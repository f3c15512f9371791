"""Range index: per-chunk zone maps (min/max every CHUNK docs).

Port of ``pinot_tpu/index/range_index.py``: the same host numpy code, so the files it
writes are byte-equal to the JAX package's.

Reference parity: pinot-segment-local/.../segment/index/range/
(RangeIndexCreator buckets values into ranges with a bitmap per bucket;
operator/filter/RangeIndexBasedFilterOperator). Dict-encoded columns don't
need it here — the sorted dictionary turns range predicates into id ranges
(query/planner.py _dict_range). This index serves RAW columns: zone maps
let the host path skip whole chunks and let the planner prune segments
more precisely than the global column min/max.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

CHUNK = 8192
MIN_SUFFIX = ".rng.min.bin"
MAX_SUFFIX = ".rng.max.bin"


def build(col: str, seg_dir: str, *, values: np.ndarray,
          **_: Any) -> Dict[str, Any]:
    arr = np.asarray(values)
    if arr.dtype == object:
        raise ValueError(f"range index needs a numeric raw column: {col}")
    n = len(arr)
    n_chunks = max((n + CHUNK - 1) // CHUNK, 1)
    mins = np.empty(n_chunks, dtype=arr.dtype)
    maxs = np.empty(n_chunks, dtype=arr.dtype)
    for i in range(n_chunks):
        c = arr[i * CHUNK: (i + 1) * CHUNK]
        mins[i] = c.min() if len(c) else 0
        maxs[i] = c.max() if len(c) else 0
    mins.tofile(os.path.join(seg_dir, col + MIN_SUFFIX))
    maxs.tofile(os.path.join(seg_dir, col + MAX_SUFFIX))
    return {"chunk": CHUNK, "dtype": arr.dtype.name}


class RangeIndexReader:
    def __init__(self, seg_dir: str, col: str, meta: Dict[str, Any]):
        dt = np.dtype(meta.get("dtype", "int64"))
        self.chunk = int(meta.get("chunk", CHUNK))
        from ..segment import segdir
        self.mins = np.asarray(segdir.read_array(seg_dir, col + MIN_SUFFIX,
                                                 dt, mmap=False))
        self.maxs = np.asarray(segdir.read_array(seg_dir, col + MAX_SUFFIX,
                                                 dt, mmap=False))

    def candidate_chunks(self, lo, hi) -> np.ndarray:
        """Bool per chunk: may contain a value in [lo, hi] (inclusive;
        None = unbounded)."""
        ok = np.ones(len(self.mins), dtype=bool)
        if lo is not None:
            ok &= self.maxs >= lo
        if hi is not None:
            ok &= self.mins <= hi
        return ok

    def candidate_mask(self, lo, hi, n_docs: int) -> np.ndarray:
        """Expand chunk verdicts to a per-doc candidate mask."""
        ok = self.candidate_chunks(lo, hi)
        return np.repeat(ok, self.chunk)[:n_docs]
