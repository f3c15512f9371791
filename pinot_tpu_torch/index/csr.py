"""CSR posting-list storage shared by inverted/text/json indexes.

Port of ``pinot_tpu/index/csr.py``: the same host numpy code, so the files it
writes are byte-equal to the JAX package's.

Reference parity: pinot-segment-local/.../segment/index/inverted/ stores a
RoaringBitmap per dict id; the TPU-native layout is a flat CSR (offsets +
concatenated sorted doc ids) which memmaps zero-copy and turns a posting
read into one slice.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np


def write_csr(path_prefix: str, postings: Sequence[np.ndarray]) -> None:
    """postings[i] = sorted int32 doc ids for key i."""
    offsets = np.zeros(len(postings) + 1, dtype=np.int64)
    for i, p in enumerate(postings):
        offsets[i + 1] = offsets[i] + len(p)
    docs = (np.concatenate(postings).astype(np.int32)
            if len(postings) else np.zeros(0, dtype=np.int32))
    docs.tofile(path_prefix + ".docs.bin")
    offsets.tofile(path_prefix + ".off.bin")


class CsrPostings:
    """Memmapped CSR posting lists (v1 loose files or v3 packed slices
    via segment.segdir)."""

    def __init__(self, seg_dir: str, prefix: str):
        from ..segment import segdir
        self.docs = segdir.read_array(seg_dir, prefix + ".docs.bin",
                                      np.int32)
        self.offsets = np.asarray(segdir.read_array(
            seg_dir, prefix + ".off.bin", np.int64, mmap=False))

    @property
    def n_keys(self) -> int:
        return len(self.offsets) - 1

    def docs_for(self, key: int) -> np.ndarray:
        if key < 0 or key >= self.n_keys:
            return np.zeros(0, dtype=np.int32)
        return np.asarray(self.docs[self.offsets[key]: self.offsets[key + 1]])

    def mask_for(self, keys: Iterable[int], n_docs: int) -> np.ndarray:
        mask = np.zeros(n_docs, dtype=bool)
        for k in keys:
            mask[self.docs_for(k)] = True
        return mask


def postings_from_ids(ids: np.ndarray, cardinality: int) -> List[np.ndarray]:
    """Group doc positions by dict id (counting sort; ids in [0, card))."""
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    bounds = np.searchsorted(sorted_ids, np.arange(cardinality + 1))
    return [order[bounds[i]: bounds[i + 1]].astype(np.int32)
            for i in range(cardinality)]


def postings_from_doc_keys(doc_keys: Sequence[Iterable[int]],
                           n_keys: int) -> List[np.ndarray]:
    """doc_keys[doc] = iterable of key ids present in that doc."""
    buckets: Dict[int, List[int]] = {}
    for doc, keys in enumerate(doc_keys):
        for k in keys:
            buckets.setdefault(k, []).append(doc)
    return [np.asarray(sorted(set(buckets.get(k, []))), dtype=np.int32)
            for k in range(n_keys)]
