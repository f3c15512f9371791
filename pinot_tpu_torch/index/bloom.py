"""Bloom filter index: probabilistic membership for EQ segment pruning.

Port of ``pinot_tpu/index/bloom.py``: the same host numpy code, so the files it
writes are byte-equal to the JAX package's.

Reference parity: pinot-segment-local/.../segment/index/bloom/ (guava-based
OnHeapGuavaBloomFilterReader) consumed by BloomFilterSegmentPruner
(pinot-core/.../query/pruner/) and ColumnValueSegmentPruner. A definite
"absent" folds the predicate to FalseP at plan time — folding the root
predicate to FalseP IS segment pruning in this engine.
"""
from __future__ import annotations

import hashlib
import os
from typing import Any, Dict

import numpy as np

SUFFIX = ".bloom.bin"
DEFAULT_FPP_BITS_PER_KEY = 10  # ~1% fpp at k=4
K_HASHES = 4


def _hash2(value: Any) -> tuple:
    raw = str(value).encode("utf-8")
    d = hashlib.md5(raw).digest()
    return (int.from_bytes(d[:8], "little"),
            int.from_bytes(d[8:16], "little"))


def _positions(value: Any, m_bits: int) -> list:
    h1, h2 = _hash2(value)
    return [(h1 + i * h2) % m_bits for i in range(K_HASHES)]


def build(col: str, seg_dir: str, *, values: np.ndarray,
          **_: Any) -> Dict[str, Any]:
    uniq = np.unique(np.asarray(values).astype(str))
    m_bits = max(1024, len(uniq) * DEFAULT_FPP_BITS_PER_KEY)
    bits = np.zeros(m_bits, dtype=bool)
    for v in uniq:
        bits[_positions(v, m_bits)] = True
    np.packbits(bits).tofile(os.path.join(seg_dir, col + SUFFIX))
    return {"mBits": int(m_bits), "k": K_HASHES}


class BloomFilterReader:
    def __init__(self, seg_dir: str, col: str, meta: Dict[str, Any]):
        self.m_bits = int(meta["mBits"])
        from ..segment import segdir
        packed = np.asarray(segdir.read_array(seg_dir, col + SUFFIX,
                                              np.uint8, mmap=False))
        self.bits = np.unpackbits(packed)[: self.m_bits].astype(bool)

    def might_contain(self, value: Any) -> bool:
        return bool(all(self.bits[p] for p in _positions(value, self.m_bits)))
