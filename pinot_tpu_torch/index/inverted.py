"""Inverted index: dict id -> sorted doc ids (CSR).

Port of ``pinot_tpu/index/inverted.py``: the same host numpy code, so the files it
writes are byte-equal to the JAX package's.

Reference parity: pinot-segment-local/.../segment/index/inverted/
(BitmapInvertedIndexWriter/Reader — RoaringBitmap per dict id) consumed by
operator/filter/InvertedIndexFilterOperator. TPU-native: the posting read
produces a boolean doc mask (host) that joins the kernel's predicate mask;
on the host query path it answers EQ/IN directly in O(selectivity).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from .csr import CsrPostings, postings_from_ids, write_csr

SUFFIX = ".inv"


def build(col: str, seg_dir: str, *, ids: np.ndarray, cardinality: int,
          **_: Any) -> Dict[str, Any]:
    if ids is None:
        raise ValueError(f"inverted index needs a dictionary column: {col}")
    write_csr(os.path.join(seg_dir, col + SUFFIX),
              postings_from_ids(np.asarray(ids), cardinality))
    return {}


class InvertedIndexReader:
    def __init__(self, seg_dir: str, col: str, meta: Dict[str, Any]):
        self.postings = CsrPostings(seg_dir, col + SUFFIX)

    def docs_for(self, dict_id: int) -> np.ndarray:
        return self.postings.docs_for(dict_id)

    def mask_for_ids(self, dict_ids, n_docs: int) -> np.ndarray:
        return self.postings.mask_for(dict_ids, n_docs)
