"""Index type registry: kind -> (builder fn, reader class).

Port of ``pinot_tpu/index/registry.py``. Registered here: inverted, range,
bloom, text, json, vector. The ``geo`` kind is known (table configs name
it) but not ported yet: building or loading it raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from . import bloom, inverted, json_index, range_index, text, vector


def _geo_not_ported(*_args, **_kw):
    raise NotImplementedError("geo index: next slice (not yet ported to "
                              "pinot_tpu_torch)")


_BUILDERS = {
    "inverted": inverted.build,
    "range": range_index.build,
    "bloom": bloom.build,
    "text": text.build,
    "json": json_index.build,
    "vector": vector.build,
    "geo": _geo_not_ported,
}

_READERS = {
    "inverted": inverted.InvertedIndexReader,
    "range": range_index.RangeIndexReader,
    "bloom": bloom.BloomFilterReader,
    "text": text.TextIndexReader,
    "json": json_index.JsonIndexReader,
    "vector": vector.VectorIndexReader,
    "geo": _geo_not_ported,
}

INDEX_KINDS = tuple(_BUILDERS)

# on-disk file stems per kind, derived from each module's SUFFIX constants
# (the module that writes the files is the one source). Removal on reload
# deletes <col><stem> and <col><stem>.* (csr sub-files).
_MODULES = {"inverted": inverted, "range": range_index, "bloom": bloom,
            "text": text, "json": json_index, "vector": vector}
FILE_STEMS: Dict[str, tuple] = {}
for _kind, _mod in _MODULES.items():
    _sufs = [getattr(_mod, a) for a in dir(_mod)
             if a == "SUFFIX" or a.endswith("_SUFFIX")]
    # trim trailing .bin etc. down to the shared stem prefix so sub-files
    # (<stem>.docs.bin / <stem>.min.bin) match by prefix
    FILE_STEMS[_kind] = tuple(sorted({"." + s.split(".")[1]
                                      for s in _sufs}))
del _kind, _mod, _sufs


def build_indexes_for_column(col: str, kinds, seg_dir: str, *,
                             values: np.ndarray, ids, cardinality: int,
                             configs: Dict[str, Dict[str, Any]] = None
                             ) -> Dict[str, Dict[str, Any]]:
    """Build each configured index; returns {kind: extra_metadata} to embed
    in the column's metadata under "indexes". ``configs`` carries per-kind
    build options from the table config (e.g. the vector metric)."""
    out: Dict[str, Dict[str, Any]] = {}
    for kind in kinds:
        if kind not in _BUILDERS:
            raise ValueError(f"unknown index kind {kind!r}; have "
                             f"{INDEX_KINDS}")
        out[kind] = _BUILDERS[kind](col, seg_dir, values=values, ids=ids,
                                    cardinality=cardinality,
                                    **((configs or {}).get(kind) or {}))
    return out


def load_index(seg_dir: str, col: str, kind: str, meta: Dict[str, Any]):
    return _READERS[kind](seg_dir, col, meta)
