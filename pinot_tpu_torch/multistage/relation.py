"""Relation: the columnar block flowing between stages.

Port of ``pinot_tpu/multistage/relation.py`` (host numpy, no device code).

Reference parity: pinot-common/.../datablock/{RowDataBlock,
ColumnarDataBlock}.java — the transferable block of the v2 engine — plus
the segment-protocol adapter so the vectorized host evaluators
(engine/host_eval.py) run unchanged over intermediate results. Columns are
keyed by qualified name ("alias.col"); bare-name lookup resolves when
unambiguous, mirroring Calcite's scope resolution at small scale.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class _RelColMeta:
    has_dict = False
    is_sorted = False
    min = None
    max = None
    cardinality = 0
    partitions = None

    def __init__(self, name: str, has_nulls: bool):
        self.name = name
        self.has_nulls = has_nulls


class _ResolvingMetaMap:
    def __init__(self, rel: "Relation"):
        self._rel = rel

    def get(self, name: str, default=None):
        q = self._rel.resolve(name)
        if q is None:
            return default
        return _RelColMeta(q, q in self._rel.nulls)

    def __getitem__(self, name: str):
        m = self.get(name)
        if m is None:
            raise KeyError(name)
        return m

    def __contains__(self, name: str) -> bool:
        return self._rel.resolve(name) is not None

    def __iter__(self):
        return iter(self._rel.data)


class _SchemaShim:
    def __init__(self, names: List[str]):
        self.column_names = names


class Relation:
    """Columnar batch: {qualified_name: np.ndarray}, equal lengths."""

    is_mutable = False

    def __init__(self, data: Dict[str, np.ndarray],
                 nulls: Optional[Dict[str, np.ndarray]] = None,
                 name: str = "relation"):
        self.data = data
        self.nulls = nulls or {}
        self.name = name
        lens = {len(v) for v in data.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged relation: {lens}")
        self.n_docs = lens.pop() if lens else 0
        self.columns = _ResolvingMetaMap(self)
        self.schema = _SchemaShim(list(data))

    @property
    def n_rows(self) -> int:
        return self.n_docs

    # -- name resolution ---------------------------------------------------
    def resolve(self, name: str) -> Optional[str]:
        if name in self.data:
            return name
        # bare name: unique suffix match on ".name"
        suffix = "." + name
        hits = [k for k in self.data if k.endswith(suffix)]
        if len(hits) == 1:
            return hits[0]
        return None

    # -- segment-protocol adapter (host_eval) ------------------------------
    def raw_values(self, name: str) -> np.ndarray:
        q = self.resolve(name)
        if q is None:
            raise KeyError(f"column {name!r} not in relation "
                           f"{list(self.data)}")
        return self.data[q]

    def null_mask(self, name: str) -> Optional[np.ndarray]:
        q = self.resolve(name)
        return self.nulls.get(q) if q else None

    def dictionary(self, name: str):
        return None

    # -- block ops ---------------------------------------------------------
    def take(self, idx: np.ndarray) -> "Relation":
        return Relation({k: v[idx] for k, v in self.data.items()},
                        {k: v[idx] for k, v in self.nulls.items()},
                        self.name)

    def with_columns(self, extra: Dict[str, np.ndarray]) -> "Relation":
        d = dict(self.data)
        d.update(extra)
        return Relation(d, dict(self.nulls), self.name)

    @classmethod
    def concat(cls, rels: List["Relation"]) -> "Relation":
        rels = [r for r in rels if r.n_rows > 0] or rels[:1]
        if not rels:
            return cls({})
        keys = list(rels[0].data)
        data = {k: np.concatenate([r.data[k] for r in rels]) for k in keys}
        nulls = {}
        for k in keys:
            if any(k in r.nulls for r in rels):
                nulls[k] = np.concatenate([
                    r.nulls.get(k, np.zeros(r.n_rows, dtype=bool))
                    for r in rels])
        return cls(data, nulls, rels[0].name)

    def __repr__(self) -> str:
        return f"Relation({list(self.data)}, rows={self.n_rows})"
