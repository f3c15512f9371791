"""Partial-upsert row merging.

Port of ``pinot_tpu/upsert/merger.py``, line for line; ``read_row``
reads an immutable segment of the port through its host memmaps.

Reference parity: pinot-segment-local/.../upsert/merger/
PartialUpsertMerger.java:30 + columnar/{Overwrite,Ignore,Increment,
Append,Union,Max,Min}Merger.java. Semantics reproduced:

- a NULL incoming value means "not provided" — the previous value is
  kept regardless of strategy (PartialUpsertColumnarMerger skips null
  new values);
- OVERWRITE (default): non-null new value wins;
- IGNORE: the first-seen value is immutable (new value discarded);
- INCREMENT: numeric add (previous null -> new value);
- MAX / MIN: numeric extremum;
- APPEND: multi-value list concatenation;
- UNION: multi-value set union (first-seen order preserved);
- primary-key and comparison columns always take the new row's values.

Row reads against either segment kind are targeted single-doc lookups
(fwd[doc] + dictionary gather), not whole-column decodes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

STRATEGIES = ("overwrite", "ignore", "increment", "append", "union",
              "max", "min")


def _merge_value(strategy: str, prev: Any, new: Any) -> Any:
    if new is None:
        return prev            # partial semantics: null = not provided
    if strategy == "ignore":
        return prev if prev is not None else new
    if prev is None:
        return new
    if strategy == "overwrite":
        return new
    if strategy == "increment":
        return prev + new
    if strategy == "max":
        return max(prev, new)
    if strategy == "min":
        return min(prev, new)
    if strategy == "append":
        return list(prev) + list(new)
    if strategy == "union":
        out = list(prev)
        seen = set(out)
        for v in (list(new) if isinstance(new, (list, tuple)) else [new]):
            if v not in seen:
                seen.add(v)
                out.append(v)
        return out
    raise ValueError(f"unknown partial-upsert strategy {strategy!r}")


class PartialUpsertMerger:
    """Column-wise merge of the incoming row with the current live row."""

    def __init__(self, pk_columns: List[str],
                 comparison_column: Optional[str],
                 strategies: Dict[str, str],
                 default_strategy: str = "overwrite"):
        for col, s in strategies.items():
            if s.lower() not in STRATEGIES:
                raise ValueError(
                    f"unknown partial-upsert strategy {s!r} for {col!r}")
        if default_strategy.lower() not in STRATEGIES:
            raise ValueError(
                f"unknown default partial-upsert strategy "
                f"{default_strategy!r}")
        self._pk = set(pk_columns)
        self._cmp = comparison_column
        self._strategies = {c: s.lower() for c, s in strategies.items()}
        self._default = default_strategy.lower()

    def merge(self, prev_row: Dict[str, Any],
              new_row: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for col in new_row.keys() | prev_row.keys():
            newv = new_row.get(col)
            if col in self._pk or col == self._cmp:
                out[col] = newv
                continue
            out[col] = _merge_value(
                self._strategies.get(col, self._default),
                prev_row.get(col), newv)
        return out


def _py(v: Any) -> Any:
    return v.item() if isinstance(v, np.generic) else v


def read_row(segment, doc_id: int) -> Dict[str, Any]:
    """One row from either segment kind in value space (None for nulls).

    MutableSegment exposes get_row; ImmutableSegment is read through
    targeted fwd[doc] + dictionary gathers (never a whole-column
    decode — merging runs per ingested row)."""
    if hasattr(segment, "get_row"):
        return segment.get_row(doc_id)
    row: Dict[str, Any] = {}
    for name, m in segment.columns.items():
        nm = segment.null_mask(name)
        if nm is not None and nm[doc_id]:
            row[name] = None
            continue
        if getattr(m, "encoding", None) == "VECTOR":
            # vector columns have no fwd.bin — read the index matrix row
            mat = segment.index_reader(name, "vector").matrix
            row[name] = [float(x) for x in np.asarray(mat)[doc_id]]
            continue
        stored = segment.fwd(name)
        d = segment.dictionary(name)
        if not getattr(m, "single_value", True):
            ids = np.asarray(stored[doc_id])
            ids = ids[ids >= 0]
            row[name] = [_py(d.value(int(i))) for i in ids] \
                if d is not None else [_py(v) for v in ids]
            continue
        v = stored[doc_id]
        if d is not None:
            v = d.value(int(v))     # O(1), never the whole dictionary
        row[name] = _py(v)
    return row
