"""Index-answered filter functions: TEXT_MATCH / JSON_MATCH /
VECTOR_SIMILARITY.

Port of the text, json and vector part of ``pinot_tpu/index/predicates.py``
(the geo part comes with the geo index). Each function requires the
corresponding index on the column and raises ``SqlError`` when it is
absent, as the reference does. The result is a host boolean doc mask; the
planner ships it to the device as a ``docmask`` kernel param, the host path
ANDs it directly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..query.sql import FuncCall, Identifier, Literal, SqlError


def _col_of(e: FuncCall) -> str:
    if not e.args or not isinstance(e.args[0], Identifier):
        raise SqlError(f"{e.name.upper()} needs a column as first argument")
    return e.args[0].name


def _lit(e: FuncCall, i: int, what: str):
    if len(e.args) <= i or not isinstance(e.args[i], Literal):
        raise SqlError(f"{e.name.upper()} needs a literal {what} "
                       f"as argument {i + 1}")
    return e.args[i].value


def is_index_predicate(e) -> bool:
    return isinstance(e, FuncCall) and e.name in (
        "text_match", "json_match", "vector_similarity")


def index_filter_mask(seg, e: FuncCall) -> np.ndarray:
    """Evaluate an index predicate over a segment -> bool mask (n_docs)."""
    col = _col_of(e)
    meta = seg.columns.get(col)
    if meta is None:
        raise SqlError(f"unknown column {col!r}")
    if e.name == "text_match":
        reader = seg.index_reader(col, "text")
        if reader is None:
            raise SqlError(f"TEXT_MATCH requires a text index on {col!r} "
                           "(tableConfig indexing.textIndexColumns)")
        return reader.match(str(_lit(e, 1, "query")), seg.n_docs)
    if e.name == "json_match":
        reader = seg.index_reader(col, "json")
        if reader is None:
            raise SqlError(f"JSON_MATCH requires a json index on {col!r} "
                           "(tableConfig indexing.jsonIndexColumns)")
        return reader.match(str(_lit(e, 1, "filter")), seg.n_docs)
    if e.name == "vector_similarity":
        # the vector execution plane (engine/vector_exec.py): validated
        # IVF/flat device search, memoized per (query, segment, call),
        # micro-batched with concurrent same-shape queries
        from ..engine.vector_exec import filter_mask
        return filter_mask(seg, e)
    raise SqlError(f"not an index predicate: {e.name}")


def try_index_filter_mask(seg, e) -> Optional[np.ndarray]:
    if not is_index_predicate(e):
        return None
    return index_filter_mask(seg, e)
