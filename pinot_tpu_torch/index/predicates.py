"""Index-answered filter functions: TEXT_MATCH / JSON_MATCH /
VECTOR_SIMILARITY, and the geospatial filters.

Port of ``pinot_tpu/index/predicates.py``. TEXT_MATCH, JSON_MATCH and
VECTOR_SIMILARITY require the corresponding index on the column and raise
``SqlError`` when it is absent, as the reference does; the geo filters
engage only when the column has a geo index. The result is a host boolean
doc mask; the planner ships it to the device as a ``docmask`` kernel
param, the host path ANDs it directly.
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


# ---------------------------------------------------------------------------
# geospatial filters (H3IndexFilterOperator / H3InclusionIndexFilterOperator
# analogs): engage only when the column has a geo index; without one the
# planner hosts the query and the ST_* scalar functions evaluate row-wise,
# matching the reference's fallback to expression scan filters.
# ---------------------------------------------------------------------------

_GEO_CONSTRUCTORS = ("stpoint", "stgeogfromtext", "stgeomfromtext",
                     "stgeogfromwkb", "stgeomfromwkb")


def _const_geometry(e):
    """Literal WKT/WKB-hex or all-literal geo constructor -> Geometry."""
    from ..geo import geometry as geom
    if isinstance(e, Literal) and isinstance(e.value, str):
        try:
            return geom.coerce(e.value)
        except Exception:
            return None
    from ..query.functions import canonical
    if isinstance(e, FuncCall) and canonical(e.name) in _GEO_CONSTRUCTORS \
            and all(isinstance(a, Literal) for a in e.args):
        from ..query.functions import call
        import numpy as np
        try:
            v = call(e.name, *[np.asarray([a.value]) for a in e.args])
            return geom.coerce(v.ravel()[0])
        except Exception:
            return None
    return None


def try_geo_distance_mask(seg, lhs, op: str, rhs) -> Optional[np.ndarray]:
    """ST_Distance(col, <const point>) <op> <number> via the geo index."""
    from ..query.functions import canonical
    if not (isinstance(lhs, FuncCall) and canonical(lhs.name) == "stdistance"
            and len(lhs.args) == 2 and isinstance(rhs, Literal)
            and isinstance(rhs.value, (int, float))
            and op in ("<", "<=", ">", ">=")):
        return None
    a, b = lhs.args
    if isinstance(a, Identifier):
        col, other = a.name, b
    elif isinstance(b, Identifier):
        col, other = b.name, a
    else:
        return None
    g = _const_geometry(other)
    if g is None:
        return None
    reader = seg.index_reader(col, "geo")
    if reader is None:
        return None
    mask = reader.distance_mask(g, float(rhs.value), op, seg.n_docs)
    return np.asarray(mask, dtype=bool)


def try_geo_inclusion_mask(seg, e, positive: bool = True
                           ) -> Optional[np.ndarray]:
    """ST_Contains(<const polygon>, col) / ST_Within(col, <const polygon>)
    via the geo index; ``positive=False`` complements over valid points."""
    from ..query.functions import canonical
    if not (isinstance(e, FuncCall)
            and canonical(e.name) in ("stcontains", "stwithin")
            and len(e.args) == 2):
        return None
    if canonical(e.name) == "stcontains":
        poly_e, col_e = e.args
    else:
        col_e, poly_e = e.args
    if not isinstance(col_e, Identifier):
        return None
    g = _const_geometry(poly_e)
    if g is None or g.kind != "polygon":
        return None
    reader = seg.index_reader(col_e.name, "geo")
    if reader is None:
        return None
    mask = reader.inclusion_mask(g, seg.n_docs, positive=positive)
    return np.asarray(mask, dtype=bool)
