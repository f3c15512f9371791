"""Broker routing: the offline/realtime time boundary of a hybrid table.

Port of the time-boundary part of ``pinot_tpu/broker/routing.py``
(``resolve_time_column``, ``time_boundary``, ``split_hybrid``), copied
line for line; the reference system's TimeBoundaryManager
(pinot-broker/.../routing/timeboundary/TimeBoundaryManager.java). The
segment pruners and instance selectors of that module serve the cluster's
broker node and wait for it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..query.sql import BoolAnd, Comparison, Identifier, Literal


def resolve_time_column(config: Optional[Dict[str, Any]], schema: Any
                        ) -> Optional[str]:
    """Table time column: explicit timeColumn config, else the schema's
    first DATE_TIME field. Accepts a schema dict ({"fields": [...]}) or a
    Schema object — shared by the in-process and HTTP brokers."""
    if config and config.get("timeColumn"):
        return config["timeColumn"]
    fields = (schema or {}).get("fields", []) if isinstance(schema, dict) \
        else getattr(schema, "fields", [])
    for f in fields:
        if isinstance(f, dict):
            if f.get("fieldType") == "DATE_TIME":
                return f.get("name")
        elif getattr(getattr(f, "field_type", None), "value", None) \
                == "DATE_TIME":
            return f.name
    return None


def time_boundary(offline_segment_meta: Dict[str, Dict[str, Any]],
                  time_col: str) -> Optional[Any]:
    """Max end time across offline segments (TimeBoundaryManager: the
    offline side answers time <= boundary, realtime time > boundary)."""
    best = None
    for meta in offline_segment_meta.values():
        cm = ((meta or {}).get("columns") or {}).get(time_col)
        if cm is None or cm.get("max") is None:
            return None  # a segment without time metadata: no boundary
        if best is None or cm["max"] > best:
            best = cm["max"]
    return best


def split_hybrid(stmt, time_col: str, boundary: Any):
    """Rewrite one logical-table statement into (offline, realtime)
    statements with the boundary conjuncts applied."""
    import copy

    def with_conjunct(s, conj):
        s = copy.copy(s)
        s.options = dict(s.options)
        s.where = conj if s.where is None else BoolAnd((s.where, conj))
        return s

    off = with_conjunct(stmt, Comparison(
        "<=", Identifier(time_col), Literal(boundary)))
    off.table = stmt.table + "_OFFLINE"
    rt = with_conjunct(stmt, Comparison(
        ">", Identifier(time_col), Literal(boundary)))
    rt.table = stmt.table + "_REALTIME"
    return off, rt
