"""Partial-result wire format: the DataTable analog.

Reference parity: pinot-common/.../datatable/ (versioned server->broker
result serialization) + common/datablock/. Pinot ships row-wise binary
DataTables over Netty; here partials are the mergeable aggregation states
(engine/executor.py), JSON-encoded with type tags for the few non-JSON
state shapes (sets for DISTINCTCOUNT, tuples for AVG and group keys).
JSON keeps the wire debuggable; a packed binary codec can swap in behind
the same two functions without touching the broker or servers.

Port of ``pinot_tpu/engine/serde.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List

from .executor import AggPartial, GroupByPartial, SelectionPartial


def _enc_state(s: Any) -> Any:
    if isinstance(s, set):
        return {"__set__": sorted(s, key=lambda v: (str(type(v)), str(v)))}
    if isinstance(s, tuple):
        return {"__tuple__": [_enc_state(x) for x in s]}
    if isinstance(s, dict):
        # MODE value->count maps: JSON stringifies object keys, so ship as
        # pairs to keep numeric keys numeric
        return {"__dict__": [[_enc_state(k), _enc_state(v)]
                             for k, v in s.items()]}
    return s


def _dec_state(s: Any) -> Any:
    if isinstance(s, dict) and "__set__" in s:
        return set(s["__set__"])
    if isinstance(s, dict) and "__tuple__" in s:
        return tuple(_dec_state(x) for x in s["__tuple__"])
    if isinstance(s, dict) and "__dict__" in s:
        return {_dec_state(k): _dec_state(v) for k, v in s["__dict__"]}
    return s


def partial_to_wire(p: Any) -> Dict[str, Any]:
    if isinstance(p, AggPartial):
        return {"type": "agg", "states": [_enc_state(s) for s in p.states]}
    if isinstance(p, GroupByPartial):
        return {"type": "groupby",
                "groups": [[list(k), [_enc_state(s) for s in v]]
                           for k, v in p.groups.items()]}
    if isinstance(p, SelectionPartial):
        return {"type": "selection", "labels": p.labels,
                "rows": [list(r) for r in p.rows],
                "orderKeys": [list(k) for k in p.order_keys]}
    raise TypeError(f"unknown partial {type(p)}")


def partial_from_wire(d: Dict[str, Any]) -> Any:
    t = d["type"]
    if t == "agg":
        return AggPartial([_dec_state(s) for s in d["states"]])
    if t == "groupby":
        return GroupByPartial({tuple(k): [_dec_state(s) for s in v]
                               for k, v in d["groups"]})
    if t == "selection":
        return SelectionPartial(d["labels"],
                                [tuple(r) for r in d["rows"]],
                                [tuple(k) for k in d["orderKeys"]])
    raise ValueError(f"unknown partial type {t!r}")
