"""EXPLAIN PLAN / EXPLAIN ANALYZE rendering.

Port of ``pinot_tpu/query/explain.py``, copied line for line: rows of
(Operator, Operator_Id, Parent_Id) describing the physical tree, as the
reference system's ExplainPlanQueriesTest pattern shows it. The plan is
flatter than Pinot's pull-based tree (one fused kernel per segment), so
the explain shows the broker reduce, the combine, and the per-segment
plan kinds with their predicate/aggregation structure (and which segments
pruned / answered from rollups / fast paths). The operator names are the
reference's, so the rows compare equal.

EXPLAIN ANALYZE executes the query under the span tracer (utils/spans.py)
and renders the resulting tree: per-phase wall ms (plan / device execute
/ transfer / reduce), the cost model's strategy decision trace, plan-cache
hit/miss, and estimated vs measured selectivity per segment kernel.
"""
from __future__ import annotations

import json
from collections import Counter
from typing import Any, List, Tuple

from ..ops.ir import (And, Bin, Cmp, Col, EqId, FalseP, IdRange, InBitmap,
                      InSet,
                      KernelPlan, Lit, MaskParam, Not, Or, Pred, TrueP,
                      ValueExpr)
from ..query.planner import CompiledPlan


def _ve(v: ValueExpr, cols: List[str]) -> str:
    if isinstance(v, Col):
        base = cols[v.col]
        return f"{base}" if v.dict_param is None else f"dictGet({base})"
    if isinstance(v, Lit):
        return "literal"
    if isinstance(v, Bin):
        return f"({_ve(v.lhs, cols)}{v.op}{_ve(v.rhs, cols)})"
    return "?"


def _pred(p: Pred, cols: List[str]) -> str:
    if isinstance(p, TrueP):
        return "MATCH_ALL"
    if isinstance(p, FalseP):
        return "MATCH_NONE"
    if isinstance(p, EqId):
        return f"EQ_DICT({cols[p.col]})"
    if isinstance(p, IdRange):
        return f"RANGE_DICT({cols[p.col]})"
    if isinstance(p, InSet):
        return f"IN_SET({cols[p.col]},n={p.n})"
    if isinstance(p, InBitmap):
        return f"IN_BITMAP({cols[p.col]})"
    if isinstance(p, Cmp):
        return f"CMP({_ve(p.lhs, cols)}{p.op})"
    if isinstance(p, MaskParam):
        return "MASK_PARAM"
    if isinstance(p, And):
        return "AND(" + ",".join(_pred(c, cols) for c in p.children) + ")"
    if isinstance(p, Or):
        return "OR(" + ",".join(_pred(c, cols) for c in p.children) + ")"
    if isinstance(p, Not):
        return f"NOT({_pred(p.child, cols)})"
    return "?"


def explain_rows(ctx, plans: List[CompiledPlan], rollup_count: int = 0
                 ) -> Tuple[List[str], List[tuple]]:
    """-> (columns, rows) for the explain result table."""
    rows: List[tuple] = []
    rid = 0

    def emit(op: str, parent: int) -> int:
        nonlocal rid
        rows.append((op, rid, parent))
        rid += 1
        return rid - 1

    root = emit("BROKER_REDUCE"
                + ("(HAVING)" if ctx.having is not None else "")
                + (f"(ORDER_BY:{len(ctx.order_by)})" if ctx.order_by else "")
                + (f"(LIMIT:{ctx.limit})" if ctx.limit is not None else ""),
                -1)
    combine = emit("COMBINE(vmap_batched)", root)
    if rollup_count:
        emit(f"STARTREE_ROLLUP(segments:{rollup_count})", combine)

    kinds = Counter(p.kind for p in plans)
    if kinds.get("pruned"):
        emit(f"SEGMENT_PRUNED(segments:{kinds['pruned']})", combine)
    if kinds.get("fast"):
        emit(f"METADATA_FAST_PATH(segments:{kinds['fast']})", combine)
    if kinds.get("host"):
        emit(f"HOST_VECTORIZED(segments:{kinds['host']})", combine)

    kernel_plans = [p for p in plans if p.kind == "kernel"]
    if kernel_plans:
        p = kernel_plans[0]
        kp: KernelPlan = p.kernel_plan
        node = emit(f"TPU_KERNEL(segments:{len(kernel_plans)},"
                    f"bucket:{p.segment.bucket})", combine)
        emit(f"FILTER_MASK:{_pred(kp.pred, p.col_names)}", node)
        if kp.is_group_by:
            keys = ",".join(p.col_names[i] for i, _ in kp.group_keys)
            emit(f"GROUP_BY_ONEHOT_DOT(keys:[{keys}],"
                 f"space:{kp.group_space})", node)
        for i, spec in enumerate(kp.aggs):
            desc = spec.kind.upper()
            if spec.value is not None:
                desc += f"({_ve(spec.value, p.col_names)})"
            emit(f"AGGREGATE:{desc}", node)
    return ["Operator", "Operator_Id", "Parent_Id"], rows


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE: span-tree rendering
# ---------------------------------------------------------------------------

ANALYZE_COLUMNS = ["Node", "Node_Id", "Parent_Id", "Time_Ms", "Detail"]

# attribute rendering order: the decision-relevant fields first (what the
# cost model estimated vs what the kernel measured), everything else
# alphabetical after
_ATTR_ORDER = ["strategy", "cache", "est_sel", "meas_sel", "slots_cap",
               "matched", "retrace", "compiled",
               # compile lane (staged build_kernel spans, ISSUE 15):
               # trigger taxonomy + executable memory/flops as Detail
               "trigger", "memory_bytes", "flops", "site",
               # cluster plane (scatter_call / server_query spans)
               "server", "attempt", "status", "net_ms", "error"]


def _fmt_val(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, (dict, list, tuple)):
        return json.dumps(v, sort_keys=True, default=str)
    return str(v)


def _fmt_attrs(attrs: dict) -> str:
    keys = [k for k in _ATTR_ORDER if k in attrs and attrs[k] is not None]
    keys += sorted(k for k in attrs
                   if k not in _ATTR_ORDER and attrs[k] is not None)
    return " ".join(f"{k}={_fmt_val(attrs[k])}" for k in keys)


def explain_analyze_rows(root) -> Tuple[List[str], List[tuple]]:
    """utils/spans.Span tree -> (columns, rows) of
    (Node, Node_Id, Parent_Id, Time_Ms, Detail) in pre-order — the same
    parent-pointer table shape EXPLAIN PLAN uses, plus timings."""
    rows: List[tuple] = []

    def walk(s, parent: int) -> None:
        rid = len(rows)
        rows.append((s.name, rid, parent, round(s.duration_ms, 3),
                     _fmt_attrs(s.attrs)))
        for c in s.children:
            walk(c, rid)

    walk(root, -1)
    return list(ANALYZE_COLUMNS), rows


def finalize_analyze(root) -> Tuple[List[str], List[tuple], dict]:
    """The EXPLAIN ANALYZE render tail: attach the explicit
    ``broker_overhead`` self-time child (so root-child timings sum to
    the query's wall time — the 10% gate), render the rows, and build
    the trace envelope."""
    from ..utils import phases as ph
    from ..utils.spans import Span

    overhead = root.duration_ms - root.children_ms()
    if overhead > 0:
        s = Span(ph.BROKER_OVERHEAD)
        s.duration_ms = overhead
        root.children.append(s)
    cols, rows = explain_analyze_rows(root)
    return cols, rows, {"spans": root.to_dict()}
