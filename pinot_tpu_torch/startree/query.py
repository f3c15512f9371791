"""Rollup query rewriting: swap a matching aggregation onto the rollup.

Port of ``pinot_tpu/startree/query.py``: the same matching rules and the
same refusals (``valid_docs`` present, a filter outside the dimensions, a
non-identifier group-by, an unmapped aggregation). Reference parity:
pinot-core/.../startree/{StarTreeUtils.java, plan/StarTreeProjectionPlan
Node...} — AggregationPlanNode swaps in the star-tree executor when every
predicate/group-by column is a tree dimension and every aggregation has a
pre-aggregated column pair. The "tree traversal" is the port's ordinary
``execute_segment`` over the (small) rollup segment, which lives on the
parent segment's device, with rewritten aggregations:

    COUNT(*)   -> SUM(__count)
    SUM(m)     -> SUM(m__sum)
    MIN(m)     -> MIN(m__min)
    MAX(m)     -> MAX(m__max)
    AVG(m)     -> (SUM(m__sum), SUM(__count)) recombined into the avg state

A loaded rollup is cached on its parent segment (``_rollup_cache``,
filled under one lock so two threads never upload it twice) and leaves
the device with it (``ImmutableSegment.evict_device``).
"""
from __future__ import annotations

import os
import threading
from typing import Any, List, Optional, Tuple

from ..query.context import AggExpr, QueryContext
from ..query.sql import Identifier
from ..segment.immutable import ImmutableSegment
from .builder import ROLLUP_META_KEY


def _filter_refs(e: Any) -> Optional[set]:
    """Referenced column names, or None if the filter shape is unsupported
    for rewriting (expressions over metrics etc. stay on the raw path)."""
    from ..query.sql import (Between, BoolAnd, BoolNot, BoolOr,
                             Comparison, InList, IsNull, Like, Literal)
    if e is None:
        return set()
    if isinstance(e, (BoolAnd, BoolOr)):
        out: set = set()
        for c in e.children:
            r = _filter_refs(c)
            if r is None:
                return None
            out |= r
        return out
    if isinstance(e, BoolNot):
        return _filter_refs(e.child)
    if isinstance(e, Comparison):
        sides = [e.lhs, e.rhs]
        out = set()
        for s in sides:
            if isinstance(s, Identifier):
                out.add(s.name)
            elif not isinstance(s, Literal):
                return None
        return out
    if isinstance(e, Between):
        if isinstance(e.expr, Identifier) and \
                isinstance(e.lo, Literal) and isinstance(e.hi, Literal):
            return {e.expr.name}
        return None
    if isinstance(e, IsNull):
        # rollup dims lose null identity (builder refuses null-bearing dims,
        # but reject defensively)
        return None
    if isinstance(e, (InList, Like)):
        if isinstance(e.expr, Identifier):
            return {e.expr.name}
        return None
    return None


def _rollup_cols(agg: AggExpr, metrics: set) -> Optional[List[Tuple[str,
                                                                    str]]]:
    """-> [(rewritten_kind, rollup_col)] building blocks, or None."""
    if agg.kind == "count":
        return [("sum", "__count")]
    if not isinstance(agg.arg, Identifier):
        return None
    col = agg.arg.name
    if agg.kind == "sum" and ("sum", col) in metrics:
        return [("sum", f"{col}__sum")]
    if agg.kind == "min" and ("min", col) in metrics:
        return [("min", f"{col}__min")]
    if agg.kind == "max" and ("max", col) in metrics:
        return [("max", f"{col}__max")]
    if agg.kind == "avg" and ("sum", col) in metrics:
        return [("sum", f"{col}__sum"), ("sum", "__count")]
    return None


def try_rollup_execute(ctx: QueryContext, seg: ImmutableSegment):
    """Partial via a matching rollup, or None (raw-segment path)."""
    match = match_rollup(ctx, seg)
    if match is None:
        return None
    return execute_on_rollup(ctx, seg, *match)


def match_rollup(ctx: QueryContext, seg: ImmutableSegment):
    """(rollup entry, aggregation mapping) of the first rollup that can
    answer ``ctx`` on ``seg``, or None; executes nothing (EXPLAIN counts
    rollup segments through it)."""
    entries = seg.metadata.get(ROLLUP_META_KEY) if hasattr(seg, "metadata") \
        else None
    if not entries or not ctx.is_aggregation:
        return None
    if getattr(seg, "valid_docs", None) is not None:
        # upsert-invalidated docs are baked into the rollup's pre-aggregates;
        # only the per-doc path can mask them out
        return None
    refs = _filter_refs(ctx.filter)
    if refs is None:
        return None
    group_cols = []
    for g in ctx.group_by:
        if not isinstance(g, Identifier):
            return None
        group_cols.append(g.name)

    for entry in entries:
        dims = set(entry["dims"])
        metrics = {(f, c) for f, c in entry["metrics"]}
        if not refs <= dims or not set(group_cols) <= dims:
            continue
        mapping: List[List[Tuple[str, str]]] = []
        ok = True
        for agg in ctx.aggregations:
            m = _rollup_cols(agg, metrics)
            if m is None:
                ok = False
                break
            mapping.append(m)
        if not ok:
            continue
        return entry, mapping
    return None


def rollup_query(ctx: QueryContext, seg: ImmutableSegment, entry,
                 mapping):
    """(rewritten context, the loaded rollup segment, the flat (kind, col)
    aggregations) that answer ``ctx`` on ``seg`` through ``entry``."""
    rollup = _load_rollup(seg, os.path.join(seg.dir, entry["name"]))
    # rewritten context: flat list of (kind, col) aggs, dedup'd
    flat: List[Tuple[str, str]] = []
    for m in mapping:
        for pair in m:
            if pair not in flat:
                flat.append(pair)
    rewritten = QueryContext(
        table=ctx.table,
        select_items=[],
        labels=[],
        aggregations=[AggExpr(kind, Identifier(col), f"{kind}({col})")
                      for kind, col in flat],
        group_by=list(ctx.group_by),
        filter=ctx.filter,
        having=None,
        order_by=[],
        limit=None,
        offset=0,
    )
    return rewritten, rollup, flat


def execute_on_rollup(ctx: QueryContext, seg: ImmutableSegment, entry,
                      mapping):
    from ..engine.executor import (AggPartial, GroupByPartial,
                                   execute_segment)
    rewritten, rollup, flat = rollup_query(ctx, seg, entry, mapping)
    partial = execute_segment(rewritten, rollup)

    def remap(states: List[Any]) -> List[Any]:
        by_pair = dict(zip(flat, states))
        out: List[Any] = []
        for agg, m in zip(ctx.aggregations, mapping):
            if agg.kind == "avg":
                out.append((by_pair[m[0]], by_pair[m[1]]))
            else:
                out.append(by_pair[m[0]])
        return out

    if isinstance(partial, AggPartial):
        return AggPartial(remap(partial.states))
    assert isinstance(partial, GroupByPartial)
    return GroupByPartial({k: remap(v) for k, v in partial.groups.items()})


_LOAD_LOCK = threading.Lock()


def _load_rollup(seg: ImmutableSegment, rollup_dir: str) -> ImmutableSegment:
    with _LOAD_LOCK:
        cache = getattr(seg, "_rollup_cache", None)
        if cache is None:
            cache = {}
            seg._rollup_cache = cache
        if rollup_dir not in cache:
            cache[rollup_dir] = ImmutableSegment.load(rollup_dir, seg.device)
        return cache[rollup_dir]
