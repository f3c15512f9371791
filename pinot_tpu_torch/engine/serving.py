"""Per-table execution: the one rollup-or-plan-then-batch loop.

Port of ``pinot_tpu/engine/serving.py``. The broker serves a query over a
table's segments through this one loop: a segment whose star-tree rollup
matches the aggregation answers from the rollup (``startree/query.py``,
itself an ordinary segment on the card), every other segment is planned
and then executed through the batched dispatch. Each executed segment (a
kernel or host plan) is touched in the heat table (``utils/heat``), whose
scores rank the device tier's demotions. ``planning`` and ``execution``
are phases of the flat trace envelope and spans of the span tree. The
plan cache's retrace detector of the JAX package has no counterpart: the
port compiles no plans. EXPLAIN counts the segments a rollup would answer
without executing the rollup (``explain=True``); the reference's EXPLAIN
plans with ``use_rollups=False`` and so never prints its
``STARTREE_ROLLUP`` line.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..query.context import QueryContext
from ..query.planner import CompiledPlan, SegmentPlanner
from ..startree.query import execute_on_rollup, match_rollup
from ..utils import phases as ph
from ..utils.heat import global_segment_heat
from ..utils.spans import annotate, span
from ..utils.trace import Tracing
from .batch import execute_plans_batched


@dataclass
class TableExecution:
    plans: List[Optional[CompiledPlan]]         # None where rollup answered
    real_plans: List[CompiledPlan]
    partials: List[Any] = field(default_factory=list)
    rollup_segments: int = 0
    # per plan: the dispatch it took (engine/batch route names; "rollup"
    # where a rollup answered)
    routes: List[str] = field(default_factory=list)
    precomputed: Dict[int, Any] = field(default_factory=dict)

    @property
    def pruned(self) -> int:
        return sum(1 for p in self.real_plans if p.kind == "pruned")

    @property
    def docs_scanned(self) -> int:
        return sum(p.segment.n_docs for p in self.real_plans
                   if p.kind in ("kernel", "host"))


def plan_segments(ctx: QueryContext, segments: List[Any],
                  use_rollups: bool = True,
                  explain: bool = False) -> TableExecution:
    """Plan every segment, answering from a matching rollup first when
    ``use_rollups``. With ``explain`` a matching rollup is only counted
    (its partial stays None): EXPLAIN executes nothing."""
    plans: List[Optional[CompiledPlan]] = []
    precomputed: Dict[int, Any] = {}
    with Tracing.phase(ph.PLANNING), span(ph.PLANNING,
                                        segments=len(segments)):
        for i, seg in enumerate(segments):
            match = match_rollup(ctx, seg) if use_rollups else None
            if match is not None:
                precomputed[i] = (None if explain
                                  else execute_on_rollup(ctx, seg, *match))
                plans.append(None)
            else:
                plans.append(SegmentPlanner(ctx, seg).plan())
        ex = TableExecution(plans, [p for p in plans if p is not None],
                            rollup_segments=len(precomputed),
                            precomputed=precomputed)
        # one heat touch per executed segment: the device tier's ranking
        for p in ex.real_plans:
            if p.kind in ("kernel", "host"):
                global_segment_heat.touch(p.segment, ctx.table,
                                          p.segment.n_docs)
        if ex.real_plans:
            p0 = ex.real_plans[0]
            annotate(kinds=sorted({p.kind for p in ex.real_plans}),
                     rollup_segments=len(precomputed), pruned=ex.pruned)
            if p0.kind == "kernel":
                annotate(strategy=p0.kernel_plan.strategy,
                         est_sel=p0.est_selectivity,
                         slots_cap=p0.slots_cap,
                         cost_trace=p0.strategy_trace)
    return ex


def execute_planned(ex: TableExecution) -> List[Any]:
    """Run the batched dispatch and interleave the rollup partials back
    into segment order."""
    with Tracing.phase(ph.EXECUTION), span(ph.EXECUTION,
                                          segments=len(ex.real_plans)):
        executed, routes = execute_plans_batched(ex.real_plans)
    executed, routes = iter(executed), iter(routes)
    ex.partials, ex.routes = [], []
    for i, p in enumerate(ex.plans):
        if p is None:
            ex.partials.append(ex.precomputed[i])
            ex.routes.append("rollup")
        else:
            ex.partials.append(next(executed))
            ex.routes.append(next(routes))
    return ex.partials


def execute_segments(ctx: QueryContext, segments: List[Any],
                     use_rollups: bool = True) -> TableExecution:
    ex = plan_segments(ctx, segments, use_rollups)
    execute_planned(ex)
    return ex
