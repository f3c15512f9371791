"""Per-table execution: plan every segment, then run the batched dispatch.

Port of ``pinot_tpu/engine/serving.py``. The broker serves a query over a
table's segments through this one loop. Each executed segment (a kernel
or host plan) is touched in the heat table (``utils/heat``), whose scores
rank the device tier's demotions. Star-tree rollups, tracing and the
plan cache's retrace detector of the JAX package are not ported; without
them every segment is planned and executed, which changes no row.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List

from ..query.context import QueryContext
from ..query.planner import CompiledPlan, SegmentPlanner
from ..utils.heat import global_segment_heat
from .batch import execute_plans_batched


@dataclass
class TableExecution:
    plans: List[CompiledPlan]
    partials: List[Any] = field(default_factory=list)
    # per plan: the dispatch it took (engine/batch route names)
    routes: List[str] = field(default_factory=list)

    @property
    def pruned(self) -> int:
        return sum(1 for p in self.plans if p.kind == "pruned")

    @property
    def docs_scanned(self) -> int:
        return sum(p.segment.n_docs for p in self.plans
                   if p.kind in ("kernel", "host"))


def plan_segments(ctx: QueryContext, segments: List[Any]
                  ) -> TableExecution:
    ex = TableExecution([SegmentPlanner(ctx, seg).plan()
                         for seg in segments])
    # one heat touch per executed segment: the device tier's ranking
    for p in ex.plans:
        if p.kind in ("kernel", "host"):
            global_segment_heat.touch(p.segment, ctx.table, p.segment.n_docs)
    return ex


def execute_planned(ex: TableExecution) -> List[Any]:
    """Run the batched dispatch; the partials come back in segment order."""
    ex.partials, ex.routes = execute_plans_batched(ex.plans)
    return ex.partials


def execute_segments(ctx: QueryContext, segments: List[Any]
                     ) -> TableExecution:
    ex = plan_segments(ctx, segments)
    execute_planned(ex)
    return ex
