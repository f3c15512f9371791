"""Broker routing: segment pruning, instance selection, time boundary.

Reference parity: pinot-broker/.../broker/routing/ —
- segment pruners (segmentpruner/{TimeSegmentPruner,PartitionSegment
  Pruner}.java): drop segments a query cannot match using broker-held
  segment metadata (per-column min/max, partition ids);
- instance selectors (instanceselector/{Balanced,ReplicaGroup,
  StrictReplicaGroup}InstanceSelector.java): which replica serves each
  segment;
- adaptive server selection (adaptiveserverselector/): latency/in-flight
  aware replica choice;
- TimeBoundaryManager (timeboundary/TimeBoundaryManager.java): the
  offline/realtime split point for hybrid tables.

All pure logic over the routing snapshot — shared by the in-process
broker and the HTTP BrokerNode.

Port of ``pinot_tpu/broker/routing.py``.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Set, Tuple

from ..query.sql import (Between, BoolAnd, Comparison, Identifier, InList,
                         Literal)
from ..spi.partition import partition_of

# ---------------------------------------------------------------------------
# filter analysis: per-column value constraints from the WHERE conjuncts
# ---------------------------------------------------------------------------


class ColumnBounds:
    """Interval + optional equality-set constraint for one column."""

    def __init__(self):
        self.lo: Optional[Any] = None
        self.hi: Optional[Any] = None
        self.values: Optional[Set[Any]] = None  # None = unconstrained

    def add_range(self, lo: Optional[Any], hi: Optional[Any]) -> None:
        if lo is not None and (self.lo is None or lo > self.lo):
            self.lo = lo
        if hi is not None and (self.hi is None or hi < self.hi):
            self.hi = hi

    def add_values(self, vals: Set[Any]) -> None:
        self.values = vals if self.values is None else (self.values & vals)


def filter_bounds(e: Any) -> Dict[str, ColumnBounds]:
    """Top-level AND conjunct analysis (same scope the reference's pruners
    use — OR branches are not analyzed)."""
    out: Dict[str, ColumnBounds] = {}

    def bound(name: str) -> ColumnBounds:
        return out.setdefault(name, ColumnBounds())

    def visit(conj: Any) -> None:
        if isinstance(conj, BoolAnd):
            for c in conj.children:
                visit(c)
            return
        if isinstance(conj, Comparison) and \
                isinstance(conj.lhs, Identifier) and \
                isinstance(conj.rhs, Literal):
            name, v = conj.lhs.name, conj.rhs.value
            if conj.op == "==":
                bound(name).add_range(v, v)
                bound(name).add_values({v})
            elif conj.op in (">", ">="):
                bound(name).add_range(v, None)
            elif conj.op in ("<", "<="):
                bound(name).add_range(None, v)
        elif isinstance(conj, Comparison) and \
                isinstance(conj.rhs, Identifier) and \
                isinstance(conj.lhs, Literal):
            flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(
                conj.op, conj.op)
            visit(Comparison(flipped, conj.rhs, conj.lhs))
        elif isinstance(conj, Between) and not conj.negated and \
                isinstance(conj.expr, Identifier) and \
                isinstance(conj.lo, Literal) and isinstance(conj.hi, Literal):
            bound(conj.expr.name).add_range(conj.lo.value, conj.hi.value)
        elif isinstance(conj, InList) and not conj.negated and \
                isinstance(conj.expr, Identifier):
            bound(conj.expr.name).add_values(
                {v.value for v in conj.values})

    if e is not None:
        visit(e)
    return out


# ---------------------------------------------------------------------------
# segment pruning over broker-held metadata
# ---------------------------------------------------------------------------

def _cmp_overlap(lo, hi, smin, smax) -> bool:
    """Does [lo,hi] (None = open) intersect the segment's [smin,smax]?"""
    try:
        if lo is not None and smax is not None and smax < lo:
            return False
        if hi is not None and smin is not None and smin > hi:
            return False
    except TypeError:
        return True  # incomparable types: cannot prune
    return True


def prune_segments(segment_meta: Dict[str, Dict[str, Any]], where: Any,
                   table_cfg: Optional[Dict[str, Any]] = None
                   ) -> Tuple[List[str], int]:
    """(segments to query, pruned count). segment_meta: name ->
    {"columns": {col: {"min","max","partitions"}}, "numPartitions": N}.
    Segments without metadata are never pruned."""
    bounds = filter_bounds(where)
    keep: List[str] = []
    pruned = 0
    pc = (table_cfg or {}).get("partitionColumn")
    for name, meta in segment_meta.items():
        cols = (meta or {}).get("columns") or {}
        drop = False
        for col, b in bounds.items():
            cm = cols.get(col)
            if cm is None:
                continue
            smin, smax = cm.get("min"), cm.get("max")
            # value-range pruning (ColumnValueSegmentPruner / time pruner)
            if (b.lo is not None or b.hi is not None) and \
                    not _cmp_overlap(b.lo, b.hi, smin, smax):
                drop = True
                break
            # partition pruning: equality values all outside this
            # segment's partitions
            parts = cm.get("partitions")
            if parts is not None and col == pc and b.values:
                n = int(meta.get("numPartitions") or
                        (table_cfg or {}).get("numPartitions") or 1)
                pset = set(parts)
                if not any(partition_of(v, n) in pset for v in b.values):
                    drop = True
                    break
        if drop:
            pruned += 1
        else:
            keep.append(name)
    return keep, pruned


# ---------------------------------------------------------------------------
# instance selection
# ---------------------------------------------------------------------------

# placement-affinity multipliers (HBM tier, engine/tier.py): a replica
# already holding a segment's columns hot — or a warm ragged cube for
# the plan key — answers without paying the upload, so its adaptive
# score shrinks by the factor. Warm (padded host arrays) still skips
# the mmap re-pad, a weaker but real preference. Unknown/cold = 1.0.
PLACEMENT_AFFINITY = {"hot": 0.3, "cube": 0.45, "warm": 0.6}

# every selector's select() accepts ``placement`` ({segment: {server:
# tier}} from the residency heartbeats); only the adaptive selector
# uses it — the deterministic selectors keep their reference semantics


class BalancedInstanceSelector:
    """Round-robin across healthy replicas per segment (the default)."""

    def __init__(self):
        self._rr = 0

    def select(self, assignment: Dict[str, List[str]],
               healthy, placement=None) -> Dict[str, Optional[str]]:
        out: Dict[str, Optional[str]] = {}
        for seg, holders in assignment.items():
            cands = [h for h in holders if healthy(h)] or list(holders)
            if not cands:
                out[seg] = None
                continue
            self._rr += 1
            out[seg] = cands[self._rr % len(cands)]
        return out


class ReplicaGroupInstanceSelector:
    """One replica index per query: every segment served by the same
    replica position, minimizing the number of servers a query fans out
    to (ReplicaGroupInstanceSelector semantics). Falls back per segment
    when that replica is unhealthy."""

    def __init__(self):
        self._rr = 0

    def select(self, assignment: Dict[str, List[str]],
               healthy, placement=None) -> Dict[str, Optional[str]]:
        self._rr += 1
        r = self._rr
        out: Dict[str, Optional[str]] = {}
        for seg, holders in assignment.items():
            if not holders:
                out[seg] = None
                continue
            pick = holders[r % len(holders)]
            if not healthy(pick):
                cands = [h for h in holders if healthy(h)] or list(holders)
                pick = cands[r % len(cands)] if cands else None
            out[seg] = pick
        return out


class StrictReplicaGroupInstanceSelector(ReplicaGroupInstanceSelector):
    """Like ReplicaGroup but refuses to mix replica positions: if the
    chosen replica of any segment is unhealthy, the whole query errors
    (strict consistency for partial-upsert routing)."""

    def select(self, assignment: Dict[str, List[str]],
               healthy, placement=None) -> Dict[str, Optional[str]]:
        self._rr += 1
        r = self._rr
        out: Dict[str, Optional[str]] = {}
        for seg, holders in assignment.items():
            pick = holders[r % len(holders)] if holders else None
            out[seg] = pick if (pick is not None and healthy(pick)) \
                else None
        return out


class AdaptiveServerSelector:
    """Latency-EWMA + in-flight aware replica choice
    (adaptiveserverselector/ NumInFlightReqSelector + LatencySelector
    hybrid): score = ewma_latency_ms * (1 + in_flight), scaled by the
    placement-affinity factor when tier residency is known — a replica
    already holding the segment hot (or a warm cube) wins unless its
    latency/in-flight picture is badly worse, and the server-name
    tiebreak keeps repeated picks sticky instead of ping-ponging
    uploads across replicas."""

    ALPHA = 0.3

    def __init__(self):
        self._lock = threading.Lock()
        self._lat: Dict[str, float] = {}
        self._inflight: Dict[str, int] = {}

    def record_start(self, server: str) -> None:
        with self._lock:
            self._inflight[server] = self._inflight.get(server, 0) + 1

    def record_end(self, server: str, latency_ms: float) -> None:
        with self._lock:
            self._inflight[server] = max(
                0, self._inflight.get(server, 1) - 1)
            prev = self._lat.get(server)
            self._lat[server] = latency_ms if prev is None else \
                (1 - self.ALPHA) * prev + self.ALPHA * latency_ms

    def score(self, server: str) -> float:
        return self._score_default(server, 1.0)

    def estimate_ms(self, server: str) -> Optional[float]:
        """Latency EWMA for hedging decisions (None until the first
        completed call establishes an estimate)."""
        with self._lock:
            return self._lat.get(server)

    def _score_default(self, server: str, default: float) -> float:
        """score() with an explicit unknown-latency default (the
        placement-aware path): the stock 1.0 ms optimism makes a
        never-measured replica out-bid a measured one holding the
        segment HOT, ping-ponging uploads across replicas — with
        residency in hand, an unknown server scores like the average
        known one instead."""
        with self._lock:
            return self._lat.get(server, default) * \
                (1 + self._inflight.get(server, 0))

    def select(self, assignment: Dict[str, List[str]],
               healthy, placement=None) -> Dict[str, Optional[str]]:
        with self._lock:
            lats = list(self._lat.values())
        mean_lat = (sum(lats) / len(lats)) if lats else 1.0
        out: Dict[str, Optional[str]] = {}
        for seg, holders in assignment.items():
            cands = [h for h in holders if healthy(h)] or list(holders)
            if not cands:
                out[seg] = None
                continue
            tiers = (placement or {}).get(seg) or {}
            default = mean_lat if tiers else 1.0
            out[seg] = min(
                cands,
                key=lambda h: (self._score_default(h, default)
                               * PLACEMENT_AFFINITY.get(tiers.get(h),
                                                        1.0), h))
        return out


SELECTORS = {
    "balanced": BalancedInstanceSelector,
    "replicaGroup": ReplicaGroupInstanceSelector,
    "strictReplicaGroup": StrictReplicaGroupInstanceSelector,
    "adaptive": AdaptiveServerSelector,
}


def make_selector(kind: str):
    cls = SELECTORS.get(kind)
    if cls is None:
        raise ValueError(f"unknown instance selector {kind!r}; "
                         f"have {sorted(SELECTORS)}")
    return cls()


# ---------------------------------------------------------------------------
# hybrid-table time boundary
# ---------------------------------------------------------------------------

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
    from ..query.sql import SelectStmt  # noqa: F401

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
