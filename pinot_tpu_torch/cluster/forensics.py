"""Query forensics plane: slow-query ring + per-query stats ledger.

Reference parity: the reference's broker query log (BaseBrokerRequest
Handler logs table/timeMs/exceptions per request, rate-limited) and the
/debug/... admin endpoints, collapsed to one broker-side object:

- every completed cluster query builds a VALIDATED ``query_stats``
  ledger record (utils/ledger.py kind: wall ms, partialResult,
  exceptions[] codes, hedge/failover counts, servers queried vs
  responded) and appends it to the configured stats ledger, so chaos
  soaks (tools/chaos_smoke.py) produce per-query trend lines instead of
  only aggregate counters;
- queries that were slow (``OPTION(slowQueryMs=...)`` or the broker
  default), errored, or carried a stitched trace (EXPLAIN ANALYZE) also
  enter a bounded ring buffer served at ``GET /debug/queries`` and
  rendered by the /ui console + controller webapp.

The ring is the one deliberately host-synchronous piece (a deque under
a lock, mutated per query) — it lives on the broker's HTTP path, never
inside kernels.

Port of ``pinot_tpu/cluster/forensics.py``.
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..query.sql import SqlError
from ..utils import ledger as uledger
from ..utils.metrics import global_metrics
from ..utils.slo import global_incidents, global_slo

DEFAULT_SLOW_QUERY_MS = 500.0
DEFAULT_TRACE_RATIO = 0.0
RING_CAPACITY = 128

# process identity for fleet rollups: in-process clusters run several
# node roles in ONE interpreter sharing global_metrics / heat / devmem —
# the controller's rollup dedupes those per-node blocks by this token so
# fleet totals never multiply-count a shared registry
PROC_TOKEN = f"{os.getpid()}-{uuid.uuid4().hex[:6]}"


def parse_slow_query_ms(options: Dict[str, Any],
                        default_ms: float) -> float:
    """Validate OPTION(slowQueryMs=...) up front — a bad value must be a
    400-class SqlError BEFORE any work is dispatched, not a ValueError
    after the scatter already ran."""
    raw = options.get("slowQueryMs")
    if raw is None:
        return default_ms
    try:
        return max(float(raw), 0.0)
    except (TypeError, ValueError):
        raise SqlError(f"invalid slowQueryMs value {raw!r}; "
                       "expected a number of milliseconds") from None


def ratio_value(raw: Any, what: str = "traceRatio") -> float:
    """A sampling ratio in [0, 1] or a 400-class SqlError — shared by
    the per-query option and the broker-default / env configuration so
    a bad PINOT_TRACE_RATIO fails at startup, not per query."""
    try:
        v = float(raw)
    except (TypeError, ValueError):
        raise SqlError(f"invalid {what} value {raw!r}; "
                       "expected a fraction in [0, 1]") from None
    if not 0.0 <= v <= 1.0:
        raise SqlError(f"invalid {what} value {raw!r}; "
                       "expected a fraction in [0, 1]")
    return v


def parse_trace_ratio(options: Dict[str, Any], default: float) -> float:
    """Validate OPTION(traceRatio=...) pre-dispatch (400-class on a bad
    value); absent option -> the broker default."""
    raw = options.get("traceRatio")
    if raw is None:
        return default
    return ratio_value(raw)


def default_trace_ratio(override: Optional[float] = None) -> float:
    """The broker-default sampling ratio, shared by the in-process
    Broker and BrokerNode/QueryForensics so their precedence can't
    diverge: constructor override wins, then PINOT_TRACE_RATIO, then
    off — validated either way, so a bad env value fails at broker
    startup rather than per query."""
    if override is not None:
        return ratio_value(override)
    env_ratio = os.environ.get("PINOT_TRACE_RATIO")
    if env_ratio is not None:
        return ratio_value(env_ratio)
    return DEFAULT_TRACE_RATIO


class QueryForensics:
    """Per-broker forensics state: the slow-query ring and the optional
    query_stats ledger sink."""

    def __init__(self, slow_query_ms: Optional[float] = None,
                 ledger_path: Optional[str] = None,
                 capacity: int = RING_CAPACITY,
                 trace_ratio: Optional[float] = None):
        env_slow = os.environ.get("PINOT_SLOW_QUERY_MS")
        self.default_slow_ms = float(
            slow_query_ms if slow_query_ms is not None
            else env_slow if env_slow is not None
            else DEFAULT_SLOW_QUERY_MS)
        self.ledger_path = (ledger_path
                            or os.environ.get("PINOT_QUERY_STATS_LEDGER")
                            or None)
        # traceRatio production sampling default (OPTION(traceRatio=...)
        # overrides per query)
        self.trace_ratio = default_trace_ratio(trace_ratio)
        self.stats_written = 0
        self.traces_written = 0
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        # epoch for the query_stats ``arrival_ms`` offsets: the ledger's
        # envelope ts has 1 s resolution, far too coarse for the
        # traffic-replay harness's inter-arrival deltas
        # (tools/traffic_replay.py) — arrival offsets are recorded in
        # ms against this per-broker epoch instead
        self._epoch = time.perf_counter()

    # -- recording ---------------------------------------------------------
    def record(self, qid: str, table: Optional[str], sql: str, t0: float,
               result: Optional[Any], scatters: List[Any],
               slow_ms: Optional[float] = None,
               trace: Optional[Any] = None,
               error: Optional[BaseException] = None,
               traced: bool = False,
               workload: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
        """Build + validate the query_stats record for one completed (or
        failed) cluster query; append it to the stats ledger when one is
        configured, and admit slow/errored/traced queries to the ring.
        Returns the validated record."""
        wall_ms = (time.perf_counter() - t0) * 1e3
        threshold = self.default_slow_ms if slow_ms is None else slow_ms
        slow = wall_ms >= threshold
        fields: Dict[str, Any] = {
            "qid": qid,
            "table": table or "<compound>",
            "wall_ms": round(wall_ms, 3),
            "partial": bool(getattr(result, "partial_result", False)),
            "servers_queried": int(
                getattr(result, "num_servers_queried", 0) or 0),
            "servers_responded": int(
                getattr(result, "num_servers_responded", 0) or 0),
            "exception_codes": sorted({
                int(e.get("errorCode", 0))
                for e in getattr(result, "exceptions", []) or []}),
            "sql": sql,
            "hedges": sum(getattr(s, "hedges", 0) for s in scatters),
            "failovers": sum(getattr(s, "failovers", 0)
                             for s in scatters),
            # ms since this broker's forensics epoch: the inter-arrival
            # signal tools/traffic_replay.py replays at multiples
            "arrival_ms": round((t0 - self._epoch) * 1e3, 3),
        }
        if workload:
            # overload plane attribution (broker/workload.py): tenant,
            # degraded rung, and — on a shed — shed/shed_rung/
            # retry_after_ms, the per-table/tenant shed-rate trend line
            # the fleet rollup aggregates
            fields.update(workload)
        if result is not None:
            fields["rows"] = len(result.rows)
            fields["segments_queried"] = result.num_segments
            fields["segments_pruned"] = result.num_segments_pruned
        if slow:
            fields["slow"] = True
        if error is not None:
            fields["error"] = str(error)[:300]
        if traced or trace is not None:
            # stats<->trace join key: the query_trace record in this
            # ledger carries the same qid
            fields["traced"] = True
        serde = sum(getattr(s, "serde_ms", 0.0) for s in scatters)
        net = sum(getattr(s, "net_ms", 0.0) for s in scatters)
        if serde:
            fields["serde_ms"] = round(serde, 3)
        if net:
            fields["net_ms"] = round(net, 3)
        # cross-query micro-batching: fused dispatches this
        # query's server executions participated in + the largest
        # batch shared — the throughput plane's query_stats trend line
        batched = sum(getattr(s, "batched_dispatches", 0)
                      for s in scatters)
        if batched:
            fields["batched"] = batched
            fields["batch_size"] = max(
                getattr(s, "batch_size_max", 0) for s in scatters)
        # placement-affinity routing (HBM tier): segments dispatched to
        # a replica already holding them hot — the per-query
        # avoided-upload trend line the fleet rollup aggregates
        affinity = sum(getattr(s, "affinity_hits", 0) for s in scatters)
        if affinity:
            fields["tier_affinity_hits"] = affinity
        rec = uledger.make_record("query_stats", **fields)
        if self.ledger_path:
            try:
                uledger.append_record(rec, self.ledger_path)
                with self._lock:
                    self.stats_written += 1
            except OSError:
                # observability must never fail the data path: a full
                # disk / missing directory drops the record, counted so
                # the loss is visible (the record itself was VALIDATED
                # above — schema bugs still surface loudly)
                global_metrics.count("query_stats_write_errors")
        if slow or error is not None or trace is not None:
            entry = dict(rec)
            if trace is not None:
                entry["trace"] = (trace.to_dict()
                                  if hasattr(trace, "to_dict") else trace)
            with self._lock:
                self._ring.append(entry)
        # SLO plane feed (utils/slo.py): unarmed this is ONE attribute
        # read — the <1% hot-path overhead contract
        global_slo.observe_query(rec)
        return rec

    def record_trace(self, root: Any, sql: str, qid: str
                     ) -> Optional[Dict[str, Any]]:
        """A sampled production query's span tree -> validated
        ``query_trace`` record in the SAME ledger the query_stats
        records land in, cross-linked by qid (the stats record carries
        ``traced: true``). Returns the validated record (None only when
        no ledger is configured)."""
        rec = uledger.trace_record(root, sql, qid=qid, sampled=True)
        if not self.ledger_path:
            return rec
        try:
            uledger.append_record(rec, self.ledger_path)
            with self._lock:
                self.traces_written += 1
        except OSError:
            # observability must never fail the data path (same policy
            # as the stats record above)
            global_metrics.count("query_trace_write_errors")
        return rec

    # -- serving -----------------------------------------------------------
    def snapshot(self, limit: Optional[int] = None) -> Dict[str, Any]:
        """GET /debug/queries payload: newest first."""
        with self._lock:
            entries = list(self._ring)
        entries.reverse()
        if limit is not None:
            entries = entries[:max(limit, 0)]
        return {"slowQueryMs": self.default_slow_ms,
                "traceRatio": self.trace_ratio,
                "statsLedger": self.ledger_path,
                "statsWritten": self.stats_written,
                "tracesWritten": self.traces_written,
                "count": len(entries),
                "queries": entries}


# ---------------------------------------------------------------------------
# ledger shipping: incremental per-node /debug endpoints the
# controller's ForensicsRollupTask pulls (cluster/rollup.py)
# ---------------------------------------------------------------------------

def parse_since(path: str) -> int:
    """``?since=N`` off a /debug/ledger request path (0 when absent or
    malformed — the puller then re-reads from the start, which is safe:
    the controller advances its cursor from the response's nextSeq)."""
    from urllib.parse import parse_qs, urlparse
    try:
        return max(int(parse_qs(urlparse(path).query)["since"][0]), 0)
    except (KeyError, ValueError, IndexError):
        return 0


def read_ledger_since(path: Optional[str], since: int
                      ) -> Tuple[List[Dict[str, Any]], int]:
    """-> (records after line ``since``, nextSeq = total line count).

    The sequence is the ledger's LINE number (ledgers are append-only
    JSONL, so line order is stable); unparseable lines advance the
    sequence but ship nothing — the controller re-validates every
    record against the utils/ledger contracts anyway. A final line
    WITHOUT a newline terminator is an append still in flight: it must
    not advance the sequence, or the puller's cursor would step past
    the record and permanently drop it once the write completes."""
    records: List[Dict[str, Any]] = []
    seq = 0
    if path and os.path.exists(path):
        with open(path) as fh:
            for i, line in enumerate(fh):
                if not line.endswith("\n"):
                    break   # torn tail: ship it complete, next pull
                seq = i + 1
                if i < since:
                    continue
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                records.append(rec)
    return records, seq


def ledger_debug_payload(node_id: str, role: str, path: Optional[str],
                         since: int, heat_top: int = 64
                         ) -> Dict[str, Any]:
    """GET /debug/ledger payload (brokers AND servers): the incremental
    ledger delta plus the node-local telemetry blocks the rollup carries
    per node — metrics counters/gauges (drift, retraces, batching),
    device-memory pools and the segment-heat table — so one pull per
    node gathers everything the fleet view needs."""
    from ..engine.ragged import batching_health
    from ..engine.tier import global_tier
    from ..utils.devmem import global_device_memory
    from ..utils.heat import global_segment_heat
    records, next_seq = read_ledger_since(path, since)
    snap = global_metrics.snapshot()
    return {"node": node_id, "role": role, "proc": PROC_TOKEN,
            "ledger": path, "since": since, "nextSeq": next_seq,
            "records": records,
            "counters": snap["counters"], "gauges": snap["gauges"],
            "batching": batching_health(snap),
            "memory": global_device_memory.snapshot(),
            "tier": global_tier.snapshot(),
            "heat": global_segment_heat.snapshot(top=heat_top),
            # SLO burn table + incident counts: the rollup
            # aggregates these per node into fleet_rollup.slo
            "slo": global_slo.status_block(),
            "incidents": {"count": global_incidents.snapshot(0)["count"],
                          "captured": global_incidents.captured}}


# the debug surfaces every data-plane role serves at minimum; roles
# extend with their extras (broker: queries/compile/slo; controller
# advertises its own set — it serves /debug/fleet, not node ledgers)
DEBUG_SURFACES = ("/debug/ledger", "/debug/memory", "/debug/incidents")

# roles that serve the incident autopsy plane (cluster/autopsy.py):
# the broker runs it over its node ledger, the controller over the
# fleet ledger — servers have no attribution surface, so advertising
# it there would be a lie the index exists to prevent
AUTOPSY_ROLES = ("broker", "controller")


def debug_index(node_id: str, role: str,
                extra: Tuple[str, ...] = (),
                surfaces: Optional[Tuple[str, ...]] = None
                ) -> Dict[str, Any]:
    """GET /debug payload — the index of every debug surface THIS node
    actually serves (truthful per role), so an operator landing on any
    role can enumerate the forensics endpoints instead of memorizing
    them. ``surfaces`` overrides the data-plane default set.
    ``/debug/autopsy`` is appended here, once, per AUTOPSY_ROLES — one
    source of truth instead of each role's extras drifting."""
    base = tuple(DEBUG_SURFACES if surfaces is None else surfaces)
    out = base + tuple(extra)
    if role in AUTOPSY_ROLES and "/debug/autopsy" not in out:
        out = out + ("/debug/autopsy",)
    return {"node": node_id, "role": role, "proc": PROC_TOKEN,
            "surfaces": sorted(out)}


def memory_debug_payload(node_id: str,
                         residency: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
    """GET /debug/memory payload: what lives in HBM on this node right
    now — per-pool live bytes / entries / evictions (utils/devmem), the
    tier occupancy (engine/tier.py hot/warm/cold + budget), this node's
    per-segment tier residency (servers pass it — the same block their
    heartbeats ship for affinity routing) and the hottest segments
    (utils/heat)."""
    from ..engine.tier import global_tier
    from ..utils.devmem import global_device_memory
    from ..utils.heat import global_segment_heat
    out = {"node": node_id, "proc": PROC_TOKEN,
           "pools": global_device_memory.snapshot(),
           "tier": global_tier.snapshot(),
           "heat": global_segment_heat.snapshot(top=50)}
    if residency is not None:
        out["residency"] = residency
    return out
