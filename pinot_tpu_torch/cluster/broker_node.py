"""Broker node: REST query entry, routing, scatter-gather, failure handling.

Reference parity: pinot-broker/ — PinotClientRequest.java:110 (/query/sql),
BrokerRoutingManager (routing table from the ideal state), instance
selectors (BalancedInstanceSelector round-robin across replicas),
ConnectionFailureDetector (unhealthy on failure, exponential-backoff
retry), and SingleConnectionBrokerRequestHandler.java:141-151
(scatter over servers, gather DataTables, reduce). Scatter here is
threaded HTTP to server nodes; partials come back in the serde wire
format and reduce through the same BrokerReduceService analog the
in-process broker uses.

Port of ``pinot_tpu/cluster/broker_node.py``: the same routes, wire
formats, error codes (200, 250, 427), replica retry and hedging. Joins and
windows are refused as in the reference. The incident autopsy
(``cluster/autopsy.py``) runs after each incident capture, answers
``/debug/autopsy`` and annotates an ``OPTION(whydown=true)`` trace. The
compile plane is JAX-only: the health block has no
``compile`` entry and there is no ``/debug/compile``.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
import urllib.error
import uuid
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..engine.reduce import ResultTable, reduce_partials

from ..query.context import build_query_context
from ..query.sql import SetOpStmt, SqlError, parse_sql, to_sql
from ..utils import phases as ph
from ..utils.metrics import global_metrics, ingest_health
from ..utils.spans import Span, sample_decision, span, span_tracer
from ..utils.slo import SLOWQ_TAIL, global_incidents, global_slo
from .forensics import (QueryForensics, debug_index,
                        ledger_debug_payload, memory_debug_payload,
                        parse_since, parse_slow_query_ms,
                        parse_trace_ratio)
from .http_util import (JsonHandler, http_json, http_raw,
                        inject_trace_context, start_http)
from .autopsy import global_autopsy, load_corpus, whydown

# pinot-common QueryException error-code analogs (the exceptions[] wire
# contract the webapp/console already renders)
ERR_QUERY_EXECUTION = 200      # server answered with an application error
ERR_BROKER_TIMEOUT = 250       # query deadline exhausted mid-scatter
ERR_SERVER_NOT_RESPONDED = 427  # transport failure / no replica left


class ScatterTimeoutError(SqlError):
    """The query's timeoutMs budget ran out while scattering."""


def _parse_timeout_ms(options: Dict[str, Any]) -> int:
    """Validate OPTION(timeoutMs=...) up front: a bad value must be a
    400-class SqlError, never a ValueError escaping as a 500."""
    from ..broker.broker import DEFAULT_TIMEOUT_MS
    raw = options.get("timeoutMs", DEFAULT_TIMEOUT_MS)
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise SqlError(f"invalid timeoutMs value {raw!r}; "
                       "expected an integer of milliseconds") from None


class ReplicaExhaustedError(SqlError):
    """No healthy replica left for a segment — an availability failure
    (exceptions[] code 427), not a query-execution error."""


class _SegmentShortfall(Exception):
    """A server answered 200 but ran fewer segments than asked — it is
    mid-(re)load after a heartbeat loss / reassignment and silently
    skips segments it doesn't hold yet. Classified with the transport
    failures so the caller fails over instead of reducing over a
    silent subset (found by the chaos soak: heartbeat churn under CPU
    starvation produced exact-looking partial answers)."""


@dataclass
class ScatterResult:
    """One scatter-gather's partials + the health metadata the response
    envelope carries (BrokerResponseNative analog). failovers/hedges are
    the PER-QUERY counts (global_metrics keeps the process-wide totals)
    so the forensics plane can write per-query trend lines."""
    partials: List[Any] = field(default_factory=list)
    segments_queried: int = 0
    pruned: int = 0
    servers_queried: int = 0
    servers_responded: int = 0
    exceptions: List[Dict[str, Any]] = field(default_factory=list)
    partial: bool = False
    failovers: int = 0
    hedges: int = 0
    # serde vs true-network split of the net gap, summed over
    # this scatter's calls: serde_ms = server-side frame encode +
    # broker-side decode; net_ms = call wall - remote tree - serde
    # (only measured on sampled/traced calls, where the remote tree
    # exists to subtract)
    serde_ms: float = 0.0
    net_ms: float = 0.0
    # cross-query micro-batching participation (engine/ragged.py via
    # the server wire header): fused dispatches this query's server
    # executions rode, and the largest batch any of them shared
    batched_dispatches: int = 0
    batch_size_max: int = 0
    # placement-affinity routing (HBM tier): segments this scatter sent
    # to a replica already holding them hot (or a warm cube) — the
    # per-query avoided-upload count (set on the scatter thread before
    # dispatch, never from pool threads)
    affinity_hits: int = 0
    # failovers/serde/net increment from call() on POOL threads —
    # float/int += is a non-atomic read-modify-write (the same race _rr
    # hit before its itertools.count fix), so they mutate under this lock
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)
    # set when the gather returns: an ABANDONED hedge straggler's late
    # response must not add its serde/net to a query_stats record that
    # is being (or has been) written — the span plane snapshots
    # `collect` for the same reason
    _closed: bool = field(default=False, repr=False, compare=False)

    def add_wire_times(self, serde: float, net: float = 0.0) -> None:
        with self._lock:
            if self._closed:
                return
            self.serde_ms += serde
            self.net_ms += net

    def add_batching(self, dispatches: int, batch_size: int) -> None:
        with self._lock:
            if self._closed:
                return
            self.batched_dispatches += int(dispatches)
            self.batch_size_max = max(self.batch_size_max,
                                      int(batch_size))

    def close_wire_times(self) -> None:
        with self._lock:
            self._closed = True


class FailureDetector:
    """Consecutive-failure marking with exponential backoff retry
    (BaseExponentialBackoffRetryFailureDetector analog)."""

    def __init__(self, base_backoff: float = 0.5, max_backoff: float = 30.0):
        self._fails: Dict[str, int] = {}
        self._until: Dict[str, float] = {}
        self._base = base_backoff
        self._max = max_backoff
        self._lock = threading.Lock()

    def healthy(self, server: str) -> bool:
        with self._lock:
            return time.monotonic() >= self._until.get(server, 0.0)

    def record_failure(self, server: str) -> None:
        with self._lock:
            n = self._fails.get(server, 0) + 1
            self._fails[server] = n
            backoff = min(self._base * (2 ** (n - 1)), self._max)
            self._until[server] = time.monotonic() + backoff

    def record_success(self, server: str) -> None:
        with self._lock:
            self._fails.pop(server, None)
            self._until.pop(server, None)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-server consecutive-failure state for /metrics and the UI."""
        now = time.monotonic()
        with self._lock:
            servers = set(self._fails) | set(self._until)
            return {s: {
                "consecutiveFailures": self._fails.get(s, 0),
                "backoffRemainingS": round(
                    max(self._until.get(s, 0.0) - now, 0.0), 3),
            } for s in sorted(servers)}


class BrokerNode:
    def __init__(self, controller_url: str, port: int = 0,
                 routing_refresh: float = 0.3,
                 instance_selector: str = "balanced",
                 slow_query_ms: Optional[float] = None,
                 query_stats_path: Optional[str] = None,
                 trace_ratio: Optional[float] = None,
                 instance_id: Optional[str] = None):
        import os
        from ..broker.quota import QueryQuotaManager
        from ..broker.routing import make_selector
        from ..broker.workload import global_workload
        # overload protection: per-tenant budget admission +
        # the watermark degradation ladder, shared process-global with
        # the in-process broker (tenant isolation is per process)
        self.workload = global_workload
        self.controller_url = controller_url
        self.routing_refresh = routing_refresh
        # fleet identity: brokers register with the controller
        # like servers do (role "broker"), so the ForensicsRollupTask can
        # discover and pull their ledgers; live_servers() filters on role,
        # so broker registration never perturbs segment assignment
        self._instance_id = instance_id   # default derived after bind
        self.advertise_host = (os.environ.get("PINOT_ADVERTISE_HOST")
                               or "127.0.0.1")
        # forensics plane: slow-query ring (GET /debug/queries) + the
        # optional per-query query_stats ledger (chaos soak trend lines)
        # + the traceRatio production-sampling default
        self.forensics = QueryForensics(slow_query_ms=slow_query_ms,
                                        ledger_path=query_stats_path,
                                        trace_ratio=trace_ratio)
        # SLO plane: burn alerts / slo_status / incident
        # bundles default into the SAME stats ledger so /debug/ledger
        # ships them to the fleet rollup with zero extra config, and
        # the broker donates its slow-query ring tail to the incident
        # flight recorder's bundle (utils/ cannot import cluster state)
        if self.forensics.ledger_path:
            if global_slo.path is None:
                global_slo.path = self.forensics.ledger_path
            if global_incidents.path is None:
                global_incidents.path = self.forensics.ledger_path
            # incident autopsy plane: verdicts land in the SAME ledger,
            # and attribution runs automatically after each incident
            # capture — on the recorder's background thread, fenced,
            # never on the query path
            if global_autopsy.path is None:
                global_autopsy.path = self.forensics.ledger_path
            if global_incidents.post_hook is None:
                global_incidents.post_hook = global_autopsy.on_incident
        global_incidents.register_surface(
            "slow_queries",
            lambda: self.forensics.snapshot(SLOWQ_TAIL)["queries"])
        self._routing: Dict[str, Any] = {"version": -1}
        # round-robin cursor for explain/failover re-picks. An itertools
        # counter, not an int += 1: _pick_replica runs on pool threads
        # during failover, and the unlocked read-modify-write lost
        # increments (next() is a single atomic step under the GIL)
        self._rr = itertools.count(1)
        self._failures = FailureDetector()
        self._selector = make_selector(instance_selector)
        self._quota = QueryQuotaManager()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=16)
        self._httpd, self.port, _ = start_http(self._make_handler(), port)
        # the default identity is STABLE across restarts (host + bound
        # port, like operator-named servers), not a fresh random token:
        # the controller's rollup cursors key on this id, and a restart
        # under a new id would re-ship the broker's whole ledger into
        # the fleet ledger as duplicates
        self.instance_id = (self._instance_id
                            or f"broker_{self.advertise_host}_{self.port}")
        try:
            # best-effort: the controller may be an HA standby (503) or
            # briefly down — the loop below retries via the 404 path
            self._register()
        except Exception:
            pass
        self._refresh_routing()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _register(self) -> None:
        http_json("POST", f"{self.controller_url}/instances", {
            "id": self.instance_id, "host": self.advertise_host,
            "port": self.port, "role": "broker"})

    # -- routing -----------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.routing_refresh):
            epoch = None
            try:
                try:
                    resp = http_json(
                        "POST", f"{self.controller_url}/heartbeat/"
                                f"{self.instance_id}")
                    # assignment-version epoch: the
                    # heartbeat response names the controller's current
                    # version, so a rebalance flip that lands mid-poll
                    # converges on THIS tick instead of the next one
                    epoch = (resp or {}).get("version")
                except urllib.error.HTTPError as e:
                    if e.code != 404:
                        raise
                    # restarted controller with empty ephemeral state:
                    # re-announce (same rule as ServerNode._loop)
                    self._register()
            except Exception:
                pass
            try:
                self._refresh_routing()
                if epoch is not None and \
                        self._routing.get("version", -1) < epoch:
                    # the refresh raced a concurrent flip: the epoch
                    # proves a newer assignment exists — re-fetch now
                    self._refresh_routing()
            except Exception:
                pass

    def _refresh_routing(self) -> None:
        snap = http_json("GET", f"{self.controller_url}/routing")
        with self._lock:
            # always swap: instance host/port and liveServers are
            # heartbeat-driven, NOT version-driven — a rolled server
            # re-registers on a new port with the assignment version
            # unchanged, and a version-gated swap would keep routing
            # queries to the dead port forever (found by the rolling-
            # upgrade compat verifier). Consumers take one
            # snapshot reference, so the whole-dict swap stays
            # tear-free.
            self._routing = snap

    def wait_for_version(self, version: int, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._routing.get("version", -1) >= version:
                return True
            try:
                self._refresh_routing()
            except Exception:
                pass
            time.sleep(0.05)
        return False

    def _server_url(self, server_id: str) -> Optional[str]:
        inst = self._routing.get("instances", {}).get(server_id)
        if inst is None:
            return None
        return f"http://{inst['host']}:{inst['port']}"

    def _route(self, table: str) -> Dict[str, List[str]]:
        """segment -> replica server ids, from the cached ideal state."""
        with self._lock:
            assignment = self._routing.get("assignment", {}).get(table)
        if assignment is None:
            raise SqlError(f"table {table!r} not found in routing")
        return assignment

    def _pick_replica(self, holders: List[str]) -> Optional[str]:
        candidates = [h for h in holders if self._failures.healthy(h)
                      and self._server_url(h)]
        if not candidates:
            # all backed off: try anyway rather than failing outright
            candidates = [h for h in holders if self._server_url(h)]
        if not candidates:
            return None
        return candidates[next(self._rr) % len(candidates)]

    # -- query path --------------------------------------------------------
    def _snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return self._routing

    def _table_config(self, table: str,
                      snap: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
        snap = snap if snap is not None else self._snapshot()
        return (snap.get("tables", {}).get(table) or {}).get("config") or {}

    def _placement(self, table: str,
                   snap: Dict[str, Any]) -> Dict[str, Dict[str, str]]:
        """{segment: {server: tier}} from the heartbeat-shipped
        residency blocks (HBM tier placement signal); empty when no
        server reports residency for this table."""
        out: Dict[str, Dict[str, str]] = {}
        for sid, inst in (snap.get("instances") or {}).items():
            res = (inst.get("residency") or {}).get(table) or {}
            for seg, tier in res.items():
                out.setdefault(seg, {})[sid] = tier
        return out

    def _segment_meta(self, table: str,
                      snap: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
        snap = snap if snap is not None else self._snapshot()
        return {s: (e or {}).get("meta")
                for s, e in (snap.get("segments", {}).get(table)
                             or {}).items()}

    def _check_quota(self, table: str,
                     snap: Optional[Dict[str, Any]] = None) -> None:
        snap = snap if snap is not None else self._snapshot()
        qps = self._table_config(table, snap).get("quotaQps")
        # the reference divides the table quota by the number of LIVE
        # brokers (external-view-change analog): the controller ships
        # the heartbeat-fresh broker list in every routing snapshot
        self._quota.set_num_brokers(len(snap.get("liveBrokers") or [])
                                    or 1)
        self._quota.set_quota(table, qps)
        self._quota.check(table)

    def _resolve_workload_tenant(self, table: Optional[str]) -> None:
        """Refresh the workload manager's table->tenant mapping from
        the routing snapshot's table config (the TableConfig ``tenant``
        field as shipped by the controller; hybrid logical names fall
        back to the _OFFLINE half's config)."""
        if not table:
            return
        cfg = self._table_config(table)
        if not cfg:
            cfg = self._table_config(f"{table}_OFFLINE")
        self.workload.set_table_tenant(table, cfg.get("tenant"))

    @staticmethod
    def _workload_fields(ticket) -> Optional[Dict[str, Any]]:
        """query_stats ledger fields for an ADMITTED query's workload
        attribution (the shed path builds its own)."""
        if ticket is None:
            return None
        out: Dict[str, Any] = {"tenant": ticket.tenant}
        if ticket.rung:
            out["rung"] = ticket.rung
        return out

    def query(self, sql: str) -> ResultTable:
        t0 = time.perf_counter()
        stmt = parse_sql(sql)
        from ..query.sql import DdlStmt
        if isinstance(stmt, DdlStmt):
            raise SqlError(
                "view DDL runs on the in-process broker (views are "
                "broker-local state; the networked broker carries no "
                "catalog yet)")
        # validate the forensics options up front (400-class, pre-dispatch)
        options = getattr(stmt, "options", {}) or {}
        slow_ms = parse_slow_query_ms(options,
                                      self.forensics.default_slow_ms)
        ratio = parse_trace_ratio(options, self.forensics.trace_ratio)
        # a client-supplied OPTION(queryId=...) is what makes the
        # deterministic sampling AND shed decisions hold ACROSS broker
        # replicas and client retries — without it each broker draws a
        # fresh uuid and only same-broker machinery (failover/hedge
        # attempts, which share this qid via traceContext) agrees
        qid = str(options.get("queryId") or uuid.uuid4().hex[:12])[:64]
        table = getattr(stmt, "table", None)
        # overload admission (broker/workload.py) once per
        # user query, before any planning/dispatch work. Plan-only
        # EXPLAIN skips (nothing to protect); a shed is recorded as a
        # query_stats row (tenant/rung/retryAfterMs) so the fleet
        # rollup trends shed rates, then surfaces as the structured
        # 429 (the /query/sql handler renders e.payload()).
        from ..broker.workload import (OverloadShedError, clamp_brownout,
                                       leaf_table, parse_retry_attempt)
        retry_attempt = parse_retry_attempt(options)
        ticket = None
        if not getattr(stmt, "explain", False) or \
                getattr(stmt, "analyze", False):
            wl_table = table or leaf_table(stmt)
            self._resolve_workload_tenant(wl_table)
            try:
                ticket = self.workload.admit(
                    qid, wl_table, retry_attempt=retry_attempt)
            except OverloadShedError as e:
                self.forensics.record(
                    qid, table, sql, t0, None, [], slow_ms, error=e,
                    workload={"tenant": e.tenant, "tier": e.tier,
                              "shed": True, "shed_rung": e.rung,
                              "retry_after_ms": e.retry_after_ms})
                raise
            if ticket.brownout:
                # rung-3 brownout: every admitted query clamps to the
                # floor deadline and runs with partial-result
                # semantics — a degraded answer beats a metastable
                # retry storm (one shared helper so the two brokers'
                # ladders can't drift)
                from ..broker.broker import DEFAULT_TIMEOUT_MS
                clamp_brownout(stmt.options, DEFAULT_TIMEOUT_MS)
        result: Optional[ResultTable] = None
        try:
            if getattr(stmt, "analyze", False):
                result = self._query_analyze(stmt, sql, t0, slow_ms)
                return result
            # traceRatio production sampling: deterministic in the qid
            # so replicas/retries agree when the client names the
            # query; a sampled query roots the SAME span tree EXPLAIN
            # ANALYZE uses (the scatter then propagates sampled=true
            # traceContext to every server), zero spans when unsampled.
            # EXPLAIN (plan-only) never samples, and rung >= 1 sheds
            # this speculative work entirely.
            sampled = (not getattr(stmt, "explain", False)
                       and not (ticket is not None and ticket.degraded)
                       and sample_decision(qid, ratio))
            scatters: List[ScatterResult] = []
            root: Optional[Span] = None
            if sampled:
                root = span_tracer.start(ph.QUERY, table=table,
                                         query_id=qid, sampled=True)
            try:
                try:
                    result = self._query_stmt(
                        stmt, sql, t0, qid, scatters,
                        workload=None if ticket is None else
                        {"tenant": ticket.tenant, "tier": ticket.tier})
                finally:
                    if sampled:
                        # stop on EVERY exit: a leaked thread-local
                        # stack would silently trace the next query on
                        # this HTTP worker thread
                        root = span_tracer.stop() or root
            except SqlError as e:
                if sampled and root is not None:
                    # the stats record below is flagged traced=true, so
                    # the trace record must exist for the qid join to
                    # hold — a failed query's spans are exactly the
                    # wanted ones
                    root.annotate(error=str(e)[:200])
                    self.forensics.record_trace(root, sql, qid)
                self.forensics.record(qid, table, sql, t0, None,
                                      scatters, slow_ms, trace=root,
                                      error=e, traced=sampled,
                                      workload=self._workload_fields(
                                          ticket))
                raise
            if sampled:
                root.annotate(
                    rows=len(result.rows),
                    servers_queried=result.num_servers_queried,
                    servers_responded=result.num_servers_responded)
                global_metrics.count("sampled_traces")
                self.forensics.record_trace(root, sql, qid)
            self.forensics.record(qid, table, sql, t0, result, scatters,
                                  slow_ms, trace=root, traced=sampled,
                                  workload=self._workload_fields(ticket))
            return result
        finally:
            # result-bytes estimate feeds the tenant's post-paid bucket
            # (the cluster broker never runs the engine's track_result
            # fence itself — the reduced rows are its usage signal)
            est = 0
            if result is not None:
                est = len(result.rows) * max(len(result.columns), 1) * 8
            self.workload.release(ticket, result_bytes=est or None)

    def _query_stmt(self, stmt, sql: str, t0: float, qid: str,
                    scatters: List["ScatterResult"],
                    workload: Optional[Dict[str, Any]] = None
                    ) -> ResultTable:
        """One statement through routing/scatter/reduce. ``scatters``
        collects every ScatterResult this statement dispatched so the
        caller (forensics, EXPLAIN ANALYZE) sees per-query hedge and
        failover counts. ``workload`` is the admitted query's
        tenant/tier attribution, forwarded on every server dispatch so
        the server-side accountant registers it too — the tier-aware
        HeapWatcher kill ordering and the post-paid cpu budgets run
        where the work actually executes, not just at the broker."""
        if isinstance(stmt, SetOpStmt):
            return self._query_setop(stmt, t0, qid, scatters, workload)
        from ..multistage.window import has_window
        if stmt.joins or has_window(stmt):
            raise SqlError("multi-stage joins/windows over the remote data "
                           "plane arrive with the dispatch stage; use the "
                           "in-process broker for them")

        # one snapshot for the whole query: hybrid detection, quota, time
        # boundary, pruning, and scatter must agree on routing state (the
        # refresh thread swaps self._routing underneath)
        snap = self._snapshot()
        # the query's timeoutMs is a BUDGET for the whole scatter: every
        # server call gets the remaining slice, and servers receive it as
        # deadlineMs so their accountant deadline is min(own, remaining)
        timeout_ms = _parse_timeout_ms(stmt.options)
        deadline = t0 + timeout_ms / 1e3
        snap_tables = snap.get("tables", {})
        if stmt.table not in snap_tables and \
                f"{stmt.table}_OFFLINE" in snap_tables and \
                f"{stmt.table}_REALTIME" in snap_tables:
            return self._query_hybrid(stmt, t0, snap, deadline, qid,
                                      scatters, workload)

        self._check_quota(stmt.table, snap)
        ctx = build_query_context(stmt)
        if stmt.explain:
            return self._explain_remote(sql, ctx.table, deadline)
        sc = self._scatter(sql, ctx, snap, deadline, qid, workload)
        scatters.append(sc)
        with span(ph.REDUCE, partials=len(sc.partials)):
            result = reduce_partials(ctx, sc.partials)
        result.num_segments = sc.segments_queried
        result.num_segments_pruned = sc.pruned
        self._attach_scatter_meta(result, [sc])
        result.time_ms = (time.perf_counter() - t0) * 1e3
        return result

    # -- EXPLAIN ANALYZE over the cluster plane ----------------------------
    def _query_analyze(self, stmt, sql: str, t0: float,
                       slow_ms: float) -> ResultTable:
        """Execute the statement for real under the span tracer, with
        cross-node propagation: every scatter call carries a sampled
        trace context, each server roots a remote span tree around its
        executor, and the broker stitches the trees — hedges, failovers
        and error branches included — under the scatter_call spans that
        dispatched them. Renders the same Node/Id/Parent/Time_Ms rows
        as the in-process broker (query/explain.py); the gap between a
        call span and its server_query child is the network +
        serialization cost (``net_ms``)."""
        from ..query.explain import finalize_analyze
        stmt.analyze = False  # the re-entrant path executes normally
        qid = uuid.uuid4().hex[:12]
        table = getattr(stmt, "table", None)
        scatters: List[ScatterResult] = []
        root = span_tracer.start(ph.QUERY, table=table, query_id=qid)
        err: Optional[SqlError] = None
        inner: Optional[ResultTable] = None
        try:
            inner = self._query_stmt(stmt, sql, t0, qid, scatters)
        except SqlError as e:
            err = e
        finally:
            root = span_tracer.stop() or root
        if err is not None:
            # the partial tree still reaches the forensics ring: a failed
            # analyze is exactly when the spans are wanted
            self.forensics.record(qid, table, sql, t0, None, scatters,
                                  slow_ms, trace=root, error=err,
                                  traced=True)
            raise err
        root.annotate(rows=len(inner.rows),
                      servers_queried=inner.num_servers_queried,
                      servers_responded=inner.num_servers_responded,
                      partial=inner.partial_result or None)
        cols, rows, trace = finalize_analyze(root)
        result = ResultTable(cols, rows, num_segments=inner.num_segments)
        result.trace = trace
        result.partial_result = inner.partial_result
        result.num_servers_queried = inner.num_servers_queried
        result.num_servers_responded = inner.num_servers_responded
        result.exceptions = list(inner.exceptions)
        result.time_ms = (time.perf_counter() - t0) * 1e3
        self.forensics.record(qid, table, sql, t0, result, scatters,
                              slow_ms, trace=root, traced=True)
        # whydown lane: OPTION(whydown=true) annotates the analyze trace
        # with the cross-plane events overlapping this query's wall
        # window. AFTER forensics.record, so the query's own stats line
        # anchors the ledger-position overlap
        from ..query.planner import _truthy
        options = getattr(stmt, "options", {}) or {}
        if _truthy(options.get("whydown", False)) and \
                self.forensics.ledger_path:
            trace["whydown"] = whydown(
                load_corpus(self.forensics.ledger_path), qid=qid)
        return result

    @staticmethod
    def _attach_scatter_meta(result: ResultTable,
                             scatters: List[ScatterResult]) -> None:
        result.num_servers_queried = sum(s.servers_queried
                                         for s in scatters)
        result.num_servers_responded = sum(s.servers_responded
                                           for s in scatters)
        for s in scatters:
            result.exceptions.extend(s.exceptions)
        result.partial_result = any(s.partial for s in scatters)
        if result.partial_result:
            global_metrics.count("scatter_partial_responses")

    def _query_hybrid(self, stmt, t0: float, snap: Dict[str, Any],
                      deadline: Optional[float] = None,
                      qid: Optional[str] = None,
                      scatters_out: Optional[List["ScatterResult"]] = None,
                      workload: Optional[Dict[str, Any]] = None
                      ) -> ResultTable:
        from ..broker.routing import (resolve_time_column, split_hybrid,
                                      time_boundary)
        logical = stmt.table
        off_table = f"{logical}_OFFLINE"
        self._check_quota(off_table, snap)  # charges EXPLAIN too
        time_col = resolve_time_column(
            self._table_config(off_table, snap),
            (snap.get("tables", {}).get(off_table) or {}).get("schema"))
        if not time_col:
            raise SqlError(
                f"hybrid table {logical!r} needs a timeColumn in its "
                f"config or a DATE_TIME schema field")
        boundary = time_boundary(
            self._segment_meta(off_table, snap), time_col)
        if boundary is None:
            raise SqlError(f"hybrid table {logical!r}: offline segments "
                           f"lack {time_col!r} metadata for the boundary")
        off, rt = split_hybrid(stmt, time_col, boundary)
        if stmt.explain:
            return self._explain_remote("EXPLAIN " + to_sql(off),
                                        off.table, deadline)
        scatters: List[ScatterResult] = []
        for part_stmt in (off, rt):
            ctx_p = build_query_context(part_stmt)
            scatters.append(
                self._scatter(to_sql(part_stmt), ctx_p, snap, deadline,
                              qid, workload))
        if scatters_out is not None:
            scatters_out.extend(scatters)
        with span(ph.REDUCE,
                  partials=sum(len(s.partials) for s in scatters)):
            result = reduce_partials(
                build_query_context(off),
                [p for s in scatters for p in s.partials])
        result.num_segments = sum(s.segments_queried for s in scatters)
        result.num_segments_pruned = sum(s.pruned for s in scatters)
        self._attach_scatter_meta(result, scatters)
        result.time_ms = (time.perf_counter() - t0) * 1e3
        return result

    def _explain_remote(self, sql: str, table: str,
                        deadline: Optional[float] = None) -> ResultTable:
        # plan shape is identical across servers: ask any holder, with the
        # same failover + failure-detector recording and the same
        # remaining-deadline budget as the data path
        assignment = self._route(table)
        for seg, holders in assignment.items():
            tried: set = set()
            while True:
                pick = self._pick_replica(
                    [h for h in holders if h not in tried])
                if pick is None:
                    break
                rem = None if deadline is None \
                    else deadline - time.perf_counter()
                if rem is not None and rem <= 0:
                    raise ScatterTimeoutError(
                        "query deadline exhausted while explaining")
                try:
                    resp = http_json(
                        "POST", f"{self._server_url(pick)}/query",
                        {"sql": sql},
                        timeout=10.0 if rem is None else max(rem, 0.05))
                except urllib.error.HTTPError as e:
                    # application error: surface it, keep health intact
                    self._failures.record_success(pick)
                    try:
                        detail = e.read().decode()[:200]
                    except Exception:
                        detail = str(e)
                    raise SqlError(f"server {pick} rejected explain: "
                                   f"{detail}") from None
                except Exception:
                    tried.add(pick)
                    self._failures.record_failure(pick)
                    continue
                self._failures.record_success(pick)
                exp = resp.get("explain", {})
                return ResultTable(exp.get("columns", []),
                                   [tuple(r) for r in exp.get("rows", [])])
        raise SqlError("no live replica to explain against")

    @staticmethod
    def _parse_hedge_option(ctx) -> Optional[float]:
        """Validate OPTION(hedgeMs=...) once, BEFORE dispatch: a bad
        value must be a 400-class SqlError, not a ValueError escaping
        mid-gather with futures in flight. None = option absent;
        0.0 = explicitly disabled."""
        raw = ctx.options.get("hedgeMs")
        if raw is None:
            return None
        try:
            v = float(raw)
        except (TypeError, ValueError):
            raise SqlError(f"invalid hedgeMs value {raw!r}; "
                           "expected a number of milliseconds") from None
        return max(v, 0.0)

    def _hedge_threshold_ms(self, hedge_opt: Optional[float],
                            server: str) -> Optional[float]:
        """When to re-dispatch a straggling server's segments elsewhere:
        a validated OPTION(hedgeMs=...) wins (0 disables); otherwise 3x
        the adaptive selector's latency EWMA for that server, floored at
        150 ms — the EWMA mixes query shapes, so a low floor would hedge
        every legitimately-heavy query after a stream of cheap ones
        (duplicated dispatch exactly when the cluster is loaded). A
        hedge fires at most once per group either way. Overload rung
        >= 1 disables hedging outright — speculative duplicate
        dispatch is the FIRST work the degradation ladder sheds."""
        if self.workload.governor.rung() >= 1:
            return None
        if hedge_opt is not None:
            return hedge_opt if hedge_opt > 0 else None
        est = getattr(self._selector, "estimate_ms", None)
        if est is not None:
            e = est(server)
            if e is not None:
                return max(3.0 * e, 150.0)
        return None

    def _scatter(self, sql: str, ctx,
                 snap: Optional[Dict[str, Any]] = None,
                 deadline: Optional[float] = None,
                 qid: Optional[str] = None,
                 workload: Optional[Dict[str, Any]] = None
                 ) -> ScatterResult:
        # one snapshot for assignment + segment metadata: the refresh
        # thread swaps self._routing, and mixing two snapshots could
        # silently drop segments assigned in one but absent in the other
        if snap is None:
            snap = self._snapshot()
        # tracing: when this query runs under the span tracer (EXPLAIN
        # ANALYZE rooted a tree on THIS thread), every dispatch attempt
        # gets a scatter_call span. call() runs on pool threads, so the
        # spans are built explicitly and collected here (list.append is
        # GIL-atomic), then stitched under the scatter span start-ordered
        collect: Optional[List[Span]] = \
            [] if span_tracer.active() else None
        sampled = collect is not None
        assignment = snap.get("assignment", {}).get(ctx.table)
        if assignment is None:
            raise SqlError(f"table {ctx.table!r} not found in routing")
        seg_entries = snap.get("segments", {}).get(ctx.table) or {}

        from ..query.planner import _truthy
        allow_partial = _truthy(ctx.options.get("allowPartialResults"))
        hedge_opt = self._parse_hedge_option(ctx)
        res = ScatterResult()

        # broker-side pruning over controller-held segment metadata; an
        # assigned segment with no metadata entry is never pruned
        from ..broker.routing import prune_segments
        meta = {s: (seg_entries.get(s) or {}).get("meta")
                for s in assignment}
        keep, res.pruned = prune_segments(
            meta, ctx.filter,
            (snap.get("tables", {}).get(ctx.table) or {}).get("config"))
        keep_set = set(keep)
        assignment = {s: h for s, h in assignment.items() if s in keep_set}

        # drop holders with no known URL up front so selector fallbacks
        # can only pick reachable servers
        assignment = {s: [h for h in holders if self._server_url(h)]
                      for s, holders in assignment.items()}

        # instance selection (pluggable: balanced / replicaGroup /
        # strictReplicaGroup / adaptive) — placement-aware: the
        # residency heartbeats tell the adaptive selector which
        # replicas already hold each segment hot (HBM tier)
        def healthy(h: str) -> bool:
            return self._failures.healthy(h)

        placement = self._placement(ctx.table, snap)
        picks = self._selector.select(assignment, healthy,
                                      placement=placement)
        if placement:
            # avoided-vs-paid uploads: a pick landing on a replica
            # that holds the segment hot (or a warm cube) skips the
            # column upload entirely. Segments NO server reported
            # residency for (heartbeat cap, table not yet surveyed)
            # count neither way — they would understate the hit ratio
            # through no fault of the routing
            for seg, pick in picks.items():
                tiers = placement.get(seg)
                if pick is None or not tiers:
                    continue
                if tiers.get(pick) in ("hot", "cube"):
                    res.affinity_hits += 1
                    global_metrics.count("tier_affinity_hits")
                else:
                    global_metrics.count("tier_affinity_misses")
        unserved = [s for s, p in picks.items() if p is None]
        if unserved:
            msg = (f"no live replica for segments {unserved[:3]}"
                   f"{'...' if len(unserved) > 3 else ''}")
            if not allow_partial:
                raise SqlError(msg)
            res.exceptions.append({"errorCode": ERR_SERVER_NOT_RESPONDED,
                                   "message": msg})
            res.partial = True
        by_server: Dict[str, List[str]] = {}
        for seg, pick in picks.items():
            if pick is not None:
                by_server.setdefault(pick, []).append(seg)

        adaptive = getattr(self._selector, "record_start", None)

        def remaining() -> Optional[float]:
            return None if deadline is None \
                else deadline - time.perf_counter()

        def attempt_span(server: str, segs: List[str],
                         attempt: str) -> Optional[Span]:
            if collect is None:
                return None
            # every later-written key is pre-seeded (None renders as
            # absent): an ABANDONED straggler may annotate from its pool
            # thread while the broker thread renders the tree, and value
            # overwrites of existing keys never resize the attrs dict
            # under that iteration (a fresh key insertion could)
            s = Span(ph.SCATTER_CALL, server=server, segments=len(segs),
                     attempt=attempt, span_id=uuid.uuid4().hex[:8],
                     status=None, error=None, net_ms=None, serde_ms=None)
            collect.append(s)
            return s

        def call(server: str, segs: List[str], retry: bool = True,
                 attempt: str = "primary", rerouted: bool = False):
            url = self._server_url(server)
            sp = attempt_span(server, segs, attempt)
            rem = remaining()
            if rem is not None and rem <= 0:
                if sp is not None:
                    sp.finish()
                    sp.annotate(status="deadline")
                raise ScatterTimeoutError(
                    f"query deadline exhausted before dispatch to "
                    f"{server}")
            if adaptive:
                self._selector.record_start(server)
            tcall = time.perf_counter()
            try:
                from ..engine.datablock import decode_wire_frame
                from ..utils.faults import corrupt_bytes
                body = {"sql": sql, "segments": segs}
                if workload:
                    # tenant/tier attribution crosses the wire: the
                    # server registers its accountant entry with it
                    body["workload"] = workload
                if qid is not None or sampled:
                    # cross-node trace context: query id + sampled flag
                    # + the dispatching span, so the server's remote
                    # tree stitches back under THIS attempt
                    inject_trace_context(
                        body, query_id=qid, sampled=sampled,
                        parent_span_id=None if sp is None
                        else sp.attrs["span_id"],
                        remaining_ms=None if rem is None else rem * 1e3)
                if rem is not None:
                    # the server clamps its accountant deadline to
                    # min(its own timeoutMs, this remaining budget)
                    body["deadlineMs"] = int(rem * 1e3)
                raw = http_raw("POST", f"{url}/query/bin", body,
                               timeout=10.0 if rem is None
                               else max(rem, 0.05))
                raw = corrupt_bytes("wire.corrupt", server, raw)
                t_dec = time.perf_counter()
                header, decoded = decode_wire_frame(raw)
                dec_ms = (time.perf_counter() - t_dec) * 1e3
                n_run = int(header.get("segmentsQueried", 0))
                if n_run < len(segs):
                    raise _SegmentShortfall(
                        f"server {server} ran {n_run} of {len(segs)} "
                        f"requested segments (still loading after a "
                        f"reassignment?)")
                self._failures.record_success(server)
                # serde vs network split of the net gap: the
                # server timed its frame encode (serdeEncodeMs in the
                # header), the decode was timed above
                serde = dec_ms + float(header.get("serdeEncodeMs")
                                       or 0.0)
                net = 0.0
                if sp is not None:
                    sp.finish()
                    remote = header.get("trace")
                    if remote:
                        rt = Span.from_dict(remote)
                        sp.children.append(rt)
                        # call span - remote tree - serde = true
                        # network time
                        net = max(sp.duration_ms - rt.duration_ms
                                  - serde, 0.0)
                        sp.annotate(net_ms=round(net, 3))
                    sp.annotate(status="ok", serde_ms=round(serde, 3))
                res.add_wire_times(serde, net)
                if header.get("batched"):
                    res.add_batching(header.get("batched", 0),
                                     header.get("batchSize", 0))
                return {"partials": decoded, "segmentsQueried": n_run,
                        "dispatched": [server], "responders": [server]}
            except urllib.error.HTTPError as e:
                # the server answered: an application error, not a health
                # signal — surface it, don't poison the failure detector
                self._failures.record_success(server)
                try:
                    raw_body = e.read().decode()
                except Exception:
                    raw_body = str(e)
                detail = raw_body[:200]
                if sp is not None:
                    sp.finish()
                    sp.annotate(status="rejected", error=detail)
                if e.code == 429:
                    # a capacity rejection (SchedulerRejectedError via
                    # the server's JsonHandler): keep it STRUCTURED end
                    # to end so the broker's own /query/sql can render
                    # the retryable 429 instead of flattening to a 400
                    try:
                        body = json.loads(raw_body)
                    except ValueError:
                        body = {}
                    if isinstance(body, dict) and                             body.get("retryAfterMs") is not None:
                        err = SqlError(f"server {server} out of "
                                       f"capacity: "
                                       f"{body.get('error', detail)}")
                        err.error_code = int(body.get("errorCode", 429))
                        err.retry_after_ms = int(body["retryAfterMs"])
                        raise err from None
                raise SqlError(f"server {server} rejected query: "
                               f"{detail}") from None
            except (ScatterTimeoutError, SqlError):
                if sp is not None and sp.duration_ms == 0.0:
                    sp.finish()
                raise
            except Exception as e:
                self._failures.record_failure(server)
                # finish the attempt span NOW: the failover recursion
                # below gets its own spans, not this one's tail
                if sp is not None:
                    sp.finish()
                    sp.annotate(status="failed",
                                error=f"{type(e).__name__}: {e}"[:200])
                # a failover target that answered without some segment
                # (a rebalance moved it while the query ran) earns one
                # more try
                short = isinstance(e, _SegmentShortfall)
                if not retry and (rerouted or not short):
                    raise
                if retry:
                    # failover: re-pick replicas per segment, one retry
                    global_metrics.count("scatter_failovers")
                    with res._lock:
                        res.failovers += 1
                # the holders come from the controller's current routing,
                # read once: a segment may have moved since the query's
                # snapshot (a rebalance flipped it to a new replica). A
                # server that answered short is picked again only where
                # the routing names no other holder
                try:
                    self._refresh_routing()
                except Exception:
                    pass
                fresh = self._snapshot().get("assignment", {}).get(
                    ctx.table) or assignment
                regrouped: Dict[str, List[str]] = {}
                for seg in segs:
                    listed = [h for h in fresh.get(seg, [])
                              if self._server_url(h)]
                    holders = [h for h in listed if h != server] or \
                        [h for h in listed if short]
                    pick = self._pick_replica(holders)
                    if pick is None:
                        raise ReplicaExhaustedError(
                            f"no replica left for {seg!r}")
                    regrouped.setdefault(pick, []).append(seg)
                # dispatched/responders surface the failover in the
                # response health metadata: the dead primary stays in
                # "queried", the replica that actually answered joins
                # "responded" — a hidden failover is invisible otherwise
                out = {"partials": [], "segmentsQueried": 0,
                       "dispatched": [server], "responders": []}
                for srv, ss in regrouped.items():
                    r = call(srv, ss, retry=False, attempt="failover",
                             rerouted=not retry)
                    out["partials"].extend(r["partials"])
                    out["segmentsQueried"] += r["segmentsQueried"]
                    out["dispatched"].extend(r["dispatched"])
                    out["responders"].extend(r["responders"])
                return out
            finally:
                if adaptive:
                    self._selector.record_end(
                        server, (time.perf_counter() - tcall) * 1e3)

        with span(ph.SCATTER, table=ctx.table, servers=len(by_server),
                  segments=sum(len(s) for s in by_server.values())
                  ) as sc_span:
            try:
                self._gather(hedge_opt, assignment, by_server, call, res,
                             remaining, allow_partial)
            finally:
                # attach even when the gather raises: a failed analyze
                # still shows WHICH attempts failed (forensics ring).
                # Snapshot first — an abandoned straggler can still be
                # appending its failover attempt from a pool thread, and
                # list.sort() raises if the list mutates mid-sort
                res.close_wire_times()
                if sc_span is not None and collect:
                    done = list(collect)
                    done.sort(key=lambda s: s._t0)
                    sc_span.children.extend(done)
        global_metrics.gauge(
            "scatter_unhealthy_servers",
            sum(1 for s in snap.get("instances", {})
                if not self._failures.healthy(s)))
        return res

    def _gather(self, hedge_opt: Optional[float],
                assignment: Dict[str, List[str]],
                by_server: Dict[str, List[str]], call,
                res: ScatterResult, remaining, allow_partial: bool
                ) -> None:
        """Gather that collects per-server errors instead of letting the
        first f.result() abandon the rest, with deadline-aware waiting
        and hedged re-dispatch of stragglers.

        One 'group' per primary server dispatch. A group resolves when
        its primary attempt (internal failover included) succeeds, or
        when ALL parts of one hedge attempt succeed — whichever lands
        first; the loser is ignored (replica partials are byte-identical
        by construction, so either is correct, never both)."""
        groups: Dict[int, Dict[str, Any]] = {}
        fut_info: Dict[Any, Tuple[int, str, bool]] = {}
        for gid, (srv, segs) in enumerate(sorted(by_server.items())):
            groups[gid] = {"server": srv, "segs": segs, "done": False,
                           "errors": [], "t0": time.perf_counter(),
                           "hedged": False, "hedge_parts": 0,
                           "hedge_partials": [], "hedge_segments": 0,
                           "hedge_servers": [], "primary_failed": False}
            f = self._pool.submit(call, srv, segs)
            fut_info[f] = (gid, srv, False)

        responded: set = set()
        # every server an attempt was dispatched to: primaries up front,
        # hedge targets as they launch — so numServersResponded (a
        # subset of attempt targets) can never exceed numServersQueried
        queried: set = set(by_server)
        timed_out = False
        pending = set(fut_info)

        def abandon(futs) -> None:
            # consume late results/exceptions so the executor never logs
            # "exception was never retrieved" for attempts we no longer
            # care about (a hedged-out straggler, a post-deadline call)
            for f in futs:
                f.add_done_callback(lambda fut: fut.exception())

        while pending:
            if all(g["done"] for g in groups.values()):
                abandon(pending)  # every group resolved (hedges won):
                break             # don't wait out the stragglers
            rem = remaining()
            if rem is not None and rem <= 0:
                timed_out = True
                abandon(pending)
                for g in groups.values():
                    # only groups with NO recorded failure get the
                    # still-waiting entry — a server that already
                    # answered with an error must not also be reported
                    # as "did not respond"
                    if not g["done"] and not g["errors"]:
                        g["errors"].append({
                            "errorCode": ERR_BROKER_TIMEOUT,
                            "message": f"server {g['server']} did not "
                                       "respond within the query "
                                       "deadline"})
                break
            # poll fast only while some group could still hedge;
            # otherwise block the full remaining budget (or until a
            # completion) instead of 50 wakeups/s per scatter
            hedgeable = any(
                not g["done"] and not g["hedged"]
                and not g["primary_failed"]
                and self._hedge_threshold_ms(hedge_opt,
                                             g["server"]) is not None
                for g in groups.values())
            if hedgeable:
                tick = 0.02 if rem is None else min(0.02, rem)
            else:
                tick = rem  # None = block until a completion
            done, pending = wait(pending, timeout=tick,
                                 return_when=FIRST_COMPLETED)
            for f in done:
                gid, server, is_hedge = fut_info[f]
                g = groups[gid]
                try:
                    resp = f.result()
                except Exception as e:
                    if isinstance(e, ScatterTimeoutError):
                        code = ERR_BROKER_TIMEOUT
                    elif isinstance(e, ReplicaExhaustedError):
                        code = ERR_SERVER_NOT_RESPONDED
                    elif isinstance(e, SqlError):
                        # a capacity rejection keeps its own code (211/
                        # 429) so exceptions[] and the final raise stay
                        # structured-retryable end to end
                        code = getattr(e, "error_code", None) \
                            or ERR_QUERY_EXECUTION
                    else:
                        code = ERR_SERVER_NOT_RESPONDED
                    if not is_hedge:
                        g["primary_failed"] = True
                    entry = {"errorCode": code, "message": str(e),
                             "server": server}
                    if getattr(e, "retry_after_ms", None) is not None:
                        entry["retryAfterMs"] = e.retry_after_ms
                    g["errors"].append(entry)
                    continue
                if g["done"]:
                    continue  # the other attempt already resolved it
                if not is_hedge:
                    g["done"] = True
                    res.partials.extend(resp["partials"])
                    res.segments_queried += resp["segmentsQueried"]
                    queried.update(resp["dispatched"])
                    responded.update(resp["responders"])
                else:
                    g["hedge_partials"].extend(resp["partials"])
                    g["hedge_segments"] += resp["segmentsQueried"]
                    g["hedge_servers"].extend(resp["responders"])
                    g["hedge_parts"] -= 1
                    if g["hedge_parts"] == 0:
                        # every part of the hedge landed: commit it
                        g["done"] = True
                        res.partials.extend(g["hedge_partials"])
                        res.segments_queried += g["hedge_segments"]
                        responded.update(g["hedge_servers"])
            # hedge pass: a primary past its latency threshold gets its
            # segments re-dispatched to other healthy replicas, once
            now = time.perf_counter()
            for gid, g in groups.items():
                if g["done"] or g["hedged"] or g["primary_failed"]:
                    continue
                thr = self._hedge_threshold_ms(hedge_opt, g["server"])
                if thr is None or (now - g["t0"]) * 1e3 < thr:
                    continue
                g["hedged"] = True
                regrouped: Dict[str, List[str]] = {}
                ok = True
                for seg in g["segs"]:
                    holders = [h for h in assignment.get(seg, [])
                               if h != g["server"]
                               and self._failures.healthy(h)]
                    pick = self._pick_replica(holders)
                    if pick is None:
                        ok = False  # nowhere to hedge this segment
                        break
                    regrouped.setdefault(pick, []).append(seg)
                if not ok:
                    continue
                global_metrics.count("scatter_hedges", len(regrouped))
                res.hedges += len(regrouped)
                g["hedge_parts"] = len(regrouped)
                for srv2, ss in regrouped.items():
                    f2 = self._pool.submit(call, srv2, ss, False,
                                           "hedge")
                    fut_info[f2] = (gid, srv2, True)
                    queried.add(srv2)
                    pending.add(f2)

        failed = [g for g in groups.values() if not g["done"]]
        for g in failed:
            res.exceptions.extend(g["errors"])
        if res.exceptions:
            global_metrics.count("scatter_server_errors",
                                 len(res.exceptions))
        res.servers_queried = len(queried)
        res.servers_responded = len(responded)
        if failed:
            res.partial = True
            if not allow_partial:
                if timed_out:
                    raise ScatterTimeoutError(
                        f"query timed out: {len(failed)} of "
                        f"{len(groups)} servers unanswered when the "
                        f"timeoutMs budget ran out "
                        f"(set allowPartialResults=true for a partial "
                        f"answer); exceptions: "
                        f"{[e['message'] for e in res.exceptions][:3]}")
                first = (failed[0]["errors"] or
                         [{"message": "server failed"}])[0]
                err = SqlError(first["message"])
                if first.get("retryAfterMs") is not None:
                    # re-attach the capacity-rejection shape: the
                    # /query/sql handler renders these as HTTP 429
                    err.error_code = first.get("errorCode", 429)
                    err.retry_after_ms = first["retryAfterMs"]
                raise err

    def _query_setop(self, stmt: SetOpStmt, t0: float,
                     qid: Optional[str] = None,
                     scatters: Optional[List["ScatterResult"]] = None,
                     workload: Optional[Dict[str, Any]] = None
                     ) -> ResultTable:
        """Set operations over the remote data plane: run each branch as
        its own scatter-gather (rendered back to SQL), combine at this
        broker — the same multiset merge the in-process broker uses.
        The compound's timeoutMs is ONE budget: each branch gets the
        remaining slice, not a fresh full allowance. Branches run
        through _query_stmt, NOT self.query: the compound is ONE user
        query and writes ONE query_stats record — with the branch
        scatters' hedge/failover counts — not one per branch."""
        from ..engine.reduce import DEFAULT_LIMIT
        from ..engine.setops import combine_setop, order_limit_rows

        timeout_ms = _parse_timeout_ms(stmt.options)
        deadline = t0 + timeout_ms / 1e3
        qid = qid or uuid.uuid4().hex[:12]
        scatters = scatters if scatters is not None else []
        branches: List[ResultTable] = []  # leaf results carry the
        # scatter metadata combine_setop's fresh tables would drop

        def run(node) -> ResultTable:
            if isinstance(node, SetOpStmt):
                return combine_setop(node.op, node.all,
                                     run(node.left), run(node.right))
            if stmt.options:
                node.options = {**stmt.options, **node.options}
            remaining_ms = int((deadline - time.perf_counter()) * 1e3)
            node.options["timeoutMs"] = min(
                int(node.options.get("timeoutMs", timeout_ms)),
                max(remaining_ms, 1))
            if node.limit is None:
                node.limit = 1 << 31
            branch_sql = to_sql(node)
            out = self._query_stmt(parse_sql(branch_sql), branch_sql,
                                   time.perf_counter(), qid, scatters,
                                   workload)
            branches.append(out)
            return out

        result = combine_setop(stmt.op, stmt.all,
                               run(stmt.left), run(stmt.right))
        limit = stmt.limit if stmt.limit is not None else DEFAULT_LIMIT
        result = order_limit_rows(result, stmt.order_by, limit, stmt.offset)
        # a partial branch must not present the compound as complete
        result.num_servers_queried = sum(b.num_servers_queried
                                         for b in branches)
        result.num_servers_responded = sum(b.num_servers_responded
                                           for b in branches)
        for b in branches:
            result.exceptions.extend(b.exceptions)
        result.partial_result = any(b.partial_result for b in branches)
        result.time_ms = (time.perf_counter() - t0) * 1e3
        return result

    # -- scatter health (satellite: FailureDetector + counters exported) --
    def scatter_health(self) -> Dict[str, Any]:
        """Scatter-gather health: per-server consecutive-failure state
        from the FailureDetector plus the scatter counters — served at
        GET /metrics and rendered on the /ui console. ``ingest`` carries
        the realtime-plane recovery counters + freshness gauge next to
        the scatter counters (in-process roles share
        global_metrics; a standalone broker reports zeros)."""
        from ..engine.ragged import batching_health
        from ..engine.tier import tier_health
        from ..utils.metrics import overload_health
        # armed freshness objectives sample their ingest gauges on the
        # health poll (dead/stale gauge = bad sample); unarmed this is
        # one attribute read
        if global_slo.armed:
            global_slo.observe_freshness()
        snap = global_metrics.snapshot()
        c = snap["counters"]
        fd = self._failures.snapshot()
        instances = self._snapshot().get("instances", {})
        overload = overload_health(snap)
        overload["tenants"] = self.workload.health()
        overload["governor"] = self.workload.governor.snapshot()
        return {
            "servers": fd,
            "unhealthyServers": sum(
                1 for s in instances if not self._failures.healthy(s)),
            "knownServers": len(instances),
            "counters": {k: c.get(k, 0) for k in (
                "scatter_failovers", "scatter_hedges",
                "scatter_partial_responses", "scatter_server_errors",
                "faults_fired")},
            "ingest": ingest_health(snap),
            # cross-query micro-batching counters — rendered on
            # the /ui console next to the scatter block
            "batching": batching_health(snap),
            # overload-protection plane: shed/degrade-rung
            # counters + per-tenant gauges (broker/workload.py)
            "overload": overload,
            # HBM tier occupancy + placement-affinity hit ratio
            # (engine/tier.py) — the memory-hierarchy health block
            "tier": tier_health(snap),
            # SLO burn table: per-objective fast/slow burn
            # + budget remaining + latch state (utils/slo.py)
            "slo": global_slo.status_block(),
        }

    # -- REST --------------------------------------------------------------
    def _make_handler(self):
        node = self

        def q(h, b):
            from ..broker.workload import OverloadShedError
            sql = (b or {}).get("sql")
            if not sql:
                return 400, {"error": "missing sql"}
            try:
                return 200, node.query(sql).to_dict()
            except OverloadShedError as e:
                # the structured 429: errorCode + retryAfterMs +
                # tenant/tier/rung — NEVER a 500/stack trace (the
                # acceptance contract chaos_smoke --overload pins)
                return 429, e.payload()
            except SqlError as e:
                code = getattr(e, "error_code", None)
                if code is not None and \
                        getattr(e, "retry_after_ms", None) is not None:
                    # e.g. a server's SchedulerRejectedError surfacing
                    # through the broker: keep it retryable-structured
                    return 429, (e.payload() if hasattr(e, "payload")
                                 else {"error": str(e),
                                       "errorCode": code,
                                       "retryAfterMs":
                                           e.retry_after_ms})
                return 400, {"error": str(e)}

        def _limit(path):
            from urllib.parse import parse_qs, urlparse
            try:
                return int(parse_qs(urlparse(path).query)["n"][0])
            except (KeyError, ValueError, IndexError):
                return None

        def debug_queries(h, b):
            # GET /debug/queries[?n=K]: the slow-query/forensics ring
            return 200, node.forensics.snapshot(_limit(h.path))

        def debug_incidents(h, b):
            # GET /debug/incidents[?n=K]: flight-recorder bundles,
            # newest first (utils/slo.py IncidentRecorder)
            return 200, global_incidents.snapshot(_limit(h.path))

        def debug_autopsy(h, b):
            # GET /debug/autopsy[?n=K]: verdict ring, newest first;
            # ?run=1 computes a fresh verdict synchronously over the
            # node ledger; ?qid=<id> runs the per-query whydown lane
            from urllib.parse import parse_qs, urlparse
            params = parse_qs(urlparse(h.path).query)
            qid = (params.get("qid") or [None])[0]
            if qid:
                return 200, whydown(
                    load_corpus(node.forensics.ledger_path), qid=qid)
            if (params.get("run") or [None])[0]:
                return 200, global_autopsy.run(
                    ledger_path=node.forensics.ledger_path)
            return 200, global_autopsy.snapshot(_limit(h.path))

        class Handler(JsonHandler):
            routes = {
                ("GET", "/health"): lambda h, b: (200, {"status": "OK"}),
                ("GET", "/metrics/prometheus"): lambda h, b: (
                    200, ("text/plain", global_metrics.prometheus())),
                ("GET", "/metrics"): lambda h, b: (
                    200, node.scatter_health()),
                ("GET", "/debug/queries"): debug_queries,
                # ledger shipping: the controller's
                # ForensicsRollupTask pulls validated stats/trace deltas
                # + node telemetry blocks from here
                ("GET", "/debug/ledger"): lambda h, b: (
                    200, ledger_debug_payload(
                        node.instance_id, "broker",
                        node.forensics.ledger_path,
                        parse_since(h.path))),
                ("GET", "/debug/memory"): lambda h, b: (
                    200, memory_debug_payload(node.instance_id)),
                # debug-surface index + SLO plane
                ("GET", "/debug"): lambda h, b: (
                    200, debug_index(node.instance_id, "broker",
                                     extra=("/debug/queries",
                                            "/debug/slo"))),
                ("GET", "/debug/incidents"): debug_incidents,
                ("GET", "/debug/autopsy"): debug_autopsy,
                ("GET", "/debug/slo"): lambda h, b: (
                    200, global_slo.status_block()),
                ("GET", "/ui"): lambda h, b: (
                    200, ("text/html", node.ui_page())),
                ("POST", "/query/sql"): q,
            }
        return Handler

    def ui_page(self) -> str:
        """Query console (GET /ui): the broker-side piece of the
        reference's controller web app (its Query Console tab posts to
        the broker exactly like this page). Server-rendered shell +
        vanilla JS against the existing /query/sql endpoint."""
        return """<!doctype html><html><head><title>pinot-tpu-torch console</title>
<style>
 body{font-family:monospace;margin:2em;background:#111;color:#ddd}
 textarea{width:100%;height:6em;background:#1b1b1b;color:#ddd;
   border:1px solid #444;padding:.5em;font-family:monospace}
 button{margin:.5em 0;padding:.4em 1.2em;background:#2a6;border:0;
   color:#fff;cursor:pointer}
 table{border-collapse:collapse;margin-top:1em}
 td,th{border:1px solid #444;padding:.25em .6em;text-align:left}
 th{background:#222}
 #stats{color:#8a8;margin-top:.5em}
 #err{color:#e66;white-space:pre-wrap}
 #warn{color:#ea3;white-space:pre-wrap}
 #scatter{color:#789;margin-top:1.5em;font-size:.85em;
   border-top:1px solid #333;padding-top:.5em;white-space:pre-wrap}
 #slowq{color:#a96;margin-top:.5em;font-size:.85em;
   border-top:1px solid #333;padding-top:.5em}
 #slowq td{border:1px solid #333;font-size:1em}
 #links{font-size:.85em;color:#678}
 #links a{color:#7ac}
</style></head><body>
<h2>pinot-tpu-torch query console</h2>
<div id=links>debug: <a href=/debug>index</a> &middot;
<a href=/debug/queries>queries</a> &middot;
<a href=/debug/memory>memory</a> &middot;
<a href=/debug/ledger>ledger</a> &middot;
<a href=/debug/slo>slo</a> &middot;
<a href=/debug/incidents>incidents</a> &middot;
<a href=/debug/autopsy>autopsy</a></div>
<textarea id=sql>SELECT * FROM mytable LIMIT 10</textarea><br>
<button onclick=run()>Run (Ctrl-Enter)</button>
<div id=stats></div><div id=warn></div><div id=err></div><div id=out></div>
<div id=scatter></div>
<div id=slowq></div>
<script>
const esc=s=>String(s).replace(/[&<>"']/g,
  c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
const sqlEl=document.getElementById('sql');
sqlEl.addEventListener('keydown',e=>{
  if(e.ctrlKey&&e.key==='Enter')run();});
async function run(){
  const t0=performance.now();
  document.getElementById('err').textContent='';
  document.getElementById('warn').textContent='';
  document.getElementById('out').innerHTML='';
  let j;
  try{
    const r=await fetch('/query/sql',{method:'POST',
      headers:{'Content-Type':'application/json'},
      body:JSON.stringify({sql:sqlEl.value})});
    j=await r.json();
  }catch(e){document.getElementById('err').textContent=e;return;}
  if(j.error){document.getElementById('err').textContent=j.error;return;}
  if(j.partialResult)
    document.getElementById('warn').textContent=
      'PARTIAL RESULT: '+j.numServersResponded+'/'+j.numServersQueried+
      ' servers responded — '+
      (j.exceptions||[]).map(e=>e.message).join('; ');
  const rt=j.resultTable||j;
  const cols=(rt.dataSchema&&rt.dataSchema.columnNames)||rt.columns||[];
  const rows=rt.rows||[];
  let h='<table><tr>'+cols.map(c=>'<th>'+esc(c)+'</th>').join('')+'</tr>';
  for(const row of rows)
    h+='<tr>'+row.map(v=>'<td>'+esc(v)+'</td>').join('')+'</tr>';
  h+='</table>';
  document.getElementById('out').innerHTML=h;
  const ms=(performance.now()-t0).toFixed(1);
  const srvMs=j.timeUsedMs!==undefined?j.timeUsedMs:j.timeMs;
  document.getElementById('stats').textContent=
    rows.length+' rows | server '+(srvMs!==undefined?
    srvMs.toFixed(1):'?')+' ms | wall '+ms+' ms | docs scanned '+
    (j.numDocsScanned!==undefined?j.numDocsScanned:'?');
}
async function health(){
  try{
    const m=await (await fetch('/metrics')).json();
    const c=m.counters||{};
    const srv=Object.entries(m.servers||{}).map(([id,s])=>
      esc(id)+': '+s.consecutiveFailures+' consecutive failures'+
      (s.backoffRemainingS>0?' (backoff '+s.backoffRemainingS+'s)':''))
      .join(' | ')||'all healthy';
    const i=m.ingest||{};
    const b=m.batching||{};const sf=b.solo_fallbacks||{};
    const o=m.overload||{};const ot=o.tenants||{};
    document.getElementById('scatter').textContent=
      'scatter health: '+m.unhealthyServers+'/'+m.knownServers+
      ' unhealthy | failovers '+(c.scatter_failovers||0)+
      ' | hedges '+(c.scatter_hedges||0)+
      ' | partial responses '+(c.scatter_partial_responses||0)+
      ' | server errors '+(c.scatter_server_errors||0)+
      ' — '+srv+
      '\\ningest: rows '+(i.ingest_rows||0)+
      ' | freshness '+(i.freshness_ms!=null?
        i.freshness_ms.toFixed(1)+' ms':'n/a')+
      ' | commit retries '+(i.ingest_commit_retries||0)+
      ' | rebalance resets '+(i.ingest_rebalance_resets||0)+
      ' | upsert replays '+(i.ingest_upsert_replays||0)+
      ' | orphans cleaned '+(i.ingest_orphans_cleaned||0)+
      '\\nbatching ('+(b.enabled?'on':'off')+'): fused dispatches '+
      (b.batched_dispatches||0)+
      ' | fused queries '+(b.batched_queries||0)+
      ' | queue depth '+(b.batch_queue_depth||0)+
      ' | cube cache '+(b.cube_cache_hits||0)+'/'+
      ((b.cube_cache_hits||0)+(b.cube_cache_misses||0))+
      ' | solo: deadline '+(sf.deadline||0)+
      ', incompatible '+(sf.incompatible||0)+
      ', window-expired '+(sf.window_expired||0)+
      ', no-peers '+(sf.no_peers||0)+
      ', timeout '+(sf.timeout||0)+
      ', leader-error '+(sf.leader_error||0)+
      ' | errors '+(b.fused_dispatch_errors||0)+
      ' | sizes '+JSON.stringify(b.batch_size_histogram||{})+
      '\\ntier ('+((m.tier||{}).armed?'budget '+
        ((m.tier||{}).budget_bytes||0)+'B':'unbounded')+'): hot '+
      (((m.tier||{}).hot||{}).segments||0)+' seg / '+
      (((m.tier||{}).hot||{}).bytes||0)+'B | warm '+
      (((m.tier||{}).warm||{}).segments||0)+' seg / '+
      (((m.tier||{}).warm||{}).bytes||0)+'B | cold '+
      (((m.tier||{}).cold||{}).segments||0)+
      ' | promotions '+((m.tier||{}).promotions||0)+
      ' | demotions '+((m.tier||{}).demotions||0)+
      ' | affinity '+((m.tier||{}).affinity_hits||0)+'/'+
      (((m.tier||{}).affinity_hits||0)+
       ((m.tier||{}).affinity_misses||0))+
      ((m.tier||{}).affinity_hit_ratio!=null?
        ' ('+((m.tier||{}).affinity_hit_ratio*100).toFixed(1)+'%)':'')+
      '\\noverload: rung '+(o.rung||0)+
      ' | shed '+(o.overload_shed||0)+
      ' (rung2 '+((o.shed_by_rung||{})['2']||0)+
      ', rung3 '+((o.shed_by_rung||{})['3']||0)+')'+
      ' | brownout clamps '+(o.overload_brownout_clamped||0)+
      ' | retries suppressed '+(o.overload_retries_suppressed||0)+
      ' | scheduler rejected '+(o.scheduler_rejected||0)+
      ' | tenants '+(Object.entries(ot).map(([t,s])=>
        esc(t)+'['+s.tier+'] inflight '+s.inflight+
        ' shed '+((o.shed_by_tenant||{})[t]||0)).join(', ')||'none')+
      '\\nslo: '+(((m.slo||{}).armed)?
        ((m.slo||{}).objectives||[]).map(s=>
          esc(s.scope)+'/'+s.kind+' burn '+s.burn_fast+'x/'+
          s.burn_slow+'x budget '+
          (s.budget_remaining*100).toFixed(0)+'%'+
          (s.alerting?' ALERTING':'')).join(' | ')||'no objectives'
        :'unarmed');
  }catch(e){}
}
async function slowq(){
  try{
    const d=await (await fetch('/debug/queries?n=5')).json();
    if(!d.count){
      document.getElementById('slowq').textContent=
        'forensics: no slow queries (threshold '+d.slowQueryMs+' ms)';
      return;
    }
    let h='forensics (slowest-recent, threshold '+d.slowQueryMs+
      ' ms):<table><tr><th>qid</th><th>wall ms</th><th>table</th>'+
      '<th>partial</th><th>sql</th></tr>';
    for(const e of d.queries)
      h+='<tr><td>'+esc(e.qid)+'</td><td>'+e.wall_ms+'</td><td>'+
        esc(e.table)+'</td><td>'+(e.partial?'YES':'no')+'</td><td>'+
        esc((e.sql||'').slice(0,120))+'</td></tr>';
    document.getElementById('slowq').innerHTML=h+'</table>';
  }catch(e){}
}
health();slowq();setInterval(health,3000);setInterval(slowq,3000);
</script></body></html>"""

    def stop(self) -> None:
        self._stop.set()
        self._pool.shutdown(wait=False)
        self._httpd.shutdown()
        self._httpd.server_close()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"
