"""Server node: segment hosting + query execution over HTTP.

Reference parity: pinot-server/.../BaseServerStarter.java:557 + the Helix
state model (SegmentOnlineOfflineStateModelFactory.java:78,128 — servers
receive ONLINE transitions and download/load segments) + the server half of
the single-stage data plane (InstanceRequestHandler.channelRead0). Here the
server polls its versioned assignment from the controller (ideal-state
pull, not ZK push), loads/unloads immutable segments to match, and serves
POST /query {sql, table, segments?} by running the per-segment planner +
batched kernel executor and returning wire-encoded partials — the
DataTable response analog.

Port of ``pinot_tpu/cluster/server_node.py``. A server node serves its
segments from one device: ``device`` (default ``"cuda"``) resolves
through ``device.resolve_device`` and raises when CUDA is asked for and
absent, so a node never serves from the CPU unless told to. Every
segment it loads, from a local directory or a deep-store archive, lives
on that device. The gRPC data plane of the reference comes in a later
slice: this node starts the HTTP planes only and ``grpc_server`` stays
``None``.
"""
from __future__ import annotations

import os
import threading
import time
import urllib.error
import uuid
from typing import Any, Callable, Dict, List, Optional

from ..engine.accounting import global_accountant
from ..engine.scheduler import make_scheduler
from ..engine.serde import partial_to_wire
from ..query.context import build_query_context
from ..device import resolve_device
from ..query.sql import parse_sql
from ..segment.immutable import ImmutableSegment
from ..server.data_manager import TableDataManager
from .http_util import (JsonHandler, http_json, start_http,
                        trace_context_from)


class ServerNode:
    def __init__(self, instance_id: str, controller_url: str, port: int = 0,
                 poll_interval: float = 0.3,
                 scheduler_config: Optional[Dict[str, Any]] = None,
                 tags: Optional[List[str]] = None,
                 advertise_host: Optional[str] = None,
                 ledger_path: Optional[str] = None,
                 device=None):
        self.device = resolve_device(device)
        self.instance_id = instance_id
        self.controller_url = controller_url
        self.poll_interval = poll_interval
        # optional node-local perf ledger (ingest_stats writers etc.)
        # served incrementally at GET /debug/ledger for the controller's
        # fleet rollup; None still serves the telemetry blocks
        # (heat / device memory / counters) with zero records
        self.ledger_path = ledger_path
        # the host OTHER nodes dial (containers/k8s must advertise their
        # service-reachable name, not loopback); env override for
        # image-based deployments (deploy/)
        self.advertise_host = (advertise_host
                               or os.environ.get("PINOT_ADVERTISE_HOST")
                               or "127.0.0.1")
        self.tags = list(tags or [])  # tenant tags (Helix instance tags)
        import tempfile
        # local segment store for deep-store downloads (tar.gz locations)
        self.data_dir = tempfile.mkdtemp(prefix=f"ptpu_{instance_id}_")
        # admission + ordering for concurrent HTTP queries
        # (QuerySchedulerFactory analog; fcfs by default)
        self.scheduler = make_scheduler(scheduler_config)
        from ..multistage.exchange import MailboxService
        self.mailboxes = MailboxService()  # multi-stage receiving side
        # no gRPC data plane yet: the HTTP planes carry every request
        self.grpc_server = None
        self.grpc_port: Optional[int] = None
        # OOM protection: kill the most expensive query near the RSS limit
        # (PerQueryCPUMemAccountant WatcherTask analog); limit defaults to
        # 90% of system memory, override/disable via
        # scheduler_config["query.killer.rss_limit_bytes"] (0 disables)
        from ..engine.accounting import HeapWatcher, system_memory_bytes
        cfg = scheduler_config or {}
        # deterministic chaos: a node config can arm the process-global
        # fault plan (PINOT_FAULTS grammar — utils/faults.py); the env
        # var is the container path, this is the embedded-cluster path.
        # The plan is PROCESS-global: last installer wins, and stop()
        # disarms it again (only if still ours) so a stopped chaos node
        # doesn't keep injecting into the rest of the process
        self._fault_plan = None
        if cfg.get("fault.plan"):
            from ..utils import faults
            self._fault_plan = faults.install(cfg["fault.plan"])
        rss_limit = int(cfg.get("query.killer.rss_limit_bytes",
                                int(system_memory_bytes() * 0.9)))
        self.heap_watcher = (HeapWatcher(global_accountant, rss_limit).start()
                             if rss_limit > 0 else None)
        self._tables: Dict[str, TableDataManager] = {}
        # called as on_execute(sql, segments, plans) once an execution
        # has run or failed: the segment objects it acquired, in the order
        # it ran them, and the plans it ran on them
        self.on_execute: Optional[Callable[
            [str, List[ImmutableSegment], List[Any]], None]] = None
        self._assignment_version = -1
        self._stop = threading.Event()
        self._httpd, self.port, _ = start_http(self._make_handler(), port)
        self._register(retries=20)   # ~1min of startup tolerance
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- control plane -----------------------------------------------------
    def _register(self, retries: int = 0) -> None:
        """retries > 0: tolerate startup transients — an HA standby's
        503, a not-yet-scheduled controller — with linear backoff (the
        crash-looping alternative is what k8s would otherwise do)."""
        for attempt in range(retries + 1):
            try:
                http_json("POST", f"{self.controller_url}/instances", {
                    "id": self.instance_id, "host": self.advertise_host,
                    "port": self.port, "role": "server",
                    "tags": self.tags})
                return
            except Exception:
                if attempt == retries:
                    raise
                time.sleep(min(0.5 * (attempt + 1), 5.0))

    def _residency(self, cap: int = 512) -> Dict[str, Dict[str, str]]:
        """Per-table {segment: tier} for THIS node's hosted segments —
        the placement signal every heartbeat carries (the broker's
        affinity routing prefers replicas already holding a segment
        hot). ``cube`` marks a non-hot segment whose ragged cube is
        resident (it answers plan-key-sharing queries without any
        column upload). Capped so a wide node can't bloat the
        control-plane heartbeat."""
        from ..engine.tier import TIER_HOT, segment_tier
        from ..ops.plan_cache import global_cube_cache
        cube_uids = global_cube_cache.resident_uids()
        out: Dict[str, Dict[str, str]] = {}
        n = 0
        for table, dm in list(self._tables.items()):
            segs: Dict[str, str] = {}
            for s in dm.acquire_segments():
                if n >= cap:
                    break
                t = segment_tier(s)
                if t != TIER_HOT and getattr(s, "uid", None) in cube_uids:
                    t = "cube"
                segs[s.name] = t
                n += 1
            if segs:
                out[table] = segs
        return out

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            epoch = None
            try:
                try:
                    resp = http_json("POST",
                                     f"{self.controller_url}/heartbeat/"
                                     f"{self.instance_id}",
                                     {"residency": self._residency()})
                    # assignment-version epoch: when the
                    # heartbeat says our applied version is current,
                    # skip the assignment fetch this tick. A stale or
                    # absent epoch (older controller) always syncs; a
                    # partially-failed sync keeps _assignment_version
                    # behind the epoch, so retries still fire each poll
                    epoch = (resp or {}).get("version")
                except urllib.error.HTTPError as e:
                    if e.code != 404:
                        raise
                    # a RESTARTED controller has empty ephemeral state
                    # and answers 404 for unknown instances: re-announce
                    # (the ZK ephemeral-node re-registration Helix does
                    # on session re-establishment)
                    self._register()
                if epoch is None or epoch != self._assignment_version:
                    self._sync_assignment()
            except Exception:
                pass  # controller briefly unreachable; keep serving

    def _sync_assignment(self) -> None:
        a = http_json("GET", f"{self.controller_url}/assignments/"
                             f"{self.instance_id}")
        if a["version"] == self._assignment_version:
            return
        ok = True  # advance the version only after a fully-applied sync;
        # a failed segment load retries on every poll instead of being
        # silently skipped until an unrelated version bump
        for table, segs in a["tables"].items():
            dm = self._tables.get(table)
            if dm is None:
                dm = self._tables.setdefault(
                    table, TableDataManager(table, device=self.device))
            have = {s.name for s in dm.acquire_segments()}
            for seg_name, location in segs.items():
                if seg_name not in have:
                    try:
                        # deep-store location: download + untar, then load
                        # (onBecomeOnlineFromOffline download path)
                        from .deepstore import (download_segment,
                                                is_deepstore_uri)
                        if is_deepstore_uri(location):
                            location = download_segment(
                                location,
                                os.path.join(self.data_dir, table))
                        dm.add_segment(ImmutableSegment.load(
                            location, self.device))
                    except Exception:
                        ok = False
            for seg_name in have - set(segs):
                dm.remove_segment(seg_name)
                # reclaim the local deep-store download, if any (mmaps of
                # in-flight queries survive the unlink)
                local = os.path.join(self.data_dir, table, seg_name)
                if os.path.isdir(local):
                    import shutil
                    shutil.rmtree(local, ignore_errors=True)
        for table in list(self._tables):
            if table not in a["tables"]:
                del self._tables[table]
        if ok:
            self._assignment_version = a["version"]

    def wait_for_version(self, version: int, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._assignment_version >= version:
                return True
            time.sleep(0.05)
        return False

    # -- data plane --------------------------------------------------------
    def execute(self, sql: str, segment_names: Optional[List[str]] = None,
                priority: int = 0,
                deadline_ms: Optional[float] = None,
                trace_ctx: Optional[Dict[str, Any]] = None,
                workload: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        """Admit through the scheduler (QueryScheduler.submit analog) and
        account the query so the watcher can kill it under pressure.
        ``deadline_ms`` is the dispatching broker's REMAINING budget; the
        accountant deadline becomes min(own timeoutMs, broker remaining)
        so a server never works past the point the broker stops
        listening. A sampled ``trace_ctx`` (http_util.
        inject_trace_context wire shape) activates a remote-rooted span
        tree around the executor and ships it back in the response
        envelope for the broker to stitch."""
        # accountant id stays server-local: in-process clusters share ONE
        # global accountant, and registering the broker's query id from
        # two server nodes (hybrid halves, hedged duplicates) would
        # collide; the broker id rides the span tree instead
        query_id = uuid.uuid4().hex[:12]
        # the deadline anchors at ARRIVAL, before scheduler admission:
        # queue time is inside the broker's budget, not in addition to it
        t_arrive = time.perf_counter()
        sampled = bool((trace_ctx or {}).get("sampled"))

        def run() -> Dict[str, Any]:
            # the scheduler runs this on a worker thread — the span
            # tracer is thread-local, so the tree must root HERE, not in
            # the HTTP handler thread that admitted the query
            if not sampled:
                return self._execute(sql, segment_names, query_id,
                                     deadline_ms, t_arrive)
            from ..utils import phases as ph
            from ..utils.spans import span_tracer
            root = span_tracer.start(
                ph.SERVER_QUERY, server=self.instance_id,
                query_id=trace_ctx.get("queryId") or query_id,
                parent_span_id=trace_ctx.get("parentSpanId"))
            try:
                resp = self._execute(sql, segment_names, query_id,
                                     deadline_ms, t_arrive)
            finally:
                root = span_tracer.stop() or root
            root.annotate(segments=resp.get("segmentsQueried", 0))
            resp["trace"] = root.to_dict()
            return resp

        # tenant/tier attribution forwarded by the dispatching broker
        # (broker_node._scatter): the tier-aware HeapWatcher kill
        # ordering and post-paid tenant budgets act HERE, where the
        # kernels actually execute
        wl = workload or {}
        global_accountant.register(query_id,
                                   tenant=wl.get("tenant"),
                                   tier=wl.get("tier"), sql=sql)
        try:
            resp = self.scheduler.execute(run, query_id,
                                          priority=priority)
        finally:
            usage = global_accountant.unregister(query_id)
        if usage is not None and usage.batched_dispatches:
            # cross-query micro-batching participation (engine/ragged):
            # rides the wire header so the broker's query_stats records
            # carry batched/batch_size per query
            resp["batched"] = usage.batched_dispatches
            resp["batchSize"] = usage.max_batch_size
        return resp

    def _execute(self, sql: str, segment_names: Optional[List[str]] = None,
                 query_id: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 t_arrive: Optional[float] = None) -> Dict[str, Any]:
        t0 = time.perf_counter()
        stmt = parse_sql(sql)
        from ..query.sql import DdlStmt, SetOpStmt
        if isinstance(stmt, (SetOpStmt, DdlStmt)):
            raise ValueError("leaf servers execute single-table stages; "
                             "set operations and DDL belong to the broker")
        from ..multistage.window import has_window
        if has_window(stmt):
            raise ValueError("leaf servers execute single-table stages; "
                             "window functions run in the dispatch stage")
        if query_id is not None:
            # enforce the query's timeoutMs where the work actually runs
            # (the broker-side deadline lives in a different process in
            # cluster mode), clamped to the broker's forwarded remaining
            # budget so a re-dispatched straggler cannot outlive the
            # scatter that asked for it
            from ..broker.broker import DEFAULT_TIMEOUT_MS
            timeout_ms = int(stmt.options.get("timeoutMs",
                                              DEFAULT_TIMEOUT_MS))
            if deadline_ms is not None:
                timeout_ms = min(timeout_ms, int(deadline_ms))
            global_accountant.set_deadline(
                query_id, (t_arrive or t0) + timeout_ms / 1e3)
        if stmt.joins:
            raise ValueError("leaf servers execute single-table stages")
        from ..utils.faults import fault_point
        fault_point("segment.slow", key=self.instance_id)
        ctx = build_query_context(stmt)
        dm = self._tables.get(ctx.table)
        if dm is None:
            return {"partials_raw": [], "segmentsQueried": 0}
        segments = dm.acquire_segments()
        if segment_names is not None:
            wanted = set(segment_names)
            segments = [s for s in segments if s.name in wanted]
        # shared loop with the in-process broker (engine/serving.py)
        from ..engine.serving import execute_planned, plan_segments
        if stmt.explain:
            ex = plan_segments(ctx, segments, use_rollups=False)
            from ..query.explain import explain_rows
            cols, rows = explain_rows(ctx, ex.real_plans, 0)
            return {"explain": {"columns": cols,
                                "rows": [list(r) for r in rows]},
                    "segmentsQueried": len(segments)}
        ex = plan_segments(ctx, segments)
        try:
            execute_planned(ex)
        finally:
            # also when the execution was killed part way (a deadline):
            # what it launched before that ran on these plans
            if self.on_execute is not None:
                self.on_execute(sql, segments, ex.real_plans)
        return {"partials_raw": ex.partials,
                "segmentsQueried": len(segments)}

    def execute_json(self, sql: str,
                     segment_names: Optional[List[str]] = None,
                     deadline_ms: Optional[float] = None,
                     trace_ctx: Optional[Dict[str, Any]] = None,
                     workload: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
        """Legacy/debuggable JSON wire (also serves EXPLAIN)."""
        resp = self.execute(sql, segment_names, deadline_ms=deadline_ms,
                            trace_ctx=trace_ctx, workload=workload)
        raw = resp.pop("partials_raw", None)
        if raw is not None:
            resp["partials"] = [partial_to_wire(p) for p in raw]
        return resp

    def execute_bin(self, sql: str,
                    segment_names: Optional[List[str]] = None,
                    deadline_ms: Optional[float] = None,
                    trace_ctx: Optional[Dict[str, Any]] = None,
                    workload: Optional[Dict[str, Any]] = None) -> bytes:
        """Binary data plane: columnar DataBlock partials in one frame.
        The span tree (when sampled) rides the JSON frame header, along
        with ``serdeEncodeMs`` — the partial-encode time this side of
        the wire, so the broker can split its call-span gap into serde
        vs true network time (the encode is timed BEFORE the header is
        assembled; header serialization itself is negligible)."""
        from ..engine.datablock import (encode_partial,
                                        encode_wire_frame_blocks)
        resp = self.execute(sql, segment_names, deadline_ms=deadline_ms,
                            trace_ctx=trace_ctx, workload=workload)
        raw = resp.pop("partials_raw", [])
        t_enc = time.perf_counter()
        blocks = [encode_partial(p) for p in raw]
        resp["serdeEncodeMs"] = round(
            (time.perf_counter() - t_enc) * 1e3, 3)
        return encode_wire_frame_blocks(resp, blocks)

    def handle_reload(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Reload a hosted table's segments against a (new) table config
        (the reload segment/table REST operation + reload Helix message
        analog: servers rebuild secondary indexes in place)."""
        from ..spi.config import TableConfig
        table = body["table"]
        dm = self._tables.get(table)
        if dm is None:
            return {"reloaded": 0, "added": [], "removed": []}
        cfg_dict = body.get("tableConfig")
        if not cfg_dict:
            # reload against the CURRENT config: the controller's routing
            # snapshot is the config source of truth for cluster servers
            snap = http_json("GET", f"{self.controller_url}/routing")
            cfg_dict = (snap.get("tables", {}).get(table) or {}) \
                .get("config")
            if not cfg_dict:
                raise ValueError(f"no table config for {table!r} at the "
                                 "controller; pass tableConfig inline")
        changes = dm.reload(TableConfig.from_dict(cfg_dict))
        return {"reloaded": len(dm.acquire_segments()), **changes}

    def handle_mailbox(self, data: bytes) -> Dict[str, Any]:
        from ..multistage.dispatch import deliver_mailbox_frame
        deliver_mailbox_frame(self.mailboxes, data)
        return {"status": "OK"}

    def handle_stage(self, spec: Dict[str, Any],
                     trace_ctx: Optional[Dict[str, Any]] = None):
        from ..multistage.dispatch import execute_stage
        return execute_stage(self, spec, trace_ctx=trace_ctx)

    def memory_payload(self) -> Dict[str, Any]:
        """GET /debug/memory: the shared device-memory pools, tier and
        heat, this node's residency, its device and the device of every
        resident column of every segment it hosts."""
        from .forensics import memory_debug_payload
        out = memory_debug_payload(self.instance_id, self._residency())
        out["device"] = str(self.device)
        out["columns"] = {
            table: {s.name: s.resident_devices()
                    for s in dm.acquire_segments()}
            for table, dm in list(self._tables.items())}
        return out

    def _make_handler(self):
        from ..utils.slo import global_incidents
        from .forensics import (debug_index, ledger_debug_payload,
                                memory_debug_payload, parse_since)
        node = self

        class Handler(JsonHandler):
            routes = {
                ("GET", "/health"): lambda h, b: (200, {"status": "OK"}),
                # debug-surface index + incident flight-recorder ring
                #
                ("GET", "/debug"): lambda h, b: (
                    200, debug_index(node.instance_id, "server")),
                ("GET", "/debug/incidents"): lambda h, b: (
                    200, global_incidents.snapshot()),
                # ledger shipping + device-memory telemetry:
                # the controller's ForensicsRollupTask pulls the ledger
                # delta + heat/devmem/counters blocks; /debug/memory is
                # the HBM residency view the future tiered segment
                # cache will admit/evict on
                ("GET", "/debug/ledger"): lambda h, b: (
                    200, ledger_debug_payload(
                        node.instance_id, "server", node.ledger_path,
                        parse_since(h.path))),
                ("GET", "/debug/memory"): lambda h, b: (
                    200, node.memory_payload()),
                ("POST", "/query/bin"): lambda h, b: (
                    200, node.execute_bin(b["sql"], b.get("segments"),
                                          b.get("deadlineMs"),
                                          b.get("traceContext"),
                                          b.get("workload"))),
                ("POST", "/query"): lambda h, b: (
                    200, node.execute_json(b["sql"], b.get("segments"),
                                           b.get("deadlineMs"),
                                           b.get("traceContext"),
                                           b.get("workload"))),
                # multi-stage data plane (mailbox.proto analog) + stage
                # dispatch (worker.proto Submit analog; the trace
                # context rides an HTTP header because the StagePlan
                # proto body is opaque bytes)
                ("POST", "/mailbox"): lambda h, b: (
                    200, node.handle_mailbox(b)),
                ("POST", "/reload"): lambda h, b: (
                    200, node.handle_reload(b)),
                ("POST", "/stage"): lambda h, b: (
                    200, node.handle_stage(b, trace_context_from(
                        h.headers))),
            }
        return Handler

    def stop(self) -> None:
        self._stop.set()
        if self._fault_plan is not None:
            from ..utils import faults
            if faults.current_plan() is self._fault_plan:
                faults.clear()
            self._fault_plan = None
        self.scheduler.stop()
        if self.heap_watcher is not None:
            self.heap_watcher.stop()
        self._httpd.shutdown()
        self._httpd.server_close()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"
