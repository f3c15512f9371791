"""Controller: cluster metadata + declarative reconciliation.

Reference parity: pinot-controller/.../BaseControllerStarter.java:351 +
PinotHelixResourceManager (table/segment/instance CRUD) + segment
assignment strategies (helix/core/assignment/segment/) + periodic tasks
(RetentionManager, SegmentStatusChecker — BaseControllerStarter.java:
174-191). TPU-native stance (SURVEY.md section 5, distributed backend):
Helix/ZK is replaceable infrastructure, not product surface — a single
controller process owns a file-backed property store (atomic tmp+rename
JSON, the ZK property-store analog), instances announce themselves with
heartbeats (ephemeral-node analog), and a reconciliation loop converges
ideal state: every segment assigned to `replication` live servers with
minimal movement (keep surviving replicas, top up from least-loaded).
Brokers/servers poll a monotonically versioned ideal state instead of
watching ZK events.

Port of ``pinot_tpu/cluster/controller.py``: the registry, assignment,
reconcile loop, heartbeats, leader lease, rebalance and REST routes, with
the same state directory (``cluster_state.json``) so either package's
controller serves the other's. It schedules the fleet forensics rollup
(``cluster/rollup.py``) and the closed-loop rebalancer
(``cluster/rebalancer.py``), leader-gated, arbitrates realtime commits
(``cluster/completion.py``), plans the incident autopsy over the fleet
ledger (``cluster/autopsy.py``) and serves the web app
(``cluster/webapp.py``). Their files (the fleet ledger, the per-node
cursors, ``rebalance_journal.json``) carry between the packages. The
compile-plane health block is JAX-only and left out of ``/ui/data``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .http_util import JsonHandler, start_http


HEARTBEAT_TIMEOUT_S = 10.0
RECONCILE_INTERVAL_S = 1.0


class Controller:
    def __init__(self, data_dir: str, port: int = 0,
                 heartbeat_timeout: float = HEARTBEAT_TIMEOUT_S,
                 reconcile_interval: float = RECONCILE_INTERVAL_S,
                 lease_ttl: Optional[float] = None,
                 instance_id: Optional[str] = None):
        """lease_ttl enables HA mode (LeadControllerManager analog): controllers sharing a
        data_dir contend for a file lease; exactly one leads (runs
        reconcile/periodic tasks, accepts writes) while the others tail
        the versioned property store and serve stale-ok reads, taking
        over within ~lease_ttl of the leader dying. lease_ttl=None is
        the classic single-node controller."""
        import uuid as _uuid

        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self._lock = threading.RLock()
        self._routing_cache: Optional[Dict[str, Any]] = None
        self.heartbeat_timeout = heartbeat_timeout
        self.reconcile_interval = reconcile_interval
        self.lease_ttl = lease_ttl
        self.instance_id = instance_id or f"controller_{_uuid.uuid4().hex[:8]}"
        # single-writer atomic bool BY DESIGN: the lease loop abdicates
        # without _lock (taking it would deadlock through
        # _bump->_persist) and GIL-atomic bool stores need no guard
        self.is_leader = False  # guarded-by: none
        self._recon: Optional[threading.Thread] = None
        self._state: Dict[str, Any] = self._load() or {
            "version": 0,
            "tables": {},      # name -> {schema, config, replication}
            "segments": {},    # table -> {segment -> {location, meta}}
            "assignment": {},  # table -> {segment -> [instance ids]}
            "lineage": {},     # table -> [{id, from, to, state}]
        }
        self._state.setdefault("lineage", {})
        self._instances: Dict[str, Dict[str, Any]] = {}  # ephemeral
        self._status: Dict[str, Any] = {}
        self._stop = threading.Event()
        # periodic controller tasks (BaseControllerStarter.java:174-191);
        # built before the HTTP server binds so /periodictask/* never sees
        # a half-constructed controller
        from .periodic import BasePeriodicTask, PeriodicTaskScheduler
        self.scheduler = PeriodicTaskScheduler()
        # periodic tasks are leader-gated in HA mode: an abdicated
        # controller's scheduler keeps ticking (restartability) but its
        # tasks no-op — a fenced-out epoch must never mutate the shared
        # property store or delete deep-store artifacts
        self.scheduler.register(BasePeriodicTask(
            "RetentionManager", interval_s=60.0,
            fn=self._leader_gated(self.run_retention)))
        self.scheduler.register(BasePeriodicTask(
            "SegmentStatusChecker", interval_s=30.0,
            fn=self._leader_gated(self.run_status_check)))
        # fleet forensics rollup: pull per-node ledgers,
        # aggregate cluster-wide, serve at GET /debug/fleet + the
        # webapp Fleet view. Leader-gated like every periodic task and
        # REST-triggerable (POST /periodictask/run/ForensicsRollup);
        # the initial delay keeps short-lived test controllers from
        # auto-pulling mid-setup
        from .rollup import ForensicsRollupTask
        self.rollup = ForensicsRollupTask(self)
        self.scheduler.register(BasePeriodicTask(
            ForensicsRollupTask.NAME, interval_s=30.0,
            initial_delay_s=30.0,
            fn=self._leader_gated(self.rollup.run)))
        # closed-loop rebalance: consumes the rollup's
        # slo/heat/plan_shapes blocks, moves segments when a budget
        # burns, freezes while an incident is open. Leader-gated +
        # REST-triggerable like the rollup; the initial delay sits
        # after the first rollup pass so a pass has a fleet view
        from .rebalancer import ClosedLoopRebalanceTask
        self.rebalancer = ClosedLoopRebalanceTask(self)
        self.scheduler.register(BasePeriodicTask(
            ClosedLoopRebalanceTask.NAME, interval_s=60.0,
            initial_delay_s=45.0,
            fn=self._leader_gated(self.rebalancer.run)))
        # realtime commit arbitration (SegmentCompletionManager FSM); the
        # registry fallback keeps restarts/purges from re-electing a
        # committer for an already-registered segment
        from .completion import SegmentCompletionManager

        def _registered(table: str, segment: str):
            with self._lock:
                entry = self._state["segments"].get(table, {}).get(segment)
                if entry is None:
                    return None
                meta = entry.get("meta") or {}
                return {"downloadURI": entry.get("location"),
                        "offset": meta.get("endOffset")}

        self.completion = SegmentCompletionManager(
            expected_replicas=lambda t: self._state["tables"]
            .get(t, {}).get("replication", 1),
            registered_segment=_registered)
        self._httpd, self.port, _ = start_http(self._make_handler(), port)
        if self.lease_ttl is None:
            self._become_leader()
        else:
            # one synchronous acquire attempt so constructing against a
            # free lease returns an already-leading controller; then the
            # lease loop renews / tails / takes over
            if self._try_acquire_lease():
                self._become_leader()
            self._lease_thread = threading.Thread(
                target=self._lease_loop, daemon=True)
            self._lease_thread.start()

    # -- leadership (LeadControllerManager analog) -------------------------
    def _lease_path(self) -> str:
        return os.path.join(self.data_dir, "leader.lease")

    def _read_lease(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self._lease_path()) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def _write_lease(self, epoch: int) -> None:
        tmp = self._lease_path() + f".w{self.instance_id}"
        with open(tmp, "w") as fh:
            json.dump({"holder": self.instance_id, "epoch": epoch,
                       "expires": time.time() + self.lease_ttl}, fh)
        os.replace(tmp, self._lease_path())

    def _try_acquire_lease(self) -> bool:
        """Claim the lease if free/expired. A short-lived O_EXCL lock
        file serializes contenders (stale locks from a crash mid-claim
        are broken after 2x ttl)."""
        now = time.time()
        cur = self._read_lease()
        if cur and cur.get("holder") != self.instance_id \
                and cur.get("expires", 0) > now:
            return False
        lock = self._lease_path() + ".lock"
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:
                if now - os.path.getmtime(lock) > \
                        max(self.lease_ttl or 1.0, 1.0) * 2:
                    os.unlink(lock)
            except OSError:
                pass
            return False
        try:
            os.close(fd)
            cur = self._read_lease()   # re-check under the claim lock
            if cur and cur.get("holder") != self.instance_id \
                    and cur.get("expires", 0) > now:
                return False
            epoch = (cur or {}).get("epoch", 0)
            if not cur or cur.get("holder") != self.instance_id:
                epoch += 1             # fencing token: bumps on takeover
            self._write_lease(epoch)
            return True
        finally:
            try:
                os.unlink(lock)
            except OSError:
                pass

    def _leader_gated(self, fn):
        def run():
            if self.lease_ttl is not None and not self.is_leader:
                return
            fn()
        return run

    def _renew_lease(self) -> bool:
        """Renew under the same claim lock acquisition takes, re-checking
        the holder — a stalled leader must never clobber a standby's
        fresh claim or regress the fencing epoch. False -> abdicate."""
        lock = self._lease_path() + ".lock"
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            # a contender holds the claim lock this tick; keep leading
            # until the holder check resolves next tick
            cur = self._read_lease()
            return not cur or cur.get("holder") == self.instance_id
        try:
            os.close(fd)
            cur = self._read_lease()
            if cur and cur.get("holder") != self.instance_id:
                return False           # stolen while we stalled
            self._write_lease((cur or {}).get("epoch", 1))
            return True
        finally:
            try:
                os.unlink(lock)
            except OSError:
                pass

    def _become_leader(self) -> None:
        with self._lock:
            # the previous leader may have written newer state: reload
            fresh = self._load()
            if fresh is not None and fresh.get("version", 0) >= \
                    self._state.get("version", 0):
                self._state = fresh
                self._state.setdefault("lineage", {})
                self._routing_cache = None
            self.is_leader = True
        if self._recon is None:
            self._recon = threading.Thread(target=self._reconcile_loop,
                                           daemon=True)
            self._recon.start()
            self.scheduler.start()

    def _tail_state(self) -> None:
        """Standby read path: follow the leader's property-store writes
        so reads (routing, status, UI) serve fresh-enough snapshots."""
        fresh = self._load()
        if fresh is None:
            return
        with self._lock:
            if fresh.get("version", 0) > self._state.get("version", 0):
                self._state = fresh
                self._state.setdefault("lineage", {})
                self._routing_cache = None

    def _lease_loop(self) -> None:
        interval = max(self.lease_ttl / 3.0, 0.05)
        while not self._stop.wait(interval):
            if self.is_leader:
                if not self._renew_lease():
                    # lease stolen (e.g. long GC pause past expiry):
                    # abdicate — never act on a fenced-out epoch.
                    # is_leader is a single-writer atomic bool; taking
                    # _lock here would deadlock through _bump->_persist
                    self.is_leader = False
            else:
                self._tail_state()
                if self._try_acquire_lease():
                    self._become_leader()

    # -- property store ----------------------------------------------------
    def _path(self) -> str:
        return os.path.join(self.data_dir, "cluster_state.json")

    def _load(self) -> Optional[Dict[str, Any]]:
        if os.path.exists(self._path()):
            with open(self._path()) as fh:
                return json.load(fh)
        return None

    def _persist(self) -> None:
        if self.lease_ttl is not None:
            # epoch fence on the STORE, not just the lease: a stalled
            # ex-leader can keep is_leader for up to one renewal tick
            # after a takeover — re-check the lease holder immediately
            # before every write so its stale in-memory state can never
            # clobber the new leader's property store (the
            # lease file alone protects only itself).
            cur = self._read_lease()
            if not self.is_leader or (
                    cur and cur.get("holder") != self.instance_id):
                # callers (_bump) hold _lock; atomic bool abdication
                self.is_leader = False
                return   # abdicate silently; _tail_state re-syncs reads
        tmp = self._path() + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._state, fh, indent=1)
        os.replace(tmp, self._path())

    def _bump(self) -> None:
        # every caller mutates _state under self._lock and bumps inside
        # the same critical section
        self._state["version"] += 1
        self._persist()

    # -- instance registry (Helix liveness analog) -------------------------
    def register_instance(self, inst: Dict[str, Any]) -> None:
        with self._lock:
            inst = dict(inst)
            inst["lastHeartbeat"] = time.monotonic()
            self._instances[inst["id"]] = inst
            self._reconcile_locked()

    def heartbeat(self, instance_id: str,
                  residency: Optional[Dict[str, Any]] = None) -> bool:
        """Liveness refresh; servers also piggyback their per-segment
        tier residency ({table: {segment: hot|warm|cold|cube}}, the
        HBM-tier placement signal the routing snapshot ships to
        brokers for affinity routing)."""
        with self._lock:
            inst = self._instances.get(instance_id)
            if inst is None:
                return False
            inst["lastHeartbeat"] = time.monotonic()
            if residency is not None:
                inst["residency"] = residency
            return True

    def assignment_version(self) -> int:
        """The current property-store version — piggybacked on
        heartbeat responses as an assignment epoch so brokers/servers
        converge on a flip without waiting out a poll interval (or a
        restart)."""
        with self._lock:
            return self._state["version"]

    def live_servers(self, tenant: Optional[str] = None) -> List[str]:
        """Live server instances; with tenant, only instances carrying
        that tag (tag-based tenant isolation, controller tenant mgmt)."""
        now = time.monotonic()
        out = []
        for i in self._instances.values():
            if i.get("role") != "server":
                continue
            if now - i["lastHeartbeat"] > self.heartbeat_timeout:
                continue
            if tenant is not None and tenant not in (i.get("tags") or []):
                continue
            out.append(i["id"])
        return sorted(out)

    def live_brokers(self) -> List[str]:
        """Live (heartbeat-fresh) broker instances — the reference's
        HelixExternalViewBasedQueryQuotaManager divides each table's
        QPS quota by this count, and brokers
        register+heartbeat exactly like servers, so the routing
        snapshot can now ship it (broker/quota.py consumes it)."""
        now = time.monotonic()
        return sorted(
            i["id"] for i in self._instances.values()
            if i.get("role") == "broker"
            and now - i["lastHeartbeat"] <= self.heartbeat_timeout)

    # -- tables / segments -------------------------------------------------
    def add_table(self, name: str, schema: Dict[str, Any],
                  config: Optional[Dict[str, Any]] = None,
                  replication: int = 1) -> None:
        with self._lock:
            self._state["tables"][name] = {
                "schema": schema, "config": config or {},
                "replication": replication}
            self._state["segments"].setdefault(name, {})
            self._state["assignment"].setdefault(name, {})
            self._bump()

    def update_table_config(self, name: str,
                            config: Dict[str, Any]) -> None:
        """Replace a table's config without touching schema/replication/
        assignment (the updateTableConfig REST operation; reload then
        reconciles segments against it)."""
        with self._lock:
            if name not in self._state["tables"]:
                raise KeyError(f"table {name!r} not registered")
            self._state["tables"][name]["config"] = config or {}
            self._bump()

    @staticmethod
    def _delete_artifact(location: Optional[str]) -> None:
        """Best-effort deletion of a retired segment's bytes (local dir or
        deep-store archive via PinotFS) — dropping only the metadata would
        grow deep-store/disk unboundedly (RetentionManager deletes the
        artifacts too)."""
        if not location:
            return
        try:
            from ..spi.filesystem import fs_for_uri
            fs, path = fs_for_uri(location)
            fs.delete(path, force=True)
        except Exception:
            pass  # unreachable store: metadata removal still wins

    def drop_table(self, name: str) -> None:
        with self._lock:
            for key in ("tables", "segments", "assignment", "lineage"):
                self._state[key].pop(name, None)
            self._bump()
        # outside self._lock: segmentCommitEnd nests completion._lock ->
        # self._lock (register), so nesting the other way here would be
        # an ABBA deadlock
        self.completion.drop_table(name)

    @staticmethod
    def _read_segment_meta(location: str) -> Optional[Dict[str, Any]]:
        """Pruning metadata from the segment dir (per-column min/max +
        partitions, ZK segment-metadata analog); None when unreadable."""
        from .deepstore import pruning_metadata
        return pruning_metadata(location)

    def add_segment(self, table: str, segment: str, location: str,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            if table not in self._state["tables"]:
                raise KeyError(f"table {table!r} not registered")
            prev = self._state["segments"][table].get(segment)
            if metadata is None:
                metadata = self._read_segment_meta(location)
            self._state["segments"][table][segment] = {
                "location": location, "meta": metadata}
            if prev is not None and prev.get("location") != location:
                # segment refresh/replace: assignment may be unchanged but
                # servers must re-download — force a version bump so their
                # assignment sync sees it (segment refresh message analog)
                self._bump()
            self._reconcile_locked()

    # -- assignment / reconciliation ---------------------------------------
    def _reconcile_loop(self) -> None:
        while not self._stop.wait(self.reconcile_interval):
            if self.lease_ttl is not None and not self.is_leader:
                continue   # abdicated: a fenced-out epoch must not act
            with self._lock:
                self._reconcile_locked()

    def _table_tenant(self, table: str) -> Optional[str]:
        cfg = self._state["tables"].get(table, {}).get("config") or {}
        return cfg.get("serverTenant")

    def _segment_tier_tag(self, table: str, segment: str) -> Optional[str]:
        """First age-matching tier's server tag, else None (stay on the
        tenant). TierFactory TIME segmentSelector analog: age is measured
        from the segment's creationTimeMs metadata."""
        cfg = self._state["tables"].get(table, {}).get("config") or {}
        tiers = cfg.get("tiers") or []
        if not tiers:
            return None
        meta = (self._state["segments"].get(table, {}).get(segment)
                or {}).get("meta") or {}
        created_ms = meta.get("creationTimeMs")
        if created_ms is None:
            return None
        age = time.time() - created_ms / 1e3
        for t in tiers:
            if age >= float(t.get("segmentAgeSeconds", float("inf"))):
                return t.get("serverTag")
        return None

    def _segment_live(self, table: str, segment: str,
                      tenant_live: List[str],
                      tag_cache: Optional[Dict[str, List[str]]] = None
                      ) -> List[str]:
        tag = self._segment_tier_tag(table, segment)
        if tag is None:
            return tenant_live
        if tag_cache is not None and tag in tag_cache:
            tier_live = tag_cache[tag]
        else:
            tier_live = self.live_servers(tag)
            if tag_cache is not None:
                tag_cache[tag] = tier_live
        # a tier with zero live servers must not unassign the segment:
        # availability beats placement policy (the reference likewise
        # keeps serving from the current tier until the target has hosts)
        return tier_live if tier_live else tenant_live

    def _reconcile_locked(self) -> None:
        """Converge assignment: each segment on `replication` live servers
        of the table's tenant, minimal movement (TableRebalancer analog at
        small scale)."""
        changed = False
        all_live = self.live_servers()
        load: Dict[str, int] = {s: 0 for s in all_live}
        for table, segs in self._state["assignment"].items():
            for seg, holders in segs.items():
                for h in holders:
                    if h in load:
                        load[h] += 1
        tag_cache: Dict[str, List[str]] = {}
        for table, tmeta in self._state["tables"].items():
            tenant_live = self.live_servers(self._table_tenant(table))
            assign = self._state["assignment"].setdefault(table, {})
            for seg in self._state["segments"].get(table, {}):
                # tier selection may narrow the candidates to the tier
                # tag's servers (age-based tiered storage)
                live = self._segment_live(table, seg, tenant_live,
                                          tag_cache)
                repl = min(tmeta.get("replication", 1), max(len(live), 1))
                cur = assign.get(seg, [])
                holders = [h for h in cur if h in live]
                while len(holders) < repl and live:
                    candidates = [s for s in live if s not in holders]
                    if not candidates:
                        break
                    pick = min(candidates, key=lambda s: load.get(s, 0))
                    holders.append(pick)
                    load[pick] = load.get(pick, 0) + 1
                if any(h not in cur for h in holders):
                    # migration in flight (tier move / replacement): keep
                    # prior live holders serving until the next tick, when
                    # the new targets have had a poll+download cycle —
                    # approximation of the reference's external-view
                    # gating (routing only advertises ONLINE replicas)
                    for h in cur:
                        if h in all_live and h not in holders:
                            holders.append(h)
                if assign.get(seg) != holders:
                    assign[seg] = holders
                    changed = True
        if changed:
            self._bump()

    # -- rebalance (TableRebalancer analog) --------------------------------
    def rebalance(self, table: str, dry_run: bool = False,
                  replication: Optional[int] = None) -> Dict[str, Any]:
        """Recompute a balanced assignment with minimal movement: keep
        surviving replicas, move only what load-balance requires. Returns
        the before/after diff (rebalance observer analog); applies unless
        dry_run."""
        with self._lock:
            if table not in self._state["tables"]:
                raise KeyError(f"table {table!r} not registered")
            live = self.live_servers(self._table_tenant(table))
            # tiered segments may be placeable even when the tenant has no
            # live servers (and vice versa): gate and cap on the union
            cfg = self._state["tables"][table].get("config") or {}
            tag_cache: Dict[str, List[str]] = {}
            for t in cfg.get("tiers") or []:
                tag = t.get("serverTag")
                if tag is not None and tag not in tag_cache:
                    tag_cache[tag] = self.live_servers(tag)
            union = list(dict.fromkeys(
                live + [s for ls in tag_cache.values() for s in ls]))
            if not union:
                return {"status": "NO_SERVERS", "table": table}
            if replication is None:
                replication = self._state["tables"][table].get(
                    "replication", 1)
            elif not dry_run:
                # a dry run must not change cluster state
                self._state["tables"][table]["replication"] = replication
            repl = min(replication, len(union))
            segs = sorted(self._state["segments"].get(table, {}))
            current = {s: list(self._state["assignment"]
                               .get(table, {}).get(s, []))
                       for s in segs}
            # target load per server for THIS table
            total = len(segs) * repl
            cap = -(-total // len(union))  # ceil
            load = {s: 0 for s in union}
            target: Dict[str, List[str]] = {}
            moved = 0
            # per-segment candidates honor tier placement, exactly like
            # the reconcile loop (a rebalance must not undo tiering)
            seg_live = {s: self._segment_live(table, s, live, tag_cache)
                        for s in segs}
            # pass 1: keep current holders that are candidates, under cap
            for seg in segs:
                kept = []
                for h in current[seg]:
                    if h in seg_live[seg] and load.get(h, 0) < cap \
                            and len(kept) < repl:
                        kept.append(h)
                        load[h] = load.get(h, 0) + 1
                target[seg] = kept
            # pass 2: top up from least-loaded candidates
            for seg in segs:
                while len(target[seg]) < min(repl, len(seg_live[seg])):
                    cands = [s for s in seg_live[seg]
                             if s not in target[seg]]
                    if not cands:
                        break
                    pick = min(cands, key=lambda s: load.get(s, 0))
                    target[seg].append(pick)
                    load[pick] = load.get(pick, 0) + 1
                    if pick not in current[seg]:
                        moved += 1
            result = {
                "status": "DRY_RUN" if dry_run else "DONE",
                "table": table,
                "segmentsMoved": moved,
                "numSegments": len(segs),
                "replication": repl,
                "serverLoad": load,
            }
            if not dry_run:
                if self._state["assignment"].get(table) != target:
                    self._state["assignment"][table] = target
                    self._bump()
            return result

    # -- retention (RetentionManager analog) -------------------------------
    _UNIT_MS = {"MILLISECONDS": 1, "SECONDS": 1_000, "MINUTES": 60_000,
                "HOURS": 3_600_000, "DAYS": 86_400_000}

    def run_retention(self) -> None:
        """Drop segments older than the table's retention, judged by the
        time column's max value in segment metadata. Artifact deletion
        (deep-store I/O) happens after the lock is released — a hung
        store must not stall the control plane."""
        now_ms = time.time() * 1e3
        retired: List[Optional[str]] = []
        with self._lock:
            changed = False
            for table, tmeta in list(self._state["tables"].items()):
                cfg = tmeta.get("config") or {}
                value = cfg.get("retentionValue")
                tcol = cfg.get("timeColumn")
                if not value or not tcol:
                    continue
                unit_ms = self._UNIT_MS.get(
                    str(cfg.get("retentionUnit", "DAYS")).upper(), 86_400_000)
                tcol_ms = self._UNIT_MS.get(
                    str(cfg.get("timeUnit", "MILLISECONDS")).upper(), 1)
                cutoff_ms = now_ms - float(value) * unit_ms
                for seg, entry in list(
                        self._state["segments"].get(table, {}).items()):
                    cm = ((entry.get("meta") or {}).get("columns")
                          or {}).get(tcol)
                    if cm is None or cm.get("max") is None:
                        continue
                    if float(cm["max"]) * tcol_ms < cutoff_ms:
                        entry = self._state["segments"][table].pop(
                            seg, None)
                        self._state["assignment"].get(table, {}).pop(
                            seg, None)
                        retired.append((entry or {}).get("location"))
                        changed = True
            if changed:
                self._bump()
        for loc in retired:
            self._delete_artifact(loc)

    # -- status checker (SegmentStatusChecker analog) ----------------------
    def run_status_check(self) -> None:
        with self._lock:
            live = set(self.live_servers())
            out: Dict[str, Any] = {}
            for table, tmeta in self._state["tables"].items():
                repl = tmeta.get("replication", 1)
                segs = self._state["segments"].get(table, {})
                assign = self._state["assignment"].get(table, {})
                unassigned = sum(
                    1 for s in segs
                    if not [h for h in assign.get(s, []) if h in live])
                under = sum(
                    1 for s in segs
                    if 0 < len([h for h in assign.get(s, []) if h in live])
                    < repl)
                out[table] = {
                    "numSegments": len(segs),
                    "numUnassigned": unassigned,
                    "numUnderReplicated": under,
                    "healthy": unassigned == 0,
                }
            self._status = out

    # -- segment lineage (replace/merge atomicity) -------------------------
    def start_replace_segments(self, table: str, from_segs: List[str],
                               to_segs: List[str]) -> str:
        """Begin an atomic segment swap (SegmentLineage IN_PROGRESS):
        the new segments stay invisible to routing until the end call."""
        import uuid as _uuid
        with self._lock:
            if table not in self._state["tables"]:
                raise KeyError(f"table {table!r} not registered")
            entry_id = _uuid.uuid4().hex[:12]
            self._state["lineage"].setdefault(table, []).append({
                "id": entry_id, "from": list(from_segs),
                "to": list(to_segs), "state": "IN_PROGRESS",
            })
            self._bump()
            return entry_id

    def _retire_lineage_segments(self, table: str, entry_id: str,
                                 from_state: str, to_state: str,
                                 seg_key: str, reconcile: bool) -> None:
        retired: List[Optional[str]] = []
        with self._lock:
            for e in self._state["lineage"].get(table, []):
                if e["id"] == entry_id and e["state"] == from_state:
                    e["state"] = to_state
                    for seg in e[seg_key]:
                        entry = self._state["segments"].get(
                            table, {}).pop(seg, None)
                        self._state["assignment"].get(table, {}).pop(
                            seg, None)
                        retired.append((entry or {}).get("location"))
                    if reconcile:
                        self._reconcile_locked()
                    self._bump()
                    break
            else:
                raise KeyError(
                    f"no {from_state} lineage entry {entry_id!r}")
        for loc in retired:  # deep-store I/O outside the lock
            self._delete_artifact(loc)

    def end_replace_segments(self, table: str, entry_id: str) -> None:
        """Flip the lineage entry to COMPLETED: new segments become
        routable, replaced ones are removed, atomically (one version
        bump). Removal (not permanent name exclusion) keeps replaced
        segment names reusable by later uploads."""
        self._retire_lineage_segments(table, entry_id, "IN_PROGRESS",
                                      "COMPLETED", "from", reconcile=True)

    def revert_replace_segments(self, table: str, entry_id: str) -> None:
        self._retire_lineage_segments(table, entry_id, "IN_PROGRESS",
                                      "REVERTED", "to", reconcile=False)

    def _excluded_segments(self, table: str) -> set:
        """Segments hidden from routing by lineage state. Only IN_PROGRESS
        "to" segments are hidden (resident on servers but not routable
        until the flip); COMPLETED/REVERTED entries already removed their
        dead segments, so finished entries never blacklist a name."""
        out: set = set()
        for e in self._state["lineage"].get(table, []):
            if e["state"] == "IN_PROGRESS":
                out.update(e["to"])
        return out

    # -- views -------------------------------------------------------------
    # -- admin REST reads (pinot-controller/.../api/resources analog) -----
    def admin_tables(self) -> Dict[str, Any]:
        with self._lock:
            return {"tables": [
                {"name": t, "replication": m.get("replication", 1),
                 "segments": len(self._state["segments"].get(t, {})),
                 "serverTenant": (m.get("config") or {})
                 .get("serverTenant")}
                for t, m in self._state["tables"].items()]}

    def admin_table(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            m = self._state["tables"].get(name)
            if m is None:
                return None
            return {"name": name, "schema": m["schema"],
                    "config": m.get("config"),
                    "replication": m.get("replication", 1),
                    "segments": sorted(
                        self._state["segments"].get(name, {})),
                    "assignment": dict(
                        self._state["assignment"].get(name, {})),
                    "lineage": list(self._state["lineage"].get(name, []))}

    def admin_segments(self, table: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            segs = self._state["segments"].get(table)
            if segs is None:
                return None
            asn = self._state["assignment"].get(table, {})
            return {"table": table, "segments": {
                s: {"location": e.get("location"),
                    "metadata": e.get("meta"),
                    "servers": list(asn.get(s, []))}
                for s, e in segs.items()}}

    def admin_instances(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            return {"instances": sorted(({
                "id": i["id"], "role": i.get("role"),
                "host": i.get("host"), "port": i.get("port"),
                "tags": i.get("tags") or [],
                "lastHeartbeatSecondsAgo":
                    round(now - i["lastHeartbeat"], 1),
                "live": now - i["lastHeartbeat"]
                    <= self.heartbeat_timeout}
                for i in self._instances.values()),
                key=lambda x: x["id"])}

    def admin_leadership(self) -> Dict[str, Any]:
        return {"haEnabled": self.lease_ttl is not None,
                "isLeader": self.is_leader,
                "instanceId": self.instance_id,
                "lease": self._read_lease()}

    def _delete_segment_route(self, path: str):
        """Route adapter for DELETE /segments/{table}/{segment}:
        malformed paths and unknown names are routine 404s, never 500s
        (consistent with the GET admin endpoints)."""
        parts = [p for p in path.split("?")[0].split("/") if p]
        if len(parts) != 3 or parts[0] != "segments":
            return 404, {"error": "expected /segments/{table}/{segment}"}
        try:
            self.delete_segment(parts[1], parts[2])
        except KeyError as e:
            return 404, {"error": str(e).strip("'")}
        return 200, {"status": "OK"}

    def delete_segment(self, table: str, segment: str) -> None:
        """Admin segment drop: metadata + assignment + artifact
        (PinotSegmentRestletResource delete analog)."""
        with self._lock:
            entry = self._state["segments"].get(table, {}).pop(segment,
                                                               None)
            if entry is None:
                raise KeyError(f"unknown segment {table}/{segment}")
            self._state["assignment"].get(table, {}).pop(segment, None)
            self._bump()
        self._delete_artifact(entry.get("location"))

    def ui_data(self) -> Dict[str, Any]:
        """The web app's cluster snapshot (GET /ui/data, and the
        server-side hydration seed inlined into GET /ui)."""
        now = time.monotonic()
        with self._lock:
            instances = {
                i["id"]: {"live": now - i["lastHeartbeat"]
                          <= self.heartbeat_timeout,
                          "tags": i.get("tags") or [],
                          "role": i.get("role"),
                          "host": (f"{i.get('host')}:{i.get('port')}"
                                   if i.get("host") else "")}
                for i in self._instances.values()}
            tables = {
                t: {"replication": m.get("replication", 1),
                    "tenant": (m.get("config") or {}).get("serverTenant"),
                    "segments": sorted(
                        self._state["segments"].get(t, {})),
                    "assignment": {
                        s: list(h) for s, h in
                        self._state["assignment"].get(t, {}).items()}}
                for t, m in self._state["tables"].items()}
            version = self._state["version"]
        lease = self._read_lease() or {}
        tasks = {t["name"]: {k: v for k, v in t.items() if k != "name"}
                 for t in self.scheduler.status()}
        from ..utils.metrics import global_metrics, ingest_health
        return {"version": version, "instances": instances,
                "tables": tables, "tasks": tasks,
                "instance_id": self.instance_id,
                "leader": (self.instance_id if self.is_leader
                           else lease.get("holder")),
                "lease_holder": lease.get("holder"),
                # realtime-plane health next to the cluster view (shared
                # global_metrics for in-process roles)
                "ingest": ingest_health(global_metrics.snapshot()),
                # fleet forensics rollup (webapp Fleet view): the latest
                # ForensicsRollup pass, None until one has run
                "fleet": self.rollup.snapshot(),
                # closed-loop rebalance moves ring (Fleet view panel
                # beside the SLO budgets table)
                "rebalance": self.rebalancer.snapshot(limit=20)}

    def ui_page(self) -> str:
        """The controller web application (GET /ui): the reference's
        React cluster manager (pinot-controller/src/main/resources/app)
        as one server-bootstrapped single-page app — cluster/tables/
        tasks/query-console views hydrated from the inlined snapshot,
        live-refreshing from /ui/data (cluster/webapp.py)."""
        from .webapp import render_app
        return render_app(self.ui_data())

    def routing_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            # cache the expensive deep copy per version: brokers poll this
            # endpoint continuously and the state only changes on _bump()
            cached = self._routing_cache
            if cached is not None and cached["version"] == \
                    self._state["version"]:
                snap = dict(cached)
            else:
                assignment = json.loads(json.dumps(
                    self._state["assignment"]))
                segments = json.loads(json.dumps(self._state["segments"]))
                for table in list(assignment):
                    hidden = self._excluded_segments(table)
                    if hidden:
                        assignment[table] = {
                            s: h for s, h in assignment[table].items()
                            if s not in hidden}
                        segments[table] = {
                            s: e for s, e in segments.get(table,
                                                          {}).items()
                            if s not in hidden}
                snap = {
                    "version": self._state["version"],
                    "tables": {
                        t: {"schema": m["schema"], "config": m["config"]}
                        for t, m in self._state["tables"].items()},
                    "assignment": assignment,
                    "segments": segments,
                }
                self._routing_cache = snap
                snap = dict(snap)
            # liveness is heartbeat-driven, not version-driven: always
            # fresh — residency (the HBM-tier placement signal) rides
            # the same path because it changes with every query, not
            # with the assignment version
            snap["instances"] = {
                i["id"]: {"host": i["host"], "port": i["port"],
                          "role": i.get("role"),
                          **({"residency": i["residency"]}
                             if i.get("residency") else {})}
                for i in self._instances.values()}
            snap["liveServers"] = self.live_servers()
            snap["liveBrokers"] = self.live_brokers()
            return snap

    def server_assignment(self, instance_id: str) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Dict[str, str]] = {}
            for table, segs in self._state["assignment"].items():
                # servers DO load IN_PROGRESS lineage "to" segments (they
                # must be resident before the atomic flip makes them
                # routable); replaced/reverted segments are already gone
                # from the assignment itself
                for seg, holders in segs.items():
                    if instance_id not in holders:
                        continue
                    entry = self._state["segments"][table].get(seg)
                    if entry is not None:
                        out.setdefault(table, {})[seg] = entry["location"]
            return {"version": self._state["version"], "tables": out,
                    "schemas": {t: m["schema"] for t, m in
                                self._state["tables"].items()}}

    # -- REST --------------------------------------------------------------
    def _make_handler(self):
        ctrl = self

        def guard(fn):
            """HA mode: writes only land on the lease holder — a
            standby answers 503 so clients retry/repoint instead of
            split-braining the property store."""
            def wrapped(h, b):
                if ctrl.lease_ttl is not None and not ctrl.is_leader:
                    return 503, {"error": "not leader",
                                 "leader": (ctrl._read_lease() or {})
                                 .get("holder")}
                return fn(h, b)
            return wrapped

        def _debug_index(c):
            from .forensics import debug_index
            return debug_index(
                getattr(c, "instance_id", "controller"), "controller",
                surfaces=("/debug/fleet", "/debug/incidents",
                          "/debug/rebalance"))

        def _incidents():
            from ..utils.slo import global_incidents
            return global_incidents.snapshot()

        def _autopsy(h):
            # on-demand fleet autopsy: the controller keeps
            # no verdict ring of its own — it plans over the rollup's
            # fleet ledger, where the brokers' rca_verdict records and
            # all cross-plane evidence already land. ?qid= runs the
            # per-query whydown lane instead.
            from urllib.parse import parse_qs, urlparse
            from .autopsy import load_corpus, plan_autopsy, whydown
            params = parse_qs(urlparse(h.path).query)
            corpus = load_corpus(ctrl.rollup.ledger_path)
            qid = (params.get("qid") or [None])[0]
            if qid:
                return whydown(corpus, qid=qid)
            return plan_autopsy(corpus)

        class Handler(JsonHandler):
            routes = {
                ("GET", "/ui"): lambda h, b: (
                    200, ("text/html", ctrl.ui_page())),
                ("GET", "/ui/data"): lambda h, b: (200, ctrl.ui_data()),
                ("GET", "/health"): lambda h, b: (200, {"status": "OK"}),
                ("POST", "/instances"): lambda h, b: (
                    ctrl.register_instance(b) or (200, {"status": "OK"})),
                # heartbeat responses carry the assignment-version
                # epoch: a broker/server whose routing is
                # behind re-syncs immediately instead of waiting out
                # its poll — rebalance cutovers converge in one
                # heartbeat interval without restarts
                ("POST", "/heartbeat/"): lambda h, b: (
                    (200, {"status": "OK",
                           "version": ctrl.assignment_version()})
                    if ctrl.heartbeat(h.path.rsplit("/", 1)[1],
                                      (b or {}).get("residency"))
                    else (404, {"error": "unknown instance"})),
                ("POST", "/tables"): lambda h, b: (
                    ctrl.add_table(b["name"], b["schema"],
                                   b.get("config"),
                                   b.get("replication", 1))
                    or (200, {"status": "OK"})),
                ("DELETE", "/tables/"): lambda h, b: (
                    ctrl.drop_table(h.path.rsplit("/", 1)[1])
                    or (200, {"status": "OK"})),
                ("POST", "/tableconfig/"): lambda h, b: (
                    ctrl.update_table_config(
                        h.path.rsplit("/", 1)[1], b)
                    or (200, {"status": "OK"})),
                ("POST", "/segments"): lambda h, b: (
                    ctrl.add_segment(b["table"], b["segment"],
                                     b["location"], b.get("metadata"))
                    or (200, {"status": "OK"})),
                ("GET", "/routing"): lambda h, b: (
                    200, ctrl.routing_snapshot()),
                ("GET", "/assignments/"): lambda h, b: (
                    200, ctrl.server_assignment(h.path.rsplit("/", 1)[1])),
                ("POST", "/rebalance/"): lambda h, b: (
                    200, ctrl.rebalance(
                        h.path.rsplit("/", 1)[1],
                        dry_run=bool((b or {}).get("dryRun")),
                        replication=(b or {}).get("replication"))),
                ("POST", "/lineage/start"): lambda h, b: (
                    200, {"entryId": ctrl.start_replace_segments(
                        b["table"], b["from"], b["to"])}),
                ("POST", "/lineage/end"): lambda h, b: (
                    ctrl.end_replace_segments(b["table"], b["entryId"])
                    or (200, {"status": "OK"})),
                ("POST", "/lineage/revert"): lambda h, b: (
                    ctrl.revert_replace_segments(b["table"], b["entryId"])
                    or (200, {"status": "OK"})),
                ("POST", "/periodictask/run/"): lambda h, b: (
                    (200, {"status": "OK"})
                    if ctrl.scheduler.trigger(h.path.rsplit("/", 1)[1])
                    else (404, {"error": "unknown task"})),
                ("GET", "/periodictask/status"): lambda h, b: (
                    200, {"tasks": ctrl.scheduler.status()}),
                # fleet forensics rollup plane
                ("GET", "/debug/fleet"): lambda h, b: (
                    200, ctrl.rollup.snapshot()),
                # debug-surface index + incident ring: the
                # controller serves the fleet view, not node ledgers —
                # its index says so instead of advertising 404s
                ("GET", "/debug"): lambda h, b: (
                    200, _debug_index(ctrl)),
                ("GET", "/debug/incidents"): lambda h, b: (
                    200, _incidents()),
                # incident autopsy plane: fleet-wide root-cause
                # verdict on demand (cluster/autopsy.py)
                ("GET", "/debug/autopsy"): lambda h, b: (
                    200, _autopsy(h)),
                # closed-loop rebalance audit ring
                ("GET", "/debug/rebalance"): lambda h, b: (
                    200, ctrl.rebalancer.snapshot()),
                ("POST", "/segmentConsumed"): lambda h, b: (
                    200, ctrl.completion.segment_consumed(
                        b["table"], b["segment"], b["server"],
                        int(b["offset"]))),
                ("POST", "/segmentCommitStart"): lambda h, b: (
                    200, ctrl.completion.segment_commit_start(
                        b["table"], b["segment"], b["server"])),
                ("POST", "/segmentCommitEnd"): lambda h, b: (
                    200, ctrl.completion.segment_commit_end(
                        b["table"], b["segment"], b["server"],
                        b["downloadURI"],
                        register=lambda: ctrl.add_segment(
                            b["table"], b["segment"], b["downloadURI"],
                            b.get("metadata")))),
                ("GET", "/status"): lambda h, b: (
                    ctrl.run_status_check() or (200, ctrl._status)),
                # admin REST reads (controller/api/resources analog)
                ("GET", "/tables"): lambda h, b: (
                    200, ctrl.admin_tables()),
                ("GET", "/tables/"): lambda h, b: (
                    (lambda t: (200, t) if t is not None else
                     (404, {"error": "unknown table"}))(
                        ctrl.admin_table(h.path.rsplit("/", 1)[1]))),
                ("GET", "/segments/"): lambda h, b: (
                    (lambda t: (200, t) if t is not None else
                     (404, {"error": "unknown table"}))(
                        ctrl.admin_segments(h.path.rsplit("/", 1)[1]))),
                ("GET", "/instances"): lambda h, b: (
                    200, ctrl.admin_instances()),
                ("GET", "/leadership"): lambda h, b: (
                    200, ctrl.admin_leadership()),
                # readiness for HA deployments: 200 only on the lease
                # holder, so a k8s Service readiness probe routes
                # clients to the leader (deploy/k8s.yaml)
                ("GET", "/health/leader"): lambda h, b: (
                    (200, {"status": "LEADER"})
                    if ctrl.lease_ttl is None or ctrl.is_leader
                    else (503, {"status": "STANDBY"})),
                ("DELETE", "/segments/"): lambda h, b: (
                    ctrl._delete_segment_route(h.path)),
            }

        Handler.routes = {k: (v if k[0] == "GET" else guard(v))
                          for k, v in Handler.routes.items()}
        return Handler

    def stop(self, release_lease: bool = True) -> None:
        """release_lease=False simulates a crash: the lease expires
        naturally and the standby takes over after ~lease_ttl (tests);
        the default deletes the lease for an immediate handoff."""
        self._stop.set()
        self.scheduler.stop()
        if self.lease_ttl is not None and release_lease and self.is_leader:
            cur = self._read_lease()
            if cur and cur.get("holder") == self.instance_id:
                try:
                    os.unlink(self._lease_path())
                except OSError:
                    pass
        # shutdown path: lease thread already stopped, atomic bool store
        self.is_leader = False
        self._httpd.shutdown()
        self._httpd.server_close()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"
