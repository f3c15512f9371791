"""SLO plane: per-table/tenant error budgets, multi-window burn-rate
alerting and the incident flight recorder.

Port of ``pinot_tpu/utils/slo.py`` (the broker node's forensics plane
calls ``global_slo.observe_query`` on every query). The incident bundle
carries no ``compile`` block: the compile plane is JAX-only. The
judgment layer over the measuring planes:

- ``Objective`` declares one SLO per scope (a table name or
  ``tenant:<name>``) and kind:
  * ``latency`` — fraction of queries under ``bar_ms`` must be >=
    ``objective`` (p99 <= bar spelled as objective=0.99). Shed rows are
    EXCLUDED (the rollup rule): a shed is rejected at
    admission in sub-ms and would mask the regression it reports.
  * ``availability`` — non-error, non-shed, non-partial fraction >=
    ``objective`` (sheds COUNT as bad here — they are denied answers).
  * ``freshness`` — fraction of ingest-freshness samples under
    ``bar_ms`` must be >= ``objective``; a DEAD gauge (no write for
    ``stale_s``, utils/metrics gauge timestamps) is a bad sample — a
    frozen freshness gauge must trip the SLO, not silently pass it.
- error budgets burn over Google-SRE-style paired windows: burn rate =
  (bad fraction / error budget) per window; the alert arms only when
  BOTH the fast and the slow window exceed the threshold (fast = quick
  detection, slow = flap suppression), latched with hysteresis through
  the generic ``utils/alerts`` plane — the same latch implementation
  the compile-storm detector uses.
- every decision is **deterministic and replayable** : windows are computed from RECORD timestamps
  (``arrival_ms + wall_ms``), never the wall clock, so the same
  ``query_stats`` stream yields the same alert stream byte-for-byte —
  ``plan_alert_stream`` is the pure replay evaluator
  tools/traffic_replay.py compares its live run against.
- on alert fire the ``IncidentRecorder`` snapshots a bounded bundle of
  the node's debug surfaces (slow-query ring tail, governor rung + shed
  counters, tier occupancy, devmem pools, active SLO
  burn table) into a validated ``incident`` ledger record on a
  BACKGROUND thread (the capture must never sit on the query path),
  served at ``GET /debug/incidents`` and rendered in the webapp.

Zero-cost contract: unarmed (no objectives declared — the default),
``observe_query`` is one attribute read and a return; armed, the hot
path pays one deque append + pure window math over a bounded deque.
Status/alert ledger records are written only on fire/clear transitions
and explicit snapshots, never per query.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .alerts import AlertManager, PROC_TOKEN, global_alerts
from .metrics import global_metrics

KINDS = ("latency", "availability", "freshness")
DEFAULT_OBJECTIVE = 0.99
DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 300.0
DEFAULT_BURN_THRESHOLD = 4.0
DEFAULT_HYSTERESIS = 1.0      # re-arm as soon as burn < threshold
DEFAULT_FRESHNESS_STALE_S = 120.0
EVENT_CAP = 4096              # per-objective in-memory event bound
INCIDENT_RING_CAPACITY = 32
SLOWQ_TAIL = 8


@dataclass(frozen=True)
class Objective:
    """One declared SLO (module docstring). ``objective`` is the
    good-event fraction target; the error budget is ``1 - objective``;
    burn rate over a window is bad_fraction / budget."""

    scope: str
    kind: str
    objective: float = DEFAULT_OBJECTIVE
    bar_ms: Optional[float] = None
    fast_s: float = DEFAULT_FAST_WINDOW_S
    slow_s: float = DEFAULT_SLOW_WINDOW_S
    burn_threshold: float = DEFAULT_BURN_THRESHOLD
    hysteresis: float = DEFAULT_HYSTERESIS
    severity: str = "page"
    stale_s: float = DEFAULT_FRESHNESS_STALE_S

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r} "
                             f"(have {KINDS})")
        if self.kind in ("latency", "freshness") and self.bar_ms is None:
            raise ValueError(f"{self.kind} objective for "
                             f"{self.scope!r} requires bar_ms")
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be a fraction in (0, 1)")

    @property
    def key(self) -> str:
        return f"{self.scope}:{self.kind}"


# ---------------------------------------------------------------------------
# pure window math (the oracle-testable core)
# ---------------------------------------------------------------------------

def burn_rate(events: Tuple, now: float, window_s: float,
              budget: float) -> Tuple[float, int, int]:
    """Burn rate over ``[now - window_s, now]``: -> (burn, total, bad).

    ``events`` is an ordered iterable of ``(t, good)``; burn =
    (bad/total)/budget, 0.0 on an empty window — an idle service burns
    nothing. Pure function of its arguments (the determinism
    contract)."""
    total = bad = 0
    for t, good in events:
        if 0.0 <= now - t <= window_s:
            total += 1
            if not good:
                bad += 1
    if total == 0 or budget <= 0.0:
        return 0.0, total, bad
    return (bad / total) / budget, total, bad


def evaluate_objective(events: Tuple, now: float,
                       obj: Objective) -> Dict[str, Any]:
    """One objective's status row at ``now`` (pure): paired fast/slow
    burn rates + slow-window budget remaining (= 1 - burn_slow clamped
    to [0, 1] — exhausted when the budget has burned at 1x for the
    whole window). The row's fields are the ``slo_status`` ledger
    contract minus the envelope/proc."""
    budget = max(1.0 - obj.objective, 1e-9)
    bf, _nf, _xf = burn_rate(events, now, obj.fast_s, budget)
    bs, ns, xs = burn_rate(events, now, obj.slow_s, budget)
    row: Dict[str, Any] = {
        "scope": obj.scope, "kind": obj.kind,
        "objective": obj.objective,
        "burn_fast": round(bf, 4), "burn_slow": round(bs, 4),
        "budget_remaining": round(min(max(1.0 - bs, 0.0), 1.0), 4),
        "window_s": obj.slow_s, "fast_window_s": obj.fast_s,
        "threshold": obj.burn_threshold,
        "events": ns, "bad": xs,
    }
    if obj.bar_ms is not None:
        row["bar_ms"] = obj.bar_ms
    return row


def classify_query(rec: Dict[str, Any],
                   bar_ms: Optional[float]) -> Dict[str, Any]:
    """Per-kind (counted, good) classification of one ``query_stats``
    record (pure; exported for the oracle tests). Latency skips shed
    rows; availability counts every query and a
    shed/error/partial is bad."""
    shed = bool(rec.get("shed"))
    return {
        "latency": (not shed,
                    bar_ms is None
                    or float(rec.get("wall_ms", 0.0)) <= bar_ms),
        "availability": (True,
                         not (shed or rec.get("error")
                              or rec.get("partial"))),
    }


def event_time(rec: Dict[str, Any]) -> Optional[float]:
    """A ``query_stats`` record's completion time in seconds on the
    broker's forensics-epoch clock (``arrival_ms + wall_ms``) — the
    injectable-clock source every window decision derives from. None
    when the record carries no arrival offset (caller falls back to
    its own clock)."""
    a = rec.get("arrival_ms")
    if a is None:
        return None
    return (float(a) + float(rec.get("wall_ms", 0.0))) / 1e3


# ---------------------------------------------------------------------------
# the tracking plane
# ---------------------------------------------------------------------------

class SloPlane:
    """Objectives + sliding event windows + burn-rate alerting (module
    docstring). ``telemetry=False`` builds a silent evaluator (no
    global gauges/counters) — the pure replay planner's mode."""

    def __init__(self, alerts: Optional[AlertManager] = None,
                 proc_token: Optional[str] = None,
                 telemetry: bool = True):
        self._lock = threading.Lock()
        self._objectives: Dict[str, Objective] = {}
        self._events: Dict[str, deque] = {}
        self._stale: Dict[str, bool] = {}
        self.alerts = alerts if alerts is not None \
            else AlertManager(proc_token)
        self.proc = proc_token or self.alerts.proc
        self.telemetry = telemetry   # guarded-by: none — config-time
        self.path: Optional[str] = None  # guarded-by: none — config
        # the incident flight recorder hooked on fire (config-time;
        # None = no capture)
        self.recorder: Optional["IncidentRecorder"] = None  # guarded-by: none
        # injectable ledger-ts formatter (event-time seconds -> ts
        # string) so a pure replay plan is byte-stable; None = wall ts
        self.ts_fn: Optional[Callable[[float], str]] = None  # guarded-by: none
        # the unarmed hot-path gate: ONE attribute read per query when
        # no objectives are declared (<1% overhead contract)
        self.armed = False  # guarded-by: none — config-time flip

    # -- configuration -----------------------------------------------------
    def set_objective(self, scope: str, kind: str,
                      **params: Any) -> Objective:
        """Declare/replace one objective; arms the plane. ``params``
        are the Objective fields (objective, bar_ms, fast_s, slow_s,
        burn_threshold, hysteresis, severity, stale_s)."""
        obj = Objective(scope=scope, kind=kind, **params)
        rule = self.alerts.level_rule(f"slo:{obj.key}",
                                      obj.burn_threshold,
                                      severity=obj.severity,
                                      hysteresis=obj.hysteresis)
        # re-declaration updates the existing rule's bars (config-time)
        rule.threshold = obj.burn_threshold
        rule.hysteresis = min(max(obj.hysteresis, 0.0), 1.0)
        with self._lock:
            self._objectives[obj.key] = obj
            self._events.setdefault(obj.key, deque(maxlen=EVENT_CAP))
        self.armed = True
        return obj

    def objectives(self) -> List[Objective]:
        with self._lock:
            return [self._objectives[k]
                    for k in sorted(self._objectives)]

    def clear(self) -> None:
        """Back to the inert default (tests + gate phase boundaries)."""
        self.armed = False
        with self._lock:
            self._objectives.clear()
            self._events.clear()
            self._stale.clear()
        self.alerts.reset()

    # -- observation (the hot path) ----------------------------------------
    def observe_query(self, rec: Dict[str, Any],
                      now: Optional[float] = None
                      ) -> List[Dict[str, Any]]:
        """Feed one completed query's ``query_stats`` record; returns
        the alert records fired by this observation (usually empty).
        Unarmed: one attribute read, nothing else."""
        if not self.armed:
            return []
        t = now if now is not None else event_time(rec)
        if t is None:
            t = time.monotonic()
        scopes = []
        if rec.get("table"):
            scopes.append(str(rec["table"]))
        if rec.get("tenant"):
            scopes.append(f"tenant:{rec['tenant']}")
        fired: List[Dict[str, Any]] = []
        for scope in scopes:
            for kind in ("latency", "availability"):
                obj = self._objectives.get(f"{scope}:{kind}")
                if obj is None:
                    continue
                counted, good = classify_query(rec, obj.bar_ms)[kind]
                if not counted:
                    continue
                rec_f = self._ingest(obj, t, good)
                if rec_f is not None:
                    fired.append(rec_f)
        return fired

    def observe_freshness(self, table: Optional[str] = None,
                          freshness_ms: Optional[float] = None,
                          age_s: Optional[float] = None,
                          now: Optional[float] = None
                          ) -> List[Dict[str, Any]]:
        """Sample the freshness objectives. Explicit
        ``freshness_ms``/``age_s`` is the pure/test path; with neither,
        each objective reads its table's ``ingest_freshness_ms_<t>``
        gauge + age from global_metrics (the live broker path). A
        missing or stale gauge is a BAD sample — dead writers trip the
        SLO instead of passing it."""
        if not self.armed:
            return []
        with self._lock:
            targets = [o for o in self._objectives.values()
                       if o.kind == "freshness"
                       and (table is None or o.scope == table)]
        fired: List[Dict[str, Any]] = []
        for obj in targets:
            if freshness_ms is None and age_s is None:
                name = f"ingest_freshness_ms_{obj.scope}"
                snap_g = global_metrics.snapshot()["gauges"]
                v = snap_g.get(name)
                a = global_metrics.gauge_age_s(name)
            else:
                v, a = freshness_ms, age_s
            stale = v is None or (a is not None and a > obj.stale_s)
            good = (not stale) and float(v) <= float(obj.bar_ms)
            t = now if now is not None else time.monotonic()
            with self._lock:
                self._stale[obj.key] = stale
            rec_f = self._ingest(obj, t, good)
            if rec_f is not None:
                fired.append(rec_f)
        return fired

    def _ingest(self, obj: Objective, t: float,
                good: bool) -> Optional[Dict[str, Any]]:
        with self._lock:
            dq = self._events.get(obj.key)
            if dq is None:
                return None  # objective cleared concurrently
            dq.append((t, good))
            events = tuple(dq)
        return self._evaluate(obj, events, t)

    # -- evaluation + alerting ---------------------------------------------
    def _evaluate(self, obj: Objective, events: Tuple,
                  now: float) -> Optional[Dict[str, Any]]:
        st = evaluate_objective(events, now, obj)
        # the Google-SRE pairing: BOTH windows must burn over threshold
        level = min(st["burn_fast"], st["burn_slow"])
        if self.telemetry:
            # scope-keyed gauge names are sanitized by _prom_name at
            # Prometheus exposition ()
            global_metrics.gauge(f"slo_burn_{obj.key}", level)
            global_metrics.gauge(
                f"slo_budget_{obj.key}", st["budget_remaining"])
        rule = self.alerts.rule(f"slo:{obj.key}")
        transition = rule.check(level) if rule is not None else None
        if transition == "fire":
            ts = self.ts_fn(now) if self.ts_fn is not None else None
            rec = self.alerts.fire(
                "slo_burn", obj.severity, round(level, 4),
                obj.burn_threshold, obj.slow_s,
                path=self.path, proc=self.proc, ts=ts,
                counter="slo_alerts" if self.telemetry else None,
                detail=(f"{obj.kind} burn {level:.2f}x >= "
                        f"{obj.burn_threshold}x budget for {obj.scope} "
                        f"(fast {st['burn_fast']}x / "
                        f"slow {st['burn_slow']}x)"),
                extra={"scope": obj.scope, "kind": obj.kind,
                       "objective": obj.objective,
                       "bar_ms": obj.bar_ms,
                       "fast_window_s": obj.fast_s,
                       "burn_fast": st["burn_fast"],
                       "burn_slow": st["burn_slow"],
                       "budget_remaining": st["budget_remaining"]},
                on_fire=(lambda rec, _st=st:
                         self.recorder.request(rec, slo=_st))
                if self.recorder is not None else None)
            self._emit_status(st, obj, alerting=True, now=now)
            return rec
        if transition == "clear":
            if self.telemetry:
                global_metrics.count("slo_alerts_cleared")
            self._emit_status(st, obj, alerting=False, now=now)
        return None

    def _emit_status(self, st: Dict[str, Any], obj: Objective,
                     alerting: bool, now: float) -> None:
        """ONE validated ``slo_status`` record on a fire/clear
        transition (never per query); append failures are counted,
        never raised."""
        path = self.path
        if not path:
            return
        from . import ledger as uledger
        fields = dict(st)
        # the envelope key ``kind`` is the record kind (slo_status) —
        # the objective kind ships as ``slo_kind``
        fields["slo_kind"] = fields.pop("kind")
        fields["proc"] = self.proc
        fields["alerting"] = alerting
        fields["severity"] = obj.severity
        with self._lock:
            if self._stale.get(obj.key):
                fields["stale"] = True
        if self.ts_fn is not None:
            fields["ts"] = self.ts_fn(now)
        try:
            uledger.append_record(
                uledger.make_record("slo_status", **fields), path)
        except OSError:
            global_metrics.count("slo_status_write_errors")

    # -- serving -----------------------------------------------------------
    def status_block(self, now: Optional[float] = None
                     ) -> Dict[str, Any]:
        """The live burn table (/metrics ``slo`` block, incident
        bundles, /debug/ledger shipping). ``now`` defaults to each
        objective's newest event time — pure event-time, so a replayed
        stream renders the same table."""
        if not self.armed:
            return {"armed": False, "objectives": []}
        with self._lock:
            objs = dict(self._objectives)
            events = {k: tuple(dq) for k, dq in self._events.items()}
            stale = dict(self._stale)
        rows = []
        for key in sorted(objs):
            obj = objs[key]
            evs = events.get(key, ())
            n = now if now is not None else (evs[-1][0] if evs else 0.0)
            row = evaluate_objective(evs, n, obj)
            rule = self.alerts.rule(f"slo:{key}")
            row["alerting"] = bool(rule.latched) if rule else False
            if stale.get(key):
                row["stale"] = True
            rows.append(row)
        return {"armed": True, "objectives": rows,
                "alerts_fired": self.alerts.alerts_fired,
                "ledger": self.path}

    def emit_status(self, path: Optional[str] = None,
                    now: Optional[float] = None) -> int:
        """Append every objective's current ``slo_status`` row to
        ``path`` (default: the plane's ledger) — the explicit snapshot
        tools/slo_report.py and the replay gate consume. Returns the
        record count written."""
        from . import ledger as uledger
        path = path or self.path
        block = self.status_block(now)
        written = 0
        for row in block["objectives"]:
            fields = dict(row)
            fields["slo_kind"] = fields.pop("kind")
            fields["proc"] = self.proc
            if self.ts_fn is not None and now is not None:
                fields["ts"] = self.ts_fn(now)
            if not path:
                continue
            try:
                uledger.append_record(
                    uledger.make_record("slo_status", **fields), path)
                written += 1
            except OSError:
                global_metrics.count("slo_status_write_errors")
        return written


# ---------------------------------------------------------------------------
# pure replay planning (the determinism gate's comparison object)
# ---------------------------------------------------------------------------

def plan_alert_stream(records: List[Dict[str, Any]],
                      objectives: List[Dict[str, Any]],
                      proc: str = "plan") -> Dict[str, Any]:
    """Replay an ordered ``query_stats``-shaped record stream through a
    silent SloPlane: -> ``{"alerts": [...], "status": [...]}``. Pure —
    the same records and objectives yield byte-identical output
    (``json.dumps`` equal), which is exactly what traffic_replay's SLO
    gate asserts across two same-seed plans. ``proc`` and the
    event-time ts formatter are pinned so no process identity or wall
    clock leaks into the plan."""
    plane = SloPlane(proc_token=proc, telemetry=False)
    plane.ts_fn = lambda t: f"t+{t:.3f}s"
    for spec in objectives:
        plane.set_objective(**spec)
    fired: List[Dict[str, Any]] = []
    for rec in records:
        fired.extend(plane.observe_query(rec))
    return {"alerts": fired,
            "status": plane.status_block()["objectives"]}


def normalize_alerts(alerts: List[Dict[str, Any]]
                     ) -> List[Tuple[str, str, str, str]]:
    """The ordered comparison stream for live-vs-plan matching:
    (alert, scope, kind, severity) — process identity, wall-clock ts
    and jitter-sensitive burn magnitudes are normalized out, exactly
    the shed-stream discipline."""
    out = []
    for a in alerts:
        x = a.get("extra") or {}
        out.append((str(a.get("alert")), str(x.get("scope")),
                    str(x.get("kind")), str(a.get("severity"))))
    return out


# ---------------------------------------------------------------------------
# incident flight recorder
# ---------------------------------------------------------------------------

class IncidentRecorder:
    """On-alert debug-surface capture (module docstring): bounded
    bundles, captured on a background daemon thread so the firing
    (query) path never pays the snapshot cost; ``sync=True`` captures
    inline for deterministic tests/gates. Every surface is
    independently fenced — a broken provider records its error string,
    never loses the bundle."""

    def __init__(self, proc_token: Optional[str] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=INCIDENT_RING_CAPACITY)
        self._pending: deque = deque()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._busy = False
        self._surfaces: Dict[str, Callable[[], Any]] = {}
        self.proc = proc_token or PROC_TOKEN
        self.path: Optional[str] = None  # guarded-by: none — config
        # post-snapshot hook (config-time wiring): called with the
        # captured incident record AFTER the bundle lands — the
        # autopsy plane attaches here (cluster/autopsy.py, which
        # utils/ cannot import). Runs on the capture thread, fenced:
        # a broken hook can never lose the bundle or take the
        # recorder down.
        self.post_hook: Optional[
            Callable[[Dict[str, Any]], Any]] = None  # guarded-by: none
        self._seq = 0
        self.captured = 0

    def register_surface(self, name: str,
                         fn: Callable[[], Any]) -> None:
        """Attach a node-local provider (the broker registers its
        slow-query ring tail here — cluster state utils/ cannot import)."""
        with self._lock:
            self._surfaces[name] = fn

    # -- capture -----------------------------------------------------------
    def request(self, alert_rec: Dict[str, Any],
                slo: Optional[Dict[str, Any]] = None,
                sync: bool = False) -> Optional[Dict[str, Any]]:
        """Queue one capture for the background thread (returns None);
        ``sync=True`` captures inline and returns the record."""
        if sync:
            return self._capture(alert_rec, slo)
        with self._lock:
            self._pending.append((alert_rec, slo))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="incident-recorder")
                self._thread.start()
        self._wake.set()
        return None

    def _loop(self) -> None:
        while True:
            self._wake.wait(timeout=1.0)
            self._wake.clear()
            while True:
                with self._lock:
                    if not self._pending:
                        self._busy = False
                        break
                    alert_rec, slo = self._pending.popleft()
                    self._busy = True
                try:
                    self._capture(alert_rec, slo)
                except Exception:
                    # the recorder must never take the process down
                    global_metrics.count("incident_capture_errors")

    def drain(self, timeout: float = 5.0) -> bool:
        """Wait for the pending queue to empty (gates/tests)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending and not self._busy:
                    return True
            time.sleep(0.01)
        return False

    def _capture(self, alert_rec: Dict[str, Any],
                 slo: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        from . import ledger as uledger
        surfaces: Dict[str, Any] = {}
        for name, fn in self._providers():
            try:
                surfaces[name] = fn()
            except Exception as e:
                surfaces[name] = {"error": str(e)[:120]}
        with self._lock:
            self._seq += 1
            seq = self._seq
        fields: Dict[str, Any] = {
            "incident_id": f"{self.proc}-{seq}",
            "alert": str(alert_rec.get("alert")),
            "severity": str(alert_rec.get("severity")),
            "proc": self.proc, "seq": seq,
            "surfaces": surfaces,
        }
        detail = alert_rec.get("detail")
        if detail:
            fields["detail"] = detail
        scope = (alert_rec.get("extra") or {}).get("scope")
        if scope:
            fields["scope"] = scope
        if slo is not None:
            fields["slo"] = slo
        rec = uledger.make_record("incident", **fields)
        path = self.path
        if path:
            try:
                uledger.append_record(rec, path)
            except OSError:
                global_metrics.count("incident_write_errors")
        with self._lock:
            self._ring.append(rec)
            self.captured += 1
        global_metrics.count("incidents_captured")
        hook = self.post_hook
        if hook is not None:
            try:
                hook(rec)
            except Exception:
                global_metrics.count("incident_post_hook_errors")
        return rec

    def attach_verdict(self, incident_id: str,
                       ref: Dict[str, Any]) -> bool:
        """Stamp an autopsy verdict ref onto the named incident's ring
        entry (``rca``: proc/seq/top_cause/inconclusive), so
        GET /debug/incidents answers "what burned AND why" without a
        second lookup. Returns False when the incident already rolled
        off the ring."""
        with self._lock:
            for entry in self._ring:
                if entry.get("incident_id") == incident_id:
                    entry["rca"] = ref
                    return True
        return False

    def _providers(self) -> List[Tuple[str, Callable[[], Any]]]:
        """The bounded default surfaces + registered extras. Defaults
        resolve lazily (process-global registries) so the recorder
        stays importable from utils/ without dragging the engine in."""
        def _overload():
            from ..broker.workload import global_workload
            from .metrics import overload_health
            snap = global_metrics.snapshot()
            out = overload_health(snap)
            out["governor"] = global_workload.governor.snapshot()
            return out

        def _tier():
            from ..engine.tier import global_tier
            return global_tier.snapshot()

        def _devmem():
            from .devmem import global_device_memory
            return global_device_memory.snapshot()

        def _slo():
            return global_slo.status_block()

        with self._lock:
            extra = list(self._surfaces.items())
        defaults = [("overload", _overload), ("tier", _tier),
                    ("devmem", _devmem),
                    ("slo", _slo)]
        have = {n for n, _ in extra}
        return extra + [(n, f) for n, f in defaults if n not in have]

    # -- serving (GET /debug/incidents) ------------------------------------
    def snapshot(self, limit: Optional[int] = None) -> Dict[str, Any]:
        with self._lock:
            incidents = list(self._ring)[::-1]
        count = len(incidents)   # ring size, not the limited slice
        if limit is not None:
            incidents = incidents[:max(limit, 0)]
        return {"count": count, "captured": self.captured,
                "ledger": self.path, "incidents": incidents}

    def reset(self, surfaces: bool = False) -> None:
        """Clear ring/queue (tests, gate boundaries); the seq counter
        survives — (proc, seq) is an incident's identity for fleet
        dedup, the CompileLog discipline. Registered surfaces are
        config-time wiring (a live broker's slow-query tail) and stay
        unless ``surfaces=True``."""
        with self._lock:
            self._ring.clear()
            self._pending.clear()
            if surfaces:
                self._surfaces.clear()
            self.captured = 0


global_slo = SloPlane(alerts=global_alerts)
global_incidents = IncidentRecorder()
global_slo.recorder = global_incidents
