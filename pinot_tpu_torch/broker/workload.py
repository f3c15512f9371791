"""Per-tenant workload isolation + watermark load shedding.

Port of ``pinot_tpu/broker/workload.py``, whole. The decisions are the
reference's: ``_unit`` hashes with ``hashlib``, so a (qid, tenant, rung)
gets the same shed decision and ``retryAfterMs`` in both packages, and a
pinned schedule the same shed stream. In the port the in-process broker
(``broker/broker.py``) is its one caller; the cluster broker, the
scheduler's queue-depth signal, the replay harness
(``tools/traffic_replay.py``) and the ``query_stats`` ledger rows come
with the cluster plane. ``arm_default_signals``' device signal is the
port's ``utils/devmem`` pool bytes: the card's tracked bytes.

Reference parity: Pinot layers exactly this defense-in-depth —
``HelixExternalViewBasedQueryQuotaManager`` (per-table QPS, broker/
quota.py here), ``PerQueryCPUMemAccountantFactory`` (watcher kills,
engine/accounting.py) and scheduler admission (engine/scheduler.py).
What none of them answer is *what happens at 4x capacity*: a sustained
spike needs tenant isolation (one tenant's burst must not starve the
others), a graceful degradation ladder (shed speculative work before
shedding queries, shed best-effort tenants before paying ones), and a
retry contract that cannot amplify the overload. This module is that
plane, shared by both of the reference's brokers (broker/broker.py
in-process, cluster/broker_node.py HTTP).

Three pieces:

**WorkloadManager** — tenant registry + budgets. A table's tenant comes
from its TableConfig ``tenant`` field (``DEFAULT_TENANT`` when
unconfigured); each tenant carries a priority tier (``protected`` /
``standard`` / ``besteffort``) and optional budgets: max concurrent
in-flight queries, CPU-ms/s and result-bytes/s token buckets (post-paid:
the accountant's existing ``track_result`` fence feeds actual usage back
through ``observe()`` at unregister time, so a tenant that overdraws its
bucket is shed until the debt refills — usage-shaped isolation without
per-launch metering), and a retries/s budget so client retries during
overload cannot amplify it. Shed queries raise ``OverloadShedError`` —
a 429-shaped ``SqlError`` carrying ``retryAfterMs`` — never a 500.

**OverloadGovernor** — the watermark degradation ladder, driven by
signals the repo already exports (registered as (name, fn, capacity)
pairs — broker in-flight count, scheduler queue depth, accountant RSS
pressure, utils/devmem pool bytes). ``pressure`` = max normalized
signal; watermarks map it to a rung with hysteresis:

==== ======================================================
rung effect
==== ======================================================
0    normal service
1    shed speculative work: hedged re-dispatch off,
     traceRatio sampling off, micro-batch admission window
     widened (fewer, fuller fused launches)
2    shed ``besteffort`` tenants outright and ``standard``
     tenants by a deterministic per-(qid, tenant) draw,
     with a structured 429 + ``retryAfterMs``
3    brownout: ``besteffort``/``standard`` shed entirely;
     every admitted query is clamped to a floor deadline
     and forced to ``allowPartialResults`` semantics
==== ======================================================

**Determinism** (the round-16 stream-keying discipline): given a rung,
the shed decision and ``retryAfterMs`` for a (qid, tenant) are pure
hash draws — same qids shed identically across same-seed runs. The
traffic-replay harness (tools/traffic_replay.py) pins the rung per
replayed qid from the offered-load schedule (``pin_rungs``), so its
whole shed stream is a pure function of (ledger, multiple, seed) and
two same-seed replays produce byte-identical shed streams; live
deployments drive the same ladder from live signals instead.

Every shed/degrade decision is counted in ``global_metrics``
(``overload_shed`` + per-rung/reason/tenant counters), annotated on the
active span, appended to the bounded ``shed_log`` (the chaos-gate
comparison stream), and — on the cluster broker — lands in the
``query_stats`` ledger row so the fleet rollup trends shed rates per
table/tenant.

Default state is inert: no tenants configured + no signals armed + no
pins => rung 0 and unlimited budgets, so the plane costs two dict reads
per query until an operator arms it.
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..query.sql import SqlError
from ..utils.metrics import global_metrics

DEFAULT_TENANT = "default"

TIER_PROTECTED = "protected"
TIER_STANDARD = "standard"
TIER_BESTEFFORT = "besteffort"
TIERS = (TIER_PROTECTED, TIER_STANDARD, TIER_BESTEFFORT)

# shed order: lower rank sheds (and OOM-kills) first
_TIER_SHED_RANK = {TIER_BESTEFFORT: 0, TIER_STANDARD: 1,
                   TIER_PROTECTED: 2}

# rung-2 partial shed of the standard tier (deterministic per qid draw);
# rung 3 sheds standard entirely — "besteffort then standard"
STANDARD_SHED_P = 0.5

# retryAfterMs = base * rung + deterministic per-(qid, tenant) jitter
RETRY_AFTER_BASE_MS = 100
RETRY_AFTER_SPREAD_MS = 150

# brownout (rung 3): every admitted query's deadline clamps to this
# floor unless the broker was configured tighter
BROWNOUT_DEADLINE_MS = 1_000.0

SHED_LOG_CAP = 8192

# rung >= 1: the micro-batcher's admission window widens by this factor
WINDOW_SCALE = 4.0

# Pinot-common QueryException analogs: 429 is the tenant-shed shape the
# webapp/console render with retryAfterMs; 211 is the scheduler's
# "server out of capacity" rejection (engine/scheduler.py reuses it)
ERR_TOO_MANY_REQUESTS = 429
ERR_SERVER_OUT_OF_CAPACITY = 211


def tier_shed_rank(tier: Optional[str]) -> int:
    """Shed/kill ordering rank (besteffort first, protected last);
    unknown/missing tiers rank with standard."""
    return _TIER_SHED_RANK.get(tier or TIER_STANDARD, 1)


def _unit(key: str) -> float:
    """Deterministic uniform [0, 1) — the utils/faults._unit discipline
    (md5 keeps parity with utils/spans.sample_decision)."""
    h = hashlib.md5(key.encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


def retry_after_ms(qid: str, tenant: str, rung: int) -> int:
    """Deterministic per-(qid, tenant) retry-after: a rung-scaled base
    plus a hash-spread jitter so a shed wave's retries don't stampede
    back in one synchronized burst — and so same-seed chaos replays see
    identical values."""
    base = RETRY_AFTER_BASE_MS * max(rung, 1)
    jitter = int(_unit(f"retry|{qid}|{tenant}") * RETRY_AFTER_SPREAD_MS)
    return base + jitter


def shed_decision(qid: str, tenant: str, tier: str,
                  rung: int) -> Optional[str]:
    """The PURE rung-shed ladder: -> shed reason or None (admit).

    Pure in (qid, tenant, tier, rung) — no clocks, no counters — which
    is what makes the replay gate's shed stream reproducible: the same
    pinned rung schedule sheds the same qids every run."""
    if rung < 2 or tier == TIER_PROTECTED:
        return None
    if tier == TIER_BESTEFFORT:
        return "tier_besteffort"
    # standard: partial at rung 2 (deterministic draw), full at rung 3+
    if rung >= 3:
        return "tier_standard"
    if _unit(f"shed|{qid}|{tenant}") < STANDARD_SHED_P:
        return "tier_standard"
    return None


class OverloadShedError(SqlError):
    """A load-shed query: the 429-shaped structured rejection. Both
    brokers render it as JSON carrying ``errorCode`` 429 and
    ``retryAfterMs`` — never a 500/stack trace (cluster/http_util.py
    renders any escaping exception with these attrs the same way)."""

    error_code = ERR_TOO_MANY_REQUESTS

    def __init__(self, msg: str, retry_after_ms: int, tenant: str,
                 rung: int, reason: str, tier: str = TIER_STANDARD):
        super().__init__(msg)
        self.retry_after_ms = int(retry_after_ms)
        self.tenant = tenant
        self.rung = int(rung)
        self.reason = reason
        self.tier = tier

    def payload(self) -> Dict[str, Any]:
        """The structured response body (HTTP 429)."""
        return {"error": str(self), "errorCode": self.error_code,
                "retryAfterMs": self.retry_after_ms,
                "tenant": self.tenant, "tier": self.tier,
                "rung": self.rung, "reason": self.reason}


def clamp_brownout(options: Dict[str, Any],
                   default_timeout_ms: int) -> None:
    """Rung-3 brownout effects on a statement's options, shared by both
    brokers so the ladder can never drift between them: clamp the query
    deadline to the floor and force partial-result semantics. Validates
    timeoutMs (a bad value is a 400-class SqlError, never a ValueError
    escaping mid-clamp)."""
    raw = options.get("timeoutMs", default_timeout_ms)
    try:
        cur = int(raw)
    except (TypeError, ValueError):
        raise SqlError(f"invalid timeoutMs value {raw!r}; "
                       "expected an integer of milliseconds") from None
    options["timeoutMs"] = min(cur, int(BROWNOUT_DEADLINE_MS))
    options.setdefault("allowPartialResults", "true")
    global_metrics.count("overload_brownout_clamped")


def leaf_table(stmt: Any) -> Optional[str]:
    """Left-most leaf table of a statement tree — the tenant anchor for
    compound set operations (shared by both brokers)."""
    while hasattr(stmt, "left") and not hasattr(stmt, "table"):
        stmt = stmt.left
    return getattr(stmt, "table", None)


def parse_retry_attempt(options: Dict[str, Any]) -> int:
    """Validate ``OPTION(retryAttempt=N)`` pre-dispatch (the client-side
    retry contract: a client resubmitting a shed query marks the
    attempt so the broker can charge the tenant's retry budget). A bad
    value is a 400-class SqlError, never a ValueError escaping as a
    500."""
    raw = (options or {}).get("retryAttempt")
    if raw is None:
        return 0
    try:
        v = int(raw)
    except (TypeError, ValueError):
        raise SqlError(f"invalid retryAttempt value {raw!r}; "
                       "expected a non-negative integer") from None
    if v < 0:
        raise SqlError(f"invalid retryAttempt value {raw!r}; "
                       "expected a non-negative integer")
    return v


@dataclass
class TenantSpec:
    """One tenant's tier + budgets (None = unlimited)."""
    tier: str = TIER_STANDARD
    max_inflight: Optional[int] = None
    cpu_ms_per_s: Optional[float] = None
    result_bytes_per_s: Optional[float] = None
    retries_per_s: Optional[float] = None


class _PostPaidBucket:
    """Post-paid token bucket: admission only requires a non-negative
    balance; actual usage debits afterwards (and may drive the balance
    negative — the debt then blocks new admissions until it refills).
    This matches how the accountant meters: usage is only known at the
    post-execute ``track_result`` fence, never up front. ``now`` is
    injectable so the replay/tests can drive virtual time."""

    def __init__(self, rate_per_s: float, burst_s: float = 1.0):
        self.rate = float(rate_per_s)
        self.balance = self.rate * burst_s
        self.cap = self.balance
        self._t0: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._t0 is None:
            self._t0 = now
        self.balance = min(self.cap,
                           self.balance + (now - self._t0) * self.rate)
        self._t0 = now

    def ok(self, now: Optional[float] = None) -> bool:
        self._refill(time.monotonic() if now is None else now)
        return self.balance > 0.0

    def debit(self, amount: float,
              now: Optional[float] = None) -> None:
        self._refill(time.monotonic() if now is None else now)
        self.balance -= max(float(amount), 0.0)

    def retry_after_ms(self) -> int:
        """Time until the debt refills past zero (the budget-shed
        retryAfterMs)."""
        if self.balance > 0 or self.rate <= 0:
            return RETRY_AFTER_BASE_MS
        return int(-self.balance / self.rate * 1e3) + RETRY_AFTER_BASE_MS


@dataclass
class AdmissionTicket:
    """One admitted query: carried from admit() to release()."""
    qid: str
    table: Optional[str]
    tenant: str
    tier: str
    rung: int
    brownout: bool = False
    degraded: bool = False
    # False on the inert fast path: nothing was counted at admit, so
    # release() must not touch inflight state or gauges either
    counted: bool = field(default=True, repr=False)
    released: bool = field(default=False, repr=False)


class WorkloadManager:
    """Tenant registry + budget admission (module docstring). All state
    mutates under one lock; nothing blocking runs inside it."""

    def __init__(self, governor: Optional["OverloadGovernor"] = None):
        self._lock = threading.Lock()
        self._tenants: Dict[str, TenantSpec] = {}
        self._table_tenant: Dict[str, str] = {}
        self._inflight: Dict[str, int] = {}
        self._cpu: Dict[str, _PostPaidBucket] = {}
        self._bytes: Dict[str, _PostPaidBucket] = {}
        self._retries: Dict[str, _PostPaidBucket] = {}
        self.shed_log: List[Tuple[str, str, int, str, int]] = []
        self.governor = governor or OverloadGovernor()

    # -- configuration -----------------------------------------------------
    def set_tenant(self, name: str, tier: str = TIER_STANDARD,
                   max_inflight: Optional[int] = None,
                   cpu_ms_per_s: Optional[float] = None,
                   result_bytes_per_s: Optional[float] = None,
                   retries_per_s: Optional[float] = None) -> TenantSpec:
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r}; have {list(TIERS)}")
        spec = TenantSpec(tier, max_inflight, cpu_ms_per_s,
                          result_bytes_per_s, retries_per_s)
        with self._lock:
            self._tenants[name] = spec
            self._cpu.pop(name, None)
            self._bytes.pop(name, None)
            self._retries.pop(name, None)
            if cpu_ms_per_s:
                self._cpu[name] = _PostPaidBucket(cpu_ms_per_s)
            if result_bytes_per_s:
                self._bytes[name] = _PostPaidBucket(result_bytes_per_s)
            if retries_per_s:
                self._retries[name] = _PostPaidBucket(retries_per_s)
        return spec

    def set_table_tenant(self, table: str,
                         tenant: Optional[str]) -> None:
        with self._lock:
            if tenant:
                self._table_tenant[table] = tenant
            else:
                self._table_tenant.pop(table, None)

    def resolve(self, table: Optional[str]) -> Tuple[str, str]:
        """-> (tenant, tier) for a table; unconfigured tables map to the
        default tenant at standard tier."""
        with self._lock:
            tenant = self._table_tenant.get(table or "", DEFAULT_TENANT)
            spec = self._tenants.get(tenant)
        return tenant, spec.tier if spec else TIER_STANDARD

    def tenant_names(self) -> List[str]:
        with self._lock:
            return sorted(set(self._tenants)
                          | set(self._table_tenant.values()))

    def inflight(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is not None:
                return self._inflight.get(tenant, 0)
            return sum(self._inflight.values())

    # -- admission ---------------------------------------------------------
    def admit(self, qid: str, table: Optional[str],
              retry_attempt: int = 0,
              now: Optional[float] = None) -> AdmissionTicket:
        """Admission-or-shed for one user query. Raises
        ``OverloadShedError`` (429-shaped, retryAfterMs) on a shed;
        otherwise returns the ticket the broker must ``release()``.

        Order of checks (cheapest/purest first): rung ladder (pure),
        retry budget (a retry during overload charges it), concurrency
        budget, then the post-paid cpu/bytes buckets."""
        with self._lock:
            inert = not self._tenants and not self._table_tenant
        rung = self.governor.rung_for(qid)
        if inert and rung == 0:
            # the process default: no tenants configured, nothing
            # armed — two lock reads per query, no metrics churn
            return AdmissionTicket(qid, table, DEFAULT_TENANT,
                                   TIER_STANDARD, 0, counted=False)
        tenant, tier = self.resolve(table)
        reason = shed_decision(qid, tenant, tier, rung)
        retry_ms: Optional[int] = None
        if reason is None and retry_attempt > 0 and rung >= 2:
            # the retry amplification guard: during overload a tenant's
            # retries draw a separate budget, so a shed wave's
            # re-submissions cannot multiply the offered load
            with self._lock:
                bucket = self._retries.get(tenant)
                if bucket is not None:
                    if bucket.ok(now):
                        bucket.debit(1.0, now)
                    else:
                        reason = "retry_budget"
                        retry_ms = 2 * retry_after_ms(qid, tenant, rung)
                        global_metrics.count(
                            "overload_retries_suppressed")
        if reason is None:
            with self._lock:
                spec = self._tenants.get(tenant)
                if spec is not None and spec.max_inflight is not None \
                        and self._inflight.get(tenant, 0) \
                        >= spec.max_inflight:
                    reason = "inflight_budget"
                elif not self._cpu.get(tenant,
                                       _ALWAYS_OK).ok(now):
                    reason = "cpu_budget"
                    retry_ms = self._cpu[tenant].retry_after_ms()
                elif not self._bytes.get(tenant,
                                         _ALWAYS_OK).ok(now):
                    reason = "bytes_budget"
                    retry_ms = self._bytes[tenant].retry_after_ms()
                else:
                    self._inflight[tenant] = \
                        self._inflight.get(tenant, 0) + 1
        if reason is not None:
            self._shed(qid, table, tenant, tier, rung, reason,
                       retry_ms)
        ticket = AdmissionTicket(qid, table, tenant, tier, rung,
                                 brownout=rung >= 3,
                                 degraded=rung >= 1)
        global_metrics.count(f"tenant_admitted_{tenant}")
        global_metrics.gauge(f"tenant_inflight_{tenant}",
                             self.inflight(tenant))
        if ticket.degraded:
            from ..utils.spans import annotate
            annotate(overload_rung=rung)
        return ticket

    def _shed(self, qid: str, table: Optional[str], tenant: str,
              tier: str, rung: int, reason: str,
              retry_ms: Optional[int]) -> None:
        if retry_ms is None:
            retry_ms = retry_after_ms(qid, tenant, rung)
        global_metrics.count("overload_shed")
        global_metrics.count(f"overload_shed_rung_{rung}")
        global_metrics.count(f"overload_shed_{reason}")
        global_metrics.count(f"tenant_shed_{tenant}")
        from ..utils.spans import annotate
        annotate(shed=True, shed_rung=rung, shed_reason=reason)
        with self._lock:
            self.shed_log.append((qid, tenant, rung, reason, retry_ms))
            if len(self.shed_log) > SHED_LOG_CAP:
                del self.shed_log[: SHED_LOG_CAP // 2]
        raise OverloadShedError(
            f"query {qid} shed under overload (tenant {tenant!r} tier "
            f"{tier}, rung {rung}, {reason}); retry after "
            f"{retry_ms}ms", retry_ms, tenant, rung, reason, tier)

    def release(self, ticket: Optional[AdmissionTicket],
                cpu_ms: Optional[float] = None,
                result_bytes: Optional[float] = None,
                now: Optional[float] = None) -> None:
        """End of one admitted query: decrement in-flight and debit any
        explicitly-measured usage (the cluster broker's result-size
        estimate; the in-process path debits through ``observe()``
        instead). Idempotent per ticket."""
        if ticket is None or ticket.released:
            return
        ticket.released = True
        if not ticket.counted:
            return  # inert fast path: nothing to undo
        with self._lock:
            n = self._inflight.get(ticket.tenant, 0)
            if n > 1:
                self._inflight[ticket.tenant] = n - 1
            else:
                self._inflight.pop(ticket.tenant, None)
            if cpu_ms and ticket.tenant in self._cpu:
                self._cpu[ticket.tenant].debit(cpu_ms, now)
            if result_bytes and ticket.tenant in self._bytes:
                self._bytes[ticket.tenant].debit(result_bytes, now)
        global_metrics.gauge(f"tenant_inflight_{ticket.tenant}",
                             self.inflight(ticket.tenant))

    def observe(self, usage: Any) -> None:
        """The accountant's unregister hook (engine/accounting.py): a
        QueryUsage carrying a tenant debits its actual CPU-ms and
        tracked result bytes — the post-paid feed off the existing
        ``track_result`` fence, no extra metering on the hot path."""
        tenant = getattr(usage, "tenant", None)
        if not tenant:
            return
        with self._lock:
            if tenant in self._cpu:
                self._cpu[tenant].debit(usage.cpu_s * 1e3)
            if tenant in self._bytes:
                self._bytes[tenant].debit(usage.mem_bytes)

    def clear_shed_log(self) -> None:
        """Reset the comparison stream (the replay gate clears it at
        the spike boundary so only spike decisions are compared)."""
        with self._lock:
            self.shed_log.clear()

    def shed_stream(self) -> List[Tuple[str, str, int, str, int]]:
        """Order-independent copy of the shed log (qid, tenant, rung,
        reason, retryAfterMs) — the chaos-gate comparison stream, the
        ``FaultPlan.fired_summary`` discipline."""
        with self._lock:
            return sorted(self.shed_log)

    def reset(self) -> None:
        """Back to the inert default (tests + harness teardown)."""
        with self._lock:
            self._tenants.clear()
            self._table_tenant.clear()
            self._inflight.clear()
            self._cpu.clear()
            self._bytes.clear()
            self._retries.clear()
            self.shed_log.clear()
        self.governor.reset()

    def health(self) -> Dict[str, Any]:
        """The per-tenant block for /metrics consoles."""
        with self._lock:
            tenants = sorted(set(self._tenants)
                             | set(self._inflight))
            out = {t: {
                "tier": (self._tenants.get(t) or TenantSpec()).tier,
                "inflight": self._inflight.get(t, 0),
            } for t in tenants}
        return out


class _AlwaysOk:
    """Null bucket for tenants without a budget."""

    @staticmethod
    def ok(now: Optional[float] = None) -> bool:
        return True


_ALWAYS_OK = _AlwaysOk()


class OverloadGovernor:
    """Watermark ladder over registered pressure signals (module
    docstring). Signals are (fn, capacity) pairs: pressure is the MAX
    of fn()/capacity over all signals — overload is whichever resource
    saturates first, never an average that hides it."""

    #: pressure thresholds per rung (>= threshold enters the rung)
    WATERMARKS: Dict[int, float] = {1: 0.5, 2: 0.75, 3: 0.9}
    HYSTERESIS = 0.05
    # live pressure is re-sampled at most this often (signal fns may
    # read /proc); pins bypass the cache entirely
    POLL_S = 0.05

    def __init__(self):
        self._lock = threading.Lock()
        self._signals: Dict[str, Tuple[Callable[[], float], float]] = {}
        self._pins: Optional[Dict[str, int]] = None
        self._pin_default: int = 0
        self._rung = 0
        self._pressure = 0.0
        self._t_sample = 0.0

    # -- configuration -----------------------------------------------------
    def add_signal(self, name: str, fn: Callable[[], float],
                   capacity: float) -> None:
        """Register a pressure source: fn() in the same unit as
        ``capacity`` (e.g. in-flight queries vs a capacity of 32)."""
        if capacity <= 0:
            raise ValueError(f"signal {name!r} needs capacity > 0")
        with self._lock:
            self._signals[name] = (fn, float(capacity))

    def remove_signal(self, name: str) -> None:
        with self._lock:
            self._signals.pop(name, None)
            disarmed = not self._signals and self._pins is None
        if disarmed:
            # back to inert: the cached rung must not stick elevated
            # forever once nothing can ever lower it again
            self._apply(0)

    def pin_rungs(self, by_qid: Dict[str, int],
                  default: int = 0) -> None:
        """Replay-harness mode: the rung per qid is a precomputed pure
        schedule (tools/traffic_replay.py derives it from the offered-
        load curve through ``rung_for_pressure`` — the same ladder live
        signals drive), so shed streams are reproducible. ``default``
        applies to qids outside the map."""
        with self._lock:
            self._pins = dict(by_qid)
            self._pin_default = int(default)
        self._apply(max([default] + list(by_qid.values()))
                    if by_qid or default else 0)

    def unpin(self) -> None:
        with self._lock:
            self._pins = None
            self._pin_default = 0
        self._apply(0)

    @classmethod
    def rung_for_pressure(cls, pressure: float) -> int:
        """The PURE watermark map (no hysteresis, no state) — shared by
        the live path and the replay planner's schedule computation."""
        rung = 0
        for r, w in sorted(cls.WATERMARKS.items()):
            if pressure >= w:
                rung = r
        return rung

    # -- live evaluation ---------------------------------------------------
    def pressure(self) -> float:
        with self._lock:
            signals = list(self._signals.values())
        if not signals:
            return 0.0
        p = 0.0
        for fn, cap in signals:
            try:
                p = max(p, float(fn()) / cap)
            except Exception:
                continue  # a broken signal must never fail admission
        return p

    def rung(self, now: Optional[float] = None) -> int:
        """Current rung from live signals, with hysteresis (a rung only
        drops once pressure falls HYSTERESIS below its watermark — no
        flapping at the boundary). ``now`` injects the poll clock for
        replay/tests; pinned and inert governors return before any
        clock read, so replay-mode admission never touches wall time.
        """
        with self._lock:
            pinned = self._pins is not None
            inert = not self._signals
            current = self._rung
            t_sample = self._t_sample
        if pinned or inert:
            # inert (nothing armed) is the process default: zero work,
            # zero metric churn, zero clock reads on every
            # admission/hedge check
            return current
        t = now if now is not None else time.monotonic()
        if (t - t_sample) < self.POLL_S:
            return current
        p = self.pressure()
        rung = self.rung_for_pressure(p)
        if rung < current:
            # hysteresis: stay on the higher rung until clearly below it
            w = self.WATERMARKS.get(current, 1.0)
            if p >= w - self.HYSTERESIS:
                rung = current
        with self._lock:
            self._pressure = p
            self._t_sample = t if now is not None else time.monotonic()
        if rung != current:
            self._apply(rung)
        global_metrics.gauge("overload_pressure", round(p, 4))
        return rung

    def rung_for(self, qid: str, now: Optional[float] = None) -> int:
        """The admission rung for one query: the pinned schedule when
        one is installed (replay), else the live rung."""
        with self._lock:
            if self._pins is not None:
                return self._pins.get(qid, self._pin_default)
        return self.rung(now)

    def _apply(self, rung: int) -> None:
        """Rung transition side effects: the speculative-work ladder
        (rung >= 1 widens the micro-batch admission window so fused
        launches get fuller while hedging/tracing pause — the brokers
        consult ``rung()`` for those directly)."""
        with self._lock:
            prev, self._rung = self._rung, rung
        if prev == rung:
            return
        global_metrics.count(f"overload_rung_enter_{rung}")
        global_metrics.gauge("overload_rung", rung)
        from ..engine.ragged import global_batcher
        global_batcher.window_scale = WINDOW_SCALE if rung >= 1 else 1.0

    # -- degradation queries (brokers consult these) -----------------------
    def shed_speculative(self) -> bool:
        """rung >= 1: hedging + traceRatio sampling pause."""
        return self.rung() >= 1

    def brownout_deadline_ms(self) -> Optional[float]:
        """rung >= 3: the floor deadline every admitted query clamps
        to (None below rung 3)."""
        return BROWNOUT_DEADLINE_MS if self.rung() >= 3 else None

    def reset(self) -> None:
        with self._lock:
            self._signals.clear()
            self._pins = None
            self._pin_default = 0
            self._pressure = 0.0
            self._t_sample = 0.0
        self._apply(0)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"rung": self._rung,
                    "pressure": round(self._pressure, 4),
                    "pinned": self._pins is not None,
                    "signals": sorted(self._signals)}


def arm_default_signals(workload: "WorkloadManager",
                        inflight_capacity: int = 64,
                        rss_limit_bytes: Optional[int] = None,
                        devmem_budget_bytes: Optional[int] = None,
                        queue_depth_fn: Optional[Callable[[], float]]
                        = None,
                        queue_capacity: int = 64) -> None:
    """Wire the repo's existing signals into a governor: broker
    in-flight count, accountant RSS pressure, utils/devmem pool bytes,
    and (when provided) a scheduler/batch queue-depth callable. Called
    by operators/harnesses that want live overload protection —
    NOT armed by default (the ladder stays inert until configured)."""
    gov = workload.governor
    gov.add_signal("inflight", workload.inflight,
                   float(inflight_capacity))
    if rss_limit_bytes is None:
        from ..engine.accounting import system_memory_bytes
        rss_limit_bytes = int(system_memory_bytes() * 0.9) or None
    if rss_limit_bytes:
        from ..engine.accounting import process_rss_bytes
        gov.add_signal("rss", process_rss_bytes, float(rss_limit_bytes))
    if devmem_budget_bytes:
        from ..utils.devmem import global_device_memory

        def _dev_bytes() -> float:
            snap = global_device_memory.snapshot()
            return float((snap.get("total") or {}).get("bytes", 0))
        gov.add_signal("devmem", _dev_bytes, float(devmem_budget_bytes))
    if queue_depth_fn is not None:
        gov.add_signal("queue", queue_depth_fn, float(queue_capacity))


# process-global instances, the global_accountant/global_batcher idiom:
# in-process clusters run several broker roles in one interpreter and
# tenant budgets must be enforced once per process, not per role
global_governor = OverloadGovernor()
global_workload = WorkloadManager(global_governor)
