"""Deterministic, seedable fault injection for the cluster plane.

Port of ``pinot_tpu/utils/faults.py``, whole: the registry, the plan
grammar, the per-stream decisions (``_unit`` hashes with ``hashlib``, so
one seed fires at the same sites in both packages) and the inline
effects. In the port the ingest family has its call sites
(``realtime/stream.consume_faults``, ``realtime/manager.py``,
``upsert/metadata.py``) and so do the device points: ``tier.evict``
(``engine/tier.on_access``), ``device.overflow`` (``engine/executor``'s
compact rerun and ``multistage/fused``'s fallback) and
``accounting.oom_kill`` (``engine/accounting.sample``); the RPC, wire,
commit-protocol, handoff and rebalance points wait for the cluster
plane.

Reference parity: the reference exercises its ConnectionFailureDetector,
deadline budgets, and partial-response paths with Netty-level chaos in
integration tests; here the same failure classes are first-class *named
injection points* compiled into the hot paths, modeled on the span
tracer (utils/spans.py): a single ``is None`` check when no plan is
installed, so the hooks live permanently in http_util / server_node /
grpc_plane / accounting / executor at zero cost.

Named points (the registry contract — tests and tools/chaos_smoke.py
target these):

==================== ======================================================
``rpc.drop``         client-side connection failure (URLError) before the
                     request is sent (http_util.http_raw, grpc client)
``rpc.delay``        sleep ``delay_ms`` before the request is sent
``rpc.http_error``   synthesized HTTPError(``http_status``) without
                     reaching the server (application-error path)
``wire.corrupt``     flip the magic/header bytes of a binary response
                     frame before decode (broker gather path)
``segment.slow``     server-side straggler: sleep ``delay_ms`` before
                     executing (cluster/server_node.py)
``accounting.oom_kill`` the accountant kills the sampling query as the
                     HeapWatcher would under heap pressure
``device.overflow``  force the kernel's compact-overflow retry ladder
                     (engine/executor.run_kernel) — result-identical
``stream.error``     a consumer read fails (ConnectionError) before the
                     fetch reaches the stream (realtime/stream.py
                     ``consume_faults`` — kafka/kinesis/pulsar/in-memory
                     consumers all pass through it)
``stream.rebalance`` decision hook: partition offsets snap back — the
                     realtime manager drops its consuming state and
                     resumes from the durable checkpoint
                     (realtime/manager.py)
``commit.crash``     decision hook: simulated process death between the
                     segment build and the checkpoint ``os.replace`` —
                     the site raises ``IngestCrash`` and the manager
                     must be abandoned and restarted
``commit.http_error`` the controller-arbitrated commit RPC fails
                     mid-protocol (HTTPError, cluster/completion.py —
                     segmentConsumed / commitStart / commitEnd
                     boundaries)
``handoff.stall``    a COMMITTED-replica artifact download stalls
                     (sleep ``delay_ms``) then fails (OSError) —
                     cluster/deepstore.download_segment; the adopter
                     retries on its next poll
``upsert.compact_crash`` decision hook: crash mid upsert-metadata
                     replay / TTL eviction (upsert/metadata.py) — the
                     site raises ``IngestCrash``
``tier.evict``       decision hook: the HBM tier force-demotes the
                     touched segment MID-QUERY (engine/tier.on_access,
                     site key = segment name) — the query must
                     re-promote through device_col and finish
                     byte-exact (tools/chaos_smoke.py ``--tier``)
``rebalance.crash``  decision hook: the controller dies inside the
                     rebalance cutover window — after the receiver
                     pre-warmed but BEFORE the flip journal commit
                     (cluster/rebalancer.py raises RebalanceCrash;
                     site key ``rebalance/<table>/<segment>``). The
                     next pass / new leader must resume the journaled
                     move idempotently, never double-assign
``cutover.stall``    a rebalance receiver pre-warm hangs past its
                     deadline: sleep ``delay_ms`` then OSError at the
                     pre-warm wait (same site key) — the move aborts,
                     the donor keeps serving, placement is unchanged
==================== ======================================================

Activation: ``PINOT_FAULTS`` env var at process start, or
``install(plan)`` from code / the server's scheduler config
(``{"fault.plan": "..."}``). Plan grammar (``;``-separated)::

    seed=42; rpc.drop: match=/query/bin, p=0.5, times=1;
             segment.slow: delay_ms=200, after=1

Per-spec fields: ``p`` fire probability, ``match`` substring filter on
the stream name (``qid|site-key`` under a query context, else the bare
site key — server URL, instance id, segment name), ``times`` max fires
**per stream** (-1 unlimited), ``after`` skip the first N matching
hits (per stream), ``delay_ms``, ``http_status``.

Determinism — per-query / per-partition streams: a decision
is a pure function of ``hash(seed, point, stream, hit_index)`` where
the **stream** is ``(owning query id, site key)`` when the calling
thread executes on behalf of a registered query
(``engine.accounting.global_accountant.current_query_id()``) and the
bare site key otherwise (ingest consumer threads, broker scatter pool
threads — ingest sites embed ``table/partition`` in the key, so those
are naturally per-partition streams). Hit AND fire counters are kept
per (spec, stream): background traffic, thread interleaving across
servers, AND the micro-batcher's
admission-window composition cannot perturb another stream's
decisions, so the same seed fires the same faults for a query whether
its peers fused, ran solo, or interleaved arbitrarily.

Compat note (older plans): hit/fire/``after``/``times`` windows
used to be per SITE KEY across the whole process, shared by every
query touching the site; they are now per (query, site) wherever a
query context exists, so e.g. ``times=1`` at a query-execution point
bounds fires *per query*, not per process (``accounting.oom_kill``
included — it used to decide on one process-global stream). To pin a
fault to one specific query, name it (``OPTION(queryId=...)``, honored
by the in-process broker) and use ``match`` — the match filter tests
the COMPOSITE ``qid|site-key`` stream name. Note that p<1 draws hash
the stream name, so cross-run reproducibility of probabilistic specs
at query-context sites requires deterministically named query ids
(chaos tooling — chaos_smoke, engine/loadgen, bench_ingest — names
them); ``p=1``/``times``/``after`` specs are reproducible regardless,
because the per-stream counters do not depend on the id's value.

Every fired fault is appended to ``plan.fired`` (under the plan lock,
with the owning query id when one exists), annotated onto the active
span, and counted in ``global_metrics`` (``faults_fired`` +
``fault_<point>``).
"""
from __future__ import annotations

import hashlib
import io
import threading
import time
import urllib.error
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

FAULT_POINTS = (
    "rpc.drop", "rpc.delay", "rpc.http_error", "wire.corrupt",
    "segment.slow", "accounting.oom_kill", "device.overflow",
    # ingest fault family (realtime consume -> seal -> commit -> handoff)
    "stream.error", "stream.rebalance", "commit.crash",
    "commit.http_error", "handoff.stall", "upsert.compact_crash",
    # HBM tier (engine/tier.py): forced mid-query demotion
    "tier.evict",
    # closed-loop rebalance cutover (cluster/rebalancer.py)
    "rebalance.crash", "cutover.stall",
)


class FaultInjected(Exception):
    """Marker base so call sites/tests can distinguish injected failures
    that are NOT shaped like a real transport error (transport-shaped
    faults raise the real urllib exceptions on purpose — the code under
    test must not be able to tell them apart)."""


class IngestCrash(FaultInjected):
    """Simulated process death inside the ingest plane (commit.crash /
    upsert.compact_crash). Never caught-and-continued: the realtime
    manager that raised it must be abandoned and a fresh one restarted
    from the durable checkpoint — exactly the recovery path a real
    kill -9 would force."""


@dataclass(frozen=True)
class FaultSpec:
    point: str
    prob: float = 1.0
    match: str = ""          # substring of the stream name; "" = all
    times: int = -1          # max fires per stream; -1 = unlimited
    after: int = 0           # skip the first N matching hits (per stream)
    delay_ms: float = 0.0
    http_status: int = 503

    @staticmethod
    def parse(text: str) -> "FaultSpec":
        """``point: k=v, k=v`` (the PINOT_FAULTS per-spec grammar)."""
        head, _, rest = text.partition(":")
        point = head.strip()
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}; "
                             f"have {list(FAULT_POINTS)}")
        kw: Dict[str, Any] = {}
        for item in filter(None, (p.strip() for p in rest.split(","))):
            k, _, v = item.partition("=")
            k = k.strip()
            v = v.strip()
            if k == "p":
                kw["prob"] = float(v)
            elif k == "match":
                kw["match"] = v
            elif k in ("times", "after", "http_status"):
                kw[k] = int(v)
            elif k == "delay_ms":
                kw[k] = float(v)
            else:
                raise ValueError(f"unknown fault field {k!r} in {text!r}")
        return FaultSpec(point, **kw)


def _unit(seed: int, point: str, key: str, hit: int) -> float:
    """Deterministic uniform [0, 1) — stable across processes/threads."""
    h = hashlib.sha256(f"{seed}|{point}|{key}|{hit}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


def _context_query_id() -> str:
    """The query this thread executes on behalf of, or '' — the stream
    partitioner for decide(). Lazy import: utils must not pull the
    engine in at import time (engine.accounting itself imports this
    module lazily inside sample())."""
    try:
        from ..engine.accounting import global_accountant
    except Exception:  # engine unavailable (stripped install)
        return ""
    return global_accountant.current_query_id() or ""


class FaultPlan:
    """One installed chaos plan: specs + seed + per-(spec, stream) hit
    counters + the fired-fault log (stream = (owning query id, site
    key) where a query context exists, site key alone otherwise — see
    the module doc)."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._hits: Dict[Tuple[int, str], int] = {}
        self._fires: Dict[Tuple[int, str], int] = {}
        self.fired: List[Dict[str, Any]] = []

    @staticmethod
    def parse(text: str) -> "FaultPlan":
        """Full PINOT_FAULTS grammar: ``seed=N; spec; spec; ...``."""
        seed = 0
        specs: List[FaultSpec] = []
        for part in filter(None, (p.strip() for p in text.split(";"))):
            if part.startswith("seed="):
                seed = int(part[5:])
            else:
                specs.append(FaultSpec.parse(part))
        return FaultPlan(specs, seed)

    def decide(self, point: str, key: str) -> Optional[FaultSpec]:
        """First matching spec that fires for this hit, or None. Pure in
        (seed, point, stream, per-stream hit index) where stream =
        (owning query id | site key) — see module doc. The query id is
        resolved OUTSIDE the plan lock (the accountant takes its own
        lock; nesting it under ours would order locks against
        engine.accounting's internals)."""
        qid = _context_query_id()
        stream = f"{qid}|{key}" if qid else key
        fired: Optional[FaultSpec] = None
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.point != point:
                    continue
                if spec.match and spec.match not in stream:
                    continue
                hit = self._hits.get((i, stream), 0)
                self._hits[(i, stream)] = hit + 1
                if hit < spec.after:
                    continue
                # fire budget is per (spec, stream) like the hit
                # counter: a shared budget would be consumed by
                # whichever thread reached the lock first, breaking
                # same-seed determinism
                if spec.times >= 0 and \
                        self._fires.get((i, stream), 0) >= spec.times:
                    continue
                if spec.prob < 1.0 and \
                        _unit(self.seed, point, stream, hit) >= spec.prob:
                    continue
                self._fires[(i, stream)] = \
                    self._fires.get((i, stream), 0) + 1
                entry = {"point": point, "key": key, "hit": hit}
                if qid:
                    entry["q"] = qid
                self.fired.append(entry)
                fired = spec
                break
        return fired

    def fired_summary(self) -> List[Tuple[str, str, int]]:
        """Order-independent view of the fired log (threads race on
        append order; (point, key, per-stream hit) triples do not —
        and they stay comparable across runs even when query ids are
        random, because the triple carries the SITE key while the hit
        index comes from the owning stream's own counter)."""
        with self._lock:
            return sorted((f["point"], f["key"], f["hit"])
                          for f in self.fired)


_plan: Optional[FaultPlan] = None
_plan_lock = threading.Lock()


def install(plan: Any, seed: Optional[int] = None) -> FaultPlan:
    """Install a process-global plan: a FaultPlan, a PINOT_FAULTS-grammar
    string, or a list of FaultSpecs (+ seed)."""
    global _plan
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    elif isinstance(plan, (list, tuple)):
        plan = FaultPlan(list(plan), seed or 0)
    if seed is not None:
        plan.seed = int(seed)
    with _plan_lock:
        _plan = plan
    return plan


def clear() -> None:
    global _plan
    with _plan_lock:
        _plan = None


def active() -> bool:
    return _plan is not None


def current_plan() -> Optional[FaultPlan]:
    return _plan


def install_from_env(environ: Optional[Dict[str, str]] = None
                     ) -> Optional[FaultPlan]:
    import os
    text = (environ if environ is not None else os.environ) \
        .get("PINOT_FAULTS")
    return install(text) if text else None


def _record(point: str, key: str, spec: FaultSpec,
            detail: Optional[str] = None) -> None:
    from .metrics import global_metrics
    global_metrics.count("faults_fired")
    global_metrics.count("fault_" + point.replace(".", "_"))
    from .spans import add_event, tracing_active
    if tracing_active():
        add_event(f"fault:{point}", spec.delay_ms, key=key,
                  **({"detail": detail} if detail else {}))


def fault_fires(point: str, key: str = "",
                detail: Optional[str] = None) -> bool:
    """Pure decision hook for sites that implement the effect themselves
    (device.overflow, accounting.oom_kill)."""
    plan = _plan
    if plan is None:
        return False
    spec = plan.decide(point, key)
    if spec is None:
        return False
    _record(point, key, spec, detail)
    return True


def fault_point(point: str, key: str = "") -> None:
    """Raise/sleep per the installed plan at a named point; no-op (one
    attribute read) when no plan is installed."""
    plan = _plan
    if plan is None:
        return
    spec = plan.decide(point, key)
    if spec is None:
        return
    _record(point, key, spec)
    if point in ("rpc.delay", "segment.slow"):
        time.sleep(spec.delay_ms / 1e3)
        return
    if point == "rpc.drop":
        # shaped like a real connection failure: callers must take the
        # genuine failover path, not a special injected one
        raise urllib.error.URLError(
            OSError(f"injected fault rpc.drop ({key})"))
    if point in ("rpc.http_error", "commit.http_error"):
        raise urllib.error.HTTPError(
            key or "http://injected", spec.http_status,
            f"injected fault {point}", None,
            io.BytesIO(f"injected fault {point}".encode()))
    if point == "stream.error":
        # shaped like a real consumer-transport failure: the manager's
        # bounded retry-with-backoff must not be able to tell them apart
        raise ConnectionError(f"injected fault stream.error ({key})")
    if point == "handoff.stall":
        # artifact download stalls, then breaks: the adopting replica
        # retries from its next completion poll
        time.sleep(spec.delay_ms / 1e3)
        raise OSError(f"injected fault handoff.stall ({key})")
    if point == "cutover.stall":
        # receiver pre-warm hangs past its deadline: the rebalancer
        # aborts the move and the donor keeps serving
        time.sleep(spec.delay_ms / 1e3)
        raise OSError(f"injected fault cutover.stall ({key})")
    raise FaultInjected(f"fault point {point} has no inline effect; "
                        "use fault_fires()/corrupt_bytes()")


def rpc_faults(key: str) -> None:
    """The standard client-side RPC trio in deterministic order (delay
    first so a delayed call can still be dropped)."""
    if _plan is None:
        return
    fault_point("rpc.delay", key)
    fault_point("rpc.drop", key)
    fault_point("rpc.http_error", key)


def corrupt_bytes(point: str, key: str, data: bytes) -> bytes:
    """wire.corrupt effect: XOR the frame magic + header-length prefix so
    decode fails loudly (never silently wrong — decode_wire_frame checks
    the magic before trusting anything else)."""
    plan = _plan
    if plan is None:
        return data
    spec = plan.decide(point, key)
    if spec is None:
        return data
    _record(point, key, spec)
    head = bytes(b ^ 0xFF for b in data[:8])
    return head + bytes(data[8:])


# activate from the environment at import, like the span tracer's
# permanently-compiled-in stance: cluster roles import this module, so a
# PINOT_FAULTS-bearing process is armed before any node starts
install_from_env()
