"""Closed-loop traffic replay: the overload-resilience gate.

The port's copy of the root ``tools/traffic_replay.py``, over
``pinot_tpu_torch``: the same subcommands (``gate`` in cluster and local
mode, ``plan``, ``rebalance``, ``autopsy``), flags, seeds, summary JSON
and exit codes. Its servers, brokers and tables run on ``--device``
(default ``cuda``; without a card the gates refuse, exit 2, unless
``--device cpu`` is given). It replays a recorded query mix at a
multiple of its rate against a cluster whose per-tenant budgets enforce
QoS, closed end to end:

1. **Record** — a seeded three-tenant query mix (``protected`` /
   ``standard`` / ``besteffort`` tables) runs at 1x through the real
   broker path, landing ``query_stats`` ledger records that carry SQL,
   per-query ``arrival_ms`` offsets, tenant and qid — the replay input
   AND the pre-spike latency baseline.
2. **Plan** — the recorded records compress to ``--multiple N`` x their
   inter-arrival spacing. The offered-rate curve (a pure function of
   ledger + multiple + capacity) maps through the SAME watermark ladder
   live signals drive (``OverloadGovernor.rung_for_pressure``) into a
   per-qid rung schedule, and the pure shed ladder
   (``workload.shed_decision``) precomputes the full shed stream —
   retries included (a shed query retries once after its deterministic
   ``retryAfterMs``). The plan is computed TWICE and must match itself.
3. **Spike** — the rung schedule pins onto the broker's governor
   (``pin_rungs`` — decisions stay in the broker: tier ladder, hash
   draws, 429 shaping, counters, ledger rows all execute there), a
   chaos plan arms (recoverable faults: straggler delay + one dropped
   dispatch per server, so failover runs under load), and the replay
   client dispatches on schedule, honoring each shed response's
   ``retryAfterMs`` before its single retry. Every shed response must
   be a structured 429 (errorCode + retryAfterMs) — a 500 anywhere
   fails the gate.
4. **Verify** — the broker's OBSERVED shed stream must equal the
   precomputed one byte-for-byte; ``protected`` must see ZERO sheds and
   zero errors with spike p99 inside its self-calibrated bar while
   ``besteffort`` absorbs the excess; and after the spike the governor
   unpins and a fresh 1x pass must land back inside the pre-spike noise
   floor — no metastable retry-storm state.

The summary lands as one validated ``replay_bench`` ledger record
(``utils/ledger.py``) whose ``backend`` is the torch device the run
used. ``chaos_smoke --overload`` runs the gate in cluster mode.

    python -m pinot_tpu_torch.tools.traffic_replay gate [--multiple 4]
        [--seed N] [--queries 48] [--mode cluster|local] [--no-chaos]
        [--ledger OUT.jsonl] [--device cuda|cpu]
    python -m pinot_tpu_torch.tools.traffic_replay plan STATS.jsonl \
        --multiple 4
    python -m pinot_tpu_torch.tools.traffic_replay rebalance|autopsy ...

The autopsy gate has no compile-storm pass: the port has no compile
plane (JAX-only), so it injects the straggler and the tier thrash and
checks the clean pass.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.error
from typing import Any, Dict, List, Optional, Tuple

from ..device import tool_device

# -- gate scenario ----------------------------------------------------------

TENANT_TABLES = (
    # (table, tenant, tier, mix weight)
    ("rp_orders", "ten_protected", "protected", 3),
    ("rp_events", "ten_standard", "standard", 3),
    ("rp_logs", "ten_besteffort", "besteffort", 4),
)

QUERY_SHAPES = (
    "SELECT k, SUM(v), COUNT(*) FROM {t} WHERE v < {p} GROUP BY k "
    "ORDER BY k LIMIT 16",
    "SELECT COUNT(*), SUM(v) FROM {t} WHERE v < {p}",
)

OPTION_TIMEOUT_MS = 120_000
# pressure = offered qps / (recorded qps * CAPACITY_HEADROOM): at 1x the
# steady offered rate reads ~0.4 — comfortably under every watermark —
# while --multiple 4 plateaus at ~1.6, deep in rung 3, with the window
# ramp passing rungs 1-2 at the spike edges
CAPACITY_HEADROOM = 2.5
PRESSURE_WINDOW_S = 0.25
# recovery bar: post-spike p50 within factor x pre-spike p50 + floor
# (floor absorbs scheduler jitter on tiny absolute latencies; the
# metastable failure mode this guards against is 10-100x, not 2x)
RECOVER_FACTOR = 3.0
RECOVER_FLOOR_MS = 80.0
# protected p99 bar during the spike, relative to its own pre-spike p99
# (the floor absorbs the armed chaos plan's own injected straggler
# delays + queueing on loaded CI boxes; the failure mode this guards —
# protected queries starving behind an unshed backlog — is seconds)
PROTECTED_BAR_FACTOR = 5.0
PROTECTED_BAR_FLOOR_MS = 750.0
# SLO burn windows for the spike: the fast window is wider
# than the whole compressed spike (so both paired windows see the full
# shed fraction — the fire decision reduces to the cumulative bad
# fraction, order-independent), and narrow enough that ~1 s into the
# good-traffic recovery phase it drains to zero and CLEARS the latch
SLO_FAST_S = 1.0
SLO_SLOW_S = 6.0
SLO_BURN_THRESHOLD = 1.0


def _pctl(sorted_vals: List[float], frac: float) -> float:
    from ..utils.stats import pctl
    return pctl(sorted_vals, frac)


# -- clients (cluster HTTP vs in-process broker) ----------------------------

class _Outcome:
    __slots__ = ("kind", "ms", "payload")

    def __init__(self, kind: str, ms: float = 0.0,
                 payload: Optional[dict] = None):
        self.kind = kind          # ok | shed | error
        self.ms = ms
        self.payload = payload or {}


class _ClusterClient:
    """POST /query/sql against a BrokerNode; a shed is HTTP 429 with
    the structured payload (anything else shed-shaped fails the
    structured-429 contract)."""

    extra_opt = ""  # appended inside every OPTION(...) clause

    def __init__(self, broker_url: str):
        self.url = broker_url

    def query(self, sql: str) -> _Outcome:
        from ..cluster.http_util import http_json
        t0 = time.perf_counter()
        try:
            http_json("POST", f"{self.url}/query/sql", {"sql": sql},
                      timeout=120.0)
            return _Outcome("ok", (time.perf_counter() - t0) * 1e3)
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read().decode())
            except Exception:
                body = {}
            if e.code == 429:
                return _Outcome("shed", payload=body)
            return _Outcome("error", payload={
                "status": e.code, **(body if isinstance(body, dict)
                                     else {})})
        except Exception as e:  # noqa: BLE001 — summarized, not raised
            return _Outcome("error",
                            payload={"error": f"{type(e).__name__}: {e}"})


class _LocalClient:
    """In-process Broker path: a shed raises OverloadShedError, whose
    payload() is the same structured shape the HTTP plane ships."""

    extra_opt = ""  # appended inside every OPTION(...) clause

    def __init__(self, broker):
        self.broker = broker

    def query(self, sql: str) -> _Outcome:
        from ..broker.workload import OverloadShedError
        from ..query.sql import SqlError
        t0 = time.perf_counter()
        try:
            self.broker.query(sql)
            return _Outcome("ok", (time.perf_counter() - t0) * 1e3)
        except OverloadShedError as e:
            return _Outcome("shed", payload=e.payload())
        except SqlError as e:
            return _Outcome("error", payload={"error": str(e)})


# -- cluster / table builders ----------------------------------------------

def retire_segments(*holders) -> None:
    """The immutable segments of every table of ``holders`` (Brokers or
    ServerNodes) leave the device (``ImmutableSegment.retire``): a
    gate's tables end with it, and so do their device bytes and the
    device-memory plane's count of them (a stopped server is a process
    that ended)."""
    for h in holders:
        for dm in list(h._tables.values()):
            for seg in dm.acquire_segments():
                if not getattr(seg, "is_mutable", False):
                    seg.retire()


def quiesce(timeout: float = 30.0) -> bool:
    """Wait until no query executes in this process: a hedged-away
    straggler's execution runs on after its broker answered, and would
    skew the next window's server spans."""
    from ..engine.accounting import global_accountant

    deadline = time.monotonic() + timeout
    while global_accountant.running():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


def stop_servers(servers) -> None:
    """Stop each server node and retire its segments; a server that
    fails to stop does not keep the others running, and its failure is
    raised once all have been tried."""
    failed = []
    for s in servers:
        try:
            s.stop()
        except Exception as e:  # noqa: BLE001 — raised below
            failed.append(e)
        retire_segments(s)
    if failed:
        raise RuntimeError(f"{len(failed)} server node(s) failed to "
                           f"stop: {failed!r}") from failed[0]


def stop_cluster(ctrl, servers, broker) -> None:
    """Stop the broker node, each server (its segments retired) and the
    controller; a server's failure to stop is raised after the
    controller has stopped."""
    broker.stop()
    try:
        stop_servers(servers)
    finally:
        ctrl.stop()


def _gen_columns(rows: int, seed: int = 7) -> Dict[str, Any]:
    import numpy as np
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 16, rows).astype(np.int32),
            "v": rng.integers(0, 1000, rows).astype(np.int32)}


def _schema(table: str):
    from ..spi import DataType, FieldSpec, FieldType, Schema
    return Schema(table, [
        FieldSpec("k", DataType.INT, FieldType.DIMENSION),
        FieldSpec("v", DataType.INT, FieldType.METRIC),
    ])


def configure_tenants() -> None:
    """Register the gate's tenant tiers on the process-global workload
    manager. Budgets stay unlimited here on purpose: the replay's shed
    stream must be a pure function of the pinned rung schedule
    (budget sheds are wall-clock-fed and unit-tested separately)."""
    from ..broker.workload import global_workload
    for _table, tenant, tier, _w in TENANT_TABLES:
        global_workload.set_tenant(tenant, tier=tier)


def build_cluster(tmp: str, rows: int = 4096, poll: float = 0.1,
                  device: Any = "cuda"):
    """Controller + 2 servers on ``device`` + broker hosting the three
    tenant tables (TableConfig ``tenant`` field shipped through the
    routing snapshot)."""
    from ..cluster import BrokerNode, Controller, ServerNode
    from ..segment import SegmentBuilder
    from ..spi import TableConfig

    ctrl = Controller(os.path.join(tmp, "ctrl"), heartbeat_timeout=5.0,
                      reconcile_interval=0.2)
    servers = [ServerNode(f"server_{i}", ctrl.url, poll_interval=poll,
                          device=device) for i in range(2)]
    broker = BrokerNode(ctrl.url, routing_refresh=poll,
                        query_stats_path=os.path.join(
                            tmp, "query_stats.jsonl"))
    cols = _gen_columns(rows)
    for table, tenant, _tier, _w in TENANT_TABLES:
        schema = _schema(table)
        builder = SegmentBuilder(schema, TableConfig(table))
        ctrl.add_table(table, schema.to_dict(),
                       config={"tenant": tenant}, replication=2)
        half = rows // 2
        for i, (lo, hi) in enumerate(((0, half), (half, rows))):
            d = builder.build({n: v[lo:hi] for n, v in cols.items()},
                              os.path.join(tmp, table), f"seg_{i}")
            ctrl.add_segment(table, f"seg_{i}", d)
    v = ctrl.routing_snapshot()["version"]
    for s in servers:
        assert s.wait_for_version(v, timeout=30.0), "server never synced"
    assert broker.wait_for_version(v, timeout=30.0), "broker never synced"

    def stop():
        stop_cluster(ctrl, servers, broker)

    return ctrl, servers, broker, stop


def build_local(tmp: str, rows: int = 4096, device: Any = "cuda"):
    """In-process Broker on ``device`` hosting the same tenant tables
    (the gate's fast mode)."""
    from ..broker import Broker
    from ..segment import SegmentBuilder
    from ..server import TableDataManager
    from ..spi import TableConfig

    broker = Broker(device=device)
    cols = _gen_columns(rows)
    for table, tenant, _tier, _w in TENANT_TABLES:
        schema = _schema(table)
        cfg = TableConfig(table, tenant=tenant)
        dm = TableDataManager(table, device=device)
        dm.table_config = cfg
        dm.add_segment_dir(SegmentBuilder(schema, cfg).build(
            cols, os.path.join(tmp, table), "seg_0"))
        broker.register_table(dm)
    return broker


# -- the seeded mix ---------------------------------------------------------

def build_mix(seed: int, n_queries: int) -> List[Dict[str, Any]]:
    """The seeded (table, tenant, tier, sql) sequence — pure in
    (seed, n)."""
    import numpy as np
    rng = np.random.default_rng([seed, 1209])
    weighted = [t for t in TENANT_TABLES for _ in range(t[3])]
    out = []
    for i in range(n_queries):
        table, tenant, tier, _w = \
            weighted[int(rng.integers(len(weighted)))]
        shape = QUERY_SHAPES[int(rng.integers(len(QUERY_SHAPES)))]
        sql = shape.format(t=table, p=int(rng.integers(100, 1000)))
        out.append({"qid": f"rp{seed}_{i}", "table": table,
                    "tenant": tenant, "tier": tier, "sql": sql})
    return out


# -- recording --------------------------------------------------------------

def record_phase(client, mix: List[Dict[str, Any]], qps: float,
                 stats_path: Optional[str],
                 prefix: str = "") -> Dict[str, Any]:
    """Run the mix at 1x, paced at ``qps``; returns per-tier latency
    baselines and (local mode) writes the query_stats records the
    cluster broker would have written itself."""
    from ..utils import ledger as uledger
    lat: Dict[str, List[float]] = {}
    errors = 0
    t0 = time.perf_counter()
    for i, q in enumerate(mix):
        due = t0 + i / qps
        now = time.perf_counter()
        if due > now:
            time.sleep(due - now)
        sql = (f"{q['sql']} OPTION(timeoutMs={OPTION_TIMEOUT_MS},"
               f"queryId={prefix}{q['qid']}{client.extra_opt})")
        out = client.query(sql)
        if out.kind == "ok":
            lat.setdefault(q["tier"], []).append(out.ms)
            if stats_path is not None:
                # local mode writes the replay input itself — the SAME
                # validated query_stats contract the cluster broker's
                # forensics plane appends (arrival_ms per record)
                uledger.append_record(uledger.make_record(
                    "query_stats", qid=q["qid"], table=q["table"],
                    wall_ms=round(out.ms, 3), partial=False,
                    servers_queried=0, servers_responded=0,
                    exception_codes=[], sql=q["sql"],
                    tenant=q["tenant"],
                    arrival_ms=round((time.perf_counter() - t0) * 1e3,
                                     3)), stats_path)
        else:
            errors += 1
    return {"latencies": {t: sorted(v) for t, v in lat.items()},
            "errors": errors,
            "duration_s": time.perf_counter() - t0}


# -- the pure replay plan ---------------------------------------------------

def load_records(stats_path: str) -> List[Dict[str, Any]]:
    """query_stats records with the replay fields, arrival order."""
    records = []
    with open(stats_path) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("kind") == "query_stats" \
                    and rec.get("sql") and not rec.get("shed") \
                    and rec.get("arrival_ms") is not None:
                # the cluster broker records the FULL SQL including its
                # original OPTION clause; the replay appends its own
                # (fresh qid/timeout/retryAttempt), so strip the old one
                rec = dict(rec)
                rec["sql"] = rec["sql"].split(" OPTION(")[0].rstrip()
                records.append(rec)
    records.sort(key=lambda r: (float(r["arrival_ms"]), r.get("qid")))
    return records


def plan_replay(records: List[Dict[str, Any]], multiple: float,
                seed: int, capacity_qps: Optional[float] = None,
                tier_of: Optional[Dict[str, str]] = None
                ) -> Dict[str, Any]:
    """The PURE replay plan: schedule + rung pins + predicted shed
    stream, a function of (records, multiple, seed, capacity) only —
    no clocks, no randomness beyond the seeded deterministic draws.

    The offered-rate curve over the compressed schedule maps through
    ``OverloadGovernor.rung_for_pressure`` (the same watermark ladder
    live signals drive) into a rung per scheduled query; the pure shed
    ladder then decides each (qid, tenant, tier) — and each shed
    query's single retry is scheduled ``retryAfterMs`` later and
    decided the same way. Computing this twice MUST yield identical
    streams (the gate asserts it), and the live run's observed stream
    must match it exactly."""
    from ..broker.workload import (OverloadGovernor,
                                           retry_after_ms,
                                           shed_decision)
    if not records:
        return {"entries": [], "pins": {}, "shed_stream": [],
                "capacity_qps": 0.0}
    t_base = float(records[0]["arrival_ms"])
    span_ms = max(float(records[-1]["arrival_ms"]) - t_base, 1.0)
    if capacity_qps is None:
        recorded_qps = len(records) / (span_ms / 1e3)
        capacity_qps = recorded_qps * CAPACITY_HEADROOM
    offsets = [(float(r["arrival_ms"]) - t_base) / 1e3 / multiple
               for r in records]

    def pressure_at(t: float, sched: List[float]) -> float:
        lo = t - PRESSURE_WINDOW_S
        n = sum(1 for s in sched if lo < s <= t)
        return (n / PRESSURE_WINDOW_S) / capacity_qps

    entries: List[Dict[str, Any]] = []
    pins: Dict[str, int] = {}
    shed_stream: List[Tuple[str, str, int, str, int]] = []
    for r, off in zip(records, offsets):
        qid = f"{r['qid']}_x{seed}"
        tenant = r.get("tenant") or "default"
        tier = (tier_of or {}).get(tenant) or r.get("tier") \
            or "standard"
        rung = OverloadGovernor.rung_for_pressure(
            pressure_at(off, offsets))
        pins[qid] = rung
        entry = {"offset_s": off, "qid": qid, "sql": r["sql"],
                 "tenant": tenant, "tier": tier, "rung": rung,
                 "retry_attempt": 0}
        entries.append(entry)
        reason = shed_decision(qid, tenant, tier, rung)
        if reason is None:
            continue
        after = retry_after_ms(qid, tenant, rung)
        shed_stream.append((qid, tenant, rung, reason, after))
        # the client-side retry contract: one retry, retryAfterMs
        # later, marked retryAttempt=1 — decided by the same ladder
        r_qid = f"{qid}_r1"
        r_off = off + after / 1e3
        r_rung = OverloadGovernor.rung_for_pressure(
            pressure_at(r_off, offsets))
        pins[r_qid] = r_rung
        entries.append({"offset_s": r_off, "qid": r_qid, "sql": r["sql"],
                        "tenant": tenant, "tier": tier, "rung": r_rung,
                        "retry_attempt": 1, "retry_of": qid})
        r_reason = shed_decision(r_qid, tenant, tier, r_rung)
        if r_reason is not None:
            shed_stream.append((r_qid, tenant, r_rung, r_reason,
                                retry_after_ms(r_qid, tenant, r_rung)))
    entries.sort(key=lambda e: (e["offset_s"], e["qid"]))
    return {"entries": entries, "pins": pins,
            "shed_stream": sorted(shed_stream),
            "capacity_qps": capacity_qps}


# -- the pure SLO alert plan ------------------------------------------------

def plan_slo(records: List[Dict[str, Any]], plan: Dict[str, Any],
             multiple: float) -> Tuple[List[Dict[str, Any]],
                                       Dict[str, Any], float]:
    """The precomputed SLO burn-alert stream for the spike, pure in
    (records, plan, multiple): synthetic spike ``query_stats`` modeled
    from the replay plan — scheduled arrivals, recorded 1x walls x
    ``multiple``, the planned shed stream — fed through
    ``utils/slo.plan_alert_stream``. Same inputs => byte-identical
    output (the gate computes it twice and compares).

    Objectives are derived FROM the plan so the verdict has margin:
    availability budget = half the planned besteffort shed fraction
    (final burn 2.0x by construction — fires decisively — while the
    protected tenant burns 0.0x), and the latency bar sits at 1.5x the
    recorded p50, which the ``multiple``x-modeled walls overrun.

    -> (objectives, plan_alert_stream output, besteffort shed frac)."""
    walls = {str(r["qid"]): float(r.get("wall_ms", 1.0))
             for r in records}
    shed_qids = {s[0] for s in plan["shed_stream"]}
    srecs: List[Dict[str, Any]] = []
    for e in plan["entries"]:
        base = e["qid"].split("_x")[0]   # rpSEED_i[_xSEED[_r1]]
        srecs.append({
            "tenant": e["tenant"],
            "arrival_ms": round(e["offset_s"] * 1e3, 3),
            "wall_ms": round(walls.get(base, 1.0) * multiple, 3),
            "shed": e["qid"] in shed_qids})
    be = [r for r in srecs if r["tenant"] == "ten_besteffort"]
    frac = (sum(1 for r in be if r["shed"]) / len(be)) if be else 0.0
    objectives: List[Dict[str, Any]] = []
    if 0.0 < frac < 1.0:
        avail_obj = 1.0 - frac / 2.0
        for tenant in ("ten_besteffort", "ten_protected"):
            objectives.append({
                "scope": f"tenant:{tenant}", "kind": "availability",
                "objective": round(avail_obj, 6),
                "fast_s": SLO_FAST_S, "slow_s": SLO_SLOW_S,
                "burn_threshold": SLO_BURN_THRESHOLD})
    sorted_walls = sorted(walls.values())
    bar = _pctl(sorted_walls, 0.5) * 1.5 if sorted_walls else 100.0
    for tenant in ("ten_besteffort", "ten_standard"):
        objectives.append({
            "scope": f"tenant:{tenant}", "kind": "latency",
            "bar_ms": round(bar, 3),
            "fast_s": SLO_FAST_S, "slow_s": SLO_SLOW_S,
            "burn_threshold": SLO_BURN_THRESHOLD})
    from ..utils.slo import plan_alert_stream
    return objectives, plan_alert_stream(srecs, objectives), frac


# -- the spike --------------------------------------------------------------

def run_spike(client, plan: Dict[str, Any], workers: int = 8
              ) -> Dict[str, Any]:
    """Dispatch the plan on schedule (pins already installed by the
    caller). Retries are REACTIVE: a worker that receives a shed
    honors the RESPONSE's retryAfterMs — the plan's precomputed retry
    entries are only the prediction it is checked against."""
    lat: Dict[str, List[float]] = {}
    sheds: List[Tuple[str, str, int, str, int]] = []
    errors: Dict[str, int] = {}
    structured = [0, 0]   # well-formed 429 payloads, malformed sheds
    submitted = [0]
    lock = threading.Lock()
    sem = threading.Semaphore(workers)
    threads: List[threading.Thread] = []
    t0 = time.perf_counter()

    def fire(entry: Dict[str, Any]) -> None:
        sql = (f"{entry['sql']} OPTION("
               f"timeoutMs={OPTION_TIMEOUT_MS},"
               f"queryId={entry['qid']},"
               f"retryAttempt={entry['retry_attempt']}"
               f"{client.extra_opt})")
        with lock:
            submitted[0] += 1
        out = client.query(sql)
        if out.kind == "ok":
            with lock:
                lat.setdefault(entry["tier"], []).append(out.ms)
            return
        if out.kind == "error":
            with lock:
                errors[entry["tier"]] = \
                    errors.get(entry["tier"], 0) + 1
            return
        p = out.payload
        well_formed = (p.get("errorCode") == 429
                       and isinstance(p.get("retryAfterMs"), int)
                       and p.get("retryAfterMs") > 0)
        with lock:
            structured[0 if well_formed else 1] += 1
            sheds.append((entry["qid"], p.get("tenant") or "?",
                          int(p.get("rung") or 0),
                          p.get("reason") or "?",
                          int(p.get("retryAfterMs") or 0)))
        if entry["retry_attempt"] == 0 and well_formed:
            # honor the response: wait retryAfterMs, retry once
            time.sleep(p["retryAfterMs"] / 1e3)
            fire({**entry, "qid": f"{entry['qid']}_r1",
                  "retry_attempt": 1})

    def dispatch(entry: Dict[str, Any]) -> None:
        try:
            fire(entry)
        finally:
            sem.release()

    for entry in plan["entries"]:
        if entry["retry_attempt"]:
            continue  # reactive retries only — predictions not replayed
        due = t0 + entry["offset_s"]
        now = time.perf_counter()
        if due > now:
            time.sleep(due - now)
        sem.acquire()
        th = threading.Thread(target=dispatch, args=(entry,),
                              daemon=True)
        threads.append(th)
        th.start()
    for th in threads:
        th.join(timeout=130.0)
    wall = time.perf_counter() - t0
    return {"latencies": {t: sorted(v) for t, v in lat.items()},
            "sheds": sorted(sheds), "errors": errors,
            "submitted": submitted[0],
            "structured_429": structured[0],
            "malformed_sheds": structured[1],
            "duration_s": wall}


# -- the gate ---------------------------------------------------------------

def run_gate(multiple: float = 4.0, seed: int = 20260805,
             n_queries: int = 48, rows: int = 4096,
             mode: str = "cluster", chaos: bool = True,
             record_qps: float = 24.0,
             ledger_out: Optional[str] = None,
             keep_dir: Optional[str] = None,
             device: Any = "cuda") -> Dict[str, Any]:
    """The full closed loop (module docstring) on ``device``. Returns
    the summary dict; ``ok`` is the gate verdict. Resets the
    process-global workload/governor state around the run, and leaves
    no fault plan armed and no rung pinned."""
    from ..broker.workload import (global_governor,
                                           global_workload)
    from ..utils import faults
    from ..utils import ledger as uledger
    from ..utils.slo import (global_incidents, global_slo,
                                     normalize_alerts)

    tmp = keep_dir or tempfile.mkdtemp(prefix="ptpu_replay_")
    failures: List[str] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        if not ok:
            failures.append(f"{name}: {detail}")

    global_workload.reset()
    faults.clear()
    stop = None
    local = None
    summary: Dict[str, Any] = {
        "mode": mode, "scenario": "overload_replay", "seed": seed,
        "multiple": multiple, "queries_recorded": n_queries}
    try:
        configure_tenants()
        stats_path = os.path.join(tmp, "replay_stats.jsonl")
        if mode == "cluster":
            _ctrl, _servers, broker, stop = build_cluster(
                tmp, rows, device=device)
            stats_path = broker.forensics.ledger_path
            client = _ClusterClient(broker.url)
            p0 = _servers[0].port
            chaos_plan_text = (
                f"seed={seed}; "
                f"segment.slow: match=server_0, delay_ms=40, times=8; "
                f"rpc.drop: match=:{p0}/query/bin, times=1")
        elif mode == "local":
            broker = local = build_local(tmp, rows, device=device)
            client = _LocalClient(broker)
            # local-mode chaos is armed AFTER the plan is computed: an
            # accountant OOM kill targeted at one ADMITTED besteffort
            # query (the watcher-kill story under pressure; protected
            # must still see zero kills)
            chaos_plan_text = None
        else:
            raise ValueError(f"unknown mode {mode!r}")

        mix = build_mix(seed, n_queries)
        # warmup: every (table, shape) pays its first-use costs (kernel
        # builds, plan caches) outside the measured phases
        seen = set()
        for q in mix:
            key = (q["table"], q["sql"].split("FROM")[0])
            if key in seen:
                continue
            seen.add(key)
            client.query(f"{q['sql']} OPTION("
                         f"timeoutMs={OPTION_TIMEOUT_MS},"
                         f"queryId=warm_{len(seen)}"
                         f"{client.extra_opt})")

        # 1) record at 1x — the replay input + the pre-spike baseline
        pre = record_phase(
            client, mix, record_qps,
            stats_path if mode == "local" else None)
        check("record.errors", pre["errors"] == 0,
              f"{pre['errors']} errors during the 1x recording")
        records = [r for r in load_records(stats_path)
                   if str(r.get("qid", "")).startswith(f"rp{seed}_")]
        check("record.count", len(records) >= n_queries * 0.9,
              f"only {len(records)} of {n_queries} recorded")

        # 2) the pure plan, computed twice — must match itself
        tier_of = {t[1]: t[2] for t in TENANT_TABLES}
        plan = plan_replay(records, multiple, seed, tier_of=tier_of)
        plan2 = plan_replay(records, multiple, seed, tier_of=tier_of)
        deterministic = (plan["shed_stream"] == plan2["shed_stream"]
                         and plan["pins"] == plan2["pins"])
        check("plan.deterministic", deterministic,
              "two same-seed plans diverged")
        check("plan.sheds_besteffort",
              any(s[1] == "ten_besteffort"
                  for s in plan["shed_stream"]),
              "the 4x plan shed no besteffort query — raise multiple")
        check("plan.protected_never_shed",
              all(s[1] != "ten_protected" for s in plan["shed_stream"]),
              "plan shed a protected query")

        # 2b) the pure SLO alert plan, computed twice — byte-identical
        # (utils/slo.plan_alert_stream: same corpus => same alert
        # stream: the determinism contract)
        slo_objs, slo_plan, be_frac = plan_slo(records, plan, multiple)
        slo_plan2 = plan_slo(records, plan, multiple)[1]
        slo_deterministic = (
            json.dumps(slo_plan, sort_keys=True)
            == json.dumps(slo_plan2, sort_keys=True))
        check("slo.plan_deterministic", slo_deterministic,
              "two same-input SLO alert plans diverged")
        check("slo.plan_alerts", len(slo_plan["alerts"]) >= 1,
              "the 4x SLO plan fired no burn alert — raise multiple")
        planned_avail = sorted({
            x for x in normalize_alerts(slo_plan["alerts"])
            if x[2] == "availability"})
        check("slo.plan_besteffort_burns",
              any(x[1] == "tenant:ten_besteffort"
                  for x in planned_avail),
              "planned availability burn missed the shed tenant")
        check("slo.plan_protected_never_burns",
              all(x[1] != "tenant:ten_protected"
                  for x in normalize_alerts(slo_plan["alerts"])),
              "the plan burned the protected tenant's budget")
        # live SLO plane: armed with the plan's availability objectives
        # only (live wall clocks are nondeterministic — the latency
        # objectives stay plan-side); fed by the cluster broker's
        # forensics plane per completed/shed query
        slo_live = mode == "cluster"
        if slo_live:
            global_slo.clear()
            global_incidents.reset()
            for spec in slo_objs:
                if spec["kind"] == "availability":
                    global_slo.set_objective(**spec)

        if mode == "local" and chaos:
            shed_qids = {s0[0] for s0 in plan["shed_stream"]}
            victim = next(
                (e["qid"] for e in plan["entries"]
                 if e["tier"] == "besteffort"
                 and not e["retry_attempt"]
                 and e["qid"] not in shed_qids), None)
            check("plan.oom_victim", victim is not None,
                  "no admitted besteffort query to target with "
                  "accounting.oom_kill")
            chaos_plan_text = (
                f"seed={seed}; accounting.oom_kill: match={victim}, "
                f"times=1") if victim else None

        # 3) the spike: pins + chaos armed, replay on schedule
        global_workload.clear_shed_log()
        global_governor.pin_rungs(plan["pins"])
        fault_plan = faults.install(chaos_plan_text) \
            if chaos and chaos_plan_text else None
        try:
            spike = run_spike(client, plan)
        finally:
            fired = len(fault_plan.fired) if fault_plan else 0
            faults.clear()
            global_governor.unpin()
        observed = [s for s in global_workload.shed_stream()
                    if s[0] in plan["pins"]]

        # 4) verify
        check("spike.stream_matches_plan",
              observed == plan["shed_stream"],
              f"observed {len(observed)} shed(s) != planned "
              f"{len(plan['shed_stream'])}")
        client_seen = sorted(s[0] for s in spike["sheds"])
        planned_qids = sorted(s[0] for s in plan["shed_stream"])
        check("spike.client_saw_every_shed",
              client_seen == planned_qids,
              f"client saw {len(client_seen)} shed responses, "
              f"planned {len(planned_qids)}")
        check("spike.structured_429",
              spike["malformed_sheds"] == 0
              and spike["structured_429"] == len(spike["sheds"]),
              f"{spike['malformed_sheds']} shed responses were not "
              "structured 429s")
        check("spike.protected_zero_sheds",
              not any(s[1] == "ten_protected" for s in observed),
              "a protected-tenant query was shed")
        check("spike.protected_zero_errors",
              spike["errors"].get("protected", 0) == 0,
              f"{spike['errors'].get('protected', 0)} protected "
              "errors (OOM-kill/5xx) during the spike")
        pre_prot = pre["latencies"].get("protected") or [0.0]
        prot = spike["latencies"].get("protected") or []
        prot_bar = (_pctl(pre_prot, 0.99) * PROTECTED_BAR_FACTOR
                    + PROTECTED_BAR_FLOOR_MS)
        prot_p99 = _pctl(prot, 0.99) if prot else 0.0
        check("spike.protected_completed", len(prot) >= 1,
              "no protected query completed during the spike")
        check("spike.protected_p99_bar", prot_p99 <= prot_bar,
              f"protected p99 {prot_p99:.1f}ms > bar {prot_bar:.1f}ms")
        if chaos:
            check("spike.chaos_fired", fired >= 1,
                  "the armed chaos plan never fired")

        # 4b) live SLO verdicts (cluster mode): the live availability
        # alert set must match the precomputed plan's — compared on the
        # normalized (alert, scope, kind, severity) projection, the
        # shed-stream discipline (ts/proc/burn magnitudes are process
        # identity and jitter, not decisions)
        live_avail: List[Any] = []
        incidents_count = 0
        if slo_live:
            global_incidents.drain(5.0)
            live_avail = sorted({
                x for x in normalize_alerts(global_slo.alerts.alerts())
                if x[0] == "slo_burn" and x[2] == "availability"})
            check("slo.live_matches_plan", live_avail == planned_avail,
                  f"live availability alerts {live_avail} != "
                  f"planned {planned_avail}")
            blk = global_slo.status_block()
            prot = next(
                (r for r in blk["objectives"]
                 if r["scope"] == "tenant:ten_protected"
                 and r["kind"] == "availability"), None)
            check("slo.protected_budget_intact",
                  prot is not None and prot["burn_slow"] == 0.0
                  and prot["budget_remaining"] == 1.0,
                  f"protected error budget dented: {prot}")
            inc = global_incidents.snapshot()
            incidents_count = inc["count"]
            check("slo.incident_captured", incidents_count >= 1,
                  "no incident bundle captured on the burn alert")
            if inc["incidents"]:
                first = inc["incidents"][0]
                verr = uledger.validate_record(first)
                check("slo.incident_valid", not verr,
                      f"incident bundle violates the ledger "
                      f"contract: {verr}")
                # no "compile" surface: the port has no compile plane
                check("slo.incident_surfaces",
                      {"slow_queries", "overload", "tier", "devmem",
                       "slo"}
                      <= set(first.get("surfaces") or {}),
                      f"incident bundle missing surfaces: "
                      f"{sorted(first.get('surfaces') or {})}")

        # 5) recovery: fresh 1x pass must land inside the noise floor
        post_mix = [{**q, "qid": q["qid"] + "_post"} for q in mix]
        post = record_phase(client, post_mix, record_qps, None)
        pre_all = sorted(x for v in pre["latencies"].values()
                         for x in v)
        post_all = sorted(x for v in post["latencies"].values()
                          for x in v)
        pre_p50 = _pctl(pre_all, 0.5)
        post_p50 = _pctl(post_all, 0.5)
        recover_bar = pre_p50 * RECOVER_FACTOR + RECOVER_FLOOR_MS
        recovered = bool(post_all) and post_p50 <= recover_bar
        check("recovery", recovered,
              f"post-spike p50 {post_p50:.1f}ms > bar "
              f"{recover_bar:.1f}ms (pre {pre_p50:.1f}ms) — "
              "metastable state?")

        # 5b) the post-spike good traffic drained the 1s fast window,
        # so the paired-window level dropped below threshold and the
        # latched burn alert CLEARED — no stale page after recovery
        if slo_live:
            blk = global_slo.status_block()
            be = next(
                (r for r in blk["objectives"]
                 if r["scope"] == "tenant:ten_besteffort"
                 and r["kind"] == "availability"), None)
            check("slo.recovery_burn_cleared",
                  be is not None and not be["alerting"]
                  and be["burn_fast"] == 0.0,
                  f"burn alert latched past recovery: {be}")

        completed = sum(len(v) for v in spike["latencies"].values())
        shed_by_tenant: Dict[str, int] = {}
        shed_by_rung: Dict[str, int] = {}
        shed_by_reason: Dict[str, int] = {}
        for _qid, tn, rung, reason, _after in observed:
            shed_by_tenant[tn] = shed_by_tenant.get(tn, 0) + 1
            shed_by_rung[str(rung)] = shed_by_rung.get(str(rung), 0) + 1
            shed_by_reason[reason] = shed_by_reason.get(reason, 0) + 1
        tiers = {}
        for tier in ("protected", "standard", "besteffort"):
            lat = spike["latencies"].get(tier) or []
            tiers[tier] = {
                "completed": len(lat),
                "p50_ms": round(_pctl(lat, 0.5), 3),
                "p99_ms": round(_pctl(lat, 0.99), 3),
                "errors": spike["errors"].get(tier, 0),
            }
        summary.update({
            "backend": _backend(device),
            "offered": spike["submitted"],
            "completed": completed,
            "shed": len(observed),
            "shed_by_tenant": shed_by_tenant,
            "shed_by_rung": shed_by_rung,
            "shed_by_reason": shed_by_reason,
            "tiers": tiers,
            "structured_429": spike["structured_429"],
            "retries": len([s for s in spike["sheds"]
                            if s[0].endswith("_r1")]),
            "deterministic": bool(deterministic
                                  and observed == plan["shed_stream"]),
            "protected_sheds": shed_by_tenant.get("ten_protected", 0),
            "protected_p99_ms": round(prot_p99, 3),
            "protected_bar_ms": round(prot_bar, 3),
            "goodput_qps": round(
                completed / max(spike["duration_s"], 1e-3), 3),
            "duration_s": round(spike["duration_s"], 3),
            "spike_errors": sum(spike["errors"].values()),
            "chaos": chaos,
            "faults_fired": fired,
            "recovered": recovered,
            "recovery": {"pre_p50_ms": round(pre_p50, 3),
                         "post_p50_ms": round(post_p50, 3),
                         "bar_ms": round(recover_bar, 3)},
            "extra": {"slo": {
                "plan_deterministic": slo_deterministic,
                "alerts_planned": len(slo_plan["alerts"]),
                "planned_availability": [list(x) for x in planned_avail],
                "live_availability": [list(x) for x in live_avail],
                "live": slo_live,
                "incidents": incidents_count,
                "besteffort_shed_frac": round(be_frac, 4),
            }},
            "ok": not failures,
        })
        if failures:
            summary["error"] = "; ".join(failures[:4])
        if ledger_out:
            contract = uledger.KINDS["replay_bench"]
            allowed = contract["required"] | contract["optional"]
            rec = uledger.make_record("replay_bench", **{
                k: v for k, v in summary.items() if k in allowed})
            uledger.append_record(rec, ledger_out)
        summary["failures"] = failures
        return summary
    finally:
        faults.clear()
        global_governor.unpin()
        global_workload.reset()
        global_slo.clear()
        global_slo.path = None     # the tmp ledger dir is about to go
        global_incidents.reset()
        global_incidents.path = None
        if stop is not None:
            stop()
        if local is not None:
            retire_segments(local)
        if keep_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)


# -- rebalance gate -----------------------------------------------------------
# The closed-loop rebalance replay: record a skewed mix, burn the hot
# table's latency SLO with donor-only chaos, precompute the pure move
# plan, let the rebalancer execute it, and verify the observed move
# stream equals the plan byte-for-byte, digests never drift across the
# cutover, the protected table's p99 stays inside its bar, and the burn
# is measurably lower after convergence WITHOUT shifting to the
# receiver (the donor-matched chaos stays armed the whole time — the
# burn drops because placement moved, not because the fault cleared).

REBALANCE_TABLES = (("rb_hot", 3), ("rb_prot", 2))
REBALANCE_DELAY_MS = 40.0
# hot-table SLO bar, self-calibrated between the pre-chaos p99 and the
# injected +40ms: above noise, below the slowed donor
REBALANCE_BAR_FACTOR = 1.25
REBALANCE_BAR_FLOOR_MS = 15.0
# burn windows sized like the overload gate's: the slow window outlives
# the burn phase but drains within seconds of post-cutover good traffic
REBALANCE_FAST_S = 1.0
REBALANCE_SLOW_S = 6.0
REBALANCE_DRAIN_TIMEOUT_S = 20.0


def build_rebalance_cluster(tmp: str, rows: int = 2048,
                            poll: float = 0.1, device: Any = "cuda"):
    """Controller + 2 servers on ``device`` + broker with engineered
    skew: ``rb_hot``
    lands wholly on server_0 (added while it is the only live server),
    ``rb_prot`` lands on server_1 (least-loaded placement after it
    joins) — the donor/receiver geometry the closed loop must fix."""
    from ..cluster import BrokerNode, Controller, ServerNode
    from ..segment import SegmentBuilder
    from ..spi import TableConfig

    ctrl = Controller(os.path.join(tmp, "ctrl"), heartbeat_timeout=5.0,
                      reconcile_interval=0.2)
    servers = [ServerNode("server_0", ctrl.url, poll_interval=poll,
                          device=device)]
    cols = _gen_columns(rows)

    def add(table: str, n_segments: int) -> None:
        schema = _schema(table)
        builder = SegmentBuilder(schema, TableConfig(table))
        ctrl.add_table(table, schema.to_dict(), replication=1)
        step = rows // n_segments
        for i in range(n_segments):
            lo = i * step
            hi = rows if i == n_segments - 1 else (i + 1) * step
            d = builder.build({n: v[lo:hi] for n, v in cols.items()},
                              os.path.join(tmp, table), f"seg_{i}")
            ctrl.add_segment(table, f"seg_{i}", d)

    add(*REBALANCE_TABLES[0])   # all on server_0 (the future donor)
    v = ctrl.routing_snapshot()["version"]
    assert servers[0].wait_for_version(v, timeout=30.0), \
        "server_0 never synced"
    servers.append(ServerNode("server_1", ctrl.url, poll_interval=poll,
                              device=device))
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and len(ctrl.live_servers()) < 2:
        time.sleep(0.05)
    assert len(ctrl.live_servers()) >= 2, "server_1 never registered"
    add(*REBALANCE_TABLES[1])   # least-loaded -> server_1
    broker = BrokerNode(ctrl.url, routing_refresh=poll)
    v = ctrl.routing_snapshot()["version"]
    for s in servers:
        assert s.wait_for_version(v, timeout=30.0), "server never synced"
    assert broker.wait_for_version(v, timeout=30.0), "broker never synced"
    # park the scheduled pass: every rebalance pass in this gate is a
    # deliberate, manually-triggered phase
    ctrl.scheduler._next_run[ctrl.rebalancer.NAME] = \
        time.monotonic() + 1e9

    def stop():
        stop_cluster(ctrl, servers, broker)

    return ctrl, servers, broker, stop


def build_rebalance_mix(seed: int, n_queries: int
                        ) -> List[Dict[str, Any]]:
    """The seeded (qid, table, sql) sequence — pure in (seed, n), hot
    table weighted 2:1 so the burn signal dominates the mix."""
    import numpy as np
    rng = np.random.default_rng([seed, 1906])
    weighted = ["rb_hot", "rb_hot", "rb_prot"]
    out = []
    for i in range(n_queries):
        table = weighted[int(rng.integers(len(weighted)))]
        shape = QUERY_SHAPES[int(rng.integers(len(QUERY_SHAPES)))]
        sql = shape.format(t=table, p=int(rng.integers(100, 1000)))
        out.append({"qid": f"rbm{seed}_{i}", "table": table,
                    "sql": sql})
    return out


def _rb_phase(broker_url: str, mix: List[Dict[str, Any]], tag: str,
              qps: float) -> Dict[str, Any]:
    """Run the mix once, paced at ``qps``: per-table latencies + the
    per-qid result digest (the drift detector across cutovers)."""
    from ..cluster.http_util import http_json
    lat: Dict[str, List[float]] = {}
    digests: Dict[str, str] = {}
    errors = 0
    t_start = time.perf_counter()
    for i, q in enumerate(mix):
        target = t_start + i / qps
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        sql = (f"{q['sql']} OPTION(timeoutMs={OPTION_TIMEOUT_MS},"
               f"queryId={tag}_{q['qid']})")
        t0 = time.perf_counter()
        try:
            resp = http_json("POST", f"{broker_url}/query/sql",
                             {"sql": sql}, timeout=120.0)
        except Exception:  # noqa: BLE001 — counted, not raised
            errors += 1
            continue
        lat.setdefault(q["table"], []).append(
            (time.perf_counter() - t0) * 1e3)
        digests[q["qid"]] = json.dumps(
            (resp or {}).get("resultTable"), sort_keys=True)
    return {"lat": {t: sorted(v) for t, v in lat.items()},
            "digests": digests, "errors": errors,
            "duration_s": time.perf_counter() - t_start}


def run_rebalance_gate(seed: int = 20260807, n_queries: int = 24,
                       rows: int = 2048, qps: float = 12.0,
                       ledger_out: Optional[str] = None,
                       device: Any = "cuda") -> Dict[str, Any]:
    """The closed-loop rebalance gate (section comment above) on
    ``device``. Returns the summary dict; ``ok`` is the verdict."""
    from ..cluster.rebalancer import plan_moves
    from ..engine.tier import global_tier
    from ..utils import faults
    from ..utils import ledger as uledger
    from ..utils.metrics import global_metrics
    from ..utils.slo import global_incidents, global_slo

    tmp = tempfile.mkdtemp(prefix="ptpu_rebalance_")
    failures: List[str] = []
    summary: Dict[str, Any] = {
        "scenario": "rebalance_replay", "seed": seed, "multiple": 1.0,
        "queries_recorded": n_queries, "mode": "cluster"}

    def check(name: str, ok: bool, detail: str = "") -> None:
        if not ok:
            failures.append(f"{name}: {detail}")

    faults.clear()
    global_slo.clear()
    global_incidents.reset()
    global_tier.configure(budget_bytes=None)
    stop = None
    try:
        ctrl, servers, broker, stop = build_rebalance_cluster(
            tmp, rows, device=device)
        rb = ctrl.rebalancer
        rb.budget_moves = 8          # one pass moves every hot segment
        rb.budget_bytes = 1 << 30
        rb.prewarm_timeout = 15.0
        mix = build_rebalance_mix(seed, n_queries)

        def holders() -> Dict[str, List[str]]:
            with ctrl._lock:
                return {s: list(h) for s, h in
                        ctrl._state["assignment"]["rb_hot"].items()}

        check("skew.initial",
              all(h == ["server_0"] for h in holders().values()),
              f"hot table not pinned to the donor: {holders()}")

        # warmup: every (table, shape) pays its first-use costs
        # off-phase
        seen = set()
        for q in mix:
            key = (q["table"], q["sql"].split("FROM")[0])
            if key in seen:
                continue
            seen.add(key)
            _rb_phase(broker.url, [q], f"warm{len(seen)}", qps=1e9)

        # 1) record at 1x: the latency baseline + the digest corpus
        base = _rb_phase(broker.url, mix, "base", qps)
        check("record.errors", base["errors"] == 0,
              f"{base['errors']} errors during the 1x recording")
        hot_bar = (_pctl(base["lat"].get("rb_hot") or [0.0], 0.99)
                   * REBALANCE_BAR_FACTOR + REBALANCE_BAR_FLOOR_MS)
        prot_bar = (_pctl(base["lat"].get("rb_prot") or [0.0], 0.99)
                    * PROTECTED_BAR_FACTOR + PROTECTED_BAR_FLOOR_MS)
        check("record.bar_below_delay",
              hot_bar < _pctl(base["lat"].get("rb_hot") or [0.0], 0.5)
              + REBALANCE_DELAY_MS,
              f"bar {hot_bar:.1f}ms cannot separate the slowed donor")

        # 2) burn: donor-only chaos stays armed from here to the END —
        # the later burn drop must come from the cutover, not disarming
        global_slo.set_objective("rb_hot", "latency", bar_ms=hot_bar,
                                 objective=0.9,
                                 fast_s=REBALANCE_FAST_S,
                                 slow_s=REBALANCE_SLOW_S)
        global_slo.set_objective("rb_prot", "latency", bar_ms=prot_bar,
                                 objective=0.9,
                                 fast_s=REBALANCE_FAST_S,
                                 slow_s=REBALANCE_SLOW_S)
        fault_plan = faults.install(
            f"seed={seed}; segment.slow: match=server_0, "
            f"delay_ms={REBALANCE_DELAY_MS:.0f}, times=-1")
        burn = _rb_phase(broker.url, mix, "burn", qps)
        for qid, d in burn["digests"].items():
            check(f"digest.burn.{qid}", d == base["digests"].get(qid),
                  "digest drift under donor chaos")
        prot_burn = burn["lat"].get("rb_prot") or []
        check("burn.protected_p99",
              prot_burn and _pctl(prot_burn, 0.99) <= prot_bar,
              f"protected p99 {_pctl(prot_burn, 0.99):.1f}ms > bar "
              f"{prot_bar:.1f}ms during the burn")

        def _burn(scope: str) -> Dict[str, Any]:
            return next(
                (r for r in global_slo.status_block()["objectives"]
                 if r["scope"] == scope and r["kind"] == "latency"),
                {"burn_slow": 0.0, "burn_fast": 0.0, "alerting": False})

        burn_before = _burn("rb_hot")["burn_slow"]
        check("burn.ignited",
              burn_before >= rb.burn_threshold,
              f"hot-table burn {burn_before:.2f} never crossed "
              f"{rb.burn_threshold}")
        # the burn alert captured an incident; acknowledge it (the
        # freeze lever belongs to chaos_smoke --rebalance) and roll up
        global_incidents.reset()
        ctrl.rollup.run()
        rollup = (ctrl.rollup.snapshot() or {}).get("rollup")

        # 3) the pure plan, computed twice — must match itself, and the
        # executed move stream must match it byte-for-byte
        inputs = rb._plan_inputs()
        kw = dict(budget=rb._budget(), instances=inputs["instances"],
                  sizes=inputs["sizes"], recent=frozenset(),
                  threshold=rb.burn_threshold)
        expected = plan_moves(rollup, inputs["assignment"], **kw)
        expected2 = plan_moves(rollup, inputs["assignment"], **kw)
        proj = ("table", "segment", "donor", "receiver", "bytes",
                "reason")
        as_bytes = lambda moves: json.dumps(  # noqa: E731
            [{k: m[k] for k in proj} for m in moves], sort_keys=True)
        check("plan.deterministic",
              as_bytes(expected) == as_bytes(expected2),
              "two same-input plans diverged")
        check("plan.moves", len(expected) == REBALANCE_TABLES[0][1],
              f"planned {len(expected)} of {REBALANCE_TABLES[0][1]} "
              f"hot segments: {expected}")
        check("plan.geometry",
              all(m["donor"] == "server_0"
                  and m["receiver"] == "server_1" for m in expected),
              f"plan left the donor/receiver geometry: {expected}")

        ring_before = len(rb.snapshot()["moves"])
        res = rb.run()
        check("cutover.executed",
              not res["frozen"] and res["planned"] == len(expected)
              and res["executed"] == len(expected),
              f"pass did not execute the plan: {res}")
        events = rb.snapshot()["moves"][ring_before:]
        observed = [{k: e[k] for k in proj} for e in events
                    if e["phase"] == "plan"]
        check("cutover.stream_matches_plan",
              json.dumps(observed, sort_keys=True) == as_bytes(expected),
              f"observed move stream != plan "
              f"({len(observed)} vs {len(expected)} moves)")
        flipped = sorted(e["segment"] for e in events
                         if e["phase"] == "flip")
        check("cutover.flips",
              flipped == sorted(m["segment"] for m in expected),
              f"flips {flipped} != plan")
        v = ctrl.routing_snapshot()["version"]
        check("cutover.converged",
              broker.wait_for_version(v, timeout=15.0)
              and all(s.wait_for_version(v, timeout=15.0)
                      for s in servers),
              "cluster never converged on the flipped assignment")
        check("cutover.placement",
              all(h == ["server_1"] for h in holders().values()),
              f"hot table not on the receiver: {holders()}")

        # 4) after: chaos STILL armed on the donor; queries now route
        # to the receiver, so latency recovers and the burn drains
        c0 = global_metrics.snapshot()["counters"]
        after = _rb_phase(broker.url, mix, "after", qps)
        for qid, d in after["digests"].items():
            check(f"digest.after.{qid}", d == base["digests"].get(qid),
                  "digest drift across the cutover")
        hot_after = after["lat"].get("rb_hot") or []
        check("after.hot_inside_bar",
              hot_after and _pctl(hot_after, 0.99) <= hot_bar,
              f"hot p99 {_pctl(hot_after, 0.99):.1f}ms still over the "
              f"bar {hot_bar:.1f}ms after the cutover")
        prot_after = after["lat"].get("rb_prot") or []
        check("after.protected_p99",
              prot_after and _pctl(prot_after, 0.99) <= prot_bar,
              f"protected p99 {_pctl(prot_after, 0.99):.1f}ms > bar "
              f"{prot_bar:.1f}ms after the cutover")
        # the receiver's first touch per drained segment re-promotes
        # from WARM arrays (no cold re-pad): bounded, then zero
        c1 = global_metrics.snapshot()["counters"]
        promo_after = (c1.get("tier_promotions", 0)
                       - c0.get("tier_promotions", 0))
        check("after.promotions_bounded",
              promo_after <= len(expected),
              f"{promo_after} promotions for {len(expected)} drained "
              "segments — cold re-pads?")
        settle = _rb_phase(broker.url, mix, "settle", qps)
        for qid, d in settle["digests"].items():
            check(f"digest.settle.{qid}", d == base["digests"].get(qid),
                  "digest drift at steady state")
        c2 = global_metrics.snapshot()["counters"]
        promo_settle = (c2.get("tier_promotions", 0)
                        - c1.get("tier_promotions", 0))
        check("settle.no_rewarm", promo_settle == 0,
              f"{promo_settle} promotions at steady state — the "
              "pre-warm did not pay the receiver's warmup debt")

        # 5) burn convergence: measurably lower on the hot table, NOT
        # shifted to the receiver's protected table
        deadline = time.monotonic() + REBALANCE_DRAIN_TIMEOUT_S
        hot = _burn("rb_hot")
        while time.monotonic() < deadline and \
                (hot["burn_fast"] > 0.0
                 or hot["burn_slow"] >= burn_before * 0.5):
            time.sleep(0.25)
            hot = _burn("rb_hot")
        check("converge.burn_lower",
              hot["burn_slow"] < burn_before * 0.5
              and hot["burn_fast"] == 0.0,
              f"burn {hot['burn_slow']:.2f} (was {burn_before:.2f}) "
              "never drained after the cutover")
        prot = _burn("rb_prot")
        check("converge.not_shifted",
              prot["burn_slow"] < rb.burn_threshold
              and not prot["alerting"],
              f"burn shifted to the receiver: {prot}")

        summary.update({
            "backend": _backend(device),
            "offered": 4 * n_queries,
            "completed": 4 * n_queries
            - sum(p["errors"] for p in (base, burn, after, settle)),
            "shed": 0,
            "goodput_qps": round(
                len(after["digests"])
                / max(after["duration_s"], 1e-3), 3),
            "duration_s": round(base["duration_s"] + burn["duration_s"]
                                + after["duration_s"]
                                + settle["duration_s"], 3),
            "faults_fired": len(fault_plan.fired),
            "chaos": True,
            "deterministic": as_bytes(expected) == as_bytes(expected2),
            "extra": {"rebalance": {
                "moves_planned": len(expected),
                "moves_executed": res["executed"],
                "burn_before": round(burn_before, 3),
                "burn_after": round(hot["burn_slow"], 3),
                "receiver_burn": round(prot["burn_slow"], 3),
                "hot_bar_ms": round(hot_bar, 3),
                "promotions_after": promo_after,
                "promotions_settle": promo_settle,
            }},
            "ok": not failures,
        })
        if failures:
            summary["error"] = "; ".join(failures[:4])
        if ledger_out:
            contract = uledger.KINDS["replay_bench"]
            allowed = contract["required"] | contract["optional"]
            rec = uledger.make_record("replay_bench", **{
                k: v for k, v in summary.items() if k in allowed})
            uledger.append_record(rec, ledger_out)
        summary["failures"] = failures
        return summary
    finally:
        faults.clear()
        global_slo.clear()
        global_slo.path = None
        global_incidents.reset()
        global_incidents.path = None
        if stop is not None:
            stop()
        shutil.rmtree(tmp, ignore_errors=True)


# -- the incident-autopsy gate ----------------------------------------------
#
# Three passes over ONE warmed cluster, each sliced out of the broker's
# ledger by sequence: a clean pass must yield an EXPLICIT inconclusive
# verdict, then two injected causes — donor-only ``segment.slow``
# chaos and a starved device-budget tier thrash — must each be named
# top-1 with every competing cause scored strictly lower, and each
# verdict computed twice must be byte-identical (``plan_autopsy`` is
# pure, so the same corpus can never rank differently). The JAX gate's
# fourth pass, a cleared-cache compile storm, has no counterpart: the
# port has no compile plane.

AUTOPSY_TABLE = "ap_events"
AUTOPSY_DELAY_MS = 60.0
# far below one segment column: every admission demotes everything else
AUTOPSY_TIER_BUDGET_BYTES = 4096


def build_autopsy_cluster(tmp: str, rows: int = 1024,
                          poll: float = 0.1, device: Any = "cuda"):
    """Controller + 2 servers + broker WITH a stats/trace ledger and
    full trace sampling (the straggler scorer reads per-server scatter
    spans out of ``query_trace`` records), one table replicated on both
    servers so every query scatters to both — the geometry a one-sided
    ``segment.slow`` plan must show up in. The servers run on
    ``device``."""
    from ..cluster import BrokerNode, Controller, ServerNode
    from ..segment import SegmentBuilder
    from ..spi import TableConfig

    ctrl = Controller(os.path.join(tmp, "ctrl"), heartbeat_timeout=5.0,
                      reconcile_interval=0.2)
    servers = [ServerNode(f"server_{i}", ctrl.url, poll_interval=poll,
                          device=device) for i in range(2)]
    broker = BrokerNode(ctrl.url, routing_refresh=poll,
                        query_stats_path=os.path.join(
                            tmp, "query_stats.jsonl"),
                        trace_ratio=1.0)
    cols = _gen_columns(rows)
    schema = _schema(AUTOPSY_TABLE)
    builder = SegmentBuilder(schema, TableConfig(AUTOPSY_TABLE))
    ctrl.add_table(AUTOPSY_TABLE, schema.to_dict(), replication=2)
    half = rows // 2
    for i, (lo, hi) in enumerate(((0, half), (half, rows))):
        d = builder.build({n: v[lo:hi] for n, v in cols.items()},
                          os.path.join(tmp, AUTOPSY_TABLE), f"seg_{i}")
        ctrl.add_segment(AUTOPSY_TABLE, f"seg_{i}", d)
    v = ctrl.routing_snapshot()["version"]
    for s in servers:
        assert s.wait_for_version(v, timeout=30.0), "server never synced"
    assert broker.wait_for_version(v, timeout=30.0), "broker never synced"
    # park the closed loop: nothing may move segments mid-gate (the
    # rebalance-churn scorer must see an empty move stream)
    ctrl.scheduler._next_run[ctrl.rebalancer.NAME] = \
        time.monotonic() + 1e9

    def stop():
        stop_cluster(ctrl, servers, broker)

    return ctrl, servers, broker, stop


def build_autopsy_mix(seed: int, n_queries: int) -> List[Dict[str, Any]]:
    """The seeded single-table (qid, sql) sequence — pure in (seed, n)."""
    import numpy as np
    rng = np.random.default_rng([seed, 2025])
    out = []
    for i in range(n_queries):
        shape = QUERY_SHAPES[int(rng.integers(len(QUERY_SHAPES)))]
        out.append({"qid": f"ap{seed}_{i}", "table": AUTOPSY_TABLE,
                    "sql": shape.format(
                        t=AUTOPSY_TABLE,
                        p=int(rng.integers(100, 1000)))})
    return out


def run_autopsy_gate(seed: int = 20260807, n_queries: int = 12,
                     rows: int = 1024, qps: float = 25.0,
                     ledger_out: Optional[str] = None,
                     device: Any = "cuda") -> Dict[str, Any]:
    """The incident-autopsy gate (section comment above) on ``device``.
    Returns the summary dict; ``ok`` is the verdict."""
    from ..cluster.autopsy import (global_autopsy, load_corpus,
                                           plan_autopsy, whydown)
    from ..engine.tier import global_tier
    from ..utils import faults
    from ..utils import ledger as uledger
    from ..utils.slo import (event_time, global_incidents,
                             global_slo)

    tmp = tempfile.mkdtemp(prefix="ptpu_autopsy_")
    failures: List[str] = []
    summary: Dict[str, Any] = {
        "scenario": "autopsy_replay", "seed": seed, "multiple": 1.0,
        "queries_recorded": n_queries, "mode": "cluster"}

    def check(name: str, ok: bool, detail: str = "") -> None:
        if not ok:
            failures.append(f"{name}: {detail}")

    faults.clear()
    global_slo.clear()
    global_incidents.reset()
    global_incidents.post_hook = None   # the broker re-wires below
    global_autopsy.reset()
    global_autopsy.path = None
    global_tier.configure(budget_bytes=None)
    stop = None
    t_start = time.perf_counter()
    try:
        ctrl, servers, broker, stop = build_autopsy_cluster(
            tmp, rows, device=device)
        path = broker.forensics.ledger_path
        mix = build_autopsy_mix(seed, n_queries)

        # wiring sanity: the broker adopted its ledger for the autopsy
        # plane and hooked attribution onto incident capture
        check("wire.autopsy_path", global_autopsy.path == path,
              f"autopsy ledger {global_autopsy.path} != {path}")
        check("wire.post_hook",
              getattr(global_incidents.post_hook, "__self__", None)
              is global_autopsy,
              "incident post hook not wired to the autopsy plane")

        # warmup: each query shape pays its first-use costs off-corpus
        seen = set()
        for q in mix:
            key = q["sql"].split("FROM")[0]
            if key in seen:
                continue
            seen.add(key)
            _rb_phase(broker.url, [q], f"apwarm{len(seen)}", qps=1e9)

        def probe(tag: str) -> None:
            # a synthetic info-severity alert captures a REAL incident
            # bundle (tier/devmem/overload/slo surfaces) — the
            # pre/post tier blocks the thrash scorer deltas, and each
            # capture also exercises the post-hook auto-run
            alert = uledger.make_record(
                "alert", alert=f"autopsy_probe_{tag}", severity="info",
                rate_per_min=0.0, watermark=0.0, window_s=0.0,
                proc=global_incidents.proc)
            global_incidents.request(alert, sync=True)

        def run_pass(tag: str, expected: Optional[str],
                     inject=None, revert=None) -> Dict[str, Any]:
            prior = load_corpus(path)
            seq0 = prior[-1]["_seq"] if prior else 0
            probe(f"{tag}_pre")   # pre-window bundle (baseline tier)
            base = _rb_phase(broker.url, mix, f"{tag}b", qps)
            check(f"{tag}.baseline_errors", base["errors"] == 0,
                  f"{base['errors']} errors during the baseline")
            times = [t for t in (
                event_time(r) for r in load_corpus(path)
                if r["_seq"] > seq0 and r.get("kind") == "query_stats")
                if t is not None]
            check(f"{tag}.baseline_stats", bool(times),
                  "no baseline query_stats landed in the ledger")
            t_cut = max(times or [0.0]) + 1e-6
            if inject is not None:
                inject()
            try:
                win = _rb_phase(broker.url, mix, f"{tag}w", qps)
                probe(f"{tag}_post")   # bundle while still injected
            finally:
                if revert is not None:
                    revert()
                quiesce()   # an injected straggler's executions
            check(f"{tag}.window_errors", win["errors"] == 0,
                  f"{win['errors']} errors during the window")
            corpus = [r for r in load_corpus(path) if r["_seq"] > seq0]
            v1 = plan_autopsy(corpus, window=(t_cut, None))
            v2 = plan_autopsy(corpus, window=(t_cut, None))
            check(f"{tag}.byte_identical",
                  json.dumps(v1, sort_keys=True)
                  == json.dumps(v2, sort_keys=True),
                  "two same-corpus verdicts diverged")
            ranked = v1["causes"]
            if expected is None:
                check(f"{tag}.inconclusive",
                      v1["inconclusive"] and v1["top_cause"] == "",
                      "clean pass confabulated "
                      f"{ranked[0]['cause']}={ranked[0]['score']}")
            else:
                check(f"{tag}.top_cause", v1["top_cause"] == expected,
                      f"top {v1['top_cause'] or '<inconclusive>'} != "
                      f"{expected}: " + ", ".join(
                          f"{c['cause']}={c['score']}"
                          for c in ranked[:3]))
                check(f"{tag}.margin",
                      ranked[0]["score"] > ranked[1]["score"],
                      f"competing cause not strictly lower: "
                      f"{ranked[0]['cause']}={ranked[0]['score']} vs "
                      f"{ranked[1]['cause']}={ranked[1]['score']}")
            return v1

        verdicts: Dict[str, Dict[str, Any]] = {}
        verdicts["clean"] = run_pass("apc", None)
        verdicts["straggler"] = run_pass(
            "aps", "straggler",
            inject=lambda: faults.install(
                f"seed={seed}; segment.slow: match=server_0, "
                f"delay_ms={AUTOPSY_DELAY_MS:.0f}, times=-1"),
            revert=faults.clear)
        verdicts["tier_thrash"] = run_pass(
            "apt", "tier_thrash",
            inject=lambda: global_tier.configure(
                budget_bytes=AUTOPSY_TIER_BUDGET_BYTES),
            revert=lambda: global_tier.configure(budget_bytes=None))

        # the per-query lane: whydown over a straggler-window query
        # must find it and surface the overlapping cross-plane events
        wd = whydown(load_corpus(path), qid=f"apsw_{mix[0]['qid']}")
        check("whydown.found",
              bool(wd["found"]) and wd["queries"] >= 1, str(wd))

        summary.update({
            "backend": _backend(device),
            "offered": 6 * n_queries,
            "completed": 6 * n_queries,
            "shed": 0,
            "goodput_qps": round(
                n_queries
                / max(time.perf_counter() - t_start, 1e-3), 3),
            "duration_s": round(time.perf_counter() - t_start, 3),
            "faults_fired": 0,
            "chaos": True,
            "deterministic": not any("byte_identical" in f
                                     for f in failures),
            "extra": {"autopsy": {
                tag: {"top_cause": v["top_cause"],
                      "inconclusive": v["inconclusive"],
                      "top_score": v["causes"][0]["score"],
                      "excess_ms": v["window"]["excess_ms"],
                      "evidence_total": v["evidence_total"]}
                for tag, v in verdicts.items()}},
            "ok": not failures,
        })
        if failures:
            summary["error"] = "; ".join(failures[:4])
        if ledger_out:
            contract = uledger.KINDS["replay_bench"]
            allowed = contract["required"] | contract["optional"]
            rec = uledger.make_record("replay_bench", **{
                k: v for k, v in summary.items() if k in allowed})
            uledger.append_record(rec, ledger_out)
        summary["failures"] = failures
        return summary
    finally:
        faults.clear()
        global_tier.configure(budget_bytes=None)
        global_slo.clear()
        global_slo.path = None
        global_incidents.reset()
        global_incidents.path = None
        global_incidents.post_hook = None
        global_autopsy.reset()
        global_autopsy.path = None
        if stop is not None:
            stop()
        shutil.rmtree(tmp, ignore_errors=True)


def _backend(device: Any) -> str:
    """The torch device type the run used (what the port's records
    stamp as ``backend``)."""
    import torch
    return torch.device(device).type


# -- CLI --------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd")
    g = sub.add_parser("gate", help="full closed-loop overload gate")
    g.add_argument("--multiple", type=float, default=4.0)
    g.add_argument("--seed", type=int, default=20260805)
    g.add_argument("--queries", type=int, default=48)
    g.add_argument("--rows", type=int, default=4096)
    g.add_argument("--mode", choices=("cluster", "local"),
                   default="cluster")
    g.add_argument("--no-chaos", action="store_true")
    g.add_argument("--ledger", default=None,
                   help="append the replay_bench record here")
    p = sub.add_parser("plan", help="print the pure shed-decision "
                                    "stream for a query_stats ledger")
    p.add_argument("stats", help="query_stats JSONL path")
    p.add_argument("--multiple", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=20260805)
    r = sub.add_parser("rebalance",
                       help="closed-loop rebalance gate")
    r.add_argument("--seed", type=int, default=20260807)
    r.add_argument("--queries", type=int, default=24)
    r.add_argument("--rows", type=int, default=2048)
    r.add_argument("--qps", type=float, default=12.0)
    r.add_argument("--ledger", default=None,
                   help="append the replay_bench record here")
    a = sub.add_parser("autopsy",
                       help="incident-autopsy replay gate")
    a.add_argument("--seed", type=int, default=20260807)
    a.add_argument("--queries", type=int, default=12)
    a.add_argument("--rows", type=int, default=1024)
    a.add_argument("--qps", type=float, default=25.0)
    a.add_argument("--ledger", default=None,
                   help="append the replay_bench record here")
    for gp in (g, r, a):
        gp.add_argument("--device", default="cuda",
                        help="the servers' and tables' device (default "
                             "%(default)s; refused without a card "
                             "unless cpu)")
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--rebalance"]:  # flag spelling of the subcommand
        argv[0] = "rebalance"
    if argv[:1] == ["--autopsy"]:   # flag spelling of the subcommand
        argv[0] = "autopsy"
    args = ap.parse_args(argv)
    device = None
    if args.cmd in ("gate", "rebalance", "autopsy"):
        device = tool_device(args.device)
        if device is None:
            return 2
    if args.cmd == "autopsy":
        summary = run_autopsy_gate(seed=args.seed,
                                   n_queries=args.queries,
                                   rows=args.rows, qps=args.qps,
                                   ledger_out=args.ledger, device=device)
        print(json.dumps(summary))
        return 0 if summary.get("ok") else 1
    if args.cmd == "rebalance":
        summary = run_rebalance_gate(seed=args.seed,
                                     n_queries=args.queries,
                                     rows=args.rows, qps=args.qps,
                                     ledger_out=args.ledger,
                                     device=device)
        print(json.dumps(summary))
        return 0 if summary.get("ok") else 1
    if args.cmd == "plan":
        records = load_records(args.stats)
        plan = plan_replay(records, args.multiple, args.seed)
        print(json.dumps({
            "records": len(records),
            "capacity_qps": round(plan["capacity_qps"], 3),
            "entries": len(plan["entries"]),
            "shed_stream": [list(s) for s in plan["shed_stream"]]}))
        return 0
    if args.cmd != "gate":
        ap.print_help()
        return 2
    summary = run_gate(multiple=args.multiple, seed=args.seed,
                       n_queries=args.queries, rows=args.rows,
                       mode=args.mode, chaos=not args.no_chaos,
                       ledger_out=args.ledger, device=device)
    print(json.dumps(summary))
    return 0 if summary.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
