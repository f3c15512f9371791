"""Fleet forensics rollup plane: controller-pulled ledger aggregation.

The forensics plane lands
sampled ``query_trace`` / ``query_stats`` / ``ingest_stats`` records in
PER-NODE JSONL files, so nothing could trend a whole fleet. This module
closes that loop on the controller, the cluster's single pane of glass:

- ``ForensicsRollupTask`` (a ``cluster/periodic.py`` task, leader-gated
  in HA mode, REST-triggerable via ``POST /periodictask/run/
  ForensicsRollup``) pulls ``GET /debug/ledger?since=<seq>`` deltas
  from every live broker/server, re-validates each record through the
  ``utils/ledger.py`` contracts, stamps it with its source ``node`` and
  appends it to the controller-side FLEET ledger. A dead or partitioned
  node is skipped and counted — a bounded per-node timeout means one
  wedged node can never wedge the pull. Per-node cursors persist next
  to the fleet ledger (atomic tmp+rename, the property-store idiom) so
  a controller restart never re-ships already-pulled records.
- Each pass aggregates the fleet ledger into a validated
  ``fleet_rollup`` record: per-table fleet stats (query counts, QPS,
  p50/p99 wall ms, partial/failover/hedge/batched ratios, worst-table
  ingest freshness), a hot-segment heat ranking, the slowest fleet
  queries, and per-node drift/batching/device-memory blocks with
  unique-process fleet totals (in-process clusters share one metrics
  registry per process — node blocks dedupe by the ``proc`` token
  before summing, or totals would multiply-count).
- Served at controller ``GET /debug/fleet`` and rendered as the
  webapp's Fleet view; ``tools/span_diff.py check --fleet`` trends the
  aggregated ``query_trace`` corpus with per-node speed calibration.

The aggregation functions are pure record->dict math, exported for the
oracle tests.

Port of ``pinot_tpu/cluster/rollup.py``: the same pull, cursors, fleet
ledger and ``fleet_rollup`` records, so either package's controller
carries on from the other's fleet ledger and cursor file. The port's
nodes write no ``compile_event`` records and report the compile-plane
counters as 0; ``plan_shapes`` ranks whatever compile events a JAX
node shipped.
"""
from __future__ import annotations

import calendar
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..utils import ledger as uledger
from ..utils.metrics import global_metrics
from .http_util import http_json

PULL_TIMEOUT_S = 3.0
HEAT_TOP = 20
SLOW_TOP = 10
# aggregation window: the per-pass stats re-aggregate over an in-memory
# deque of the newest N fleet records (fed incrementally by each pull;
# loaded from the fleet ledger once at startup), so a long-lived
# controller's pass cost stays bounded instead of re-reading an
# ever-growing file every 30 s. Exactness holds up to the window; a
# clipped pass says so in the record (``window_clipped``).
AGG_WINDOW = 20_000

# the per-node counter subset the rollup carries (drift/requantize,
# retraces, scatter health, batching) — full snapshots stay on the nodes
NODE_COUNTER_KEYS = (
    "selectivity_drift_detected", "selectivity_drift_requantized",
    "selectivity_drift_recompiles", "plan_cache_retraces",
    "plan_cache_expected_recompiles", "scatter_failovers",
    "scatter_hedges", "scatter_partial_responses",
    "scatter_server_errors", "batched_dispatches", "batched_queries",
    "fused_dispatch_errors", "cube_cache_hits", "cube_cache_misses",
    "sampled_traces", "faults_fired",
    # HBM tier (engine/tier.py): paid uploads / budget demotions /
    # affinity-routed avoided uploads
    "tier_promotions", "tier_demotions", "tier_affinity_hits",
    # compile-plane warmup debt (the JAX package's compile plane; 0 on
    # the port's nodes)
    "compiles_total", "compiles_retrace", "compiles_lru_evict_rebuild",
    "compile_ms_total", "compile_storm_alerts",
)
PLAN_SHAPE_TOP = 20


from ..utils.stats import pctl as _pctl  # noqa: E402 — the ONE fleet
# percentile definition (utils/metrics snapshots + engine/loadgen
# ingest-bench percentiles share it so trend lines stay comparable)


def _ts_epoch(ts: Any) -> Optional[float]:
    """Ledger envelope ts ("%Y-%m-%dT%H:%M:%SZ", UTC) -> epoch seconds
    (None when unparseable — legacy/hand-edited lines must not kill a
    rollup pass)."""
    try:
        return calendar.timegm(time.strptime(str(ts),
                                             "%Y-%m-%dT%H:%M:%SZ"))
    except (ValueError, TypeError):
        return None


def aggregate_tables(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fleet per-table stats over ``query_stats`` + ``ingest_stats``
    records (the pulled, node-stamped fleet-ledger corpus).

    ``queries`` is the exact record count per table — the chaos gate
    asserts it equals the sum of the surviving brokers' own ledgers.
    QPS is queries over the observed ts window (1 s envelope
    resolution, floored at 1 s — a burst inside one second reads as
    n/1). Percentiles use the registry definition (_pctl)."""
    acc: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        if rec.get("kind") != "query_stats":
            continue
        t = rec.get("table") or "<unknown>"
        e = acc.setdefault(t, {
            "queries": 0, "errors": 0, "partial": 0, "slow": 0,
            "traced": 0, "failovers": 0, "hedges": 0, "batched": 0,
            "batched_queries": 0, "rows": 0, "shed": 0,
            "shed_by_tenant": {}, "walls": [],
            "t_min": None, "t_max": None})
        e["queries"] += 1
        if rec.get("shed"):
            # overload plane: fleet-wide shed-rate trend
            # lines per table and per tenant. Shed rows are counted in
            # ``queries`` (the chaos gate's exactness contract) but
            # EXCLUDED from the latency walls: a shed is rejected at
            # admission in sub-ms, and folding those into p50/p99
            # would mask the latency regression exactly during the
            # overload the shed counters are reporting.
            e["shed"] += 1
            tn = rec.get("tenant") or "default"
            e["shed_by_tenant"][tn] = e["shed_by_tenant"].get(tn, 0) + 1
        else:
            e["walls"].append(float(rec.get("wall_ms", 0.0)))
        if rec.get("error"):
            e["errors"] += 1
        if rec.get("partial"):
            e["partial"] += 1
        if rec.get("slow"):
            e["slow"] += 1
        if rec.get("traced"):
            e["traced"] += 1
        e["failovers"] += int(rec.get("failovers", 0))
        e["hedges"] += int(rec.get("hedges", 0))
        e["batched"] += int(rec.get("batched", 0))
        if rec.get("batched"):
            e["batched_queries"] += 1
        e["rows"] += int(rec.get("rows", 0))
        ts = _ts_epoch(rec.get("ts"))
        if ts is not None:
            e["t_min"] = ts if e["t_min"] is None else min(e["t_min"], ts)
            e["t_max"] = ts if e["t_max"] is None else max(e["t_max"], ts)
    # latest ingest freshness per table (the freshness ledger); sustained
    # run writers (engine/loadgen, bench_ingest) also carry the sustained-run
    # percentiles — trended per table when present
    freshness: Dict[str, float] = {}
    fresh_pctl: Dict[str, Dict[str, float]] = {}
    for rec in records:
        if rec.get("kind") == "ingest_stats" and rec.get("table"):
            freshness[rec["table"]] = float(rec.get("freshness_ms", 0.0))
            pcts = {k: float(rec[k])
                    for k in ("freshness_p50_ms", "freshness_p99_ms")
                    if isinstance(rec.get(k), (int, float))}
            if pcts:
                fresh_pctl[rec["table"]] = pcts
    out: Dict[str, Any] = {}
    for t, e in sorted(acc.items()):
        walls = sorted(e.pop("walls"))
        t_min, t_max = e.pop("t_min"), e.pop("t_max")
        window = max((t_max - t_min), 1.0) if t_min is not None else 1.0
        n = e["queries"]
        out[t] = {
            **e,
            "qps": round(n / window, 3),
            "p50_ms": round(_pctl(walls, 0.5), 3),
            "p99_ms": round(_pctl(walls, 0.99), 3),
            "partial_ratio": round(e["partial"] / n, 4) if n else 0.0,
            "batched_ratio": round(e["batched_queries"] / n, 4)
            if n else 0.0,
        }
        if t in freshness:
            out[t]["freshness_ms"] = round(freshness[t], 3)
    for t, f in freshness.items():
        out.setdefault(t, {"queries": 0})["freshness_ms"] = round(f, 3)
    for t, pcts in fresh_pctl.items():
        out.setdefault(t, {"queries": 0}).update(
            {k: round(v, 3) for k, v in pcts.items()})
    return out


def rank_plan_shapes(records: List[Dict[str, Any]],
                     top: int = PLAN_SHAPE_TOP) -> List[Dict[str, Any]]:
    """The fleet's hottest plan shapes ranked by warmup cost —
    ``compiles x median compile_ms`` per normalized plan-shape hash
    over the pulled ``compile_event`` corpus. Events dedupe by their
    (proc, seq) identity first (the heat-table rule: two in-process
    node roles shipping one shared compile ledger must not
    double-count), then aggregate per shape with the trigger breakdown.
    This ranking is the prefetch list the JAX package's AOT executable
    plane consumes: a fresh replica warming these shapes first amortizes
    the most cold-start debt per compile (empty on a port-only fleet,
    which compiles nothing)."""
    seen: set = set()
    by_shape: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        if rec.get("kind") != "compile_event":
            continue
        uid = (rec.get("proc"), rec.get("seq"))
        if uid in seen:
            continue
        seen.add(uid)
        shape = rec.get("plan_shape") or "<none>"
        e = by_shape.setdefault(shape, {
            "plan_shape": shape, "sql": None, "compiles": 0,
            "triggers": {}, "_ms": []})
        e["compiles"] += 1
        e["_ms"].append(float(rec.get("lower_ms", 0.0))
                        + float(rec.get("compile_ms", 0.0)))
        t = rec.get("trigger") or "?"
        e["triggers"][t] = e["triggers"].get(t, 0) + 1
        if not e["sql"] and rec.get("sql"):
            e["sql"] = str(rec["sql"])[:120]
    out: List[Dict[str, Any]] = []
    for e in by_shape.values():
        ms = sorted(e.pop("_ms"))
        med = _pctl(ms, 0.5)
        e["median_compile_ms"] = round(med, 3)
        e["total_compile_ms"] = round(sum(ms), 3)
        e["warmup_cost"] = round(e["compiles"] * med, 3)
        out.append(e)
    out.sort(key=lambda e: (-e["warmup_cost"], e["plan_shape"]))
    return out[: max(top, 0)]


def slow_queries(records: List[Dict[str, Any]],
                 top: int = SLOW_TOP) -> List[Dict[str, Any]]:
    """The fleet's slowest queries (webapp "fleet slow queries" panel)."""
    rows = [{"qid": r.get("qid"), "node": r.get("node"),
             "table": r.get("table"),
             "wall_ms": float(r.get("wall_ms", 0.0)),
             "partial": bool(r.get("partial")),
             "sql": (r.get("sql") or "")[:120]}
            for r in records if r.get("kind") == "query_stats"]
    rows.sort(key=lambda r: -r["wall_ms"])
    return rows[: max(top, 0)]


def merge_heat(node_blocks: Dict[str, Dict[str, Any]],
               top: int = HEAT_TOP) -> List[Dict[str, Any]]:
    """Fleet hot-segment ranking from the per-node heat tables.

    Node blocks dedupe by ``proc`` first (in-process roles share ONE
    heat registry — summing per node would multiply-count), then merge
    by (table, segment): distinct processes hosting replicas of a
    segment contribute real, additive touches."""
    by_proc: Dict[str, List[Dict[str, Any]]] = {}
    for node_id in sorted(node_blocks):
        blk = node_blocks[node_id]
        by_proc[blk.get("proc") or node_id] = blk.get("heat") or []
    merged: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for rows in by_proc.values():
        for r in rows:
            key = (r.get("table") or "?", r.get("segment") or "?")
            m = merged.setdefault(key, {
                "table": key[0], "segment": key[1], "touches": 0,
                "rows_scanned": 0, "device_hits": 0,
                "device_misses": 0})
            for f in ("touches", "rows_scanned", "device_hits",
                      "device_misses"):
                m[f] += int(r.get(f, 0))
    out = sorted(merged.values(),
                 key=lambda e: (-e["touches"], -e["rows_scanned"],
                                e["segment"]))[: max(top, 0)]
    for e in out:
        acc = e["device_hits"] + e["device_misses"]
        e["device_hit_ratio"] = round(e["device_hits"] / acc, 4) \
            if acc else None
    return out


def aggregate_slo(node_blocks: Dict[str, Dict[str, Any]]
                  ) -> Dict[str, Any]:
    """Fleet SLO table from the per-node ``slo``/``incidents`` blocks
    (ledger_debug_payload). Node blocks dedupe by ``proc``
    first (in-process roles share ONE SloPlane — summing per node would
    multiply-count), then merge per (scope, kind): worst (max) burn
    rates and lowest budget remaining across processes — the fleet view
    surfaces the most-burned replica, not an average that hides it —
    with additive event/bad/incident counts (distinct processes observe
    distinct queries). Pure record->dict math, exported for the oracle
    tests."""
    seen: Dict[str, Dict[str, Any]] = {}
    for node_id in sorted(node_blocks):
        blk = node_blocks[node_id]
        seen.setdefault(blk.get("proc") or node_id, blk)
    rows: Dict[Tuple[str, str], Dict[str, Any]] = {}
    incidents = 0
    armed = False
    for blk in seen.values():
        inc = blk.get("incidents") or {}
        incidents += int(inc.get("count", 0))
        slo = blk.get("slo") or {}
        armed = armed or bool(slo.get("armed"))
        for r in slo.get("objectives") or []:
            key = (str(r.get("scope") or "?"), str(r.get("kind") or "?"))
            m = rows.setdefault(key, {
                "scope": key[0], "kind": key[1],
                "objective": r.get("objective"),
                "burn_fast": 0.0, "burn_slow": 0.0,
                "budget_remaining": 1.0, "events": 0, "bad": 0,
                "alerting": False})
            m["burn_fast"] = max(m["burn_fast"],
                                 float(r.get("burn_fast", 0.0)))
            m["burn_slow"] = max(m["burn_slow"],
                                 float(r.get("burn_slow", 0.0)))
            m["budget_remaining"] = min(
                m["budget_remaining"],
                float(r.get("budget_remaining", 1.0)))
            m["events"] += int(r.get("events", 0))
            m["bad"] += int(r.get("bad", 0))
            m["alerting"] = m["alerting"] or bool(r.get("alerting"))
            if r.get("stale"):
                m["stale"] = True
    return {"armed": armed,
            "objectives": [rows[k] for k in sorted(rows)],
            "open_incidents": incidents}


def fleet_totals(node_blocks: Dict[str, Dict[str, Any]]
                 ) -> Dict[str, int]:
    """Unique-process sums of the carried counters + device bytes."""
    seen: Dict[str, Dict[str, Any]] = {}
    for node_id in sorted(node_blocks):
        blk = node_blocks[node_id]
        seen.setdefault(blk.get("proc") or node_id, blk)
    totals: Dict[str, int] = {k: 0 for k in NODE_COUNTER_KEYS}
    totals["device_bytes"] = 0
    for blk in seen.values():
        counters = blk.get("counters") or {}
        for k in NODE_COUNTER_KEYS:
            totals[k] += int(counters.get(k, 0))
        mem = blk.get("memory") or {}
        totals["device_bytes"] += int(
            (mem.get("total") or {}).get("bytes", 0))
    return totals


VERDICT_TOP = 5


def latest_verdicts(records: List[Dict[str, Any]],
                    top: int = VERDICT_TOP) -> List[Dict[str, Any]]:
    """The newest ``rca_verdict`` briefs in the pulled corpus (webapp
    Autopsy panel): (proc, seq)-deduped like the plan-shape
    ranking (two in-process roles shipping one shared ledger must not
    double-count), newest last in ledger order so the panel's top row
    is the freshest verdict. Pure record->list math, exported for the
    oracle tests."""
    seen: set = set()
    rows: List[Dict[str, Any]] = []
    for rec in records:
        if rec.get("kind") != "rca_verdict":
            continue
        uid = (rec.get("proc"), rec.get("seq"))
        if uid in seen:
            continue
        seen.add(uid)
        causes = rec.get("causes") or []
        rows.append({
            "node": rec.get("node"), "proc": rec.get("proc"),
            "seq": rec.get("seq"), "ts": rec.get("ts"),
            "incident_ref": rec.get("incident_ref"),
            "top_cause": rec.get("top_cause"),
            "inconclusive": bool(rec.get("inconclusive")),
            "top_score": (causes[0].get("score")
                          if causes and isinstance(causes[0], dict)
                          else None),
            "detail": (causes[0].get("detail")
                       if causes and isinstance(causes[0], dict)
                       else None)})
    return rows[-max(top, 0):][::-1]


def _node_slo_brief(slo: Dict[str, Any]) -> Dict[str, Any]:
    """One node's SLO block compressed to the rebalancer's donor
    signal: worst slow-window burn across its objectives + whether any
    alert is latched."""
    objs = (slo or {}).get("objectives") or []
    return {
        "worst_burn_slow": max(
            [float(o.get("burn_slow", 0.0) or 0.0) for o in objs]
            or [0.0]),
        "alerting": any(bool(o.get("alerting")) for o in objs),
    }


class ForensicsRollupTask:
    """The controller-side pull + aggregate pass (module docstring).
    Registered as a BasePeriodicTask; ``run()`` is also the manual
    trigger body (idempotent — cursors make pulls incremental)."""

    NAME = "ForensicsRollup"

    def __init__(self, controller, ledger_path: Optional[str] = None,
                 pull_timeout: float = PULL_TIMEOUT_S):
        self.controller = controller
        self.ledger_path = ledger_path or os.path.join(
            controller.data_dir, "fleet_ledger.jsonl")
        self.pull_timeout = pull_timeout
        self._lock = threading.Lock()
        # serializes whole passes: the scheduler's periodic fire, a
        # manual REST trigger and a direct run() (chaos gate) may
        # overlap — without this, two passes would read the same
        # cursors and double-ship every node's delta
        self._run_lock = threading.Lock()
        self._cursors: Dict[str, int] = self._load_cursors()
        # the rolling aggregation window (module constant above):
        # pre-load the existing fleet ledger once, then feed deltas
        existing, _ = _read_fleet(self.ledger_path)
        self._window: deque = deque(existing, maxlen=AGG_WINDOW)
        self._total_records = len(existing)
        self.last_rollup: Optional[Dict[str, Any]] = None
        self.pulls = 0

    # -- cursor persistence (restart must not re-ship pulled records) ------
    def _cursor_path(self) -> str:
        return self.ledger_path + ".cursors"

    def _load_cursors(self) -> Dict[str, int]:
        try:
            with open(self._cursor_path()) as fh:
                data = json.load(fh)
            return {str(k): int(v) for k, v in data.items()}
        except (OSError, ValueError):
            return {}

    def _save_cursors(self) -> None:
        tmp = self._cursor_path() + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._cursors, fh)
        os.replace(tmp, self._cursor_path())

    # -- pull targets ------------------------------------------------------
    def _targets(self) -> List[Tuple[str, str]]:
        """Live (heartbeat-fresh) brokers and servers with a dialable
        host/port, from the controller's ephemeral instance registry."""
        c = self.controller
        now = time.monotonic()
        out: List[Tuple[str, str]] = []
        with c._lock:
            for inst in c._instances.values():
                if inst.get("role") not in ("broker", "server"):
                    continue
                if now - inst["lastHeartbeat"] > c.heartbeat_timeout:
                    continue
                if not inst.get("host") or not inst.get("port"):
                    continue
                out.append((inst["id"],
                            f"http://{inst['host']}:{inst['port']}"))
        return sorted(out)

    # -- the pass ----------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        # whole-pass serialization: overlapped passes would read the
        # same cursors and double-ship deltas (the scheduler serializes
        # its own fires through run_once, but a direct run() — chaos
        # gate, tests — may overlap a periodic fire)
        with self._run_lock:
            return self._run_locked()

    def _run_locked(self) -> Dict[str, Any]:
        pulled = 0
        invalid = 0
        skipped: List[str] = []
        node_blocks: Dict[str, Dict[str, Any]] = {}
        targets = self._targets()
        for node_id, url in targets:
            since = self._cursors.get(node_id, 0)
            try:
                resp = http_json(
                    "GET", f"{url}/debug/ledger?since={since}",
                    timeout=self.pull_timeout)
            except Exception:
                # dead/partitioned node: skipped and counted, the pull
                # moves on — one wedged node never wedges the fleet
                skipped.append(node_id)
                continue
            for rec in resp.get("records") or []:
                if not isinstance(rec, dict) or "v" not in rec or \
                        uledger.validate_record(rec):
                    invalid += 1  # legacy or contract-violating: dropped
                    continue
                stamped = dict(rec)
                stamped["node"] = node_id
                uledger.append_record(stamped, self.ledger_path)
                self._window.append(stamped)
                self._total_records += 1
                pulled += 1
            # cursor updates publish under _lock: snapshot() copies
            # _cursors for GET /debug/fleet while a pass is mid-pull,
            # and a dict resize during that copy raises (CC201
            # mixed-guard — _run_lock serializes passes, _lock guards
            # the served state)
            with self._lock:
                self._cursors[node_id] = int(resp.get("nextSeq", since))
            node_blocks[node_id] = {
                "role": resp.get("role"),
                "proc": resp.get("proc"),
                "counters": {k: (resp.get("counters") or {}).get(k, 0)
                             for k in NODE_COUNTER_KEYS},
                "batching": resp.get("batching"),
                "memory": resp.get("memory"),
                "tier": resp.get("tier"),
                "heat": resp.get("heat"),
                # SLO burn table + incident counts
                "slo": resp.get("slo"),
                "incidents": resp.get("incidents"),
            }
        self._save_cursors()

        # aggregate over the rolling window (not just this delta): the
        # rollup is the cumulative cluster view — fed incrementally, so
        # a pass never re-reads the whole file; restarts reload it once
        fleet_records = list(self._window)
        node_summaries = {
            n: {"role": b["role"], "proc": b["proc"],
                "counters": b["counters"],
                "memory": {p: v for p, v in
                           ((b.get("memory") or {}).items())
                           if p == "total" or (v or {}).get("entries")},
                # HBM tier occupancy beside the device-bytes block
                # (webapp Fleet view renders both)
                **({"tier": b["tier"]} if b.get("tier") else {}),
                # per-node SLO brief (worst slow-window burn + alerting
                # flag): the closed-loop rebalancer's donor-ranking
                # signal (cluster/rebalancer.plan_moves). In-process
                # roles share one SloPlane so these degenerate to the
                # same value per proc — the planner's load tiebreak
                # carries ranking then; distinct processes diverge.
                **({"slo": _node_slo_brief(b["slo"])}
                   if (b.get("slo") or {}).get("armed") else {})}
            for n, b in node_blocks.items()}
        fields: Dict[str, Any] = {
            "nodes_polled": len(targets),
            "nodes_skipped": len(skipped),
            "skipped_nodes": skipped,
            "records_pulled": pulled,
            "invalid_records": invalid,
            "fleet_records": self._total_records,
            "tables": aggregate_tables(fleet_records),
            "slow_queries": slow_queries(fleet_records),
            # the fleet's hottest plan shapes by warmup cost (the JAX
            # package's executable-plane prefetch list)
            "plan_shapes": rank_plan_shapes(fleet_records),
            "heat": merge_heat(node_blocks),
            "nodes": node_summaries,
            "fleet": fleet_totals(node_blocks),
            # worst-replica fleet SLO view + open incident count
            "slo": aggregate_slo(node_blocks),
            # newest root-cause verdicts (Autopsy panel)
            "autopsy": latest_verdicts(fleet_records),
        }
        if self._total_records > len(fleet_records):
            # older records aged out of the window: say so instead of
            # presenting a clipped aggregation as complete history
            fields["window_clipped"] = len(fleet_records)
        rec = uledger.make_record("fleet_rollup", **fields)
        uledger.append_record(rec, self.ledger_path)
        with self._lock:
            self.last_rollup = rec
            self.pulls += 1
        global_metrics.gauge("fleet_nodes_polled", len(targets))
        global_metrics.gauge("fleet_nodes_skipped", len(skipped))
        global_metrics.gauge("fleet_records_total", self._total_records)
        return rec

    # -- serving (GET /debug/fleet) ----------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"ledger": self.ledger_path,
                    "pulls": self.pulls,
                    "cursors": dict(self._cursors),
                    "rollup": self.last_rollup}


def _read_fleet(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Parse the fleet ledger (rollup records excluded from their own
    aggregation input)."""
    records: List[Dict[str, Any]] = []
    lines = 0
    if os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                lines += 1
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and \
                        rec.get("kind") != "fleet_rollup":
                    records.append(rec)
    return records, lines
