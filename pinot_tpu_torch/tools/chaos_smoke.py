"""Chaos smoke: seeded fault plans over a live 2-server cluster, plus
eight more gates, one mode each.

The port's copy of the root ``tools/chaos_smoke.py``, over
``pinot_tpu_torch``: the same modes, flags, defaults, seeds, summary JSON
(the last line) and exit codes. Its servers, brokers and tables run on
``--device`` (default ``cuda``; without a card every mode refuses, exit
2, unless ``--device cpu`` is given). The data are the JAX tool's: the
SSB rows come from ``tools/ssb.py`` (the port's copy of ``bench.py``'s
generator) and the other tables from the same seeded numpy draws, so a
digest here is the JAX tool's digest at the same seed and rows.

The base mode builds a 2-server in-process cluster hosting an SSB-lite
``lineorder`` table (4 segments, replication 2) plus a replication-1
twin, captures fault-free digests for a small SSB query set, then
re-runs under seeded ``PINOT_FAULTS``-grammar plans (``utils/faults``)
and asserts:

1. ``rpc.drop`` of server_0's first /query/bin dispatch: the broker
   fails over and every digest is byte-identical to the fault-free run.
2. ``wire.corrupt`` of server_0's first response frame: decode fails
   loudly, failover, digests byte-identical.
3. Sustained ``rpc.drop`` of server_0 against the replication-1 twin:
   ``allowPartialResults=true`` answers with ``partialResult=true``,
   populated ``exceptions[]`` and ``numServersResponded <
   numServersQueried``; the default mode fails whole-query.
4. Every cluster query appended a validated ``query_stats`` record to
   the broker's stats ledger, including at least one ``partial=true``
   record from the replication-1 plan, and a validated ``query_trace``
   record joinable to its stats row.
5. The fleet rollup survives a second broker's ledger pull dying
   mid-rollup (``_rollup_gate``), and ``span_diff check --fleet`` holds
   over the fleet ledger.

The JAX tool's compile-attribution parity pass is left out: the port has
no compile plane (JAX-only).

``--ingest``: for each seed, seeded row sequences through an append
table (standalone seal) AND an upsert table (full completion protocol +
deep store) with every ingest fault point armed, restarting from the
checkpoint on each injected crash; the final queryable state must be
digest-exact against the fault-free oracle and every run must append a
validated ``ingest_stats`` record.

``--tier``: an in-process broker over two 4-segment SSB-lite tables; a
seeded ``tier.evict`` plan force-demotes a segment MID-QUERY and every
query answers byte-exact, two same-seed runs firing identical (point,
site, hit) streams; then the mix re-runs under half the live working
set's device budget: demotions fire, digests stay byte-exact, and every
device-memory pool reconciles tracked-vs-actual to the byte.

``--rebalance``: a burn-triggered move under seeded ``rebalance.crash``
and ``cutover.stall`` recovers byte-exact from the journal, same-seed
stall runs fire identical streams, an incident-open pass plans ZERO
moves, and the pools reconcile after the donor drain.

``--autopsy``: a real SLO burn fires an alert, the incident recorder
captures it and its post hook lands a contract-valid ``rca_verdict``;
a fleet-level verdict over the rollup's pulled corpus names the
injected cause with every evidence pointer resolvable to its ledger
line, and a clean window says ``inconclusive``. The injected cause is a
donor-only ``segment.slow`` straggler (the JAX tool injects a compile
storm, which the port cannot: it has no compile plane).

``--vector``: seeded VECTOR_SIMILARITY top-k queries fail over
byte-identically under ``rpc.drop`` (same-seed streams identical),
recover from a mid-query ``tier.evict`` of the vector pool, reject a
malformed call as a structured error, and leave the ``vector`` pool
reconciled to the byte.

``--fused``: fused == mailbox digests over a join + window + set-op mix,
a p=1.0 ``device.overflow`` plan forces the mailbox fallback with
identical digests and streams, and a cross-host ``distributed_join``
under a seeded ``rpc.drop`` of a mailbox frame fails loudly, then
answers as the numpy oracle.

``--overload``: ``traffic_replay``'s gate in cluster mode (record a
three-tenant mix, replay it at ``--multiple`` with chaos armed, the shed
stream byte-identical to the pure plan) and a validated
``replay_bench`` record.

``--rate``: sustained multi-partition ingest with a concurrent query mix
and every ingest fault point armed, byte-exact against the oracle, the
``ingest_bench`` and ``ingest_stats`` records validated, and a fresh
``freshness_gate`` capture checked against the port's card baseline.
As in the reference, a ratchet that exits other than 0 fails the mode:
the committed baselines are the card's, so on the CPU the base mode's
fleet span check and ``--rate``'s freshness check exit 3 (environment
mismatch) and the mode fails unless the ratchets' ``DEFAULT_BASELINE``
names a baseline of the CPU.

    python -m pinot_tpu_torch.tools.chaos_smoke [--rows N] [--seed N]
        [--device cuda|cpu]
    python -m pinot_tpu_torch.tools.chaos_smoke --ingest [--seeds 40,50,57]
    python -m pinot_tpu_torch.tools.chaos_smoke --tier|--rebalance|
        --autopsy|--vector|--fused|--overload|--rate [--rows N]

Prints one summary JSON line last; exit 0 when all assertions hold, 1
otherwise, 2 when the device is refused.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from ..device import tool_device
from . import freshness_gate as FG
from . import span_diff, ssb
from . import traffic_replay as TR

SMOKE_QUERY_IDS = ("q1.1", "q2.1", "q3.2", "q4.1")
OPTION = " OPTION(timeoutMs=300000)"


def smoke_queries(qids=SMOKE_QUERY_IDS):
    """(qid, sql) for the smoke subset of the SSB suite."""
    by_id = {q[0]: q for q in ssb.QUERIES}
    out = []
    for qid in qids:
        _, preds, vexpr, gcols = by_id[qid]
        out.append((qid, ssb.spec_to_sql(preds, vexpr, gcols)))
    return out


def build_ssb_cluster(tmp: str, rows: int = 4096, n_segments: int = 4,
                      poll: float = 0.1, device="cuda"):
    """Controller + 2 servers on ``device`` + broker over an SSB-lite
    ``lineorder`` (replication 2) and a ``lineorder_r1`` twin
    (replication 1) built from the same segment directories. Returns
    (ctrl, servers, broker, stop)."""
    from ..cluster import BrokerNode, Controller, ServerNode
    from ..segment import SegmentBuilder
    from ..segment.builder import Categorical
    from ..spi import Schema, TableConfig

    cols = ssb.gen_columns(rows)
    fields = ssb._ssb_fields(cols)

    ctrl = Controller(os.path.join(tmp, "ctrl"), heartbeat_timeout=5.0,
                      reconcile_interval=0.2)
    servers = [ServerNode(f"server_{i}", ctrl.url, poll_interval=poll,
                          device=device) for i in range(2)]
    # per-query query_stats ledger: the soak's trend-line output (and
    # the assertion target — every cluster query must append a
    # check_ledger-valid record). trace_ratio=1.0: every soak query is
    # production-sampled, so the chaos plans also exercise the sampled
    # span plane (failover/hedge spans under injected faults) and every
    # run must land validated query_trace records beside the stats.
    broker = BrokerNode(ctrl.url, routing_refresh=poll,
                        query_stats_path=os.path.join(
                            tmp, "query_stats.jsonl"),
                        trace_ratio=1.0)

    for table, replication in (("lineorder", 2), ("lineorder_r1", 1)):
        schema = Schema(table, fields)
        builder = SegmentBuilder(schema, TableConfig(table))
        ctrl.add_table(table, schema.to_dict(), replication=replication)
        step = rows // n_segments
        for i in range(n_segments):
            lo, hi = i * step, rows if i == n_segments - 1 \
                else (i + 1) * step
            part = {n: (Categorical(v.codes[lo:hi], v.values)
                        if isinstance(v, Categorical) else v[lo:hi])
                    for n, v in cols.items()}
            d = builder.build(part, os.path.join(tmp, table), f"seg_{i}")
            ctrl.add_segment(table, f"seg_{i}", d)

    v = ctrl.routing_snapshot()["version"]
    for s in servers:
        assert s.wait_for_version(v, timeout=30.0), "server never synced"
    assert broker.wait_for_version(v, timeout=30.0), "broker never synced"

    def stop():
        TR.stop_cluster(ctrl, servers, broker)

    return ctrl, servers, broker, stop


def digest(resp: dict):
    return ssb._digest([tuple(r) for r in resp["resultTable"]["rows"]])


def _iter_kind(path: str, kind: str):
    """v2 records of one kind from a ledger file."""
    with open(path) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("kind") == kind:
                yield rec


def _iter_stats(path: str, partial=None):
    """query_stats records from a stats ledger, optionally filtered by
    the partialResult flag."""
    for rec in _iter_kind(path, "query_stats"):
        if partial is not None and rec.get("partial") != partial:
            continue
        yield rec


def _file_hash(path: str):
    import hashlib
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


# seeds/rows whose decision streams fire EVERY ingest fault point
# (verified by test_ingest_chaos's all-points gate; re-scan if the plan
# changes). The all-points check is calibrated for exactly these values
# — other --seeds/--rows still gate digest-exact recovery + the ledger,
# but fire whatever subset of points their decision streams produce
INGEST_SEEDS = (40, 50, 57)
INGEST_ROWS = 300


def main_ingest(args) -> int:
    """--ingest: seeded chaos over the realtime plane, digest-exact
    recovery + a validated ingest_stats freshness-ledger record per
    run."""
    from ..tools import ingest_fuzz as IF
    from ..utils import faults
    from ..utils import ledger as uledger

    seeds = tuple(int(s) for s in args.seeds.split(","))
    tmp = tempfile.mkdtemp(prefix="ptpu_ingest_chaos_")
    ledger_path = os.path.join(tmp, "ingest_stats.jsonl")
    failures = []
    summary = {"mode": "ingest", "rows": args.rows, "seeds": list(seeds),
               "runs": 0, "faults_fired": 0, "restarts": 0,
               "points": []}

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"{name}: {detail}")
            print(f"FAIL {name}: {detail}")

    faults.clear()
    points = set()
    try:
        for seed in seeds:
            for upsert, protocol in ((False, False), (True, True)):
                tag = (f"seed{seed}."
                       + ("upsert" if upsert else "append")
                       + (".protocol" if protocol else ""))
                run_dir = os.path.join(tmp, tag)
                try:
                    m, plan, restarts = IF.run_one(
                        run_dir, seed, args.rows, upsert=upsert,
                        protocol=protocol, device=args.device)
                except Exception as e:  # noqa: BLE001 — into the summary
                    check(tag, False, f"EXC {type(e).__name__}: {e}")
                    continue
                summary["runs"] += 1
                summary["faults_fired"] += len(plan.fired)
                summary["restarts"] += restarts
                points |= {f["point"] for f in plan.fired}
                got = IF.digest(IF.queryable_rows(m))
                exp = IF.digest(IF.oracle_rows(
                    IF.gen_rows(seed, args.rows), upsert))
                check(f"{tag}.digest", got == exp,
                      f"{len(got)} rows vs oracle {len(exp)} after "
                      f"{restarts} restarts")
                m.write_ingest_stats(ledger_path, seed=seed,
                                     restarts=restarts,
                                     faults_fired=len(plan.fired))
        summary["points"] = sorted(points)
        if seeds == INGEST_SEEDS and args.rows == INGEST_ROWS:
            check("points.all_fired",
                  points >= {"stream.error", "stream.rebalance",
                             "commit.crash", "commit.http_error",
                             "handoff.stall", "upsert.compact_crash"},
                  f"only {sorted(points)} fired across seeds {seeds}")
        else:
            summary["points_gate"] = \
                "skipped: all-points check is calibrated for the " \
                "default --seeds/--rows only"
        # the freshness ledger: one VALIDATED ingest_stats record per run
        res = uledger.validate_file(ledger_path)
        n_stats = res["kinds"].get("ingest_stats", 0)
        summary["ingest_stats"] = n_stats
        check("ingest_stats.valid", not res["errors"],
              f"invalid records: {res['errors'][:3]}")
        check("ingest_stats.count", n_stats >= summary["runs"]
              and n_stats >= 1,
              f"{n_stats} records for {summary['runs']} runs")
    finally:
        faults.clear()
        shutil.rmtree(tmp, ignore_errors=True)

    summary["ok"] = not failures
    summary["failures"] = failures
    print(json.dumps(summary))
    return 0 if not failures else 1


# the pools the tier and rebalance gates reconcile: the ones they reset
# at entry (the JAX gates' set; the vector and mesh pools belong to
# other gates)
GATE_POOLS = ("segment_cols", "stack_cache", "cube_cache", "cube_stacked")


def reconcile_pools(segments) -> dict:
    """``engine.tier.reconcile_devmem`` over ``segments``, restricted to
    GATE_POOLS."""
    from ..engine.tier import reconcile_devmem
    rec = reconcile_devmem(segments)
    return {p: rec[p] for p in GATE_POOLS}


RATE_ROWS = 600
OVERLOAD_ROWS = 2048
TIER_ROWS = 2048


def build_ssb_table(tmp: str, rows: int, n_segments: int = 4,
                    table: str = "lineorder", seg_prefix: str = "seg_",
                    device="cuda"):
    """In-process SSB-lite table on ``device``: ``n_segments`` segments
    split from one seeded ssb.gen_columns draw. Returns
    (TableDataManager, segment dirs)."""
    from ..segment import SegmentBuilder
    from ..segment.builder import Categorical
    from ..server import TableDataManager
    from ..spi import Schema, TableConfig

    cols = ssb.gen_columns(rows)
    schema = Schema(table, ssb._ssb_fields(cols))
    builder = SegmentBuilder(schema, TableConfig(table))
    dm = TableDataManager(table, device=device)
    step = rows // n_segments
    dirs = []
    for i in range(n_segments):
        lo, hi = i * step, rows if i == n_segments - 1 else (i + 1) * step
        part = {n: (Categorical(v.codes[lo:hi], v.values)
                    if isinstance(v, Categorical) else v[lo:hi])
                for n, v in cols.items()}
        d = builder.build(part, os.path.join(tmp, table),
                          f"{seg_prefix}{i}")
        dirs.append(d)
        dm.add_segment_dir(d)
    return dm, dirs


def main_tier(args) -> int:
    """--tier: the HBM-tier chaos gate (module docstring): mid-query
    ``tier.evict`` demotion recovers byte-exact with same-seed
    determinism, and a constrained budget demotes coldest-first with
    every devmem pool reconciling to the byte."""
    from ..broker import Broker
    from ..engine.tier import global_tier
    from ..utils import faults
    from ..utils.devmem import global_device_memory
    from ..utils.metrics import global_metrics

    tmp = tempfile.mkdtemp(prefix="ptpu_tier_chaos_")
    failures = []
    summary = {"mode": "tier", "rows": args.rows, "seed": args.seed,
               "queries": 0, "faults_fired": 0, "promotions": 0,
               "demotions": 0}

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"{name}: {detail}")
            print(f"FAIL {name}: {detail}")

    faults.clear()
    global_tier.configure(budget_bytes=None)
    # start from devmem-synced caches: when this gate runs inside a
    # warm pytest process, earlier tests' cube/stack entries survive
    # the per-test accounting reset and would fail the byte-exact
    # reconcile below through no fault of the tier's
    from ..engine.batch import clear_stack_cache
    from ..ops.plan_cache import global_cube_cache
    clear_stack_cache()
    global_cube_cache.clear()
    broker = Broker(device=args.device)
    try:
        # TWO tables over the same seeded data: the twin gives the
        # budget enforcement demotion victims OUTSIDE the querying
        # table's pinned working set (and its digests must equal the
        # original's — same rows, different placement history)
        dm, _dirs = build_ssb_table(tmp, args.rows, device=args.device)
        dm2, _dirs2 = build_ssb_table(tmp, args.rows,
                                      table="lineorder2",
                                      seg_prefix="t2seg_",
                                      device=args.device)
        broker.register_table(dm)
        broker.register_table(dm2)
        queries = smoke_queries(tuple(args.queries.split(",")))
        summary["queries"] = len(queries)

        def run_all(tag, twin=False):
            # deterministic query ids: the per-(qid, site-key) fault
            # streams must be identical across same-seed runs
            out = {}
            for qid, sql in queries:
                if twin:
                    sql = sql.replace("FROM lineorder ",
                                      "FROM lineorder2 ")
                res = broker.query(
                    sql + f" OPTION(timeoutMs=300000,"
                          f"queryId=tier.{tag}.{qid})")
                out[qid] = ssb._digest([tuple(r) for r in res.rows])
            return out

        baseline = run_all("base")
        check("twin.digests", run_all("base2", twin=True) == baseline,
              "twin table digests differ from the original's")

        # (a) mid-query demotion: the group access hook force-demotes
        # seg_1 (device columns AND stacked copies) after planning,
        # before dispatch — the SAME query must rebuild/re-promote
        # through device_col and answer byte-exact. times=1 per
        # (query id, site) stream: once per query, every query.
        plan_text = (f"seed={args.seed}; "
                     "tier.evict: match=seg_1, times=1")

        def run_plan(tag):
            plan = faults.install(plan_text)
            try:
                got = run_all(tag)
            finally:
                faults.clear()
            return plan, got

        d0 = global_tier.demotions
        plan1, got1 = run_plan("evict")
        summary["faults_fired"] += len(plan1.fired)
        check("tier_evict.fired", len(plan1.fired) >= 1,
              "tier.evict never fired")
        check("tier_evict.demoted", global_tier.demotions > d0,
              "no demotion recorded")
        for qid in baseline:
            check(f"tier_evict.{qid}", got1[qid] == baseline[qid],
                  "digest mismatch after mid-query demotion")
        # same-seed determinism: identical (point, site, hit) streams
        plan2, got2 = run_plan("evict")
        summary["faults_fired"] += len(plan2.fired)
        check("tier_evict.deterministic",
              plan1.fired_summary() == plan2.fired_summary(),
              f"{plan1.fired_summary()} != {plan2.fired_summary()}")
        for qid in baseline:
            check(f"tier_evict.rerun.{qid}", got2[qid] == baseline[qid],
                  "digest mismatch on same-seed rerun")

        # (b) constrained budget: half the live two-table working set —
        # alternating tables forces coldest-first demotion of the idle
        # table's segments; digests stay exact, pools reconcile
        total = global_device_memory.snapshot()["total"]["bytes"]
        budget = max(total // 2, 1)
        summary["budget_bytes"] = budget
        global_tier.configure(budget_bytes=budget)
        d1 = global_tier.demotions
        got3 = run_all("budget")
        got4 = run_all("budget2", twin=True)
        got5 = run_all("budget3")
        for qid in baseline:
            check(f"tier_budget.{qid}",
                  got3[qid] == baseline[qid]
                  and got4[qid] == baseline[qid]
                  and got5[qid] == baseline[qid],
                  "digest mismatch under constrained budget")
        check("tier_budget.demoted", global_tier.demotions > d1,
              "constrained budget never demoted")
        # the four pools this gate resets at start (GATE_POOLS)
        rec = reconcile_pools(
            dm.acquire_segments() + dm2.acquire_segments())
        summary["reconcile"] = rec
        for pool, r in rec.items():
            check(f"reconcile.{pool}", r["tracked"] == r["actual"],
                  f"tracked {r['tracked']} != actual {r['actual']}")
        snap = global_tier.snapshot()
        summary["promotions"] = snap["promotions"]
        summary["demotions"] = snap["demotions"]
        # churn bound: demotions are per-query work (at most the idle
        # table's segments per alternation), not a runaway loop
        check("tier_budget.churn_bounded",
              global_tier.demotions - d1 <= 8 * 3 * len(queries) + 8,
              f"{global_tier.demotions - d1} demotions for "
              f"{3 * len(queries)} queries")
        c = global_metrics.snapshot()["counters"]
        check("tier.promotions_counted",
              c.get("tier_promotions", 0) >= snap["promotions"] - 1,
              "tier_promotions counter missing")
    finally:
        faults.clear()
        global_tier.configure(budget_bytes=None)
        TR.retire_segments(broker)
        shutil.rmtree(tmp, ignore_errors=True)

    summary["ok"] = not failures
    summary["failures"] = failures
    print(json.dumps(summary))
    return 0 if not failures else 1


REBALANCE_ROWS = 2048


def build_rebalance_cluster(tmp: str, rows: int, poll: float = 0.1,
                            device="cuda"):
    """A deliberately skewed cluster for the closed-loop rebalance
    gate: ``lineorder`` (3 segments, replication 1) is added while
    server_0 is the ONLY live server so every segment lands there;
    then server_1 joins and the protected ``lineorder_s`` twin (2
    segments) lands on it least-loaded. Returns (ctrl, servers,
    broker, stop)."""
    from ..cluster import BrokerNode, Controller, ServerNode
    from ..segment import SegmentBuilder
    from ..segment.builder import Categorical
    from ..spi import Schema, TableConfig

    cols = ssb.gen_columns(rows)
    fields = ssb._ssb_fields(cols)
    ctrl = Controller(os.path.join(tmp, "ctrl"), heartbeat_timeout=5.0,
                      reconcile_interval=0.2)
    servers = [ServerNode("server_0", ctrl.url, poll_interval=poll,
                          device=device)]

    def add_table(table, n_segments):
        schema = Schema(table, fields)
        builder = SegmentBuilder(schema, TableConfig(table))
        ctrl.add_table(table, schema.to_dict(), replication=1)
        step = rows // n_segments
        for i in range(n_segments):
            lo, hi = i * step, rows if i == n_segments - 1 \
                else (i + 1) * step
            part = {n: (Categorical(v.codes[lo:hi], v.values)
                        if isinstance(v, Categorical) else v[lo:hi])
                    for n, v in cols.items()}
            d = builder.build(part, os.path.join(tmp, table), f"seg_{i}")
            ctrl.add_segment(table, f"seg_{i}", d)

    add_table("lineorder", 3)       # all on server_0 (the future donor)
    v = ctrl.routing_snapshot()["version"]
    assert servers[0].wait_for_version(v, timeout=30.0), \
        "server_0 never synced"
    servers.append(ServerNode("server_1", ctrl.url, poll_interval=poll,
                              device=device))
    add_table("lineorder_s", 2)     # least-loaded -> server_1
    broker = BrokerNode(ctrl.url, routing_refresh=poll)
    v = ctrl.routing_snapshot()["version"]
    for s in servers:
        assert s.wait_for_version(v, timeout=30.0), "server never synced"
    assert broker.wait_for_version(v, timeout=30.0), "broker never synced"

    def stop():
        TR.stop_cluster(ctrl, servers, broker)

    return ctrl, servers, broker, stop


def main_rebalance(args) -> int:
    """--rebalance: the closed-loop rebalance chaos gate:
    a burn-triggered move under seeded ``rebalance.crash`` +
    ``cutover.stall`` recovers byte-exact from the journal, same-seed
    stall runs fire identical (point, site, hit) streams, an
    incident-open pass plans ZERO moves, and the devmem/tier pools
    reconcile to the byte after the donor drain."""
    import time as _time

    from ..cluster.http_util import http_json
    from ..engine.tier import global_tier
    from ..utils import faults
    from ..utils.slo import global_incidents, global_slo

    tmp = tempfile.mkdtemp(prefix="ptpu_rebalance_chaos_")
    failures = []
    summary = {"mode": "rebalance", "rows": args.rows,
               "seed": args.seed, "queries": 0, "faults_fired": 0}

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"{name}: {detail}")
            print(f"FAIL {name}: {detail}")

    faults.clear()
    global_slo.clear()
    global_incidents.reset()
    global_tier.configure(budget_bytes=None)
    from ..engine.batch import clear_stack_cache
    from ..ops.plan_cache import global_cube_cache
    clear_stack_cache()
    global_cube_cache.clear()
    ctrl, servers, broker, stop = build_rebalance_cluster(
        tmp, args.rows, device=args.device)
    rb = ctrl.rebalancer
    rb.budget_moves = 1     # one move per pass: each chaos phase is
    rb.prewarm_timeout = 10.0  # exactly one cutover
    # park the scheduled pass: every pass in this gate is a deliberate,
    # manually-triggered chaos phase
    ctrl.scheduler._next_run[rb.NAME] = _time.monotonic() + 1e9
    try:
        queries = smoke_queries(tuple(args.queries.split(",")))
        summary["queries"] = len(queries)

        def run_all(tag):
            out = {}
            for qid, sql in queries:
                for table in ("lineorder", "lineorder_s"):
                    q = sql.replace("FROM lineorder ", f"FROM {table} ")
                    resp = http_json(
                        "POST", f"{broker.url}/query/sql",
                        {"sql": q + f" OPTION(timeoutMs=300000,"
                                    f"queryId=rb.{tag}.{table}.{qid})"},
                        timeout=120.0)
                    out[(table, qid)] = digest(resp)
            return out

        def holders(table="lineorder"):
            with ctrl._lock:
                return {s: list(h) for s, h in
                        ctrl._state["assignment"][table].items()}

        baseline = run_all("base")
        check("skew.initial",
              all(h == ["server_0"] for h in holders().values()),
              f"burn table not pinned to server_0: {holders()}")

        # arm a latency objective the baseline traffic cannot meet:
        # every query is a bad event, slow-window burn saturates, the
        # burn-rate alert fires and the flight recorder captures an
        # incident (all through the real feed path)
        global_slo.set_objective("lineorder", "latency", bar_ms=0.01,
                                 objective=0.9)
        run_all("burn")
        deadline = _time.monotonic() + 10.0
        while _time.monotonic() < deadline and \
                global_incidents.snapshot(limit=0)["count"] < 1:
            _time.sleep(0.05)
        check("incident.captured",
              global_incidents.snapshot(limit=0)["count"] >= 1,
              "burn alert never captured an incident")

        # (a) incident-open pass: plans ZERO moves, placement untouched
        ctrl.rollup.run()
        before = holders()
        res = rb.run()
        check("freeze.zero_moves",
              res["frozen"] and res["planned"] == 0,
              f"incident-open pass was not frozen: {res}")
        check("freeze.placement", holders() == before,
              "placement changed under an open incident")

        # (b) burn-triggered move under rebalance.crash: the pass dies
        # in the cutover window AFTER the receiver pre-warmed, BEFORE
        # the flip journal commit; the journal must carry the move
        global_incidents.reset()
        ctrl.rollup.run()
        plan = faults.install(f"seed={args.seed}; rebalance.crash: "
                              f"match=rebalance/lineorder/, times=1")
        crashed = False
        try:
            rb.run()
        except faults.FaultInjected:
            crashed = True
        summary["faults_fired"] += len(plan.fired)
        faults.clear()
        check("crash.raised", crashed, "rebalance.crash never fired")
        journal = rb._load_journal()
        check("crash.journal",
              journal is not None and journal.get("phase") == "prewarm",
              f"no prewarm journal after crash: {journal}")
        moved = (journal or {}).get("move") or {}
        seg = moved.get("segment")
        check("crash.overreplicated",
              sorted(holders().get(seg) or []) ==
              ["server_0", "server_1"],
              f"receiver not pre-warmed: {holders()}")

        # (c) recovery: the next pass (same controller, or the new
        # leader over the shared data dir) resumes the journaled move
        # idempotently — exactly one final assignment, donor drained
        res = rb.run()
        check("recover.resumed", res["resumed"] == 1,
              f"journaled move not resumed: {res}")
        check("recover.journal_cleared", rb._load_journal() is None,
              "journal left behind after recovery")
        check("recover.flip", holders().get(seg) == ["server_1"],
              f"resumed move did not converge: {holders()}")
        v = ctrl.routing_snapshot()["version"]
        check("recover.converged",
              broker.wait_for_version(v, timeout=10.0)
              and all(s.wait_for_version(v, timeout=10.0)
                      for s in servers),
              "cluster never converged on the flipped assignment")
        # no orphaned receiver load: exactly one resident copy of the
        # moved segment on the receiver, zero on the drained donor
        have1 = {s.name for s in
                 servers[1]._tables["lineorder"].acquire_segments()}
        have0 = {s.name for s in
                 servers[0]._tables["lineorder"].acquire_segments()}
        check("recover.receiver_loaded", seg in have1,
              f"receiver lost the segment: {sorted(have1)}")
        check("recover.donor_unloaded", seg not in have0,
              f"donor still holds the segment: {sorted(have0)}")
        got = run_all("after")
        for k in baseline:
            check(f"digest.{k[0]}.{k[1]}", got[k] == baseline[k],
                  "digest drift across the crash-recovered cutover")

        # (d) cutover.stall: the pre-warm hangs past its deadline; the
        # move aborts, the donor keeps serving, placement is unchanged
        # — and the abort path is state-neutral, so two same-seed
        # passes must fire IDENTICAL (point, site, hit) streams
        stall_text = (f"seed={args.seed}; cutover.stall: "
                      f"match=rebalance/lineorder/, delay_ms=30, "
                      f"times=-1")
        before = holders()

        def stall_pass(tag):
            plan = faults.install(stall_text)
            try:
                r = rb.run()
            finally:
                faults.clear()
            return plan, r

        plan_a, res_a = stall_pass("a")
        summary["faults_fired"] += len(plan_a.fired)
        check("stall.aborted",
              res_a["planned"] >= 1
              and res_a["aborted"] == res_a["planned"],
              f"stalled pass did not abort every move: {res_a}")
        check("stall.placement", holders() == before,
              "aborted move changed placement")
        plan_b, res_b = stall_pass("b")
        summary["faults_fired"] += len(plan_b.fired)
        check("stall.deterministic",
              plan_a.fired_summary() == plan_b.fired_summary()
              and len(plan_a.fired) >= 1,
              f"{plan_a.fired_summary()} != {plan_b.fired_summary()}")
        check("stall.placement2", holders() == before,
              "second stalled pass changed placement")

        # (e) pools reconcile to the byte after the drain (GATE_POOLS)
        segs = []
        for s in servers:
            for dm in s._tables.values():
                segs.extend(dm.acquire_segments())
        rec = reconcile_pools(segs)
        summary["reconcile"] = rec
        for pool, r in rec.items():
            check(f"reconcile.{pool}", r["tracked"] == r["actual"],
                  f"tracked {r['tracked']} != actual {r['actual']}")
        got = run_all("final")
        for k in baseline:
            check(f"digest.final.{k[0]}.{k[1]}",
                  got[k] == baseline[k],
                  "digest drift after the chaos sequence")
        snap = rb.snapshot()
        summary["rebalance"] = {k: snap[k] for k in
                                ("passes", "executed", "aborted",
                                 "resumed", "frozen_passes")}
    finally:
        faults.clear()
        global_slo.clear()
        global_incidents.reset()
        stop()
        shutil.rmtree(tmp, ignore_errors=True)

    summary["ok"] = not failures
    summary["failures"] = failures
    print(json.dumps(summary))
    return 0 if not failures else 1


AUTOPSY_ROWS = 1024


def main_autopsy(args) -> int:
    """--autopsy: the incident-autopsy chaos gate: a REAL SLO burn
    fires an alert, the flight recorder captures the incident and its
    post hook runs attribution on the capture thread — the ring entry
    must carry the ``rca`` verdict ref and the ledger a contract-valid
    ``rca_verdict``; a fleet-level verdict over the rollup's pulled
    corpus must name the injected donor-only straggler with EVERY
    evidence pointer resolvable back to its ledger line by (node, proc,
    seq); and a clean follow-up window must say ``inconclusive``
    explicitly rather than confabulate a cause. (The JAX gate injects a
    compile storm; the port has no compile plane.)"""
    import time as _time

    from ..cluster.autopsy import (global_autopsy, load_corpus,
                                           plan_autopsy)
    from ..cluster.forensics import read_ledger_since
    from ..engine.tier import global_tier
    from ..utils import faults
    from ..utils import ledger as uledger
    from ..utils.slo import (event_time, global_incidents,
                             global_slo)

    tmp = tempfile.mkdtemp(prefix="ptpu_autopsy_chaos_")
    failures = []
    summary = {"mode": "autopsy", "rows": args.rows, "seed": args.seed,
               "queries": 0, "faults_fired": 0}

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"{name}: {detail}")
            print(f"FAIL {name}: {detail}")

    faults.clear()
    global_slo.clear()
    global_incidents.reset()
    global_incidents.post_hook = None   # the broker re-wires below
    global_autopsy.reset()
    global_autopsy.path = None
    global_tier.configure(budget_bytes=None)
    stop = None
    try:
        ctrl, servers, broker, stop = TR.build_autopsy_cluster(
            tmp, args.rows, device=args.device)
        path = broker.forensics.ledger_path
        mix = TR.build_autopsy_mix(args.seed, 8)
        summary["queries"] = len(mix)
        seen = set()
        for q in mix:           # warmup: first-use costs off-window
            key = q["sql"].split("FROM")[0]
            if key not in seen:
                seen.add(key)
                TR._rb_phase(broker.url, [q], f"cwarm{len(seen)}",
                             qps=1e9)

        def t_cut_after(seq0):
            times = [t for t in (
                event_time(r) for r in load_corpus(path)
                if r["_seq"] > seq0 and r.get("kind") == "query_stats")
                if t is not None]
            return (max(times) + 1e-6) if times else 0.0

        # (a) baseline window, then a real burn THROUGH a donor-only
        # straggler: an unmeetable latency objective makes every query
        # a bad event, the burn-rate alert fires on the live feed path,
        # the recorder captures the incident and the post hook lands
        # the verdict — nothing in this gate calls the autopsy plane
        # directly
        TR._rb_phase(broker.url, mix, "cbase", qps=50.0)
        t_cut = t_cut_after(0)
        check("baseline.stats", t_cut > 0.0,
              "no baseline query_stats landed in the ledger")
        global_slo.set_objective(TR.AUTOPSY_TABLE, "latency",
                                 bar_ms=0.01, objective=0.9)
        straggler = faults.install(     # the cause the verdict names
            f"seed={args.seed}; segment.slow: match=server_0, "
            f"delay_ms={TR.AUTOPSY_DELAY_MS:.0f}, times=-1")
        TR._rb_phase(broker.url, mix, "cburn", qps=50.0)
        deadline = _time.monotonic() + 10.0
        while _time.monotonic() < deadline and \
                global_incidents.snapshot(limit=0)["count"] < 1:
            _time.sleep(0.05)
        global_slo.clear()      # disarm before the clean window
        faults.clear()
        summary["faults_fired"] += len(straggler.fired)
        TR.quiesce()            # the straggler's abandoned executions
        check("incident.captured",
              global_incidents.snapshot(limit=0)["count"] >= 1,
              "burn alert never captured an incident")
        check("incident.drained", global_incidents.drain(timeout=10.0),
              "capture queue never drained")

        # (b) the ring answers "what burned AND why" in one lookup,
        # and the landed verdict honors the ledger contract
        entry = (global_incidents.snapshot(limit=1)["incidents"]
                 or [{}])[0]
        check("incident.rca_ref", bool(entry.get("rca")),
              f"no rca ref on {entry.get('incident_id')}")
        ap = global_autopsy.snapshot(limit=1)
        summary["autopsies"] = ap["computed"]
        check("autopsy.computed",
              ap["computed"] >= 1 and ap["errors"] == 0,
              f"computed={ap['computed']} errors={ap['errors']}")
        lres = uledger.validate_file(path)
        summary["ledger_kinds"] = lres["kinds"]
        check("ledger.valid", not lres["errors"],
              f"invalid records: {lres['errors'][:3]}")
        check("ledger.rca_verdict",
              lres["kinds"].get("rca_verdict", 0) >= 1,
              f"kinds={lres['kinds']}")

        # (c) fleet-level attribution: pull the node ledger into the
        # rollup's fleet ledger, plan over THAT corpus, and walk every
        # evidence pointer back to its ledger line
        ctrl.rollup.run()
        fleet_path = ctrl.rollup.ledger_path
        fleet = plan_autopsy(load_corpus(fleet_path),
                             window=(t_cut, None))
        summary["fleet_top"] = fleet["top_cause"]
        check("fleet.top_cause", fleet["top_cause"] == "straggler",
              f"top {fleet['top_cause'] or '<inconclusive>'}: " +
              ", ".join(f"{c['cause']}={c['score']}"
                        for c in fleet["causes"][:3]))
        ptrs = [p for c in fleet["causes"] for p in c["evidence"]]
        summary["evidence_pointers"] = len(ptrs)
        check("fleet.evidence", len(ptrs) >= 1, "verdict has no "
              "evidence to resolve")
        for node, proc, seq in ptrs:
            recs, _ = read_ledger_since(fleet_path, seq - 1)
            hit = recs[0] if recs else {}
            if not (str(hit.get("node") or "") == node
                    and str(hit.get("proc") or "") == proc):
                check(f"fleet.pointer.{seq}", False,
                      f"[{node},{proc},{seq}] resolved to "
                      f"{hit.get('kind')}/{hit.get('node')}/"
                      f"{hit.get('proc')}")

        # (d) no anomaly -> an EXPLICIT inconclusive, not a
        # confabulated cause
        seq0 = load_corpus(path)[-1]["_seq"]
        TR._rb_phase(broker.url, mix, "ccb", qps=50.0)
        t_clean = t_cut_after(seq0)
        TR._rb_phase(broker.url, mix, "ccw", qps=50.0)
        clean = plan_autopsy(
            [r for r in load_corpus(path) if r["_seq"] > seq0],
            window=(t_clean, None))
        check("clean.inconclusive",
              clean["inconclusive"] and clean["top_cause"] == "",
              f"clean window confabulated {clean['top_cause']}="
              f"{clean['causes'][0]['score']}")
    except Exception as e:  # noqa: BLE001 — into the summary
        check("autopsy.run", False, f"EXC {type(e).__name__}: {e}")
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

    summary["ok"] = not failures
    summary["failures"] = failures
    print(json.dumps(summary))
    return 0 if not failures else 1


VECTOR_ROWS = 4096
VECTOR_DIM = 16
VECTOR_LISTS = 16
VECTOR_K = 8


def build_vector_cluster(tmp: str, rows: int, seed: int,
                         n_segments: int = 4, poll: float = 0.1,
                         device="cuda"):
    """Controller + 2 servers + broker over a ``vectors`` table
    (replication 2) with an IVF vector index on ``emb``. Returns
    (ctrl, servers, broker, stop, query_vectors)."""
    import numpy as np
    from ..cluster import BrokerNode, Controller, ServerNode
    from ..segment import SegmentBuilder
    from ..spi import Schema, TableConfig
    from ..spi.config import IndexingConfig
    from ..spi.schema import DataType, FieldSpec, FieldType

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, VECTOR_DIM)).astype(np.float32)
    a = rng.integers(0, 8, rows)
    vecs = (centers[a] + 0.15 * rng.standard_normal(
        (rows, VECTOR_DIM))).astype(np.float32)
    data = {"id": np.arange(rows, dtype=np.int64), "emb": vecs,
            "views": rng.integers(0, 1000, rows).astype(np.int32)}
    qvecs = vecs[rng.integers(0, rows, 4)] + 0.01 * rng.standard_normal(
        (4, VECTOR_DIM)).astype(np.float32)

    schema = Schema("vectors", [
        FieldSpec("id", DataType.LONG, FieldType.DIMENSION),
        FieldSpec("emb", DataType.FLOAT, FieldType.DIMENSION),
        FieldSpec("views", DataType.INT, FieldType.METRIC)])
    cfg = TableConfig("vectors", indexing=IndexingConfig(
        vector_index_columns={"emb": {
            "metric": "cosine", "nLists": VECTOR_LISTS, "seed": 7}}))
    ctrl = Controller(os.path.join(tmp, "ctrl"), heartbeat_timeout=5.0,
                      reconcile_interval=0.2)
    servers = [ServerNode(f"server_{i}", ctrl.url, poll_interval=poll,
                          device=device) for i in range(2)]
    broker = BrokerNode(ctrl.url, routing_refresh=poll,
                        query_stats_path=os.path.join(
                            tmp, "query_stats.jsonl"))
    builder = SegmentBuilder(schema, cfg)
    ctrl.add_table("vectors", schema.to_dict(), replication=2)
    step = rows // n_segments
    for i in range(n_segments):
        lo, hi = i * step, rows if i == n_segments - 1 \
            else (i + 1) * step
        d = builder.build({k: v[lo:hi] for k, v in data.items()},
                          os.path.join(tmp, "vectors"), f"seg_{i}")
        ctrl.add_segment("vectors", f"seg_{i}", d)
    v = ctrl.routing_snapshot()["version"]
    for s in servers:
        assert s.wait_for_version(v, timeout=30.0), "server never synced"
    assert broker.wait_for_version(v, timeout=30.0), \
        "broker never synced"

    def stop():
        TR.stop_cluster(ctrl, servers, broker)

    return ctrl, servers, broker, stop, qvecs


def vector_sql(qvec, k: int = VECTOR_K) -> str:
    arr = ", ".join(f"{float(x):.6f}" for x in qvec)
    vs = f"VECTOR_SIMILARITY(emb, ARRAY[{arr}], {k})"
    return (f"SELECT id, {vs} AS score FROM vectors WHERE {vs} "
            f"ORDER BY {vs} DESC LIMIT {k}")


def main_vector(args) -> int:
    """--vector: the vector-search chaos gate: seeded
    VECTOR_SIMILARITY top-k queries over a 2-server cluster must
    (a) fail over byte-identically under ``rpc.drop`` with same-seed
    runs firing identical decision streams, (b) recover byte-identical
    top-k from a mid-query ``tier.evict`` demotion of the vector pool,
    (c) reject malformed calls as structured errors even under chaos,
    and (d) leave the ``vector`` devmem pool reconciled to the byte."""
    from ..cluster.http_util import http_json
    from ..index import vector as vix
    from ..utils import faults
    from ..utils.devmem import global_device_memory

    tmp = tempfile.mkdtemp(prefix="ptpu_vector_chaos_")
    failures = []
    summary = {"mode": "vector", "rows": args.rows, "seed": args.seed,
               "queries": 0, "faults_fired": 0}

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"{name}: {detail}")
            print(f"FAIL {name}: {detail}")

    faults.clear()
    # start from devmem-synced vector residents: inside a warm pytest
    # process, earlier tests' readers can still hold device arrays
    # whose pool accounting the per-test reset already cleared (the
    # --tier gate's cache-clear discipline, applied to this pool)
    for r in vix.live_readers():
        r.evict_device()
    ctrl, servers, broker, stop, qvecs = build_vector_cluster(
        tmp, args.rows, args.seed, device=args.device)
    try:
        sqls = [vector_sql(q) for q in qvecs]

        def run_all(tag):
            out = {}
            for i, sql in enumerate(sqls):
                resp = http_json(
                    "POST", f"{broker.url}/query/sql",
                    {"sql": sql + f" OPTION(timeoutMs=300000,"
                                  f"queryId=vec.{tag}.{i})"},
                    timeout=120.0)
                out[i] = digest(resp)
            return out

        baseline = run_all("base")
        summary["queries"] = len(sqls)
        check("baseline.rows", all(baseline.values()),
              "a fault-free vector query returned no rows")

        # (a) rpc.drop failover: server_0's first /query/bin dispatch
        # dies; the broker must fail over to the replica and answer
        # byte-identically, two same-seed runs firing identical streams
        # (port-scoped match: heartbeat traffic must not join the
        # stream comparison — background timing isn't deterministic)
        p0 = servers[0].port
        plan_text = (f"seed={args.seed}; "
                     f"rpc.drop: match=:{p0}/query/bin, times=1")

        def run_plan(tag):
            # clear the previous plan's failure backoff so the
            # selector dials server_0 again and the fault re-fires —
            # same-seed determinism is a property of the decision
            # STREAMS, so both runs must present the same dial pattern
            for s in servers:
                broker._failures.record_success(s.instance_id)
            plan = faults.install(plan_text)
            try:
                got = run_all(tag)
            finally:
                faults.clear()
            return plan, got

        plan1, got1 = run_plan("drop")
        summary["faults_fired"] += len(plan1.fired)
        check("rpc_drop.fired", len(plan1.fired) >= 1,
              "rpc.drop never fired")
        for i in baseline:
            check(f"rpc_drop.q{i}", got1[i] == baseline[i],
                  "top-k digest mismatch after failover")
        plan2, got2 = run_plan("drop")
        check("rpc_drop.deterministic",
              plan1.fired_summary() == plan2.fired_summary(),
              f"{plan1.fired_summary()} != {plan2.fired_summary()}")
        for i in baseline:
            check(f"rpc_drop.rerun.q{i}", got2[i] == baseline[i],
                  "digest mismatch on same-seed rerun")

        # (b) tier.evict mid-query: the vector pool's device residents
        # drop between accesses; the search must re-upload and answer
        # byte-identically (once per query stream, every query)
        plan3 = faults.install(
            f"seed={args.seed}; tier.evict: match=seg_1, times=1")
        got3 = run_all("evict")
        faults.clear()
        summary["faults_fired"] += len(plan3.fired)
        check("tier_evict.fired", len(plan3.fired) >= 1,
              "tier.evict never fired")
        for i in baseline:
            check(f"tier_evict.q{i}", got3[i] == baseline[i],
                  "top-k digest mismatch after mid-query demotion")

        # (c) structured errors survive chaos: a bad-dim call is a
        # user error (HTTP 400 / SqlError), never a partial result
        from urllib.error import HTTPError
        try:
            http_json("POST", f"{broker.url}/query/sql",
                      {"sql": "SELECT id FROM vectors WHERE "
                              "VECTOR_SIMILARITY(emb, ARRAY[1.0], 3) "
                              "LIMIT 3"}, timeout=60.0)
            check("bad_dim.structured", False, "no error raised")
        except HTTPError as e:
            body = e.read().decode("utf-8", "replace")
            check("bad_dim.structured",
                  e.code == 400 and "dim mismatch" in body,
                  f"HTTP {e.code}: {body[:200]}")
        except Exception as e:  # noqa: BLE001 — into the summary
            check("bad_dim.structured", False,
                  f"unexpected error: {e}")

        # (d) vector pool reconciles to the byte across the churn
        tracked = global_device_memory.pool_bytes("vector")
        actual = sum(r.device_bytes() for r in vix.live_readers())
        summary["vector_pool"] = {"tracked": tracked, "actual": actual}
        check("reconcile.vector", tracked == actual,
              f"tracked {tracked} != actual {actual}")

        # forensics ride along for free: every vector query landed a
        # validated query_stats record
        from ..utils import ledger as uledger
        res = uledger.validate_file(
            os.path.join(tmp, "query_stats.jsonl"))
        check("query_stats.valid", not res["errors"],
              f"invalid records: {res['errors'][:3]}")
        check("query_stats.count",
              res["kinds"].get("query_stats", 0) >= 4 * len(sqls),
              f"{res['kinds'].get('query_stats', 0)} records for "
              f"{4 * len(sqls)} queries")
    finally:
        faults.clear()
        stop()
        shutil.rmtree(tmp, ignore_errors=True)

    summary["ok"] = not failures
    summary["failures"] = failures
    print(json.dumps(summary))
    return 0 if not failures else 1


FUSED_ROWS = 65536
FUSED_DROP_TIMEOUT_S = 3.0


def build_fused_broker(tmp: str, rows: int, seed: int, device="cuda"):
    """In-process broker over a 3-table join star (the whole-plan mesh
    compilation surface: fact ``orders`` in 4 segments + two dims)."""
    import numpy as np

    from ..broker import Broker
    from ..segment import SegmentBuilder
    from ..server import TableDataManager
    from ..spi import (DataType, FieldSpec, FieldType, Schema,
                               TableConfig)

    rng = np.random.default_rng(seed)
    n_cust = max(rows // 4, 64)
    n_part = max(rows // 64, 16)
    tables = {
        "customers": ({
            "c_id": np.arange(n_cust).astype(np.int32),
            "c_nation": rng.choice(["us", "de", "jp", "br", "cn"],
                                   n_cust),
        }, [FieldSpec("c_id", DataType.INT),
            FieldSpec("c_nation", DataType.STRING)], 1),
        "parts": ({
            "p_id": np.arange(n_part).astype(np.int32),
            "p_brand": rng.choice(["acme", "blitz", "corex"], n_part),
        }, [FieldSpec("p_id", DataType.INT),
            FieldSpec("p_brand", DataType.STRING)], 1),
        "orders": ({
            "o_key": np.arange(rows).astype(np.int64),
            "o_cust": rng.choice(n_cust, rows).astype(np.int32),
            "o_part": rng.choice(n_part, rows).astype(np.int32),
            "o_price": rng.integers(10, 5000, rows).astype(np.int64),
        }, [FieldSpec("o_key", DataType.LONG),
            FieldSpec("o_cust", DataType.INT),
            FieldSpec("o_part", DataType.INT),
            FieldSpec("o_price", DataType.LONG, FieldType.METRIC)], 4),
    }
    broker = Broker(device=device)
    for name, (cols, fields, n_segments) in tables.items():
        schema = Schema(name, fields)
        b = SegmentBuilder(schema, TableConfig(name))
        dm = TableDataManager(name, device=device)
        n = len(next(iter(cols.values())))
        step = -(-n // n_segments)
        for i in range(n_segments):
            chunk = {k: v[i * step:(i + 1) * step]
                     for k, v in cols.items()}
            dm.add_segment_dir(b.build(chunk, os.path.join(tmp, name),
                                       f"s{i}"))
        broker.register_table(dm)
    return broker, tables


FUSED_MIX = [
    "SELECT c.c_nation, SUM(o.o_price), COUNT(*) FROM orders o "
    "JOIN customers c ON o.o_cust = c.c_id "
    "GROUP BY c.c_nation ORDER BY c.c_nation LIMIT 10",
    "SELECT c.c_nation, p.p_brand, SUM(o.o_price) FROM orders o "
    "JOIN customers c ON o.o_cust = c.c_id "
    "JOIN parts p ON o.o_part = p.p_id "
    "GROUP BY c.c_nation, p.p_brand "
    "ORDER BY c.c_nation, p.p_brand LIMIT 20",
    "SELECT c.c_nation, o.o_key, "
    "ROW_NUMBER() OVER (PARTITION BY c.c_nation ORDER BY o.o_key) "
    "FROM orders o JOIN customers c ON o.o_cust = c.c_id "
    "WHERE o.o_price > 4900 ORDER BY c.c_nation, o.o_key LIMIT 50",
    "SELECT c.c_nation, SUM(o.o_price) FROM orders o "
    "JOIN customers c ON o.o_cust = c.c_id "
    "WHERE o.o_price > 2500 GROUP BY c.c_nation "
    "UNION ALL "
    "SELECT p.p_brand, SUM(o.o_price) FROM orders o "
    "JOIN parts p ON o.o_part = p.p_id "
    "WHERE o.o_price <= 2500 GROUP BY p.p_brand",
]


def main_fused(args) -> int:
    """--fused: the whole-plan fused-plane chaos gate:
    (a) fused == mailbox byte-identical digests over a join + window +
    set-op mix, (b) a p=1.0 ``device.overflow`` plan forces the real
    fallback edge — the mailbox plane serves every query byte-
    identically, two same-seed runs firing identical streams — and
    (c) a cross-host distributed_join under a seeded ``rpc.drop``
    pins that cross-process plans ride the mailbox data plane (the
    fused counter never moves), fail LOUDLY when a frame drops, and
    answer byte-identical to the numpy oracle once the fault clears."""
    import numpy as np

    from ..multistage import fused
    from ..utils import faults

    tmp = tempfile.mkdtemp(prefix="ptpu_fused_chaos_")
    failures = []
    summary = {"mode": "fused", "rows": args.rows, "seed": args.seed,
               "queries": len(FUSED_MIX), "faults_fired": 0}

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"{name}: {detail}")
            print(f"FAIL {name}: {detail}")

    def dig(res):
        return sorted(tuple(r) for r in res.rows)

    faults.clear()
    broker, _tables = build_fused_broker(tmp, args.rows, args.seed,
                                         device=args.device)
    try:
        # (a) parity: every mix query byte-identical across planes,
        # and the fused plane genuinely engaged
        plans0 = fused.STATS["fused_plans"]
        for i, q in enumerate(FUSED_MIX):
            d_m = dig(broker.query(q + " OPTION(multistageFused=false)"))
            d_f = dig(broker.query(q + " OPTION(multistageFused=true)"))
            check(f"parity.q{i}", d_f == d_m,
                  "fused and mailbox digests differ")
        check("parity.engaged",
              fused.STATS["fused_plans"] - plans0 >= len(FUSED_MIX),
              "the fused plane never engaged on the mix")

        # (b) device.overflow chaos: forced overflow takes the real
        # fallback edge; the mailbox plane must serve every query
        # byte-identically and same-seed runs fire identical streams
        def overflow_run():
            plan = faults.install(
                f"seed={args.seed}; device.overflow: "
                f"match=multistage.fused, p=1.0")
            try:
                out = [dig(broker.query(
                    q + " OPTION(multistageFused=true)"))
                    for q in FUSED_MIX]
            finally:
                faults.clear()
            return plan, out

        fb0 = fused.STATS["fused_fallbacks"]
        plan1, got1 = overflow_run()
        summary["faults_fired"] += len(plan1.fired)
        check("overflow.fired", len(plan1.fired) >= len(FUSED_MIX),
              f"{len(plan1.fired)} fires for {len(FUSED_MIX)} queries")
        check("overflow.fallbacks",
              fused.STATS["fused_fallbacks"] - fb0 >= len(FUSED_MIX),
              "forced overflow did not route the mailbox fallback")
        for i, q in enumerate(FUSED_MIX):
            check(f"overflow.q{i}",
                  got1[i] == dig(broker.query(
                      q + " OPTION(multistageFused=false)")),
                  "digest mismatch on the chaos fallback path")
        plan2, got2 = overflow_run()
        check("overflow.deterministic",
              plan1.fired_summary() == plan2.fired_summary(),
              f"{plan1.fired_summary()} != {plan2.fired_summary()}")
        check("overflow.rerun", got1 == got2,
              "same-seed rerun digests differ")

        # (c) cross-host plans ride the mailbox data plane: a 2-process
        # distributed_join never touches the fused counter; a seeded
        # rpc.drop of one mailbox frame fails the stage loudly (no
        # partial relation), same-seed reruns fire identical streams,
        # and the join is byte-exact once the fault clears
        from ..cluster import Controller, ServerNode
        from ..multistage.dispatch import distributed_join
        from ..segment import SegmentBuilder
        from ..spi import (DataType, FieldSpec, FieldType,
                                   Schema, TableConfig)

        rng = np.random.default_rng(args.seed + 1)
        n_o, n_c = 400, 50
        xo = {"cust_id": rng.integers(0, n_c + 5, n_o)
              .astype(np.int32),
              "amount": rng.integers(1, 1000, n_o).astype(np.int32)}
        xc = {"id": np.arange(n_c, dtype=np.int32),
              "tier": rng.choice(["gold", "silver"], n_c)}
        ctrl = Controller(os.path.join(tmp, "ctrl"),
                          heartbeat_timeout=5.0,
                          reconcile_interval=0.2)
        servers = [ServerNode(f"server_{i}", ctrl.url,
                              poll_interval=0.1, device=args.device)
                   for i in range(2)]
        try:
            so = Schema("xorders", [
                FieldSpec("cust_id", DataType.INT),
                FieldSpec("amount", DataType.INT, FieldType.METRIC)])
            sc = Schema("xcust", [
                FieldSpec("id", DataType.INT),
                FieldSpec("tier", DataType.STRING)])
            ctrl.add_table("xorders", so.to_dict(), replication=1)
            ctrl.add_table("xcust", sc.to_dict(), replication=1)
            ctrl.add_segment("xorders", "xorders_0", SegmentBuilder(
                so, TableConfig("xorders")).build(
                xo, os.path.join(tmp, "xseg"), "xorders_0"))
            ctrl.add_segment("xcust", "xcust_0", SegmentBuilder(
                sc, TableConfig("xcust")).build(
                xc, os.path.join(tmp, "xseg"), "xcust_0"))
            v = ctrl.routing_snapshot()["version"]
            for s in servers:
                assert s.wait_for_version(v, timeout=30.0)

            def owner_url(table):
                for s in servers:
                    dm = s._tables.get(table)
                    if dm is not None and dm.acquire_segments():
                        return s.url
                raise AssertionError(table)

            def run_join(timeout: float = 60.0):
                return distributed_join(
                    [{"url": owner_url("xorders"),
                      "sql": "SELECT cust_id, amount FROM xorders "
                             "LIMIT 100000", "alias": "o"}],
                    [{"url": owner_url("xcust"),
                      "sql": "SELECT id, tier FROM xcust "
                             "LIMIT 100000", "alias": "c"}],
                    [s.url for s in servers],
                    ["o.cust_id"], ["c.id"], timeout=timeout)

            plans_x = fused.STATS["fused_plans"]
            drop_text = (f"seed={args.seed}; rpc.drop: "
                         f"match=/mailbox, times=1")

            def drop_run():
                plan = faults.install(drop_text)
                loud = False
                try:
                    # the join stage waits ``timeout`` for the dropped
                    # frame, then fails (the JAX gate waits 60 s)
                    run_join(timeout=FUSED_DROP_TIMEOUT_S)
                except Exception:
                    loud = True
                finally:
                    faults.clear()
                return plan, loud

            pland1, loud1 = drop_run()
            summary["faults_fired"] += len(pland1.fired)
            check("rpc_drop.fired", len(pland1.fired) >= 1,
                  "rpc.drop never fired on the mailbox plane")
            check("rpc_drop.loud", loud1,
                  "a dropped mailbox frame did not fail the stage")
            pland2, loud2 = drop_run()
            check("rpc_drop.deterministic",
                  pland1.fired_summary() == pland2.fired_summary(),
                  f"{pland1.fired_summary()} != "
                  f"{pland2.fired_summary()}")
            check("rpc_drop.rerun_loud", loud2,
                  "same-seed rerun did not fail the stage")

            rel = run_join()
            tier = {int(i): t for i, t in zip(xc["id"], xc["tier"])}
            exp = sorted((int(c), int(a), tier[int(c)]) for c, a in
                         zip(xo["cust_id"], xo["amount"])
                         if int(c) in tier)
            got = sorted(zip(rel.data["o.cust_id"].tolist(),
                             rel.data["o.amount"].tolist(),
                             rel.data["c.tier"].tolist()))
            check("crosshost.digest", got == exp,
                  "distributed join differs from the numpy oracle")
            check("crosshost.mailbox_pinned",
                  fused.STATS["fused_plans"] == plans_x,
                  "a cross-host plan engaged the fused plane")
        finally:
            try:
                TR.stop_servers(servers)
            finally:
                ctrl.stop()
    finally:
        faults.clear()
        TR.retire_segments(broker)
        shutil.rmtree(tmp, ignore_errors=True)

    summary["ok"] = not failures
    summary["failures"] = failures
    print(json.dumps(summary))
    return 0 if not failures else 1


def main_overload(args) -> int:
    """--overload: the overload-resilience gate. One closed-
    loop traffic replay (tools/traffic_replay.py, cluster mode): record
    a three-tenant mix at 1x, replay it at --multiple N with chaos
    armed, and assert the acceptance contract — protected-tenant p99
    inside its bar with ZERO sheds/kills while besteffort sheds absorb
    the excess, every shed a structured 429 with retryAfterMs, the
    shed stream byte-identical to the pure same-seed plan, post-spike
    latency back inside the pre-spike noise floor, and >=1 validated
    ``replay_bench`` ledger record."""
    from ..utils import ledger as uledger

    tmp = tempfile.mkdtemp(prefix="ptpu_overload_")
    ledger_path = os.path.join(tmp, "replay_bench.jsonl")
    failures = []
    summary = {"mode": "overload", "seed": args.seed,
               "multiple": args.multiple, "rows": args.rows}

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"{name}: {detail}")
            print(f"FAIL {name}: {detail}")

    try:
        res = TR.run_gate(multiple=args.multiple, seed=args.seed,
                          n_queries=args.replay_queries, rows=args.rows,
                          mode="cluster", chaos=True,
                          ledger_out=ledger_path, device=args.device)
        summary.update({k: res.get(k) for k in (
            "offered", "completed", "shed", "shed_by_tenant",
            "shed_by_rung", "tiers", "structured_429", "retries",
            "deterministic", "protected_sheds", "protected_p99_ms",
            "protected_bar_ms", "goodput_qps", "faults_fired",
            "recovered", "recovery")})
        check("overload.ok", res.get("ok") is True,
              res.get("error", "gate failed"))
        check("overload.deterministic", res.get("deterministic") is True,
              "same-seed shed streams diverged")
        check("overload.protected_untouched",
              res.get("protected_sheds") == 0
              and (res.get("tiers") or {}).get(
                  "protected", {}).get("errors", 1) == 0,
              f"protected sheds={res.get('protected_sheds')} "
              f"errors={(res.get('tiers') or {}).get('protected')}")
        check("overload.besteffort_absorbs",
              (res.get("shed_by_tenant") or {}).get(
                  "ten_besteffort", 0) >= 1,
              f"shed_by_tenant={res.get('shed_by_tenant')}")
        check("overload.structured_429",
              res.get("structured_429") == res.get("shed")
              and res.get("shed", 0) >= 1,
              f"{res.get('structured_429')} structured of "
              f"{res.get('shed')} sheds")
        check("overload.chaos_fired", res.get("faults_fired", 0) >= 1,
              "the armed chaos plan never fired")
        check("overload.recovered", res.get("recovered") is True,
              f"recovery={res.get('recovery')}")
        lres = uledger.validate_file(ledger_path)
        summary["ledger_kinds"] = lres["kinds"]
        check("overload.ledger_valid", not lres["errors"],
              f"invalid records: {lres['errors'][:3]}")
        check("overload.replay_bench_record",
              lres["kinds"].get("replay_bench", 0) >= 1,
              f"kinds={lres['kinds']}")
    except Exception as e:  # noqa: BLE001 — into the summary
        check("overload.run", False, f"EXC {type(e).__name__}: {e}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    summary["ok"] = not failures
    summary["failures"] = failures
    print(json.dumps(summary))
    return 0 if not failures else 1


def main_rate(args) -> int:
    """--rate: the sustained ingest-while-query chaos gate (module
    docstring). Chaos-armed loadgen run -> oracle exactness + validated
    ingest_bench/ingest_stats records -> fault-free freshness-gate
    capture+check vs the checked-in baseline."""
    from ..engine.loadgen import (LoadgenConfig, TableLoadSpec,
                                          run_load)
    from ..tools.ingest_fuzz import ingest_plan
    from ..utils import faults
    from ..utils import ledger as uledger

    tmp = tempfile.mkdtemp(prefix="ptpu_rate_chaos_")
    ledger_path = os.path.join(tmp, "ingest_bench.jsonl")
    failures = []
    summary = {"mode": "rate", "rows": args.rows, "seed": args.seed}

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"{name}: {detail}")
            print(f"FAIL {name}: {detail}")

    faults.clear()
    try:
        cfg = LoadgenConfig(
            tables=[
                TableLoadSpec("rate_append", partitions=2),
                TableLoadSpec("rate_upsert", partitions=2, upsert=True,
                              protocol=True),
            ],
            seed=args.seed,
            rows_per_partition=args.rows,
            query_concurrency=2,
            scenario="chaos_rate",
            fault_plan=ingest_plan(args.seed, protocol=True),
            ledger_path=ledger_path,
            max_wall_s=90.0)
        res = run_load(os.path.join(tmp, "run"), cfg, device=args.device)
        summary.update(
            {k: res.get(k) for k in
             ("rows", "rows_per_s", "duration_s", "freshness_p50_ms",
              "freshness_p99_ms", "commit_p50_ms", "queries",
              "query_p50_ms", "query_errors", "restarts",
              "faults_fired", "batched", "oracle_ok")})
        # (a) chaos actually happened AND the final state is byte-exact
        # vs the fault-free oracle (run_load diffs per table/partition)
        check("rate.ok", res.get("ok") is True,
              res.get("error", "oracle mismatch"))
        check("rate.fired", res.get("faults_fired", 0) >= 1,
              "the armed plan never fired")
        check("rate.queries_ran", res.get("queries", 0) >= 1,
              "no concurrent queries completed")
        # (b) validated ledger: one ingest_bench + per-table stats rows
        lres = uledger.validate_file(ledger_path)
        summary["ledger_kinds"] = lres["kinds"]
        check("rate.ledger_valid", not lres["errors"],
              f"invalid records: {lres['errors'][:3]}")
        check("rate.ingest_bench_record",
              lres["kinds"].get("ingest_bench", 0) >= 1
              and lres["kinds"].get("ingest_stats", 0) >= 2,
              f"kinds={lres['kinds']}")
        # (c) the freshness ratchet: fresh fault-free gate-corpus
        # capture checked against the port's checked-in baseline
        gate_ledger = os.path.join(tmp, "gate_corpus.jsonl")
        try:
            FG.capture(gate_ledger, iters=args.gate_iters,
                       device=args.device)
            rc = FG.main(["check", gate_ledger,
                          "--device", str(args.device)])
            summary["freshness_gate_exit"] = rc
            check("rate.freshness_gate", rc == 0, f"exit {rc}")
        except Exception as e:  # noqa: BLE001 — into the summary
            check("rate.freshness_gate", False,
                  f"EXC {type(e).__name__}: {e}")
    finally:
        faults.clear()
        shutil.rmtree(tmp, ignore_errors=True)

    summary["ok"] = not failures
    summary["failures"] = failures
    print(json.dumps(summary))
    return 0 if not failures else 1


def _rollup_gate(ctrl, broker, tmp, queries, seed, check, device) -> dict:
    """The fleet-rollup chaos gate: fault-kill one broker's ledger pull
    mid-rollup, then assert skip-count + exact per-table totals + a
    valid fleet ledger + the --fleet span check (in ``device``'s
    environment)."""
    from ..cluster import BrokerNode
    from ..cluster.http_util import http_json
    from ..utils import faults
    from ..utils import ledger as uledger

    out: dict = {}
    b2 = BrokerNode(ctrl.url, routing_refresh=0.1,
                    query_stats_path=os.path.join(tmp, "qs_broker2.jsonl"))
    # the fault arms BEFORE broker2 serves any ledger pull: every pull
    # of it — including an auto-fired periodic pass — dies, so its rows
    # can never leak into the fleet ledger and the exactness assert
    # below is airtight
    plan = faults.install(
        f"seed={seed}; rpc.drop: match=:{b2.port}/debug/ledger")
    try:
        assert b2.wait_for_version(
            ctrl.routing_snapshot()["version"], timeout=30.0)
        qid, sql = queries[0]
        http_json("POST", f"{b2.url}/query/sql", {"sql": sql + OPTION},
                  timeout=120.0)
        rollup = None
        try:
            rollup = ctrl.rollup.run()
        except Exception as e:  # noqa: BLE001 — into the summary
            check("rollup.run", False, f"EXC {type(e).__name__}: {e}")
        out["rollup_faults_fired"] = len(plan.fired)
        check("rollup.pull_fault_fired", len(plan.fired) >= 1,
              "the /debug/ledger rpc.drop never fired")
        if rollup is not None:
            check("rollup.valid",
                  not uledger.validate_record(rollup),
                  f"{uledger.validate_record(rollup)}")
            check("rollup.dead_broker_counted",
                  rollup["nodes_skipped"] >= 1
                  and b2.instance_id in rollup.get("skipped_nodes", []),
                  f"skipped={rollup.get('skipped_nodes')}")
            # exactness: fleet per-table query counts == sum over the
            # brokers whose pulls SURVIVED of their own ledger rows
            expected: dict = {}
            for rec in _iter_stats(broker.forensics.ledger_path):
                t = rec.get("table")
                expected[t] = expected.get(t, 0) + 1
            got = {t: s.get("queries", 0)
                   for t, s in rollup["tables"].items()}
            check("rollup.table_totals_exact", got == expected,
                  f"rollup {got} != surviving brokers {expected}")
            out["rollup_tables"] = got
        # the whole fleet ledger must be contract-valid, rollup
        # records included (check_ledger reports the new kind)
        res = uledger.validate_file(ctrl.rollup.ledger_path)
        check("fleet_ledger.valid", not res["errors"],
              f"invalid records: {res['errors'][:3]}")
        check("fleet_ledger.kinds",
              res["kinds"].get("fleet_rollup", 0) >= 1
              and res["kinds"].get("query_stats", 0) >= 1,
              f"kinds={res['kinds']}")
        out["fleet_ledger_kinds"] = res["kinds"]
        # fleet span-diff over the aggregated (node-stamped) trace
        # corpus: per-node calibration, same env as the baseline
        rc = span_diff.main(["check", "--fleet", ctrl.rollup.ledger_path,
                             "--device", str(device)])
        out["fleet_span_diff_exit"] = rc
        check("fleet_span_diff", rc == 0, f"exit {rc}")
    finally:
        faults.clear()
        b2.stop()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=None,
                    help="table rows (default: 4096 cluster mode, "
                         "300/seeded-run ingest mode)")
    ap.add_argument("--seed", type=int, default=20260804)
    ap.add_argument("--queries", default=",".join(SMOKE_QUERY_IDS),
                    help="comma-separated SSB qids (the tests run a "
                         "2-query subset to protect the suite budget)")
    ap.add_argument("--ingest", action="store_true",
                    help="run the realtime ingest chaos gate instead "
                         "of the cluster query gate")
    ap.add_argument("--rate", action="store_true",
                    help="run the sustained ingest-while-query rate "
                         "gate (loadgen + ingest_bench + freshness "
                         "ratchet)")
    ap.add_argument("--overload", action="store_true",
                    help="run the closed-loop traffic-replay overload "
                         "gate (tools/traffic_replay.py cluster mode)")
    ap.add_argument("--tier", action="store_true",
                    help="run the HBM-tier gate: mid-query tier.evict "
                         "recovery + constrained-budget demotion with "
                         "devmem reconciliation")
    ap.add_argument("--vector", action="store_true",
                    help="run the vector-search gate: seeded "
                         "VECTOR_SIMILARITY queries under rpc.drop + "
                         "tier.evict with identical top-k and a "
                         "reconciled vector devmem pool")
    ap.add_argument("--rebalance", action="store_true",
                    help="run the closed-loop rebalance gate: "
                         "burn-triggered move under rebalance.crash + "
                         "cutover.stall recovers byte-exact, incident "
                         "freeze honored, pools reconciled")
    ap.add_argument("--autopsy", action="store_true",
                    help="run the incident-autopsy gate: a real SLO "
                         "burn -> incident -> post-hook rca_verdict "
                         "with resolvable fleet evidence pointers, "
                         "and a clean window says inconclusive")
    ap.add_argument("--fused", action="store_true",
                    help="run the whole-plan mesh compilation gate: "
                         "fused == mailbox parity, device.overflow "
                         "fallback and cross-host mailbox pinning "
                         "under seeded rpc.drop")
    ap.add_argument("--multiple", type=float, default=4.0,
                    help="--overload mode: replay load multiple")
    ap.add_argument("--replay-queries", type=int, default=40,
                    help="--overload mode: recorded-mix size")
    ap.add_argument("--seeds", default=",".join(map(str, INGEST_SEEDS)),
                    help="--ingest mode seeds (comma-separated)")
    ap.add_argument("--gate-iters", type=int, default=2,
                    help="--rate mode: freshness-gate capture "
                         "iterations (default %(default)s)")
    ap.add_argument("--device", default="cuda",
                    help="the servers', brokers' and tables' device "
                         "(default %(default)s; refused without a card "
                         "unless cpu)")
    args = ap.parse_args(argv)
    args.device = tool_device(args.device)
    if args.device is None:
        return 2
    if args.rows is None:
        args.rows = INGEST_ROWS if args.ingest \
            else RATE_ROWS if args.rate \
            else OVERLOAD_ROWS if args.overload \
            else TIER_ROWS if args.tier \
            else VECTOR_ROWS if args.vector \
            else REBALANCE_ROWS if args.rebalance \
            else AUTOPSY_ROWS if args.autopsy \
            else FUSED_ROWS if args.fused else 4096
    mode = main_ingest if args.ingest \
        else main_rate if args.rate \
        else main_overload if args.overload \
        else main_tier if args.tier \
        else main_vector if args.vector \
        else main_rebalance if args.rebalance \
        else main_autopsy if args.autopsy \
        else main_fused if args.fused else main_base
    try:
        return mode(args)
    finally:
        restore_globals()


def restore_globals() -> None:
    """Leave the process as a mode found it, whatever the mode did or
    raised: no fault plan armed, the governor unpinned, the workload,
    SLO, incident and autopsy planes reset and detached from the mode's
    (deleted) ledgers, no device budget. A process that runs several
    modes, or other work after one, starts each clean."""
    from ..broker.workload import global_governor, global_workload
    from ..cluster.autopsy import global_autopsy
    from ..engine.tier import global_tier
    from ..utils import faults
    from ..utils.slo import global_incidents, global_slo

    faults.clear()
    global_governor.unpin()
    global_workload.reset()
    global_slo.clear()
    global_slo.path = None
    global_incidents.reset()
    global_incidents.path = None
    global_incidents.post_hook = None
    global_autopsy.reset()
    global_autopsy.path = None
    global_tier.configure(budget_bytes=None)


def main_base(args) -> int:
    """The base mode (module docstring, 1-5): failover under rpc.drop
    and wire.corrupt, the partial-result contract, the ledgers, the
    fleet rollup, on ``args.device``."""
    from ..cluster.http_util import http_json
    from ..utils import faults
    from ..utils.metrics import global_metrics

    tmp = tempfile.mkdtemp(prefix="ptpu_chaos_")
    failures = []
    summary = {"rows": args.rows, "seed": args.seed, "plans": 0,
               "queries": 0, "faults_fired": 0}

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"{name}: {detail}")
            print(f"FAIL {name}: {detail}")

    faults.clear()
    span_path = span_diff.DEFAULT_BASELINE
    baseline_hash = _file_hash(span_path) \
        if os.path.exists(span_path) else None
    ctrl, servers, broker, stop = build_ssb_cluster(tmp, args.rows,
                                                    device=args.device)
    try:
        queries = smoke_queries(tuple(args.queries.split(",")))

        def run_all():
            out = {}
            for qid, sql in queries:
                # generous CLIENT timeout: the first query pays the
                # kernel builds (the broker-side budget is
                # OPTION(timeoutMs))
                resp = http_json("POST", f"{broker.url}/query/sql",
                                 {"sql": sql + OPTION}, timeout=120.0)
                out[qid] = digest(resp)
            return out

        baseline = run_all()
        summary["queries"] = len(baseline)
        p0 = servers[0].port

        # plan 1: drop server_0's first data-plane dispatch per key
        for plan_name, plan_text in (
                ("rpc.drop",
                 f"seed={args.seed}; "
                 f"rpc.drop: match=:{p0}/query/bin, times=1"),
                ("wire.corrupt",
                 f"seed={args.seed}; wire.corrupt: match=server_0, "
                 "times=1")):
            # clear the previous plan's failure backoff so the selector
            # dials server_0 again and this plan's fault actually fires
            for s in servers:
                broker._failures.record_success(s.instance_id)
            c0 = global_metrics.snapshot()["counters"]
            plan = faults.install(plan_text)
            try:
                got = run_all()
            finally:
                faults.clear()
            summary["plans"] += 1
            summary["faults_fired"] += len(plan.fired)
            check(f"{plan_name}.fired", len(plan.fired) >= 1,
                  "fault never fired")
            c1 = global_metrics.snapshot()["counters"]
            check(f"{plan_name}.failover",
                  c1.get("scatter_failovers", 0)
                  > c0.get("scatter_failovers", 0),
                  "no failover recorded")
            for qid in baseline:
                check(f"{plan_name}.{qid}", got[qid] == baseline[qid],
                      "digest mismatch after failover")

        # plan 3: replication-1 twin, server_0 permanently dropped —
        # the partial-result metadata contract
        plan = faults.install(
            f"seed={args.seed}; rpc.drop: match=:{p0}/query/bin")
        try:
            sql = ("SELECT d_year, SUM(lo_revenue) FROM lineorder_r1 "
                   "GROUP BY d_year ORDER BY d_year LIMIT 100 "
                   "OPTION(timeoutMs=300000,allowPartialResults=true)")
            resp = http_json("POST", f"{broker.url}/query/sql",
                             {"sql": sql}, timeout=120.0)
            summary["plans"] += 1
            summary["faults_fired"] += len(plan.fired)
            check("partial.flag", resp.get("partialResult") is True,
                  f"partialResult={resp.get('partialResult')}")
            check("partial.exceptions",
                  len(resp.get("exceptions", [])) >= 1, "no exceptions[]")
            check("partial.servers",
                  resp.get("numServersResponded", 0)
                  < resp.get("numServersQueried", 0),
                  f"{resp.get('numServersResponded')} !< "
                  f"{resp.get('numServersQueried')}")
            # default mode: whole-query failure
            import urllib.error
            try:
                http_json("POST", f"{broker.url}/query/sql", {
                    "sql": "SELECT SUM(lo_revenue) FROM lineorder_r1 "
                           "OPTION(timeoutMs=300000)"}, timeout=120.0)
                check("partial.default_fails", False,
                      "default mode returned despite dead replica")
            except urllib.error.HTTPError:
                pass
        finally:
            faults.clear()

        # recovery: fault-free digests once more (detector backoffs heal).
        # Any failure mode must land in the summary JSON, never a raw
        # traceback past the last print
        import time
        recovered = False
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not recovered:
            try:
                recovered = run_all() == baseline
            except urllib.error.HTTPError:
                pass
            if not recovered:
                time.sleep(0.5)
        check("recovery", recovered,
              "cluster did not recover fault-free digests within 30s")

        # forensics plane: the soak must have emitted one validated
        # query_stats record per cluster query
        from ..utils import ledger as uledger
        stats = uledger.validate_file(broker.forensics.ledger_path)
        n_stats = stats["kinds"].get("query_stats", 0)
        summary["query_stats"] = n_stats
        check("query_stats.valid", not stats["errors"],
              f"invalid records: {stats['errors'][:3]}")
        # baseline + two failover plans + the partial-contract plan +
        # recovery all route through BrokerNode.query: at minimum the
        # three full run_all passes must be on record
        check("query_stats.count", n_stats >= 3 * len(queries) + 1,
              f"only {n_stats} query_stats records for "
              f"{len(queries)} queries")
        check("query_stats.partial_flagged",
              any(True for _ in _iter_stats(
                  broker.forensics.ledger_path, partial=True)),
              "no partialResult=true query_stats record from the "
              "replication-1 plan")
        # traceRatio=1.0 sampling: every soak query must also have
        # landed a VALIDATED query_trace record (validate_file above
        # already schema-checked them), qid-joinable to its stats row
        n_traces = stats["kinds"].get("query_trace", 0)
        summary["query_trace"] = n_traces
        check("query_trace.count", n_traces >= 3 * len(queries),
              f"only {n_traces} query_trace records for "
              f"{len(queries)} queries x 3 full passes")
        trace_qids = {r.get("qid") for r in _iter_kind(
            broker.forensics.ledger_path, "query_trace")}
        stats_qids = {r.get("qid") for r in _iter_stats(
            broker.forensics.ledger_path) if r.get("traced")}
        check("trace_stats_join", bool(trace_qids)
              and trace_qids <= stats_qids,
              f"{len(trace_qids - stats_qids)} trace qids without a "
              "traced query_stats row")
        # the chaos run must not have corrupted the checked-in span
        # baseline (nothing may write it outside `span_diff.py update`)
        if baseline_hash is not None:
            check("span_baseline.intact",
                  _file_hash(span_path) == baseline_hash,
                  f"{span_path} changed during the soak")

        # fleet forensics rollup under chaos: a second
        # broker joins the fleet, then its ledger pull is fault-killed
        # MID-ROLLUP (rpc.drop on its /debug/ledger endpoint) — the
        # controller rollup must stay contract-valid, skip + count the
        # dead node, and per-table query totals must equal the sum of
        # the SURVIVING brokers' query_stats rows exactly
        summary.update(_rollup_gate(ctrl, broker, tmp, queries,
                                    args.seed, check, args.device))
        summary["plans"] += 1
    finally:
        faults.clear()
        stop()
        shutil.rmtree(tmp, ignore_errors=True)

    summary["ok"] = not failures
    summary["failures"] = failures
    print(json.dumps(summary))
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
