"""The cluster's control plane of the port against the JAX package, on the
CPU.

- the fleet rollup's aggregations (``cluster/rollup.py``) on seeded
  corpora and node blocks equal the reference's, and a rollup pass of
  each package over the same live nodes (a port fleet on
  ``device="cpu"``) writes the same ``fleet_rollup`` record; either
  package carries on from the other's fleet ledger and cursor file;
- the rebalancer's pure planning plane (``plan_moves``,
  ``burning_tables``, ``churn_capped``, ``receiver_affinity``,
  ``incident_frozen``) equals the reference's on seeded inputs, and a
  cutover that crashed (``rebalance.crash``) under one package's
  controller is resumed from ``rebalance_journal.json`` by either
  package's controller with the same final assignment and event stream;
- the autopsy's verdicts and whydown answers (``cluster/autopsy.py``)
  are byte-equal (``json.dumps(..., sort_keys=True)``) on corpora the JAX
  package wrote, compile-event causes included;
- the web app's page (``cluster/webapp.py``) equals the reference's for
  the same snapshot outside the script's comments;
- ``TierManager.drain`` demotes the named segment's hot copies of one
  table only, as the reference's does, and devmem reconciles.

Integers and files compare exactly, floats to a relative 1e-9.
"""
import copy
import json
import os
import time
import urllib.error

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the engine)

import pinot_tpu.cluster as jcluster
import pinot_tpu.cluster.autopsy as japsy
import pinot_tpu.cluster.rebalancer as jreb
import pinot_tpu.cluster.rollup as jroll
import pinot_tpu.cluster.webapp as jweb
import pinot_tpu.utils.faults as jfaults
import pinot_tpu.utils.ledger as jledger
import pinot_tpu_torch.cluster as tcluster
import pinot_tpu_torch.cluster.autopsy as tapsy
import pinot_tpu_torch.cluster.rebalancer as treb
import pinot_tpu_torch.cluster.rollup as troll
import pinot_tpu_torch.cluster.webapp as tweb
import pinot_tpu_torch.utils.faults as tfaults

SEEDS = range(6)
TABLES = ("t0", "t1", "t2")
SERVERS = ("s0", "s1", "s2")


def _ts(rng):
    return time.strftime("%Y-%m-%dT%H:%M:%SZ",
                         time.gmtime(1_790_000_000 + int(rng.integers(0, 90))))


def _corpus(seed):
    """Seeded rollup input: query_stats, ingest_stats, compile events and
    verdict records, some sharing (proc, seq)."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(120):
        t = str(rng.choice(TABLES))
        r = {"kind": "query_stats", "qid": f"q{i}", "table": t,
             "wall_ms": float(rng.uniform(0.5, 400.0)), "ts": _ts(rng),
             "node": str(rng.choice(SERVERS)), "rows": int(rng.integers(9)),
             "sql": f"SELECT {i} FROM {t}"}
        for flag in ("shed", "error", "partial", "slow", "traced"):
            if rng.random() < 0.15:
                r[flag] = "boom" if flag == "error" else True
        if r.get("shed"):
            r["tenant"] = str(rng.choice(["a", "b"]))
        for n in ("failovers", "hedges", "batched"):
            if rng.random() < 0.3:
                r[n] = int(rng.integers(1, 4))
        recs.append(r)
    for i in range(6):
        recs.append({"kind": "ingest_stats", "table": str(rng.choice(TABLES)),
                     "freshness_ms": float(rng.uniform(1, 900)),
                     "freshness_p50_ms": float(rng.uniform(1, 90)),
                     "freshness_p99_ms": float(rng.uniform(90, 900))})
    for i in range(30):
        recs.append({"kind": "compile_event", "proc": f"p{i % 3}",
                     "seq": int(rng.integers(0, 12)),
                     "plan_shape": f"shape{int(rng.integers(0, 5))}",
                     "trigger": str(rng.choice(["cold", "retrace",
                                                "lru_evict_rebuild"])),
                     "compile_ms": float(rng.uniform(1, 300)),
                     "lower_ms": float(rng.uniform(0, 30)),
                     "sql": "SELECT x" if rng.random() < 0.5 else None})
    for i in range(8):
        recs.append({"kind": "rca_verdict", "proc": f"p{i % 2}",
                     "seq": int(rng.integers(0, 5)), "node": "b0",
                     "ts": _ts(rng), "incident_ref": f"i{i}",
                     "top_cause": "straggler", "inconclusive": False,
                     "causes": [{"cause": "straggler",
                                 "score": float(rng.random()),
                                 "detail": "d"}]})
    rng.shuffle(recs)
    return recs


def _node_blocks(seed):
    rng = np.random.default_rng(100 + seed)
    out = {}
    for i, n in enumerate(SERVERS + ("b0",)):
        out[n] = {
            "role": "broker" if n == "b0" else "server",
            "proc": f"proc{i % 2}",
            "counters": {k: int(rng.integers(0, 50))
                         for k in jroll.NODE_COUNTER_KEYS},
            "memory": {"total": {"bytes": int(rng.integers(0, 1 << 30))}},
            "heat": [{"table": str(rng.choice(TABLES)),
                      "segment": f"seg_{int(rng.integers(0, 6))}",
                      "touches": int(rng.integers(0, 99)),
                      "rows_scanned": int(rng.integers(0, 1 << 20)),
                      "device_hits": int(rng.integers(0, 9)),
                      "device_misses": int(rng.integers(0, 9))}
                     for _ in range(5)],
            "slo": {"armed": True, "objectives": [
                {"scope": str(rng.choice(TABLES)), "kind": "latency",
                 "objective": 0.99,
                 "burn_fast": float(rng.uniform(0, 9)),
                 "burn_slow": float(rng.uniform(0, 9)),
                 "budget_remaining": float(rng.random()),
                 "events": int(rng.integers(0, 99)),
                 "bad": int(rng.integers(0, 9)),
                 "alerting": bool(rng.random() < 0.5),
                 **({"stale": True} if rng.random() < 0.2 else {})}
                for _ in range(2)]},
            "incidents": {"count": int(rng.integers(0, 3))}}
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_rollup_aggregations_match(seed):
    recs = _corpus(seed)
    blocks = _node_blocks(seed)
    for fn in ("aggregate_tables", "rank_plan_shapes", "slow_queries",
               "latest_verdicts"):
        got = getattr(troll, fn)(copy.deepcopy(recs))
        want = getattr(jroll, fn)(copy.deepcopy(recs))
        assert got == want, fn
    for fn in ("merge_heat", "aggregate_slo", "fleet_totals"):
        assert getattr(troll, fn)(copy.deepcopy(blocks)) == \
            getattr(jroll, fn)(copy.deepcopy(blocks)), fn
    for blk in blocks.values():
        assert troll._node_slo_brief(blk["slo"]) == \
            jroll._node_slo_brief(blk["slo"])
    assert troll.NODE_COUNTER_KEYS == jroll.NODE_COUNTER_KEYS


def _strip(rec):
    """A fleet_rollup record less its envelope's time and the pulled
    nodes' live memory/tier blocks (they move between two passes)."""
    out = {k: v for k, v in rec.items() if k not in ("ts",)}
    out["nodes"] = {n: {k: v for k, v in b.items()
                        if k not in ("memory", "tier")}
                    for n, b in rec["nodes"].items()}
    out["fleet"] = {k: v for k, v in rec["fleet"].items()
                    if k != "device_bytes"}
    return out


@pytest.fixture(scope="module")
def port_fleet(tmp_path_factory):
    """A port controller, one ServerNode(device="cpu") and a BrokerNode
    with a query_stats ledger, over a 4-segment sales table, after 12
    queries."""
    import pinot_tpu.segment as jseg
    import pinot_tpu.spi as jspi
    from test_torch_tier import reset_port_memory

    reset_port_memory()
    root = tmp_path_factory.mktemp("control_fleet")
    sales = jspi.Schema("sales", [
        jspi.FieldSpec("region", jspi.DataType.STRING),
        jspi.FieldSpec("amount", jspi.DataType.INT, jspi.FieldType.METRIC)])
    rng = np.random.default_rng(3)
    b = jseg.SegmentBuilder(sales, jspi.TableConfig("sales"))
    dirs = [b.build({"region": rng.choice(["east", "west"], 200),
                     "amount": rng.integers(0, 1000, 200).astype(np.int32)},
                    str(root / "sales"), f"seg_{i}") for i in range(4)]
    ctrl = tcluster.Controller(str(root / "ctrl"), heartbeat_timeout=30.0,
                               reconcile_interval=0.2)
    server = tcluster.ServerNode("server_0", ctrl.url, poll_interval=0.1,
                                 device="cpu",
                                 ledger_path=str(root / "s0.jsonl"))
    broker = tcluster.BrokerNode(ctrl.url, routing_refresh=0.1,
                                 query_stats_path=str(root / "b.jsonl"))
    try:
        ctrl.add_table("sales", sales.to_dict(), replication=1)
        for d in dirs:
            ctrl.add_segment("sales", os.path.basename(d), d)
        v = ctrl.routing_snapshot()["version"]
        assert server.wait_for_version(v, 30) and \
            broker.wait_for_version(v, 30)
        from pinot_tpu_torch.cluster.http_util import http_json
        for i in range(12):
            http_json("POST", f"{broker.url}/query/sql", {
                "sql": f"SELECT region, SUM(amount) FROM sales WHERE "
                       f"amount > {i * 50} GROUP BY region"}, timeout=30)
        yield ctrl, server, broker, root
    finally:
        broker.stop()
        server.stop()
        for dm in list(server._tables.values()):
            for seg in dm.acquire_segments():
                seg.evict_device()
        ctrl.stop()


def test_rollup_pass_matches_and_cursors_carry(port_fleet):
    """Both packages' ForensicsRollupTask over the same live nodes write
    the same fleet_rollup record; each carries on from the other's fleet
    ledger and cursors (a second pass pulls nothing new and aggregates
    the same window)."""
    ctrl, server, broker, root = port_fleet
    recs = {}
    for name, mod in (("jax", jroll), ("torch", troll)):
        task = mod.ForensicsRollupTask(
            ctrl, ledger_path=str(root / f"fleet_{name}.jsonl"))
        recs[name] = task.run()
    assert recs["torch"]["records_pulled"] == 12   # the queries' stats
    assert jledger.validate_record(recs["torch"]) == []
    assert _strip(recs["torch"]) == _strip(recs["jax"])
    for writer, reader in (("jax", troll), ("torch", jroll)):
        again = reader.ForensicsRollupTask(
            ctrl, ledger_path=str(root / f"fleet_{writer}.jsonl")).run()
        assert again["records_pulled"] == 0
        assert again["fleet_records"] == recs[writer]["fleet_records"]
        assert again["tables"] == recs[writer]["tables"]
    cursors = {}
    for name in ("jax", "torch"):
        with open(str(root / f"fleet_{name}.jsonl.cursors")) as fh:
            cursors[name] = json.load(fh)
    assert cursors["torch"] == cursors["jax"]
    assert len(cursors["torch"]) == 2          # the server and the broker


def _plan_inputs(seed):
    rng = np.random.default_rng(200 + seed)
    servers = [f"s{i}" for i in range(int(rng.integers(1, 5)))]
    instances = {s: {"role": "server", "residency": {
        t: {f"seg_{j}": str(rng.choice(["hot", "warm", "cube", "cold"]))
            for j in range(6) if rng.random() < 0.4} for t in TABLES}}
        for s in servers}
    instances["b0"] = {"role": "broker", "residency": {}}
    assignment = {t: {f"seg_{j}": sorted(set(
        rng.choice(servers, int(rng.integers(1, 3))).tolist()))
        for j in range(6)} for t in TABLES}
    rollup = {
        "slo": {"open_incidents": int(rng.random() < 0.2),
                "objectives": [
                    {"scope": str(rng.choice(list(TABLES) + ["tenant:a"])),
                     "kind": "latency", "burn_slow": float(rng.uniform(0, 6))}
                    for _ in range(4)]},
        "nodes": {s: {"slo": {"worst_burn_slow": float(rng.uniform(0, 5))}}
                  for s in servers if rng.random() < 0.7},
        "heat": [{"table": str(rng.choice(TABLES)),
                  "segment": f"seg_{int(rng.integers(0, 6))}"}
                 for _ in range(8)]}
    sizes = {f"{t}/seg_{j}": int(rng.integers(0, 1 << 28))
             for t in TABLES for j in range(6)}
    recent = frozenset(f"{t}/seg_{j}" for t in TABLES for j in range(6)
                       if rng.random() < 0.1)
    budget = {"moves": int(rng.integers(1, 6)),
              "bytes": int(rng.integers(1 << 20, 1 << 30))}
    return rollup, assignment, instances, sizes, recent, budget


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_moves_match(seed):
    rollup, assignment, instances, sizes, recent, budget = \
        _plan_inputs(seed)
    for thr in (1.0, 2.5):
        kw = dict(budget=budget, instances=instances, sizes=sizes,
                  recent=recent, threshold=thr)
        got = treb.plan_moves(copy.deepcopy(rollup),
                              copy.deepcopy(assignment), **kw)
        want = jreb.plan_moves(copy.deepcopy(rollup),
                               copy.deepcopy(assignment), **kw)
        assert got == want
        assert treb.burning_tables(rollup, thr) == \
            jreb.burning_tables(rollup, thr)
        assert treb.churn_capped(want, budget) == \
            jreb.churn_capped(want, budget)
    assert treb.incident_frozen(rollup) == jreb.incident_frozen(rollup)
    for t in TABLES:
        for s in instances:
            assert treb.receiver_affinity(instances, t, "seg_1", s) == \
                jreb.receiver_affinity(instances, t, "seg_1", s)


CLUSTER = {"jax": (jcluster, jfaults, jreb), "torch": (tcluster, tfaults,
                                                      treb)}
BURNING = {"slo": {"armed": True, "open_incidents": 0, "objectives": [
    {"scope": "t", "kind": "latency", "burn_slow": 5.0}]},
    "nodes": {}, "heat": [{"table": "t", "segment": "seg_0"}]}


def _controller(pkg, root):
    ctrl = CLUSTER[pkg][0].Controller(str(root), heartbeat_timeout=600.0,
                                      reconcile_interval=600.0)
    now = time.monotonic()
    with ctrl._lock:
        for sid in ("donor", "recv"):
            # registered servers with a fresh heartbeat; the receiver's
            # residency already shows the segment, so a prewarm passes
            ctrl._instances[sid] = {
                "id": sid, "role": "server", "host": "", "port": 0,
                "lastHeartbeat": now, "residency": {
                    "t": {"seg_0": "warm"} if sid == "recv" else {}}}
    ctrl.rollup.last_rollup = copy.deepcopy(BURNING)
    return ctrl


@pytest.mark.parametrize("writer,resumer", [
    ("jax", "jax"), ("jax", "torch"), ("torch", "jax"), ("torch", "torch")])
def test_crashed_cutover_resumes_across_packages(writer, resumer,
                                                 tmp_path):
    """A rebalance pass dies in the cutover window (rebalance.crash after
    the prewarm journal); the next controller over the same state
    directory, of either package, resumes the journaled move: one final
    assignment, the journal gone, the same event stream."""
    shared = tmp_path / "ctrl"
    ctrl = _controller(writer, shared)
    _cl, faults, reb = CLUSTER[writer]
    try:
        ctrl.add_table("t", {"schemaName": "t", "fields": []},
                       replication=1)
        with ctrl._lock:
            ctrl._state["assignment"]["t"] = {"seg_0": ["donor"]}
            ctrl._bump()
        faults.install("seed=1; rebalance.crash: match=rebalance/t/, "
                       "times=1")
        with pytest.raises(reb.RebalanceCrash):
            ctrl.rebalancer.run()
        faults.clear()
        journal = ctrl.rebalancer._load_journal()
        assert journal["phase"] == "prewarm"
        assert journal["move"]["segment"] == "seg_0"
    finally:
        faults.clear()
        ctrl.stop()
    ctrl = _controller(resumer, shared)
    try:
        res = ctrl.rebalancer.run()
        assert (res["resumed"], res["planned"], res["executed"]) == (1, 0, 0)
        assert ctrl.rebalancer._load_journal() is None
        with ctrl._lock:
            assert ctrl._state["assignment"]["t"] == {"seg_0": ["recv"]}
        events = [(e["phase"], e["reason"])
                  for e in ctrl.rebalancer.snapshot()["moves"]]
        assert events == [("resume", "journal:prewarm"),
                          ("flip", "burn_slow=5.000"),
                          ("drain", "burn_slow=5.000")]
        with open(ctrl.rollup.ledger_path) as fh:
            kinds = [json.loads(line)["phase"] for line in fh
                     if '"rebalance_event"' in line]
        assert kinds == ["plan", "prewarm", "resume", "flip", "drain"]
    finally:
        ctrl.stop()


# -- the autopsy --------------------------------------------------------------

def _stat(qid, arrival_ms, wall_ms, **kw):
    return {"kind": "query_stats", "qid": qid, "table": "t",
            "arrival_ms": arrival_ms, "wall_ms": wall_ms, **kw}


def _scenario(seed):
    """A seeded corpus touching every cause family: a baseline, a window
    with compile events of each trigger, rebalance phases, incident
    bundles with tier surfaces, ingest faults, freshness status, alerts,
    sheds and straggler traces."""
    rng = np.random.default_rng(300 + seed)
    recs = [_stat(f"b{i}", i * 1000.0, float(rng.uniform(5, 15)))
            for i in range(5)]
    recs.append({"kind": "incident", "incident_id": "p-1",
                 "surfaces": {"tier": {"armed": True, "demotions": 3}}})
    recs.append({"kind": "ingest_stats", "table": "t", "faults_fired": 2,
                 "freshness_ms": 50.0})
    for i in range(int(rng.integers(4, 12))):
        kind = int(rng.integers(0, 7))
        if kind == 0:
            recs.append({"kind": "compile_event", "trigger": str(
                rng.choice(["cold", "retrace", "drift_requantize",
                            "lru_evict_rebuild"])),
                "compile_ms": float(rng.uniform(10, 400)),
                "lower_ms": float(rng.uniform(0, 40))})
        elif kind == 1:
            recs.append({"kind": "rebalance_event", "phase": str(
                rng.choice(["plan", "prewarm", "flip", "drain", "abort"])),
                "table": "t", "segment": "seg_0", "donor": "s0",
                "receiver": "s1"})
        elif kind == 2:
            recs.append({"kind": "incident", "incident_id": f"p-{i + 2}",
                         "surfaces": {"tier": {
                             "armed": bool(rng.random() < 0.7),
                             "demotions": int(rng.integers(3, 20))}}})
        elif kind == 3:
            recs.append({"kind": "ingest_stats", "table": "t",
                         "faults_fired": int(rng.integers(2, 30)),
                         "freshness_ms": float(rng.uniform(1, 900))})
        elif kind == 4:
            recs.append({"kind": "slo_status", "slo_kind": "freshness",
                         "burn_slow": float(rng.uniform(0, 8)),
                         "threshold": 4.0, "bar_ms": 300.0,
                         **({"stale": True} if rng.random() < 0.3
                            else {})})
        elif kind == 5:
            recs.append({"kind": "alert", "alert": str(rng.choice(
                ["compile_storm", "overload_shed", "slo_burn"])),
                "severity": "page"})
        else:
            qid = f"w{i}"
            recs.append({"kind": "query_trace", "qid": qid, "root": {
                "name": "broker_query", "ms": 0.0, "children": [
                    {"name": "scatter_call", "ms": float(ms),
                     "attrs": {"server": srv}}
                    for srv, ms in (("s0", rng.uniform(5, 20)),
                                    ("s1", rng.uniform(5, 300)),
                                    ("s2", rng.uniform(5, 20)))]}})
        recs.append(_stat(f"w{i}", 20000.0 + i * 700.0,
                          float(rng.uniform(5, 600)),
                          **({"shed": True} if rng.random() < 0.2 else {}),
                          **({"hedges": 1} if rng.random() < 0.2 else {})))
    return recs


@pytest.fixture(scope="module")
def jax_corpora(tmp_path_factory):
    """Ledgers the JAX package wrote: each seeded scenario's records
    appended by the reference's ledger writer, then a verdict of the
    reference's AutopsyPlane landed in the same file."""
    root = tmp_path_factory.mktemp("corpora")
    out = {}
    for seed in SEEDS:
        path = str(root / f"ledger_{seed}.jsonl")
        with open(path, "w") as fh:
            for rec in _scenario(seed):
                fh.write(json.dumps(rec) + "\n")
        plane = japsy.AutopsyPlane()
        plane.path = path
        plane.run(window=(10.0, None), ts="2026-08-04T10:00:00Z")
        out[seed] = path
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_autopsy_verdicts_match_on_jax_corpus(seed, jax_corpora):
    path = jax_corpora[seed]
    recs_t = tapsy.load_corpus(path)
    recs_j = japsy.load_corpus(path)
    assert recs_t == recs_j
    assert any(r.get("kind") == "rca_verdict" for r in recs_t)
    for window in (None, (10.0, None), (21.0, 25.0)):
        got = tapsy.plan_autopsy(recs_t, window=window, proc="p")
        want = japsy.plan_autopsy(recs_j, window=window, proc="p")
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True)
    for qid in ("w0", "w3", "b2", "missing"):
        assert json.dumps(tapsy.whydown(recs_t, qid=qid), sort_keys=True) \
            == json.dumps(japsy.whydown(recs_j, qid=qid), sort_keys=True)
    assert troll.latest_verdicts(recs_t) == jroll.latest_verdicts(recs_j)
    # the live plane's record equals the reference's, less its envelope
    got = tapsy.AutopsyPlane().run(ledger_path=path,
                                   ts="2026-08-04T10:00:00Z")
    want = japsy.AutopsyPlane().run(ledger_path=path,
                                    ts="2026-08-04T10:00:00Z")
    skip = ("proc", "v", "ts")
    assert {k: v for k, v in got.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    assert jledger.validate_record(got) == []


def test_autopsy_names_compile_causes_on_jax_corpus():
    """The compile causes the port never writes still rank as the
    reference ranks them on a JAX-written corpus."""
    recs = [_stat(f"b{i}", i * 1000.0, 10.0) for i in range(4)] + [
        {"kind": "compile_event", "trigger": "cold", "compile_ms": 300.0,
         "lower_ms": 100.0},
        _stat("w0", 20000.0, 510.0), _stat("w1", 21000.0, 10.0)]
    got = tapsy.plan_autopsy(recs, window=(10.0, None))
    assert got == japsy.plan_autopsy(recs, window=(10.0, None))
    assert got["top_cause"] == "compile_storm"
    assert got["causes"][0]["score"] == 0.8


# -- the web app ----------------------------------------------------------------

def _code_lines(page):
    """The page without its script comment lines (the port's carry no
    history tags) and without trailing comments."""
    out = []
    for line in page.splitlines():
        if line.lstrip().startswith("//"):
            continue
        out.append(line)
    return out


def test_webapp_page_matches(port_fleet):
    ctrl, _server, _broker, root = port_fleet
    ctrl.rollup.run()
    snap = ctrl.ui_data()
    assert snap["fleet"]["rollup"] is not None and "rebalance" in snap
    got = tweb.render_app(snap)
    want = jweb.render_app(snap)
    assert _code_lines(got) == _code_lines(want)
    assert len(got.splitlines()) == len(want.splitlines())
    # the bootstrap is inlined and script-safe
    blob = json.dumps(snap).replace("</", "<\\/")
    assert blob in got and "__BOOTSTRAP__" not in got
    from pinot_tpu_torch.cluster.http_util import http_raw
    page = http_raw("GET", f"{ctrl.url}/ui").decode()
    # the page up to the inlined snapshot, which moves between calls
    head = want[:want.index('type="application/json">')]
    assert page.startswith(head) and '"fleet": {' in page


# -- the tier's drain ----------------------------------------------------------

def test_drain_demotes_one_tables_hot_copies(tmp_path):
    """Two copies of seg_0 in table lineorder and one seg_0 of another
    table, all hot: a drain of (seg_0, lineorder) demotes the two, keeps
    the other, logs the reference's decisions, and devmem reconciles."""
    import pinot_tpu.engine.tier as jtier
    import pinot_tpu.segment as jseg
    import pinot_tpu_torch.engine.tier as ttier
    import pinot_tpu_torch.segment as tseg
    from pinot_tpu_torch.tools import ssb
    from test_torch_tier import reset_port_memory

    d = ssb.build_segment_dir(4096, str(tmp_path / "a"))
    other = str(tmp_path / "b")
    import shutil
    shutil.copytree(d, other)
    meta_path = os.path.join(other, "metadata.json")
    with open(meta_path) as fh:
        meta = json.load(fh)
    meta["schema"]["schemaName"] = "orders"
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)
    counts = {}
    for name, tier, seg_mod in (("torch", ttier, tseg), ("jax", jtier,
                                                        jseg)):
        mgr = tier.TierManager()
        if name == "torch":
            segs = [seg_mod.ImmutableSegment.load(p, "cpu")
                    for p in (d, d, other)]
        else:
            segs = [seg_mod.ImmutableSegment.load(p) for p in (d, d, other)]
        for s in segs:
            mgr.admitted(s)
        n = mgr.drain("seg_0", reason="rebalance", table="lineorder")
        counts[name] = (n, [x[:4] + (x[4],) for x in mgr.decisions])
        if name == "torch":
            reset_port_memory(segs)
    assert counts["torch"] == counts["jax"]
    assert counts["torch"][0] == 2


@pytest.mark.parametrize("stale_once", [False, True])
def test_broker_node_follows_a_segment_moved_mid_query(tmp_path,
                                                       stale_once):
    """The routing a query took names two servers that no longer hold
    its segment (a rebalance moved it while the query ran): the primary
    answers short, and the broker node's failover re-reads the
    controller's routing and gets the rows from the segment's holder,
    where the reference fails over to the other stale server, which
    answers short too: ``no replica left``. Without the move the answer
    is unchanged. With ``stale_once`` the first re-read still gives the
    stale routing: the failover target answers short and earns one more
    try, on the routing read again; a third short answer fails the
    query."""
    import pinot_tpu.segment as jseg
    import pinot_tpu.spi as jspi
    from pinot_tpu_torch.cluster.http_util import http_json
    from test_torch_tier import reset_port_memory

    reset_port_memory()
    schema = jspi.Schema("m", [
        jspi.FieldSpec("k", jspi.DataType.STRING),
        jspi.FieldSpec("v", jspi.DataType.INT, jspi.FieldType.METRIC)])
    d = jseg.SegmentBuilder(schema, jspi.TableConfig("m")).build(
        {"k": np.array(["a", "b", "a"] * 50),
         "v": np.arange(150, dtype=np.int32)}, str(tmp_path), "seg_0")
    ctrl = tcluster.Controller(str(tmp_path / "ctrl"),
                               heartbeat_timeout=30.0, reconcile_interval=0.2)
    servers = [tcluster.ServerNode(f"server_{i}", ctrl.url,
                                   poll_interval=0.1, device="cpu")
               for i in range(3)]
    broker = tcluster.BrokerNode(ctrl.url, routing_refresh=3600.0)
    try:
        ctrl.add_table("m", schema.to_dict(), replication=1)
        ctrl.add_segment("m", "seg_0", d)
        v = ctrl.routing_snapshot()["version"]
        assert all(s.wait_for_version(v, 30) for s in servers)
        assert broker.wait_for_version(v, 30)
        holder = ctrl.routing_snapshot()["assignment"]["m"]["seg_0"]
        others = sorted(s.instance_id for s in servers
                        if s.instance_id not in holder)
        sql = "SELECT k, SUM(v) FROM m GROUP BY k ORDER BY k"
        want = http_json("POST", f"{broker.url}/query/sql", {"sql": sql})
        stale = copy.deepcopy(broker._routing)
        stale["assignment"]["m"]["seg_0"] = others
        broker._routing = stale
        real, reads = broker._refresh_routing, []

        def refresh():
            reads.append(1)
            if not (stale_once and len(reads) == 1):
                real()

        broker._refresh_routing = refresh
        got = http_json("POST", f"{broker.url}/query/sql", {"sql": sql})
        assert got["resultTable"] == want["resultTable"]
        assert want["resultTable"]["rows"] == [["a", 7450], ["b", 3725]]
        assert broker._routing["assignment"]["m"]["seg_0"] == holder
        assert len(reads) == 1 + stale_once
        if stale_once:
            # always stale: the primary, its failover and the second try
            # answer short, and the query fails instead of looping
            broker._refresh_routing = lambda: None
            broker._routing = copy.deepcopy(stale)
            with pytest.raises(urllib.error.HTTPError) as bad:
                http_json("POST", f"{broker.url}/query/sql", {"sql": sql})
            assert bad.value.code == 400
            assert "requested segments" in bad.value.read().decode()
    finally:
        broker.stop()
        for s in servers:
            s.stop()
            for dm in list(s._tables.values()):
                for seg in dm.acquire_segments():
                    seg.evict_device()
        ctrl.stop()
