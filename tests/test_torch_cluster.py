"""The cluster's data plane of the port against the JAX package, on the CPU.

A port fleet (``pinot_tpu_torch.cluster``: a Controller, two
``ServerNode(device="cpu")`` and a BrokerNode over loopback HTTP) and a
reference fleet (``pinot_tpu.cluster``), each at replication 2 over the
same segments, answer the reference's own cluster queries and the 13 SSB
queries with equal rows and ``numSegmentsQueried``; the error answers for
a bad ``timeoutMs``, a dead replica and an exhausted deadline are equal.
Mixed fleets (a reference controller and broker over one port server and
one reference server; the port's broker over reference servers) give the
all-reference rows. The controller's state directory, deep-store
archives and ``query_stats`` records carry between the packages, and the
closed stubs (a batch job's push, ``localfs``, the trace ledger) are
checked against the reference. Integers match exactly, floats to a
relative 1e-9.
"""
import json
import os
import time
import urllib.error
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the engine)

import pinot_tpu.cluster as jcluster
import pinot_tpu.cluster.deepstore as jdeep
import pinot_tpu.cluster.http_util as jhttp
import pinot_tpu.segment as jseg
import pinot_tpu.spi as jspi
import pinot_tpu.utils.faults as jfaults
import pinot_tpu.utils.ledger as jledger
import pinot_tpu_torch.cluster as tcluster
import pinot_tpu_torch.cluster.deepstore as tdeep
import pinot_tpu_torch.cluster.http_util as thttp
import pinot_tpu_torch.utils.faults as tfaults
from pinot_tpu_torch.tools import ssb

SSB_ROWS = 1 << 14
SSB_SEGMENTS = 4
SALES_SEGMENTS = 4
SALES_ROWS = 800
WAIT_S = 60.0

CLUSTER_QUERIES = [
    "SELECT region, SUM(amount), COUNT(*) FROM sales GROUP BY region "
    "ORDER BY region",
    "SELECT SUM(amount) FROM sales",
    "SELECT COUNT(*) FROM sales",
    "SELECT region FROM sales WHERE amount > 500 UNION SELECT region FROM "
    "sales WHERE amount <= 500 ORDER BY region",
    "SELECT region FROM sales EXCEPT SELECT region FROM sales WHERE "
    "region = 'east'",
    "SELECT region, AVG(amount), MAX(amount) FROM sales WHERE amount "
    "BETWEEN 100 AND 700 GROUP BY region ORDER BY region",
    "SELECT region, amount FROM sales WHERE amount > 990 ORDER BY amount, "
    "region LIMIT 20",
    "SELECT SUM(v) FROM ts WHERE day >= 350",
]
SSB_SQLS = {qid: ssb.spec_to_sql(p, v, g) for qid, p, v, g in ssb.QUERIES}


def _pkg(name):
    if name == "jax":
        return SimpleNamespace(
            name=name, cluster=jcluster, http=jhttp, deep=jdeep,
            faults=jfaults,
            server=lambda i, url, **k: jcluster.ServerNode(
                i, url, poll_interval=0.1, **k))
    return SimpleNamespace(
        name=name, cluster=tcluster, http=thttp, deep=tdeep, faults=tfaults,
        server=lambda i, url, **k: tcluster.ServerNode(
            i, url, poll_interval=0.1, device="cpu", **k))


def _schema(name, fields):
    return jspi.Schema(name, fields)


@pytest.fixture(scope="module")
def segments(tmp_path_factory):
    """{table: (schema dict, [segment dirs])}: the reference's sales and
    ts tables and SSB at SSB_ROWS rows in SSB_SEGMENTS segments."""
    out = tmp_path_factory.mktemp("cluster_segments")
    rng = np.random.default_rng(3)
    sales = _schema("sales", [
        jspi.FieldSpec("region", jspi.DataType.STRING),
        jspi.FieldSpec("amount", jspi.DataType.INT, jspi.FieldType.METRIC)])
    b = jseg.SegmentBuilder(sales, jspi.TableConfig("sales"))
    sales_dirs = [b.build({
        "region": rng.choice(["east", "west"], SALES_ROWS),
        "amount": rng.integers(0, 1000, SALES_ROWS).astype(np.int32)},
        str(out / "sales"), f"seg_{i}") for i in range(SALES_SEGMENTS)]
    ts = _schema("ts", [
        jspi.FieldSpec("day", jspi.DataType.INT),
        jspi.FieldSpec("v", jspi.DataType.INT, jspi.FieldType.METRIC)])
    b = jseg.SegmentBuilder(ts, jspi.TableConfig("ts"))
    ts_dirs = [b.build({
        "day": (100 * i + np.arange(100)).astype(np.int32),
        "v": np.full(100, i + 1, dtype=np.int32)},
        str(out / "ts"), f"ts_{i}") for i in range(4)]
    ssb_dir = ssb.build_table_dir([SSB_ROWS // SSB_SEGMENTS] * SSB_SEGMENTS,
                                  str(out / "lineorder"))
    ssb_dirs = sorted(os.path.join(ssb_dir, d) for d in os.listdir(ssb_dir))
    with open(os.path.join(ssb_dirs[0], "metadata.json")) as fh:
        ssb_schema = json.load(fh)["schema"]
    return {"sales": (sales.to_dict(), sales_dirs),
            "ts": (ts.to_dict(), ts_dirs),
            "lineorder": (ssb_schema, ssb_dirs)}


def _register(ctrl, segments, replication=2, tables=None):
    for table, (schema, dirs) in segments.items():
        if tables is not None and table not in tables:
            continue
        ctrl.add_table(table, schema, replication=replication)
        for d in dirs:
            ctrl.add_segment(table, os.path.basename(d), d)


def _sync(ctrl, servers, brokers):
    v = ctrl.routing_snapshot()["version"]
    for s in servers:
        assert s.wait_for_version(v, WAIT_S), s.instance_id
    for b in brokers:
        assert b.wait_for_version(v, WAIT_S)


class Fleet:
    """A controller, servers built by ``server_pkgs`` and a broker of
    ``broker_pkg`` (the controller's package is the broker's)."""

    def __init__(self, root, broker_pkg, server_pkgs, segments,
                 replication=2, stats=None, tables=None):
        self.pkg = _pkg(broker_pkg)
        self.ctrl = self.pkg.cluster.Controller(
            str(root / "ctrl"), heartbeat_timeout=30.0,
            reconcile_interval=0.2)
        self.servers = [_pkg(p).server(f"server_{i}", self.ctrl.url)
                        for i, p in enumerate(server_pkgs)]
        self.broker = self.pkg.cluster.BrokerNode(
            self.ctrl.url, routing_refresh=0.1, query_stats_path=stats)
        _register(self.ctrl, segments, replication, tables)
        _sync(self.ctrl, self.servers, [self.broker])

    def query(self, sql):
        return self.pkg.http.http_json(
            "POST", f"{self.broker.url}/query/sql", {"sql": sql},
            timeout=WAIT_S)

    def error(self, sql):
        with pytest.raises(urllib.error.HTTPError) as ei:
            self.query(sql)
        return ei.value.code, json.loads(ei.value.read().decode())

    def stop(self):
        self.broker.stop()
        for s in self.servers:
            try:
                s.stop()
            except Exception:
                pass
            if isinstance(s, tcluster.ServerNode):
                # the port's device-memory accounting is process-global:
                # a stopped node's segments leave it
                for dm in list(s._tables.values()):
                    for seg in dm.acquire_segments():
                        seg.evict_device()
        self.ctrl.stop()


@pytest.fixture(scope="module")
def fleets(segments, tmp_path_factory):
    from test_torch_tier import reset_port_memory

    reset_port_memory()
    root = tmp_path_factory.mktemp("fleets")
    out = {}
    for name in ("jax", "torch"):
        (root / name).mkdir()
        out[name] = Fleet(root / name, name, [name, name], segments,
                          stats=str(root / name / "stats.jsonl"))
    yield out
    for f in out.values():
        f.stop()


def _cell(v):
    return ("f", round(v, 6)) if isinstance(v, float) else (
        type(v).__name__, v)


def _same_rows(got, want, ordered=True):
    assert len(got) == len(want)
    if not ordered:
        got = sorted(got, key=lambda r: [_cell(x) for x in r])
        want = sorted(want, key=lambda r: [_cell(x) for x in r])
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=1e-9)
            else:
                assert a == b


def _same_answer(got, want):
    assert got["resultTable"]["dataSchema"] == \
        want["resultTable"]["dataSchema"]
    _same_rows(got["resultTable"]["rows"], want["resultTable"]["rows"],
               ordered=False)
    for k in ("numSegmentsQueried", "numSegmentsPruned"):
        assert got.get(k) == want.get(k), k


@pytest.mark.parametrize("sql", CLUSTER_QUERIES)
def test_cluster_queries_match_the_reference_fleet(fleets, sql):
    _same_answer(fleets["torch"].query(sql), fleets["jax"].query(sql))


@pytest.mark.parametrize("qid", sorted(SSB_SQLS))
def test_ssb_queries_match_the_reference_fleet(fleets, qid):
    got = fleets["torch"].query(SSB_SQLS[qid])
    _same_answer(got, fleets["jax"].query(SSB_SQLS[qid]))
    assert got["numSegmentsQueried"] == SSB_SEGMENTS


def test_explain_and_bad_requests_match(fleets):
    for sql in ("EXPLAIN SELECT SUM(amount) FROM sales",
                "SELECT COUNT(*) FROM sales OPTION(timeoutMs=60000)"):
        _same_answer(fleets["torch"].query(sql), fleets["jax"].query(sql))
    for sql in ("SELECT SUM(amount) FROM sales OPTION(timeoutMs=abc)",
                "SELECT FROM nope", "SELECT nope FROM sales",
                "SELECT a.x FROM sales a JOIN ts b ON a.amount = b.v"):
        assert fleets["torch"].error(sql) == fleets["jax"].error(sql)


def test_query_stats_records_match(fleets):
    """Both brokers' query_stats records: same keys, same values apart
    from the timing fields, the generated query id and the micro-batch
    fields (whether the two in-process servers' executions meet in one
    fused dispatch is a matter of timing); every record passes the JAX
    package's validator. The reference's ledger also takes its compile
    plane's records, which the port does not have."""
    timing = {"ts", "qid", "wall_ms", "arrival_ms", "serde_ms", "net_ms",
              "slow", "tier_affinity_hits", "batched", "batch_size"}
    recs = {}
    for name, f in fleets.items():
        path = f.broker.forensics.ledger_path
        n0 = sum(1 for _ in open(path)) if os.path.exists(path) else 0
        for sql in CLUSTER_QUERIES[:3] + [SSB_SQLS["q2.1"]]:
            f.query(sql)
        with open(path) as fh:
            lines = [json.loads(x) for x in fh][n0:]
        assert all(jledger.validate_record(r) == [] for r in lines)
        lines = [r for r in lines if r["kind"] == "query_stats"]
        assert len(lines) == 4
        recs[name] = [{k: v for k, v in r.items() if k not in timing}
                      for r in lines]
    assert recs["torch"] == recs["jax"]


def test_deadline_and_dead_replica_match(segments, tmp_path):
    """Exhausted deadlines (code 250 under allowPartialResults) and dead
    replicas (failover; both down: code 427, or a 400 without
    allowPartialResults) answer alike in both packages."""
    answers = {}
    for name in ("jax", "torch"):
        (tmp_path / name).mkdir()
        f = Fleet(tmp_path / name, name, [name, name], segments,
                  tables={"sales"})
        try:
            got = {}
            f.pkg.faults.install(
                "seed=3; segment.slow: match=server_, delay_ms=600")
            try:
                code, body = f.error(
                    "SELECT SUM(amount) FROM sales OPTION(timeoutMs=250)")
                got["deadline"] = (code, "timed out" in body["error"])
                resp = f.query("SELECT SUM(amount) FROM sales "
                               "OPTION(timeoutMs=250,"
                               "allowPartialResults=true)")
                got["deadline_partial"] = (
                    resp["partialResult"],
                    sorted({e["errorCode"] for e in resp["exceptions"]}))
            finally:
                f.pkg.faults.clear()
            time.sleep(0.7)          # the slowed server threads drain
            f.servers[0].stop()
            resp = f.query("SELECT region, SUM(amount) FROM sales "
                           "GROUP BY region ORDER BY region")
            got["failover"] = resp["resultTable"]["rows"]
            f.servers[1].stop()
            resp = f.query("SELECT region, SUM(amount) FROM sales "
                           "GROUP BY region OPTION(allowPartialResults="
                           "true)")
            got["both_down"] = (
                resp["resultTable"]["rows"], resp["partialResult"],
                sorted({e["errorCode"] for e in resp["exceptions"]}))
            got["both_down_strict"] = f.error(
                "SELECT region, SUM(amount) FROM sales GROUP BY region")[0]
        finally:
            f.stop()
        answers[name] = got
    assert answers["torch"] == answers["jax"]
    assert answers["torch"]["deadline"] == (400, True)
    assert answers["torch"]["deadline_partial"] == (True, [250])
    assert answers["torch"]["both_down"] == ([], True, [427])


@pytest.mark.parametrize("mix", ["jax_broker_mixed_servers",
                                 "torch_broker_jax_servers"])
def test_mixed_fleets_give_the_reference_rows(fleets, segments, tmp_path,
                                              mix):
    broker, servers = {
        "jax_broker_mixed_servers": ("jax", ["torch", "jax"]),
        "torch_broker_jax_servers": ("torch", ["jax", "jax"])}[mix]
    f = Fleet(tmp_path, broker, servers, segments,
              tables={"sales", "lineorder"})
    try:
        for sql in CLUSTER_QUERIES[:7] + [SSB_SQLS[q] for q in (
                "q1.1", "q2.1", "q3.1", "q4.1")]:
            _same_answer(f.query(sql), fleets["jax"].query(sql))
        served = {s.instance_id: len(s._tables["sales"].acquire_segments())
                  for s in f.servers}
        assert all(served.values())
    finally:
        f.stop()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_controller_state_carries_between_packages(segments, tmp_path,
                                                   writer, reader):
    ctl = _pkg(writer).cluster.Controller(str(tmp_path / "ctrl"),
                                          reconcile_interval=0.2)
    _register(ctl, segments, replication=1, tables={"sales", "ts"})
    ctl.add_table("cfg", segments["ts"][0], config={"quotaQps": 3.0})
    ctl.start_replace_segments("ts", ["ts_0"], ["ts_0"])
    want = ctl.routing_snapshot()
    ctl.stop()
    ctl2 = _pkg(reader).cluster.Controller(str(tmp_path / "ctrl"),
                                           reconcile_interval=0.2)
    try:
        got = ctl2.routing_snapshot()
        for k in ("tables", "segments", "assignment", "version"):
            assert got[k] == want[k], k
        with open(tmp_path / "ctrl" / "cluster_state.json") as fh:
            assert json.load(fh)["lineage"] == \
                ctl2._state["lineage"]
    finally:
        ctl2.stop()


@pytest.mark.parametrize("packer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_deepstore_archives_read_by_either_package(segments, tmp_path,
                                                   packer, reader):
    src = segments["sales"][1][0]
    uri = _pkg(packer).deep.upload_segment(
        src, f"file://{tmp_path}/deep/sales")
    assert _pkg(reader).deep.is_deepstore_uri(uri)
    local = _pkg(reader).deep.download_segment(uri, str(tmp_path / "dl"))
    for name in sorted(os.listdir(src)):
        with open(os.path.join(src, name), "rb") as a, \
                open(os.path.join(local, name), "rb") as b:
            assert a.read() == b.read(), name
    assert tdeep.pruning_metadata(local) == jdeep.pruning_metadata(src)


def test_deepstore_segment_served_by_port_servers(fleets, segments,
                                                 tmp_path):
    """A tar.gz location: both port servers download, untar and load it;
    the rows equal the reference fleet's over the directories."""
    f = Fleet(tmp_path, "torch", ["torch", "torch"], segments,
              tables=set())
    try:
        schema, dirs = segments["sales"]
        f.ctrl.add_table("sales", schema, replication=2)
        for d in dirs:
            uri = tdeep.upload_segment(d, f"file://{tmp_path}/deep/sales")
            f.ctrl.add_segment("sales", os.path.basename(d), uri,
                               tdeep.pruning_metadata(d))
        _sync(f.ctrl, f.servers, [f.broker])
        for s in f.servers:
            assert sorted(os.listdir(os.path.join(s.data_dir, "sales"))) \
                == sorted(os.path.basename(d) for d in dirs)
        for sql in CLUSTER_QUERIES[:3]:
            _same_answer(f.query(sql), fleets["jax"].query(sql))
    finally:
        f.stop()


def test_unported_routes_answer_501(fleets):
    """The routes that answered 501 while the control plane was missing
    now answer as the reference's do: the same status and the same keys
    on the controller's fleet, autopsy, rebalance and commit routes and
    the broker's autopsy, and the same fleet and rebalance blocks in
    ``/ui/data``."""
    f, j = fleets["torch"], fleets["jax"]
    for path, method, body, node in (
            ("/debug/fleet", "GET", None, "ctrl"),
            ("/debug/autopsy", "GET", None, "ctrl"),
            ("/debug/rebalance", "GET", None, "ctrl"),
            ("/segmentConsumed", "POST",
             {"table": "t", "segment": "s", "server": "x", "offset": 1},
             "ctrl"),
            ("/debug/autopsy", "GET", None, "broker")):
        got = thttp.http_json(method, getattr(f, node).url + path, body)
        want = jhttp.http_json(method, getattr(j, node).url + path, body)
        assert sorted(got) == sorted(want), path
        if path == "/segmentConsumed":
            assert got == want == {"status": "COMMIT", "offset": 1}
    data = thttp.http_json("GET", f"{f.ctrl.url}/ui/data")
    ref = jhttp.http_json("GET", f"{j.ctrl.url}/ui/data")
    assert sorted(data["fleet"]) == sorted(ref["fleet"])
    assert sorted(data["rebalance"]) == sorted(ref["rebalance"])
    assert set(ref) == set(data) | {"compile"}
    mem = thttp.http_json("GET", f"{f.servers[0].url}/debug/memory")
    assert mem["device"] == "cpu" and mem["columns"]["sales"]
    assert all(d == "cpu" for by_seg in mem["columns"].values()
               for cols in by_seg.values() for d in cols.values())


def test_server_node_defaults_to_cuda():
    """No device means CUDA: where none is available the server node
    raises before it binds or registers anything."""
    with pytest.raises(RuntimeError, match="CUDA"):
        tcluster.ServerNode("s", "http://127.0.0.1:1")


def test_localfs_plugin_and_filesystem(tmp_path):
    from pinot_tpu.spi.filesystem import LocalPinotFS as JLocal
    from pinot_tpu_torch.spi import filesystem as tfs
    from pinot_tpu_torch.spi.plugin import create_instance

    fs = create_instance("localfs")
    assert isinstance(fs, tfs.LocalPinotFS)
    (tmp_path / "a.txt").write_text("hello")
    fs.copy(str(tmp_path / "a.txt"), str(tmp_path / "b" / "a.txt"))
    assert JLocal().listdir(str(tmp_path / "b")) == ["a.txt"]
    got, path = tfs.fs_for_uri(f"file://{tmp_path}/x")
    assert isinstance(got, tfs.LocalPinotFS) and path == f"{tmp_path}/x"
    s3, _ = tfs.fs_for_uri("s3://bucket/key")
    with pytest.raises(RuntimeError, match=r"S3PinotFS\.register\("):
        s3.exists("bucket/key")


SLO_CORPUS = [{"table": "t1", "tenant": "acme", "arrival_ms": i * 50.0,
               "wall_ms": 40.0 if i % 3 else 400.0, "shed": i in (10, 11),
               "partial": i == 17} for i in range(40)]
SLO_OBJECTIVES = [
    {"scope": "t1", "kind": "latency", "bar_ms": 100.0, "objective": 0.9,
     "fast_s": 1.0, "slow_s": 5.0, "burn_threshold": 2.0},
    {"scope": "tenant:acme", "kind": "availability", "objective": 0.95,
     "fast_s": 1.0, "slow_s": 5.0, "burn_threshold": 1.0},
]


def test_slo_plane_replays_the_reference_alert_stream():
    """The SLO plane the broker node's forensics feed on every query:
    the same query_stats stream and objectives give the reference's
    alert stream and status rows, byte for byte."""
    from pinot_tpu.utils import slo as jslo
    from pinot_tpu_torch.utils import slo as tslo

    want = jslo.plan_alert_stream(SLO_CORPUS, SLO_OBJECTIVES)
    got = tslo.plan_alert_stream(SLO_CORPUS, SLO_OBJECTIVES)
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(want, sort_keys=True)
    assert len(got["alerts"]) >= 2
    assert tslo.normalize_alerts(got["alerts"]) == \
        jslo.normalize_alerts(want["alerts"])


PRUNE_META = {
    f"s{i}": {"columns": {"t": {"min": 100 * i, "max": 100 * i + 99},
                          "k": {"min": "a" if i % 2 else "m",
                                "max": "l" if i % 2 else "z",
                                "partitions": [i % 4]}},
              "numPartitions": 4, "totalDocs": 100}
    for i in range(8)}
PRUNE_WHERES = ["t >= 350", "t < 100", "t BETWEEN 120 AND 450",
                "t = 777", "k = 'b'", "k IN ('n', 'q')",
                "t > 250 AND k = 'c'", "t > 250 OR k = 'c'", "t >= 5000"]


@pytest.mark.parametrize("where", PRUNE_WHERES)
def test_segment_pruning_matches_the_reference(where):
    from pinot_tpu.broker import routing as jr
    from pinot_tpu.query.sql import parse_sql as jparse
    from pinot_tpu_torch.broker import routing as tr
    from pinot_tpu_torch.query.sql import parse_sql as tparse

    cfg = {"segmentPartitionConfig": {"columnPartitionMap": {
        "k": {"functionName": "murmur", "numPartitions": 4}}}}
    for table_cfg in (None, cfg):
        want = jr.prune_segments(
            PRUNE_META, jparse(f"SELECT t FROM x WHERE {where}").where,
            table_cfg)
        got = tr.prune_segments(
            PRUNE_META, tparse(f"SELECT t FROM x WHERE {where}").where,
            table_cfg)
        assert got == want


@pytest.mark.parametrize("kind", ["balanced", "replicaGroup",
                                  "strictReplicaGroup", "adaptive"])
def test_instance_selectors_match_the_reference(kind):
    from pinot_tpu.broker import routing as jr
    from pinot_tpu_torch.broker import routing as tr

    assignment = {f"s{i}": ["a", "b", "c"][i % 3:] + ["a", "b", "c"][:i % 3]
                  for i in range(7)}
    picks = {}
    for name, mod in (("jax", jr), ("torch", tr)):
        sel = mod.make_selector(kind)
        assert type(sel).__name__ == type(jr.make_selector(kind)).__name__
        if kind == "adaptive":
            for host, ms in (("a", 30.0), ("b", 5.0), ("c", 12.0)):
                sel.record_start(host)
                sel.record_end(host, ms)
        runs = []
        for healthy in (lambda h: True, lambda h: h != "b"):
            for _ in range(3):
                try:
                    runs.append(sel.select(assignment, healthy))
                except Exception as e:
                    runs.append((type(e).__name__, str(e)))
        picks[name] = runs
    assert picks["torch"] == picks["jax"]


def test_query_schedulers_match_the_reference():
    """FCFS and priority order, the full-queue rejection and the
    factory, as the JAX package's scheduler suite checks them."""
    import threading

    from pinot_tpu.engine import scheduler as js
    from pinot_tpu_torch.engine import scheduler as ts

    got = {}
    for name, mod in (("jax", js), ("torch", ts)):
        out = {}
        for cls in ("FcfsScheduler", "PriorityScheduler"):
            sched = getattr(mod, cls)(num_workers=1, max_pending=16)
            order, gate = [], threading.Event()
            first = sched.submit(lambda: gate.wait(5), "q0")
            futs = [sched.submit(lambda i=i: order.append(i), f"q{i}",
                                 priority=10 - i) for i in range(1, 5)]
            gate.set()
            for f in [first] + futs:
                f.result(timeout=5)
            out[cls] = order
            sched.stop()
        sched = mod.FcfsScheduler(num_workers=1, max_pending=2)
        gate = threading.Event()
        sched.submit(lambda: gate.wait(5), "q0")
        time.sleep(0.05)     # the worker takes q0 off the queue
        sched.submit(lambda: None, "q1")
        sched.submit(lambda: None, "q2")
        with pytest.raises(mod.SchedulerRejectedError) as ei:
            sched.submit(lambda: None, "q3")
        out["rejected"] = (ei.value.error_code, ei.value.retry_after_ms)
        gate.set()
        sched.stop()
        out["factory"] = [type(mod.make_scheduler(c)).__name__ for c in (
            {}, {"query.scheduler.name": "priority"})]
        with pytest.raises(ValueError):
            mod.make_scheduler({"query.scheduler.name": "bogus"})
        got[name] = out
    assert got["torch"] == got["jax"]
    assert got["torch"]["FcfsScheduler"] == [1, 2, 3, 4]
    assert got["torch"]["PriorityScheduler"] == [4, 3, 2, 1]


def test_http_connections_match_the_reference(fleets):
    """clients.HttpConnection over each broker node: the same result
    tables, and the same SqlError text for a refused query."""
    from pinot_tpu.clients import HttpConnection as JConn
    from pinot_tpu_torch.clients import HttpConnection as TConn
    from pinot_tpu_torch.query.sql import SqlError

    t = TConn(fleets["torch"].broker.url)
    j = JConn(fleets["jax"].broker.url)
    for sql in (CLUSTER_QUERIES[0], SSB_SQLS["q3.1"]):
        a, b = t(sql), j(sql)
        assert a.columns == b.columns and a.num_segments == b.num_segments
        _same_rows(a.rows, b.rows)
        assert t.cursor().execute(sql).fetchall() == a.rows
    with pytest.raises(SqlError) as te:
        t("SELECT nope FROM sales")
    with pytest.raises(Exception) as je:
        j("SELECT nope FROM sales")
    assert str(te.value) == str(je.value)


def test_ledger_schema_matches_the_reference(tmp_path):
    """utils/ledger: the same per-kind field contract, the same verdicts
    on good and bad records, and the port's trace and ingest records
    pass the reference's validator; the port writes only where told."""
    from pinot_tpu_torch.utils import ledger as tledger
    from pinot_tpu_torch.utils.spans import Span

    assert tledger.KINDS == jledger.KINDS
    samples = [
        {"v": 2, "ts": "x", "kind": "query_stats", "qid": "a",
         "table": "t", "wall_ms": 1.0, "sql": "s"},
        {"v": 2, "ts": "x", "kind": "query_stats", "qid": "a"},
        {"v": 2, "ts": "x", "kind": "nope"},
        {"v": 3, "kind": "query_stats"},
        {"metric": "legacy", "value": 1},
    ]
    for rec in samples:
        assert tledger.validate_record(rec) == jledger.validate_record(rec)
    root = Span("query", table="t")
    root.finish()
    rec = tledger.trace_record(root, "SELECT 1", qid="q")
    assert rec["backend"] == "cpu" and jledger.validate_record(rec) == []
    path = str(tmp_path / "ledger.jsonl")
    tledger.append_record(rec, path)
    assert tledger.validate_file(path) == jledger.validate_file(path)
    assert jledger.validate_file(path)["kinds"] == {"query_trace": 1}
    with pytest.raises(ValueError):
        tledger.make_record("query_stats", qid="only")


def test_in_process_servers_hold_their_own_copies(fleets):
    """Two port servers holding the same segment names each load their
    own copy; the shared device-memory accounting counts both copies,
    tracked equal to held after queries on both."""
    from pinot_tpu_torch.engine.tier import reconcile_devmem

    f = fleets["torch"]
    for sql in CLUSTER_QUERIES[:3] + [SSB_SQLS["q2.1"], SSB_SQLS["q4.1"]]:
        f.query(sql)
    held = {s.instance_id: {seg.name: seg
                            for seg in s._tables["lineorder"]
                            .acquire_segments()} for s in f.servers}
    a, b = held["server_0"], held["server_1"]
    assert sorted(a) == sorted(b)
    assert all(a[n] is not b[n] and a[n].uid != b[n].uid for n in a)
    segs = [seg for s in f.servers for dm in s._tables.values()
            for seg in dm.acquire_segments()]
    rec = reconcile_devmem(segs)
    assert rec["segment_cols"]["actual"] > 0
    assert all(r["tracked"] == r["actual"] for r in rec.values()), rec
