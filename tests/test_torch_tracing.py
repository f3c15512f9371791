"""The tracing plane: the port against the JAX package.

For one query of each plan kind (scalar, dense, compact, host, kselect,
segmented, batched dense, cube, join, window, vector, rollup), EXPLAIN
ANALYZE over the same segments in both brokers must give span trees with
the same names, nesting and attribute keys, less the spans and
attributes that mark JAX-only work (``JAX_ONLY_SPANS``,
``JAX_ONLY_ATTRS``: tracing and compiling a program, the cache of
compiled programs and its hit/miss counts, donated buffers, retraces). Also equal: EXPLAIN ANALYZE's columns and its Node / Node_Id /
Parent_Id columns, the inner rows against the untraced query's, the
``OPTION(trace=true)`` phase and counter keys, ``render_prometheus`` on
one snapshot, ``sample_decision`` on 10,000 query ids, the sampled
query's tree and the ``sampled_traces`` counter. An inactive ``span()``
allocates no ``Span``; the root's children sum to its wall time (the
``broker_overhead`` child); every span name is in ``phases.SPAN_NAMES``.
"""
import os
import shutil
import threading

import numpy as np
import pytest

from pinot_tpu.broker import Broker as JaxBroker
from pinot_tpu.engine import ragged as jragged
from pinot_tpu.engine.accounting import global_accountant as j_acc
from pinot_tpu.ops.plan_cache import global_cube_cache as j_cubes
from pinot_tpu.server import TableDataManager as JaxTable
from pinot_tpu.utils import metrics as jmetrics
from pinot_tpu.utils import spans as jspans
from pinot_tpu_torch.broker import Broker, connect
from pinot_tpu_torch.engine import ragged as tragged
from pinot_tpu_torch.engine.accounting import global_accountant as t_acc
from pinot_tpu_torch.ops.plan_cache import global_cube_cache as t_cubes
from pinot_tpu_torch.segment import load_segment
from pinot_tpu_torch.server import TableDataManager
from pinot_tpu_torch.startree import RollupConfig, build_rollup
from pinot_tpu_torch.tools import ssb, vec
from pinot_tpu_torch.utils import metrics as tmetrics
from pinot_tpu_torch.utils import phases
from pinot_tpu_torch.utils import spans as tspans
from pinot_tpu_torch.utils.metrics import global_metrics

from test_torch_multistage import THRESHOLDS, star_schema
from test_torch_tier import reset_port_memory

# work only the JAX package does: tracing and compiling a program, the
# cache of compiled programs (cache=hit|miss and the root's counts of
# them), its donated accumulators, and the retrace detector
JAX_ONLY_SPANS = frozenset({"trace_kernel"})
JAX_ONLY_ATTRS = frozenset({"compiled", "donated", "retrace", "retraces",
                            "cache", "cache_hits", "cache_misses"})

SSB = {qid: ssb.spec_to_sql(p, v, g) for qid, p, v, g in ssb.QUERIES}
ROLLUP = (["d_year", "p_category", "p_brand1", "s_region"],
          [("sum", "lo_revenue")])
VCOLS = {"emb": (8, "cosine", 2)}

KINDS = {
    "scalar": ("ssb", SSB["q1.1"]),
    "dense": ("ssb", SSB["q4.1"] + " OPTION(groupByStrategy=dense)"),
    "compact": ("ssb", SSB["q2.1"] + " OPTION(groupByStrategy=compact)"),
    "host": ("ssb", SSB["q3.1"] + " OPTION(forceHostExecution=true)"),
    "kselect": ("ssb", "SELECT lo_revenue, d_year FROM lineorder "
                "WHERE d_year = 1993 ORDER BY d_year LIMIT 5"),
    "segmented": ("table", SSB["q2.1"]
                  + " OPTION(groupByStrategy=compact)"),
    "batched": ("table", SSB["q1.1"]),
    "rollup": ("rollup", "SELECT d_year, SUM(lo_revenue), COUNT(*) "
               "FROM lineorder WHERE s_region = 'ASIA' GROUP BY d_year"),
    "join": ("star", "SELECT c.c_nation, SUM(o.o_price) FROM orders o "
             "JOIN customers c ON o.o_cust = c.c_id GROUP BY c.c_nation "
             "ORDER BY c.c_nation"),
    "join_mailbox": ("star", "SELECT p.p_brand, COUNT(*) FROM orders o "
                     "JOIN parts p ON o.o_part = p.p_id "
                     "GROUP BY p.p_brand ORDER BY p.p_brand "
                     "OPTION(multistageFused=false)"),
    "window": ("star", "SELECT o_key, ROW_NUMBER() OVER (PARTITION BY "
               "o_cust ORDER BY o_key) FROM orders ORDER BY o_key "
               "LIMIT 5"),
}

# the span that shows each kind took its path
KIND_SPAN = {"scalar": "segment_kernel", "dense": "segment_kernel",
             "compact": "segment_kernel", "host": "segment_host",
             "kselect": "segment_kselect",
             "segmented": "segmented_compact_dispatch",
             "batched": "vmap_dispatch", "rollup": "plan_segment",
             "join": "fused_plan", "join_mailbox": "join_stage",
             "window": "window_stage"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in THRESHOLDS:
        monkeypatch.setenv(k, "0")
    monkeypatch.setenv("PINOT_CPU_FAST_GROUPBY", "1")


def _pair(dirs, name="lineorder"):
    dm = TableDataManager(name, device="cpu")
    jdm = JaxTable(name)
    for d in dirs:
        dm.add_segment_dir(d)
        jdm.add_segment_dir(d)
    b, jb = Broker(device="cpu"), JaxBroker()
    b.register_table(dm)
    jb.register_table(jdm)
    return b, jb


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    out = tmp_path_factory.mktemp("trace")
    one = ssb.build_segment_dir(4096, str(out / "one"))
    table = ssb.build_table_dir([2048, 2048], str(out / "table"))
    rollup = str(out / "rollup" / "seg_0")
    shutil.copytree(one, rollup)
    build_rollup(load_segment(rollup, "cpu"), RollupConfig(*ROLLUP))
    brokers = {
        "ssb": _pair([one]),
        "table": _pair([os.path.join(table, d)
                        for d in sorted(os.listdir(table))]),
        "rollup": _pair([rollup]),
    }
    b, jb = Broker(device="cpu"), JaxBroker()
    for name, ds in star_schema(str(out / "star")).items():
        dm, jdm = TableDataManager(name, device="cpu"), JaxTable(name)
        for d in ds:
            dm.add_segment_dir(d)
            jdm.add_segment_dir(d)
        b.register_table(dm)
        jb.register_table(jdm)
    brokers["star"] = (b, jb)
    cols, queries = vec.vec_table(2000, VCOLS, n_queries=2)
    tdirs = vec.build_table(str(out / "vec"), cols, columns=VCOLS,
                            n_lists=8)
    brokers["vec"] = _pair(tdirs, "vt")
    yield brokers, queries
    for b, _jb in brokers.values():
        for t in b.table_names:
            reset_port_memory(b.table(t).acquire_segments())


def _shape(sp):
    """(name, attribute keys, children) less the JAX-only parts."""
    return (sp["name"],
            tuple(sorted(k for k in sp["attrs"] if k not in JAX_ONLY_ATTRS)),
            tuple(_shape(c) for c in sp["children"]
                  if c["name"] not in JAX_ONLY_SPANS))


def _names(sp):
    yield sp["name"]
    for c in sp["children"]:
        yield from _names(c)


def _analyze(b, jb, sql):
    for _ in range(2):      # the second run: caches warm in both
        got = b.query("EXPLAIN ANALYZE " + sql)
        want = jb.query("EXPLAIN ANALYZE " + sql)
    return got, want


def _check_tree(got, want):
    assert got.columns == want.columns == [
        "Node", "Node_Id", "Parent_Id", "Time_Ms", "Detail"]
    assert _shape(got.trace["spans"]) == _shape(want.trace["spans"])
    assert set(_names(got.trace["spans"])) <= phases.SPAN_NAMES
    root = got.trace["spans"]
    assert abs(sum(c["ms"] for c in root["children"]) - root["ms"]) \
        <= 0.1 * root["ms"] + 0.01


@pytest.mark.parametrize("kind", list(KINDS))
def test_span_tree_equals_jax(env, kind):
    brokers, _q = env
    where, sql = KINDS[kind]
    b, jb = brokers[where]
    got, want = _analyze(b, jb, sql)
    _check_tree(got, want)
    names = set(_names(got.trace["spans"]))
    assert KIND_SPAN[kind] in names, (kind, names)
    if kind == "rollup":        # planned and run on the rollup segment
        assert any(r[0] == "plan_segment" and "segment=startree0" in r[4]
                   for r in got.rows), got.rows
    # the analyzed rows render the same tree: Node / Node_Id / Parent_Id
    # agree (the warm run traces no JAX program)
    assert not any(r[0] in JAX_ONLY_SPANS for r in want.rows)
    assert [r[:3] for r in got.rows] == [r[:3] for r in want.rows]
    assert got.rows[0][3] > 0 and got.trace["spans"]["attrs"]["rows"] \
        == len(connect(b)(sql).rows)


@pytest.mark.parametrize("kind", ["compact", "dense", "batched"])
def test_profile_phases_tree_equals_jax(env, kind):
    """EXPLAIN ANALYZE with OPTION(profilePhases=true): the kernel's phase
    ladder (mask, fuse, compact, sort, aggregate, transfer) as child
    spans, the same in both packages."""
    brokers, _q = env
    where, sql = KINDS[kind]
    b, jb = brokers[where]
    sql = sql.replace(" OPTION(", " OPTION(profilePhases=true,") \
        if " OPTION(" in sql else sql + " OPTION(profilePhases=true)"
    got, want = _analyze(b, jb, sql)
    _check_tree(got, want)
    names = set(_names(got.trace["spans"]))
    assert {"phase_profile", "phase_mask", "phase_aggregate"} <= names
    if kind == "compact":
        assert {"phase_fuse", "phase_compact", "phase_transfer"} <= names


def test_vector_span_tree_equals_jax(env):
    brokers, queries = env
    b, jb = brokers["vec"]
    vs = vec.vs("emb", queries["emb"][0], 5)
    sql = f"SELECT SUM(views), COUNT(*) FROM vt WHERE {vs}"
    got, want = _analyze(b, jb, sql)
    _check_tree(got, want)
    assert "vector_search" in set(_names(got.trace["spans"]))


def test_cube_span_trees_equal_jax(env):
    """Two concurrent EXPLAIN ANALYZEs fuse into one cube dispatch: the
    leader's tree parents cube_build and fused_execute, the follower's
    ragged_dispatch only; the pair of trees equals the JAX package's."""
    brokers, _q = env
    b, jb = brokers["ssb"]
    sqls = [SSB["q1.1"], SSB["q1.1"].replace("1993", "1994")]
    shapes = {}
    window = {"port": tragged.global_batcher.window_ms,
              "jax": jragged.global_batcher.window_ms}
    for name, broker, mod, cubes, acc in (
            ("port", b, tragged, t_cubes, t_acc),
            ("jax", jb, jragged, j_cubes, j_acc)):
        mod.global_batcher.configure(enabled=True, window_ms=800.0)
        # a registered idle peer: neither query may skip the window
        # because the other has not registered yet
        acc.register("idle_peer")
        try:
            for _ in range(2):
                cubes.clear()
                gate = threading.Barrier(2)
                trees = [None, None]

                def run(i):
                    gate.wait()
                    trees[i] = broker.query("EXPLAIN ANALYZE " + sqls[i])

                ts = [threading.Thread(target=run, args=(i,))
                      for i in range(2)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
            shapes[name] = sorted(repr(_shape(t.trace["spans"]))
                                  for t in trees)
            names = set().union(*(_names(t.trace["spans"]) for t in trees))
            assert {"ragged_dispatch", "cube_build",
                    "fused_execute"} <= names, (name, names)
        finally:
            acc.unregister("idle_peer")
            mod.global_batcher.configure(window_ms=window[name])
            cubes.clear()
    assert shapes["port"] == shapes["jax"]


def test_trace_option_phase_keys_equal_jax(env):
    brokers, _q = env
    for where, sql in (("ssb", SSB["q2.1"]), ("table", SSB["q4.1"]),
                       ("rollup", KINDS["rollup"][1])):
        b, jb = brokers[where]
        got = b.query(sql + " OPTION(trace=true)")
        want = jb.query(sql + " OPTION(trace=true)")
        assert set(got.trace) == set(want.trace)
        assert sorted(got.trace["phases"]) == sorted(want.trace["phases"])
        assert got.trace["counters"] == want.trace["counters"]
        assert set(got.trace["phases"]) <= phases.TRACED_PHASES
        assert got.rows == connect(b)(sql).rows
        assert b.query(sql).trace is None


def test_render_prometheus_equal_on_one_snapshot():
    snap = {"counters": {"broker_queries": 7, "tenant_shed_a-b": 1},
            "gauges": {"ingest_freshness_ms_t.x": 12.5, "rung": 0},
            "timers": {"broker_query": {"count": 3, "p50": 1.25,
                                        "p99": 7.0, "max": 7.0}}}
    assert tmetrics.render_prometheus(snap) == \
        jmetrics.render_prometheus(snap)
    assert tmetrics.ingest_health({**snap, "gauge_age_s": {}}) == \
        jmetrics.ingest_health({**snap, "gauge_age_s": {}})
    assert tmetrics.overload_health(snap) == jmetrics.overload_health(snap)
    reg, jreg = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for r in (reg, jreg):
        r._now = lambda: 100.0
        r.count("q", 3)
        r.gauge("g", 2.0)
        with r.timer("t"):
            pass
        r._timers["t"] = [4.0, 1.0, 2.0]
    assert reg.snapshot() == jreg.snapshot()
    assert reg.prometheus() == jreg.prometheus()


def test_sample_decision_equal_on_10000_ids():
    rng = np.random.default_rng(11)
    ids = [f"q{x:x}" for x in rng.integers(0, 1 << 48, 10_000)]
    for ratio in (0.0, 0.01, 0.25, 0.5, 0.999, 1.0):
        got = [tspans.sample_decision(i, ratio) for i in ids]
        assert got == [jspans.sample_decision(i, ratio) for i in ids]
    assert 2000 < sum(tspans.sample_decision(i, 0.25) for i in ids) < 3000


def test_sampled_query_tree_and_counter(env, monkeypatch):
    brokers, _q = env
    b, jb = brokers["ssb"]
    roots = {}
    for name, broker in (("port", b), ("jax", jb)):
        real = broker._append_trace
        monkeypatch.setattr(
            broker, "_append_trace",
            lambda root, *a, _n=name, _r=real: (
                roots.__setitem__(_n, root.to_dict()), _r(root, *a)))
    for broker in (b, jb):      # warm: the JAX kernel compiles untraced
        broker.query(SSB["q2.1"] + " OPTION(traceRatio=0)")
    before = global_metrics.snapshot()["counters"].get("sampled_traces", 0)
    sql = SSB["q2.1"] + " OPTION(traceRatio=1.0, queryId=abc)"
    got, want = b.query(sql), jb.query(sql)
    assert got.rows == connect(b)(SSB["q2.1"]).rows and got.trace is None
    assert ssb._digest(got.rows) == ssb._digest(want.rows)
    assert _shape(roots["port"]) == _shape(roots["jax"])
    assert roots["port"]["attrs"]["query_id"] == "abc"
    after = global_metrics.snapshot()["counters"]["sampled_traces"]
    assert after == before + 1
    # a ratio of 0 or an unsampled id runs untraced
    b.query(SSB["q2.1"] + " OPTION(traceRatio=0)")
    assert global_metrics.snapshot()["counters"]["sampled_traces"] == after
    with pytest.raises(Exception, match="traceRatio"):
        b.query(SSB["q2.1"] + " OPTION(traceRatio=2)")


def test_inactive_span_allocates_no_span(monkeypatch):
    made = []
    real_init = tspans.Span.__init__

    def counting(self, *a, **k):
        made.append(1)
        real_init(self, *a, **k)

    monkeypatch.setattr(tspans.Span, "__init__", counting)
    assert not tspans.tracing_active()
    for _ in range(100):
        with tspans.span("segment_kernel", segment="s") as sp:
            assert sp is None
        tspans.annotate(x=1)
        tspans.add_event("phase_mask", 1.0)
        tspans.device_fence({"a": None})
    assert made == []
    root = tspans.span_tracer.start("query")
    with tspans.span("planning"):
        pass
    assert tspans.span_tracer.stop() is root and len(made) == 2
