"""Cross-query micro-batching (K14) of the port against the JAX package, on
the CPU.

Two small tables, each loaded by both packages from one directory: the
flat SSB lineorder segment (2^14 rows as in tests/test_torch_ssb.py,
and 2^17 rows for the kernels, where every concurrent shape's cube fits
the bucket) and a ``grp`` table
shaped like the JAX package's own batching tests (two string group
columns, two dictionary dimensions, a raw dimension of small span and
two metrics). Checked:

- the cube build and the combine of the port equal the JAX package's
  ``build_cube_kernel`` and ``build_cube_combine_kernel`` array for array
  (int64, exactly) on the same segment and stacked literal params, for
  predicates of every fusable node kind (EqId, IdRange, InSet by search,
  InBitmap, Cmp over a value expression, And, Or, Not);
- the combine by ``torch.func.vmap`` over the items equals the per-item
  loop, its plain version, for every node kind above;
- ``cube_spec_for`` gives the JAX package's spec (or refusal) over a list
  of plans: eligible, min/max, float sum, CASE, MV, raw span, space
  limits; the port also keys the spec by column names, where the JAX
  package gives two plans over different columns one spec;
- fused results equal serial ones, and the JAX broker's, at concurrency
  2, 8 and 32; the 13 SSB queries fired together equal their serial rows;
- admission: a lone query never waits the window, a deadline-pressed one
  bypasses the queue, an ineligible one counts its reason, a failing
  leader sends every query of its batch solo with the right rows;
- the cube cache: hits, a demotion and a replacement evict the segment's
  cubes, and ``reconcile_devmem`` agrees with what is held.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402
from pinot_tpu.broker import Broker as JaxBroker  # noqa: E402
from pinot_tpu.engine import executor as jexec  # noqa: E402
from pinot_tpu.engine import ragged as jragged  # noqa: E402
from pinot_tpu.query.context import build_query_context as j_ctx  # noqa
from pinot_tpu.query.planner import SegmentPlanner as JPlanner  # noqa
from pinot_tpu.query.sql import parse_sql as j_parse  # noqa: E402
from pinot_tpu.server import TableDataManager as JaxTable  # noqa: E402
from pinot_tpu_torch.broker import Broker  # noqa: E402
from pinot_tpu_torch.engine import batch  # noqa: E402
from pinot_tpu_torch.engine import executor as texec  # noqa: E402
from pinot_tpu_torch.engine import ragged  # noqa: E402
from pinot_tpu_torch.engine.accounting import global_accountant  # noqa
from pinot_tpu_torch.engine.ragged import (batching_health,  # noqa: E402
                                           cube_spec_for, global_batcher)
from pinot_tpu_torch.engine.tier import reconcile_devmem  # noqa: E402
from pinot_tpu_torch.ops.plan_cache import global_cube_cache  # noqa: E402
from pinot_tpu_torch.query.context import build_query_context  # noqa
from pinot_tpu_torch.query.planner import SegmentPlanner  # noqa: E402
from pinot_tpu_torch.query.sql import parse_sql  # noqa: E402
from pinot_tpu_torch.segment import SegmentBuilder  # noqa: E402
from pinot_tpu_torch.segment.immutable import ImmutableSegment  # noqa
from pinot_tpu_torch.server import TableDataManager  # noqa: E402
from pinot_tpu_torch.spi import (DataType, FieldSpec, FieldType,  # noqa
                                 Schema, TableConfig)
from pinot_tpu_torch.tools import ssb  # noqa: E402
from pinot_tpu_torch.utils.metrics import global_metrics  # noqa: E402
from test_torch_tier import reset_port_memory  # noqa: E402

N_SSB = 1 << 14
N_CUBE = 1 << 17    # the smallest bucket that holds q3.1's 109,375 cells
OPT = " OPTION(timeoutMs=600000)"


@pytest.fixture(autouse=True)
def _clean_batcher(monkeypatch):
    """Each test starts and ends with an empty cube cache and the
    batcher's process defaults (later files reconcile device memory)."""
    monkeypatch.setenv("PINOT_CPU_FAST_GROUPBY", "1")
    global_cube_cache.clear()
    yield
    global_batcher.configure(enabled=ragged.default_enabled(),
                             window_ms=ragged.DEFAULT_WINDOW_MS,
                             max_batch=ragged.DEFAULT_MAX_BATCH)
    global_batcher.clear()
    global_cube_cache.clear()
    assert global_accountant.running() == []


def _counter(name: str) -> int:
    return global_metrics.snapshot()["counters"].get(name, 0)


def _tables(d, name):
    dm = TableDataManager(name, device="cpu")
    dm.add_segment_dir(d)
    b = Broker(device="cpu")
    b.register_table(dm)
    jdm = JaxTable(name)
    jdm.add_segment_dir(d)
    jb = JaxBroker()
    jb.register_table(jdm)
    return dm, b, jdm, jb


@pytest.fixture(scope="module")
def ssb_t(tmp_path_factory):
    d = ssb.build_segment_dir(N_SSB, str(tmp_path_factory.mktemp("rssb")))
    yield _tables(d, "lineorder")
    reset_port_memory()


@pytest.fixture(scope="module")
def ssb_big(tmp_path_factory):
    d = ssb.build_segment_dir(N_CUBE, str(tmp_path_factory.mktemp("rbig")))
    yield _tables(d, "lineorder")
    reset_port_memory()


@pytest.fixture(scope="module")
def grp_t(tmp_path_factory):
    rng = np.random.default_rng(7)
    n = 8192
    cols = {
        "g1": rng.choice([f"a{i}" for i in range(8)], n),
        "g2": rng.choice([f"b{i}" for i in range(10)], n),
        "f": rng.integers(0, 20, n).astype(np.int32),
        "e": rng.integers(0, 30, n).astype(np.int32),
        "r": rng.integers(100, 131, n).astype(np.int32),
        "v": rng.integers(0, 1000, n).astype(np.int32),
        "w": rng.random(n),
    }
    schema = Schema("grp", [
        FieldSpec("g1", DataType.STRING),
        FieldSpec("g2", DataType.STRING),
        FieldSpec("f", DataType.INT, FieldType.DIMENSION),
        FieldSpec("e", DataType.INT, FieldType.DIMENSION),
        FieldSpec("r", DataType.INT, FieldType.DIMENSION),
        FieldSpec("v", DataType.INT, FieldType.METRIC),
        FieldSpec("w", DataType.DOUBLE, FieldType.METRIC),
    ])
    cfg = TableConfig("grp")
    cfg.indexing.no_dictionary_columns = ["r"]
    d = SegmentBuilder(schema, cfg).build(
        cols, str(tmp_path_factory.mktemp("rgrp")), "g_0")
    yield _tables(d, "grp")
    reset_port_memory()


def _grp(i: int) -> str:
    return (f"SELECT g1, g2, SUM(v), COUNT(*), AVG(v) FROM grp"
            f" WHERE f < {5 + i % 12} GROUP BY g1, g2"
            f" ORDER BY g1, g2 LIMIT 1000")


def _q11(i: int) -> str:
    return ssb.CONCURRENT[0][1](i)


# predicate shapes for the kernel parity: (table, sql of variant i)
BRANDS = ssb.BRANDS
KERNEL_CASES = {
    "q1.1 eq+range": ("ssb", _q11),
    "q3.1 grouped": ("ssb", ssb.CONCURRENT[2][1]),
    "q4.1 or-of-eq": ("ssb", ssb.CONCURRENT[3][1]),
    "inbitmap": ("ssb", lambda i: (
        "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE p_brand1 "
        "IN (" + ", ".join(f"'{BRANDS[(7 * i + 3 * k) % 1000]}'"
                           for k in range(70)) + ")")),
    "grp count/sum/avg": ("grp", _grp),
    "in-or-not": ("grp", lambda i: (
        f"SELECT g1, COUNT(*), SUM(v) FROM grp WHERE (f IN ({i % 5}, "
        f"{i % 5 + 3}, {i % 5 + 7}) OR f > {14 + i % 4}) "
        f"AND NOT g2 = 'b{i % 10}' GROUP BY g1 ORDER BY g1")),
    "raw inset-search": ("grp", lambda i: (
        "SELECT COUNT(*), SUM(v) FROM grp WHERE r IN ("
        + ", ".join(str(90 + (i + 3 * k) % 60) for k in range(70)) + ")")),
    "cmp expr": ("grp", lambda i: (
        f"SELECT g2, SUM(v), COUNT(*) FROM grp WHERE r - f > {100 + i} "
        f"GROUP BY g2 ORDER BY g2")),
}


def _sig(plan):
    return batch._param_sig(texec.resolve_params(plan))


def _plans(tables, make, n):
    """(port plans, JAX plans) of the first n variants that share variant
    0's plan structure (a literal at a column's edge can drop a bound,
    which makes another structure) on the table's one segment."""
    dm, _b, jdm, _jb = tables
    seg, jseg = dm.acquire_segments()[0], jdm.acquire_segments()[0]
    tp, jp = [], []
    for i in range(64):
        t = SegmentPlanner(build_query_context(parse_sql(make(i))), seg
                           ).plan()
        j = JPlanner(j_ctx(j_parse(make(i))), jseg).plan()
        if tp and (t.kernel_plan != tp[0].kernel_plan
                   or j.kernel_plan != jp[0].kernel_plan
                   or _sig(t) != _sig(tp[0])):
            continue
        tp.append(t)
        jp.append(j)
        if len(tp) == n:
            break
    assert len(tp) == n
    return tp, jp


def _same_spec(t, j):
    return (t.dims, t.group_space, t.pred_space, t.cube_space, t.bucket,
            t.n_cols) == (j.dims, j.group_space, j.pred_space,
                          j.cube_space, j.bucket, j.n_cols)


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_cube_kernels_match_jax(ssb_big, grp_t, case):
    """Cube build and combine, port against JAX, on N = 5 stacked literal
    sets (padded to 8 by repeating item 0, as the batcher pads)."""
    which, make = KERNEL_CASES[case]
    tables = ssb_big if which == "ssb" else grp_t
    tp, jp = _plans(tables, make, 5)
    assert all(p.kind == "kernel" for p in tp + jp)
    tspec, why = cube_spec_for(tp[0])
    jspec, jwhy = jragged.cube_spec_for(jp[0])
    assert tspec is not None and jspec is not None, (why, jwhy)
    assert _same_spec(tspec, jspec)
    assert all(cube_spec_for(p)[0] == tspec for p in tp)

    seg, jseg = tp[0].segment, jp[0].segment
    cube = ragged.build_cube_kernel(tspec)(
        seg.device_cols(tp[0].col_names), seg.n_docs,
        texec.resolve_params(tp[0]))
    jcube = jax.device_get(jax.jit(jragged.build_cube_kernel(jspec))(
        jseg.device_cols(jp[0].col_names), jnp.int32(jseg.n_docs),
        jexec.resolve_params(jp[0])))
    assert sorted(cube) == sorted(jcube)
    for k in cube:
        assert cube[k].dtype == torch.int64
        np.testing.assert_array_equal(cube[k].numpy(), jcube[k])
    assert int(cube["cnt"].sum()) > 0

    order = [0, 1, 2, 3, 4, 0, 0, 0]
    tparams = [texec.resolve_params(p) for p in tp]
    jparams = [jexec.resolve_params(p) for p in jp]
    stacked = tuple(torch.stack([tparams[k][j] for k in order])
                    for j in range(len(tparams[0])))
    jstacked = tuple(jnp.stack([jparams[k][j] for k in order])
                     for j in range(len(jparams[0])))
    out = ragged.build_cube_combine_kernel(tspec)(
        {k: v[None] for k, v in cube.items()},
        torch.zeros(8, dtype=torch.int64), stacked)
    jout = jax.device_get(jragged.build_cube_combine_kernel(jspec)(
        {k: jnp.asarray(v)[None] for k, v in jcube.items()},
        jnp.zeros(8, dtype=jnp.int32), jstacked))
    assert sorted(out) == sorted(jout)
    for k in out:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    # each item equals that variant's own solo kernel, extracted
    for k in range(5):
        per = {name: v[k].numpy() for name, v in out.items()}
        fused = texec.extract_partial(tp[k], per)
        solo = texec.extract_partial(tp[k], texec.run_kernel(tp[k]))
        assert vars(fused) == vars(solo)


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_vmap_combine_equals_the_loop(ssb_big, grp_t, case):
    which, make = KERNEL_CASES[case]
    tables = ssb_big if which == "ssb" else grp_t
    tp, _jp = _plans(tables, make, 4)
    spec = cube_spec_for(tp[0])[0]
    seg = tp[0].segment
    cube = ragged.build_cube_kernel(spec)(
        seg.device_cols(tp[0].col_names), seg.n_docs,
        texec.resolve_params(tp[0]))
    params = [texec.resolve_params(p) for p in tp]
    stacked = tuple(torch.stack([params[k][j] for k in range(4)])
                    for j in range(len(params[0])))
    grid = ragged._grid_cols(spec, torch.device("cpu"))
    vm = ragged.cube_masks(spec, grid, stacked, 4, vmap=True)
    loop = ragged.cube_masks(spec, grid, stacked, 4, vmap=False)
    assert vm.shape == (4, spec.cube_space) and vm.dtype == torch.bool
    assert torch.equal(vm, loop) and bool(vm.any())
    cubes = {k: v[None] for k, v in cube.items()}
    idx = torch.zeros(4, dtype=torch.int64)
    a = ragged.build_cube_combine_kernel(spec, vmap=True)(cubes, idx,
                                                          stacked)
    b = ragged.build_cube_combine_kernel(spec, vmap=False)(cubes, idx,
                                                           stacked)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


SPEC_CASES = {
    "eligible q1.1": ("ssb", _q11(0), True),
    "eligible grouped": ("grp", _grp(3), True),
    "min/max": ("grp", "SELECT g1, MIN(v), MAX(v) FROM grp WHERE f < 9 "
                       "GROUP BY g1", False),
    "float sum": ("ssb", "SELECT AVG(lo_revenue / lo_quantity) FROM "
                         "lineorder WHERE d_year = 1993", False),
    "double column": ("grp", "SELECT SUM(w) FROM grp WHERE f < 4", False),
    "case in agg": ("grp", "SELECT SUM(CASE WHEN f < 5 THEN v ELSE 0 END)"
                           " FROM grp WHERE g1 = 'a1'", False),
    "raw span": ("ssb", "SELECT COUNT(*) FROM lineorder WHERE "
                        "lo_revenue < 3000000", False),
    "group space": ("ssb", bench.spec_to_sql(*bench.QUERIES[-1][1:]),
                    False),
    "cube over bucket": ("ssb", ssb.CONCURRENT[1][1](0), False),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_cube_spec_reasons_match_jax(ssb_t, grp_t, case):
    which, sql, eligible = SPEC_CASES[case]
    tables = ssb_t if which == "ssb" else grp_t
    tp, jp = _plans(tables, lambda i: sql, 1)
    if tp[0].kind != "kernel":
        pytest.fail(f"{case}: planned {tp[0].kind}")
    tspec, why = cube_spec_for(tp[0])
    jspec, jwhy = jragged.cube_spec_for(jp[0])
    assert (tspec is None, why) == (jspec is None, jwhy)
    assert (tspec is not None) == eligible
    if eligible:
        assert _same_spec(tspec, jspec)


def test_cube_spec_of_an_mv_predicate_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    n = 2048
    tags = [list(rng.choice(["x", "y", "z", "u"], rng.integers(1, 4)))
            for _ in range(n)]
    schema = Schema("mv", [FieldSpec("tag", DataType.STRING,
                                     single_value=False),
                           FieldSpec("v", DataType.INT, FieldType.METRIC)])
    d = SegmentBuilder(schema, TableConfig("mv")).build(
        {"tag": tags, "v": rng.integers(0, 9, n).astype(np.int32)},
        str(tmp_path), "m0")
    tables = _tables(d, "mv")
    tp, jp = _plans(tables, lambda i: "SELECT SUM(v) FROM mv WHERE "
                                      "tag = 'x'", 1)
    assert cube_spec_for(tp[0]) == (None, "incompatible") \
        == jragged.cube_spec_for(jp[0])


def test_cube_spec_is_keyed_by_column_names(grp_t):
    """Two plans that differ only in the column they read: the JAX
    package's KernelPlans are equal and so are its specs (its cube cache
    and admission key would serve one query from the other's cube); the
    port's specs carry the column names and differ."""
    sa = "SELECT SUM(v) FROM grp WHERE f < 5"
    sb = "SELECT SUM(v) FROM grp WHERE e < 5"
    (ta,), (ja,) = _plans(grp_t, lambda i: sa, 1)
    (tb,), (jb,) = _plans(grp_t, lambda i: sb, 1)
    assert ta.kernel_plan == tb.kernel_plan and ta.col_names != tb.col_names
    assert jragged.cube_spec_for(ja)[0] == jragged.cube_spec_for(jb)[0]
    spec_a, spec_b = cube_spec_for(ta)[0], cube_spec_for(tb)[0]
    assert spec_a is not None and spec_b is not None and spec_a != spec_b
    # and concurrent waves over each column answer as the serial path
    _dm, b, _jdm, _jb = grp_t
    for make in (lambda i: f"SELECT SUM(v) FROM grp WHERE f < {3 + i}",
                 lambda i: f"SELECT SUM(v) FROM grp WHERE e < {3 + i}"):
        sqls = [make(i) + OPT for i in range(8)]
        global_batcher.configure(enabled=False)
        serial = [b.query(s).rows for s in sqls]
        global_batcher.configure(enabled=True, window_ms=30.0)
        assert [r.rows for r in _concurrent(b, sqls)] == serial


def _concurrent(broker, sqls, barrier_timeout=30):
    results = [None] * len(sqls)
    errs = []
    barrier = threading.Barrier(len(sqls))

    def run(i):
        try:
            barrier.wait(barrier_timeout)
            results[i] = broker.query(sqls[i])
        except Exception as e:  # noqa: BLE001 - surfaced in the assert
            errs.append(f"q{i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(sqls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    return results


@pytest.mark.parametrize("concurrency", [2, 8, 32])
def test_fused_vs_serial_digests(ssb_t, grp_t, concurrency):
    """Variants sharing a plan structure at concurrency 2-32: fused rows
    equal the serial dispatch's and the JAX broker's, for the scalar
    (q1.1) and the grouped cube."""
    for tables, make in ((ssb_t, _q11), (grp_t, _grp)):
        _dm, b, _jdm, jb = tables
        sqls = [make(i) + OPT for i in range(concurrency)]
        global_batcher.configure(enabled=False)
        serial = [b.query(s).rows for s in sqls]
        assert serial == [jb.query(s).rows for s in sqls]
        global_batcher.configure(enabled=True, window_ms=30.0,
                                 max_batch=concurrency)
        fused0 = _counter("batched_queries")
        results = _concurrent(b, sqls)
        assert [ssb._digest(r.rows) for r in results] == \
            [ssb._digest(r) for r in serial]
        if concurrency >= 8:
            assert _counter("batched_queries") > fused0
    assert _counter("fused_dispatch_errors") == 0


def test_queries_without_literals_fuse(ssb_t):
    """A plan with no params (no WHERE) is cube-eligible: identical
    concurrent queries fuse without a failed dispatch and keep the serial
    and the JAX broker's rows (the JAX package's vmap over no params
    raises there, and every such batch falls back solo)."""
    _dm, b, _jdm, jb = ssb_t
    sqls = [s + OPT for s in (
        "SELECT d_year, SUM(lo_revenue) FROM lineorder GROUP BY d_year "
        "ORDER BY d_year",
        "SELECT COUNT(*), SUM(lo_quantity) FROM lineorder")]
    for sql in sqls:
        global_batcher.configure(enabled=False)
        serial = b.query(sql).rows
        assert serial == jb.query(sql).rows
        global_batcher.configure(enabled=True, window_ms=30.0)
        fused0 = _counter("batched_queries")
        assert all(r.rows == serial for r in _concurrent(b, [sql] * 8))
        assert _counter("batched_queries") > fused0
    assert _counter("fused_dispatch_errors") == 0


def test_ssb_corpus_under_concurrency(ssb_t):
    """The 13 SSB queries fired together with batching on: eligible and
    ineligible shapes alike keep their serial rows."""
    _dm, b, _jdm, _jb = ssb_t
    sqls = [ssb.spec_to_sql(p, v, g) + OPT for _q, p, v, g in ssb.QUERIES]
    global_batcher.configure(enabled=False)
    serial = [b.query(s).rows for s in sqls]
    global_batcher.configure(enabled=True, window_ms=10.0)
    for r, s in zip(_concurrent(b, sqls), serial):
        assert ssb._digest(r.rows) == ssb._digest(s)


def test_lone_query_never_waits_the_window(ssb_t):
    _dm, b, _jdm, _jb = ssb_t
    global_batcher.configure(enabled=True, window_ms=2000.0)
    before = _counter("solo_fallback_no_peers")
    t0 = time.perf_counter()
    res = b.query(_q11(1) + OPT)
    assert time.perf_counter() - t0 < 1.5
    assert res.rows and _counter("solo_fallback_no_peers") == before + 1


def test_deadline_pressed_query_bypasses_the_queue(ssb_t):
    _dm, b, _jdm, _jb = ssb_t
    global_batcher.configure(enabled=True, window_ms=2000.0)
    global_accountant.register("peer-query")   # a peer exists
    try:
        before = _counter("solo_fallback_deadline")
        t0 = time.perf_counter()
        res = b.query(_q11(0) + " OPTION(timeoutMs=1500)")
        wall = time.perf_counter() - t0
    finally:
        global_accountant.unregister("peer-query")
    assert res.rows and wall < 1.5
    assert _counter("solo_fallback_deadline") == before + 1


def test_incompatible_plan_counts_its_reason(ssb_t):
    _dm, b, _jdm, _jb = ssb_t
    q43 = bench.spec_to_sql(*bench.QUERIES[-1][1:])
    global_batcher.configure(enabled=True, window_ms=5.0)
    global_accountant.register("peer-query-2")
    try:
        before = _counter("solo_fallback_incompatible")
        b.query(q43 + OPT)
    finally:
        global_accountant.unregister("peer-query-2")
    assert _counter("solo_fallback_incompatible") == before + 1


def test_a_failing_leader_sends_its_batch_solo(grp_t, monkeypatch):
    _dm, b, _jdm, _jb = grp_t
    sqls = [_grp(i) + OPT for i in range(8)]
    global_batcher.configure(enabled=False)
    serial = [b.query(s).rows for s in sqls]

    def boom(self, spec, batch):
        raise RuntimeError("leader failed")

    monkeypatch.setattr(ragged.RaggedBatcher, "_execute_fused", boom)
    global_batcher.configure(enabled=True, window_ms=30.0)
    errors0 = _counter("fused_dispatch_errors")
    solo0 = _counter("solo_fallback_leader_error")
    assert [r.rows for r in _concurrent(b, sqls)] == serial
    fails = _counter("fused_dispatch_errors") - errors0
    assert fails >= 1
    # the leader and each of its followers fall back, reason leader_error
    assert _counter("solo_fallback_leader_error") - solo0 >= 2 * fails


def test_cube_cache_hits_demotion_and_replacement(grp_t, tmp_path):
    dm, b, _jdm, _jb = grp_t
    seg = dm.acquire_segments()[0]
    reset_port_memory([seg])
    global_batcher.configure(enabled=True, window_ms=30.0)
    sqls = [_grp(i) + OPT for i in range(6)]
    _concurrent(b, sqls)
    hits0 = _counter("cube_cache_hits")
    _concurrent(b, sqls)
    assert _counter("cube_cache_hits") > hits0
    stats = global_cube_cache.stats()
    assert stats["entries"] == 1 and stats["stacked"] == 1
    assert [k[1] for k in global_cube_cache._entries] == [seg.uid]
    rec = reconcile_devmem([seg])
    assert all(r["tracked"] == r["actual"] for r in rec.values()), rec
    assert rec["cube_cache"]["actual"] > 0
    seg.demote_device()                  # the tier's demotion
    assert global_cube_cache.stats()["entries"] == 0
    rec = reconcile_devmem([seg])
    assert all(r["tracked"] == r["actual"] for r in rec.values()), rec
    assert rec["cube_cache"]["tracked"] == rec["cube_stacked"][
        "tracked"] == 0
    # replacing the segment by name releases the old one's cubes
    _concurrent(b, sqls)
    assert global_cube_cache.stats()["entries"] == 1
    dm.replace_segment(ImmutableSegment.load(seg.dir, "cpu"))
    assert global_cube_cache.stats()["entries"] == 0
    dm.replace_segment(seg)              # the module's segment again
    reset_port_memory([seg])


def test_batching_health_block():
    block = batching_health(global_metrics.snapshot())
    assert set(block["solo_fallbacks"]) == {
        "incompatible", "no_peers", "deadline", "window_expired",
        "timeout", "leader_error"}
    assert set(block["batch_size_histogram"]) == {
        "le_2", "le_4", "le_8", "le_16", "le_32", "gt_32"}
    assert {"enabled", "batch_queue_depth", "cube_cache_bytes",
            "batched_dispatches"} <= set(block)


def test_concurrent_shapes_render_the_bench_sql():
    assert [s for s, _m in ssb.CONCURRENT] == \
        [s for s, _m in bench.QPS_SHAPES]
    for (_s, make), (_b, bmake) in zip(ssb.CONCURRENT, bench.QPS_SHAPES):
        assert [make(k) for k in range(32)] == [bmake(k) for k in range(32)]
