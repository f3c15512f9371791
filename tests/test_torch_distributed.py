"""Mesh-resident tables (K18): the JAX package's DistributedTable against
the port's.

The cases of ``tests/test_distributed.py`` through both packages on the
same shared-dictionary segments (built once by the JAX builder, loaded by
both): the JAX side on the suite's 8 virtual CPU devices
(``segment_mesh(n)``), the port on ``logical_mesh(n, "cpu")`` for n in 1,
2, 4, 8. Both partials are reduced by their own package; integers must
match exactly, floats to a relative 1e-9 (the shards' sums are added in
another order than ``psum``'s). The fallbacks that return None, a forced
compaction overflow and its retry, and the 13 SSB queries through the
port's broker over an 8-segment shared-dictionary table with and without
``set_distributed`` (digests equal to the numpy oracle's) complete it; the
stacks are charged to the ``mesh_stack`` pool and leave with the table.
"""
import numpy as np
import pytest

from pinot_tpu.engine.reduce import reduce_partials as j_reduce
from pinot_tpu.parallel import DistributedTable as JaxDist
from pinot_tpu.parallel import distributed as jdist
from pinot_tpu.parallel import segment_mesh as jax_mesh
from pinot_tpu.query.context import build_query_context as j_ctx
from pinot_tpu.query.sql import parse_sql as j_parse
from pinot_tpu.segment import SegmentBuilder
from pinot_tpu.segment.builder import build_table_dictionaries
from pinot_tpu.server import TableDataManager as JaxTable
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema, \
    TableConfig
from pinot_tpu_torch.broker import Broker
from pinot_tpu_torch.engine.reduce import reduce_partials
from pinot_tpu_torch.engine.tier import reconcile_devmem
from pinot_tpu_torch.parallel import DistributedTable, logical_mesh
from pinot_tpu_torch.parallel import distributed as tdist
from pinot_tpu_torch.query.context import build_query_context
from pinot_tpu_torch.query.sql import parse_sql
from pinot_tpu_torch.segment import load_segment
from pinot_tpu_torch.server import TableDataManager
from pinot_tpu_torch.tools import ssb
from pinot_tpu_torch.utils.devmem import global_device_memory

REL = 1e-9


def _build(tmp_path_factory, name, schema, chunks):
    shared = build_table_dictionaries(schema, TableConfig(name), chunks)
    builder = SegmentBuilder(schema, TableConfig(name))
    out = tmp_path_factory.mktemp(name)
    jdm, tdm = JaxTable(name), TableDataManager(name, device="cpu")
    for i, c in enumerate(chunks):
        d = builder.build(c, str(out), f"seg_{i}", shared_dicts=shared)
        jdm.add_segment_dir(d)
        tdm.add_segment_dir(d)
    return jdm, tdm


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """{name: (JAX table, port table)}: orders (16 segments, the JAX
    test's), events (8 segments, a compact-strategy group space), ev
    (expression keys over segments of different years), hetero (raw
    ranges that differ by segment)."""
    rng = np.random.default_rng(11)
    out = {}
    chunks = [{"region": rng.choice(["apac", "emea", "latam", "na"], 500),
               "year": rng.integers(2018, 2024, 500).astype(np.int32),
               "qty": rng.integers(1, 50, 500).astype(np.int32),
               "price": np.round(rng.uniform(1, 1000, 500), 2)}
              for _ in range(16)]
    out["orders"] = _build(tmp_path_factory, "orders", Schema("orders", [
        FieldSpec("region", DataType.STRING, FieldType.DIMENSION),
        FieldSpec("year", DataType.INT, FieldType.DIMENSION),
        FieldSpec("qty", DataType.INT, FieldType.METRIC),
        FieldSpec("price", DataType.DOUBLE, FieldType.METRIC)]), chunks)
    rng = np.random.default_rng(23)
    chunks = [{"ka": rng.integers(0, 40, 700).astype(np.int32),
               "kb": rng.integers(0, 60, 700).astype(np.int32),
               "sel": rng.integers(0, 100, 700).astype(np.int32),
               "v": rng.integers(-1000, 1000, 700).astype(np.int64),
               "f": np.round(rng.normal(0, 50, 700), 3)}
              for _ in range(8)]
    out["events"] = _build(tmp_path_factory, "events", Schema("events", [
        FieldSpec("ka", DataType.INT, FieldType.DIMENSION),
        FieldSpec("kb", DataType.INT, FieldType.DIMENSION),
        FieldSpec("sel", DataType.INT, FieldType.DIMENSION),
        FieldSpec("v", DataType.LONG, FieldType.METRIC),
        FieldSpec("f", DataType.DOUBLE, FieldType.METRIC)]), chunks)
    rng = np.random.default_rng(29)
    chunks = []
    for i in range(8):
        lo = 1_500_000_000_000 + i * 40_000_000_000
        chunks.append({
            "ts": rng.integers(lo, lo + 60_000_000_000, 400).astype(np.int64),
            "amt": rng.integers(1, 100, 400).astype(np.int64)})
    out["ev"] = _build(tmp_path_factory, "ev", Schema("ev", [
        FieldSpec("ts", DataType.LONG, FieldType.DIMENSION),
        FieldSpec("amt", DataType.LONG, FieldType.METRIC)]), chunks)
    chunks = [{"d": np.array([1, 2, 1, 2], dtype=np.int32),
               "price": np.array([1, 5, 3, 7], dtype=np.int64)},
              {"d": np.array([1, 2, 2, 1], dtype=np.int32),
               "price": np.array([1000000, 9, 2000000, 10],
                                 dtype=np.int64)}]
    out["hetero"] = _build(tmp_path_factory, "hetero", Schema("hetero", [
        FieldSpec("d", DataType.INT, FieldType.DIMENSION),
        FieldSpec("price", DataType.LONG, FieldType.METRIC)]), chunks)
    return out


def _rows(rows):
    return sorted(tuple(r) for r in rows)


def _same(got, want) -> None:
    got, want = _rows(got), _rows(want)
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=REL), (g, w)
            else:
                assert x == y, (g, w)


def _both(tables, name, n, sql):
    """(port rows or None, JAX rows or None) of ``sql`` on n shards."""
    jdm, tdm = tables[name]
    jd = JaxDist(jdm.acquire_segments(), jax_mesh(n))
    td = DistributedTable(tdm.acquire_segments(), logical_mesh(n, "cpu"))
    try:
        jp = jd.try_execute(j_ctx(j_parse(sql)))
        tp = td.try_execute(build_query_context(parse_sql(sql)))
    finally:
        td.close()
    return (None if tp is None else
            reduce_partials(build_query_context(parse_sql(sql)), [tp]).rows,
            None if jp is None else j_reduce(j_ctx(j_parse(sql)), [jp]).rows)


CASES = {
    "scalar_sums": ("orders", "SELECT SUM(qty), COUNT(*), SUM(price) "
                    "FROM orders WHERE year >= 2020"),
    "min_max_avg": ("orders", "SELECT SUM(qty), MIN(price), MAX(price), "
                    "AVG(qty) FROM orders WHERE region = 'apac'"),
    "group_by": ("orders", "SELECT region, SUM(qty), COUNT(*) FROM orders "
                 "WHERE year >= 2020 GROUP BY region ORDER BY region "
                 "LIMIT 10"),
    "two_keys": ("orders", "SELECT region, year, SUM(price) FROM orders "
                 "GROUP BY region, year ORDER BY region, year LIMIT 100"),
    "distinct_count": ("orders", "SELECT DISTINCTCOUNT(region) FROM "
                       "orders WHERE year = 2019"),
    "hll": ("events", "SELECT DISTINCTCOUNTHLL(kb), COUNT(*) FROM events "
            "WHERE sel < 50"),
    "compact": ("events", "SELECT ka, kb, SUM(v), COUNT(*), MIN(f), "
                "MAX(f) FROM events WHERE sel < 35 GROUP BY ka, kb "
                "LIMIT 100000"),
    "expression_key": ("ev", "SELECT YEAR(ts), COUNT(*), SUM(amt) FROM ev "
                       "GROUP BY 1 ORDER BY 1 LIMIT 100"),
    "raw_range_fold": ("hetero", "SELECT SUM(price), COUNT(*) FROM hetero "
                       "WHERE price <= 10"),
    "raw_range_limbs": ("hetero", "SELECT d, SUM(price) FROM hetero "
                        "GROUP BY d ORDER BY d"),
}


# every case on 4 and 8 shards (more shards than local segments, and
# shards of many segments); a set of them on 1 and 2 too
GRID = [(c, n) for n in (4, 8) for c in CASES] + [
    (c, n) for n in (1, 2)
    for c in ("min_max_avg", "two_keys", "compact", "raw_range_limbs")]


@pytest.mark.parametrize("case,n", GRID)
def test_partials_match_jax(tables, case, n):
    name, sql = CASES[case]
    got, want = _both(tables, name, n, sql)
    assert got is not None and want is not None
    _same(got, want)


FALLBACKS = {
    "empty_filter": ("orders", "SELECT COUNT(*) FROM orders "
                     "WHERE region = 'nowhere'"),
    "theta": ("orders", "SELECT DISTINCTCOUNTTHETASKETCH(region) FROM "
              "orders"),
    "host_plan": ("orders", "SELECT SUM(qty) FROM orders "
                  "OPTION(forceHostExecution=true)"),
}


@pytest.mark.parametrize("case", list(FALLBACKS))
def test_fallbacks_return_none(tables, case):
    name, sql = FALLBACKS[case]
    assert _both(tables, name, 4, sql) == (None, None)


def test_compact_plan_and_cap_scale_to_the_local_shard(tables):
    _jdm, tdm = tables["events"]
    td = DistributedTable(tdm.acquire_segments(), logical_mesh(4, "cpu"))
    plan = td.plan(build_query_context(parse_sql(CASES["compact"][1])))
    assert plan.kind == "kernel" and plan.kernel_plan.strategy == "compact"
    from pinot_tpu_torch.multistage.costs import scaled_compact_cap
    assert td._cost_model_cap(plan) == scaled_compact_cap(
        plan, 2 * td.bucket)
    td.close()


def test_forced_overflow_retries_at_full_capacity(tables, monkeypatch):
    """A capacity of 8 slots (1,024 rows) under a local shard's ~2,500
    matched rows overflows; the rerun at the full local capacity gives
    JAX's rows (held to the same cap)."""
    monkeypatch.setattr(jdist.DistributedTable, "_cost_model_cap",
                        lambda self, plan: 8)
    monkeypatch.setattr(tdist.DistributedTable, "_cost_model_cap",
                        lambda self, plan: 8)
    caps = []
    real = tdist.distributed_kernel

    def spy(*a):
        caps.append(a[-1])
        return real(*a)

    monkeypatch.setattr(tdist, "distributed_kernel", spy)
    got, want = _both(tables, "events", 2, CASES["compact"][1].replace(
        "sel < 35", "sel < 90"))
    _same(got, want)
    from pinot_tpu_torch.ops.compact import full_slots_cap
    assert caps == [8, full_slots_cap(4 * 1024)]


def test_default_mesh_is_one_shard_and_memory_is_tracked(tables):
    _jdm, tdm = tables["orders"]
    segs = tdm.acquire_segments()
    td = DistributedTable(segs)
    assert td.mesh.size == 1 and td.local == 16
    td4 = DistributedTable(segs, logical_mesh(4, "cpu"))
    before = global_device_memory.pool_bytes(tdist.POOL)
    sql = CASES["group_by"][1]
    assert td4.try_execute(build_query_context(parse_sql(sql))) is not None
    held = td4.device_bytes()
    assert held == 3 * 4 * 4 * td4.bucket * 4     # region, year, qty: int32
    assert global_device_memory.pool_bytes(tdist.POOL) == before + held
    rec = reconcile_devmem(segs)[tdist.POOL]
    assert rec["tracked"] == rec["actual"]
    td4.close()
    td.close()
    assert global_device_memory.pool_bytes(tdist.POOL) == before
    rec = reconcile_devmem(segs)[tdist.POOL]
    assert rec["tracked"] == rec["actual"]


@pytest.fixture(scope="module")
def ssb_table(tmp_path_factory):
    out = tmp_path_factory.mktemp("ssb_mesh")
    n = 1 << 14
    ssb.build_table_dir([n // 8] * 8, str(out / "t"), shared_dicts=True)
    one = load_segment(ssb.build_segment_dir(n, str(out / "one")), "cpu")
    want = {qid: ssb._digest(ssb.oracle_run(one, p, v, g)[0])
            for qid, p, v, g in ssb.QUERIES}
    dm = TableDataManager("lineorder", device="cpu")
    dm.add_table_dir(str(out / "t"))
    return dm, want


@pytest.mark.parametrize("n", (1, 4))
def test_ssb_digests_with_and_without_the_mesh(ssb_table, monkeypatch, n):
    dm, want = ssb_table
    broker = Broker(device="cpu")
    broker.register_table(dm)
    ran = []
    real = tdist.DistributedTable.try_execute

    def spy(self, ctx):
        out = real(self, ctx)
        ran.append(out is not None)
        return out

    monkeypatch.setattr(tdist.DistributedTable, "try_execute", spy)
    dm.set_distributed(DistributedTable(dm.acquire_segments(),
                                        logical_mesh(n, "cpu")))
    try:
        for qid, p, v, g in ssb.QUERIES:
            res = broker.query(ssb.spec_to_sql(p, v, g))
            assert ssb._digest(res.rows) == want[qid], qid
            assert res.num_segments == 8
            assert res.num_docs_scanned == 1 << 14
    finally:
        dm.set_distributed(None)
    assert ran == [True] * len(ssb.QUERIES)
    for qid, p, v, g in ssb.QUERIES:
        assert ssb._digest(broker.query(ssb.spec_to_sql(p, v, g)).rows) \
            == want[qid]
    assert len(ran) == len(ssb.QUERIES)
