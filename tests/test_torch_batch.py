"""Many-segment tables through the port's batched dispatch, on the CPU.

One lineorder table in four segments of uneven sizes (not powers of two;
three share a bucket, one does not; small enough that their dictionaries
differ) is served by the JAX ``Broker`` and ``Broker(device="cpu")``: the
13 SSB queries, each also with the compact strategy forced, and the
surface set (``tools/ssb.SURFACE``) must give equal rows, integers exactly
and floats to a relative 1e-9. Also checked: the segmented compact kernel
(K11) gives the JAX package's per-segment partials, each route is taken
where it should be with one output transfer per group (and that packed
transfer returns every output intact), a group past the compaction
kernel's row limit splits into calls that fit, and evicting a segment
drops its stacked columns.
"""
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402
from pinot_tpu.broker import Broker as JaxBroker  # noqa: E402
from pinot_tpu.engine import batch as jbatch  # noqa: E402
from pinot_tpu.engine import executor as jexec  # noqa: E402
from pinot_tpu.query.context import build_query_context as j_ctx  # noqa
from pinot_tpu.query.planner import SegmentPlanner as JPlanner  # noqa
from pinot_tpu.query.sql import parse_sql as j_parse  # noqa: E402
from pinot_tpu.server import TableDataManager as JaxTable  # noqa: E402
from pinot_tpu_torch.broker import Broker, connect  # noqa: E402
from pinot_tpu_torch.engine import batch, serving  # noqa: E402
from pinot_tpu_torch.engine import executor as texec  # noqa: E402
from pinot_tpu_torch.ops import compact  # noqa: E402
from pinot_tpu_torch.query.context import build_query_context as t_ctx  # noqa
from pinot_tpu_torch.query.sql import parse_sql as t_parse  # noqa: E402
from pinot_tpu_torch.server import TableDataManager  # noqa: E402
from pinot_tpu_torch.tools import ssb  # noqa: E402

SIZES = [900, 250, 1000, 2100]
REL = 1e-9
COMPACT = " OPTION(groupByStrategy=compact)"
SSB_SQL = [(qid, ssb.spec_to_sql(p, v, g)) for qid, p, v, g in ssb.QUERIES]


@pytest.fixture(autouse=True)
def _jax_scatter_core(monkeypatch):
    # the JAX package's CPU default core: same results, less CPU time
    monkeypatch.setenv("PINOT_CPU_FAST_GROUPBY", "1")


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    d = ssb.build_table_dir(SIZES, str(tmp_path_factory.mktemp("table")))
    jdm = JaxTable("lineorder")
    jdm.add_table_dir(d)
    jb = JaxBroker()
    jb.register_table(jdm)
    dm = TableDataManager("lineorder", device="cpu")
    dm.add_table_dir(d)
    tb = Broker(device="cpu")
    tb.register_table(dm)
    return jb, dm, connect(tb)


def _close(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)
    return type(a) is type(b) and a == b


def test_table_layout(table):
    _jb, dm, _q = table
    segs = dm.acquire_segments()
    assert dm.num_segments == len(SIZES) and dm.total_docs == sum(SIZES)
    assert sorted(s.n_docs for s in segs) == sorted(SIZES)
    cards = {s.columns["lo_quantity"].cardinality for s in segs}
    assert len(cards) > 1          # the dictionaries differ
    assert len({s.uid for s in segs}) == len(SIZES)


@pytest.mark.parametrize("opt", ["", COMPACT], ids=["planned", "compact"])
@pytest.mark.parametrize("qid,sql", SSB_SQL, ids=[q for q, _ in SSB_SQL])
def test_ssb_matches_jax_broker(table, qid, sql, opt):
    jb, _dm, query = table
    got = query(sql + opt)
    want = jb.query(sql + (opt[:-1] + ",timeoutMs=600000)" if opt
                           else bench.OPTION))
    assert got.columns == want.columns
    assert got.rows == want.rows
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.num_segments_pruned == want.num_segments_pruned


@pytest.mark.parametrize("name,sql,kind", ssb.SURFACE,
                         ids=[s[0] for s in ssb.SURFACE])
def test_surface_matches_jax_broker(table, name, sql, kind):
    jb, dm, query = table
    ctx = t_ctx(t_parse(sql))
    assert {serving.plan_segments(ctx, dm.acquire_segments()).plans[i].kind
            for i in range(len(SIZES))} == {kind}
    got = query(sql)
    want = jb.query(sql + bench.OPTION)
    assert got.columns == want.columns
    assert _close(got.rows, want.rows), (got.rows, want.rows)
    assert got.num_docs_scanned == want.num_docs_scanned


def _routes(dm, sql):
    ex = serving.execute_segments(t_ctx(t_parse(sql)), dm.acquire_segments())
    by_bucket = {}
    for p, r in zip(ex.plans, ex.routes):
        by_bucket.setdefault(p.segment.bucket, set()).add(r)
    return by_bucket


def test_routes(table, monkeypatch):
    _jb, dm, _q = table
    sqls = dict(SSB_SQL)
    shared, alone = 1024, 4096     # three segments share one bucket
    transfers = []
    real = batch.to_host
    monkeypatch.setattr(batch, "to_host",
                        lambda out: transfers.append(1) or real(out))
    # each group's outputs come to the host in one transfer
    assert _routes(dm, sqls["q2.1"]) == {shared: {batch.SEGMENTED},
                                         alone: {batch.PER_SEGMENT}}
    assert len(transfers) == 1
    assert _routes(dm, sqls["q1.1"]) == {shared: {batch.BATCHED},
                                         alone: {batch.PER_SEGMENT}}
    assert len(transfers) == 2
    # three segments of the 1.75M-group q4.3 exceed COMPACT_GROUP_LIMIT
    assert _routes(dm, sqls["q4.3"] + COMPACT) == {
        shared: {batch.PER_SEGMENT}, alone: {batch.PER_SEGMENT}}
    assert _routes(dm, dict((s[0], s[1]) for s in ssb.SURFACE)["host"]) \
        == {shared: {"host"}, alone: {"host"}}


def _assert_partials_equal(jp, tp):
    if isinstance(jp, jexec.GroupByPartial):
        assert isinstance(tp, texec.GroupByPartial)
        assert set(jp.groups) == set(tp.groups)
        for k, states in jp.groups.items():
            assert _close(list(states), list(tp.groups[k])), k
    else:
        assert _close(list(jp.states), list(tp.states))


@pytest.fixture(scope="module")
def offset_table(tmp_path_factory):
    """Three segments whose dictionaries of the summed column ``v`` hold
    the same number of different values: only a right per-segment
    dictionary offset gives the right sums."""
    from pinot_tpu_torch.segment import SegmentBuilder
    from pinot_tpu_torch.spi import DataType, FieldSpec, Schema
    out = str(tmp_path_factory.mktemp("offsets"))
    schema = Schema("t", [FieldSpec("k", DataType.STRING),
                          FieldSpec("f", DataType.INT),
                          FieldSpec("v", DataType.INT)])
    rng = np.random.default_rng(8)
    for s in range(3):
        n = 600 + 100 * s
        SegmentBuilder(schema).build({
            "k": rng.choice(["a", "b", "c", "d"], n),
            "f": rng.integers(0, 40, n).astype(np.int32),
            # values 8+2s .. 10+2s: one value range bound for every segment
            "v": (rng.integers(0, 3, n) + 8 + 2 * s).astype(np.int32)},
            out, f"s{s}")
    jdm = JaxTable("t")
    jdm.add_table_dir(out)
    dm = TableDataManager("t", device="cpu")
    dm.add_table_dir(out)
    return jdm, dm


SEGMENTED_CASES = [(q, dict(SSB_SQL)[q]) for q in ("q2.1", "q3.1", "q3.2",
                                                   "q4.2")] + [
    ("per_segment_ids", "SELECT d_year, s_region, SUM(lo_revenue), "
     "MAX(lo_supplycost) FROM lineorder WHERE lo_quantity BETWEEN 20 AND "
     "30 GROUP BY d_year, s_region"),
    ("dict_offsets", "SELECT k, SUM(v), MIN(v) FROM t WHERE f < 30 "
     "GROUP BY k")]


@pytest.mark.parametrize("case,sql", SEGMENTED_CASES,
                         ids=[c for c, _ in SEGMENTED_CASES])
def test_segmented_partials_match_jax(table, offset_table, case, sql):
    """Per-segment partials of one segmented compaction (K11) against the
    JAX package's own per-segment execution of the same plans, and
    against its segmented kernel (jitted_segmented_compact). The JAX
    segmented kernel flattens only one of the two dictionary params that
    SUM(v), MIN(v) bind for one column and reads the other out of range,
    so for ``dict_offsets`` the port is held to the per-segment partials
    alone (ROADMAP Queue 3)."""
    sql += COMPACT
    if case == "dict_offsets":
        jdm, dm = offset_table
    else:
        jdm, dm = table[0].table("lineorder"), table[1]
    bucket = 1024
    tsegs = sorted((s for s in dm.acquire_segments() if s.bucket == bucket),
                   key=lambda s: s.name)
    jsegs = sorted((s for s in jdm.acquire_segments()
                    if s.bucket == bucket), key=lambda s: s.name)
    assert len(tsegs) == 3
    jplans = [JPlanner(j_ctx(j_parse(sql)), s).plan() for s in jsegs]
    tplans = [serving.plan_segments(t_ctx(t_parse(sql)), [s]).plans[0]
              for s in tsegs]
    assert all(p.kernel_plan == tplans[0].kernel_plan for p in tplans)
    idxs = list(range(len(jplans)))
    tres = [None] * len(idxs)
    batch._run_segmented_compact(
        tplans, idxs, tplans[0].kernel_plan, bucket,
        {i: texec.resolve_params(p) for i, p in enumerate(tplans)}, tres)
    for jp, tp in zip([jexec.execute_plan(p) for p in jplans], tres):
        _assert_partials_equal(jp, tp)
    if case == "dict_offsets":
        return
    jparams = [jexec.resolve_params(p) for p in jplans]
    jres = [None] * len(idxs)
    jbatch._run_segmented_compact(
        jplans, idxs, jplans[0].kernel_plan, bucket,
        jbatch._stacked_cols(jplans, bucket),
        jnp.asarray([p.segment.n_docs for p in jplans], dtype=jnp.int32),
        tuple(jnp.stack([jp[j] for jp in jparams])
              for j in range(len(jparams[0]))), jres)
    for jp, tp in zip(jres, tres):
        _assert_partials_equal(jp, tp)


def test_segmented_chunks_under_the_row_limit(table, monkeypatch):
    """A group whose S*bucket rows pass the compaction kernel's limit runs
    as several calls of whole segments that fit, with the same rows."""
    from pinot_tpu_torch.engine.reduce import reduce_partials
    _jb, dm, _q = table
    ctx = t_ctx(t_parse(dict(SSB_SQL)["q3.1"] + COMPACT))
    segs = [s for s in dm.acquire_segments() if s.bucket == 1024]
    want = reduce_partials(ctx, serving.execute_segments(ctx, segs).partials)
    calls = []
    real = compact.compact

    def counted(mask, cols, slots_cap):
        calls.append(mask.shape[0])
        return real(mask, cols, slots_cap)

    monkeypatch.setattr(compact, "compact", counted)
    monkeypatch.setattr(compact, "MAX_ROWS", 2 * 1024 + 7)
    ex = serving.execute_segments(ctx, segs)
    assert reduce_partials(ctx, ex.partials).rows == want.rows
    # the three segments: a call of two, then a call of one
    assert calls == [2 * 1024, 1024]
    assert ex.routes == [batch.SEGMENTED] * 3


def test_evict_device_drops_stacks(table):
    _jb, dm, query = table
    query(dict(SSB_SQL)["q2.1"])
    seg = next(s for s in dm.acquire_segments() if s.bucket == 1024)
    holds = [k for k in batch._STACK_CACHE
             if seg.uid in [u for u, _n in k[0]]]
    assert holds
    seg.evict_device()
    assert not [k for k in batch._STACK_CACHE
                if seg.name in [n for _u, n in k[0]]]
    assert seg.resident_devices() == {}


def test_to_host_packs_every_dtype():
    """One packed transfer gives back each output with its dtype, shape
    and bytes, whatever the order of 1-, 4- and 8-byte outputs."""
    import torch
    g = torch.Generator().manual_seed(3)
    out = {"flag": torch.tensor([True, False, True]),
           "matched": torch.tensor(7, dtype=torch.int64),
           "ids": torch.randint(-9, 9, (5,), dtype=torch.int32, generator=g),
           "present": torch.rand(3, 4, generator=g) > 0.5,
           "sums": torch.randn(6, dtype=torch.float64, generator=g),
           "empty": torch.zeros(0, dtype=torch.int64)}
    host = texec.to_host(out)
    assert list(host) == list(out)
    for k, v in out.items():
        assert host[k].dtype == v.numpy().dtype and host[k].shape == v.shape
        np.testing.assert_array_equal(host[k], v.numpy())
