"""The port's over-budget pipeline (K13) on the CPU, mirroring
``tests/test_pipeline.py``.

With ``PINOT_HBM_BUDGET_BYTES=1`` every dense group of a five-segment
table takes the ``pipelined`` route: its rows equal the port's batched run
and the JAX ``Broker``'s, and ``STATS`` counts every segment. A large
budget keeps the batched route; ``group_stack_bytes`` equals the JAX
function's on the same segments; a segment whose live groups spill the
transfer cap reruns without filling the segment's device cache; and every
SSB query over the tier tests' table gives the JAX rows when pipelined.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402
from pinot_tpu.broker import Broker as JaxBroker  # noqa: E402
from pinot_tpu.engine import pipeline as jpipeline  # noqa: E402
from pinot_tpu.query.context import build_query_context as j_ctx  # noqa
from pinot_tpu.query.planner import SegmentPlanner as JPlanner  # noqa
from pinot_tpu.query.sql import parse_sql as j_parse  # noqa: E402
from pinot_tpu.server import TableDataManager as JaxTable  # noqa: E402
from pinot_tpu_torch.broker import Broker, connect  # noqa: E402
from pinot_tpu_torch.engine import batch, pipeline, serving  # noqa: E402
from pinot_tpu_torch.ops import kernels  # noqa: E402
from pinot_tpu_torch.query.context import build_query_context  # noqa
from pinot_tpu_torch.query.sql import parse_sql  # noqa: E402
from pinot_tpu_torch.segment import SegmentBuilder  # noqa: E402
from pinot_tpu_torch.server import TableDataManager  # noqa: E402
from pinot_tpu_torch.spi import (DataType, FieldSpec,  # noqa: E402
                                 FieldType, Schema, TableConfig)
from pinot_tpu_torch.tools import ssb  # noqa: E402
from test_torch_tier import SIZES, SSB_SQL, reset_port_memory  # noqa: E402

N_SEG = 5
ROWS = 4000
SQL = ("SELECT k, COUNT(*), SUM(v), MIN(v) FROM s WHERE v >= 100 "
       "GROUP BY k ORDER BY k")
DENSE = " OPTION(groupByStrategy=dense)"


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """Five segments of (k INT, v LONG): the port's and the JAX package's
    brokers over the same directories."""
    rng = np.random.default_rng(13)
    schema = Schema("s", [
        FieldSpec("k", DataType.INT, FieldType.DIMENSION),
        FieldSpec("v", DataType.LONG, FieldType.METRIC)])
    out = tmp_path_factory.mktemp("pipe")
    dirs = [SegmentBuilder(schema, TableConfig("s")).build(
        {"k": rng.integers(0, 7, ROWS).astype(np.int32),
         "v": rng.integers(0, 1000, ROWS).astype(np.int64)},
        str(out), f"seg_{i}") for i in range(N_SEG)]
    dm = TableDataManager("s", device="cpu")
    jdm = JaxTable("s")
    for d in dirs:
        dm.add_segment_dir(d)
        jdm.add_segment_dir(d)
    b = Broker(device="cpu")
    b.register_table(dm)
    jb = JaxBroker()
    jb.register_table(jdm)
    return dm, connect(b), jb, jdm


@pytest.fixture(autouse=True)
def _fresh_memory(request):
    segs = []
    if "table" in request.fixturenames:
        segs = request.getfixturevalue("table")[0].acquire_segments()
    reset_port_memory(segs)
    yield
    reset_port_memory(segs)


def _routes(dm, sql):
    ex = serving.execute_segments(build_query_context(parse_sql(sql)),
                                  dm.acquire_segments())
    return set(ex.routes)


def test_pipelined_matches_batched_and_jax(table, monkeypatch):
    dm, query, jb, _jdm = table
    want = query(SQL + DENSE).rows
    assert len(want) == 7
    assert _routes(dm, SQL + DENSE) == {batch.BATCHED}
    assert want == jb.query(SQL + " OPTION(groupByStrategy=dense,"
                            "timeoutMs=600000)").rows
    before = dict(pipeline.STATS)
    monkeypatch.setenv("PINOT_HBM_BUDGET_BYTES", "1")
    for s in dm.acquire_segments():
        s.evict_device()
    assert query(SQL + DENSE).rows == want
    assert pipeline.STATS["pipelined_groups"] == \
        before["pipelined_groups"] + 1
    assert pipeline.STATS["pipelined_segments"] == \
        before["pipelined_segments"] + N_SEG
    assert _routes(dm, SQL + DENSE) == {batch.PIPELINED}
    # the streamed columns never enter the segments' device cache
    assert not any(k[0] in ("k", "v") for s in dm.acquire_segments()
                   for k in s._device)
    assert pipeline.LAST_RUN["fill_s"] > 0


def test_large_budget_keeps_batched_route(table, monkeypatch):
    dm, query, _jb, _jdm = table
    monkeypatch.setenv("PINOT_HBM_BUDGET_BYTES", str(64 << 30))
    before = pipeline.STATS["pipelined_groups"]
    query(SQL + DENSE)
    assert pipeline.STATS["pipelined_groups"] == before
    assert _routes(dm, SQL + DENSE) == {batch.BATCHED}
    monkeypatch.delenv("PINOT_HBM_BUDGET_BYTES")
    # unset: the CPU default, 8 GiB, as the JAX package's
    assert pipeline.hbm_budget_bytes() == jpipeline.hbm_budget_bytes()


def test_group_stack_bytes_matches_jax(table):
    dm, _query, _jb, jdm = table
    segs = dm.acquire_segments()
    sql = SQL + DENSE
    plans = serving.plan_segments(build_query_context(parse_sql(sql)),
                                  segs).plans
    jctx = j_ctx(j_parse(sql))
    jplans = [JPlanner(jctx, s).plan() for s in jdm.acquire_segments()]
    bucket = segs[0].bucket
    assert pipeline.group_stack_bytes(plans, bucket) == \
        jpipeline.group_stack_bytes(jplans, bucket) == \
        N_SEG * bucket * (4 + 8)


def test_group_overflow_reruns_outside_the_device_cache(table, monkeypatch):
    dm, query, _jb, _jdm = table
    want = query(SQL + DENSE).rows
    for s in dm.acquire_segments():
        s.evict_device()
    # a transfer cap of 2 rows: 7 live groups spill it in every segment
    monkeypatch.setattr(kernels, "GROUP_XFER_SPACE", 4)
    monkeypatch.setattr(kernels, "GROUP_XFER_CAP", 2)
    monkeypatch.setenv("PINOT_HBM_BUDGET_BYTES", "1")
    staged = []
    stage = pipeline._staged_cols
    monkeypatch.setattr(pipeline, "_staged_cols",
                        lambda plan, bucket: staged.append(plan.segment)
                        or stage(plan, bucket))
    assert query(SQL + DENSE).rows == want
    # on the CPU every segment is staged once to stream, once to rerun
    assert len(staged) == 2 * N_SEG
    assert _routes(dm, SQL + DENSE) == {batch.PIPELINED}
    assert not any(k[0] in ("k", "v") for s in dm.acquire_segments()
                   for k in s._device)


@pytest.fixture(scope="module")
def ssb_table(tmp_path_factory):
    d = ssb.build_table_dir(SIZES, str(tmp_path_factory.mktemp("ssbp")))
    os.environ["PINOT_CPU_FAST_GROUPBY"] = "1"
    try:
        jdm = JaxTable("lineorder")
        jdm.add_table_dir(d)
        jb = JaxBroker()
        jb.register_table(jdm)
        want = {qid: jb.query(sql + bench.OPTION).rows
                for qid, sql in SSB_SQL}
    finally:
        os.environ["PINOT_CPU_FAST_GROUPBY"] = "0"
    dm = TableDataManager("lineorder", device="cpu")
    dm.add_table_dir(d)
    b = Broker(device="cpu")
    b.register_table(dm)
    return dm, connect(b), want


@pytest.mark.parametrize("qid,sql", SSB_SQL, ids=[q for q, _ in SSB_SQL])
def test_ssb_pipelined_rows_equal_jax(ssb_table, qid, sql, monkeypatch):
    dm, query, want = ssb_table
    monkeypatch.setenv("PINOT_HBM_BUDGET_BYTES", "1")
    assert query(sql).rows == want[qid]
    if qid.startswith("q1"):          # the scalar sums: dense groups
        assert _routes(dm, sql) == {batch.PIPELINED}
