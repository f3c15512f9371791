"""Star-tree rollups: the port against the JAX package.

Both packages build the same SSB segment (numpy-seeded rows; two
segments for the table tests) and the same rollups on it, in the form
of Pinot's StarTreeIndexConfig (dimensionsSplitOrder + functionColumn
Pairs). The rollup files and the parent's metadata must be byte-equal
(timestamps aside); ``try_rollup_execute`` must answer exactly where the
reference answers (a case table of filters, group-bys and aggregations,
and a segment with ``valid_docs``), with equal partial states; queries
through the broker must return the JAX broker's rows (``AVG`` through
``__count``); EXPLAIN shows ``STARTREE_ROLLUP`` for the segments a
rollup answers; and both halves of a hybrid table answer from their
rollups.
"""
import json
import os
import shutil

import numpy as np
import pytest

from pinot_tpu.broker import Broker as JaxBroker
from pinot_tpu.engine.executor import AggPartial as JAgg
from pinot_tpu.query.context import build_query_context as j_ctx
from pinot_tpu.query.explain import explain_rows as j_explain_rows
from pinot_tpu.query.sql import parse_sql as j_parse
from pinot_tpu.segment import ImmutableSegment as JaxSegment
from pinot_tpu.server import TableDataManager as JaxTable
from pinot_tpu.spi import TableConfig as JaxConfig
from pinot_tpu.startree import RollupConfig as JRollupConfig
from pinot_tpu.startree import build_rollup as j_build_rollup
from pinot_tpu.startree import try_rollup_execute as j_try
from pinot_tpu_torch.broker import Broker, connect
from pinot_tpu_torch.engine import serving
from pinot_tpu_torch.engine.executor import AggPartial
from pinot_tpu_torch.engine.tier import reconcile_devmem
from pinot_tpu_torch.query.context import build_query_context as t_ctx
from pinot_tpu_torch.query.sql import parse_sql as t_parse
from pinot_tpu_torch.segment import load_segment
from pinot_tpu_torch.server import TableDataManager
from pinot_tpu_torch.spi import TableConfig
from pinot_tpu_torch.startree import (ROLLUP_META_KEY, RollupConfig,
                                      build_rollup, try_rollup_execute)
from pinot_tpu_torch.tools import ssb

from test_torch_tier import reset_port_memory

ROLLUPS = [
    (["d_year", "p_category", "p_brand1", "s_region"],
     [("sum", "lo_revenue"), ("min", "lo_revenue"),
      ("max", "lo_supplycost")]),
    (["d_year", "c_region", "s_region", "c_nation", "s_nation"],
     [("sum", "lo_revenue")]),
]
REL = 1e-9

# filters, group-bys and aggregations a rollup may or may not serve;
# whether it does is the reference's answer, checked per case below
CASES = [
    "SELECT SUM(lo_revenue) FROM lineorder",
    "SELECT COUNT(*) FROM lineorder WHERE d_year = 1993",
    "SELECT d_year, SUM(lo_revenue) FROM lineorder "
    "WHERE p_category = 'MFGR#12' AND s_region = 'AMERICA' GROUP BY d_year",
    "SELECT d_year, p_brand1, SUM(lo_revenue), COUNT(*) FROM lineorder "
    "WHERE p_brand1 BETWEEN 'MFGR#2221' AND 'MFGR#2228' "
    "GROUP BY d_year, p_brand1",
    "SELECT d_year, AVG(lo_revenue) FROM lineorder GROUP BY d_year",
    "SELECT MIN(lo_revenue), MAX(lo_supplycost) FROM lineorder "
    "WHERE s_region IN ('ASIA', 'EUROPE')",
    "SELECT MAX(lo_revenue) FROM lineorder",                # unmapped agg
    "SELECT SUM(lo_extendedprice) FROM lineorder",          # unmapped agg
    "SELECT SUM(lo_revenue) FROM lineorder WHERE lo_quantity < 25",
    "SELECT SUM(lo_revenue) FROM lineorder WHERE p_brand1 LIKE 'MFGR#22%'",
    "SELECT SUM(lo_revenue) FROM lineorder "
    "WHERE NOT (d_year = 1993 OR s_region = 'ASIA')",
    "SELECT SUM(lo_revenue) FROM lineorder WHERE d_year IS NOT NULL",
    "SELECT SUM(lo_revenue) FROM lineorder WHERE d_year + 1 = 1994",
    "SELECT SUM(lo_revenue - lo_supplycost) FROM lineorder",  # expression
    "SELECT d_year + 1, SUM(lo_revenue) FROM lineorder GROUP BY d_year + 1",
    "SELECT lo_quantity, SUM(lo_revenue) FROM lineorder "
    "GROUP BY lo_quantity",                                 # non-dim group
    "SELECT c_nation, s_nation, SUM(lo_revenue) FROM lineorder "
    "WHERE c_region = 'ASIA' AND s_region = 'ASIA' "
    "GROUP BY c_nation, s_nation",                          # 2nd rollup
    "SELECT DISTINCTCOUNT(p_brand1) FROM lineorder",
    "SELECT d_year, lo_revenue FROM lineorder LIMIT 5",     # selection
]


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        p = os.path.join(d, name)
        if os.path.isdir(p):
            out[name] = _files(p)
            continue
        with open(p, "rb") as fh:
            data = fh.read()
        if name == "metadata.json":
            data = json.loads(data)
            data.pop("creationTimeMs", None)
        out[name] = data
    return out


def _with_rollups(seg_dir, build, cfg_cls, load):
    seg = load(seg_dir)
    for i, (dims, metrics) in enumerate(ROLLUPS):
        build(seg, cfg_cls(list(dims), list(metrics)), i)
    return seg_dir


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A plain SSB segment copied twice: rollups built by the port on
    one, by the JAX package on the other; plus 2-segment tables."""
    out = tmp_path_factory.mktemp("star")
    base = ssb.build_segment_dir(4000, str(out / "plain"))
    port, jax_dir = str(out / "port" / "seg_0"), str(out / "jax" / "seg_0")
    shutil.copytree(base, port)
    shutil.copytree(base, jax_dir)
    _with_rollups(port, build_rollup, RollupConfig,
                  lambda d: load_segment(d, "cpu"))
    _with_rollups(jax_dir, j_build_rollup, JRollupConfig, JaxSegment.load)
    tables = {}
    for side in ("port", "jax"):
        t = ssb.build_table_dir([2500, 1500], str(out / f"table_{side}"))
        for name in sorted(os.listdir(t)):
            d = os.path.join(t, name)
            if side == "port":
                _with_rollups(d, build_rollup, RollupConfig,
                              lambda x: load_segment(x, "cpu"))
            else:
                _with_rollups(d, j_build_rollup, JRollupConfig,
                              JaxSegment.load)
        tables[side] = t
    return {"base": base, "port": port, "jax": jax_dir, **{
        f"table_{k}": v for k, v in tables.items()}}


def test_rollup_files_byte_equal(dirs):
    assert _files(dirs["port"]) == _files(dirs["jax"])
    meta = json.load(open(os.path.join(dirs["port"], "metadata.json")))
    assert [e["name"] for e in meta[ROLLUP_META_KEY]] == \
        ["startree0", "startree1"]
    assert _files(dirs["table_port"]) == _files(dirs["table_jax"])


def _states_equal(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_states_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, (float, np.floating)) or \
            isinstance(b, (float, np.floating)):
        return abs(float(a) - float(b)) <= REL * max(abs(float(a)),
                                                     abs(float(b)), 1e-300)
    return a == b


@pytest.mark.parametrize("sql", CASES)
def test_rollup_answers_exactly_where_the_reference_does(dirs, sql):
    tseg = load_segment(dirs["port"], "cpu")
    jseg = JaxSegment.load(dirs["jax"])
    got = try_rollup_execute(t_ctx(t_parse(sql)), tseg)
    want = j_try(j_ctx(j_parse(sql)), jseg)
    assert (got is None) == (want is None), sql
    if want is None:
        return
    if isinstance(want, JAgg):
        assert isinstance(got, AggPartial)
        assert _states_equal(got.states, want.states), sql
    else:
        assert set(got.groups) == set(want.groups), sql
        for k, v in want.groups.items():
            assert _states_equal(got.groups[k], v), (sql, k)
    reset_port_memory([tseg])
    tseg.evict_device()


def test_valid_docs_refuse_the_rollup(dirs):
    sql = CASES[0]
    tseg = load_segment(dirs["port"], "cpu")
    jseg = JaxSegment.load(dirs["jax"])
    tseg.valid_docs = np.ones(tseg.n_docs, dtype=bool)
    jseg.valid_docs = np.ones(jseg.n_docs, dtype=bool)
    assert j_try(j_ctx(j_parse(sql)), jseg) is None
    assert try_rollup_execute(t_ctx(t_parse(sql)), tseg) is None


@pytest.fixture(scope="module")
def brokers(dirs):
    dm = TableDataManager("lineorder", device="cpu")
    dm.add_table_dir(dirs["table_port"])
    b = Broker(device="cpu")
    b.register_table(dm)
    jdm = JaxTable("lineorder")
    jdm.add_table_dir(dirs["table_jax"])
    jb = JaxBroker()
    jb.register_table(jdm)
    yield connect(b), jb, dm
    reset_port_memory(dm.acquire_segments())


def _close(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("sql", CASES[:6] + CASES[16:17])
def test_rows_equal_jax_broker(brokers, sql, monkeypatch):
    monkeypatch.setenv("PINOT_CPU_FAST_GROUPBY", "1")
    q, jb, dm = brokers
    calls = []
    real = serving.execute_on_rollup
    monkeypatch.setattr(serving, "execute_on_rollup",
                        lambda *a: calls.append(1) or real(*a))
    got, want = q(sql), jb.query(sql)
    assert got.columns == want.columns
    assert _close(sorted(got.rows, key=repr), sorted(want.rows, key=repr))
    assert len(calls) == 2      # one rollup answer per segment
    rec = reconcile_devmem(dm.acquire_segments())
    assert all(v["tracked"] == v["actual"] for v in rec.values()), rec


def test_explain_shows_the_rollup_segments(brokers):
    q, _jb, dm = brokers
    sql = CASES[2]
    rows = q("EXPLAIN PLAN FOR " + sql).rows
    # the reference's renderer with the count the port planned: every
    # segment answered by a rollup, none planned raw
    want = j_explain_rows(j_ctx(j_parse(sql)), [], 2)[1]
    assert rows == want
    assert ("STARTREE_ROLLUP(segments:2)", 2, 1) in rows
    # a query no rollup serves plans its segments as before
    raw = q("EXPLAIN PLAN FOR " + CASES[7]).rows
    assert not any(r[0].startswith("STARTREE") for r in raw)


def test_hybrid_halves_use_rollups(dirs, tmp_path, monkeypatch):
    monkeypatch.setenv("PINOT_CPU_FAST_GROUPBY", "1")
    b, jb = Broker(device="cpu"), JaxBroker()
    for side in ("OFFLINE", "REALTIME"):
        name = f"lineorder_{side}"
        dm = TableDataManager(name, device="cpu",
                              table_config=TableConfig(
                                  name, time_column="d_year"))
        dm.add_table_dir(dirs["table_port"])
        b.register_table(dm)
        jdm = JaxTable(name, table_config=JaxConfig(
            name, time_column="d_year"))
        jdm.add_table_dir(dirs["table_jax"])
        jb.register_table(jdm)
    calls = []
    real = serving.execute_on_rollup
    monkeypatch.setattr(serving, "execute_on_rollup",
                        lambda *a: calls.append(1) or real(*a))
    sql = ("SELECT d_year, SUM(lo_revenue), COUNT(*) FROM lineorder "
           "GROUP BY d_year")
    got, want = connect(b)(sql), jb.query(sql)
    assert _close(sorted(got.rows), sorted(want.rows))
    assert len(calls) == 4      # 2 segments x 2 halves
