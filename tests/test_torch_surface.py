"""Every single-stage plan kind through both brokers on one segment.

A segment with a string column, a dictionary int column, raw int and
float columns and nulls, and a copy of it with upsert validDocIds, are
served by the JAX ``Broker`` and ``Broker(device="cpu")``: fast, host,
kselect and device-sketch queries, with and without enableNullHandling.
Both planners must choose the same plan kind, and the rows must be equal
(integers exactly, floats to a relative 1e-9). Index predicates over a
column without the index raise the same SqlError in both packages.
"""
import os
import shutil

import numpy as np
import pytest

from pinot_tpu.broker import Broker as JaxBroker
from pinot_tpu.query.context import build_query_context as j_ctx
from pinot_tpu.query.planner import SegmentPlanner as JPlanner
from pinot_tpu.query.sql import parse_sql as j_parse
from pinot_tpu.segment import ImmutableSegment as JaxSegment
from pinot_tpu.server import TableDataManager as JaxTable
from pinot_tpu_torch.broker import Broker, connect
from pinot_tpu_torch.query.context import build_query_context as t_ctx
from pinot_tpu_torch.query.planner import SegmentPlanner as TPlanner
from pinot_tpu_torch.query.sql import parse_sql as t_parse
from pinot_tpu_torch.segment import SegmentBuilder
from pinot_tpu_torch.server import TableDataManager
from pinot_tpu_torch.spi import (DataType, FieldSpec, FieldType, Schema,
                                 TableConfig)
from pinot_tpu_torch.spi.config import IndexingConfig

N = 6000
REL = 1e-9
NULLS = " OPTION(enableNullHandling=true)"


@pytest.fixture(autouse=True)
def _jax_scatter_core(monkeypatch):
    monkeypatch.setenv("PINOT_CPU_FAST_GROUPBY", "1")


def _build(out, table):
    rng = np.random.default_rng(23)
    s = [f"u{i:04d}" for i in rng.integers(0, 900, N)]
    rawf = [float(x) for x in np.round(rng.normal(0, 1000, N), 3)]
    for i in range(0, N, 37):
        s[i] = None
        rawf[i + 5] = None
    schema = Schema(table, [
        FieldSpec("s", DataType.STRING, FieldType.DIMENSION),
        FieldSpec("k", DataType.INT, FieldType.DIMENSION),
        FieldSpec("raw", DataType.LONG, FieldType.METRIC),
        FieldSpec("rawf", DataType.DOUBLE, FieldType.METRIC),
        FieldSpec("sel", DataType.INT, FieldType.DIMENSION)])
    cfg = TableConfig(table, indexing=IndexingConfig(
        no_dictionary_columns=["raw", "rawf"]))
    return SegmentBuilder(schema, cfg).build({
        "s": s, "k": rng.integers(0, 400, N).astype(np.int32),
        "raw": rng.integers(-10**9, 10**9, N).astype(np.int64),
        "rawf": rawf, "sel": rng.integers(0, 100, N).astype(np.int32)},
        out, f"{table}_0")


@pytest.fixture(scope="module")
def brokers(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("surface"))
    t_dir = _build(out, "t")
    # upsert table: the same rows, a third of them superseded
    u_dir = os.path.join(out, "u_0")
    shutil.copytree(t_dir, u_dir)
    jseg = JaxSegment.load(u_dir)
    jseg.valid_docs = np.random.default_rng(4).random(N) < 0.66
    jseg.persist_valid_docs()
    jb, tb = JaxBroker(), Broker(device="cpu")
    for name, d in (("t", t_dir), ("u", u_dir)):
        jdm = JaxTable(name)
        jdm.add_segment_dir(d)
        jb.register_table(jdm)
        dm = TableDataManager(name, device="cpu")
        dm.add_segment_dir(d)
        tb.register_table(dm)
    return jb, tb


QUERIES = [
    ("SELECT COUNT(*) FROM t", "fast"),
    ("SELECT MIN(k), MAX(raw), DISTINCTCOUNT(k) FROM t", "fast"),
    ("SELECT s, k, raw FROM t WHERE sel < 30 ORDER BY raw DESC LIMIT 7",
     "kselect"),
    ("SELECT s, sel FROM t WHERE k > 100 LIMIT 5", "kselect"),
    ("SELECT k, sel FROM t ORDER BY sel, k DESC LIMIT 12", "kselect"),
    ("SELECT * FROM t WHERE sel = 3 LIMIT 4", "kselect"),
    ("SELECT s, raw FROM t WHERE s LIKE 'u01%' ORDER BY s LIMIT 6",
     "kselect"),
    ("SELECT raw + 1, s FROM t WHERE sel < 5 LIMIT 5", "host"),
    ("SELECT DISTINCTCOUNTHLL(s), DISTINCTCOUNTTHETASKETCH(raw), "
     "PERCENTILEKLL(rawf, 50), COUNT(*) FROM t WHERE sel < 80", "kernel"),
    ("SELECT DISTINCTCOUNTRAWHLL(k, 6), DISTINCTCOUNTHLL(rawf) FROM t",
     "kernel"),
    ("SELECT sel, DISTINCTCOUNTHLL(k, 8), COUNT(*) FROM t WHERE sel < 10 "
     "GROUP BY sel ORDER BY sel LIMIT 100", "kernel"),
    ("SELECT sel, DISTINCTCOUNTTHETASKETCH(s) FROM t WHERE sel < 3 "
     "GROUP BY sel ORDER BY sel LIMIT 10", "host"),
    ("SELECT UPPER(s), COUNT(*) FROM t GROUP BY UPPER(s) "
     "ORDER BY UPPER(s) LIMIT 20", "host"),
    ("SELECT COUNT(rawf), SUM(rawf), MIN(rawf) FROM t" + NULLS, "kernel"),
    ("SELECT s, COUNT(*) FROM t WHERE sel < 20 GROUP BY s "
     "ORDER BY s LIMIT 2000" + NULLS, "host"),
    ("SELECT COUNT(*) FROM t WHERE s IS NULL" + NULLS, "kernel"),
    ("SELECT rawf, s FROM t WHERE sel > 90 ORDER BY rawf LIMIT 8" + NULLS,
     "host"),
    ("SELECT COUNT(*) FROM u", "kernel"),
    ("SELECT s, raw FROM u WHERE sel < 50 ORDER BY raw DESC LIMIT 5",
     "kselect"),
    ("SELECT sel, COUNT(*), SUM(raw) FROM u GROUP BY sel ORDER BY sel "
     "LIMIT 100", "kernel"),
    ("SELECT UPPER(s), COUNT(*) FROM u GROUP BY UPPER(s) "
     "ORDER BY UPPER(s) LIMIT 20", "host"),
    ("SELECT COUNT(*) FROM u WHERE sel < 10 OPTION(skipUpsert=true)",
     "kernel"),
]


def _close(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("sql,kind", QUERIES, ids=range(len(QUERIES)))
def test_plan_kind_and_rows_match_jax(brokers, sql, kind):
    jb, tb = brokers
    table = "u" if " FROM u" in sql else "t"
    jseg = jb.table(table).acquire_segments()[0]
    tseg = tb.table(table).acquire_segments()[0]
    jkind = JPlanner(j_ctx(j_parse(sql)), jseg).plan().kind
    tkind = TPlanner(t_ctx(t_parse(sql)), tseg).plan().kind
    assert jkind == tkind == kind
    got, want = connect(tb)(sql), jb.query(sql)
    assert got.columns == want.columns
    assert _close(got.rows, want.rows), (got.rows, want.rows)
    assert got.num_docs_scanned == want.num_docs_scanned


@pytest.mark.parametrize("pred", ["TEXT_MATCH(s, 'u01')",
                                  "JSON_MATCH(s, '\"$.a\" = 1')"])
def test_index_predicates_are_not_ported(brokers, pred):
    """The index package is ported now: without the index on the column
    both brokers raise the same SqlError (a user error, no host
    fallback)."""
    from pinot_tpu.query.sql import SqlError as JaxSqlError
    from pinot_tpu_torch.query.sql import SqlError
    jb, tb = brokers
    sql = f"SELECT COUNT(*) FROM t WHERE {pred}"
    with pytest.raises(SqlError, match="index") as got:
        connect(tb)(sql)
    with pytest.raises(JaxSqlError) as want:
        jb.query(sql)
    assert str(got.value) == str(want.value)
