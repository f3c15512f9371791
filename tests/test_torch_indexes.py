"""The port's secondary indexes against the JAX package, on the CPU.

The events table of ``tests/test_indexes.py`` (inverted on a dictionary
string column, range on a raw int, bloom on a raw long, text, json and a
cosine vector index) is built by both packages' builders: every index
file must be byte-equal. Served by ``Broker(device="cpu")`` and the JAX
broker, TEXT_MATCH, JSON_MATCH, VECTOR_SIMILARITY, inverted, range and
bloom queries plan the same kind and give equal rows; a reload adds and
removes the same index files on a copy of the segment through either
package; the geo kind is not ported and says so.
"""
import json
import os
import shutil

import numpy as np
import pytest

from pinot_tpu.broker import Broker as JaxBroker
from pinot_tpu.query.context import build_query_context as j_ctx
from pinot_tpu.query.planner import SegmentPlanner as JPlanner
from pinot_tpu.query.sql import parse_sql as j_parse
from pinot_tpu.segment import SegmentBuilder as JaxBuilder
from pinot_tpu.segment.loader import reconcile_indexes as j_reconcile
from pinot_tpu.server import TableDataManager as JaxTable
from pinot_tpu.spi import Schema as JaxSchema, TableConfig as JaxConfig
from pinot_tpu_torch.broker import Broker, connect
from pinot_tpu_torch.index import build_indexes_for_column
from pinot_tpu_torch.index.registry import FILE_STEMS
from pinot_tpu_torch.query.context import build_query_context as t_ctx
from pinot_tpu_torch.query.planner import SegmentPlanner
from pinot_tpu_torch.query.sql import parse_sql as t_parse
from pinot_tpu_torch.segment import SegmentBuilder
from pinot_tpu_torch.segment.loader import reconcile_indexes
from pinot_tpu_torch.server import TableDataManager
from pinot_tpu_torch.spi import (DataType, FieldSpec, FieldType,
                                 IndexingConfig, Schema, TableConfig)

from test_torch_tier import reset_port_memory

N = 3000
CITIES = ["amsterdam", "berlin", "chicago", "denver"]
WORDS = ["fast", "slow", "columnar", "realtime", "olap", "tpu", "query"]
DIM = 8


def _data():
    """tests/test_indexes.py's draws."""
    rng = np.random.default_rng(11)
    texts = [" ".join(rng.choice(WORDS, 3, replace=False)) for _ in range(N)]
    jsons = [json.dumps({
        "name": str(rng.choice(CITIES)),
        "meta": {"tier": int(rng.integers(0, 3))},
        "tags": [str(t) for t in rng.choice(WORDS, 2, replace=False)],
    }) for _ in range(N)]
    vecs = rng.normal(0, 1, (N, DIM)).astype(np.float32)
    return {
        "city": rng.choice(CITIES, N),
        "value": rng.integers(0, 1000, N).astype(np.int64),
        "doc": np.asarray(texts, dtype=object),
        "payload": np.asarray(jsons, dtype=object),
        "emb": vecs,
        "views": rng.integers(0, 10000, N).astype(np.int32),
    }


SCHEMA = Schema("events", [
    FieldSpec("city", DataType.STRING, FieldType.DIMENSION),
    FieldSpec("value", DataType.LONG, FieldType.METRIC),
    FieldSpec("doc", DataType.STRING, FieldType.DIMENSION),
    FieldSpec("payload", DataType.JSON, FieldType.DIMENSION),
    FieldSpec("emb", DataType.FLOAT, FieldType.DIMENSION),
    FieldSpec("views", DataType.INT, FieldType.METRIC),
])
CONFIG = TableConfig("events", indexing=IndexingConfig(
    inverted_index_columns=["city"],
    range_index_columns=["views"],
    bloom_filter_columns=["value"],
    text_index_columns=["doc"],
    json_index_columns=["payload"],
    vector_index_columns={"emb": {"metric": "cosine"}},
    no_dictionary_columns=["value"],
))


def _jax(obj, cls):
    return cls.from_dict(obj.to_dict())


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    out = tmp_path_factory.mktemp("events")
    data = _data()
    tdir = SegmentBuilder(SCHEMA, CONFIG).build(data, str(out / "t"), "seg_0")
    jdir = JaxBuilder(_jax(SCHEMA, JaxSchema), _jax(CONFIG, JaxConfig)).build(
        data, str(out / "j"), "seg_0")
    dm = TableDataManager("events", device="cpu")
    seg = dm.add_segment_dir(tdir)
    tb = Broker(device="cpu")
    tb.register_table(dm)
    jdm = JaxTable("events")
    jseg = jdm.add_segment_dir(jdir)
    jb = JaxBroker()
    jb.register_table(jdm)
    yield {"data": data, "tdir": tdir, "jdir": jdir, "tb": tb, "jb": jb,
           "seg": seg, "jseg": jseg, "out": out}
    reset_port_memory([seg])


def _files(d):
    return sorted(f for f in os.listdir(d) if f != "metadata.json")


def test_index_files_byte_equal(built):
    td, jd = built["tdir"], built["jdir"]
    assert _files(td) == _files(jd)
    stems = [s for kind in ("inverted", "range", "bloom", "text", "json",
                            "vector") for s in FILE_STEMS[kind]]
    index_files = [f for f in _files(td) if any(s in f for s in stems)]
    assert len(index_files) >= 12
    for f in _files(td):
        with open(os.path.join(td, f), "rb") as a, \
                open(os.path.join(jd, f), "rb") as b:
            assert a.read() == b.read(), f
    tm, jm = (json.load(open(os.path.join(d, "metadata.json")))
              for d in (td, jd))
    assert tm["columns"] == jm["columns"]


QUERIES = [
    "SELECT COUNT(*) FROM events WHERE TEXT_MATCH(doc, 'tpu')",
    "SELECT COUNT(*) FROM events WHERE TEXT_MATCH(doc, 'tpu AND olap')",
    "SELECT COUNT(*) FROM events WHERE TEXT_MATCH(doc, 'col* OR NOT fast')",
    "SELECT COUNT(*) FROM events WHERE TEXT_MATCH(doc, '\"olap tpu\"')",
    "SELECT COUNT(*) FROM events WHERE TEXT_MATCH(doc, 'fa[*')",
    "SELECT city, SUM(views) FROM events WHERE TEXT_MATCH(doc, 'realtime') "
    "GROUP BY city ORDER BY city",
    "SELECT COUNT(*) FROM events WHERE "
    "JSON_MATCH(payload, '\"$.name\" = ''berlin''')",
    "SELECT COUNT(*) FROM events WHERE "
    "JSON_MATCH(payload, '\"$.tags[*]\" = ''tpu''')",
    "SELECT COUNT(*) FROM events WHERE JSON_MATCH(payload, "
    "'\"$.name\" = ''berlin'' AND \"$.meta.tier\" = ''0''')",
    "SELECT city, COUNT(*) FROM events WHERE city = 'berlin' GROUP BY city",
    "SELECT city, views FROM events WHERE city != 'denver' "
    "ORDER BY views DESC LIMIT 7",
    "SELECT views FROM events WHERE views >= 9990 ORDER BY views LIMIT 100",
    "SELECT views, city FROM events WHERE views = 9999 LIMIT 100",
    "SELECT COUNT(*) FROM events WHERE value = 999983",
    "SELECT COUNT(*), SUM(views) FROM events WHERE value = 17",
]


@pytest.mark.parametrize("sql", QUERIES, ids=range(len(QUERIES)))
def test_rows_and_plan_kind_match_jax(built, sql):
    jkind = JPlanner(j_ctx(j_parse(sql)), built["jseg"]).plan().kind
    tkind = SegmentPlanner(t_ctx(t_parse(sql)), built["seg"]).plan().kind
    assert tkind == jkind
    assert [tuple(r) for r in connect(built["tb"])(sql).rows] == \
        [tuple(r) for r in built["jb"].query(sql).rows]


def test_vector_predicate_rows_match_jax(built):
    arr = ", ".join(f"{x:.6f}" for x in built["data"]["emb"][17])
    for sql in (f"SELECT COUNT(*) FROM events WHERE "
                f"VECTOR_SIMILARITY(emb, ARRAY[{arr}], 5)",
                f"SELECT SUM(views) FROM events WHERE "
                f"VECTOR_SIMILARITY(emb, ARRAY[{arr}], 7)"):
        assert connect(built["tb"])(sql).rows == built["jb"].query(sql).rows


def test_bloom_prunes_like_jax(built):
    sql = "SELECT COUNT(*) FROM events WHERE value = 999983"
    assert SegmentPlanner(t_ctx(t_parse(sql)),
                          built["seg"]).plan().kind == "pruned"
    reader = built["seg"].index_reader("value", "bloom")
    jreader = built["jseg"].index_reader("value", "bloom")
    for v in range(0, 2000, 7):
        assert reader.might_contain(v) == jreader.might_contain(v)


def test_missing_index_errors_match_jax(built):
    from pinot_tpu.query.sql import SqlError as JaxSqlError
    from pinot_tpu_torch.query.sql import SqlError
    for sql in ("SELECT COUNT(*) FROM events WHERE TEXT_MATCH(city, 'x')",
                "SELECT COUNT(*) FROM events WHERE "
                "JSON_MATCH(doc, '\"$.a\" = ''1''')"):
        with pytest.raises(SqlError) as got:
            connect(built["tb"])(sql)
        with pytest.raises(JaxSqlError) as want:
            built["jb"].query(sql)
        assert str(got.value) == str(want.value)


def test_reload_adds_and_removes_same_files(built):
    """Drop the inverted and text indexes and add a range index on a
    copy of the segment through each package: same delta, same files."""
    out = built["out"]
    td, jd = str(out / "reload_t"), str(out / "reload_j")
    shutil.copytree(built["tdir"], td)
    shutil.copytree(built["tdir"], jd)
    cfg = TableConfig("events", indexing=IndexingConfig(
        range_index_columns=["views", "value"],
        bloom_filter_columns=["value"],
        json_index_columns=["payload"],
        vector_index_columns={"emb": {"metric": "cosine"}},
        no_dictionary_columns=["value"]))
    got = reconcile_indexes(td, cfg)
    want = j_reconcile(jd, _jax(cfg, JaxConfig))
    assert got == want and got["added"] and got["removed"]
    assert _files(td) == _files(jd)
    for f in _files(td):
        with open(os.path.join(td, f), "rb") as a, \
                open(os.path.join(jd, f), "rb") as b:
            assert a.read() == b.read(), f
    assert reconcile_indexes(td, cfg) == {"added": [], "removed": []}


def test_data_manager_reload_swaps_segments(built):
    out = built["out"]
    d = str(out / "reload_dm")
    shutil.copytree(built["tdir"], d)
    dm = TableDataManager("events", device="cpu", table_config=CONFIG)
    old = dm.add_segment_dir(d)
    b = Broker(device="cpu")
    b.register_table(dm)
    sql = "SELECT COUNT(*) FROM events WHERE TEXT_MATCH(doc, 'tpu')"
    before = connect(b)(sql).rows
    cfg = TableConfig("events", indexing=IndexingConfig(
        inverted_index_columns=["city"], text_index_columns=["doc"],
        range_index_columns=["views", "value"],
        no_dictionary_columns=["value"],
        vector_index_columns={"emb": {"metric": "cosine"}}))
    changes = dm.reload(cfg)
    assert changes == {"added": ["value:range"],
                       "removed": ["value:bloom", "payload:json"]}
    assert dm.acquire_segments()[0] is not old
    assert connect(b)(sql).rows == before
    reset_port_memory([old, *dm.acquire_segments()])


def test_geo_index_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="geo index"):
        build_indexes_for_column(
            "g", ["geo"], str(tmp_path), values=np.asarray(["POINT (1 2)"]),
            ids=None, cardinality=1)
