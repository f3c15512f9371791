"""The multi-stage engine: the JAX broker against Broker(device="cpu").

A small star schema (orders 4,096 rows in 2 segments, customers 300,
parts 40 with duplicate keys) is built once and loaded by both brokers.
The device thresholds are 0, so the device paths run in both packages:
the JAX package takes its mesh planes on the suite's 8 virtual devices,
the port its one-device planes (K16 ``device``, ``numpy_shuffle``, K19
``csr``/``sort``). Every plane's rows are byte-identical by design, so
rows are compared, not backend names: integers and strings exactly,
floats to a relative 1e-9 (``tools/fuzzer.digest``'s tolerance), and in
the same order. The port's own backends are asserted through its STATS.
"""
import numpy as np
import pytest

from pinot_tpu.broker import Broker as JaxBroker
from pinot_tpu.multistage.executor import MultiStageExecutor as JaxExec
from pinot_tpu.query.sql import parse_sql as j_parse
from pinot_tpu.server import TableDataManager as JaxTable
from pinot_tpu_torch.broker import Broker, connect
from pinot_tpu_torch.multistage import device_join, fused
from pinot_tpu_torch.multistage.executor import MultiStageExecutor
from pinot_tpu_torch.ops import join as ops_join
from pinot_tpu_torch.query.sql import SqlError, parse_sql
from pinot_tpu_torch.server import TableDataManager
from pinot_tpu_torch.spi import DataType, FieldSpec, FieldType
from pinot_tpu_torch.tools.star import build_tables

REL = 1e-9
THRESHOLDS = ("PINOT_DEVICE_JOIN_MIN_ROWS", "PINOT_DEVICE_WINDOW_MIN_ROWS",
              "PINOT_FUSED_MIN_ROWS")


def star_schema(out: str, n_orders: int = 4096, n_cust: int = 300,
                n_parts: int = 40, seed: int = 16):
    """{table: [segment dirs]} of the star schema (bench.py's multistage
    tables at a small size, plus a nullable key and duplicate part ids)."""
    rng = np.random.default_rng(seed)
    o_ref = [int(x) for x in rng.integers(0, n_cust, n_orders)]
    for i in range(0, n_orders, 13):
        o_ref[i] = None
    tables = {
        "customers": ({
            "c_id": np.arange(n_cust).astype(np.int32),
            "c_nation": rng.choice(["us", "de", "jp", "br", "cn"], n_cust)},
            [FieldSpec("c_id", DataType.INT),
             FieldSpec("c_nation", DataType.STRING)], 1),
        "parts": ({
            "p_id": (np.arange(n_parts) % (n_parts * 3 // 4)
                     ).astype(np.int32),
            "p_brand": rng.choice(["acme", "blitz", "corex"], n_parts),
            "p_weight": np.round(rng.normal(10, 3, n_parts), 3)},
            [FieldSpec("p_id", DataType.INT),
             FieldSpec("p_brand", DataType.STRING),
             FieldSpec("p_weight", DataType.DOUBLE, FieldType.METRIC)], 1),
        "orders": ({
            "o_key": np.arange(n_orders).astype(np.int64),
            # some customers ids past the table: outer joins null-extend
            "o_cust": rng.integers(0, n_cust + 40, n_orders
                                   ).astype(np.int32),
            "o_part": rng.integers(0, n_parts, n_orders).astype(np.int32),
            "o_price": rng.integers(10, 5000, n_orders).astype(np.int64),
            "o_disc": np.round(rng.random(n_orders), 4),
            "o_ref": o_ref},
            [FieldSpec("o_key", DataType.LONG),
             FieldSpec("o_cust", DataType.INT),
             FieldSpec("o_part", DataType.INT),
             FieldSpec("o_price", DataType.LONG, FieldType.METRIC),
             FieldSpec("o_disc", DataType.DOUBLE, FieldType.METRIC),
             FieldSpec("o_ref", DataType.INT)], 2),
    }
    return build_tables(out, tables)


@pytest.fixture(scope="module")
def brokers(tmp_path_factory):
    dirs = star_schema(str(tmp_path_factory.mktemp("star")))
    jb, tb = JaxBroker(), Broker(device="cpu")
    for name, ds in dirs.items():
        jdm, dm = JaxTable(name), TableDataManager(name, device="cpu")
        for d in ds:
            jdm.add_segment_dir(d)
            dm.add_segment_dir(d)
        jb.register_table(jdm)
        tb.register_table(dm)
    return jb, tb


@pytest.fixture(autouse=True)
def _device_paths(monkeypatch):
    for k in THRESHOLDS:
        monkeypatch.setenv(k, "0")
    monkeypatch.setenv("PINOT_CPU_FAST_GROUPBY", "1")


def same_rows(got, want) -> None:
    """Equal row lists: floats to a relative REL, the rest exactly."""
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float) and isinstance(x, float):
                assert x == pytest.approx(y, rel=REL, nan_ok=True), (g, w)
            else:
                assert x == y, (g, w)


def both(brokers, sql):
    jb, tb = brokers
    want = jb.query(sql).rows
    got = connect(tb)(sql).rows
    same_rows(got, want)
    return got


PLANES = (" OPTION(multistageFused=true)", " OPTION(multistageFused=false)")

JOIN_SQL = {
    "inner_gb": "SELECT c.c_nation, SUM(o.o_price), COUNT(*), "
                "AVG(o.o_disc) FROM orders o JOIN customers c "
                "ON o.o_cust = c.c_id GROUP BY c.c_nation "
                "ORDER BY c.c_nation",
    # no ORDER BY: the row order itself is compared
    "inner_rows": "SELECT o.o_key, c.c_nation, o.o_price FROM orders o "
                  "JOIN customers c ON o.o_cust = c.c_id LIMIT 100000",
    "left_rows": "SELECT o.o_key, c.c_id, c.c_nation FROM orders o "
                 "LEFT JOIN customers c ON o.o_cust = c.c_id "
                 "LIMIT 100000",
    "left_null_key": "SELECT o.o_key, o.o_ref, c.c_nation FROM orders o "
                     "LEFT JOIN customers c ON o.o_ref = c.c_id "
                     "ORDER BY o.o_key LIMIT 100000",
    "right": "SELECT c.c_id, o.o_key FROM orders o RIGHT JOIN customers c "
             "ON o.o_cust = c.c_id ORDER BY c.c_id, o.o_key LIMIT 100000",
    "full": "SELECT o.o_key, c.c_id FROM orders o FULL JOIN customers c "
            "ON o.o_cust = c.c_id ORDER BY o.o_key, c.c_id LIMIT 100000",
    "cross": "SELECT COUNT(*), SUM(p.p_id), SUM(p.p_weight) "
             "FROM customers c CROSS JOIN parts p",
    "left_non_equi": "SELECT o.o_key, c.c_nation FROM orders o "
                     "LEFT JOIN customers c ON o.o_cust = c.c_id "
                     "AND o.o_price > 2500 ORDER BY o.o_key LIMIT 100000",
    "inner_non_equi": "SELECT o.o_key, p.p_brand FROM orders o "
                      "JOIN parts p ON o.o_part = p.p_id "
                      "AND o.o_disc < p.p_weight / 20 LIMIT 100000",
    # duplicate build keys: the pairs' order is the stable sort's
    "dup_build": "SELECT o.o_key, p.p_brand, p.p_weight FROM orders o "
                 "JOIN parts p ON o.o_part = p.p_id LIMIT 100000",
    "three_way": "SELECT c.c_nation, p.p_brand, SUM(o.o_price * 2 + 1), "
                 "SUM(o.o_disc) FROM orders o "
                 "JOIN customers c ON o.o_cust = c.c_id "
                 "JOIN parts p ON o.o_part = p.p_id "
                 "WHERE p.p_brand = 'acme' "
                 "GROUP BY c.c_nation, p.p_brand "
                 "ORDER BY c.c_nation, p.p_brand",
    "post_where": "SELECT o.o_key, c.c_nation FROM orders o "
                  "LEFT JOIN customers c ON o.o_cust = c.c_id "
                  "WHERE c.c_nation = 'us' OR o.o_price < 100 "
                  "ORDER BY o.o_key LIMIT 100000",
    "window": "SELECT c.c_nation, o.o_key, "
              "ROW_NUMBER() OVER (PARTITION BY c.c_nation "
              "ORDER BY o.o_key), SUM(o.o_price) OVER (PARTITION BY "
              "c.c_nation ORDER BY o.o_key), AVG(o.o_disc) OVER "
              "(PARTITION BY c.c_nation) FROM orders o "
              "JOIN customers c ON o.o_cust = c.c_id "
              "WHERE o.o_price > 1000 ORDER BY o.o_key DESC LIMIT 200",
}


@pytest.mark.parametrize("plane", PLANES, ids=("fused", "mailbox"))
@pytest.mark.parametrize("name", list(JOIN_SQL))
def test_join_rows_equal_jax(brokers, name, plane):
    both(brokers, JOIN_SQL[name] + plane)


def test_port_backends(brokers):
    """The port's planes: K16 on the device, the numpy shuffle for a
    build side past the broadcast bound, K19 csr, and sort with K16
    inside the chain."""
    _jb, tb = brokers
    q = connect(tb)
    d0, f0 = dict(device_join.STATS), dict(fused.STATS)
    q(JOIN_SQL["dup_build"] + PLANES[1])
    assert device_join.STATS["device_joins"] == d0["device_joins"] + 1
    q(JOIN_SQL["inner_gb"] + PLANES[0])
    assert fused.STATS["fused_plans"] == f0["fused_plans"] + 1
    # a non-equi outer join falls back from the fused plane
    q(JOIN_SQL["left_non_equi"] + PLANES[0])
    assert fused.STATS["fused_fallbacks"] == f0["fused_fallbacks"] + 1
    ex = MultiStageExecutor(tb, parse_sql(JOIN_SQL["inner_gb"]
                                          + PLANES[1]))
    ex.execute()
    assert ex.join_backends == ["device"] and ex.plane == "mailbox"


def test_fused_sort_kind_runs_k16(brokers, monkeypatch):
    """PINOT_FUSED_MAX_CSR=0 sends every stage to the sort kind, whose
    join body is K16; rows unchanged."""
    monkeypatch.setenv("PINOT_FUSED_MAX_CSR", "0")
    calls = []
    real = fused.device_equi_join

    def spy(lk, rk, max_dup):
        calls.append(max_dup)
        return real(lk, rk, max_dup)

    monkeypatch.setattr(fused, "device_equi_join", spy)
    both(brokers, JOIN_SQL["three_way"] + PLANES[0])
    both(brokers, JOIN_SQL["dup_build"] + PLANES[0])
    assert calls == [1, 1, 2]


def test_fused_state_cap_falls_back(brokers, monkeypatch):
    monkeypatch.setenv("PINOT_FUSED_MAX_STATE", "64")
    f0 = dict(fused.STATS)
    both(brokers, JOIN_SQL["inner_rows"] + PLANES[0])
    assert fused.STATS["fused_fallbacks"] == f0["fused_fallbacks"] + 1
    assert fused.STATS["fused_plans"] == f0["fused_plans"]


def test_numpy_shuffle_past_broadcast_bound(brokers, monkeypatch):
    """A build side past BROADCAST_THRESHOLD takes the mailbox hash
    exchange on one device (the reference's mesh shuffle needs more)."""
    from pinot_tpu.multistage import executor as jexec
    from pinot_tpu_torch.multistage import executor as texec

    monkeypatch.setattr(jexec, "BROADCAST_THRESHOLD", 100)
    monkeypatch.setattr(texec, "BROADCAST_THRESHOLD", 100)
    _jb, tb = brokers
    sql = JOIN_SQL["inner_gb"] + PLANES[1]
    ex = MultiStageExecutor(tb, parse_sql(sql))
    ex.execute()
    assert ex.join_backends == ["numpy_shuffle"]
    both(brokers, sql)


def test_dynamic_semi_join_filter(brokers):
    sql = ("SELECT c.c_nation, COUNT(*), SUM(o.o_price) FROM customers c "
           "JOIN orders o ON c.c_id = o.o_cust WHERE c.c_id < 30 "
           "GROUP BY c.c_nation ORDER BY c.c_nation"
           " OPTION(multistageFused=false)")
    jb, tb = brokers
    ex = MultiStageExecutor(tb, parse_sql(sql))
    ex.execute()
    jex = JaxExec(jb, j_parse(sql))
    jex.execute()
    assert ex.dynamic_filters == jex.dynamic_filters
    assert ex.dynamic_filters == ["o.o_cust IN <30 keys>"]
    both(brokers, sql)


def test_three_way_join_order_equals_jax(brokers):
    sql = JOIN_SQL["three_way"]
    jb, tb = brokers
    ex = MultiStageExecutor(tb, parse_sql(sql))
    jex = JaxExec(jb, j_parse(sql))
    order, trace = ex.plan_join_order(ex._split_where()[0])
    jorder, jtrace = jex.plan_join_order(jex._split_where()[0])
    assert [j.table.label for j in order] == \
        [j.table.label for j in jorder] == ["p", "c"]
    assert trace == jtrace


def test_window_with_group_by_raises(brokers):
    _jb, tb = brokers
    with pytest.raises(SqlError, match="GROUP BY"):
        connect(tb)("SELECT c.c_nation, ROW_NUMBER() OVER (ORDER BY "
                    "c.c_nation) FROM orders o JOIN customers c ON "
                    "o.o_cust = c.c_id GROUP BY c.c_nation")


def test_join_leaves_nothing_on_the_device(brokers):
    """Only host arrays leave the device functions (K16, K19): the ops
    run on the device the broker names and their counts move only on
    CUDA."""
    _jb, tb = brokers
    n0 = ops_join.launches, fused.launches
    connect(tb)(JOIN_SQL["three_way"] + PLANES[0])
    connect(tb)(JOIN_SQL["dup_build"] + PLANES[1])
    assert (ops_join.launches, fused.launches) == n0


def test_fused_overflow_retries_then_falls_back(brokers, monkeypatch):
    """A program that reports a bucket overflow is re-run once at doubled
    slack, then the mailbox plane serves the query; rows unchanged."""
    real = fused._fused_program
    overflows = []

    def overflowing(times):
        def program(*args):
            out = real(*args)
            if len(overflows) < times:
                overflows.append(1)
                out = (*out[:-1], out[-1] | True)
            return out
        return program

    sql = JOIN_SQL["three_way"] + PLANES[0]
    for times, served in ((1, "fused_plans"), (2, "fused_fallbacks")):
        overflows.clear()
        monkeypatch.setattr(fused, "_fused_program", overflowing(times))
        f0 = dict(fused.STATS)
        both(brokers, sql)
        assert fused.STATS["fused_overflow"] == f0["fused_overflow"] + times
        assert fused.STATS[served] == f0[served] + 1
