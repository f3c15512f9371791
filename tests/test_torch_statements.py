"""The broker's statement surface: the port against the JAX broker.

Both brokers load the same segment directories: the small star schema of
``tests/test_torch_multistage.py`` (orders 4,096 rows in 2 segments,
customers 300, parts 40), a hybrid logical table ``ev`` (``ev_OFFLINE``
days 1-10 in 2 segments, ``ev_REALTIME`` days 8-15; boundary 10) and a
table with a QPS quota. Every statement form — IN / NOT IN / scalar /
[NOT] EXISTS subqueries, CTEs (into a single-stage query, a join, a
chain, declared columns), views, UNION [ALL] / INTERSECT [ALL] / EXCEPT
[ALL] with a compound ORDER BY / LIMIT, EXPLAIN of single-stage,
multi-stage, set-operation, CTE, subquery and hybrid statements, and
hybrid queries — must return the JAX broker's rows (floats to a relative
1e-9, in order), and each guard the JAX broker's error class name and
text. The port's CTE segments live on its device for the statement
only: after it the device-memory registry holds no CTE bytes and the
temporary directories are gone. The device thresholds are 0 so joins
take the device paths, and ``PINOT_CPU_FAST_GROUPBY`` pins the JAX
planner's CPU strategy as the other parity tests do.
"""
import os
import tempfile

import numpy as np
import pytest

from pinot_tpu.broker import Broker as JaxBroker
from pinot_tpu.broker import quota as jquota
from pinot_tpu.server import TableDataManager as JaxTable
from pinot_tpu.spi import TableConfig as JaxConfig
from pinot_tpu_torch.broker import Broker, connect
from pinot_tpu_torch.broker import quota as tquota
from pinot_tpu_torch.engine.tier import reconcile_devmem
from pinot_tpu_torch.segment import SegmentBuilder
from pinot_tpu_torch.server import TableDataManager
from pinot_tpu_torch.spi import (DataType, FieldSpec, FieldType,
                                 IndexingConfig, Schema, TableConfig)

from test_torch_multistage import THRESHOLDS, same_rows, star_schema
from test_torch_tier import reset_port_memory


def _hybrid(out: str):
    """{table: (config dict, [segment dirs])} of the hybrid tables ev
    (a dictionary time column) and raw (the same rows, the time column
    raw): the boundary reads either column's metadata max."""
    schema = Schema("ev", [
        FieldSpec("day", DataType.INT, FieldType.DATE_TIME),
        FieldSpec("kind", DataType.STRING),
        FieldSpec("v", DataType.INT, FieldType.METRIC)])
    rng = np.random.default_rng(21)
    tables = {}
    for side, days, segs in (("OFFLINE", np.arange(1, 11), 2),
                             ("REALTIME", np.arange(8, 16), 1)):
        rows = np.repeat(days, 30).astype(np.int32)
        data = {"day": rows,
                "kind": rng.choice(["a", "b", "c"], len(rows)),
                "v": rng.integers(1, 100, len(rows)).astype(np.int32)}
        bounds = np.linspace(0, len(rows), segs + 1).astype(int)
        for logical, raw in (("ev", []), ("raw", ["day"])):
            name = f"{logical}_{side}"
            cfg = TableConfig(name, time_column="day",
                              indexing=IndexingConfig(
                                  no_dictionary_columns=raw))
            tables[name] = (cfg.to_dict(), [
                SegmentBuilder(schema, cfg).build(
                    {k: v[bounds[i]:bounds[i + 1]]
                     for k, v in data.items()}, out, f"{name}_{i}")
                for i in range(segs)])
    return tables


QUOTA_QPS = 5


@pytest.fixture(scope="module")
def brokers(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("stmt"))
    star = star_schema(out)
    hybrid = _hybrid(out)
    tables = {n: (None, ds) for n, ds in star.items()}
    tables.update(hybrid)
    tables["limited"] = ({"tableName": "limited", "quotaQps": QUOTA_QPS},
                         star["parts"])
    jb, tb = JaxBroker(), Broker(device="cpu")
    for name, (cfg, dirs) in tables.items():
        jdm = JaxTable(name, table_config=JaxConfig.from_dict(cfg)
                       if cfg else None)
        dm = TableDataManager(name, device="cpu",
                              table_config=TableConfig.from_dict(cfg)
                              if cfg else None)
        for d in dirs:
            jdm.add_segment_dir(d)
            dm.add_segment_dir(d)
        jb.register_table(jdm)
        tb.register_table(dm)
    return jb, tb


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    for k in THRESHOLDS:
        monkeypatch.setenv(k, "0")
    monkeypatch.setenv("PINOT_CPU_FAST_GROUPBY", "1")


def outcome(run, sql):
    """(rows, None) or (None, (error class name, message))."""
    try:
        return run(sql), None
    except Exception as e:  # noqa: BLE001 — compared, not swallowed
        return None, (type(e).__name__, str(e))


def both(brokers, sql):
    jb, tb = brokers
    got, got_err = outcome(lambda q: connect(tb)(q).rows, sql)
    want, want_err = outcome(lambda q: jb.query(q).rows, sql)
    assert got_err == want_err, sql
    if want_err is None:
        same_rows(got, want)
    return got, got_err


GB = ("SELECT o_part, COUNT(*), SUM(o_price) FROM orders WHERE "
      "o_price {} GROUP BY o_part")
STATEMENTS = {
    # subqueries
    "in_subquery": "SELECT COUNT(*), SUM(o_price) FROM orders WHERE o_cust "
                   "IN (SELECT c_id FROM customers WHERE c_nation = 'de')",
    "not_in_gb": "SELECT o_part, COUNT(*) FROM orders WHERE o_cust NOT IN "
                 "(SELECT c_id FROM customers WHERE c_nation <> 'us') "
                 "GROUP BY o_part ORDER BY o_part LIMIT 100",
    "in_empty": "SELECT COUNT(*) FROM orders WHERE o_cust IN "
                "(SELECT c_id FROM customers WHERE c_nation = 'zz')",
    "in_user_limit": "SELECT COUNT(*) FROM orders WHERE o_cust IN (SELECT "
                     "c_id FROM customers ORDER BY c_id LIMIT 7) "
                     "OPTION(inSubqueryLimit=10)",
    "scalar": "SELECT COUNT(*) FROM orders WHERE o_price > "
              "(SELECT AVG(o_price) FROM orders)",
    "scalar_having": "SELECT o_part, SUM(o_price) FROM orders GROUP BY "
                     "o_part HAVING SUM(o_price) > (SELECT SUM(o_price) / 40 "
                     "FROM orders) ORDER BY o_part LIMIT 100",
    "exists": "SELECT COUNT(*), SUM(o_price) FROM orders o WHERE EXISTS "
              "(SELECT c_id FROM customers c WHERE c.c_id = o.o_cust AND "
              "c.c_nation = 'jp')",
    "not_exists": "SELECT o_part, COUNT(*) FROM orders o WHERE NOT EXISTS "
                  "(SELECT c_id FROM customers c WHERE c.c_id = o.o_cust) "
                  "GROUP BY o_part ORDER BY o_part LIMIT 100",
    "exists_const": "SELECT COUNT(*) FROM orders WHERE EXISTS (SELECT c_id "
                    "FROM customers WHERE c_nation = 'zz') OR o_price < 30",
    "exists_alias_self": "SELECT COUNT(*) FROM orders o WHERE EXISTS "
                         "(SELECT o_key FROM orders x WHERE x.o_key = "
                         "o.o_ref AND x.o_price > 2500)",
    # CTEs
    "cte_groupby": "WITH t AS (SELECT o_part, SUM(o_price) AS rev FROM "
                   "orders GROUP BY o_part LIMIT 1000) SELECT COUNT(*), "
                   "SUM(rev), MAX(rev) FROM t",
    "cte_join": "WITH big AS (SELECT c_id, c_nation FROM customers WHERE "
                "c_id < 150 LIMIT 1000) SELECT b.c_nation, SUM(o.o_price), "
                "COUNT(*) FROM orders o JOIN big b ON o.o_cust = b.c_id "
                "GROUP BY b.c_nation ORDER BY b.c_nation",
    "cte_chain": "WITH a AS (SELECT o_cust, o_price FROM orders WHERE "
                 "o_price > 4000 LIMIT 100000), b AS (SELECT o_cust, "
                 "COUNT(*) AS n FROM a GROUP BY o_cust LIMIT 100000) "
                 "SELECT n, COUNT(*) FROM b GROUP BY n ORDER BY n",
    "cte_columns": "WITH t (p, w) AS (SELECT p_id, p_weight FROM parts "
                   "LIMIT 100) SELECT SUM(w), MIN(p) FROM t",
    "cte_setop_body": "WITH u AS (SELECT c_nation FROM customers UNION "
                      "SELECT p_brand FROM parts) SELECT COUNT(*) FROM u",
    # set operations
    "union_all": GB.format("> 4000") + " UNION ALL " + GB.format("< 200")
    + " ORDER BY 1, 2 LIMIT 50",
    "union": "SELECT o_part FROM orders WHERE o_price > 4500 UNION SELECT "
             "p_id FROM parts WHERE p_weight > 10 ORDER BY o_part LIMIT 100",
    "intersect": "SELECT o_part FROM orders WHERE o_price > 4500 INTERSECT "
                 "SELECT o_part FROM orders WHERE o_disc < 0.1 ORDER BY 1 "
                 "LIMIT 100",
    "intersect_all": "SELECT o_part FROM orders WHERE o_price > 4800 "
                     "INTERSECT ALL SELECT p_id FROM parts ORDER BY 1 "
                     "LIMIT 100",
    "except": "SELECT p_id FROM parts EXCEPT SELECT o_part FROM orders "
              "WHERE o_price > 4000 ORDER BY p_id LIMIT 100",
    "except_all": "SELECT p_id FROM parts EXCEPT ALL SELECT o_part FROM "
                  "orders WHERE o_price > 4990 ORDER BY 1 DESC LIMIT 100",
    "setop_chain": "SELECT c_nation FROM customers UNION ALL SELECT p_brand "
                   "FROM parts EXCEPT SELECT c_nation FROM customers WHERE "
                   "c_id < 5 ORDER BY 1",
    "setop_joins": "SELECT c.c_nation, SUM(o.o_price) FROM orders o JOIN "
                   "customers c ON o.o_cust = c.c_id WHERE o.o_price > 2500 "
                   "GROUP BY c.c_nation UNION ALL SELECT p.p_brand, "
                   "SUM(o.o_price) FROM orders o JOIN parts p ON o.o_part = "
                   "p.p_id WHERE o.o_price <= 2500 GROUP BY p.p_brand "
                   "ORDER BY 1",
    "setop_default_limit": "SELECT o_key FROM orders UNION ALL SELECT "
                           "o_key FROM orders",
    # EXPLAIN
    "explain_gb": "EXPLAIN PLAN FOR " + GB.format("> 100") + " ORDER BY "
                  "o_part LIMIT 5",
    "explain_scalar": "EXPLAIN PLAN FOR SELECT SUM(o_price), COUNT(*) FROM "
                      "orders WHERE o_cust IN (1, 2, 3) AND o_disc < 0.5",
    "explain_select": "EXPLAIN PLAN FOR SELECT o_key FROM orders WHERE "
                      "o_price BETWEEN 10 AND 20 ORDER BY o_key LIMIT 3",
    "explain_fast": "EXPLAIN PLAN FOR SELECT COUNT(*) FROM orders",
    "explain_pruned": "EXPLAIN PLAN FOR SELECT COUNT(*) FROM orders WHERE "
                      "o_price > 999999",
    "explain_join": "EXPLAIN PLAN FOR SELECT c.c_nation, COUNT(*) FROM "
                    "orders o JOIN customers c ON o.o_cust = c.c_id JOIN "
                    "parts p ON o.o_part = p.p_id WHERE p.p_brand = 'acme' "
                    "GROUP BY c.c_nation",
    "explain_window": "EXPLAIN PLAN FOR SELECT o_key, ROW_NUMBER() OVER "
                      "(PARTITION BY o_part ORDER BY o_key) FROM orders",
    "explain_setop": "EXPLAIN PLAN FOR SELECT o_part FROM orders UNION ALL "
                     "SELECT p_id FROM parts INTERSECT SELECT p_id FROM parts",
    "explain_subquery": "EXPLAIN PLAN FOR SELECT COUNT(*) FROM orders WHERE "
                        "o_cust IN (SELECT c_id FROM customers) AND o_price "
                        "> (SELECT AVG(o_price) FROM orders)",
    "explain_cte": "EXPLAIN PLAN FOR WITH t AS (SELECT o_part, o_price FROM "
                   "orders) SELECT o_part, SUM(o_price) FROM t GROUP BY "
                   "o_part",
    "explain_hybrid": "EXPLAIN PLAN FOR SELECT kind, SUM(v) FROM ev GROUP BY "
                      "kind",
    # hybrid tables
    "hybrid_sum": "SELECT SUM(v), COUNT(*), MIN(day), MAX(day) FROM ev",
    "hybrid_gb": "SELECT day, kind, SUM(v) FROM ev GROUP BY day, kind "
                 "ORDER BY day, kind LIMIT 100",
    "hybrid_filter": "SELECT COUNT(*) FROM ev WHERE day >= 9 AND kind <> 'c'",
    "hybrid_select": "SELECT day, v FROM ev WHERE day BETWEEN 10 AND 11 "
                     "ORDER BY day, v LIMIT 100",
    "hybrid_in_subquery": "SELECT COUNT(*) FROM ev WHERE day IN (SELECT "
                          "day FROM ev_REALTIME WHERE v > 95)",
    "hybrid_physical": "SELECT COUNT(*) FROM ev_REALTIME",
    "hybrid_raw_time": "SELECT kind, SUM(v), COUNT(*), MAX(day) FROM raw "
                       "GROUP BY kind ORDER BY kind",
    # guards: the error class name and text must be the JAX broker's
    "err_in_limit": "SELECT COUNT(*) FROM orders WHERE o_key IN (SELECT "
                    "o_key FROM orders) OPTION(inSubqueryLimit=100)",
    "err_in_user_limit": "SELECT COUNT(*) FROM orders WHERE o_key IN "
                         "(SELECT o_key FROM orders LIMIT 500) "
                         "OPTION(inSubqueryLimit=100)",
    "err_in_columns": "SELECT COUNT(*) FROM orders WHERE o_key IN (SELECT "
                      "c_id, c_nation FROM customers)",
    "err_cte_limit": "WITH t AS (SELECT o_key FROM orders) SELECT COUNT(*) "
                     "FROM t OPTION(cteLimit=100)",
    "err_cte_columns": "WITH t (a, b) AS (SELECT p_id FROM parts LIMIT 10) "
                       "SELECT COUNT(*) FROM t",
    "err_scalar_rows": "SELECT COUNT(*) FROM orders WHERE o_price > "
                       "(SELECT o_price FROM orders LIMIT 2)",
    "err_setop_columns": "SELECT o_key FROM orders UNION SELECT c_id, "
                         "c_nation FROM customers",
    "err_setop_order": "SELECT o_key FROM orders UNION SELECT c_id FROM "
                       "customers ORDER BY nope",
    "err_exists_shape": "SELECT COUNT(*) FROM orders o WHERE EXISTS (SELECT "
                        "c_id FROM customers c WHERE c.c_id = o.o_cust "
                        "GROUP BY c_id)",
    "err_exists_qualifier": "SELECT COUNT(*) FROM orders o WHERE EXISTS "
                            "(SELECT c_id FROM customers c WHERE z.c_id = "
                            "o.o_cust)",
    "err_exists_noneq": "SELECT COUNT(*) FROM orders o WHERE EXISTS (SELECT "
                        "c_id FROM customers c WHERE c.c_id > o.o_cust)",
    "err_hybrid_join": "SELECT COUNT(*) FROM ev e JOIN parts p ON e.v = "
                       "p.p_id",
    "err_unknown_table": "SELECT COUNT(*) FROM nowhere",
}


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_matches_jax(brokers, name):
    _rows, err = both(brokers, STATEMENTS[name])
    assert (err is None) == (not name.startswith("err_")), err


def test_explain_executes_no_scan(brokers, monkeypatch):
    """Plan-only EXPLAIN runs no segment, subquery, CTE body or branch."""
    from pinot_tpu_torch.engine import serving
    from pinot_tpu_torch.multistage import executor as ms

    calls = []
    monkeypatch.setattr(serving, "execute_plans_batched",
                        lambda plans: calls.append(plans))
    monkeypatch.setattr(ms.MultiStageExecutor, "execute",
                        lambda self: calls.append(self))
    _jb, tb = brokers
    for name, sql in STATEMENTS.items():
        if name.startswith("explain_") and name != "explain_cte":
            connect(tb)(sql)
    assert calls == []


def test_views_match_jax(brokers):
    """CREATE VIEW, queries over views (a view on a view, a view in a
    join and in a subquery, an explicit CTE shadowing a view), DROP VIEW
    and the catalog's errors, step by step on both brokers."""
    jb, tb = brokers
    steps = [
        "CREATE VIEW rev AS SELECT o_part AS part, SUM(o_price) AS total "
        "FROM orders GROUP BY o_part LIMIT 100000",
        "SELECT part, total FROM rev ORDER BY total DESC LIMIT 5",
        "CREATE VIEW top AS SELECT part FROM rev WHERE total > 250000 "
        "LIMIT 1000",
        "SELECT COUNT(*) FROM top",
        "SELECT p.p_brand, COUNT(*) FROM parts p JOIN rev ON part = p.p_id "
        "GROUP BY p.p_brand ORDER BY p.p_brand",
        "SELECT COUNT(*) FROM orders WHERE o_part IN (SELECT part FROM top)",
        "WITH top AS (SELECT p_id AS part FROM parts LIMIT 3) "
        "SELECT COUNT(*) FROM top",
        "CREATE VIEW rev AS SELECT o_key FROM orders",
        "CREATE VIEW orders AS SELECT o_key FROM orders",
        "CREATE VIEW ev AS SELECT day FROM ev",
        "CREATE OR REPLACE VIEW rev AS SELECT COUNT(*) AS n FROM orders",
        "SELECT n FROM rev",
        "CREATE OR REPLACE VIEW top AS SELECT part FROM top2 LIMIT 10",
        "CREATE VIEW top2 AS SELECT part FROM top LIMIT 10",
        "SELECT * FROM top",
        "EXPLAIN PLAN FOR SELECT COUNT(*) FROM rev",
        "DROP VIEW top2",
        "DROP VIEW top",
        "DROP VIEW IF EXISTS top",
        "DROP VIEW top",
        "DROP VIEW rev",
        "SELECT COUNT(*) FROM rev",
    ]
    for sql in steps:
        both(brokers, sql)
        assert tb.view_names == jb.view_names, sql
    assert tb.view_names == []


def test_cte_segments_leave_the_device(brokers, monkeypatch, tmp_path):
    """A CTE's segment lives on the broker's device for the statement
    only: the devmem registry's tracked bytes equal the tensors held
    after it, no CTE directory is left, and the scoped table dict never
    reaches the broker."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _jb, tb = brokers
    tables = list(tb.table_names)
    live = [s for t in tables for s in tb.table(t).acquire_segments()]
    reset_port_memory(live)      # the registry is process-wide
    for name in ("cte_groupby", "cte_join", "cte_chain", "cte_columns"):
        connect(tb)(STATEMENTS[name])
        for pool, v in reconcile_devmem(live).items():
            assert v["tracked"] == v["actual"], (name, pool, v)
        assert tb.table_names == tables
        assert not [d for d in os.listdir(tmp_path)
                    if d.startswith("ptpu_cte_")]
    # a failing CTE statement tears its scope down too
    with pytest.raises(Exception, match="cteLimit"):
        connect(tb)(STATEMENTS["err_cte_limit"])
    assert not os.listdir(tmp_path)


def test_cte_segments_are_on_the_broker_device(brokers, monkeypatch):
    from pinot_tpu_torch.broker import broker as bmod

    seen = []
    real = bmod._cte_table

    def spy(*a, **kw):
        dm = real(*a, **kw)
        seen.append([s.device for s in dm.acquire_segments()])
        return dm

    monkeypatch.setattr(bmod, "_cte_table", spy)
    _jb, tb = brokers
    connect(tb)(STATEMENTS["cte_chain"])
    assert seen and all(d == tb.device for ds in seen for d in ds)


def test_quota_matches_jax(brokers, monkeypatch):
    """A table with quotaQps 5 takes a burst of 5 and refuses the 6th
    with the JAX broker's QuotaExceededError text; the clock refills it.
    Both packages read the same injected monotonic clock."""
    now = [1000.0]
    for mod in (jquota, tquota):
        monkeypatch.setattr(mod.time, "monotonic", lambda: now[0])
    jb, tb = brokers
    for b in (jb, tb):    # a full bucket at the injected clock
        b.quota.set_quota("limited", None)
        b.quota.set_quota("limited", QUOTA_QPS)
    sql = "SELECT COUNT(*) FROM limited"
    for i in range(QUOTA_QPS + 1):
        _rows, err = both(brokers, sql)
        assert (err is None) == (i < QUOTA_QPS), (i, err)
    assert err[0] == "QuotaExceededError"
    now[0] += 1.0 / QUOTA_QPS
    _rows, err = both(brokers, sql)
    assert err is None
    # subqueries and CTE bodies over the table charge it too
    _rows, err = both(brokers, "SELECT COUNT(*) FROM parts WHERE p_id IN "
                      "(SELECT p_id FROM limited)")
    assert err[0] == "QuotaExceededError"
