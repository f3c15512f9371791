"""The SSB Q1.1-Q4.3 workload: data, queries and a numpy oracle.

The port's own copy of ``bench.py``'s ``gen_columns``, ``QUERIES``,
``QPS_SHAPES`` (here ``CONCURRENT``), ``spec_to_sql``, ``oracle_run`` and
``_digest``, so ``chip_smoke.py`` and the port need nothing from the JAX
package. The 13 queries (reference:
pinot-integration-tests/src/test/resources/ssb/ssb_query_set.yaml) run
over one flat, denormalized ``lineorder`` table: the dimension attributes
each query touches are dictionary-encoded columns, hierarchically
consistent with the SSB spec (brand -> category -> mfgr; city -> nation
-> region). The data is made from a fixed seed.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np

from ..segment.builder import Categorical, SegmentBuilder
from ..spi import DataType, FieldSpec, FieldType, Schema, TableConfig

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    # 5 per region, region r owns nations r*5..r*5+4 (SSB nation list)
    "ALGERIA", "ETHIOPIA", "KENYA", "MOROCCO", "MOZAMBIQUE",
    "ARGENTINA", "BRAZIL", "CANADA", "PERU", "UNITED STATES",
    "INDIA", "INDONESIA", "JAPAN", "CHINA", "VIETNAM",
    "FRANCE", "GERMANY", "ROMANIA", "RUSSIA", "UNITED KINGDOM",
    "EGYPT", "IRAN", "IRAQ", "JORDAN", "SAUDI ARABIA",
]
# SSB cities: nation name truncated to 9 chars + digit 0-9
CITIES = [n[:9] + str(d) for n in NATIONS for d in range(10)]
MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
          "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
YEARS = list(range(1992, 1999))
YEARMONTHS = [f"{m}{y}" for y in YEARS for m in MONTHS]
# brands: MFGR#<m><c><b>, m 1-5, c 1-5, b 1-40; category MFGR#<m><c>
BRANDS = [f"MFGR#{m}{c}{b}" for m in range(1, 6) for c in range(1, 6)
          for b in range(1, 41)]
CATEGORIES = [f"MFGR#{m}{c}" for m in range(1, 6) for c in range(1, 6)]
MFGRS = [f"MFGR#{m}" for m in range(1, 6)]


def gen_columns(n: int):
    """Generate the flat denormalized lineorder columns (seeded)."""
    rng = np.random.default_rng(1992)
    year = rng.integers(0, 7, n).astype(np.int16)          # 1992..1998
    month = rng.integers(0, 12, n).astype(np.int8)
    brand = rng.integers(0, 1000, n).astype(np.int16)
    s_nation = rng.integers(0, 25, n).astype(np.int8)
    c_nation = rng.integers(0, 25, n).astype(np.int8)
    s_city = (s_nation.astype(np.int16) * 10
              + rng.integers(0, 10, n).astype(np.int16))
    c_city = (c_nation.astype(np.int16) * 10
              + rng.integers(0, 10, n).astype(np.int16))
    return {
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
        "lo_discount": rng.integers(0, 11, n).astype(np.int32),
        "lo_extendedprice": rng.integers(900, 55451, n).astype(np.int32),
        "lo_revenue": rng.integers(10000, 6000000, n).astype(np.int32),
        "lo_supplycost": rng.integers(10000, 120000, n).astype(np.int32),
        "d_year": (year.astype(np.int32) + 1992),
        "d_yearmonthnum": ((year.astype(np.int32) + 1992) * 100
                           + month + 1),
        "d_weeknuminyear": rng.integers(1, 54, n).astype(np.int32),
        "d_yearmonth": Categorical(year.astype(np.int16) * 12 + month,
                                   YEARMONTHS),
        "p_brand1": Categorical(brand, BRANDS),
        "p_category": Categorical((brand // 40).astype(np.int8), CATEGORIES),
        "p_mfgr": Categorical((brand // 200).astype(np.int8), MFGRS),
        "s_region": Categorical((s_nation // 5).astype(np.int8), REGIONS),
        "s_nation": Categorical(s_nation, NATIONS),
        "s_city": Categorical(s_city, CITIES),
        "c_region": Categorical((c_nation // 5).astype(np.int8), REGIONS),
        "c_nation": Categorical(c_nation, NATIONS),
        "c_city": Categorical(c_city, CITIES),
    }


def gen_lineorder_keys(n: int):
    """The SSB lineorder key that the flat columns leave out, for n rows
    in order (seeded): ``lo_orderkey`` numbers the orders from 1, each of
    1 to 7 lines as in the SSB spec's lineorder, and ``lo_linenumber``
    counts an order's lines from 1. (orderkey, linenumber) is unique."""
    rng = np.random.default_rng(1993)
    lines = rng.integers(1, 8, n // 3 + 8)      # 4 lines an order on average
    ends = np.cumsum(lines)
    orderkey = np.repeat(np.arange(1, len(lines) + 1, dtype=np.int32),
                         lines)[:n]
    first = np.repeat(ends - lines, lines)[:n]
    return {"lo_orderkey": orderkey,
            "lo_linenumber": (np.arange(n) - first + 1).astype(np.int32)}


def keyed_schema(cols) -> Schema:
    """The lineorder schema of the flat columns plus the lineorder key
    (``gen_lineorder_keys``) as integer dimensions."""
    keys = [c for c in ("lo_orderkey", "lo_linenumber") if c in cols]
    return Schema("lineorder", _ssb_fields(
        {c: v for c, v in cols.items() if c not in keys})
        + [FieldSpec(c, DataType.INT, FieldType.DIMENSION) for c in keys])


def take_rows(cols, idx):
    """The columns at row indexes ``idx`` (Categoricals stay encoded)."""
    return {c: (Categorical(v.codes[idx], v.values)
                if isinstance(v, Categorical) else v[idx])
            for c, v in cols.items()}


def row_dicts(cols):
    """The columns as row dicts, as a stream delivers them (strings for
    the dictionary-encoded columns, Python ints for the rest)."""
    names = list(cols)
    lists = [np.asarray(v.values, dtype=object)[v.codes].tolist()
             if isinstance(v, Categorical) else v.tolist()
             for v in cols.values()]
    return [dict(zip(names, vals)) for vals in zip(*lists)]


def lineorder_schema(cols) -> Schema:
    """The flat lineorder schema of ``cols`` (``gen_columns``)."""
    return Schema("lineorder", _ssb_fields(cols))


def avro_schema(cols) -> dict:
    """An Avro record schema for ``row_dicts(cols)``: ``int`` for the
    integer columns, ``string`` for the dictionary-encoded ones."""
    return {"type": "record", "name": "lineorder", "fields": [
        {"name": c, "type": "int" if isinstance(v, np.ndarray)
         else "string"} for c, v in cols.items()]}


def _ssb_fields(cols):
    fields = []
    for name in cols:
        if name.startswith("lo_") and name not in ("lo_quantity",
                                                   "lo_discount"):
            fields.append(FieldSpec(name, DataType.INT, FieldType.METRIC))
        elif isinstance(cols[name], np.ndarray):
            fields.append(FieldSpec(name, DataType.INT, FieldType.DIMENSION))
        else:
            fields.append(FieldSpec(name, DataType.STRING,
                                    FieldType.DIMENSION))
    return fields


def build_segment_dir(n: int, out_dir: str,
                      table_config: Optional[TableConfig] = None) -> str:
    """Build the flat SSB segment at n rows under out_dir; returns its
    directory (``seg_0``). ``table_config`` (default: plain
    ``TableConfig("lineorder")``) chooses the forward-index formats, e.g.
    ``IndexingConfig(bit_packed_ids=True)`` or raw compressed metrics."""
    cols = gen_columns(n)
    return SegmentBuilder(lineorder_schema(cols), table_config
                          or TableConfig("lineorder")).build(
        cols, out_dir, "seg_0")


def build_table_dir(sizes, out_dir: str,
                    table_config: Optional[TableConfig] = None) -> str:
    """Build a many-segment lineorder table: the seeded columns of
    ``sum(sizes)`` rows (the rows of ``build_segment_dir`` at that size,
    in order) split into one segment directory per entry of ``sizes``
    (``seg_0``, ``seg_1``, ... under ``out_dir``, as bench.py splits its
    tier-bench table); each segment builds its own dictionaries. Returns
    ``out_dir`` (``TableDataManager.add_table_dir`` loads it)."""
    cols = gen_columns(int(sum(sizes)))
    builder = SegmentBuilder(lineorder_schema(cols),
                             table_config or TableConfig("lineorder"))
    width = len(str(len(sizes) - 1))
    lo = 0
    for k, n in enumerate(sizes):
        part = {c: (Categorical(v.codes[lo:lo + n], v.values)
                    if isinstance(v, Categorical) else v[lo:lo + n])
                for c, v in cols.items()}
        builder.build(part, out_dir, f"seg_{k:0{width}d}")
        lo += n
    return out_dir


# ---------------------------------------------------------------------------
# Query specs: (qid, preds, value_expr, group_cols)
# preds: (col, op, value) with op in {eq, in, between, lt}
# value_expr: (col,) | (col, '*', col) | (col, '-', col)
# ---------------------------------------------------------------------------

QUERIES = [
    ("q1.1", [("d_year", "eq", 1993), ("lo_discount", "between", (1, 3)),
              ("lo_quantity", "lt", 25)],
     ("lo_extendedprice", "*", "lo_discount"), []),
    ("q1.2", [("d_yearmonthnum", "eq", 199401),
              ("lo_discount", "between", (4, 6)),
              ("lo_quantity", "between", (26, 35))],
     ("lo_extendedprice", "*", "lo_discount"), []),
    ("q1.3", [("d_weeknuminyear", "eq", 6), ("d_year", "eq", 1994),
              ("lo_discount", "between", (5, 7)),
              ("lo_quantity", "between", (26, 35))],
     ("lo_extendedprice", "*", "lo_discount"), []),
    ("q2.1", [("p_category", "eq", "MFGR#12"), ("s_region", "eq", "AMERICA")],
     ("lo_revenue",), ["d_year", "p_brand1"]),
    ("q2.2", [("p_brand1", "between", ("MFGR#2221", "MFGR#2228")),
              ("s_region", "eq", "ASIA")],
     ("lo_revenue",), ["d_year", "p_brand1"]),
    ("q2.3", [("p_brand1", "eq", "MFGR#2221"), ("s_region", "eq", "EUROPE")],
     ("lo_revenue",), ["d_year", "p_brand1"]),
    ("q3.1", [("c_region", "eq", "ASIA"), ("s_region", "eq", "ASIA"),
              ("d_year", "between", (1992, 1997))],
     ("lo_revenue",), ["c_nation", "s_nation", "d_year"]),
    ("q3.2", [("c_nation", "eq", "UNITED STATES"),
              ("s_nation", "eq", "UNITED STATES"),
              ("d_year", "between", (1992, 1997))],
     ("lo_revenue",), ["c_city", "s_city", "d_year"]),
    ("q3.3", [("c_city", "in", ("UNITED KI1", "UNITED KI5")),
              ("s_city", "in", ("UNITED KI1", "UNITED KI5")),
              ("d_year", "between", (1992, 1997))],
     ("lo_revenue",), ["c_city", "s_city", "d_year"]),
    ("q3.4", [("c_city", "in", ("UNITED KI1", "UNITED KI5")),
              ("s_city", "in", ("UNITED KI1", "UNITED KI5")),
              ("d_yearmonth", "eq", "Jul1995")],
     ("lo_revenue",), ["c_city", "s_city", "d_year"]),
    ("q4.1", [("c_region", "eq", "AMERICA"), ("s_region", "eq", "AMERICA"),
              ("p_mfgr", "in", ("MFGR#1", "MFGR#2"))],
     ("lo_revenue", "-", "lo_supplycost"), ["d_year", "c_nation"]),
    ("q4.2", [("c_region", "eq", "AMERICA"), ("s_region", "eq", "AMERICA"),
              ("d_year", "in", (1997, 1998)),
              ("p_mfgr", "in", ("MFGR#1", "MFGR#2"))],
     ("lo_revenue", "-", "lo_supplycost"),
     ["d_year", "s_nation", "p_category"]),
    ("q4.3", [("c_region", "eq", "AMERICA"),
              ("s_nation", "eq", "UNITED STATES"),
              ("d_year", "in", (1997, 1998)),
              ("p_category", "eq", "MFGR#14")],
     ("lo_revenue", "-", "lo_supplycost"),
     ["d_year", "s_city", "p_brand1"]),
]


# One query or more per single-stage plan kind beyond the SSB set, over the
# same table: (name, sql, the plan kind the planner should choose). The
# kselect queries cut through runs of equal order keys (ties), the sketches
# cover a dictionary column (hash64 param) and a raw one (device
# splitmix64), and "host" has a group key with no device lowering. Each
# filter keeps the host path's share (string hashing, sorts) to a few
# million rows at 2^26, since the host path is their reference.
SURFACE = [
    ("count_star", "SELECT COUNT(*) FROM lineorder", "fast"),
    ("min_max", "SELECT MIN(lo_revenue), MAX(lo_supplycost) "
                "FROM lineorder", "fast"),
    ("top_revenue", "SELECT lo_revenue, d_year, s_city FROM lineorder "
                    "WHERE d_year = 1993 AND lo_discount BETWEEN 1 AND 3 "
                    "ORDER BY lo_revenue DESC LIMIT 10", "kselect"),
    ("doc_order", "SELECT lo_revenue, c_city FROM lineorder "
                  "WHERE s_nation = 'CHINA' LIMIT 10", "kselect"),
    ("tie_cut", "SELECT d_year, p_mfgr, lo_revenue FROM lineorder "
                "WHERE c_nation = 'CHINA' ORDER BY d_year, p_mfgr DESC "
                "LIMIT 10", "kselect"),
    ("hll_dict", "SELECT DISTINCTCOUNTHLL(p_brand1) FROM lineorder "
                 "WHERE d_year = 1995 AND s_region = 'ASIA'", "kernel"),
    ("hll_raw", "SELECT DISTINCTCOUNTHLL(lo_revenue) FROM lineorder "
                "WHERE s_region = 'EUROPE'", "kernel"),
    ("theta", "SELECT DISTINCTCOUNTTHETASKETCH(lo_revenue) FROM lineorder "
              "WHERE d_year = 1994", "kernel"),
    ("percentile", "SELECT PERCENTILEKLL(lo_revenue, 90) FROM lineorder "
                   "WHERE c_region = 'ASIA'", "kernel"),
    ("hll_grouped", "SELECT d_year, DISTINCTCOUNTHLL(s_city) FROM lineorder "
                    "WHERE c_nation = 'CHINA' GROUP BY d_year "
                    "ORDER BY d_year LIMIT 10", "kernel"),
    ("host", "SELECT UPPER(s_region), SUM(lo_revenue) FROM lineorder "
             "WHERE d_yearmonthnum = 199401 GROUP BY UPPER(s_region) "
             "ORDER BY UPPER(s_region) LIMIT 10", "host"),
]

# concurrent traffic (bench.py's QPS_SHAPES): literal-variant generators
# per SSB shape. Each variant keeps the plan structure (eq stays eq,
# BETWEEN keeps both bounds, OR-of-equals keeps its width) and varies only
# literal values, so concurrent variants share the KernelPlan the
# cross-query micro-batcher (engine/ragged.py) keys on. make(k) is the
# SQL of variant k, with no OPTION clause.
CONCURRENT = [
    ("q1.1", lambda i:
        f"SELECT SUM(lo_extendedprice * lo_discount) FROM lineorder "
        f"WHERE d_year = {1992 + i % 7} "
        f"AND lo_discount BETWEEN {i % 4} AND {i % 4 + 2} "
        f"AND lo_quantity < {20 + i % 15}"),
    ("q1.2", lambda i:
        f"SELECT SUM(lo_extendedprice * lo_discount) FROM lineorder "
        f"WHERE d_yearmonthnum = {199201 + (i % 7) * 100 + i % 12} "
        f"AND lo_discount BETWEEN {1 + i % 4} AND {3 + i % 4} "
        f"AND lo_quantity BETWEEN {10 + i % 10} AND {30 + i % 10}"),
    ("q3.1", lambda i:
        f"SELECT c_nation, s_nation, d_year, SUM(lo_revenue) "
        f"FROM lineorder WHERE c_region = '{REGIONS[i % 5]}' "
        f"AND s_region = '{REGIONS[(i // 5) % 5]}' "
        f"AND d_year BETWEEN {1992 + i % 2} AND {1996 + i % 3} "
        f"GROUP BY c_nation, s_nation, d_year "
        f"ORDER BY c_nation, s_nation, d_year LIMIT 100000"),
    ("q4.1", lambda i:
        f"SELECT d_year, c_nation, "
        f"SUM(lo_revenue - lo_supplycost) FROM lineorder "
        f"WHERE c_region = '{REGIONS[i % 5]}' "
        f"AND s_region = '{REGIONS[(i // 5) % 5]}' "
        f"AND (p_mfgr = 'MFGR#{1 + i % 4}' OR p_mfgr = 'MFGR#{2 + i % 4}')"
        f" GROUP BY d_year, c_nation ORDER BY d_year, c_nation "
        f"LIMIT 100000"),
]


def _sql_lit(v) -> str:
    return f"'{v}'" if isinstance(v, str) else str(v)


def spec_to_sql(preds, value_expr, group_cols) -> str:
    agg = "SUM(" + " ".join(value_expr) + ")"
    sel = ", ".join(group_cols + [agg]) if group_cols else agg
    conds = []
    for col, op, val in preds:
        if op == "eq":
            conds.append(f"{col} = {_sql_lit(val)}")
        elif op == "lt":
            conds.append(f"{col} < {_sql_lit(val)}")
        elif op == "between":
            conds.append(f"{col} BETWEEN {_sql_lit(val[0])} "
                         f"AND {_sql_lit(val[1])}")
        elif op == "in":
            # the reference queries write 2-value sets as OR-of-equals;
            # keep that form so the planner's Or folding is exercised
            conds.append("(" + " OR ".join(
                f"{col} = {_sql_lit(v)}" for v in val) + ")")
    sql = f"SELECT {sel} FROM lineorder WHERE {' AND '.join(conds)}"
    if group_cols:
        sql += (" GROUP BY " + ", ".join(group_cols)
                + " ORDER BY " + ", ".join(group_cols) + " LIMIT 100000")
    return sql


# ---------------------------------------------------------------------------
# numpy oracle (= single-threaded CPU baseline, on dict ids like Pinot)
# ---------------------------------------------------------------------------

def _pred_mask(seg, col, op, val):
    ids = np.asarray(seg.fwd(col))
    d = seg.dictionary(col)
    vals = None if d is None else np.asarray(d.values)
    if op == "eq":
        if d is None:
            return ids == val
        i = d.index_of(val)
        return (ids == i) if i >= 0 else np.zeros(len(ids), dtype=bool)
    if op == "in":
        if d is None:
            return np.isin(ids, list(val))
        tgt = [i for i in (d.index_of(v) for v in val) if i >= 0]
        return np.isin(ids, tgt)
    if op == "lt":
        if d is None:
            return ids < val
        return ids < int(np.searchsorted(vals, val, side="left"))
    assert op == "between"
    lo_v, hi_v = val
    if d is None:
        return (ids >= lo_v) & (ids <= hi_v)
    lo = int(np.searchsorted(vals, lo_v, side="left"))
    hi = int(np.searchsorted(vals, hi_v, side="right"))
    return (ids >= lo) & (ids < hi)


def _value(seg, value_expr, mask):
    def col_vals(c):
        ids = np.asarray(seg.fwd(c))[mask]
        d = seg.dictionary(c)
        if d is None:
            return ids.astype(np.int64)
        return np.asarray(d.values)[ids].astype(np.int64)

    if len(value_expr) == 1:
        return col_vals(value_expr[0])
    a, op, b = value_expr
    return col_vals(a) * col_vals(b) if op == "*" \
        else col_vals(a) - col_vals(b)


def oracle_run(seg, preds, value_expr, group_cols):
    """Evaluate one spec with numpy; returns (rows, elapsed_seconds)."""
    t0 = time.perf_counter()
    mask = None
    for p in preds:
        m = _pred_mask(seg, *p)
        mask = m if mask is None else (mask & m)
    vals = _value(seg, value_expr, mask)
    if not group_cols:
        rows = [(int(vals.sum()),)]
        return rows, time.perf_counter() - t0
    dims = [(c, seg.columns[c].cardinality) for c in group_cols]
    key = np.zeros(int(mask.sum()), dtype=np.int64)
    for c, card in dims:
        key = key * card + np.asarray(seg.fwd(c))[mask].astype(np.int64)
    space = math.prod(card for _, card in dims)
    sums = np.bincount(key, weights=vals.astype(np.float64),
                       minlength=space)
    cnts = np.bincount(key, minlength=space)
    idxs = np.nonzero(cnts)[0]
    elapsed = time.perf_counter() - t0
    keycols = []
    rem = idxs.copy()
    for c, card in reversed(dims):
        keycols.append(seg.dictionary(c).values_for(rem % card))
        rem = rem // card
    keycols.reverse()
    rows = [tuple(_py(kc[i]) for kc in keycols) + (int(sums[idxs[i]]),)
            for i in range(len(idxs))]
    return rows, elapsed


def _py(v):
    return v.item() if isinstance(v, np.generic) else v


def _digest(rows):
    out = []
    for r in rows:
        out.append(tuple(str(x) if isinstance(x, str) else int(x)
                         for x in r))
    return sorted(out)
