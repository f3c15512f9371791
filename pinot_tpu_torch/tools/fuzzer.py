"""Randomized query generator + numpy oracle.

Reference parity: pinot-integration-test-base/.../QueryGenerator.java —
random queries over a fixed schema diffed against H2. Here the oracle
is an independent numpy evaluation of the structured QuerySpec (never a
re-parse of the SQL), and every spec runs through BOTH execution paths
(device kernels and OPTION(forceHostExecution=true)) so planner/kernel
divergence surfaces even when both disagree with each other.

Generated surface: SUM/COUNT/COUNT(col)/MIN/MAX/AVG/DISTINCTCOUNT over
int/double/nullable metrics; eq/neq/in/between/lt/gt/LIKE/IS NULL
predicates over low- and high-cardinality int and string dims; MV
membership predicates, MV group keys (row joins every value's group) and
COUNTMV/SUMMV; 0-2 group keys; HAVING; ORDER BY; enableNullHandling
toggles 2-valued vs 3-valued semantics; window functions
(SUM/COUNT/AVG/MIN/MAX OVER partition-only) on selection queries.

Failures are seed-reproducible: every spec carries the (seed, index)
that regenerates it.

Port of ``pinot_tpu/tools/fuzzer.py``: the same data, specs, SQL and
oracle for a seed, and a byte-equal segment from the port's builder;
``build_fuzz_segment`` loads it on ``device`` (default ``"cuda"``,
raising without it).
"""
from __future__ import annotations

import itertools
import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# column model the fixture table must match: (kind, cardinality/None)
COLUMNS = {
    "ci": ("int_dim", 7),          # low-card int dim
    "chi": ("int_dim", 500),       # high-card int dim
    "cs": ("str_dim", 5),          # string dim
    "m1": ("int_metric", None),
    "m2": ("double_metric", None),
    "nm": ("nullable_int_metric", None),
    "ns": ("nullable_str_dim", 4),
    "mv": ("mv_int_dim", 6),       # multi-value int dim
}

STR_POOL = ["alpha", "beta", "gamma", "delta", "epsi"]
NS_POOL = ["red", "green", "blue", "teal"]


def make_dim_data(n: int = 600, seed: int = 11) -> Dict[str, Any]:
    """The EXISTS-subquery side table (fzd): dk spans 0..5 while fz.ci
    spans 0..6 — ci == 6 rows have NO dim partner, so even
    unthresholded [NOT] EXISTS predicates exercise real semi/anti-join
    misses; dv is the local-filter column."""
    rng = np.random.default_rng(seed)
    return {
        "dk": rng.integers(0, 6, n).astype(np.int64),
        "dv": rng.integers(0, 100, n).astype(np.int64),
    }


def make_data(n: int, seed: int = 7) -> Dict[str, Any]:
    """Fixture columns (logical view: None = NULL, MV = lists)."""
    rng = np.random.default_rng(seed)
    nm = rng.integers(0, 50, n).astype(object)
    nm[rng.random(n) < 0.15] = None
    ns = rng.choice(NS_POOL, n).astype(object)
    ns[rng.random(n) < 0.2] = None
    return {
        "ci": rng.integers(0, 7, n).astype(np.int64),
        "chi": rng.integers(0, 500, n).astype(np.int64),
        "cs": rng.choice(STR_POOL, n),
        "m1": rng.integers(0, 1000, n).astype(np.int64),
        "m2": (rng.random(n) * 100).round(3),
        "nm": nm,
        "ns": ns,
        "mv": [sorted(set(rng.integers(0, 6, rng.integers(1, 4)).tolist()))
               for _ in range(n)],
    }


def fuzz_schema():
    """The Schema matching COLUMNS/make_data — the ONE definition every
    fuzz fixture builds from, so their coverage cannot silently
    diverge."""
    from ..spi import DataType, FieldSpec, FieldType, Schema
    return Schema("fz", [
        FieldSpec("ci", DataType.INT),
        FieldSpec("chi", DataType.INT),
        FieldSpec("cs", DataType.STRING),
        FieldSpec("m1", DataType.LONG, FieldType.METRIC),
        FieldSpec("m2", DataType.DOUBLE, FieldType.METRIC),
        FieldSpec("nm", DataType.LONG, FieldType.METRIC),
        FieldSpec("ns", DataType.STRING),
        FieldSpec("mv", DataType.INT, single_value=False),
    ])


def build_fuzz_segment(n: int, out_dir: str, name: str = "fz0",
                       seed: int = 7, device=None):
    """Build + load a one-segment 'fz' fixture over make_data(n), on
    ``device`` (default ``"cuda"``; raises without CUDA)."""
    from ..device import resolve_device
    from ..segment import SegmentBuilder
    from ..segment.immutable import ImmutableSegment
    from ..spi import TableConfig
    dev = resolve_device(device)
    d = SegmentBuilder(fuzz_schema(), TableConfig("fz")).build(
        make_data(n, seed), out_dir, name)
    return ImmutableSegment.load(d, dev)


@dataclass
class Pred:
    col: str
    op: str    # eq neq in between lt gt like is_null not_null
    #            exists not_exists (correlated: col = fzd.dk, value =
    #            optional dv-threshold local predicate)
    value: Any = None


@dataclass
class Agg:
    fn: str            # sum count count_col min max avg distinctcount
    col: Optional[str]  # None for COUNT(*)


@dataclass
class QuerySpec:
    kind: str                       # "agg" | "select" | "window"
    aggs: List[Agg] = field(default_factory=list)
    preds: List[Pred] = field(default_factory=list)
    group: List[str] = field(default_factory=list)
    select_cols: List[str] = field(default_factory=list)
    window: Optional[Tuple[str, str, str]] = None  # (fn, col, part_col)
    having_gt: Optional[float] = None   # HAVING first_agg > v
    order_by_keys: bool = False
    null_handling: bool = False
    # reproduce: QueryGenerator(seed, with_exists).generate() x (index+1)
    # — the flag is part of the tuple because it changes the draw stream
    seed: Tuple[int, int, bool] = (0, 0, False)


class QueryGenerator:
    """Seeded random specs over the COLUMNS model."""

    def __init__(self, seed: int, with_exists: bool = False):
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.count = 0
        self.with_exists = with_exists

    def _pred(self) -> Pred:
        r = self.rng
        if self.with_exists and r.random() < 0.12:
            op = str(r.choice(["exists", "not_exists"]))
            thresh = int(r.integers(1, 100)) if r.random() < 0.7 else None
            return Pred("ci", op, thresh)
        col = str(r.choice(["ci", "chi", "cs", "m1", "nm", "ns", "mv"]))
        if col == "cs":
            op = str(r.choice(["eq", "neq", "in", "like"]))
            if op == "like":
                return Pred(col, "like",
                            str(r.choice(["al%", "%ta", "%e%", "ep_i"])))
            if op == "in":
                k = int(r.integers(1, 4))
                return Pred(col, "in", sorted(
                    set(str(x) for x in r.choice(STR_POOL, k))))
            return Pred(col, op, str(r.choice(STR_POOL)))
        if col in ("nm", "ns"):
            op = str(r.choice(["is_null", "not_null", "eq"]))
            if op == "eq":
                v = int(r.integers(0, 50)) if col == "nm" \
                    else str(r.choice(NS_POOL))
                return Pred(col, "eq", v)
            return Pred(col, op)
        if col == "mv":
            return Pred(col, "eq", int(r.integers(0, 6)))
        hi = {"ci": 7, "chi": 500, "m1": 1000}[col]
        op = str(r.choice(["eq", "neq", "between", "lt", "gt", "in"]))
        if op == "between":
            a, b = sorted(r.integers(0, hi, 2).tolist())
            return Pred(col, "between", (int(a), int(b)))
        if op == "in":
            k = int(r.integers(1, 5))
            return Pred(col, "in",
                        sorted(set(int(x) for x in r.integers(0, hi, k))))
        return Pred(col, op, int(r.integers(0, hi)))

    def _agg(self) -> Agg:
        r = self.rng
        fn = str(r.choice(["sum", "count", "count_col", "min", "max",
                           "avg", "distinctcount", "summv", "countmv"]))
        if fn == "count":
            return Agg(fn, None)
        if fn in ("summv", "countmv"):
            return Agg(fn, "mv")
        if fn == "distinctcount":
            return Agg(fn, str(r.choice(["ci", "chi", "cs"])))
        col = str(r.choice(["m1", "m2", "nm"]))
        return Agg(fn, col)

    def generate(self) -> QuerySpec:
        r = self.rng
        idx = self.count
        self.count += 1
        kind = str(r.choice(["agg", "agg", "agg", "select", "window"]))
        spec = QuerySpec(kind=kind,
                         seed=(self.seed, idx, self.with_exists))
        spec.preds = [self._pred() for _ in range(int(r.integers(0, 4)))]
        spec.null_handling = bool(r.random() < 0.4)
        if kind == "agg":
            spec.aggs = [self._agg() for _ in range(int(r.integers(1, 4)))]
            if r.random() < 0.6:
                pool = ["ci", "cs", "chi", "mv"]
                k = int(r.integers(1, 3))
                spec.group = list(dict.fromkeys(
                    str(c) for c in r.choice(pool, k)))
                if "mv" in spec.group:
                    # MV group key + MV agg double-expands; keep one
                    spec.aggs = [a for a in spec.aggs
                                 if a.fn not in ("summv", "countmv")] \
                        or [Agg("count", None)]
                spec.order_by_keys = True
            if spec.group and r.random() < 0.3 and \
                    spec.aggs[0].fn in ("sum", "count", "count_col"):
                spec.having_gt = float(r.integers(0, 2000))
        elif kind == "select":
            pool = ["ci", "chi", "cs", "m1", "m2"]
            k = int(r.integers(1, 4))
            spec.select_cols = list(dict.fromkeys(
                str(c) for c in r.choice(pool, k)))
        else:  # window
            fn = str(r.choice(["sum", "count", "avg", "min", "max"]))
            spec.window = (fn, str(r.choice(["m1", "m2"])),
                           str(r.choice(["ci", "cs"])))
            spec.select_cols = ["chi", "m1"]
            spec.null_handling = False   # windows: 2vl surface only
        return spec


# ---------------------------------------------------------------------------
# SQL rendering
# ---------------------------------------------------------------------------

def _lit(v: Any) -> str:
    return f"'{v}'" if isinstance(v, str) else str(v)


def _pred_sql(p: Pred) -> str:
    if p.op == "eq":
        return f"{p.col} = {_lit(p.value)}"
    if p.op == "neq":
        return f"{p.col} != {_lit(p.value)}"
    if p.op == "lt":
        return f"{p.col} < {_lit(p.value)}"
    if p.op == "gt":
        return f"{p.col} > {_lit(p.value)}"
    if p.op == "between":
        return f"{p.col} BETWEEN {_lit(p.value[0])} AND {_lit(p.value[1])}"
    if p.op == "in":
        return f"{p.col} IN (" + ", ".join(_lit(v) for v in p.value) + ")"
    if p.op == "like":
        return f"{p.col} LIKE {_lit(p.value)}"
    if p.op in ("exists", "not_exists"):
        neg = "NOT " if p.op == "not_exists" else ""
        local = f" AND dv < {p.value}" if p.value is not None else ""
        return (f"{neg}EXISTS (SELECT dv FROM fzd "
                f"WHERE dk = {p.col}{local})")
    if p.op == "is_null":
        return f"{p.col} IS NULL"
    assert p.op == "not_null"
    return f"{p.col} IS NOT NULL"


def _agg_sql(a: Agg) -> str:
    if a.fn == "count":
        return "COUNT(*)"
    if a.fn == "count_col":
        return f"COUNT({a.col})"
    return f"{a.fn.upper()}({a.col})"


def render_sql(spec: QuerySpec) -> str:
    where = " WHERE " + " AND ".join(_pred_sql(p) for p in spec.preds) \
        if spec.preds else ""
    opts = " OPTION(timeoutMs=600000" + \
        (",enableNullHandling=true" if spec.null_handling else "") + ")"
    if spec.kind == "agg":
        sel = list(spec.group) + [_agg_sql(a) for a in spec.aggs]
        sql = f"SELECT {', '.join(sel)} FROM fz{where}"
        if spec.group:
            sql += " GROUP BY " + ", ".join(spec.group)
            if spec.having_gt is not None:
                sql += f" HAVING {_agg_sql(spec.aggs[0])} > " \
                       f"{spec.having_gt}"
            if spec.order_by_keys:
                sql += " ORDER BY " + ", ".join(spec.group)
            sql += " LIMIT 100000"
        return sql + opts
    if spec.kind == "select":
        sql = (f"SELECT {', '.join(spec.select_cols)} FROM fz{where}"
               " LIMIT 100000")
        return sql + opts
    fn, col, part = spec.window
    w = f"{fn.upper()}({col}) OVER (PARTITION BY {part})"
    return (f"SELECT {', '.join(spec.select_cols)}, {w} FROM fz{where}"
            " LIMIT 100000") + opts


# ---------------------------------------------------------------------------
# numpy oracle (independent evaluation of the spec)
# ---------------------------------------------------------------------------

def _pred_mask(p: Pred, data: Dict[str, Any], n: int,
               nh: bool, dim: Optional[Dict[str, Any]] = None
               ) -> np.ndarray:
    if p.op in ("exists", "not_exists"):
        assert dim is not None, "exists preds need the fzd fixture"
        dk = np.asarray(dim["dk"])
        if p.value is not None:
            dk = dk[np.asarray(dim["dv"]) < p.value]
        m = np.isin(np.asarray(data[p.col]), dk)
        return ~m if p.op == "not_exists" else m
    col = data[p.col]
    if p.col == "mv":
        if p.op != "eq":
            raise AssertionError("mv preds are eq-only")
        return np.array([p.value in row for row in col])
    nulls = None
    if p.col in ("nm", "ns"):
        nulls = np.array([v is None for v in col])
        # IS [NOT] NULL consults the null vector REGARDLESS of
        # enableNullHandling (Pinot NullPredicateEvaluator semantics;
        # the option governs comparison/aggregation 3VL, not these)
        if p.op == "is_null":
            return nulls
        if p.op == "not_null":
            return ~nulls
        # stored view: fill value participates when null handling is OFF
        fill = 0 if p.col == "nm" else "null"
        vals = np.array([fill if v is None else v for v in col])
    else:
        if p.op == "is_null":
            return np.zeros(n, dtype=bool)
        if p.op == "not_null":
            return np.ones(n, dtype=bool)
        vals = np.asarray(col)
    if p.op == "eq":
        m = vals == p.value
    elif p.op == "neq":
        m = vals != p.value
    elif p.op == "lt":
        m = vals < p.value
    elif p.op == "gt":
        m = vals > p.value
    elif p.op == "between":
        m = (vals >= p.value[0]) & (vals <= p.value[1])
    elif p.op == "in":
        m = np.isin(vals, list(p.value))
    elif p.op == "like":
        pat = ("^" + re.escape(p.value) + "$") \
            .replace("%", ".*").replace("_", ".")
        m = np.array([re.match(pat, s) is not None for s in vals])
    else:
        raise AssertionError(p.op)
    if nh and nulls is not None:
        m = m & ~nulls     # 3VL: null input never satisfies a predicate
    return m


def _metric_values(col: str, data, sel: np.ndarray,
                   nh: bool) -> np.ndarray:
    """Aggregation input values over selected rows (3VL drops nulls;
    the stored view fills them when null handling is off)."""
    raw = [data[col][i] for i in sel]
    if col == "nm":
        if nh:
            return np.array([v for v in raw if v is not None],
                            dtype=np.float64)
        return np.array([0 if v is None else v for v in raw],
                        dtype=np.float64)
    return np.asarray(raw, dtype=np.float64)


def _agg_value(a: Agg, data, sel: np.ndarray, nh: bool):
    if a.fn == "count":
        return len(sel)
    if a.fn == "countmv":
        return sum(len(data["mv"][i]) for i in sel)   # 0 on empty
    if a.fn == "summv":
        if len(sel) == 0:
            return None if nh else 0   # SUM over no input: null (3VL)
        return sum(v for i in sel for v in data["mv"][i])
    if a.fn == "distinctcount":
        return len({data[a.col][i] for i in sel})
    if a.fn == "count_col":
        if nh and a.col == "nm":
            return sum(1 for i in sel if data[a.col][i] is not None)
        return len(sel)
    vals = _metric_values(a.col, data, sel, nh)
    if vals.size == 0:
        if a.fn == "sum":
            # empty or all-null input: SQL SUM is null under 3VL, the
            # stored-view 0 when null handling is off
            return None if nh else 0
        return None
    if a.fn == "sum":
        return float(vals.sum())
    if a.fn == "min":
        return float(vals.min())
    if a.fn == "max":
        return float(vals.max())
    assert a.fn == "avg"
    return float(vals.mean())


def oracle_rows(spec: QuerySpec, data: Dict[str, Any],
                n: int, dim: Optional[Dict[str, Any]] = None
                ) -> List[tuple]:
    nh = spec.null_handling
    mask = np.ones(n, dtype=bool)
    for p in spec.preds:
        mask &= _pred_mask(p, data, n, nh, dim)
    sel = np.nonzero(mask)[0]
    if spec.kind == "select":
        return [tuple(data[c][i] for c in spec.select_cols) for i in sel]
    if spec.kind == "window":
        fn, col, part = spec.window
        parts: Dict[Any, List[int]] = {}
        for i in sel:
            parts.setdefault(data[part][i], []).append(i)
        wv: Dict[Any, float] = {}
        for k, idxs in parts.items():
            vals = np.asarray([data[col][i] for i in idxs],
                              dtype=np.float64)
            wv[k] = {"sum": vals.sum(), "count": len(vals),
                     "avg": vals.mean(), "min": vals.min(),
                     "max": vals.max()}[fn]
        return [tuple([data[c][i] for c in spec.select_cols]
                      + [float(wv[data[part][i]])]) for i in sel]
    # aggregation
    if not spec.group:
        return [tuple(_agg_value(a, data, sel, nh) for a in spec.aggs)]
    # group rows (MV key: row joins every value's group)
    groups: Dict[tuple, List[int]] = {}
    for i in sel:
        keys = [[v] if c != "mv" else data["mv"][i]
                for c, v in ((c, data[c][i]) for c in spec.group)]
        for combo in itertools.product(*keys):
            groups.setdefault(tuple(combo), []).append(i)
    out = []
    for key, idxs in groups.items():
        vals = [_agg_value(a, data, np.asarray(idxs), nh)
                for a in spec.aggs]
        if spec.having_gt is not None and not (
                vals[0] is not None and vals[0] > spec.having_gt):
            continue
        out.append(tuple(key) + tuple(vals))
    return out


def digest(rows: List[tuple]) -> List[tuple]:
    """Comparable row multiset: floats rounded to relative 1e-9."""
    def norm(v):
        if v is None:
            return ("null",)
        if isinstance(v, (list, tuple)):
            return tuple(norm(x) for x in v)
        if isinstance(v, (float, int, np.floating, np.integer)):
            if isinstance(v, float) and math.isnan(v):
                return ("nan",)
            return ("f", round(float(v), 6) if abs(v) < 1 else
                    round(float(v), max(0, 9 - int(
                        math.log10(abs(v))))))
        return (str(v),)
    return sorted(tuple(norm(v) for v in r) for r in rows)
