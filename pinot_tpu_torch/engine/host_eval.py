"""Host (numpy) evaluation: the vectorized CPU fallback path.

Covers what the device kernels don't yet: selection queries, group-by on
raw/expression keys, very-high-cardinality group-by, DISTINCTCOUNT on raw
columns. Reference parity: this is the role ScanBasedFilterOperator +
SelectionOnlyOperator + NoDictionaryGroupKeyGenerator play in pinot-core —
the general path behind the optimized ones. Everything here is vectorized
numpy over the segment memmaps; no Python-per-row loops.

Port of ``pinot_tpu/engine/host_eval.py`` (numpy, no device code), with
the index predicates (TEXT_MATCH, JSON_MATCH, VECTOR_SIMILARITY through
index/predicates.py), VECTOR_SIMILARITY as a value (engine/vector_exec's
exact host scores) and the inverted- and range-index shortcuts of the
filter scan. Geo index predicates come with the geo index.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..query.context import AggExpr, QueryContext
from ..query.sql import (Between, BinaryOp, BoolAnd, BoolNot, BoolOr,
                         CaseWhen, Cast, Comparison, FuncCall, Identifier,
                         InList, IsNull, Like, Literal, SqlError, Star)
from ..query import functions as F
from ..ops import aggregations
from ..segment.immutable import ImmutableSegment


def virtual_column(seg, name: str) -> Optional[np.ndarray]:
    """$docId / $segmentName / $hostName (segment/virtualcolumn/
    VirtualColumnProvider analog) — synthesized, never stored."""
    if name == "$docId":
        return np.arange(seg.n_docs, dtype=np.int64)
    if name == "$segmentName":
        return np.full(seg.n_docs, seg.name, dtype=object)
    if name == "$hostName":
        import socket
        return np.full(seg.n_docs, socket.gethostname(), dtype=object)
    return None


def eval_value(e: Any, seg: ImmutableSegment,
               sel: Optional[np.ndarray] = None) -> np.ndarray:
    """Evaluate a value expression to a numpy array over (selected) docs."""
    if isinstance(e, Identifier):
        if e.name.startswith("$"):
            vc = virtual_column(seg, e.name)
            if vc is None:
                raise SqlError(f"unknown virtual column {e.name!r}")
            return vc[sel] if sel is not None else vc
        vals = seg.raw_values(e.name)
        return vals[sel] if sel is not None else vals
    if isinstance(e, Literal):
        return np.asarray(e.value)
    if isinstance(e, BinaryOp):
        l = eval_value(e.lhs, seg, sel)
        r = eval_value(e.rhs, seg, sel)
        if e.op == "+":
            return l + r
        if e.op == "-":
            return l - r
        if e.op == "*":
            return l * r
        if e.op == "/":
            return l.astype(np.float64) / np.asarray(r, dtype=np.float64)
        if e.op == "%":
            return l % r
        raise SqlError(f"unknown op {e.op}")
    if isinstance(e, FuncCall):
        return _eval_func(e, seg, sel)
    if isinstance(e, CaseWhen):
        return _eval_case(e, seg, sel)
    if isinstance(e, Cast):
        return F.cast_value(eval_value(e.expr, seg, sel), e.type_name)
    raise SqlError(f"unsupported value expression {e!r}")


def _eval_func(e: FuncCall, seg: ImmutableSegment,
               sel: Optional[np.ndarray]) -> np.ndarray:
    if e.name == "vector_similarity":
        # VECTOR_SIMILARITY as a VALUE (ORDER BY score / select-list
        # column): exact per-doc similarity over the selected rows; the
        # candidate selection already ran on the device through the
        # filter's memoized search (engine/vector_exec.py)
        from .vector_exec import order_scores
        return order_scores(seg, e, sel)
    fd = F.lookup(e.name)
    if fd is None:
        raise SqlError(f"unknown function {e.name!r}")
    # dictionary fast path (TransformFunction-over-dictionary analog):
    # an elementwise function of one dict-encoded column evaluates once per
    # dictionary value, then gathers by dict id — O(cardinality) not O(rows)
    col_args = [a for a in e.args if not isinstance(a, Literal)]
    if (fd.elementwise and len(col_args) == 1
            and isinstance(col_args[0], Identifier)):
        name = col_args[0].name
        m = seg.columns.get(name)
        if m is not None and m.has_dict and \
                not getattr(m, "is_multi_value", False):
            d = seg.dictionary(name)
            dvals = np.asarray(d.values)
            args = [dvals if a is col_args[0] else a.value for a in e.args]
            per_value = np.asarray(F.call(e.name, *args))
            if per_value.ndim == 1 and len(per_value) == len(dvals):
                ids = np.asarray(seg.fwd(name)).astype(np.int64)
                if sel is not None:
                    ids = ids[sel]
                return per_value[ids]
    args = [a.value if isinstance(a, Literal) else eval_value(a, seg, sel)
            for a in e.args]
    return np.asarray(F.call(e.name, *args))


def _eval_case(e: CaseWhen, seg: ImmutableSegment,
               sel: Optional[np.ndarray]) -> np.ndarray:
    conds = []
    vals = []
    for cond, res in e.whens:
        m = eval_filter(cond, seg)
        conds.append(m[sel] if sel is not None else m)
        vals.append(np.asarray(eval_value(res, seg, sel)))
    if e.else_ is not None:
        default = np.asarray(eval_value(e.else_, seg, sel))
    else:
        stringy = any(v.dtype == object or v.dtype.kind in "US"
                      for v in vals)
        default = np.asarray(None if stringy else np.nan)
    n = len(conds[0])
    vals = [np.broadcast_to(v, (n,)) for v in vals]
    default = np.broadcast_to(default, (n,))
    return np.select(conds, vals, default=default)


def null_aware(ctx) -> bool:
    """The enableNullHandling query option (QueryOptionsUtils analog).
    Accepts anything with .options (QueryContext or SelectStmt); shares
    the option-truthiness parser with the planner."""
    from ..query.planner import _truthy
    return _truthy(ctx.options.get("enableNullHandling"))


def expr_null_mask(e: Any, seg) -> Optional[np.ndarray]:
    """Union of null masks of every column referenced by e (a row is null
    for the expression if any input is null — SQL null propagation)."""
    from ..query.sql import collect_identifiers
    m: Optional[np.ndarray] = None
    for name in collect_identifiers(e):
        if name.startswith("$"):
            continue  # virtual columns are never null
        nm = seg.null_mask(name)
        if nm is not None:
            m = nm.copy() if m is None else (m | nm)
    return m


def eval_filter_3vl(e: Any, seg) -> Tuple[np.ndarray, np.ndarray]:
    """Three-valued-logic filter evaluation for enableNullHandling.

    Returns (T, F): rows where the predicate is definitely TRUE and
    definitely FALSE; the rest are UNKNOWN (some input was null). Mirrors
    Pinot's null-handling predicate semantics: a row passes the filter
    only when the predicate is TRUE. NOT maps UNKNOWN to UNKNOWN
    (T/F swap), AND/OR follow Kleene logic.
    """
    n = seg.n_docs
    if e is None:
        return np.ones(n, dtype=bool), np.zeros(n, dtype=bool)
    if isinstance(e, BoolAnd):
        T = np.ones(n, dtype=bool)
        F = np.zeros(n, dtype=bool)
        for c in e.children:
            t, f = eval_filter_3vl(c, seg)
            T &= t
            F |= f
        return T, F
    if isinstance(e, BoolOr):
        T = np.zeros(n, dtype=bool)
        F = np.ones(n, dtype=bool)
        for c in e.children:
            t, f = eval_filter_3vl(c, seg)
            T |= t
            F &= f
        return T, F
    if isinstance(e, BoolNot):
        t, f = eval_filter_3vl(e.child, seg)
        return f, t
    if isinstance(e, IsNull):
        nm = expr_null_mask(e.expr, seg)
        if nm is None:
            nm = np.zeros(n, dtype=bool)
        t = ~nm if e.negated else nm
        return t, ~t  # IS [NOT] NULL never yields UNKNOWN
    # leaf predicate: evaluate two-valued, then mark null inputs UNKNOWN.
    # negated leaves (NOT BETWEEN / NOT IN / NOT LIKE) stay UNKNOWN on null
    # inputs because both T and F are masked by `valid`.
    m = eval_filter(e, seg)
    nm = expr_null_mask(e, seg)
    if nm is None:
        return m, ~m
    valid = ~nm
    return m & valid, ~m & valid


def _like_regex(pattern: str) -> "re.Pattern":
    out = []
    for ch in pattern:
        out.append(".*" if ch == "%" else "." if ch == "_" else re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _mv_meta(seg: ImmutableSegment, e: Any):
    if isinstance(e, Identifier):
        m = seg.columns.get(e.name)
        if m is not None and not getattr(m, "single_value", True):
            return m
    return None


def _mv_pred_mask(seg: ImmutableSegment, name: str, op: str,
                  val: Any) -> np.ndarray:
    """Any-over-values predicate on an MV column, in dict-id space (the
    host peer of kernels._mv_any; pad id -1 is inert)."""
    ids = np.asarray(seg.fwd(name))          # (n, M)
    d = seg.dictionary(name)
    svals = np.asarray(d.values)
    m = seg.columns[name]

    def coerce(v):
        if m.data_type.is_numeric and isinstance(v, str):
            return float(v) if ("." in v or "e" in v.lower()) else int(v)
        if not m.data_type.is_numeric:
            return str(v)
        return v

    if op in ("range", "not_range"):  # val = (lo, hi) incl; elementwise
        lo_v, hi_v = coerce(val[0]), coerce(val[1])
        lo = int(np.searchsorted(svals, lo_v, side="left"))
        hi = int(np.searchsorted(svals, hi_v, side="right"))
        inside = (ids >= lo) & (ids < hi)
        if op == "range":
            return inside.any(axis=1)
        # NOT BETWEEN: any value outside (value-level negation, reference
        # NotBetween applyMV); pads stay excluded
        return (~inside & (ids >= 0)).any(axis=1)
    if op == "not_in":     # val = list; any value not in the set
        dids = [d.index_of(coerce(v)) for v in val]
        hit = np.isin(ids, [i for i in dids if i >= 0])
        return (~hit & (ids >= 0)).any(axis=1)
    val = coerce(val)
    if op == "==":
        i = d.index_of(val)
        return (ids == i).any(axis=1) if i >= 0 \
            else np.zeros(len(ids), dtype=bool)
    if op == "!=":         # any value differs (value-level negation)
        i = d.index_of(val)
        return ((ids != i) & (ids >= 0)).any(axis=1)
    if op == "<":
        hi = int(np.searchsorted(svals, val, side="left"))
        return ((ids >= 0) & (ids < hi)).any(axis=1)
    if op == "<=":
        hi = int(np.searchsorted(svals, val, side="right"))
        return ((ids >= 0) & (ids < hi)).any(axis=1)
    if op == ">":
        lo = int(np.searchsorted(svals, val, side="right"))
        return (ids >= lo).any(axis=1)
    assert op == ">=", op
    lo = int(np.searchsorted(svals, val, side="left"))
    return (ids >= lo).any(axis=1)


def eval_filter(e: Any, seg: ImmutableSegment) -> np.ndarray:
    n = seg.n_docs
    if e is None:
        return np.ones(n, dtype=bool)
    if isinstance(e, BoolAnd):
        m = eval_filter(e.children[0], seg)
        for c in e.children[1:]:
            m = m & eval_filter(c, seg)
        return m
    if isinstance(e, BoolOr):
        m = eval_filter(e.children[0], seg)
        for c in e.children[1:]:
            m = m | eval_filter(c, seg)
        return m
    if isinstance(e, BoolNot):
        return ~eval_filter(e.child, seg)
    if isinstance(e, Comparison):
        mvm = _mv_meta(seg, e.lhs)
        if mvm is not None and isinstance(e.rhs, Literal):
            return _mv_pred_mask(seg, e.lhs.name, e.op, e.rhs.value)
        # InvertedIndexFilterOperator analog: EQ/NEQ on a dict column with
        # an inverted index answers in O(selectivity) from posting lists
        if e.op in ("==", "!=") and isinstance(e.lhs, Identifier) \
                and isinstance(e.rhs, Literal):
            m = seg.columns.get(e.lhs.name)
            if m is not None and getattr(m, "has_dict", False) \
                    and "inverted" in getattr(m, "indexes", {}):
                # coerce the literal like the scan path (_align_str) does;
                # on a non-coercible literal fall through so the scan path
                # raises the same SqlError as without the index
                val = e.rhs.value
                if m.data_type.is_numeric and isinstance(val, str):
                    try:
                        val = float(val) if ("." in val or "e" in val.lower()
                                            ) else int(val)
                    except ValueError:
                        val = None
                elif not m.data_type.is_numeric:
                    val = str(val)
                if val is not None:
                    d = seg.dictionary(e.lhs.name)
                    did = d.index_of(val)
                    mask = seg.index_reader(e.lhs.name, "inverted") \
                        .mask_for_ids([did] if did >= 0 else [], n)
                    return ~mask if e.op == "!=" else mask
        # RangeIndexBasedFilterOperator analog: chunk zone maps on raw
        # numeric columns let the scan skip non-candidate chunks entirely
        if e.op in ("<", "<=", ">", ">=", "==") \
                and isinstance(e.lhs, Identifier) \
                and isinstance(e.rhs, Literal) \
                and isinstance(e.rhs.value, (int, float)) \
                and not isinstance(e.rhs.value, bool):
            m = seg.columns.get(e.lhs.name)
            if m is not None and not getattr(m, "has_dict", False) \
                    and "range" in getattr(m, "indexes", {}):
                rd = seg.index_reader(e.lhs.name, "range")
                v = e.rhs.value
                lo, hi = {"<": (None, v), "<=": (None, v), ">": (v, None),
                          ">=": (v, None), "==": (v, v)}[e.op]
                np_op = {"==": np.equal, "<": np.less, "<=": np.less_equal,
                         ">": np.greater, ">=": np.greater_equal}[e.op]
                vals = np.asarray(seg.fwd(e.lhs.name))
                cand = rd.candidate_mask(lo, hi, n)
                mask = np.zeros(n, dtype=bool)
                mask[cand] = np_op(vals[:n][cand], v)
                return mask
        l = eval_value(e.lhs, seg)
        r = eval_value(e.rhs, seg)
        l, r = _align_str(l, r)
        ops = {"==": np.equal, "!=": np.not_equal, "<": np.less,
               "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}
        return np.broadcast_to(ops[e.op](l, r), (n,)).copy()
    if isinstance(e, Between):
        if _mv_meta(seg, e.expr) is not None \
                and isinstance(e.lo, Literal) and isinstance(e.hi, Literal):
            return _mv_pred_mask(seg, e.expr.name,
                                 "not_range" if e.negated else "range",
                                 (e.lo.value, e.hi.value))
        v = eval_value(e.expr, seg)
        lo = eval_value(e.lo, seg)
        hi = eval_value(e.hi, seg)
        v, lo = _align_str(v, lo)
        v, hi = _align_str(v, hi)
        m = (v >= lo) & (v <= hi)
        return ~m if e.negated else m
    if isinstance(e, InList):
        if _mv_meta(seg, e.expr) is not None:
            if e.negated:
                return _mv_pred_mask(seg, e.expr.name, "not_in",
                                     [x.value for x in e.values])
            m = np.zeros(seg.n_docs, dtype=bool)
            for x in e.values:
                m |= _mv_pred_mask(seg, e.expr.name, "==", x.value)
            return m
        v = eval_value(e.expr, seg)
        vals = [x.value for x in e.values]
        if v.dtype == object:
            vset = {str(x) for x in vals}
            m = np.asarray([x in vset for x in v], dtype=bool)
        else:
            m = np.isin(v, np.asarray(vals))
        return ~m if e.negated else m
    if isinstance(e, Like):
        v = eval_value(e.expr, seg)
        rx = _like_regex(e.pattern)
        # evaluate once per dictionary value when possible
        if isinstance(e.expr, Identifier) and \
                seg.columns[e.expr.name].has_dict:
            d = seg.dictionary(e.expr.name)
            ok = np.asarray([bool(rx.match(str(x))) for x in d.values])
            m = ok[np.asarray(seg.fwd(e.expr.name)).astype(np.int64)]
        else:
            m = np.asarray([bool(rx.match(str(x))) for x in v], dtype=bool)
        return ~m if e.negated else m
    if isinstance(e, IsNull):
        if isinstance(e.expr, Identifier):
            nm = seg.null_mask(e.expr.name)
            m = nm if nm is not None else np.zeros(n, dtype=bool)
        else:
            m = np.zeros(n, dtype=bool)
        return ~m if e.negated else m
    if isinstance(e, Literal) and isinstance(e.value, bool):
        return np.full(n, e.value, dtype=bool)
    if isinstance(e, FuncCall):
        from ..index.predicates import try_index_filter_mask
        idx_mask = try_index_filter_mask(seg, e)
        if idx_mask is not None:
            return idx_mask
    if isinstance(e, (FuncCall, Identifier, Cast, CaseWhen)):
        # boolean-valued expression used as a predicate
        # (startsWith(col, 'x'), boolean column, ...)
        v = np.asarray(eval_value(e, seg))
        if v.dtype != bool:
            v = v.astype(bool)
        return np.broadcast_to(v, (n,)).copy()
    raise SqlError(f"unsupported filter {e!r}")


def _align_str(l: np.ndarray, r: np.ndarray):
    l, r = np.asarray(l), np.asarray(r)
    l_str = l.dtype == object or l.dtype.kind in "US"
    r_str = r.dtype == object or r.dtype.kind in "US"
    if l_str and r_str:
        return (np.asarray(l, dtype=object).astype(str),
                np.asarray(r, dtype=object).astype(str))
    if l_str != r_str:
        # numeric column vs string literal: coerce the string side
        # (BadQueryRequestException analog on failure)
        s, n = (l, r) if l_str else (r, l)
        try:
            s_num = s.astype(np.float64)
        except ValueError:
            raise SqlError(
                f"cannot compare numeric and non-numeric value "
                f"{s.reshape(-1)[:1]}") from None
        return (s_num, n) if l_str else (n, s_num)
    return l, r


# ---------------------------------------------------------------------------
# host aggregation / group-by over a selected doc set
# ---------------------------------------------------------------------------

def host_aggregate(ctx: QueryContext, seg: ImmutableSegment,
                   mask: np.ndarray) -> List[Any]:
    """Per-segment states for ctx.aggregations (mergeable, value-space)."""
    sel = np.nonzero(mask)[0]
    na = null_aware(ctx)
    states: List[Any] = []
    for agg in ctx.aggregations:
        sel2 = _agg_sel(agg, seg, sel, na)
        s = _agg_state(agg, seg, sel2, na)
        if na and agg.kind in ("sum", "sum_mv") and len(sel2) == 0:
            s = None  # SUM over all-null input is null, not 0
            # (COUNT_MV stays 0 — count semantics)
        states.append(s)
    return states


def _agg_keep(agg: AggExpr, seg, sel: np.ndarray) -> Optional[np.ndarray]:
    """Boolean keep-mask over sel dropping rows whose aggregation input is
    null (NullableSingleInputAggregationFunction semantics); None when the
    inputs have no nulls. COUNT(*) (arg None) keeps every filtered row."""
    nm = None
    for arg in (agg.arg, agg.arg2):
        if arg is None or isinstance(arg, tuple):
            # tuple = funnel step predicates; a null input makes the
            # predicate false (SQL three-valued logic), not a skipped row
            continue
        m = expr_null_mask(arg, seg)
        if m is not None:
            nm = m if nm is None else (nm | m)
    return None if nm is None else ~nm[sel]


def _agg_sel(agg: AggExpr, seg, sel: np.ndarray, na: bool) -> np.ndarray:
    if not na:
        return sel
    keep = _agg_keep(agg, seg, sel)
    return sel if keep is None else sel[keep]


def _require_numeric(agg: AggExpr, vals: np.ndarray,
                     kinds: tuple) -> None:
    """Typed SqlError (not a raw numpy ValueError) when a numeric-only
    aggregation is fed a string expression — reference behavior: Pinot
    rejects SUM/AVG over STRING at plan time."""
    if agg.kind in kinds and vals.dtype.kind in "USO":
        raise SqlError(f"{agg.kind.upper()} requires numeric input; "
                       f"{agg.arg!r} is a string expression")


def _typed_ev(impl, agg: AggExpr, seg, sel: np.ndarray):
    """HostSel evaluator that rejects string inputs to numeric-only
    registry impls with a typed SqlError BEFORE the impl's math sees
    them (no numpy-message sniffing; impls that legitimately take
    strings set numeric_input = False)."""
    def ev(ast):
        vals = eval_value(ast, seg, sel)
        if impl.numeric_input and vals.dtype.kind in "USO":
            raise SqlError(f"{agg.kind.upper()} requires numeric input; "
                           f"{ast!r} is a string expression")
        return vals
    return ev


def _bool_ev(seg, sel: np.ndarray, na: bool = False):
    """HostSel.ev_bool: a boolean predicate AST evaluated over the
    selected docs (funnel step expressions). Under enableNullHandling
    only definitely-TRUE rows match (3VL: a null input never satisfies
    a step predicate)."""
    def ev_bool(ast):
        if na:
            t, _f = eval_filter_3vl(ast, seg)
            return np.asarray(t, dtype=bool)[sel]
        return np.asarray(eval_filter(ast, seg), dtype=bool)[sel]
    return ev_bool


def _agg_state(agg: AggExpr, seg: ImmutableSegment, sel: np.ndarray,
               na: bool = False) -> Any:
    if agg.kind == "count":
        return int(len(sel))
    # registry first: MV variants of extended kinds (hll_mv, ...) carry
    # their own impls; the classic six _mv kinds fall through (make ->
    # None) to the hand-coded path below
    impl = aggregations.make(agg)
    if impl is not None:
        h = aggregations.HostSel(_typed_ev(impl, agg, seg, sel), len(sel),
                                 ev_bool=_bool_ev(seg, sel, na))
        return impl.state(h)
    if agg.kind.endswith("_mv"):
        return _mv_agg_state(agg, seg, sel)
    vals = eval_value(agg.arg, seg, sel)
    _require_numeric(agg, vals, ("sum", "avg"))
    if agg.kind == "sum":
        if len(sel) == 0:
            return 0
        if np.issubdtype(vals.dtype, np.integer):
            return int(vals.astype(np.int64).sum())
        return float(vals.astype(np.float64).sum())
    if agg.kind in ("min", "max") and vals.dtype.kind in "USO":
        # lexicographic string min/max (numpy 2.x has no unicode
        # minimum ufunc — use the builtin over the selected values)
        if len(sel) == 0:
            return None
        pick = min if agg.kind == "min" else max
        return _scalar(pick(vals))
    if agg.kind == "min":
        return None if len(sel) == 0 else _scalar(vals.min())
    if agg.kind == "max":
        return None if len(sel) == 0 else _scalar(vals.max())
    if agg.kind == "avg":
        if len(sel) == 0:
            return (0.0, 0)
        return (float(vals.astype(np.float64).sum()), int(len(sel)))
    if agg.kind == "distinct_count":
        return set(np.unique(vals).tolist())
    raise SqlError(f"unknown aggregation {agg.kind}")


def _mv_agg_state(agg: AggExpr, seg: ImmutableSegment,
                  sel: np.ndarray) -> Any:
    """States for the MV aggregation family over list-valued rows (the
    host peer of the MvReduce device lowering; states match the base
    kind's — ops/aggregations.MV_BASE_KIND)."""
    rows = eval_value(agg.arg, seg, sel)  # object array of per-row lists
    return _mv_state_from_rows(agg.kind, rows)


def _mv_state_from_rows(k: str, rows) -> Any:
    if len(rows) and not isinstance(rows[0], (list, tuple, np.ndarray)):
        # single-value input would iterate characters (strings) or crash
        raise SqlError(f"{k.upper()} requires a multi-value column")
    if k == "count_mv":
        return int(sum(len(r) for r in rows))
    if k == "distinct_count_mv":
        out: set = set()
        for r in rows:
            out.update(_scalar(v) for v in r)
        return out
    flat = [v for r in rows for v in r]
    if k == "sum_mv":
        if not flat:
            return 0
        s = sum(flat)
        return int(s) if isinstance(s, (int, np.integer)) else float(s)
    if k == "min_mv":
        return _scalar(min(flat)) if flat else None
    if k == "max_mv":
        return _scalar(max(flat)) if flat else None
    if k == "avg_mv":
        return (float(sum(flat)), len(flat)) if flat else (0.0, 0)
    raise SqlError(f"unknown MV aggregation {k}")


def _scalar(v: Any) -> Any:
    return v.item() if isinstance(v, np.generic) else v


def _unique_inverse(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """np.unique(return_inverse) with a bytes-view fast path for
    fixed-width unicode keys: sorting UCS4 strings is the costliest op
    of a string group-by, but the same factorization falls out of an
    integer view (memcmp order) at a fraction of the cost. The small
    distinct set is then re-sorted lexicographically and codes remapped,
    so callers observe exact np.unique semantics."""
    if v.dtype.kind == "U" and v.dtype.itemsize in (4, 8) \
            and len(v) > 4096:
        iv = np.ascontiguousarray(v).view(
            np.int32 if v.dtype.itemsize == 4 else np.int64)
        ub, inv0 = np.unique(iv, return_inverse=True)
        reps = ub.view(v.dtype)
        order = np.argsort(reps, kind="stable")
        rank = np.empty(len(order), dtype=inv0.dtype)
        rank[order] = np.arange(len(order), dtype=inv0.dtype)
        return reps[order], rank[inv0]
    return np.unique(v, return_inverse=True)


def host_group_by(ctx: QueryContext, seg: ImmutableSegment,
                  mask: np.ndarray) -> Dict[Tuple, List[Any]]:
    """Vectorized hash group-by: composite codes from per-key np.unique,
    np.bincount / ufunc.at per aggregation. IndexedTable-general analog."""
    sel = np.nonzero(mask)[0]
    nsel = len(sel)
    if nsel == 0:
        return {}
    na = null_aware(ctx)

    # MV group key: a row joins EVERY group of its values (reference MV
    # GroupKeyGenerator semantics) — expand matched rows to (row, value)
    # pairs; SV keys and aggregation inputs repeat per pair
    mv_flat: Dict[int, np.ndarray] = {}
    mv_keys = [ki for ki, g in enumerate(ctx.group_by)
               if isinstance(g, Identifier)
               and g.name in seg.columns
               and not getattr(seg.columns[g.name], "single_value", True)]
    if len(mv_keys) > 1:
        raise SqlError("GROUP BY supports at most one multi-value column")
    if mv_keys:
        ki = mv_keys[0]
        rows = eval_value(ctx.group_by[ki], seg, sel)
        lens = np.fromiter((len(r) for r in rows), dtype=np.int64,
                           count=len(rows))
        sel = np.repeat(sel, lens)
        nsel = len(sel)
        if nsel == 0:
            return {}
        flat = [v for r in rows for v in r]
        mv_flat[ki] = np.asarray(flat)

    codes = np.zeros(nsel, dtype=np.int64)
    uniques: List[Tuple[np.ndarray, bool]] = []
    for ki, g in enumerate(ctx.group_by):
        v = mv_flat[ki] if ki in mv_flat else eval_value(g, seg, sel)
        if v.dtype == object:
            v = v.astype(str)
        nm = expr_null_mask(g, seg) if na else None
        f = nm[sel] if nm is not None else None
        if f is not None and f.any():
            # null keys form their own group: encode the null flag as an
            # extra factor so the stored default value never collides
            vv = v.copy()
            vv[f] = vv[~f][0] if (~f).any() else vv[0]
            u, inv = _unique_inverse(vv)
            codes = (codes * len(u) + inv) * 2 + f
            uniques.append((u, True))
        else:
            u, inv = _unique_inverse(v)
            codes = codes * len(u) + inv
            uniques.append((u, False))
    ucodes, inv = np.unique(codes, return_inverse=True)
    n_groups = len(ucodes)

    # decode group keys: recover per-key value by walking codes backwards
    key_cols: List[List[Any]] = []
    rem = ucodes.copy()
    for u, has_null_flag in reversed(uniques):
        if has_null_flag:
            flag = rem % 2
            rem = rem // 2
            vals = u[rem % len(u)]
            key_cols.append([None if flag[i] else _scalar(vals[i])
                             for i in range(n_groups)])
        else:
            key_cols.append([_scalar(x) for x in (u[rem % len(u)])])
        rem = rem // len(u)
    key_cols.reverse()
    keys = list(zip(*key_cols))

    out: Dict[Tuple, List[Any]] = {tuple(k): [] for k in keys}
    na = null_aware(ctx)
    for agg in ctx.aggregations:
        keep = _agg_keep(agg, seg, sel) if na else None
        if keep is None or keep.all():
            per_group = _group_states(agg, seg, sel, inv, n_groups, na)
        else:
            per_group = _group_states(agg, seg, sel[keep], inv[keep],
                                      n_groups, na)
            if agg.kind in ("sum", "min", "max", "avg"):
                # groups whose inputs were all null -> null result, not a
                # sentinel from the empty reduction
                cnt = np.bincount(inv[keep], minlength=n_groups)
                per_group = [None if cnt[gi] == 0 else per_group[gi]
                             for gi in range(n_groups)]
        for gi, k in enumerate(keys):
            out[tuple(k)].append(per_group[gi])
    return out


def _group_states(agg: AggExpr, seg: ImmutableSegment, sel: np.ndarray,
                  inv: np.ndarray, n_groups: int,
                  na: bool = False) -> List[Any]:
    if agg.kind == "count":
        c = np.bincount(inv, minlength=n_groups)
        return [int(x) for x in c]
    impl = aggregations.make(agg)  # extended registry kinds (MV incl.)
    if impl is not None:
        h = aggregations.HostSel(_typed_ev(impl, agg, seg, sel),
                                 len(sel), inv, n_groups,
                                 ev_bool=_bool_ev(seg, sel, na))
        return impl.group_states(h)
    if agg.kind.endswith("_mv"):
        # evaluate the MV column ONCE, then sort-split — calling
        # _mv_agg_state per group would re-decode the whole MV forward
        # index per group (O(n_groups * n), seconds at a few hundred
        # groups; round-4 fuzzer finding)
        rows_all = eval_value(agg.arg, seg, sel)
        order = np.argsort(inv, kind="stable")
        bounds = np.searchsorted(inv[order], np.arange(n_groups + 1))
        sorted_rows = rows_all[order]
        return [_mv_state_from_rows(agg.kind,
                                    sorted_rows[bounds[gi]:bounds[gi + 1]])
                for gi in range(n_groups)]
    vals = eval_value(agg.arg, seg, sel)
    _require_numeric(agg, vals, ("sum", "avg"))
    if agg.kind in ("min", "max") and vals.dtype.kind in "USO":
        # lexicographic string min/max per group (matches the ungrouped
        # path's vals.min()/.max() semantics) via one stable sort-split
        order = np.argsort(inv, kind="stable")
        sv, si = vals[order], inv[order]
        bounds = np.searchsorted(si, np.arange(n_groups + 1))
        pick = min if agg.kind == "min" else max
        return [_scalar(pick(sv[bounds[g]:bounds[g + 1]]))
                if bounds[g + 1] > bounds[g] else None
                for g in range(n_groups)]
    if agg.kind == "sum":
        if np.issubdtype(vals.dtype, np.integer):
            s2 = np.zeros(n_groups, dtype=np.int64)  # exact int accumulation
            np.add.at(s2, inv, vals.astype(np.int64))
            return [int(x) for x in s2]
        s = np.bincount(inv, weights=vals.astype(np.float64),
                        minlength=n_groups)
        return [float(x) for x in s]
    if agg.kind == "min":
        m = np.full(n_groups, np.inf)
        np.minimum.at(m, inv, vals.astype(np.float64))
        if np.issubdtype(vals.dtype, np.integer):
            mi = np.full(n_groups, np.iinfo(np.int64).max, dtype=np.int64)
            np.minimum.at(mi, inv, vals.astype(np.int64))
            return [int(x) for x in mi]
        return [float(x) for x in m]
    if agg.kind == "max":
        if np.issubdtype(vals.dtype, np.integer):
            ma = np.full(n_groups, np.iinfo(np.int64).min, dtype=np.int64)
            np.maximum.at(ma, inv, vals.astype(np.int64))
            return [int(x) for x in ma]
        m = np.full(n_groups, -np.inf)
        np.maximum.at(m, inv, vals.astype(np.float64))
        return [float(x) for x in m]
    if agg.kind == "avg":
        s = np.zeros(n_groups, dtype=np.float64)
        np.add.at(s, inv, vals.astype(np.float64))
        c = np.bincount(inv, minlength=n_groups)
        return [(float(s[i]), int(c[i])) for i in range(n_groups)]
    if agg.kind == "distinct_count":
        sets: List[set] = [set() for _ in range(n_groups)]
        if vals.dtype == object:
            vals = vals.astype(str)
        order = np.argsort(inv, kind="stable")
        sorted_inv = inv[order]
        sorted_vals = vals[order]
        bounds = np.searchsorted(sorted_inv, np.arange(n_groups + 1))
        for gi in range(n_groups):
            sets[gi] = set(np.unique(
                sorted_vals[bounds[gi]:bounds[gi + 1]]).tolist())
        return sets
    raise SqlError(f"unknown aggregation {agg.kind}")


def host_selection(ctx: QueryContext, seg: ImmutableSegment,
                   mask: np.ndarray) -> Tuple[List[str], List[tuple],
                                              List[tuple]]:
    """Selection query over one segment -> (labels, rows, order_keys).

    Without ORDER BY, stops at offset+limit rows (SelectionOnlyOperator
    early-exit). With ORDER BY, returns the per-segment top
    offset+limit rows plus their sort keys for the merge at reduce.
    """
    sel = np.nonzero(mask)[0]
    need = None
    if ctx.limit is not None:
        need = ctx.offset + ctx.limit
    if not ctx.order_by and need is not None:
        sel = sel[:need]

    # expand *
    exprs: List[Any] = []
    labels: List[str] = []
    for item, label in zip(ctx.select_items, ctx.labels):
        if isinstance(item, Star):
            for cname in seg.schema.column_names:
                exprs.append(Identifier(cname))
                labels.append(cname)
        else:
            exprs.append(item)
            labels.append(label)

    order_vals: List[np.ndarray] = []
    if ctx.order_by:
        for o in ctx.order_by:
            v = eval_value(o.expr, seg, sel)
            if v.dtype == object:
                v = v.astype(str)
            order_vals.append(np.broadcast_to(v, (len(sel),)))
        # per-segment partial sort down to `need`
        idx = np.lexsort([
            (ov if o.ascending else _invert_order(ov))
            for o, ov in reversed(list(zip(ctx.order_by, order_vals)))])
        if need is not None:
            idx = idx[:need]
        sel = sel[idx]
        order_vals = [ov[idx] for ov in order_vals]

    cols = [np.broadcast_to(eval_value(e, seg, sel), (len(sel),))
            for e in exprs]
    if null_aware(ctx):
        # surface stored default values as real nulls in the result rows
        out_cols: List[np.ndarray] = []
        for e, c in zip(exprs, cols):
            nm = expr_null_mask(e, seg)
            if nm is not None and nm[sel].any():
                c = c.astype(object)
                c[nm[sel]] = None
            out_cols.append(c)
        cols = out_cols
    rows = [tuple(_scalar(c[i]) for c in cols) for i in range(len(sel))]
    okeys = [tuple(_scalar(ov[i]) for ov in order_vals)
             for i in range(len(sel))] if ctx.order_by else []
    return labels, rows, okeys


def _invert_order(v: np.ndarray) -> np.ndarray:
    if v.dtype.kind in "iuf":
        return -v.astype(np.float64)
    # strings: rank-invert
    u, inv = np.unique(v, return_inverse=True)
    return -inv.astype(np.int64)
