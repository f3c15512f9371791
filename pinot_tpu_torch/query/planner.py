"""Physical planner: QueryContext + segment -> executable plan.

Port of ``pinot_tpu/query/planner.py``, kept line for line where the two
agree. What differs: the execution platform is the segment's torch device
type instead of ``jax.default_backend()``; plan verification, spans and
the plan-cache drift loop are not ported. TEXT_MATCH, JSON_MATCH and
VECTOR_SIMILARITY filters, and the geo filters over a geo-indexed column
(ST_Distance(col, point) <op> r, ST_Contains/ST_Within of a literal
polygon, bare or ``= 0|1``), become a ``docmask`` kernel param, as in the
reference; a geo filter over a column without the index plans the host
path, which evaluates the ST_* function row by row.

Reference parity: pinot-core/.../plan/maker/InstancePlanMakerImplV2.java:137
(makeInstancePlan) / :234 (makeSegmentPlanNode) chooses Aggregation /
GroupBy / Selection plans per segment; AggregationPlanNode.java:98-112
installs non-scan fast paths (metadata COUNT, dictionary MIN/MAX);
ColumnValueSegmentPruner drops segments whose min/max can't match.

TPU-native differences:
- literals resolve to dict ids / typed scalars that become runtime kernel
  params (plan structure is literal-free -> one XLA compile per shape);
- dictionary-resolved predicates constant-fold (absent value -> FalseP),
  and folding a segment's root predicate to FalseP IS the pruner;
- range predicates on sorted dictionaries become id-range masks — the
  sorted-dictionary trick replaces the RangeIndex;
- LIKE/REGEXP evaluate host-side over the (small) dictionary and ship the
  matching-id set to the device — the TPU analog of Pinot's
  dictionary-based predicate evaluators.
"""
from __future__ import annotations

import fnmatch
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.ir import (AggSpec, And, Bin, Case as CaseIR, Cmp, Col, EqId,
                      FalseP, Func as FuncIR, IdRange,
                      InBitmap, InSet, IsNull as IsNullIR, KernelPlan, Lit,
                      MaskParam as MaskParamP, Not, Or, Pred, TrueP,
                      ValueExpr)
from ..segment.immutable import ImmutableSegment
from ..spi.schema import DataType
from ..utils.spans import span
from .context import AggExpr, QueryContext, _expr_label as _expr_label_of
from .sql import (Between, BinaryOp, BoolAnd, BoolNot, BoolOr, CaseWhen,
                  Cast, Comparison, collect_identifiers, FuncCall,
                  Identifier, InList, IsNull, Like, Literal, SqlError, Star)

MAX_DENSE_GROUPS = 1 << 21          # beyond this, host hash group-by
MAX_DISTINCT_MATRIX = 1 << 24       # group_space * card gate for on-device
# small spaces stay on the dense one-hot kernel (one fused pass, vmap- and
# mesh-friendly); larger spaces compact matched rows first (ops/compact.py)
DENSE_SMALL_GROUPS = 512
# dense one-hot materializes an (bucket, space) int8 operand in HBM; cap its
# size so big segments route to compact even for small spaces (a 134M-row
# segment with 175 groups would otherwise stage a 23GB operand)
DENSE_ONEHOT_BUDGET = 1 << 28


class PlanError(SqlError):
    pass


def _truthy(v: Any) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes")
    return bool(v)


# ---------------------------------------------------------------------------
# plan kinds
# ---------------------------------------------------------------------------

@dataclass
class CompiledPlan:
    kind: str  # 'pruned' | 'fast' | 'kernel' | 'host'
    segment: ImmutableSegment
    ctx: QueryContext
    # kernel path
    col_names: List[str] = field(default_factory=list)
    kernel_plan: Optional[KernelPlan] = None
    params: List[Any] = field(default_factory=list)
    agg_bindings: List["AggBinding"] = field(default_factory=list)
    group_cols: List[str] = field(default_factory=list)   # group key columns
    # per-key decode recipe for extract_partial: ("dict", col, card) |
    # ("int", lo, stride, card) — expression keys (GROUP BY YEAR(ts))
    # have no dictionary; their ids decode as lo + id*stride
    group_decoders: List[tuple] = field(default_factory=list)
    # fast path: precomputed states per agg
    fast_states: Optional[List[Any]] = None
    # kselect path (device selection/order-by)
    select_plan: Optional[Any] = None
    select_names: List[str] = field(default_factory=list)
    # cost model (multistage/costs.py): IR-derived selectivity estimate,
    # the compaction capacity it implies for the compact strategy (None =
    # kernel-default caps), and the strategy decision trace (EXPLAIN /
    # profile tooling)
    est_selectivity: Optional[float] = None
    slots_cap: Optional[int] = None
    strategy_trace: Optional[dict] = None
    # the capacity was re-derived from a measured selectivity that drifted
    # past multistage/costs.SELECTIVITY_DRIFT_RATIO from the estimate
    drift_requantized: bool = False


@dataclass
class AggBinding:
    """Maps a logical AggExpr to kernel output names + finalize metadata."""
    agg: AggExpr
    index: int            # position in kernel plan aggs
    integral: bool
    dict_col: Optional[str] = None   # distinct_count id-space column


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

class _Binder:
    def __init__(self, segment: ImmutableSegment):
        self.segment = segment
        self.cols: List[str] = []
        self.params: List[Any] = []

    def bind_col(self, name: str) -> int:
        if name not in self.segment.columns:
            raise PlanError(f"unknown column {name!r} in segment "
                            f"{self.segment.name!r}")
        if name in self.cols:
            return self.cols.index(name)
        self.cols.append(name)
        return len(self.cols) - 1

    def add_param(self, value: Any) -> int:
        self.params.append(value)
        return len(self.params) - 1


def _pad_dup(vals: np.ndarray) -> np.ndarray:
    """Pad a sorted set to pow2 with copies of the LAST element (duplicates
    change neither `any(==)` semantics nor sortedness — the kernel's
    sorted-membership path needs ascending order) to bound recompiles on
    IN-list size."""
    n = len(vals)
    p = 1
    while p < n:
        p <<= 1
    if p == n:
        return vals
    return np.concatenate([vals, np.repeat(vals[-1:], p - n)])


def _simplify(p: Pred) -> Pred:
    if isinstance(p, And):
        kids = []
        for c in (_simplify(c) for c in p.children):
            if isinstance(c, FalseP):
                return FalseP()
            if isinstance(c, TrueP):
                continue
            if isinstance(c, And):
                kids.extend(c.children)
            else:
                kids.append(c)
        if not kids:
            return TrueP()
        return kids[0] if len(kids) == 1 else And(tuple(kids))
    if isinstance(p, Or):
        kids = []
        for c in (_simplify(c) for c in p.children):
            if isinstance(c, TrueP):
                return TrueP()
            if isinstance(c, FalseP):
                continue
            if isinstance(c, Or):
                kids.extend(c.children)
            else:
                kids.append(c)
        if not kids:
            return FalseP()
        return kids[0] if len(kids) == 1 else Or(tuple(kids))
    if isinstance(p, Not):
        c = _simplify(p.child)
        if isinstance(c, TrueP):
            return FalseP()
        if isinstance(c, FalseP):
            return TrueP()
        if isinstance(c, Not):
            return c.child
        return Not(c)
    return p


def _like_to_regex(pattern: str) -> "re.Pattern":
    # SQL LIKE: % = any run, _ = any one char (LikePredicate semantics)
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

class SegmentPlanner:
    def __init__(self, ctx: QueryContext, segment: ImmutableSegment):
        self.ctx = ctx
        self.seg = segment
        self.b = _Binder(segment)
        self.null_aware = _truthy(ctx.options.get("enableNullHandling"))

    # -- value expressions -------------------------------------------------
    def resolve_value(self, e: Any) -> Tuple[ValueExpr, bool]:
        """-> (ir, integral)."""
        if isinstance(e, Identifier):
            m = self.seg.columns.get(e.name)
            if m is None:
                raise PlanError(f"unknown column {e.name!r}")
            if not getattr(m, "single_value", True):
                raise PlanError(f"column {e.name!r} is multi-value; use "
                                "the MV aggregation forms (SUMMV, ...)")
            if not m.data_type.is_numeric:
                raise PlanError(f"column {e.name!r} ({m.data_type.value}) "
                                "is not numeric in a value context")
            idx = self.b.bind_col(e.name)
            if m.has_dict:
                # marker resolved by the executor against the segment's
                # device cache (dictionaries upload once, not per query)
                dp = self.b.add_param(("dictvals", e.name))
                return Col(idx, dp), m.data_type.is_integral
            return Col(idx), m.data_type.is_integral
        if isinstance(e, Literal):
            v = e.value
            integral = isinstance(v, (int, np.integer)) and not isinstance(v, bool)
            p = self.b.add_param(
                np.int64(v) if integral else np.float64(float(v)))
            return Lit(p), integral
        if isinstance(e, BinaryOp):
            l, li = self.resolve_value(e.lhs)
            r, ri = self.resolve_value(e.rhs)
            integral = li and ri and e.op != "/"
            return Bin(e.op, l, r), integral
        if isinstance(e, FuncCall):
            return self._device_func(e)
        if isinstance(e, Cast):
            return self._device_cast(e)
        if isinstance(e, CaseWhen):
            return self._device_case(e)
        raise PlanError(f"unsupported value expression {e!r}")

    # datetime/math scalar functions with closed-form device lowerings
    # (DateTimeTransformFunction / CastTransformFunction analogs; full
    # registry stays host-side in query/functions.py — PlanError here
    # means the host path evaluates instead)
    _DEVICE_FUNCS = {
        "year": True, "month": True, "day": True, "dayofmonth": True,
        "quarter": True, "dayofweek": True, "hour": True, "minute": True,
        "second": True, "millisecond": True,
        "abs": None, "floor": False, "ceil": False, "sqrt": False,
        "exp": False, "ln": False,
    }

    # constant output ranges of datetime field extractors (lo, hi)
    _FIELD_RANGES = {"month": (1, 12), "day": (1, 31), "quarter": (1, 4),
                     "dayofweek": (1, 7), "hour": (0, 23),
                     "minute": (0, 59), "second": (0, 59),
                     "millisecond": (0, 999)}
    _TRUNC_STRIDES = {"second": 1000, "minute": 60_000,
                      "hour": 3_600_000, "day": 86_400_000,
                      "week": 7 * 86_400_000}

    def _expr_key_range(self, g: Any):
        """GROUP BY expression -> (lo, stride, cardinality) when the
        expression has a device lowering AND a bounded integer range
        derivable from column metadata; None -> host path. The device
        answer to expression group keys (the reference evaluates a
        transform function then runs NoDictionaryGroupKeyGenerator;
        here the key arithmetic fuses into the kernel)."""
        from .functions import canonical
        if not isinstance(g, FuncCall):
            return None
        name = canonical(g.name)
        name = "day" if name == "dayofmonth" else name
        if name in self._FIELD_RANGES and len(g.args) == 1:
            lo, hi = self._FIELD_RANGES[name]
            return lo, 1, hi - lo + 1
        arg_rng = None
        if name == "year" and len(g.args) == 1:
            arg_rng = self._range_of(g.args[0])
            if arg_rng is None:
                return None
            import numpy as _np
            y_lo = int(_np.datetime64(int(arg_rng[0]), "ms")
                       .astype("datetime64[Y]").astype(_np.int64)) + 1970
            y_hi = int(_np.datetime64(int(arg_rng[1]), "ms")
                       .astype("datetime64[Y]").astype(_np.int64)) + 1970
            return y_lo, 1, y_hi - y_lo + 1
        if name == "datetrunc" and len(g.args) == 2 \
                and isinstance(g.args[0], Literal):
            unit = str(g.args[0].value).lower()
            stride = self._TRUNC_STRIDES.get(unit)
            if stride is None:
                return None
            arg_rng = self._range_of(g.args[1])
            if arg_rng is None:
                return None
            ms_lo, ms_hi = int(arg_rng[0]), int(arg_rng[1])
            if unit == "week":
                import math as _math
                d_lo = _math.floor(ms_lo / 86_400_000)
                d_hi = _math.floor(ms_hi / 86_400_000)
                t_lo = ((d_lo + 3) // 7 * 7 - 3) * 86_400_000
                t_hi = ((d_hi + 3) // 7 * 7 - 3) * 86_400_000
            else:
                import math as _math
                t_lo = _math.floor(ms_lo / stride) * stride
                t_hi = _math.floor(ms_hi / stride) * stride
            return t_lo, stride, (t_hi - t_lo) // stride + 1

        return None

    def _expr_key_ir(self, g: FuncCall, lo: int, stride: int) -> ValueExpr:
        """The [0, card) key expression for a ranged group expression."""
        from .functions import canonical
        name = canonical(g.name)
        name = "day" if name == "dayofmonth" else name
        if name == "datetrunc":
            unit = str(g.args[0].value).lower()
            v, vi = self.resolve_value(g.args[1])
            if not vi:
                raise PlanError("dateTrunc key over non-integer (host)")
            f = FuncIR(f"trunc_{unit}", (v,))
        else:
            v, vi = self.resolve_value(g.args[0])
            if not vi:
                raise PlanError(f"{g.name} key over non-integer (host)")
            f = FuncIR(name, (v,))
        out: ValueExpr = f
        if lo:
            out = Bin("-", out, Lit(self.b.add_param(np.int64(lo))))
        if stride != 1:
            out = Bin("//", out, Lit(self.b.add_param(np.int64(stride))))
        return out

    def _device_func(self, e: FuncCall) -> Tuple[ValueExpr, bool]:
        from .functions import canonical
        name = canonical(e.name)
        if name == "datetrunc" and len(e.args) == 2 and                 isinstance(e.args[0], Literal):
            unit = str(e.args[0].value).lower()
            if unit in ("second", "minute", "hour", "day", "week",
                        "month", "quarter", "year"):
                v, vi = self.resolve_value(e.args[1])
                if not vi:
                    raise PlanError("dateTrunc over non-integer (host)")
                return FuncIR(f"trunc_{unit}", (v,)), True
            raise PlanError(f"dateTrunc unit {unit!r} (host fallback)")
        integral = self._DEVICE_FUNCS.get("day" if name == "dayofmonth"
                                          else name, "missing")
        if integral == "missing" or len(e.args) != 1 or e.distinct:
            raise PlanError(f"no device lowering for {e.name!r} "
                            "(host fallback)")
        v, vi = self.resolve_value(e.args[0])
        if integral is True and not vi:
            raise PlanError(f"{e.name} over non-integer input (host)")
        name = "day" if name == "dayofmonth" else name
        out_integral = vi if integral is None else integral
        return FuncIR(name, (v,)), out_integral

    _DEVICE_CASTS = {"long": "cast_long", "bigint": "cast_long",
                     "int": "cast_int", "integer": "cast_int",
                     "double": "cast_double", "float": "cast_float"}

    def _device_cast(self, e: Cast) -> Tuple[ValueExpr, bool]:
        fn = self._DEVICE_CASTS.get(e.type_name.lower())
        if fn is None:
            raise PlanError(f"CAST to {e.type_name!r} (host fallback)")
        v, _vi = self.resolve_value(e.expr)
        return FuncIR(fn, (v,)), fn in ("cast_long", "cast_int")

    def _device_case(self, e: CaseWhen) -> Tuple[ValueExpr, bool]:
        if e.else_ is None:
            # CASE with no ELSE yields NULL for unmatched rows — null
            # result semantics live on the host path
            raise PlanError("CASE without ELSE (host fallback)")
        whens = []
        integral = True
        for cond, res in e.whens:
            pred = _simplify(self._pred(cond))
            v, vi = self.resolve_value(res)
            integral = integral and vi
            whens.append((pred, v))
        ev, ei = self.resolve_value(e.else_)
        return CaseIR(tuple(whens), ev), integral and ei

    # -- predicates --------------------------------------------------------
    def resolve_filter(self, e: Any) -> Pred:
        if e is None:
            return TrueP()
        if self.null_aware and self._nullable_refs(e):
            # enableNullHandling: a row passes only when the predicate is
            # TRUE under three-valued logic. The T/F pair propagates
            # through the tree as ordinary 2VL predicates (host peer:
            # engine/host_eval.eval_filter_3vl), so the kernel stays
            # mask-in mask-out
            t, _f = self._pred_3vl(e)
            return _simplify(t)
        return _simplify(self._pred(e))

    def _nullable_refs(self, e: Any) -> List[str]:
        refs: set = set()
        collect_identifiers(e, refs)
        return [r for r in sorted(refs)
                if getattr(self.seg.columns.get(r), "has_nulls", False)]

    def _null_any_pred(self, e: Any) -> Optional[Pred]:
        """Pred true where ANY input column of e is null (SQL null
        propagation: one null input makes the comparison UNKNOWN)."""
        parts = [MaskParamP(self.b.add_param(("nullmask", r)))
                 for r in self._nullable_refs(e)]
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else Or(tuple(parts))

    def _pred_3vl(self, e: Any) -> Tuple[Pred, Pred]:
        """-> (T, F) preds under Kleene logic (rows not in T and not in F
        are UNKNOWN — filtered out, since only TRUE passes)."""
        if isinstance(e, BoolAnd):
            ts, fs = zip(*(self._pred_3vl(c) for c in e.children))
            return And(ts), Or(fs)
        if isinstance(e, BoolOr):
            ts, fs = zip(*(self._pred_3vl(c) for c in e.children))
            return Or(ts), And(fs)
        if isinstance(e, BoolNot):
            t, f = self._pred_3vl(e.child)
            return f, t
        if isinstance(e, IsNull):
            t = self._pred(e)  # IS [NOT] NULL never yields UNKNOWN
            return t, Not(t)
        # leaf predicate: 2VL result, demoted to UNKNOWN on null inputs
        # (negated leaves included — host_eval.eval_filter_3vl contract)
        p = self._pred(e)
        nm = self._null_any_pred(e)
        if nm is None:
            return p, Not(p)
        valid = Not(nm)
        return _simplify(And((p, valid))), _simplify(And((Not(p), valid)))

    def _pred(self, e: Any) -> Pred:
        if isinstance(e, BoolAnd):
            return And(tuple(self._pred(c) for c in e.children))
        if isinstance(e, BoolOr):
            return Or(tuple(self._pred(c) for c in e.children))
        if isinstance(e, BoolNot):
            return Not(self._pred(e.child))
        if isinstance(e, Comparison):
            return self._comparison(e)
        if isinstance(e, Between):
            p = self._range(e.expr, e.lo, e.hi, True, True)
            if e.negated:
                name = e.expr.name if isinstance(e.expr, Identifier) \
                    else None
                return self._value_negate(p, name)
            return p
        if isinstance(e, InList):
            return self._in_list(e)
        if isinstance(e, Like):
            return self._like(e)
        if isinstance(e, IsNull):
            return self._is_null(e)
        if isinstance(e, Literal) and isinstance(e.value, bool):
            return TrueP() if e.value else FalseP()
        from ..index.predicates import is_index_predicate, index_filter_mask
        if is_index_predicate(e):
            # TEXT_MATCH / JSON_MATCH / VECTOR_SIMILARITY: the index
            # evaluates host-side into a doc mask shipped as a kernel param
            # (SqlError propagates when the index is missing: a user
            # error, not a host fallback)
            return self._mask_pred(index_filter_mask(self.seg, e))
        from ..index.predicates import try_geo_inclusion_mask
        gmask = try_geo_inclusion_mask(self.seg, e) \
            if isinstance(e, FuncCall) else None
        if gmask is not None:
            # bare boolean ST_Contains/ST_Within over an indexed column
            return self._mask_pred(gmask)
        if isinstance(e, FuncCall):
            p = self._dict_transform_bool(e)
            if p is not None:
                return p
        raise PlanError(f"unsupported filter expression {e!r}")

    def _comparison(self, e: Comparison) -> Pred:
        lhs, rhs, op = e.lhs, e.rhs, e.op
        # normalize literal to the right
        if isinstance(lhs, Literal) and not isinstance(rhs, Literal):
            lhs, rhs = rhs, lhs
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        if isinstance(lhs, Identifier) and isinstance(rhs, Literal):
            name, v = lhs.name, rhs.value
            m = self.seg.columns.get(name)
            if m is None:
                raise PlanError(f"unknown column {name!r}")
            if m.has_dict:
                d = self.seg.dictionary(name)
                if op == "==":
                    i = d.index_of(self._cast_for(m, v))
                    if i < 0:
                        return FalseP()
                    return EqId(self.b.bind_col(name),
                                self.b.add_param(np.int32(i)))
                if op == "!=":
                    i = d.index_of(self._cast_for(m, v))
                    if i < 0:
                        return self._value_negate(FalseP(), name)
                    return self._value_negate(
                        EqId(self.b.bind_col(name),
                             self.b.add_param(np.int32(i))), name)
                lo, hi, il, ih = {
                    "<": (None, v, True, False),
                    "<=": (None, v, True, True),
                    ">": (v, None, False, True),
                    ">=": (v, None, True, True),
                }[op]
                return self._dict_range(name, lo, hi, il, ih)
            # raw column
            return self._raw_cmp(name, m, op, v)
        geo = self._geo_comparison(lhs, op, rhs)
        if geo is not None:
            return geo
        # generic: expr vs expr -> compare difference against zero
        try:
            l, li = self.resolve_value(lhs)
            r, ri = self.resolve_value(rhs)
        except PlanError:
            # no device lowering (string functions etc.): a transform of
            # ONE dict column still plans on-device by evaluating the
            # expression over the DICTIONARY host-side and shipping the
            # matching-id set — the dictionary-based predicate evaluator
            # trick LIKE already uses (reference:
            # predicate/EqualsPredicateEvaluatorFactory dictionary path)
            p = self._dict_transform_cmp(lhs, op, rhs)
            if p is not None:
                return p
            raise
        zero = self.b.add_param(np.int64(0) if (li and ri) else np.float64(0))
        return Cmp(Bin("-", l, r), op, zero)

    # dictionary cardinality above which per-query host evaluation over
    # the dictionary stops paying for itself
    DICT_EVAL_LIMIT = 1 << 17

    def _dict_transform_cmp(self, lhs: Any, op: str,
                            rhs: Any) -> Optional[Pred]:
        if not isinstance(rhs, Literal):
            return None
        out, name = self._eval_over_dict(lhs)
        if out is None:
            return None
        v = rhs.value
        try:
            with np.errstate(all="ignore"):
                if op == "==":
                    hit = out == v
                elif op == "!=":
                    hit = out != v
                else:
                    cmpf = {"<": np.less, "<=": np.less_equal,
                            ">": np.greater,
                            ">=": np.greater_equal}[op]
                    hit = cmpf(out, v)
        except (TypeError, ValueError):
            return None
        return self._ids_pred(name, np.nonzero(np.asarray(hit))[0])

    def _dict_transform_bool(self, e: Any) -> Optional[Pred]:
        """Bare boolean transform (startsWith(city, 'x')) over one dict
        column -> matching-id pred."""
        out, name = self._eval_over_dict(e)
        if out is None:
            return None
        try:
            hit = np.asarray(out).astype(bool)
        except (TypeError, ValueError):
            return None
        return self._ids_pred(name, np.nonzero(hit)[0])

    def _ids_pred(self, name: str, ids: np.ndarray) -> Pred:
        m = self.seg.columns[name]
        if len(ids) == 0:
            return FalseP()
        if len(ids) == m.cardinality:
            # full coverage folds to "has any value": empty MV rows must
            # still NOT match (the direct dictionary path's semantics)
            return self._mv_has_value(name) if self._is_mv(name) \
                else TrueP()
        from ..ops.kernels import INSET_BITMAP_MIN
        if m.cardinality >= INSET_BITMAP_MIN * 4 \
                and len(ids) > m.cardinality // 8:
            table = np.zeros(m.cardinality, dtype=bool)
            table[ids] = True
            return InBitmap(self.b.bind_col(name), self.b.add_param(table))
        arr = _pad_dup(np.sort(ids).astype(np.int32))
        return InSet(self.b.bind_col(name), self.b.add_param(arr),
                     len(arr))

    def _eval_over_dict(self, e: Any):
        """Evaluate an elementwise single-column transform expression
        over the column's dictionary -> (values per dict id, col name);
        (None, None) when the shape doesn't qualify."""
        refs: set = set()
        collect_identifiers(e, refs)
        if len(refs) != 1:
            return None, None
        name = next(iter(refs))
        m = self.seg.columns.get(name)
        if m is None or not m.has_dict or m.cardinality == 0 \
                or m.cardinality > self.DICT_EVAL_LIMIT:
            return None, None
        vals = np.asarray(self.seg.dictionary(name).values)

        from . import functions as F

        def ev(node: Any):
            if isinstance(node, Identifier):
                return vals
            if isinstance(node, Literal):
                return node.value
            if isinstance(node, FuncCall) and not node.distinct:
                fd = F.lookup(node.name)
                if fd is None or not fd.elementwise:
                    raise PlanError(f"non-elementwise {node.name!r}")
                return fd.fn(*[ev(a) for a in node.args])
            if isinstance(node, BinaryOp):
                l, r = ev(node.lhs), ev(node.rhs)
                return {"+": lambda: l + r, "-": lambda: l - r,
                        "*": lambda: l * r,
                        "/": lambda: np.asarray(l, dtype=np.float64)
                        / np.asarray(r, dtype=np.float64),
                        "%": lambda: l % r}[node.op]()
            if isinstance(node, Cast):
                return F.cast_value(ev(node.expr), node.type_name)
            raise PlanError(f"no dictionary evaluation for {node!r}")

        try:
            out = ev(e)
        except (PlanError, SqlError, TypeError, ValueError, KeyError):
            return None, None
        out = np.asarray(out)
        if out.shape != (m.cardinality,):
            return None, None
        return out, name

    def _cast_for(self, m, v: Any) -> Any:
        if m.data_type == DataType.STRING or not m.data_type.is_numeric:
            return str(v)
        if isinstance(v, str):
            # BadQueryRequestException analog: literal must coerce to the
            # column's numeric type
            try:
                return float(v) if "." in v or "e" in v.lower() else int(v)
            except ValueError:
                raise PlanError(
                    f"cannot compare numeric column with {v!r}") from None
        return v

    def _geo_comparison(self, lhs, op: str, rhs) -> Optional[Pred]:
        """Index-backed geospatial comparisons (H3IndexFilterOperator /
        H3InclusionIndexFilterOperator analogs): ST_Distance(col, point)
        <op> r, and ST_Contains/ST_Within(...) = 0|1. None when the shape
        doesn't match or the column has no geo index (host path then
        evaluates the ST_* scalar row-wise, like the reference's scan
        filter fallback)."""
        from ..index.predicates import (try_geo_distance_mask,
                                        try_geo_inclusion_mask)
        mask = try_geo_distance_mask(self.seg, lhs, op, rhs)
        if mask is None and isinstance(rhs, Literal) and op in ("==", "!=") \
                and isinstance(rhs.value, (bool, int)) \
                and rhs.value in (0, 1, True, False):
            positive = bool(rhs.value) == (op == "==")
            mask = try_geo_inclusion_mask(self.seg, lhs, positive=positive)
        if mask is None:
            return None
        return self._mask_pred(mask)

    def _mask_pred(self, mask) -> Pred:
        """Host-computed doc mask -> constant-folded pred or docmask
        kernel param (shared by index, geo, and bare-boolean filters)."""
        if not mask.any():
            return FalseP()
        if mask.all():
            return TrueP()
        return MaskParamP(self.b.add_param(("docmask", mask)))

    def _raw_cmp(self, name: str, m, op: str, v: Any) -> Pred:
        v = self._cast_for(m, v)  # coerce string literals; PlanError if not
        if op == "==" and "bloom" in getattr(m, "indexes", {}):
            # BloomFilterSegmentPruner analog: a definite miss folds the
            # predicate (and possibly the whole segment plan) to FalseP.
            # Coerce the literal to the column dtype first so its string
            # hash matches how the build stringified the typed array
            # (int literal 5 vs stored float "5.0" must not false-prune).
            reader = self.seg.index_reader(name, "bloom")
            probe = (np.asarray(v, dtype=m.data_type.np_dtype)
                     if m.data_type.is_numeric else v)
            if reader is not None and not reader.might_contain(probe):
                return FalseP()
        # min/max constant folding = ColumnValueSegmentPruner for raw columns
        mn, mx = m.min, m.max
        if mn is not None and mx is not None and isinstance(v, (int, float)):
            if op == "==" and (v < mn or v > mx):
                return FalseP()
            if op in ("<", "<=") and v < mn:
                return FalseP()
            if op in (">", ">=") and v > mx:
                return FalseP()
            if op == "<=" and v >= mx:
                return TrueP()
            if op == ">=" and v <= mn:
                return TrueP()
            if op == "<" and v > mx:
                return TrueP()
            if op == ">" and v < mn:
                return TrueP()
        idx = self.b.bind_col(name)
        dt = m.data_type.np_dtype
        if np.issubdtype(dt, np.integer) and isinstance(v, float) \
                and v != int(v):
            # fractional literal vs int column: rewrite to exact int bound
            if op == "==":
                return FalseP()
            if op == "!=":
                return TrueP()
            import math
            if op in ("<", "<="):
                v2 = math.floor(v)
                return Cmp(Col(idx), "<=", self.b.add_param(np.asarray(v2, dt)))
            v2 = math.ceil(v)
            return Cmp(Col(idx), ">=", self.b.add_param(np.asarray(v2, dt)))
        p = self.b.add_param(np.asarray(v, dt) if m.data_type.is_numeric
                             else np.float64(v))
        return Cmp(Col(idx), op, p)

    def _generic_cmp(self, lhs_ast: Any, op: str, rhs_ast: Any) -> Pred:
        """expr-vs-expr comparison: compare the difference against zero."""
        l, li = self.resolve_value(lhs_ast)
        r, ri = self.resolve_value(rhs_ast)
        zero = self.b.add_param(np.int64(0) if (li and ri) else np.float64(0))
        return Cmp(Bin("-", l, r), op, zero)

    def _range(self, expr: Any, lo: Any, hi: Any, il: bool, ih: bool) -> Pred:
        # non-literal bounds (column/expression BETWEEN bounds) or a
        # non-column subject: generic expression comparisons
        lo_lit = lo is None or isinstance(lo, Literal)
        hi_lit = hi is None or isinstance(hi, Literal)
        if not isinstance(expr, Identifier) or not (lo_lit and hi_lit):
            kids: List[Pred] = []
            if lo is not None:
                kids.append(self._generic_cmp(expr, ">=" if il else ">", lo))
            if hi is not None:
                kids.append(self._generic_cmp(expr, "<=" if ih else "<", hi))
            return And(tuple(kids)) if kids else TrueP()
        name = expr.name
        m = self.seg.columns.get(name)
        if m is None:
            raise PlanError(f"unknown column {name!r}")
        lo_v = lo.value if isinstance(lo, Literal) else None
        hi_v = hi.value if isinstance(hi, Literal) else None
        if m.has_dict:
            return self._dict_range(name, lo_v, hi_v, il, ih)
        kids = []
        if lo_v is not None:
            kids.append(self._raw_cmp(name, m, ">=" if il else ">", lo_v))
        if hi_v is not None:
            kids.append(self._raw_cmp(name, m, "<=" if ih else "<", hi_v))
        return _simplify(And(tuple(kids))) if kids else TrueP()

    def _is_mv(self, name: Optional[str]) -> bool:
        if name is None:
            return False
        m = self.seg.columns.get(name)
        return m is not None and not getattr(m, "single_value", True)

    def _mv_has_value(self, name: str) -> Pred:
        """Matches rows with at least one value: value-level negation of a
        nothing-matches predicate on an MV column (empty arrays match
        nothing). -2 equals no dict id, so negated-EqId flips every real
        value true while pads stay excluded."""
        return EqId(self.b.bind_col(name), self.b.add_param(np.int32(-2)),
                    negated=True)

    def _value_negate(self, p: Pred, name: Optional[str]) -> Pred:
        """!=, NOT IN, NOT BETWEEN negate per VALUE: an MV row matches when
        ANY value fails the base predicate (reference NotEquals/NotIn/
        NotBetween applyMV semantics) — different from doc-level Not().
        Identical for single-value columns."""
        from dataclasses import replace as dc_replace
        if isinstance(p, (EqId, IdRange, InSet, InBitmap)):
            return dc_replace(p, negated=not p.negated)
        if self._is_mv(name):
            if isinstance(p, FalseP):   # base matched no value
                return self._mv_has_value(name)
            if isinstance(p, TrueP):    # base matched every value
                return FalseP()
        return Not(p)

    def _dict_range(self, name: str, lo: Any, hi: Any, il: bool, ih: bool
                    ) -> Pred:
        m = self.seg.columns[name]
        d = self.seg.dictionary(name)
        if lo is not None:
            lo = self._cast_for(m, lo)
        if hi is not None:
            hi = self._cast_for(m, hi)
        lo_id, hi_id = d.id_range(lo, hi, il, ih)
        if lo_id > hi_id:
            return FalseP()
        if lo_id == 0 and hi_id == d.cardinality - 1:
            return TrueP()
        idx = self.b.bind_col(name)
        lo_p = self.b.add_param(np.int32(lo_id)) if lo_id > 0 else None
        hi_p = (self.b.add_param(np.int32(hi_id))
                if hi_id < d.cardinality - 1 else None)
        return IdRange(idx, lo_p, hi_p)

    def _in_list(self, e: InList) -> Pred:
        if not isinstance(e.expr, Identifier):
            raise PlanError("IN over expressions not supported yet")
        name = e.expr.name
        m = self.seg.columns.get(name)
        if m is None:
            raise PlanError(f"unknown column {name!r}")
        vals = [v.value for v in e.values]
        if not vals:  # empty IN list (e.g. an empty IN-subquery result)
            return self._value_negate(FalseP(), name) if e.negated \
                else FalseP()
        from ..ops.kernels import INSET_BITMAP_MIN
        if m.has_dict:
            d = self.seg.dictionary(name)
            ids = d.indexes_of([self._cast_for(m, v) for v in vals])
            ids = np.unique(ids[ids >= 0]).tolist()
            if not ids:
                return self._value_negate(FalseP(), name) if e.negated \
                    else FalseP()
            if len(ids) > INSET_BITMAP_MIN:
                # big IN list on a dict column: one presence-table gather
                # per value (InBitmap) instead of a broadcast compare
                table = np.zeros(m.cardinality, dtype=bool)
                table[np.asarray(ids)] = True
                p: Pred = InBitmap(self.b.bind_col(name),
                                   self.b.add_param(table))
            else:
                arr = _pad_dup(np.asarray(ids, dtype=np.int32))
                p = InSet(self.b.bind_col(name), self.b.add_param(arr),
                          len(arr))
        else:
            vals = sorted(self._cast_for(m, v) for v in vals)
            arr = _pad_dup(np.asarray(vals, dtype=m.data_type.np_dtype))
            p = InSet(self.b.bind_col(name), self.b.add_param(arr), len(arr))
        return self._value_negate(p, name) if e.negated else p

    def _like(self, e: Like) -> Pred:
        if not isinstance(e.expr, Identifier):
            raise PlanError("LIKE over expressions not supported")
        name = e.expr.name
        m = self.seg.columns.get(name)
        if m is None or not m.has_dict:
            raise PlanError(f"LIKE needs a dictionary column, got {name!r}")
        d = self.seg.dictionary(name)
        rx = _like_to_regex(e.pattern)
        ids = [i for i, v in enumerate(d.values) if rx.match(str(v))]
        if not ids:
            return TrueP() if e.negated else FalseP()
        if len(ids) == d.cardinality:
            return FalseP() if e.negated else TrueP()
        arr = _pad_dup(np.asarray(ids, dtype=np.int32))
        p = InSet(self.b.bind_col(name), self.b.add_param(arr), len(arr))
        return Not(p) if e.negated else p

    def _is_null(self, e: IsNull) -> Pred:
        if not isinstance(e.expr, Identifier):
            raise PlanError("IS NULL over expressions not supported")
        name = e.expr.name
        m = self.seg.columns.get(name)
        if m is None:
            raise PlanError(f"unknown column {name!r}")
        if not m.has_nulls:
            return TrueP() if e.negated else FalseP()
        p = IsNullIR(self.b.add_param(("nullmask", name)))
        return Not(p) if e.negated else p

    # -- value range analysis (sizes the exact int8-limb MXU group sums) ---
    def _range_of(self, e: Any) -> Optional[Tuple[float, float]]:
        if isinstance(e, Identifier):
            m = self.seg.columns.get(e.name)
            if m is None or not m.data_type.is_numeric:
                return None
            if m.min is None or m.max is None:
                return None
            return (float(m.min), float(m.max))
        if isinstance(e, Literal) and isinstance(e.value, (int, float)) \
                and not isinstance(e.value, bool):
            return (float(e.value), float(e.value))
        if isinstance(e, BinaryOp):
            lr = self._range_of(e.lhs)
            rr = self._range_of(e.rhs)
            if lr is None or rr is None:
                return None
            (a, b), (c, d) = lr, rr
            if e.op == "+":
                return (a + c, b + d)
            if e.op == "-":
                return (a - d, b - c)
            if e.op == "*":
                corners = (a * c, a * d, b * c, b * d)
                return (min(corners), max(corners))
            return None
        return None

    @staticmethod
    def _bits_for(rng: Optional[Tuple[float, float]]) -> Tuple[int, bool]:
        if rng is None:
            return 63, True
        lo, hi = rng
        mag = max(abs(lo), abs(hi))
        bits = max(1, int(mag).bit_length()) if mag < 2 ** 62 else 63
        return min(bits, 63), lo < 0

    # -- aggregations ------------------------------------------------------
    def resolve_agg(self, i: int, agg: AggExpr) -> Tuple[AggSpec, AggBinding]:
        if agg.kind == "count" and agg.arg is None:
            return (AggSpec("count", None, True),
                    AggBinding(agg, i, True))
        if agg.kind == "distinct_count":
            if isinstance(agg.arg, Identifier):
                m = self.seg.columns.get(agg.arg.name)
                if m is not None and m.has_dict \
                        and getattr(m, "single_value", True):
                    idx = self.b.bind_col(agg.arg.name)
                    spec = AggSpec("distinct_count", Col(idx), True,
                                   card=m.cardinality,
                                   null_param=self._agg_null_param(agg))
                    return spec, AggBinding(agg, i, True,
                                            dict_col=agg.arg.name)
            raise PlanError("DISTINCTCOUNT needs a dictionary column "
                            "(host fallback handles the rest)")
        if agg.kind == "count":  # COUNT(col): Pinot counts all rows when
            # null handling is disabled (NullableSingleInputAggregationFunction)
            # — and skips null inputs when it is enabled
            return (AggSpec("count", None, True,
                            null_param=self._agg_null_param(agg)),
                    AggBinding(agg, i, True))
        if agg.kind in ("sum_mv", "count_mv", "min_mv", "max_mv"):
            if self.null_aware and isinstance(agg.arg, Identifier) and \
                    getattr(self.seg.columns.get(agg.arg.name),
                            "has_nulls", False):
                raise PlanError("null-aware MV aggregation (host fallback)")
            return self._resolve_mv_agg(i, agg)
        if agg.kind in ("distinct_count_hll", "distinct_count_theta",
                        "percentile_sketch", "raw_hll", "raw_theta",
                        "percentile_raw_sketch"):
            return self._resolve_sketch_agg(i, agg)
        if agg.kind not in ("sum", "min", "max", "avg"):
            raise PlanError(f"no device lowering for {agg.kind} "
                            "(host fallback)")
        ve, integral = self.resolve_value(agg.arg)
        bits, signed = self._bits_for(self._range_of(agg.arg))
        return (AggSpec(agg.kind, ve, integral, bits=bits, signed=signed,
                        null_param=self._agg_null_param(agg)),
                AggBinding(agg, i, integral))

    def _resolve_sketch_agg(self, i: int, agg: AggExpr
                            ) -> Tuple[AggSpec, AggBinding]:
        """Device lowerings for the flagship sketches: DISTINCTCOUNTHLL
        (register presence bitmap), DISTINCTCOUNTTHETASKETCH (k smallest
        distinct hashes), and the PERCENTILEKLL/EST/TDIGEST family (sorted
        equal-count centroids). Partial states match ops/aggregations'
        host AggImpl formats, so kernel and host partials merge
        interchangeably at the broker. Grouped: HLL only."""
        if self.ctx.is_group_by and agg.kind not in ("distinct_count_hll",
                                                     "raw_hll"):
            # grouped HLL has a device lowering (presence bitmap, OR-
            # mergeable); theta/percentile group states keep the host
            # registry
            raise PlanError("grouped sketch aggregations use the host "
                            "registry")
        if not isinstance(agg.arg, Identifier):
            raise PlanError("sketch device lowering needs a plain column")
        m = self.seg.columns.get(agg.arg.name)
        if m is None or not getattr(m, "single_value", True):
            raise PlanError("sketch device lowering needs an SV column")
        null_param = self._agg_null_param(agg)

        if agg.kind in ("percentile_sketch", "percentile_raw_sketch"):
            ve, _integral = self.resolve_value(agg.arg)
            from ..ops.aggregations import TDIGEST_MAX_CENTROIDS
            return (AggSpec(agg.kind, ve, False,
                            card=TDIGEST_MAX_CENTROIDS,
                            null_param=null_param),
                    AggBinding(agg, i, False))

        # HLL / theta hash sources: dict columns gather a precomputed
        # per-id hash table (host _hash64 covers strings via md5); raw
        # numeric columns hash on device (splitmix64, bit-identical).
        idx = self.b.bind_col(agg.arg.name)
        if m.has_dict:
            hp = self.b.add_param(("hash64", agg.arg.name))
            ve = Col(idx, hp)
        else:
            if not m.data_type.is_numeric:
                raise PlanError("raw non-numeric sketch input needs the "
                                "host path")
            # a raw float hashes through its float64 bit view; the JAX
            # package gates that on its backend (XLA:TPU cannot lower the
            # view), while Tensor.view(torch.int64) works on every torch
            # device, so the port's gate is always open (the JAX
            # package's CPU behaviour)
            ve = Col(idx)
        from ..ops.aggregations import HLL_DEFAULT_LOG2M
        from ..ops.sketches import THETA_DEFAULT_NOMINAL
        if agg.kind in ("distinct_count_hll", "raw_hll"):
            card = int(agg.params[0]) if agg.params else HLL_DEFAULT_LOG2M
            if not 4 <= card <= 16:
                raise PlanError(f"log2m {card} outside the device range")
        else:
            card = int(agg.params[0]) if agg.params \
                else THETA_DEFAULT_NOMINAL
            if not 1 <= card <= (1 << 16):
                raise PlanError(f"theta k {card} outside the device range")
        return (AggSpec(agg.kind, ve, False, card=card,
                        null_param=null_param),
                AggBinding(agg, i, False))

    def _agg_null_param(self, agg: AggExpr) -> Optional[int]:
        """Null-mask param for a null-aware aggregation's input (skip-null
        semantics, NullableSingleInputAggregationFunction). Host fallback
        for shapes the kernel can't mask per-agg: multi-column nullable
        inputs and group-by plans (the group machinery applies one shared
        mask)."""
        if not self.null_aware:
            return None
        refs: set = set()
        for arg in (agg.arg, agg.arg2):
            if arg is not None:
                collect_identifiers(arg, refs)
        nullable = [r for r in sorted(refs)
                    if getattr(self.seg.columns.get(r), "has_nulls", False)]
        if not nullable:
            return None
        if len(nullable) > 1 or self.ctx.is_group_by:
            raise PlanError("null-aware aggregation shape needs the host "
                            "path")
        return self.b.add_param(("nullmask", nullable[0]))

    SELECT_K_CAP = 1 << 14

    def _plan_selection(self) -> Optional[CompiledPlan]:
        """Device selection: SELECT cols [WHERE ...] [ORDER BY cols]
        LIMIT k -> filter mask + composite order key + lax.top_k + gather
        (ops/kernels.build_select_kernel). Returns None when the shape
        needs the host path (expressions, MV/null cells, non-integral raw
        order keys, unbounded limit)."""
        from ..ops.ir import SelectPlan
        ctx, seg = self.ctx, self.seg
        if ctx.limit is None:
            return None
        # a segment contributes at most bucket rows; lax.top_k also
        # requires k <= operand length
        k = min(ctx.offset + ctx.limit, seg.bucket)
        if not 0 < ctx.offset + ctx.limit <= self.SELECT_K_CAP:
            return None

        names: List[str] = []
        for item in ctx.select_items:
            if isinstance(item, Star):
                names.extend(seg.columns)
            elif isinstance(item, Identifier):
                names.append(item.name)
            else:
                return None
        nh = self.null_aware

        def col_ok(name: str) -> bool:
            m = seg.columns.get(name)
            return (m is not None and getattr(m, "single_value", True)
                    and not (nh and getattr(m, "has_nulls", False)))

        if not all(col_ok(n) for n in names):
            return None

        order: List[Tuple[str, bool, int]] = []
        span = 1
        for o in ctx.order_by:
            if not isinstance(o.expr, Identifier) or not col_ok(o.expr.name):
                return None
            m = seg.columns[o.expr.name]
            if m.has_dict:
                card = max(m.cardinality, 1)
                span *= card
                order.append((o.expr.name, not o.ascending, card))
            else:
                # raw keys can't radix-pack: only a single integral one,
                # with bounds well inside int64 so negation can't wrap
                # into (or past) the unmatched-row sentinel
                if len(ctx.order_by) != 1 or not m.data_type.is_numeric \
                        or m.data_type.np_dtype.kind not in "iu" \
                        or m.min is None or m.max is None \
                        or max(abs(int(m.min)), abs(int(m.max))) >= 1 << 61:
                    return None
                order.append((o.expr.name, not o.ascending, 0))
        if span >= 1 << 62:
            return None

        pred = self.resolve_filter(ctx.filter)  # PlanError -> host (caller)
        if isinstance(pred, FalseP):
            # select_names preserves expanded star labels in the empty
            # result (the host path expands them even for 0 rows)
            return CompiledPlan("pruned", seg, ctx, select_names=names)
        if getattr(seg, "valid_docs", None) is not None and \
                not _truthy(ctx.options.get("skipUpsert")):
            pred = _simplify(And((pred, MaskParamP(
                self.b.add_param(("validdocs", None))))))

        sel_idx = tuple(self.b.bind_col(n) for n in names)
        order_idx = tuple((self.b.bind_col(n), d, c) for n, d, c in order)
        sp = SelectPlan(pred=pred, select_cols=sel_idx, order=order_idx,
                        k=k)
        return CompiledPlan("kselect", seg, ctx, col_names=self.b.cols,
                            params=self.b.params, select_plan=sp,
                            select_names=names)

    def _resolve_mv_agg(self, i: int, agg: AggExpr
                        ) -> Tuple[AggSpec, AggBinding]:
        """SUMMV/COUNTMV/MINMV/MAXMV lower to the base kind over a per-row
        MvReduce (ops/ir.py); AVGMV and DISTINCTCOUNTMV stay host-side
        (their device states need a values-count column pair / 2-D
        presence)."""
        from ..ops.aggregations import base_kind
        from ..ops.ir import MvReduce

        if not isinstance(agg.arg, Identifier):
            raise PlanError("MV aggregations take a column argument")
        name = agg.arg.name
        m = self.seg.columns.get(name)
        if m is None or getattr(m, "single_value", True) \
                or not m.has_dict:
            raise PlanError(f"{agg.kind} needs a multi-value dictionary "
                            f"column (host fallback)")
        idx = self.b.bind_col(name)
        base = base_kind(agg.kind)
        if agg.kind == "count_mv":
            # per-row value count <= maxValues: tiny exact int sums
            bits = max(1, int(m.max_values or 1).bit_length())
            spec = AggSpec("sum", MvReduce(idx, "count"), True,
                           bits=bits, signed=False)
            return spec, AggBinding(agg, i, True)
        if not m.data_type.is_numeric:
            raise PlanError(f"{agg.kind} over a non-numeric MV column "
                            "(host fallback)")
        integral = m.data_type.np_dtype.kind in "iu"
        dict_param = self.b.add_param(("dictvals", name))
        mode = agg.kind.split("_")[0]  # sum | min | max
        ve = MvReduce(idx, mode, dict_param)
        if m.min is None or m.max is None:
            rng = None
        elif mode == "sum":
            # per-row sum bound: maxValues * max magnitude
            mv = float(m.max_values or 1)
            rng = (min(0.0, float(m.min) * mv), float(m.max) * mv)
        else:
            rng = (float(m.min), float(m.max))
        bits, signed = self._bits_for(rng)
        spec = AggSpec(base, ve, integral, bits=bits, signed=signed)
        return spec, AggBinding(agg, i, integral)

    # -- validation --------------------------------------------------------
    def _validate_columns(self) -> None:
        """Unknown columns are user errors everywhere (including host-path
        queries), not host-fallback surprises."""
        ctx = self.ctx
        names: List[str] = []

        from .sql import ast_children

        def walk(e: Any) -> None:
            if isinstance(e, Identifier):
                names.append(e.name)
            for c in ast_children(e):
                walk(c)

        walk(ctx.filter)
        for g in ctx.group_by:
            walk(g)
        for agg in ctx.aggregations:
            if agg.arg is not None:
                walk(agg.arg)
        for item in ctx.select_items:
            if not isinstance(item, (Star,)) and not hasattr(item, "kind"):
                walk(item)
        # virtual columns synthesize host-side (host_eval.virtual_column)
        virtual = {"$docId", "$segmentName", "$hostName"}
        for n in names:
            if n not in self.seg.columns and n not in virtual:
                raise PlanError(f"unknown column {n!r}; segment has "
                                f"{list(self.seg.columns)}")
        self._validate_vector_calls()

    def _validate_vector_calls(self) -> None:
        """VECTOR_SIMILARITY validation over the filter, select list AND
        order-by before any execution: a malformed call (missing index,
        dim mismatch, k <= 0, non-numeric ARRAY) is a plain SqlError on
        every path, never a PlanError that would demote to the host."""
        from ..engine.vector_exec import validate_call, vector_calls
        ctx = self.ctx
        calls = vector_calls(
            ctx.filter,
            *[i for i in ctx.select_items if not hasattr(i, "kind")],
            *[o.expr for o in ctx.order_by])
        for call in calls:
            validate_call(self.seg, call)

    # -- top-level ---------------------------------------------------------
    def plan(self) -> CompiledPlan:
        """Plan this segment, recording the outcome (plan kind, strategy,
        cost-model trace) as a child span of the query's planning span
        when a trace is active (utils/spans.py; no-op otherwise). The JAX
        package's static plan verification (analysis/plan_verify) is not
        ported."""
        with span("plan_segment", segment=self.seg.name) as sp:
            plan = self._plan()
            if sp is not None:
                sp.annotate(kind=plan.kind)
                if plan.kind == "kernel":
                    sp.annotate(strategy=plan.kernel_plan.strategy,
                                est_sel=plan.est_selectivity,
                                slots_cap=plan.slots_cap,
                                cost_trace=plan.strategy_trace)
                    if plan.drift_requantized:
                        sp.annotate(drift_requantized=True)
            return plan

    def _plan(self) -> CompiledPlan:
        ctx, seg = self.ctx, self.seg
        self._validate_columns()
        if _truthy(ctx.options.get("forceHostExecution")):
            # kernel-vs-host differential testing hook (the fuzzer diffs
            # both paths against a numpy oracle; reference analog:
            # QueryGenerator runs against H2)
            return CompiledPlan("host", seg, ctx)
        if self.null_aware:
            # null-aware execution stays on the device: 3VL filters via
            # resolve_filter's T-tree, per-agg null skip via
            # AggSpec.null_param. Null group KEYS form their own group —
            # a representation the dense cartesian id key lacks -> host
            refs: set = set()
            for g in ctx.group_by:
                collect_identifiers(g, refs)
            if any(getattr(seg.columns.get(r), "has_nulls", False)
                   for r in refs):
                return CompiledPlan("host", seg, ctx)
        if getattr(seg, "is_mutable", False):
            # consuming snapshot: vectorized host path (MutableSegmentImpl's
            # realtime read path analog; rows become device-resident on seal)
            return CompiledPlan("host", seg, ctx)
        if not ctx.is_aggregation:
            try:
                ksel = self._plan_selection()
            except PlanError:
                ksel = None
            if ksel is not None:
                return ksel
            return CompiledPlan("host", seg, ctx)  # general selection: host

        try:
            pred = self.resolve_filter(ctx.filter)
        except PlanError:
            # filter uses expressions without a device lowering (scalar
            # functions, CASE, ...) -> vectorized host path
            return CompiledPlan("host", seg, ctx)
        if isinstance(pred, FalseP) :
            return CompiledPlan("pruned", seg, ctx)

        # upsert validDocIds: fold the segment's valid mask into the filter
        # (queryableDocIds in the reference; OPTION(skipUpsert=true) bypasses)
        if getattr(seg, "valid_docs", None) is not None and \
                not _truthy(ctx.options.get("skipUpsert")):
            from ..ops.ir import MaskParam
            pred = _simplify(And((pred, MaskParam(
                self.b.add_param(("validdocs", None))))))

        # group-by feasibility: column keys (dict ids) or expression
        # keys with a metadata-derivable bounded integer range
        group_cols: List[str] = []
        group_keys: List[Tuple[int, int]] = []
        gspecs: List[tuple] = []   # ("col", name, card)|("expr", g, lo, stride, card)
        if ctx.is_group_by:
            dense_ok = True
            space = 1
            for g in ctx.group_by:
                if isinstance(g, Identifier):
                    m = seg.columns.get(g.name)
                    if m is None or not m.has_dict or m.cardinality == 0 \
                            or not getattr(m, "single_value", True):
                        # virtual / raw / MV keys stay host-side
                        dense_ok = False
                        break
                    gspecs.append(("col", g.name, m.cardinality))
                    space *= max(m.cardinality, 1)
                    continue
                rng = self._expr_key_range(g)
                if rng is None:
                    dense_ok = False
                    break
                lo, stride, card = rng
                gspecs.append(("expr", g, lo, stride, card))
                space *= max(card, 1)
            from ..ops.kernels import COMPACT_GROUP_LIMIT
            space_cap = max(MAX_DENSE_GROUPS, COMPACT_GROUP_LIMIT)
            if not dense_ok or space > space_cap:
                return CompiledPlan("host", seg, ctx)

        # fast path: no filter, metadata/dictionary-answerable aggs, no group
        if isinstance(pred, TrueP) and not ctx.is_group_by:
            fast = self._try_fast_path()
            if fast is not None:
                return fast

        try:
            specs: List[AggSpec] = []
            bindings: List[AggBinding] = []
            for i, agg in enumerate(ctx.aggregations):
                spec, binding = self.resolve_agg(i, agg)
                specs.append(spec)
                bindings.append(binding)
        except PlanError:
            return CompiledPlan("host", seg, ctx)

        if not ctx.is_group_by:
            # scalar DISTINCTCOUNT: the sort-boundary path (kernels.
            # DISTINCT_ONEHOT_CARD) removes the card-sized matmul, so the
            # gate is only the (card,) presence-bitmap transfer size
            for s in specs:
                if s.kind == "distinct_count" and s.card is not None \
                        and s.card > MAX_DISTINCT_MATRIX:
                    return CompiledPlan("host", seg, ctx)

        strategy = "dense"
        est_sel: Optional[float] = None
        slots_cap: Optional[int] = None
        strat_trace: Optional[dict] = None
        key_exprs: List[Any] = []
        group_decoders: List[tuple] = []
        if ctx.is_group_by:
            try:
                for spec in gspecs:
                    if spec[0] == "col":
                        _tag, name, card = spec
                        idx = self.b.bind_col(name)
                        group_keys.append((idx, card))
                        key_exprs.append(None)
                        group_cols.append(name)
                        group_decoders.append(("dict", name, card))
                    else:
                        _tag, g, lo, stride, card = spec
                        ve = self._expr_key_ir(g, lo, stride)
                        group_keys.append((0, card))
                        key_exprs.append(ve)
                        group_cols.append(_expr_label_of(g))
                        group_decoders.append(("int", lo, stride, card))
            except PlanError:
                return CompiledPlan("host", seg, ctx)
            space = 1
            for _, c in group_keys:
                space *= max(c, 1)
            from ..ops.kernels import COMPACT_GROUP_LIMIT
            # the execution platform is the segment's torch device type;
            # the reference's gates below are kept as they are, so off the
            # CPU the dense one-hot budget routes big segments to compact
            platform = seg.device.type
            slow_scatter = platform != "cpu"
            # compact strategy: CUDA row compaction + factorized/sorted
            # aggregation (ops/kernels._compact_group_aggs); covers every
            # core numeric agg (min/max ride an exact int64 orderable in a
            # lexicographic sort)
            from ..ops.ir import MvReduce as _MvR
            compact_ok = (
                not any(e is not None for e in key_exprs)
                and space <= COMPACT_GROUP_LIMIT
                and all(s.kind in ("count", "sum", "avg", "min", "max")
                        for s in specs)
                # MV value columns are (bucket, maxValues) matrices; the
                # row compaction primitive is 1-D — dense handles them
                and not any(isinstance(s.value, _MvR) for s in specs))
            # dense-strategy viability (one-hot over all rows)
            dense_viable = space <= MAX_DENSE_GROUPS
            has_expr_keys = any(e is not None for e in key_exprs)
            if (slow_scatter or has_expr_keys) and \
                    seg.bucket * (space + 1) > DENSE_ONEHOT_BUDGET:
                # the (bucket, space) int8 one-hot operand would not fit /
                # would dominate HBM traffic; matched-row compaction first
                # is strictly better at any real selectivity. Expression
                # keys can't compact (no key column to gather), so the
                # budget gates them to host on every backend.
                dense_viable = False
            for s in specs:
                if s.kind == "distinct_count" and s.card is not None \
                        and space * s.card > MAX_DISTINCT_MATRIX:
                    dense_viable = False
                if s.kind in ("distinct_count_hll", "raw_hll"):
                    from ..ops.kernels import GROUPED_HLL_LIMIT
                    r_levels = 64 - s.card + 1
                    if space * (1 << s.card) * r_levels \
                            > GROUPED_HLL_LIMIT:
                        return CompiledPlan("host", seg, ctx)
                if s.kind in ("min", "max") and slow_scatter and space > 64:
                    # no matmul form for min/max; TPU scatter is
                    # pathological (kernels.MINMAX_UNROLL_GROUPS)
                    dense_viable = False
            if not dense_viable and not compact_ok:
                return CompiledPlan("host", seg, ctx)
            # cost-model strategy choice: dense vs
            # compact driven by IR-measured selectivity x group-space
            # (multistage/costs.py), not the old space>512 heuristic.
            # OPTION(groupByStrategy=dense|compact) pins it when a
            # structurally-possible strategy is forced (hardware gates,
            # differential tests).
            from ..multistage import costs as _costs
            from ..ops.kernels import FACTORIZED_GROUP_LIMIT
            col_cards = {
                i: int(getattr(seg.columns.get(nm), "cardinality", 0) or 0)
                for i, nm in enumerate(self.b.cols)}
            est_sel = _costs.ir_selectivity(pred, self.b.params, col_cards)
            needs_sort_flag = (space > FACTORIZED_GROUP_LIMIT
                               or any(s.kind in ("min", "max")
                                      for s in specs))
            n_payloads = sum(1 for s in specs if s.kind != "count")
            force = str(ctx.options.get("groupByStrategy", "")).lower() \
                or None
            strategy, strat_trace = _costs.choose_group_strategy(
                seg.n_docs, space, est_sel, platform, needs_sort_flag,
                n_payloads, dense_viable, compact_ok, force)

        plan = KernelPlan(pred=pred, aggs=tuple(specs),
                          group_keys=tuple(group_keys),
                          strategy=strategy,
                          key_exprs=(tuple(key_exprs)
                                     if any(e is not None
                                            for e in key_exprs) else ()))
        drift_requant = False
        if strategy == "compact":
            # size from the LIVE row count (n_docs), not the padded
            # bucket — the pad rows are mask-false and consume no
            # compaction slots
            from ..multistage import costs as _costs
            slots_cap = _costs.compact_slots_cap(seg.n_docs, est_sel)
            # selectivity-drift feedback: when the last run of this plan
            # on this segment with these literals MEASURED a matched
            # fraction past the drift factor from the IR estimate, the
            # capacity is re-derived from the measurement
            from ..ops.plan_cache import global_plan_cache
            meas = global_plan_cache.measured_for(
                plan, seg.bucket, segment=seg, params=self.b.params)
            if meas is not None and _costs.selectivity_drift(est_sel,
                                                             meas):
                from ..utils.metrics import global_metrics
                global_metrics.count("selectivity_drift_detected")
                meas_f = max(meas, _costs.MIN_SEL)
                new_cap = _costs.compact_slots_cap(seg.n_docs, meas_f)
                if strat_trace is not None:
                    strat_trace["drift"] = {
                        "est_sel": round(est_sel, 8),
                        "meas_sel": round(meas_f, 8),
                        "slots_cap": slots_cap, "new_cap": new_cap}
                if new_cap != slots_cap:
                    global_metrics.count("selectivity_drift_requantized")
                    slots_cap = new_cap
                    drift_requant = True
                # the measurement replaces the estimate either way, so
                # every derived capacity (the segmented dispatch's
                # scaled_compact_cap) agrees with the cap in force
                est_sel = meas_f
        return CompiledPlan("kernel", seg, ctx,
                            col_names=list(self.b.cols),
                            kernel_plan=plan,
                            params=list(self.b.params),
                            agg_bindings=bindings,
                            group_cols=group_cols,
                            group_decoders=group_decoders,
                            est_selectivity=est_sel,
                            slots_cap=slots_cap,
                            strategy_trace=strat_trace,
                            drift_requantized=drift_requant)

    def _try_fast_path(self) -> Optional[CompiledPlan]:
        """Metadata/dictionary-only answers (AggregationPlanNode.java:98-112
        NonScanBasedAggregationOperator analog)."""
        seg, ctx = self.seg, self.ctx
        states: List[Any] = []
        for agg in ctx.aggregations:
            if agg.kind == "count":
                if self.null_aware and agg.arg is not None and any(
                        getattr(seg.columns.get(r), "has_nulls", False)
                        for r in collect_identifiers(agg.arg)):
                    # COUNT(col) skips nulls under enableNullHandling;
                    # n_docs would overcount
                    return None
                states.append(seg.n_docs)
                continue
            if agg.kind in ("min", "max") and isinstance(agg.arg, Identifier):
                m = seg.columns.get(agg.arg.name)
                if m is None or m.min is None or m.has_nulls:
                    return None
                if not m.data_type.is_numeric:
                    return None
                states.append(float(m.min if agg.kind == "min" else m.max))
                continue
            if agg.kind == "distinct_count" and isinstance(agg.arg, Identifier):
                m = seg.columns.get(agg.arg.name)
                if m is None or not m.has_dict or m.has_nulls:
                    return None
                # mergeable across segments: the value set, not its size
                states.append(set(seg.dictionary(agg.arg.name).values))
                continue
            return None
        return CompiledPlan("fast", seg, ctx, fast_states=states)
