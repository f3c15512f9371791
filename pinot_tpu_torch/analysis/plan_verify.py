"""Plan-IR static verifier: abstract shape/dtype checks over ops/ir.py.

The port runs one kernel plan SHAPE over many queries and
re-parameterizes per query (ops/ir.py), so a single bad plan invariant
— an out-of-range column index, an unhashable plan node poisoning the
cache key, a too-small magnitude claim, an int accumulator that
overflows at segment scale, a compaction capacity off the quantization
ladder, a sketch aggregation reaching the compact path — corrupts
results instead of failing once at plan time. This module re-derives
each invariant from the plan tree (plus segment metadata when
available) and reports structured diagnostics.

Entry points:

- ``verify_kernel_plan(plan, ...)`` / ``verify_select_plan(sp, ...)``:
  structural rules over a bare KernelPlan / SelectPlan — everything
  derivable without a segment.
- ``verify_compiled_plan(cp)``: the full rule set over a planner
  CompiledPlan — index bounds against the real column/param bindings,
  param kind/dtype checks, metadata-derived value ranges vs the claimed
  AggSpec.bits, cost-model slots_cap consistency.
  ``python -m pinot_tpu_torch.tools.check_static`` runs it over every
  plan the planner makes for the SSB, taxi and fuzzer corpora.
- ``verify_fused_plan(fp)`` / ``check_fused_plan(fp)``: the cross-stage
  fused IR (ops/ir.FusedPlan); ``check_fused_plan`` runs fail-fast in
  multistage/fused.py before the whole-plan program runs
  (PINOT_PLAN_VERIFY=0 disables).

Rule catalog (stable ids — tests assert them, diagnostics print them):

    PV101  column index out of bounds
    PV102  parameter index out of bounds
    PV103  plan structure not hashable / not frozen-tuple-only
    PV104  magnitude claim (bits/sign) below the metadata bound
    PV105  integral SUM accumulator can overflow at full selectivity
    PV106  compact slots_cap violates capacity invariants
    PV107  strategy gate violation (e.g. sketch agg on the compact path)
    PV108  malformed AggSpec (kind/card/bits out of contract)
    PV109  malformed value/predicate expression (op, arity, IN width)
    PV110  malformed group keys (cardinality, key_exprs parallelism)
    PV111  parameter kind/dtype mismatch for a predicate/value node
    PV112  malformed SelectPlan (k, order-key packing)
    PV201  fused exchange partition-spec/key-dtype inconsistency
    PV202  fused per-shard shape instability across a collective
    PV203  fused-stage accumulator width overflow
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..ops import ir
from ..query.sql import SqlError

RULES = {
    "PV101": "column index out of bounds",
    "PV102": "parameter index out of bounds",
    "PV103": "plan structure not hashable (plan-cache key contract)",
    "PV104": "magnitude claim below the metadata bound",
    "PV105": "integral SUM accumulator overflow at segment scale",
    "PV106": "compact slots_cap capacity invariant violation",
    "PV107": "group-by strategy gate violation",
    "PV108": "malformed AggSpec",
    "PV109": "malformed value/predicate expression",
    "PV110": "malformed group keys",
    "PV111": "parameter kind/dtype mismatch",
    "PV112": "malformed SelectPlan",
    "PV201": "fused exchange partition-spec/key-dtype inconsistency",
    "PV202": "fused per-shard shape instability across a collective",
    "PV203": "fused-stage accumulator width overflow",
}


@dataclass(frozen=True)
class Diagnostic:
    rule: str       # PVxxx
    path: str       # location in the plan tree, e.g. "fused.stages[1].max_dup"
    message: str
    fix: str = ""   # suggested fix
    # "error" diagnostics fail the plan fail-fast; "warn" is advisory
    severity: str = "error"

    def __str__(self) -> str:
        s = f"{self.rule} at {self.path}: {self.message}"
        if self.severity != "error":
            s = f"[{self.severity}] " + s
        return s + (f" (fix: {self.fix})" if self.fix else "")


class PlanVerificationError(SqlError):
    """A planned program violates a static invariant: a bug that must
    surface, not a fallback."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = diagnostics
        super().__init__("plan verification failed:\n"
                         + format_diagnostics(diagnostics))


def format_diagnostics(diags: Sequence[Diagnostic]) -> str:
    return "\n".join(f"  {d}" for d in diags)


# ---------------------------------------------------------------------------
# expression walkers
# ---------------------------------------------------------------------------

# device scalar functions with a kernels._eval_func lowering -> result
# kind ('int' | 'float' | 'same' = follows the argument)
_DEVICE_FUNC_KIND = {
    "cast_long": "int", "cast_int": "int",
    "cast_double": "float", "cast_float": "float",
    "abs": "same", "floor": "float", "ceil": "float", "sqrt": "float",
    "exp": "float", "ln": "float",
    "year": "int", "month": "int", "day": "int", "quarter": "int",
    "dayofweek": "int", "hour": "int", "minute": "int", "second": "int",
    "millisecond": "int",
    "trunc_second": "int", "trunc_minute": "int", "trunc_hour": "int",
    "trunc_day": "int", "trunc_week": "int", "trunc_month": "int",
    "trunc_quarter": "int", "trunc_year": "int",
}

_BIN_OPS = ("+", "-", "*", "/", "%", "//")
_CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")
_MV_MODES = ("sum", "count", "min", "max")

_SKETCH_KINDS = ("distinct_count_hll", "distinct_count_theta",
                 "percentile_sketch", "raw_hll", "raw_theta",
                 "percentile_raw_sketch")
_AGG_KINDS = ("count", "sum", "min", "max", "avg",
              "distinct_count") + _SKETCH_KINDS
_COMPACT_AGG_KINDS = ("count", "sum", "avg", "min", "max")


class _Ctx:
    """Shared verification context: bounds, bindings, sink."""

    def __init__(self, n_cols: Optional[int] = None,
                 n_params: Optional[int] = None,
                 params: Optional[Sequence[Any]] = None,
                 col_names: Optional[Sequence[str]] = None,
                 segment: Any = None):
        self.n_cols = n_cols
        self.n_params = n_params
        self.params = params
        self.col_names = col_names
        self.segment = segment
        self.out: List[Diagnostic] = []

    def diag(self, rule: str, path: str, message: str, fix: str = "",
             severity: str = "error") -> None:
        self.out.append(Diagnostic(rule, path, message, fix, severity))

    def check_col(self, idx: Any, path: str) -> None:
        if not isinstance(idx, (int, np.integer)):
            self.diag("PV101", path, f"column index {idx!r} is not an int")
            return
        if self.n_cols is not None and not 0 <= idx < self.n_cols:
            self.diag("PV101", path,
                      f"column index {int(idx)} outside [0, {self.n_cols})",
                      "bind the column through _Binder.bind_col")

    def check_param(self, idx: Any, path: str) -> None:
        if idx is None:
            return
        if not isinstance(idx, (int, np.integer)):
            self.diag("PV102", path, f"param index {idx!r} is not an int")
            return
        if self.n_params is not None and not 0 <= idx < self.n_params:
            self.diag("PV102", path,
                      f"param index {int(idx)} outside [0, {self.n_params})",
                      "bind the value through _Binder.add_param")

    def param_value(self, idx: Optional[int]) -> Any:
        if self.params is None or idx is None \
                or not isinstance(idx, (int, np.integer)) \
                or not 0 <= idx < len(self.params):
            return None
        return self.params[idx]

    def column_meta(self, col_idx: Any):
        if self.segment is None or self.col_names is None \
                or not isinstance(col_idx, (int, np.integer)) \
                or not 0 <= col_idx < len(self.col_names):
            return None
        return self.segment.columns.get(self.col_names[col_idx])


def _is_marker(v: Any) -> bool:
    """Planner symbolic params: ('dictvals', name), ('nullmask', name),
    ('docmask', mask), ('validdocs', None), ('hash64', name)."""
    return isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str)


def _walk_value(ve: Any, path: str, c: _Ctx) -> Optional[str]:
    """Abstract dtype inference ('int' | 'float' | None=unknown) with
    structural validation along the way."""
    if isinstance(ve, ir.Col):
        c.check_col(ve.col, path + ".col")
        c.check_param(ve.dict_param, path + ".dict_param")
        if ve.dict_param is not None:
            pv = c.param_value(ve.dict_param)
            if pv is not None and not _is_marker(pv) \
                    and not isinstance(pv, np.ndarray):
                c.diag("PV111", path,
                       f"dict_param resolves to {type(pv).__name__}, "
                       "expected a ('dictvals'|'hash64', col) marker or "
                       "a device values array")
        m = c.column_meta(ve.col)
        if m is not None and getattr(m, "data_type", None) is not None \
                and m.data_type.is_numeric:
            return "int" if m.data_type.is_integral else "float"
        return None
    if isinstance(ve, ir.Lit):
        c.check_param(ve.param, path + ".param")
        pv = c.param_value(ve.param)
        if isinstance(pv, (np.floating, float)):
            return "float"
        if isinstance(pv, (np.integer, int)) and not isinstance(pv, bool):
            return "int"
        return None
    if isinstance(ve, ir.MvReduce):
        c.check_col(ve.col, path + ".col")
        c.check_param(ve.dict_param, path + ".dict_param")
        if ve.mode not in _MV_MODES:
            c.diag("PV109", path + ".mode",
                   f"MvReduce mode {ve.mode!r} not in {_MV_MODES}")
        return "int" if ve.mode == "count" else None
    if isinstance(ve, ir.Bin):
        if ve.op not in _BIN_OPS:
            c.diag("PV109", path + ".op",
                   f"binary op {ve.op!r} not in {_BIN_OPS}")
        lk = _walk_value(ve.lhs, path + ".lhs", c)
        rk = _walk_value(ve.rhs, path + ".rhs", c)
        if ve.op == "/":
            return "float"   # SQL division is double division
        if lk == "float" or rk == "float":
            return "float"
        if lk == "int" and rk == "int":
            return "int"
        return None
    if isinstance(ve, ir.Func):
        kind = _DEVICE_FUNC_KIND.get(ve.name)
        if kind is None:
            c.diag("PV109", path + ".name",
                   f"no device lowering for function {ve.name!r}",
                   "route through query/functions.py host path")
            kind = "same"
        if not isinstance(ve.args, tuple) or len(ve.args) != 1:
            c.diag("PV109", path + ".args",
                   f"device function {ve.name!r} takes exactly one "
                   f"argument, got {len(getattr(ve, 'args', ()))}")
            return None
        ak = _walk_value(ve.args[0], path + ".args[0]", c)
        return ak if kind == "same" else kind
    if isinstance(ve, ir.Case):
        if not isinstance(ve.whens, tuple) or not ve.whens:
            c.diag("PV109", path + ".whens",
                   "CASE needs at least one WHEN arm as a tuple")
            return None
        kinds = []
        for i, (pred, val) in enumerate(ve.whens):
            _walk_pred(pred, f"{path}.whens[{i}][0]", c)
            kinds.append(_walk_value(val, f"{path}.whens[{i}][1]", c))
        kinds.append(_walk_value(ve.else_, path + ".else_", c))
        if "float" in kinds:
            return "float"
        return "int" if all(k == "int" for k in kinds) else None
    c.diag("PV109", path, f"unknown value expression {type(ve).__name__}")
    return None


def _walk_pred(p: Any, path: str, c: _Ctx) -> None:
    if isinstance(p, (ir.TrueP, ir.FalseP)):
        return
    if isinstance(p, ir.EqId):
        c.check_col(p.col, path + ".col")
        c.check_param(p.param, path + ".param")
        pv = c.param_value(p.param)
        if pv is not None and not _is_marker(pv) and not isinstance(
                pv, (int, np.integer)):
            c.diag("PV111", path + ".param",
                   f"EqId expects an integer dict id, got "
                   f"{type(pv).__name__}")
        return
    if isinstance(p, ir.IdRange):
        c.check_col(p.col, path + ".col")
        c.check_param(p.lo_param, path + ".lo_param")
        c.check_param(p.hi_param, path + ".hi_param")
        if p.lo_param is None and p.hi_param is None:
            c.diag("PV109", path, "IdRange with neither bound",
                   "fold to TrueP in the planner")
        for which in ("lo_param", "hi_param"):
            pv = c.param_value(getattr(p, which))
            if pv is not None and not _is_marker(pv) and not isinstance(
                    pv, (int, np.integer)):
                c.diag("PV111", f"{path}.{which}",
                       f"IdRange bound must be an integer id, got "
                       f"{type(pv).__name__}")
        return
    if isinstance(p, ir.InSet):
        c.check_col(p.col, path + ".col")
        c.check_param(p.param, path + ".param")
        if not isinstance(p.n, (int, np.integer)) or p.n < 1:
            c.diag("PV109", path + ".n", f"InSet n={p.n!r} must be >= 1")
        elif p.n & (p.n - 1):
            c.diag("PV109", path + ".n",
                   f"InSet n={int(p.n)} is not a power of two",
                   "pad through planner._pad_dup to bound recompiles")
        pv = c.param_value(p.param)
        if isinstance(pv, np.ndarray):
            if pv.ndim != 1 or len(pv) != p.n:
                c.diag("PV111", path + ".param",
                       f"InSet param shape {pv.shape} != ({int(p.n)},)")
            elif len(pv) > 1 and not bool(np.all(pv[:-1] <= pv[1:])):
                c.diag("PV111", path + ".param",
                       "InSet values must be sorted ascending (the "
                       "kernel's sorted-membership search requires it)")
        return
    if isinstance(p, ir.InBitmap):
        c.check_col(p.col, path + ".col")
        c.check_param(p.param, path + ".param")
        pv = c.param_value(p.param)
        if isinstance(pv, np.ndarray):
            if pv.dtype != np.bool_ or pv.ndim != 1:
                c.diag("PV111", path + ".param",
                       f"InBitmap param must be a 1-D bool presence "
                       f"table, got {pv.dtype} ndim={pv.ndim}")
            else:
                m = c.column_meta(p.col)
                card = getattr(m, "cardinality", None)
                if card and len(pv) != card:
                    c.diag("PV111", path + ".param",
                           f"presence table length {len(pv)} != column "
                           f"cardinality {card}")
        return
    if isinstance(p, ir.Cmp):
        if p.op not in _CMP_OPS:
            c.diag("PV109", path + ".op",
                   f"comparison op {p.op!r} not in {_CMP_OPS}")
        _walk_value(p.lhs, path + ".lhs", c)
        c.check_param(p.param, path + ".param")
        return
    if isinstance(p, ir.MaskParam):
        c.check_param(p.param, path + ".param")
        pv = c.param_value(p.param)
        if pv is not None and not _is_marker(pv):
            if not (isinstance(pv, np.ndarray) and pv.dtype == np.bool_):
                c.diag("PV111", path + ".param",
                       f"MaskParam expects a bool mask or marker, got "
                       f"{type(pv).__name__}")
        return
    if isinstance(p, (ir.And, ir.Or)):
        if not isinstance(p.children, tuple) or len(p.children) < 1:
            c.diag("PV109", path + ".children",
                   f"{type(p).__name__} needs a non-empty child tuple")
            return
        for i, ch in enumerate(p.children):
            _walk_pred(ch, f"{path}.children[{i}]", c)
        return
    if isinstance(p, ir.Not):
        _walk_pred(p.child, path + ".child", c)
        return
    c.diag("PV109", path, f"unknown predicate {type(p).__name__}")


# ---------------------------------------------------------------------------
# hashability (the plan-cache key contract)
# ---------------------------------------------------------------------------

_FROZEN_IR_TYPES = (
    ir.Col, ir.Lit, ir.Bin, ir.MvReduce, ir.Func, ir.Case,
    ir.TrueP, ir.FalseP, ir.EqId, ir.IdRange, ir.InSet, ir.InBitmap,
    ir.Cmp, ir.MaskParam, ir.And, ir.Or, ir.Not,
    ir.AggSpec, ir.KernelPlan, ir.SelectPlan,
)


def _check_hashable(obj: Any, path: str, c: _Ctx) -> None:
    if obj is None or isinstance(obj, (str, bool, int, float,
                                       np.integer, np.bool_)):
        return
    if isinstance(obj, tuple):
        for i, v in enumerate(obj):
            _check_hashable(v, f"{path}[{i}]", c)
        return
    if isinstance(obj, _FROZEN_IR_TYPES):
        for f in dataclasses.fields(obj):
            _check_hashable(getattr(obj, f.name), f"{path}.{f.name}", c)
        return
    if isinstance(obj, (list, dict, set, np.ndarray)):
        c.diag("PV103", path,
               f"mutable {type(obj).__name__} inside the plan structure "
               "breaks the plan-cache key contract",
               "store a tuple in the plan; ship arrays as runtime params")
        return
    c.diag("PV103", path,
           f"non-IR node {type(obj).__name__} in the plan structure "
           "(frozen, tuple-only contract)")


# ---------------------------------------------------------------------------
# aggregation width rules (PV104/PV105)
# ---------------------------------------------------------------------------

def _ir_range(ve: Any, c: _Ctx) -> Optional[Tuple[float, float]]:
    """Metadata-derived value interval of an IR value expression — the
    verifier-side mirror of SegmentPlanner._range_of (which works on the
    SQL AST). Must stay at least as conservative."""
    if isinstance(ve, ir.Col):
        m = c.column_meta(ve.col)
        if m is None or getattr(m, "data_type", None) is None \
                or not m.data_type.is_numeric:
            return None
        if m.min is None or m.max is None:
            return None
        return float(m.min), float(m.max)
    if isinstance(ve, ir.Lit):
        pv = c.param_value(ve.param)
        if isinstance(pv, (int, float, np.integer, np.floating)) \
                and not isinstance(pv, bool):
            return float(pv), float(pv)
        return None
    if isinstance(ve, ir.MvReduce):
        m = c.column_meta(ve.col)
        if m is None:
            return None
        mv = float(getattr(m, "max_values", None) or 1)
        if ve.mode == "count":
            return 0.0, mv
        if m.min is None or m.max is None \
                or not m.data_type.is_numeric:
            return None
        if ve.mode == "sum":
            return (min(0.0, float(m.min) * mv), float(m.max) * mv)
        return float(m.min), float(m.max)
    if isinstance(ve, ir.Bin):
        lr = _ir_range(ve.lhs, c)
        rr = _ir_range(ve.rhs, c)
        if lr is None or rr is None:
            return None
        (a, b), (d, e) = lr, rr
        if ve.op == "+":
            return a + d, b + e
        if ve.op == "-":
            return a - e, b - d
        if ve.op == "*":
            corners = (a * d, a * e, b * d, b * e)
            return min(corners), max(corners)
        return None
    return None


def _check_agg_widths(plan: ir.KernelPlan, c: _Ctx,
                      n_docs: Optional[int]) -> None:
    from ..query.planner import SegmentPlanner
    for i, spec in enumerate(plan.aggs):
        path = f"aggs[{i}]"
        if spec.kind not in ("sum", "avg") or not spec.integral:
            continue
        # PV104b: the claimed bits/sign must actually bound the value —
        # a too-small claim silently truncates in the int32 carrier and
        # under-sizes the int8 limb decomposition
        if c.segment is not None and spec.value is not None:
            rng = _ir_range(spec.value, c)
            true_bits, true_signed = SegmentPlanner._bits_for(rng)
            if rng is not None and spec.bits < true_bits:
                c.diag("PV104", path + ".bits",
                       f"claims {spec.bits} magnitude bits but column "
                       f"metadata bounds the value at {true_bits} bits "
                       f"(range {rng[0]:g}..{rng[1]:g}) — the narrowed "
                       "carrier/limb decomposition would truncate",
                       "recompute bits via planner._bits_for")
            if rng is not None and not spec.signed and true_signed:
                c.diag("PV104", path + ".signed",
                       "claims a non-negative value but metadata says "
                       f"the range reaches {rng[0]:g}",
                       "keep signed=True unless min >= 0 is proven")
        # PV105 (warn): a PROVEN magnitude bound plus the row count must
        # fit the 63-bit accumulator at full selectivity. Advisory, not
        # query-killing: if the sum does overflow it wraps in exact
        # lockstep with the numpy int64 host/oracle path (and the
        # reference's Java long), and real filters rarely match every
        # row — but the bench/dashboard author should know. bits == 63
        # is the 'unprofiled' sentinel and exempt.
        if n_docs and spec.bits < 63:
            need = spec.bits + max(int(n_docs - 1).bit_length(), 1)
            if need > 63:
                c.diag("PV105", path + ".bits",
                       f"SUM of {spec.bits}-bit values over {n_docs} "
                       f"rows needs {need} accumulator bits > 63 — "
                       "wraps int64 (numpy-parity) when every row "
                       "matches",
                       "shard the segment or demote to float "
                       "accumulation", severity="warn")


# ---------------------------------------------------------------------------
# strategy / capacity rules (PV106/PV107/PV110)
# ---------------------------------------------------------------------------

def _check_strategy(plan: ir.KernelPlan, c: _Ctx) -> None:
    from ..ops.kernels import COMPACT_GROUP_LIMIT, GROUPED_HLL_LIMIT
    from ..query.planner import MAX_DENSE_GROUPS, MAX_DISTINCT_MATRIX

    if plan.strategy not in ("dense", "compact"):
        c.diag("PV107", "strategy",
               f"unknown strategy {plan.strategy!r}")
        return
    space = plan.group_space
    has_expr_keys = any(e is not None for e in (plan.key_exprs or ()))
    if plan.strategy == "compact":
        if not plan.is_group_by:
            c.diag("PV107", "strategy",
                   "compact strategy without group keys")
        if has_expr_keys:
            c.diag("PV107", "key_exprs",
                   "expression group keys cannot compact (no key column "
                   "to gather)", "plan the dense strategy")
        if space > COMPACT_GROUP_LIMIT:
            c.diag("PV107", "group_keys",
                   f"group space {space} exceeds COMPACT_GROUP_LIMIT "
                   f"{COMPACT_GROUP_LIMIT}")
        for i, spec in enumerate(plan.aggs):
            if spec.kind not in _COMPACT_AGG_KINDS:
                c.diag("PV107", f"aggs[{i}].kind",
                       f"{spec.kind!r} aggregation on the compact path "
                       f"(gate allows {_COMPACT_AGG_KINDS})",
                       "plan dense or route to the host registry")
            if isinstance(spec.value, ir.MvReduce):
                c.diag("PV107", f"aggs[{i}].value",
                       "MV payloads are (bucket, maxValues) matrices; "
                       "the row compaction primitive is 1-D",
                       "plan the dense strategy")
            if spec.null_param is not None:
                c.diag("PV107", f"aggs[{i}].null_param",
                       "per-agg null masking has no compact lowering "
                       "(the planner hosts null-aware group-bys)")
    elif plan.is_group_by and space > MAX_DENSE_GROUPS:
        c.diag("PV107", "group_keys",
               f"dense one-hot over group space {space} exceeds "
               f"MAX_DENSE_GROUPS {MAX_DENSE_GROUPS}")
    if plan.is_group_by:
        for i, spec in enumerate(plan.aggs):
            if spec.kind in ("distinct_count_theta", "percentile_sketch",
                             "raw_theta", "percentile_raw_sketch"):
                c.diag("PV107", f"aggs[{i}].kind",
                       f"grouped {spec.kind!r} has no device lowering "
                       "(host registry only)")
            if spec.kind == "distinct_count" and spec.card \
                    and space * spec.card > MAX_DISTINCT_MATRIX:
                c.diag("PV107", f"aggs[{i}].card",
                       f"grouped DISTINCTCOUNT presence matrix "
                       f"{space}x{spec.card} exceeds MAX_DISTINCT_MATRIX")
            if spec.kind in ("distinct_count_hll", "raw_hll") and spec.card:
                r_levels = 64 - spec.card + 1
                if space * (1 << spec.card) * r_levels > GROUPED_HLL_LIMIT:
                    c.diag("PV107", f"aggs[{i}].card",
                           "grouped HLL presence bitmap exceeds "
                           "GROUPED_HLL_LIMIT")


def _check_group_keys(plan: ir.KernelPlan, c: _Ctx,
                      group_decoders: Optional[Sequence[tuple]] = None
                      ) -> None:
    for i, gk in enumerate(plan.group_keys):
        path = f"group_keys[{i}]"
        if not (isinstance(gk, tuple) and len(gk) == 2):
            c.diag("PV110", path, f"expected (col, card), got {gk!r}")
            continue
        idx, card = gk
        if not isinstance(card, (int, np.integer)) or card < 1:
            c.diag("PV110", path, f"cardinality {card!r} must be >= 1")
        kexpr = plan.key_exprs[i] if plan.key_exprs \
            and i < len(plan.key_exprs) else None
        if kexpr is None:
            c.check_col(idx, path + "[0]")
        else:
            _walk_value(kexpr, f"key_exprs[{i}]", c)
    if plan.key_exprs and len(plan.key_exprs) != len(plan.group_keys):
        c.diag("PV110", "key_exprs",
               f"{len(plan.key_exprs)} key_exprs for "
               f"{len(plan.group_keys)} group keys")
    if group_decoders is not None and plan.group_keys:
        if len(group_decoders) != len(plan.group_keys):
            c.diag("PV110", "group_decoders",
                   f"{len(group_decoders)} decoders for "
                   f"{len(plan.group_keys)} group keys")
        else:
            for i, (dec, (idx, card)) in enumerate(
                    zip(group_decoders, plan.group_keys)):
                if dec[-1] != card:
                    c.diag("PV110", f"group_decoders[{i}]",
                           f"decoder cardinality {dec[-1]} != plan key "
                           f"cardinality {card}")
                if dec[0] == "dict" and c.segment is not None:
                    m = c.segment.columns.get(dec[1])
                    if m is not None and m.cardinality != card:
                        c.diag("PV110", f"group_keys[{i}]",
                               f"key cardinality {card} != segment "
                               f"dictionary cardinality {m.cardinality} "
                               f"for column {dec[1]!r}")


def _check_slots_cap(plan: ir.KernelPlan, c: _Ctx, slots_cap: Optional[int],
                     bucket: Optional[int], n_docs: Optional[int],
                     est_sel: Optional[float]) -> None:
    if slots_cap is None:
        return
    from ..ops.compact import MIN_SLOTS, full_slots_cap
    if plan.strategy != "compact":
        c.diag("PV106", "slots_cap",
               f"slots_cap={slots_cap} on the {plan.strategy!r} strategy "
               "(capacity only applies to the compact path)")
        return
    if not isinstance(slots_cap, (int, np.integer)) or slots_cap < 1:
        c.diag("PV106", "slots_cap", f"slots_cap {slots_cap!r} invalid")
        return
    if slots_cap < MIN_SLOTS:
        c.diag("PV106", "slots_cap",
               f"slots_cap {slots_cap} below MIN_SLOTS "
               f"{MIN_SLOTS} (ladder/post shapes degenerate)")
    if bucket is not None and slots_cap > full_slots_cap(bucket):
        c.diag("PV106", "slots_cap",
               f"slots_cap {slots_cap} exceeds full_slots_cap(bucket="
               f"{bucket}) = {full_slots_cap(bucket)} — capacity beyond "
               "the no-overflow bound wastes the whole post-aggregation")
    full = full_slots_cap(n_docs) if n_docs else None
    pow2 = slots_cap & (slots_cap - 1) == 0
    if not pow2 and slots_cap != full:
        c.diag("PV106", "slots_cap",
               f"slots_cap {slots_cap} is not on the capacity "
               "quantization ladder (power of two or full_slots_cap) — "
               "nearby selectivity estimates would stop sharing one "
               "plan-cache entry",
               "quantize via multistage/costs.compact_slots_cap")
    if est_sel is not None and n_docs:
        from ..multistage.costs import compact_slots_cap
        expect = compact_slots_cap(n_docs, est_sel)
        if slots_cap != expect:
            c.diag("PV106", "slots_cap",
                   f"slots_cap {slots_cap} disagrees with "
                   f"multistage/costs.compact_slots_cap(n_docs={n_docs},"
                   f" sel={est_sel:.3g}) = {expect}",
                   "derive the capacity from the cost model only")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def verify_kernel_plan(plan: ir.KernelPlan, *,
                       n_cols: Optional[int] = None,
                       n_params: Optional[int] = None,
                       bucket: Optional[int] = None,
                       n_docs: Optional[int] = None,
                       params: Optional[Sequence[Any]] = None,
                       col_names: Optional[Sequence[str]] = None,
                       segment: Any = None,
                       slots_cap: Optional[int] = None,
                       est_selectivity: Optional[float] = None,
                       group_decoders: Optional[Sequence[tuple]] = None,
                       ) -> List[Diagnostic]:
    """Verify one KernelPlan. Context arguments are all optional —
    rules that need absent context simply don't run, so the same entry
    serves the planner (full context) and the plan cache (structure
    only)."""
    c = _Ctx(n_cols, n_params, params, col_names, segment)
    if not isinstance(plan, ir.KernelPlan):
        c.diag("PV103", "plan", f"not a KernelPlan: {type(plan).__name__}")
        return c.out
    _check_hashable(plan, "plan", c)
    try:
        hash(plan)
    except TypeError as e:
        c.diag("PV103", "plan", f"hash() failed: {e}",
               "plan structures must be frozen tuples of scalars")
    _walk_pred(plan.pred, "pred", c)
    if not isinstance(plan.aggs, tuple):
        c.diag("PV103", "aggs", "aggs must be a tuple")
        return c.out
    for i, spec in enumerate(plan.aggs):
        _check_agg_spec(i, spec, c)
    _check_group_keys(plan, c, group_decoders)
    _check_strategy(plan, c)
    _check_agg_widths(plan, c, n_docs)
    _check_slots_cap(plan, c, slots_cap, bucket, n_docs, est_selectivity)
    return c.out


def _check_agg_spec(i: int, spec: Any, c: _Ctx) -> None:
    path = f"aggs[{i}]"
    if not isinstance(spec, ir.AggSpec):
        c.diag("PV108", path, f"not an AggSpec: {type(spec).__name__}")
        return
    if spec.kind not in _AGG_KINDS:
        c.diag("PV108", path + ".kind",
               f"unknown aggregation kind {spec.kind!r}")
    if spec.kind == "count":
        if spec.value is not None:
            c.diag("PV108", path + ".value",
                   "COUNT carries no value expression (rides the "
                   "shared mask/count row)")
    elif spec.value is None:
        c.diag("PV108", path + ".value",
               f"{spec.kind} needs a value expression")
    else:
        _walk_value(spec.value, path + ".value", c)
    if not isinstance(spec.bits, (int, np.integer)) \
            or not 1 <= spec.bits <= 63:
        c.diag("PV108", path + ".bits",
               f"bits={spec.bits!r} outside [1, 63]")
    if spec.kind == "distinct_count":
        if not isinstance(spec.card, (int, np.integer)) or spec.card < 1:
            c.diag("PV108", path + ".card",
                   f"DISTINCTCOUNT needs the dictionary cardinality, "
                   f"got {spec.card!r}")
        elif c.segment is not None and isinstance(spec.value, ir.Col):
            m = c.column_meta(spec.value.col)
            if m is not None and m.cardinality != spec.card:
                c.diag("PV108", path + ".card",
                       f"card {spec.card} != column cardinality "
                       f"{m.cardinality}")
    if spec.kind in ("distinct_count_hll", "raw_hll"):
        if not isinstance(spec.card, (int, np.integer)) \
                or not 4 <= spec.card <= 16:
            c.diag("PV108", path + ".card",
                   f"HLL log2m {spec.card!r} outside [4, 16]")
    if spec.kind in ("distinct_count_theta", "raw_theta"):
        if not isinstance(spec.card, (int, np.integer)) \
                or not 1 <= spec.card <= (1 << 16):
            c.diag("PV108", path + ".card",
                   f"theta k {spec.card!r} outside [1, 65536]")
    c.check_param(spec.null_param, path + ".null_param")


def verify_select_plan(sp: Any, *,
                       n_cols: Optional[int] = None,
                       n_params: Optional[int] = None,
                       bucket: Optional[int] = None,
                       params: Optional[Sequence[Any]] = None,
                       col_names: Optional[Sequence[str]] = None,
                       segment: Any = None) -> List[Diagnostic]:
    c = _Ctx(n_cols, n_params, params, col_names, segment)
    if not isinstance(sp, ir.SelectPlan):
        c.diag("PV103", "select", f"not a SelectPlan: {type(sp).__name__}")
        return c.out
    _check_hashable(sp, "select", c)
    _walk_pred(sp.pred, "select.pred", c)
    for i, col in enumerate(sp.select_cols):
        c.check_col(col, f"select.select_cols[{i}]")
    if not isinstance(sp.k, (int, np.integer)) or sp.k < 1:
        c.diag("PV112", "select.k", f"k={sp.k!r} must be >= 1")
    elif bucket is not None and sp.k > bucket:
        c.diag("PV112", "select.k",
               f"k={sp.k} exceeds the segment bucket {bucket} "
               "(top-k requires k <= operand length)")
    span = 1
    raw_keys = 0
    for j, entry in enumerate(sp.order):
        path = f"select.order[{j}]"
        if not (isinstance(entry, tuple) and len(entry) == 3):
            c.diag("PV112", path, f"expected (col, desc, card): {entry!r}")
            continue
        col, _desc, card = entry
        c.check_col(col, path + "[0]")
        if card:
            span *= max(int(card), 1)
        else:
            raw_keys += 1
    if raw_keys and len(sp.order) != 1:
        c.diag("PV112", "select.order",
               "a raw (card=0) order key cannot radix-pack with other "
               "keys; the planner only emits it alone")
    if span >= 1 << 62:
        c.diag("PV112", "select.order",
               f"composite order-key span {span} does not fit 63 bits "
               "(negation could wrap past the unmatched sentinel)")
    return c.out


def verify_compiled_plan(cp: Any) -> List[Diagnostic]:
    """Full verification of a planner CompiledPlan ('kernel'/'kselect'
    kinds; other kinds verify trivially)."""
    if getattr(cp, "kind", None) == "kernel" and cp.kernel_plan is not None:
        return verify_kernel_plan(
            cp.kernel_plan,
            n_cols=len(cp.col_names), n_params=len(cp.params),
            bucket=cp.segment.bucket, n_docs=cp.segment.n_docs,
            params=cp.params, col_names=cp.col_names, segment=cp.segment,
            slots_cap=cp.slots_cap, est_selectivity=cp.est_selectivity,
            group_decoders=cp.group_decoders or None)
    if getattr(cp, "kind", None) == "kselect" and cp.select_plan is not None:
        return verify_select_plan(
            cp.select_plan,
            n_cols=len(cp.col_names), n_params=len(cp.params),
            bucket=cp.segment.bucket, params=cp.params,
            col_names=cp.col_names, segment=cp.segment)
    return []


def verify_fused_plan(fp: "ir.FusedPlan") -> List[Diagnostic]:
    """PV2xx rules over a fused whole-plan IR (ops/ir.FusedPlan).

    The fused program is ONE device program over every stage, so one bad
    static — an exchange partitioned differently from the plan, a key
    dtype the int32 program cannot carry, a stage whose per-shard shape
    drifts across an exchange, a canonical-position domain past the
    accumulator — corrupts every query sharing the shape.
    Rules:

        PV201  exchange partition-spec/key-dtype consistency: every
               exchange runs over the plan's one mesh (partitions
               equal across stages and to the plan), key dtype is the
               int32 the collectives are lowered for, hash exchanges
               carry a pow2 bucket cap, key slots name joined tables
        PV202  per-shard shape stability across collective boundaries:
               base_rows divides over the mesh; a hash exchange's
               received shape (partitions * cap) must cover the shard
               it was fed (rows are dropped silently otherwise);
               max_dup/build_rows are pow2 statics within the dense
               candidate bound
        PV203  accumulator widths: pos_bound (base_rows * prod
               max_dup) must fit the int32 accumulator — the canonical
               row order cannot be restored past it
    """
    c = _Ctx()
    n_stages = len(fp.stages)
    if fp.partitions < 1:
        c.diag("PV201", "fused.partitions",
               f"mesh partition count {fp.partitions} < 1")
    if fp.acc_dtype != "int32":
        c.diag("PV201", "fused.acc_dtype",
               f"accumulator dtype {fp.acc_dtype!r} is not the int32 "
               "the collective lowering carries")
    if fp.base_rows < 1 or fp.base_rows % max(fp.partitions, 1):
        c.diag("PV202", "fused.base_rows",
               f"probe seed of {fp.base_rows} rows does not shard "
               f"evenly over {fp.partitions} devices")
    shard_rows = fp.base_rows // max(fp.partitions, 1)
    pos_bound = fp.base_rows
    for i, st in enumerate(fp.stages):
        path = f"fused.stages[{i}]"
        ex = st.exchange
        if ex.kind not in ("hash", "broadcast"):
            c.diag("PV201", path + ".exchange.kind",
                   f"unknown exchange kind {ex.kind!r}")
        if ex.partitions != fp.partitions:
            c.diag("PV201", path + ".exchange.partitions",
                   f"exchange partitioned over {ex.partitions} devices "
                   f"but the fused mesh has {fp.partitions}",
                   fix="every stage of one fused program shares one "
                       "mesh; replan or route mailbox")
        if ex.key_dtype != "int32":
            c.diag("PV201", path + ".exchange.key_dtype",
                   f"key dtype {ex.key_dtype!r}; the collectives are "
                   "lowered for int32 codes")
        if not ex.key_slots:
            c.diag("PV201", path + ".exchange.key_slots",
                   "exchange carries no key columns")
        for s, owner in enumerate(ex.key_slots):
            if not 0 <= owner <= i:
                c.diag("PV201", path + f".exchange.key_slots[{s}]",
                       f"key slot gathers from table ordinal {owner}, "
                       f"not joined before stage {i}")
        if st.how not in ("inner", "left"):
            c.diag("PV201", path + ".how",
                   f"fused lowering has no {st.how!r} join body")
        if st.max_dup < 1 or st.max_dup & (st.max_dup - 1):
            c.diag("PV202", path + ".max_dup",
                   f"max_dup {st.max_dup} is not a pow2 static")
        if st.build_rows < 1 or st.build_rows & (st.build_rows - 1):
            c.diag("PV202", path + ".build_rows",
                   f"padded build side {st.build_rows} is not pow2 "
                   "(the padded shape is the compile signature)")
        if ex.kind == "hash":
            if ex.cap < 1 or ex.cap & (ex.cap - 1):
                c.diag("PV201", path + ".exchange.cap",
                       f"hash-exchange bucket cap {ex.cap} is not a "
                       "pow2 static")
            elif ex.partitions * ex.cap < shard_rows:
                c.diag("PV202", path + ".exchange.cap",
                       f"received shape {ex.partitions}x{ex.cap} cannot "
                       f"cover the {shard_rows}-row shard it is fed — "
                       "a full bucket would drop live rows silently",
                       fix="raise the bucket cap (slack) or fall back "
                           "to the mailbox plane")
            # post-exchange, every device probes its received buckets
            shard_rows = ex.partitions * ex.cap
        elif ex.cap:
            c.diag("PV201", path + ".exchange.cap",
                   "broadcast exchanges have no bucket; cap must be 0")
        shard_rows *= st.max_dup
        pos_bound *= st.max_dup
    if fp.pos_bound != pos_bound and not any(
            d.rule == "PV202" for d in c.out):
        c.diag("PV202", "fused.pos_bound",
               f"declared pos_bound {fp.pos_bound} != base_rows * "
               f"prod(max_dup) = {pos_bound}")
    if pos_bound > 2**31 - 1 or fp.pos_bound > 2**31 - 1:
        c.diag("PV203", "fused.pos_bound",
               f"canonical-position domain {max(pos_bound, fp.pos_bound)}"
               " overflows the int32 accumulator — order restoration "
               "would alias rows",
               fix="route the plan to the mailbox plane (the fused "
                   "planner's eligibility gate should have)")
    if fp.n_tables != n_stages + 1:
        c.diag("PV202", "fused.n_tables",
               f"{fp.n_tables} tables with {n_stages} join stages "
               "(want n_stages + 1)")
    return c.out


def check_fused_plan(fp: Any) -> None:
    """Fail-fast hook (multistage/fused.py): raise on any ERROR
    diagnostic before the whole-plan program runs. PINOT_PLAN_VERIFY=0
    disables."""
    if not verification_enabled():
        return
    errors = [d for d in verify_fused_plan(fp) if d.severity == "error"]
    if errors:
        raise PlanVerificationError(errors)


def verification_enabled() -> bool:
    return os.environ.get("PINOT_PLAN_VERIFY", "1") != "0"


def check_compiled_plan(cp: Any) -> None:
    """Raise PlanVerificationError on any ERROR diagnostic of a planner
    CompiledPlan ("warn" is advisory). PINOT_PLAN_VERIFY=0 disables."""
    if not verification_enabled():
        return
    errors = [d for d in verify_compiled_plan(cp) if d.severity == "error"]
    if errors:
        raise PlanVerificationError(errors)
