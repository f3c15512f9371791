"""Kernel plan IR: the hashable structure a per-segment query compiles to.

Copy of ``pinot_tpu/ops/ir.py``.

Reference parity: this is the TPU-native analog of pinot-core's physical
operator tree (FilterPlanNode.java:195 constructPhysicalOperator +
AggregationPlanNode / GroupByPlanNode). Key design difference from the
reference: literal values (dict ids, range bounds, IN sets) are NOT part of
the plan structure — they are runtime parameters fed to the jitted kernel,
so XLA compiles once per plan SHAPE and the same binary serves every query
with that shape (Pinot re-plans per query; we re-parameterize).

Columns are referenced by integer index into the kernel's `cols` tuple;
params by index into the `params` tuple. Both bindings are produced by the
planner (query/planner.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Value expressions (projection / transform; operator/transform/ in reference)
# ---------------------------------------------------------------------------

class ValueExpr:
    pass


@dataclass(frozen=True)
class Col(ValueExpr):
    """A projected column. If dict_param is set, the stored array holds dict
    ids and params[dict_param] is the device-resident sorted dictionary
    values array: value = dict_values[ids] (one gather, mirrors Pinot's
    dictionary.get on the read path)."""
    col: int
    dict_param: Optional[int] = None


@dataclass(frozen=True)
class Lit(ValueExpr):
    param: int


@dataclass(frozen=True)
class Bin(ValueExpr):
    """Arithmetic transform: + - * / % (ArithmeticFunctions in reference)."""
    op: str
    lhs: ValueExpr
    rhs: ValueExpr


@dataclass(frozen=True)
class MvReduce(ValueExpr):
    """Per-row reduction over a multi-value column's padded (N, maxValues)
    dict-id matrix (pad id -1): mode in {sum, count, min, max}. MV
    aggregations pre-reduce per row and ride the scalar/group machinery:
    SUMMV = SUM(MvReduce sum), COUNTMV = SUM(MvReduce count), MINMV =
    MIN(MvReduce min), MAXMV = MAX(MvReduce max). Reference:
    pinot-core/.../query/aggregation/function/SumMVAggregationFunction.java
    (and Count/Min/Max MV variants)."""
    col: int
    mode: str
    dict_param: Optional[int] = None


@dataclass(frozen=True)
class Func(ValueExpr):
    """Device scalar transform: closed-form math (datetime extraction
    over epoch millis via civil-from-days integer arithmetic, casts,
    abs/floor/ceil/sqrt...). The device lowering of the reference's
    transform-function classes (DateTimeTransformFunction, CastTransform
    Function, ...); host peers live in query/functions.py and MUST agree
    exactly — oracle tests compare the two paths."""
    name: str
    args: Tuple["ValueExpr", ...]


@dataclass(frozen=True)
class Case(ValueExpr):
    """CASE WHEN <pred> THEN <value> ... ELSE <value> END as a where
    chain (CaseTransformFunction device lowering)."""
    whens: Tuple[Tuple["Pred", "ValueExpr"], ...]
    else_: "ValueExpr"


# ---------------------------------------------------------------------------
# Predicates (operator/filter/ + predicate evaluators in reference)
# ---------------------------------------------------------------------------

class Pred:
    pass


@dataclass(frozen=True)
class TrueP(Pred):
    pass


@dataclass(frozen=True)
class FalseP(Pred):
    pass


@dataclass(frozen=True)
class EqId(Pred):
    """stored[col] == params[param] — dict-id equality (the planner resolved
    the literal through the sorted dictionary; absent values fold to FalseP).

    negated: VALUE-level negation (!=). Distinct from wrapping in Not() for
    multi-value columns: `mv != x` matches when ANY value differs
    (reference NotEqualsPredicateEvaluator applyMV), while NOT(mv = x)
    matches when NO value equals. Identical for single-value columns."""
    col: int
    param: int
    negated: bool = False


@dataclass(frozen=True)
class IdRange(Pred):
    """lo <= stored[col] <= hi over dict ids or raw sorted-comparable values.
    Bounds are params (inclusive). The planner turns >,>=,<,<=,BETWEEN on
    dict columns into inclusive id ranges via Dictionary.id_range —
    the sorted-dictionary trick that replaces Pinot's RangeIndexBasedFilterOperator.
    negated: value-level NOT BETWEEN (see EqId.negated)."""
    col: int
    lo_param: Optional[int]
    hi_param: Optional[int]
    negated: bool = False


@dataclass(frozen=True)
class InSet(Pred):
    """stored[col] IN params[param] (padded to static length n with a
    sentinel that matches nothing). InPredicateEvaluator analog.
    negated: value-level NOT IN (see EqId.negated)."""
    col: int
    param: int
    n: int
    negated: bool = False


@dataclass(frozen=True)
class InBitmap(Pred):
    """stored[col] IN <set>, where params[param] is a (cardinality,) bool
    presence table over dict ids — one gather per value instead of the
    O(rows x set) broadcast compare InSet pays. The planner picks this for
    dict columns once the resolved id set exceeds INSET_BITMAP_MIN
    (reference: DictionaryBasedInPredicateEvaluator, which likewise
    precomputes the matching-id set once)."""
    col: int
    param: int
    negated: bool = False


@dataclass(frozen=True)
class Cmp(Pred):
    """Generic comparison on a value expression (raw-column / expression
    filters — ScanBasedFilterOperator + ExpressionFilterOperator analog).
    op in {'==','!=','<','<=','>','>='}; rhs is params[param]."""
    lhs: ValueExpr
    op: str
    param: int


@dataclass(frozen=True)
class MaskParam(Pred):
    """A precomputed per-doc bool mask passed as a kernel param. Serves
    null checks (NullPredicateEvaluator analog: params hold the unpacked
    null bitmap) and upsert validDocIds (queryableDocIds in the reference's
    upsert path — pinot-segment-local/.../upsert/)."""
    param: int


IsNull = MaskParam  # historical alias


@dataclass(frozen=True)
class And(Pred):
    children: Tuple[Pred, ...]


@dataclass(frozen=True)
class Or(Pred):
    children: Tuple[Pred, ...]


@dataclass(frozen=True)
class Not(Pred):
    child: Pred


# ---------------------------------------------------------------------------
# Aggregations (query/aggregation/function/ — 91 classes in reference; the
# core numeric family here, sketches later)
# ---------------------------------------------------------------------------

AGG_KINDS = ("count", "sum", "min", "max", "avg", "distinct_count")


@dataclass(frozen=True)
class AggSpec:
    kind: str                      # one of AGG_KINDS
    value: Optional[ValueExpr]     # None for COUNT(*)
    integral: bool = False         # exact int64 accumulation when True
    # distinct_count over a dict column: cardinality for the presence bitmap
    card: Optional[int] = None
    # magnitude bound (bits) of the integral value expression; sizes the
    # int8-limb decomposition of the MXU group-sum (kernels._limb_rows).
    # The planner tightens it via interval arithmetic over column min/max.
    bits: int = 63
    # False when the planner proved the value non-negative (halves the limbs)
    signed: bool = True
    # enableNullHandling: params[null_param] is the input column's null
    # mask — the aggregation skips those rows and reports the non-null
    # count so SUM/MIN/MAX over all-null inputs finalize to null
    # (NullableSingleInputAggregationFunction semantics)
    null_param: Optional[int] = None


# ---------------------------------------------------------------------------
# The kernel plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SelectPlan:
    """Device selection/order-by: filter mask -> composite int64 order key
    -> jax.lax.top_k -> gather the selected columns at the winners.

    Reference parity: operator/query/LinearSelectionOrderByOperator.java
    (per-segment top offset+limit rows under the order, merged at broker
    reduce). order entries are (col, desc, card): dict columns compose by
    id (sorted dictionaries make id order == value order), card=0 marks a
    raw integral column; the planner guarantees the composite fits 63
    bits. k = offset + limit. Empty order = doc order (selection-only
    early-exit analog)."""
    pred: Pred
    select_cols: Tuple[int, ...]
    order: Tuple[Tuple[int, bool, int], ...]
    k: int


# ---------------------------------------------------------------------------
# Cross-stage fused IR (whole-plan compilation, multistage/fused.py)
#
# A multi-stage join pipeline runs as ONE device program: each stage
# boundary that the mailbox plane would serve with a host exchange becomes
# an explicit Exchange node ('hash' -> a bucket exchange across devices,
# 'broadcast' -> replication of the build side). The nodes carry exactly
# the static facts the verifier (analysis/plan_verify.py PV2xx) needs:
# partition count, key slots, dtypes, and the per-shard shapes that must
# stay stable across collective boundaries. Like KernelPlan, everything
# here is frozen/hashable.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Exchange:
    """One stage boundary inside a fused plan. ``partitions`` is the
    device count the exchange runs over (1 = one device); ``key_slots``
    are the table ordinals naming which already-joined table each
    probe-key slot gathers from; ``cap`` is the pow2 per-device bucket
    capacity of a hash exchange (0 for broadcast — replication has no
    bucket)."""
    kind: str                           # 'hash' | 'broadcast'
    partitions: int
    key_slots: Tuple[int, ...]          # probe-side owner table ordinals
    key_dtype: str = "int32"
    cap: int = 0


@dataclass(frozen=True)
class FusedJoin:
    """One join stage of the fused program: the exchange that feeds it
    plus the dense-formulation statics (ops/join.device_equi_join).
    ``build_rows`` is the padded build-side length (static shape);
    ``max_dup`` the pow2 build-key multiplicity bound."""
    exchange: Exchange
    how: str                            # 'inner' | 'left'
    max_dup: int
    build_rows: int


@dataclass(frozen=True)
class FusedPlan:
    """The whole-plan IR: N join stages over ``n_tables`` relations,
    probe seed of ``base_rows`` (padded) rows sharded over
    ``partitions`` devices. ``pos_bound`` = base_rows * prod(max_dup)
    is the canonical-position domain — it must fit the accumulator
    dtype (``acc_dtype``) or the host cannot restore hash_join's
    canonical row order after the program returns."""
    stages: Tuple[FusedJoin, ...]
    n_tables: int
    base_rows: int
    partitions: int
    pos_bound: int
    acc_dtype: str = "int32"


@dataclass(frozen=True)
class KernelPlan:
    """Everything the kernel builder needs, hashable. group_keys is a tuple
    of (col_index, cardinality): group-by keys must be dict-encoded stored
    columns; the dense group key is cartesian dict-id arithmetic exactly
    like DictionaryBasedGroupKeyGenerator.java:63.

    strategy selects the group-by execution shape (ops/kernels.py):
    - 'dense':   scatter-add over all rows — small group spaces;
    - 'compact': masked-row compaction (ops/compact.py, a CUDA kernel on
      the card), then a factorized scatter (small spaces) or sort +
      boundary diffs (large spaces) over the compacted rows only.
    """
    pred: Pred
    aggs: Tuple[AggSpec, ...]
    group_keys: Tuple[Tuple[int, int], ...] = ()
    strategy: str = "dense"
    # expression group keys (GROUP BY YEAR(ts), ...): parallel to
    # group_keys; entry k, when not None, is a ValueExpr already shifted
    # into [0, card_k) — evaluated instead of cols[col_idx]. Expression
    # keys force the dense strategy (compaction gathers key columns by
    # index). () means all-column keys.
    key_exprs: Tuple[Optional["ValueExpr"], ...] = ()

    @property
    def group_space(self) -> int:
        s = 1
        for _, card in self.group_keys:
            s *= max(card, 1)
        return s

    @property
    def is_group_by(self) -> bool:
        return len(self.group_keys) > 0
