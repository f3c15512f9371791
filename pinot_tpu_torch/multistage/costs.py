"""Cost model: the group-by strategy and the multi-stage engine's
estimates.

Port of ``pinot_tpu/multistage/costs.py``:

- the multi-stage estimates from segment metadata (``TableStats``,
  ``selectivity``, ``scan_cardinality``, ``join_cardinality``), the
  greedy INNER-join order (``order_inner_joins``) and the fused-vs-
  mailbox plane choice (``choose_multistage_plane``); estimates only
  steer physical choices, correctness never depends on them;
- ``ir_selectivity``, ``compact_slots_cap``, ``scaled_compact_cap``,
  ``choose_group_strategy`` and the selectivity drift test
  (``selectivity_drift``). The port's compaction (``ops/compact.py``)
  is exact on every device, so the capacity always takes the
  reference's exact branch (``CAP_SAFETY_XLA``), and the strategy choice
  always takes its non-scatter branch.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..query.sql import (Between, BoolAnd, BoolNot, BoolOr, Comparison,
                         Identifier, InList, IsNull, Like, Literal)

DEFAULT_SEL = 0.25          # Calcite's RelMdUtil guess for opaque predicates
EQ_DEFAULT_SEL = 0.15       # eq against an un-profiled column
MIN_SEL = 1e-6


class TableStats:
    """Aggregated column statistics for one table's loaded segments."""

    def __init__(self, total_docs: int,
                 cols: Dict[str, Dict[str, Any]]):
        self.total_docs = total_docs
        self.cols = cols          # col -> {ndv, min, max}

    @classmethod
    def from_segments(cls, segments: Sequence[Any]) -> "TableStats":
        total = 0
        cols: Dict[str, Dict[str, Any]] = {}
        for seg in segments:
            total += seg.n_docs
            for name, m in seg.columns.items():
                c = cols.setdefault(name, {"ndv": 0, "min": None,
                                           "max": None})
                # only profiled cardinalities count: consuming mutable
                # segments report 0, and flooring them to 1 would fake an
                # NDV of n_segments and poison equality selectivity
                c["ndv"] += int(getattr(m, "cardinality", 0) or 0)
                for attr, pick in (("min", min), ("max", max)):
                    v = getattr(m, attr, None)
                    if v is None or isinstance(v, str):
                        continue
                    cur = c[attr]
                    c[attr] = v if cur is None else pick(cur, v)
        return cls(total, cols)

    def ndv(self, col: str) -> Optional[int]:
        c = self.cols.get(col)
        if c is None or not c["ndv"]:
            return None
        # summing per-segment cardinalities over-counts shared values;
        # cap at totalDocs (an NDV can never exceed the row count)
        return min(c["ndv"], max(self.total_docs, 1))

    def value_range(self, col: str) -> Optional[Tuple[float, float]]:
        c = self.cols.get(col)
        if c is None or c["min"] is None or c["max"] is None:
            return None
        return float(c["min"]), float(c["max"])


def _col_of(e: Any) -> Optional[str]:
    return e.name.split(".")[-1] if isinstance(e, Identifier) else None


def selectivity(pred: Any, stats: TableStats) -> float:
    """Fraction of rows a single-table predicate keeps (RelMdSelectivity
    analog over segment metadata)."""
    if pred is None:
        return 1.0
    if isinstance(pred, BoolAnd):
        s = 1.0
        for c in pred.children:
            s *= selectivity(c, stats)
        return max(s, MIN_SEL)
    if isinstance(pred, BoolOr):
        s = 1.0
        for c in pred.children:
            s *= 1.0 - selectivity(c, stats)
        return max(1.0 - s, MIN_SEL)
    if isinstance(pred, BoolNot):
        return max(1.0 - selectivity(pred.child, stats), MIN_SEL)
    if isinstance(pred, Comparison):
        col = _col_of(pred.lhs) or _col_of(pred.rhs)
        if col is None:
            return DEFAULT_SEL
        if pred.op == "==":
            ndv = stats.ndv(col)
            return max(1.0 / ndv, MIN_SEL) if ndv else EQ_DEFAULT_SEL
        if pred.op == "!=":
            ndv = stats.ndv(col)
            return 1.0 - (1.0 / ndv if ndv else EQ_DEFAULT_SEL)
        # range: fraction of the [min, max] span on the literal side
        lit = pred.rhs if isinstance(pred.rhs, Literal) else (
            pred.lhs if isinstance(pred.lhs, Literal) else None)
        rng = stats.value_range(col)
        if lit is None or rng is None or \
                not isinstance(lit.value, (int, float)) or \
                isinstance(lit.value, bool):
            return DEFAULT_SEL
        lo, hi = rng
        if hi <= lo:
            return DEFAULT_SEL
        frac = (float(lit.value) - lo) / (hi - lo)
        frac = min(max(frac, 0.0), 1.0)
        op = pred.op
        if isinstance(pred.lhs, Literal):   # lit <op> col: flip
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        return max(frac if op in ("<", "<=") else 1.0 - frac, MIN_SEL)
    if isinstance(pred, Between):
        col = _col_of(pred.expr)
        rng = stats.value_range(col) if col else None
        if rng and isinstance(pred.lo, Literal) and \
                isinstance(pred.hi, Literal) and \
                isinstance(pred.lo.value, (int, float)) and \
                isinstance(pred.hi.value, (int, float)):
            lo, hi = rng
            if hi > lo:
                frac = (min(float(pred.hi.value), hi)
                        - max(float(pred.lo.value), lo)) / (hi - lo)
                s = min(max(frac, MIN_SEL), 1.0)
                return 1.0 - s if pred.negated else s
        return DEFAULT_SEL
    if isinstance(pred, InList):
        col = _col_of(pred.expr)
        ndv = stats.ndv(col) if col else None
        k = len(pred.values)
        s = min(k / ndv, 1.0) if ndv else min(k * EQ_DEFAULT_SEL, 0.5)
        s = max(s, MIN_SEL)
        return 1.0 - s if pred.negated else s
    if isinstance(pred, Like):
        return 0.05 if not pred.negated else 0.95
    if isinstance(pred, IsNull):
        return 0.1 if not pred.negated else 0.9
    return DEFAULT_SEL


def scan_cardinality(stats: TableStats, pred: Any) -> float:
    return max(stats.total_docs * selectivity(pred, stats), 1.0)


def join_cardinality(l_rows: float, r_rows: float,
                     l_ndv: Optional[int], r_ndv: Optional[int]) -> float:
    """|L x R| / max(NDV_l, NDV_r) — System-R / RelMdRowCount equi-join
    estimate; missing NDVs degrade to max(|L|, |R|) (FK-join guess)."""
    ndv = max(l_ndv or 0, r_ndv or 0)
    if ndv <= 0:
        return max(l_rows, r_rows)
    return max(l_rows * r_rows / ndv, 1.0)


# relative per-row cost constants (1.0 = one fused streaming pass). These
# are the reference's values, calibrated there for the CPU and the TPU;
# nothing here has been calibrated on the H100 yet.
COST_COMPACT_PASS = 3.0     # the compaction pass over every row
COST_SORT_ROW = 0.5         # per row per log2(rows) per sort operand
COST_MAC = 1.0 / 256.0      # one int8 MAC on the MXU relative to a pass
COST_POST_MAC = COST_MAC / 4    # factorized two-sided one-hot after
                                # compaction: no (rows, space) operand ever
                                # streams through HBM, so its effective MAC
                                # rate is ~4x the dense one-hot formulation
COST_OUT_ROW = 0.5          # dense (space,) output materialization
CAP_SAFETY_XLA = 4.0        # exact compaction: margin over the estimate


def ir_selectivity(pred: Any, params: Sequence[Any],
                   col_cards: Dict[int, int]) -> float:
    """Selectivity of a resolved kernel-IR predicate tree.

    ``params`` are the planner's raw parameter values (literal dict ids /
    bounds / presence tables); symbolic markers (device dict values, null
    masks, ...) degrade to conservative defaults. ``col_cards`` maps the
    kernel column index to the column's dictionary cardinality (absent or
    0 = unprofiled)."""
    from ..ops import ir as _ir

    def val(i):
        if i is None or i >= len(params):
            return None
        p = params[i]
        if isinstance(p, (bool, np.bool_)):
            return None
        if isinstance(p, (int, float, np.integer, np.floating)):
            return float(p)
        return None

    def sel(p) -> float:
        if isinstance(p, _ir.TrueP):
            return 1.0
        if isinstance(p, _ir.FalseP):
            return 0.0
        if isinstance(p, _ir.And):
            s = 1.0
            for c in p.children:
                s *= sel(c)
            return max(s, MIN_SEL)
        if isinstance(p, _ir.Or):
            s = 1.0
            for c in p.children:
                s *= 1.0 - sel(c)
            return max(1.0 - s, MIN_SEL)
        if isinstance(p, _ir.Not):
            return max(1.0 - sel(p.child), MIN_SEL)
        if isinstance(p, _ir.EqId):
            card = col_cards.get(p.col)
            s = 1.0 / card if card else EQ_DEFAULT_SEL
            return max(1.0 - s, MIN_SEL) if p.negated else max(s, MIN_SEL)
        if isinstance(p, _ir.IdRange):
            card = col_cards.get(p.col)
            if not card:
                return DEFAULT_SEL
            lo = val(p.lo_param)
            hi = val(p.hi_param)
            lo = 0.0 if lo is None else max(lo, 0.0)
            hi = float(card - 1) if hi is None else min(hi, card - 1)
            span = max(hi - lo + 1.0, 0.0)
            s = min(max(span / card, MIN_SEL), 1.0)
            return max(1.0 - s, MIN_SEL) if p.negated else s
        if isinstance(p, _ir.InSet):
            card = col_cards.get(p.col)
            s = min(p.n / card, 1.0) if card \
                else min(p.n * EQ_DEFAULT_SEL, 0.5)
            s = max(s, MIN_SEL)
            return max(1.0 - s, MIN_SEL) if p.negated else s
        if isinstance(p, _ir.InBitmap):
            card = col_cards.get(p.col)
            tbl = params[p.param] if p.param < len(params) else None
            if card and isinstance(tbl, np.ndarray) and \
                    tbl.dtype == np.bool_:
                s = max(float(tbl.sum()) / max(card, 1), MIN_SEL)
            else:
                s = DEFAULT_SEL
            return max(1.0 - s, MIN_SEL) if p.negated else s
        if isinstance(p, _ir.Cmp):
            return DEFAULT_SEL
        if isinstance(p, _ir.MaskParam):
            # null masks / validDocs: usually nearly-all-true; stay
            # conservative (larger capacity) rather than tight
            return 1.0
        return DEFAULT_SEL

    return min(max(sel(pred), MIN_SEL), 1.0)


# est-vs-measured selectivity drift factor past which a plan's compact
# capacity is re-derived from the MEASURED fraction (query/planner.py reads
# ops/plan_cache.measured_for). 4x matches CAP_SAFETY_XLA: a smaller drift
# is already absorbed by the capacity's safety margin and pow2
# quantization. PINOT_DRIFT_RATIO overrides.
SELECTIVITY_DRIFT_RATIO = 4.0
_DRIFT_RATIO_DEFAULT: Optional[float] = None


def _drift_ratio_default() -> float:
    """PINOT_DRIFT_RATIO parsed ONCE (selectivity_drift sits on the
    planner's path); a malformed value falls back to the default."""
    global _DRIFT_RATIO_DEFAULT
    if _DRIFT_RATIO_DEFAULT is None:
        raw = os.environ.get("PINOT_DRIFT_RATIO")
        try:
            _DRIFT_RATIO_DEFAULT = float(raw) if raw is not None \
                else SELECTIVITY_DRIFT_RATIO
        except ValueError:
            _DRIFT_RATIO_DEFAULT = SELECTIVITY_DRIFT_RATIO
    return _DRIFT_RATIO_DEFAULT


def selectivity_drift(est: Optional[float], meas: Optional[float],
                      ratio: Optional[float] = None) -> bool:
    """True when the estimated and measured selectivity disagree by more
    than the drift factor (either direction). Both sides floor at MIN_SEL
    so a zero-matched run keeps the ratio finite."""
    if est is None or meas is None:
        return False
    if ratio is None:
        ratio = _drift_ratio_default()
    e = max(est, MIN_SEL)
    m = max(meas, MIN_SEL)
    return e / m > ratio or m / e > ratio


def _pow2_at_least(x: float) -> int:
    n = max(int(x), 1)
    return 1 << (n - 1).bit_length()


def compact_slots_cap(n_rows: int, sel: float) -> int:
    """Cost-model compaction capacity (slot rows of 128 elements) for the
    compact group-by strategy, quantized to a power of two. Compaction is
    exact, so capacity tracks the estimated matched rows with a safety
    margin and a small floor. Underestimates are safe: the kernel reports
    overflow and the executor retries at full_slots_cap."""
    from ..ops.compact import LANES, MIN_SLOTS, full_slots_cap

    full = full_slots_cap(n_rows)
    est_rows = max(n_rows * min(max(sel, 0.0), 1.0), 1.0)
    slots = _pow2_at_least(est_rows * CAP_SAFETY_XLA / LANES)
    return int(min(max(slots, MIN_SLOTS), full))


def scaled_compact_cap(plan, n_rows: int) -> Optional[int]:
    """A CompiledPlan's cost-model compaction capacity re-derived for a
    different row count (the segmented multi-segment dispatch of
    engine/batch.py); None when the planner picked no cost-model cap."""
    if plan.slots_cap is None or plan.est_selectivity is None:
        return None
    return compact_slots_cap(n_rows, plan.est_selectivity)


def choose_group_strategy(n_rows: int, space: int, sel: float,
                          platform: str, needs_sort: bool, n_payloads: int,
                          dense_viable: bool, compact_ok: bool,
                          force: Optional[str] = None
                          ) -> Tuple[str, Dict[str, Any]]:
    """Pick 'dense' vs 'compact' for a group-by kernel plan from relative
    cost estimates; returns (strategy, trace). ``force`` (the
    groupByStrategy query option) overrides the cost comparison when the
    forced strategy is structurally possible. Structural gates
    (dense_viable / compact_ok) always win over costs."""
    import math

    trace: Dict[str, Any] = {"sel": round(sel, 8), "space": space,
                             "n_rows": n_rows, "platform": platform}
    if force in ("dense", "compact"):
        allowed = (force == "dense" and dense_viable) or \
                  (force == "compact" and compact_ok)
        if allowed:
            trace["forced"] = force
            return force, trace
    if not compact_ok:
        trace["reason"] = "compact structurally unavailable"
        return "dense", trace
    if not dense_viable:
        trace["reason"] = "dense structurally unavailable"
        return "compact", trace

    sel = min(max(sel, MIN_SEL), 1.0)
    payloads = max(n_payloads, 1)
    # dense = one pass over every row per payload; compact = compaction
    # pass + factorized or sorted post over ~matched rows
    cost_dense = n_rows * (1.0 + space * COST_MAC * payloads)
    post_rows = min(compact_slots_cap(n_rows, sel) * 128, n_rows)
    if needs_sort:
        post = post_rows * COST_SORT_ROW * \
            max(math.log2(max(post_rows, 2)), 1.0)
    else:
        post = post_rows * space * COST_POST_MAC * payloads
    cost_compact = n_rows * COST_COMPACT_PASS + post \
        + space * COST_OUT_ROW
    trace["cost_dense"] = round(cost_dense)
    trace["cost_compact"] = round(cost_compact)
    return ("compact" if cost_compact < cost_dense else "dense"), trace


def order_inner_joins(joins: List[Any], base_label: str,
                      table_rows: Dict[str, float],
                      key_ndv_fn, equi_fn) -> Tuple[List[Any], List[Dict]]:
    """Greedy smallest-intermediate-first join order.

    ``joins``: the SQL JoinClause list. Only maximal runs of INNER joins
    reorder; LEFT joins are barriers (their probe side must contain every
    previously joined table, and null-extension order is semantic).
    ``equi_fn(join, joined_labels) -> bool`` tells whether the join's ON
    has an equi condition against the already-joined set (a reorder
    candidate must, or it would degenerate to a cross join).
    Returns (new_join_order, per-step estimate trace).
    """
    trace: List[Dict] = []
    out: List[Any] = []
    joined: Set[str] = {base_label}
    rows = table_rows.get(base_label, 1.0)
    pending = list(joins)
    while pending:
        # the barrier prefix rule: any LEFT join must wait until every
        # join textually before it has executed (its semantics depend on
        # the accumulated left side), so only the INNER prefix of the
        # remaining list competes
        candidates = []
        for i, j in enumerate(pending):
            if j.join_type != "inner":
                break
            if equi_fn(j, joined):
                candidates.append((i, j))
        if not candidates:
            # either the head is a LEFT join or no inner candidate
            # connects yet: execute the head in textual order
            i, j = 0, pending[0]
            est = None
        else:
            best = None
            for i, j in candidates:
                r = table_rows.get(j.table.label, 1.0)
                ndv_l, ndv_r = key_ndv_fn(j, joined)
                est = join_cardinality(rows, r, ndv_l, ndv_r)
                if best is None or est < best[0]:
                    best = (est, i, j)
            est, i, j = best
        out.append(j)
        pending.pop(i)
        r = table_rows.get(j.table.label, 1.0)
        ndv_l, ndv_r = key_ndv_fn(j, joined)
        rows = join_cardinality(rows, r, ndv_l, ndv_r) \
            if j.join_type == "inner" else max(rows, 1.0)
        trace.append({"table": j.table.label, "rightRows": round(r),
                      "estRows": round(rows)})
        joined.add(j.table.label)
    return out, trace


# ---------------------------------------------------------------------------
# Whole-plan compilation: fused-vs-mailbox plane choice
# ---------------------------------------------------------------------------

FUSED_MIN_ROWS = 100_000    # est. probe rows below which the device
                            # round-trip cannot beat host hash_join
FUSED_MAX_WIDTH = 256       # joined-relation column budget: the fused
                            # gather materializes every needed column


def _fused_min_rows() -> int:
    import os
    return int(os.environ.get("PINOT_FUSED_MIN_ROWS", FUSED_MIN_ROWS))


def choose_multistage_plane(n_dev: int, est_rows: float, width: int,
                            key_card: Optional[float] = None,
                            force: Optional[str] = None
                            ) -> Tuple[str, Dict]:
    """'fused' or 'mailbox' for a co-located multi-stage plan.

    Estimates only ever steer the physical choice — the fused planner
    (multistage/fused.py) re-checks every gate exactly against the
    scanned relations and falls back to the mailbox plane, so
    correctness never depends on the numbers here. ``force`` carries
    the OPTION(multistageFused=...) override; it wins whenever the
    plan is structurally fuseable at all."""
    trace: Dict[str, Any] = {"nDev": n_dev, "estRows": round(est_rows),
                             "width": width}
    if key_card is not None:
        trace["keyCard"] = round(key_card)
    if force in ("fused", "mailbox"):
        trace["forced"] = force
        return force, trace
    if est_rows < _fused_min_rows():
        trace["reason"] = f"estRows<{_fused_min_rows()}"
        return "mailbox", trace
    if width > FUSED_MAX_WIDTH:
        trace["reason"] = f"width>{FUSED_MAX_WIDTH}"
        return "mailbox", trace
    if key_card is not None and key_card > 2**31 - 1:
        trace["reason"] = "keyCard>int32"
        return "mailbox", trace
    trace["reason"] = "fused"
    return "fused", trace
