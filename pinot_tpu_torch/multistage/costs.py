"""Group-by strategy cost model, main-path subset.

Port of ``ir_selectivity``, ``compact_slots_cap``,
``scaled_compact_cap``, ``choose_group_strategy`` and the selectivity
drift test (``selectivity_drift``) from
``pinot_tpu/multistage/costs.py``. The port's compaction
(``ops/compact.py``) is exact on every device, so the capacity always
takes the reference's exact branch (``CAP_SAFETY_XLA``), and the
strategy choice always takes its non-scatter branch. The join
estimates and join ordering of the reference module belong to the
multi-stage engine, which is not ported yet.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

DEFAULT_SEL = 0.25          # Calcite's RelMdUtil guess for opaque predicates
EQ_DEFAULT_SEL = 0.15       # eq against an un-profiled column
MIN_SEL = 1e-6


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
