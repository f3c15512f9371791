"""Kernel builder: KernelPlan -> a function of torch tensors, main-path subset.

Port of ``build_kernel`` from ``pinot_tpu/ops/kernels.py``. A query runs
over one segment as eager torch ops on the segment's device: predicates
evaluate to a whole-segment bool mask, projections are gathers through the
dictionary, aggregations are masked reductions. The output dict has the
reference's names, dtypes and meaning (``matched``, ``overflow``,
``agg{i}_{kind}``, ``_sum``/``_cnt``, ``group_count``, ``group_idx``,
``group_overflow``), so ``engine/executor.extract_partial`` consumes it as
the reference's does.

What changes on the way from XLA on a TPU:
- integer sums are exact int64 ``scatter_add_``/``sum``, not the TPU's
  int8-limb one-hot matmuls; float sums accumulate in float64;
- the compact group-by runs the CUDA compaction kernel (ops/compact.py),
  which is exact, then sizes its post-aggregation from the synced matched
  count, so the reference's static-shape size ladder and two-pass
  re-tighten are gone;
- the factorized post is a scatter over the compacted rows (no one-hot
  operands); the sorted posts use a stable ``torch.sort``,
  ``searchsorted`` and int64 cumsum differences.

- the device sketches hash in int64 (torch's uint64 covers few ops):
  multiplication wraps to the same bits, logical right shifts mask off
  the sign extension, and the theta sort flips the sign bit so signed
  order is unsigned order;
- the selection kernel (K9) takes its top k from a stable descending
  sort, which keeps ``lax.top_k``'s lower-index-first order among ties;
- the segmented compact kernel (K11) evaluates each segment's predicate
  on its own row of the stacked columns and then runs ONE compaction over
  the S*bucket flattened rows.
"""
from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..device import FLOAT_ACC, INT_ACC
from .ir import (AggSpec, And, Bin, Case, Cmp, Col, EqId, FalseP, Func,
                 IdRange, InBitmap, InSet, KernelPlan, Lit, MaskParam,
                 MvReduce, Not, Or, Pred, SelectPlan, TrueP, ValueExpr)

Tensor = torch.Tensor

# IN lists longer than this use sorted membership (raw values); dict
# columns take a presence table past INSET_BITMAP_MIN (planner)
INSET_SEARCH_MIN = 64
INSET_BITMAP_MIN = 64

# compact-strategy limits shared with the planner
FACTORIZED_GROUP_LIMIT = 1 << 14
COMPACT_GROUP_LIMIT = 1 << 22

# dense (space,) group outputs at or above this space are gathered down
# to the live groups before they leave the device
GROUP_XFER_SPACE = 1 << 15
GROUP_XFER_CAP = 1 << 15

_IMIN64 = -(1 << 63)
_IMIN32 = -(1 << 31)


def sum_carrier_dtype(bits: int) -> torch.dtype:
    """Narrowest exact carrier for a compact-path integral sum payload
    whose magnitude the planner bounded at ``bits``: values under 2^31
    ride int32 through the compaction (half the bytes)."""
    return torch.int32 if bits < 32 else torch.int64


def _take(vals: Tensor, ids: Tensor) -> Tensor:
    """vals[ids] for int32 or int64 ids of any shape, without widening
    the ids (index_select takes int32 indices as they are)."""
    return torch.index_select(vals, 0, ids.reshape(-1)).reshape(ids.shape)


def _promote(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """JAX's promotion for two arrays: a 0-d param is strongly typed there,
    while torch would let a 0-d tensor lose to the other operand's type
    (int32 column + int64 literal would stay int32)."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t), b.to(t)


# ---------------------------------------------------------------------------
# value expressions
# ---------------------------------------------------------------------------

def _eval_value(ve: ValueExpr, cols, params, promote: bool = False
                ) -> Tensor:
    """promote=True upcasts integral column leaves to int64 so products in
    aggregation expressions (SUM(price * discount)) can't wrap int32."""
    if isinstance(ve, Col):
        arr = cols[ve.col]
        if ve.dict_param is not None:
            arr = _take(params[ve.dict_param], arr)
        if promote and not arr.dtype.is_floating_point \
                and arr.dtype != torch.bool:
            arr = arr.to(INT_ACC)
        return arr
    if isinstance(ve, Lit):
        return params[ve.param]
    if isinstance(ve, MvReduce):
        ids = cols[ve.col]                       # (N, M) int32, pad -1
        present = ids >= 0
        if ve.mode == "count":
            return present.sum(-1).to(INT_ACC)
        vals = ids
        if ve.dict_param is not None:
            vals = _take(params[ve.dict_param], ids.clamp(min=0))
        if promote and not vals.dtype.is_floating_point:
            vals = vals.to(INT_ACC)
        if ve.mode == "sum":
            return torch.where(present, vals, torch.zeros_like(vals)).sum(
                -1, dtype=vals.dtype)
        sign = 1 if ve.mode == "min" else -1
        filled = torch.where(present, vals, _extreme(vals.dtype, sign,
                                                     vals.device))
        return filled.amin(-1) if ve.mode == "min" else filled.amax(-1)
    if isinstance(ve, Bin):
        l, r = _promote(_eval_value(ve.lhs, cols, params, promote),
                        _eval_value(ve.rhs, cols, params, promote))
        if ve.op == "+":
            return l + r
        if ve.op == "-":
            return l - r
        if ve.op == "*":
            return l * r
        if ve.op == "/":
            # SQL division is double division (ArithmeticFunctions.divide)
            return l.to(FLOAT_ACC) / r.to(FLOAT_ACC)
        if ve.op == "%":
            return torch.remainder(l, r)
        if ve.op == "//":
            return torch.floor_divide(l, r)
        raise ValueError(f"unknown binary op {ve.op!r}")
    if isinstance(ve, Func):
        args = [_eval_value(a, cols, params, promote) for a in ve.args]
        return _eval_func(ve.name, args)
    if isinstance(ve, Case):
        out = _eval_value(ve.else_, cols, params, promote)
        # all-literal CASE folds at bucket 1 and returns a scalar
        scalar = not cols and not out.dim()
        bucket = (cols[0].shape[0] if cols
                  else (out.shape[0] if out.dim() else 1))
        out = out.expand((bucket,) + tuple(out.shape[1:]))
        # reverse order: the first matching WHEN must win
        for pred, val in reversed(ve.whens):
            m = _eval_pred(pred, cols, params, bucket,
                           out.device).reshape(bucket)
            v, o = _promote(_eval_value(val, cols, params, promote), out)
            out = torch.where(m, v, o)
        return out[0] if scalar else out
    raise TypeError(f"unknown value expr {ve!r}")


# closed-form datetime math over epoch millis (Howard Hinnant's
# civil-from-days); semantics match query/functions.py's host path
_MS_DAY = 86_400_000


def _fdiv(a: Tensor, b: int) -> Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _civil_ymd(days: Tensor):
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y: Tensor, m: Tensor, d: Tensor) -> Tensor:
    y = y - (m <= 2).to(y.dtype)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _eval_func(name: str, args) -> Tensor:
    a = args[0]
    if name in ("cast_long", "cast_int"):
        if a.dtype.is_floating_point:
            a = torch.trunc(a)  # C-style truncation (host cast_value)
        return a.to(torch.int64 if name == "cast_long" else torch.int32)
    if name in ("cast_double", "cast_float"):
        return a.to(torch.float64 if name == "cast_double"
                    else torch.float32)
    if name == "abs":
        return torch.abs(a)
    if name in ("floor", "ceil", "sqrt", "exp", "ln"):
        f = {"floor": torch.floor, "ceil": torch.ceil, "sqrt": torch.sqrt,
             "exp": torch.exp, "ln": torch.log}[name]
        return f(a.to(FLOAT_ACC))
    ms = a.to(torch.int64)
    days = _fdiv(ms, _MS_DAY)
    if name == "year":
        return _civil_ymd(days)[0]
    if name == "month":
        return _civil_ymd(days)[1]
    if name == "day":
        return _civil_ymd(days)[2]
    if name == "quarter":
        return _fdiv(_civil_ymd(days)[1] - 1, 3) + 1
    if name == "dayofweek":
        # 1=Monday..7=Sunday (epoch day 0 was a Thursday)
        return torch.remainder(days + 3, 7) + 1
    if name == "hour":
        return torch.remainder(_fdiv(ms, 3_600_000), 24)
    if name == "minute":
        return torch.remainder(_fdiv(ms, 60_000), 60)
    if name == "second":
        return torch.remainder(_fdiv(ms, 1000), 60)
    if name == "millisecond":
        return torch.remainder(ms, 1000)
    if name.startswith("trunc_"):
        unit = name[6:]
        step = {"second": 1000, "minute": 60_000, "hour": 3_600_000}
        if unit in step:
            return _fdiv(ms, step[unit]) * step[unit]
        if unit == "day":
            return days * _MS_DAY
        if unit == "week":
            # ISO week start (Monday); day 0 = Thursday -> offset 3
            return (_fdiv(days + 3, 7) * 7 - 3) * _MS_DAY
        y, m, _d = _civil_ymd(days)
        one = torch.ones_like(m)
        if unit == "month":
            return _days_from_civil(y, m, one) * _MS_DAY
        if unit == "quarter":
            return _days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1,
                                    one) * _MS_DAY
        if unit == "year":
            return _days_from_civil(y, one, one) * _MS_DAY
    raise ValueError(f"no device lowering for function {name!r}")


# ---------------------------------------------------------------------------
# predicates -> mask
# ---------------------------------------------------------------------------

def _val_negate(m: Tensor, arr: Tensor) -> Tensor:
    """Value-level negation (!=, NOT IN, NOT BETWEEN); MV pad slots (-1)
    stay unmatched."""
    m = ~m
    if arr.dim() == 2:
        m = m & (arr >= 0)
    return m


def _mv_any(m: Tensor) -> Tensor:
    """MV rows match when ANY value does; SV masks pass through."""
    return m.any(dim=-1) if m.dim() == 2 else m


def _eval_pred(p: Pred, cols, params, bucket: int,
               device: Optional[torch.device] = None) -> Tensor:
    dev = device if device is not None else _device_of(cols, params)
    if isinstance(p, TrueP):
        return torch.ones(bucket, dtype=torch.bool, device=dev)
    if isinstance(p, FalseP):
        return torch.zeros(bucket, dtype=torch.bool, device=dev)
    if isinstance(p, EqId):
        arr = cols[p.col]
        m = arr == params[p.param]
        return _mv_any(_val_negate(m, arr) if p.negated else m)
    if isinstance(p, IdRange):
        arr = cols[p.col]
        # out of place, so torch.func.vmap can carry it over stacked
        # params (engine/ragged.py evaluates it for N queries at once)
        parts = []
        if p.lo_param is not None:
            parts.append(torch.ge(*_promote(arr, params[p.lo_param])))
        if p.hi_param is not None:
            parts.append(torch.le(*_promote(arr, params[p.hi_param])))
        if p.lo_param is None and arr.dim() == 2:
            parts.append(arr >= 0)  # hi-only MV range: not the -1 pads
        if not parts:
            parts.append(torch.ones(arr.shape, dtype=torch.bool,
                                    device=arr.device))
        m = parts[0]
        for part in parts[1:]:
            m = m & part
        return _mv_any(_val_negate(m, arr) if p.negated else m)
    if isinstance(p, InSet):
        arr = cols[p.col]
        vals = params[p.param]  # (n,) sorted ascending
        if p.n > INSET_SEARCH_MIN:
            a, v = _promote(arr, vals)
            idx = torch.searchsorted(v, a.contiguous()).clamp(0, p.n - 1)
            m = v[idx] == a
        else:
            m = (arr.unsqueeze(-1) == vals).any(dim=-1)
        return _mv_any(_val_negate(m, arr) if p.negated else m)
    if isinstance(p, InBitmap):
        arr = cols[p.col]
        tbl = params[p.param]   # (cardinality,) bool presence over ids
        m = _take(tbl, arr.clamp(min=0)) & (arr >= 0)
        return _mv_any(_val_negate(m, arr) if p.negated else m)
    if isinstance(p, Cmp):
        l = _eval_value(p.lhs, cols, params)
        r = params[p.param]
        ops = {"==": torch.eq, "!=": torch.ne, "<": torch.lt,
               "<=": torch.le, ">": torch.gt, ">=": torch.ge}
        if p.op not in ops:
            raise ValueError(f"unknown cmp op {p.op!r}")
        return ops[p.op](*_promote(l, r))
    if isinstance(p, MaskParam):
        return params[p.param]
    if isinstance(p, And):
        m = _eval_pred(p.children[0], cols, params, bucket, dev)
        for c in p.children[1:]:
            m = m & _eval_pred(c, cols, params, bucket, dev)
        return m
    if isinstance(p, Or):
        m = _eval_pred(p.children[0], cols, params, bucket, dev)
        for c in p.children[1:]:
            m = m | _eval_pred(c, cols, params, bucket, dev)
        return m
    if isinstance(p, Not):
        return ~_eval_pred(p.child, cols, params, bucket, dev)
    raise TypeError(f"unknown predicate {p!r}")


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _device_of(cols, params) -> torch.device:
    for t in tuple(cols) + tuple(params):
        return t.device
    return torch.device("cpu")


def _extreme(dtype: torch.dtype, sign: int, device) -> Tensor:
    if dtype.is_floating_point:
        v = float("inf") if sign > 0 else float("-inf")
    else:
        info = torch.iinfo(dtype)
        v = info.max if sign > 0 else info.min
    return torch.tensor(v, dtype=dtype, device=device)


def _acc_dtype(spec: AggSpec) -> torch.dtype:
    return INT_ACC if spec.integral else FLOAT_ACC


def _agg_name(i: int, spec: AggSpec) -> str:
    return f"agg{i}_{spec.kind}"


def _segment_sum(vals: Tensor, keys: Tensor, nseg: int) -> Tensor:
    out = torch.zeros(nseg, dtype=vals.dtype, device=vals.device)
    return out.scatter_add_(0, keys, vals)


def _segment_reduce(vals: Tensor, keys: Tensor, nseg: int,
                    kind: str) -> Tensor:
    """Per-segment min/max; empty segments hold the kind's extreme."""
    sign = 1 if kind == "min" else -1
    out = _extreme(vals.dtype, sign, vals.device).repeat(nseg)
    return out.scatter_reduce_(0, keys, vals,
                               "amin" if kind == "min" else "amax")


# ---------------------------------------------------------------------------
# device sketches (K10): partial states match the host AggImpl registry
# exactly, so kernel partials merge with host partials in the broker reduce
# ---------------------------------------------------------------------------

def _i64(c: int) -> int:
    """A 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _lsr(x: Tensor, s: int) -> Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _clz64(x: Tensor) -> Tensor:
    """Leading zeros of non-zero int64 bit patterns: a branch-free binary
    search in six steps (torch has no clz)."""
    n = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for s in (32, 16, 8, 4, 2, 1):
        z = _lsr(x, 64 - s) == 0
        n = n + z.to(torch.int32) * s
        x = torch.where(z, x << s, x)
    return n


def _device_splitmix64(v: Tensor) -> Tensor:
    """aggregations._splitmix64 on device, bit-identical, as int64 bit
    patterns: the shared 64-bit hash for HLL/theta over raw numeric
    columns. Floats hash their float64 bits, like the host _hash64."""
    if v.dtype.is_floating_point:
        v = v.to(torch.float64).contiguous().view(torch.int64)
    x = v.to(torch.int64) + _i64(0x9E3779B97F4A7C15)
    x = (x ^ _lsr(x, 30)) * _i64(0xBF58476D1CE4E5B9)
    x = (x ^ _lsr(x, 27)) * _i64(0x94D049BB133111EB)
    return x ^ _lsr(x, 31)


def _agg_hashes(spec: AggSpec, cols, params) -> Tensor:
    """The 64-bit hash stream of a sketch aggregation: dict columns gather
    the per-id hash table (params[dict_param], host _hash64 over the
    dictionary values, md5 for strings); raw numeric columns hash on
    device."""
    ve = spec.value
    if isinstance(ve, Col) and ve.dict_param is not None:
        return _take(params[ve.dict_param], cols[ve.col])
    return _device_splitmix64(_eval_value(ve, cols, params))


def _presence(comb: Tensor, n_slots: int) -> Tensor:
    """(n_slots,) bool: which slot ids occur in comb (unmatched rows carry
    the sentinel n_slots). A scatter into a presence tensor: the same
    output as the reference's sort + searchsorted, without the sort."""
    pres = torch.zeros(n_slots + 1, dtype=torch.bool, device=comb.device)
    pres[comb.long()] = True
    return pres[:n_slots]


def _hll_slots(spec: AggSpec, cols, params):
    """(slot, r_levels): register index = top log2m hash bits, rank =
    leading zeros of the remainder + 1 (a sentinel bit bounds it), slot =
    idx * r_levels + (rank - 1); bit-identical to the host HllAgg._regs."""
    p = spec.card                    # log2m
    r_levels = 64 - p + 1
    h = _agg_hashes(spec, cols, params)
    idx = _lsr(h, 64 - p).to(torch.int32)
    rank = _clz64((h << p) | (1 << (p - 1))) + 1   # 1 .. R
    return idx * r_levels + (rank - 1), r_levels


def _scalar_hll(name: str, spec: AggSpec, mask, cols, params,
                out: Dict[str, Tensor]) -> None:
    """DISTINCTCOUNTHLL: (m * R) presence bitmap; extraction maxes over
    the rank axis into the host HllAgg register list."""
    slot, r_levels = _hll_slots(spec, cols, params)
    n_slots = (1 << spec.card) * r_levels
    out[name + "_present"] = _presence(torch.where(mask, slot, n_slots),
                                       n_slots)


def _scalar_theta(name: str, spec: AggSpec, mask, cols, params,
                  out: Dict[str, Tensor]) -> None:
    """KMV theta sketch: the k smallest DISTINCT hashes, (k,) int64 bit
    patterns with an all-ones sentinel. Sort in unsigned order (sign bit
    flipped, unmatched rows on the all-ones sentinel), flag first
    occurrences, gather the positions of unique ranks 1..k."""
    k = spec.card
    h = _agg_hashes(spec, cols, params)
    s = torch.sort(torch.where(mask, h, -1) ^ _IMIN64).values ^ _IMIN64
    uniq = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    uniq[1:] = s[1:] != s[:-1]
    ranks = torch.cumsum(uniq.to(torch.int32), 0, dtype=torch.int32)
    pos = torch.searchsorted(ranks, torch.arange(
        1, k + 1, dtype=torch.int32, device=s.device))
    picked = s[pos.clamp(max=s.shape[0] - 1)]
    valid = torch.arange(k, dtype=torch.int32, device=s.device) < ranks[-1]
    # sentinel-valued picks are unmatched-row hashes, not data
    out[name + "_hashes"] = torch.where(valid & (picked != -1), picked, -1)


def _scalar_percentile(name: str, spec: AggSpec, mask, cols, params,
                       out: Dict[str, Tensor]) -> None:
    """Mergeable quantile summary: sort of the matched values, equal-count
    chunk boundaries over the matched prefix, centroid means from float64
    prefix-sum differences; (C,) means + weights map to the host
    PercentileSketchAgg centroid list."""
    c = spec.card                    # number of centroids
    vals = _eval_value(spec.value, cols, params).to(FLOAT_ACC)
    s = torch.sort(torch.where(mask, vals, float("inf"))).values
    mcount = mask.sum(dtype=torch.int64)
    ps = torch.cumsum(torch.where(torch.isfinite(s), s, 0.0), 0)
    bounds = torch.arange(c + 1, dtype=torch.int64, device=s.device) \
        * mcount // c
    totals = torch.where(bounds > 0,
                         ps[(bounds - 1).clamp(0, s.shape[0] - 1)], 0.0)
    w = (bounds[1:] - bounds[:-1]).to(torch.int32)
    sums = totals[1:] - totals[:-1]
    out[name + "_pc_mean"] = torch.where(
        w > 0, sums / w.clamp(min=1).to(sums.dtype), 0.0)
    out[name + "_pc_w"] = w


_SKETCH_SCALAR = {"distinct_count_hll": _scalar_hll,
                  "distinct_count_theta": _scalar_theta,
                  "percentile_sketch": _scalar_percentile,
                  # RAW forms share the kernels: RawAgg delegates state
                  # to the inner sketch impl, only finalize serializes
                  "raw_hll": _scalar_hll,
                  "raw_theta": _scalar_theta,
                  "percentile_raw_sketch": _scalar_percentile}

_HLL_KINDS = ("distinct_count_hll", "raw_hll")

# grouped HLL presence bitmap cap: space * 2^log2m * rank_levels slots
# (bool); larger spaces keep the host registry
GROUPED_HLL_LIMIT = 1 << 23


def _group_hll(name: str, spec: AggSpec, mask, keys_s, space: int, cols,
               params, out: Dict[str, Tensor]) -> None:
    """Grouped DISTINCTCOUNTHLL: one combined (group, register, rank)
    presence bitmap; (space, m*R) bool rows merge across segments by OR,
    and extraction maxes ranks per group into HllAgg register lists."""
    slot, r_levels = _hll_slots(spec, cols, params)
    m = 1 << spec.card
    comb = torch.where(mask & (keys_s < space),
                       keys_s * (m * r_levels) + slot,
                       space * m * r_levels)
    out[name + "_present"] = _presence(comb, space * m * r_levels).reshape(
        space, m * r_levels)


# ---------------------------------------------------------------------------
# scalar (non-group-by) aggregation
# ---------------------------------------------------------------------------

def _scalar_agg(i: int, spec: AggSpec, mask: Tensor, cols, params,
                out: Dict[str, Tensor]) -> None:
    name = _agg_name(i, spec)
    if spec.null_param is not None:
        # enableNullHandling: skip null-input rows, report the non-null
        # count (extract finalizes all-null SUM/MIN/MAX to null from it)
        mask = mask & ~params[spec.null_param]
        out[name + "_nnz"] = mask.sum(dtype=INT_ACC)
    sketch_fn = _SKETCH_SCALAR.get(spec.kind)
    if sketch_fn is not None:
        sketch_fn(name, spec, mask, cols, params, out)
        return
    if spec.kind == "count":
        out[name] = mask.sum(dtype=INT_ACC)
        return
    if spec.kind == "distinct_count":
        ids = _eval_value(spec.value, cols, params).long()
        present = torch.zeros(spec.card + 1, dtype=torch.bool,
                              device=mask.device)
        present[torch.where(mask, ids, spec.card)] = True
        out[name + "_present"] = present[:spec.card]
        return
    if spec.kind not in ("sum", "min", "max", "avg"):
        raise ValueError(f"device {spec.kind!r} is not yet ported")
    vals = _eval_value(spec.value, cols, params, promote=spec.integral)
    acc = _acc_dtype(spec)
    vals = vals.to(acc)
    if spec.kind in ("sum", "avg"):
        s = torch.where(mask, vals, torch.zeros((), dtype=acc,
                                                device=vals.device)).sum()
        if spec.kind == "sum":
            out[name] = s
        else:
            out[name + "_sum"] = s
            out[name + "_cnt"] = mask.sum(dtype=INT_ACC)
        return
    sign = 1 if spec.kind == "min" else -1
    filled = torch.where(mask, vals, _extreme(acc, sign, vals.device))
    out[name] = filled.min() if spec.kind == "min" else filled.max()


# ---------------------------------------------------------------------------
# dense group-by
# ---------------------------------------------------------------------------

def _group_keys_sentinel(plan: KernelPlan, mask: Tensor, cols, params):
    """Cartesian dict-id group key (DictionaryBasedGroupKeyGenerator.java:63
    arithmetic) with unmatched rows (and out-of-range expression keys) on
    the sentinel key == plan.group_space. Returns (mask, keys_s int32)."""
    space = plan.group_space
    keys = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    exprs = plan.key_exprs or (None,) * len(plan.group_keys)
    for (col_idx, card), kexpr in zip(plan.group_keys, exprs):
        ids = cols[col_idx] if kexpr is None \
            else _eval_value(kexpr, cols, params)
        keys = keys * card + ids.to(torch.int32)
    if plan.key_exprs:
        mask = mask & (keys >= 0) & (keys < space)
    return mask, torch.where(mask, keys, space)


def _group_aggs(plan: KernelPlan, mask: Tensor, cols, params,
                out: Dict[str, Tensor]) -> None:
    """Dense group-by: exact int64 / float64 scatter-adds over every row,
    the sentinel segment sliced off (the TPU's int8-limb one-hot matmul
    has the same (space,) output contract)."""
    space = plan.group_space
    nseg = space + 1
    mask, keys_s = _group_keys_sentinel(plan, mask, cols, params)
    keys = keys_s.long()
    counts = _segment_sum(mask.to(INT_ACC), keys, nseg)[:space]
    out["group_count"] = counts
    for i, spec in enumerate(plan.aggs):
        name = _agg_name(i, spec)
        if spec.kind == "count":
            continue
        if spec.kind in _HLL_KINDS:
            _group_hll(name, spec, mask, keys_s, space, cols, params, out)
            continue
        if spec.kind == "distinct_count":
            ids = _eval_value(spec.value, cols, params).long()
            comb = torch.where(mask, keys * spec.card + ids,
                               space * spec.card)
            pres = torch.zeros(space * spec.card + 1, dtype=torch.bool,
                               device=mask.device)
            pres[comb] = True
            out[name + "_present"] = pres[:space * spec.card].reshape(
                space, spec.card)
            continue
        if spec.kind not in ("sum", "avg", "min", "max"):
            raise ValueError(f"device grouped {spec.kind!r} is not yet "
                             "ported")
        acc = _acc_dtype(spec)
        vals = _eval_value(spec.value, cols, params,
                           promote=spec.integral).to(acc)
        if spec.kind in ("sum", "avg"):
            s = _segment_sum(torch.where(mask, vals, torch.zeros(
                (), dtype=acc, device=vals.device)), keys, nseg)[:space]
            if spec.kind == "avg":
                out[name + "_sum"] = s
                out[name + "_cnt"] = counts
            else:
                out[name] = s
        else:
            out[name] = _segment_reduce(vals, keys, nseg, spec.kind)[:space]


# ---------------------------------------------------------------------------
# compacted group-by (CUDA compaction -> aggregate matched rows only)
# ---------------------------------------------------------------------------

def _to_orderable64(v: Tensor, integral: bool):
    """Order-preserving map to int64: integers pass through; floats map
    via the sign-flip bijection on their bit patterns (non-negatives keep
    their bits, negatives land below at imin + ~bits). Returns (orderable,
    mode) for _from_orderable64."""
    if integral:
        return v.to(torch.int64), "int"
    if v.dtype == torch.float64:
        bits = v.contiguous().view(torch.int64)
        return torch.where(bits >= 0, bits, _IMIN64 + ~bits), "f64"
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    o32 = torch.where(bits >= 0, bits, _IMIN32 + ~bits)
    return o32.to(torch.int64), "f32"


def _from_orderable64(o: Tensor, mode: str) -> Tensor:
    if mode == "int":
        return o
    if mode == "f64":
        o = o.to(torch.int64)
        bits = torch.where(o >= 0, o, ~(o - _IMIN64))
        return bits.contiguous().view(torch.float64)
    o32 = o.to(torch.int32)
    bits = torch.where(o32 >= 0, o32, ~(o32 - _IMIN32))
    return bits.contiguous().view(torch.float32).to(FLOAT_ACC)


def _to_orderable(v: Tensor, integral: bool):
    """_to_orderable64 at the narrowest exact carrier width: integers of
    32 bits or fewer and f32 orderables stay int32 (half the compaction
    bytes)."""
    if integral and not v.dtype.is_floating_point \
            and v.element_size() <= 4:
        return v.to(torch.int32), "int"
    o, mode = _to_orderable64(v, integral)
    if mode == "f32":
        return o.to(torch.int32), mode
    return o, mode


def _payload_columns(plan: KernelPlan, mask: Tensor, cols, params):
    """Every aggregation input evaluated ONCE over the full segment, masked
    and narrowed to its smallest exact carrier BEFORE compaction, so the
    compaction moves [key] + payloads and the post never re-evaluates
    value expressions. Returns (arrays, sum_jobs, mm_jobs, ord_modes) as
    the reference's ``_payload_columns`` does."""
    arrays: List[Tensor] = []
    sum_slots: Dict[Tuple, int] = {}
    ord_slots: Dict[object, int] = {}
    ord_modes: Dict[int, str] = {}
    sum_jobs: List[Tuple[int, AggSpec, int]] = []
    mm_jobs: List[Tuple[int, AggSpec, int]] = []
    for i, spec in enumerate(plan.aggs):
        if spec.kind == "count":
            continue
        if spec.kind in ("sum", "avg"):
            key = (spec.value, spec.integral)
            slot = sum_slots.get(key)
            if slot is None:
                if spec.integral:
                    v = _eval_value(spec.value, cols, params, promote=True)
                    v = v.to(sum_carrier_dtype(spec.bits))
                else:
                    v = _eval_value(spec.value, cols, params).to(FLOAT_ACC)
                v = torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                                     device=v.device))
                slot = len(arrays)
                sum_slots[key] = slot
                arrays.append(v)
            sum_jobs.append((i, spec, slot))
        elif spec.kind in ("min", "max"):
            slot = ord_slots.get(spec.value)
            if slot is None:
                v = _eval_value(spec.value, cols, params)
                integral = spec.integral and not v.dtype.is_floating_point
                o, mode = _to_orderable(v, integral)
                slot = len(arrays)
                ord_slots[spec.value] = slot
                ord_modes[slot] = mode
                arrays.append(o.contiguous())
            mm_jobs.append((i, spec, slot))
        else:
            raise ValueError(
                f"compact group-by cannot lower {spec.kind!r}")
    return tuple(arrays), sum_jobs, mm_jobs, ord_modes


def _needs_sort(plan: KernelPlan) -> bool:
    """Whether the compact strategy takes the sort path (vs the factorized
    post). Shared by path selection and the planner's cost model."""
    return (plan.group_space > FACTORIZED_GROUP_LIMIT
            or any(s.kind in ("min", "max") for s in plan.aggs))


def _compact_group_aggs(plan: KernelPlan, mask: Tensor, cols, params,
                        slots_cap: int, out: Dict[str, Tensor],
                        xfer_sparse: bool = False) -> None:
    """Group aggregation over compacted matched rows. One prefix builds
    the mask, the cartesian group key and every payload; ONE compaction
    call (the CUDA kernel on the card) moves [key] + payloads to the
    front; the post then runs over exactly the matched rows:

    - sorted (min/max present or space > FACTORIZED_GROUP_LIMIT): one
      stable lexicographic sort, searchsorted edges, cumsum differences;
      with ``xfer_sparse`` it emits (group_idx, value) pairs directly;
    - factorized (small spaces, sums only): scatter-adds into (space,).
    """
    from .compact import compact

    space = plan.group_space
    mask, keys_s = _group_keys_sentinel(plan, mask, cols, params)
    payloads, sum_jobs, mm_jobs, ord_modes = _payload_columns(
        plan, mask, cols, params)
    valid, comp, _n_valid, matched, overflow = compact(
        mask, (keys_s,) + payloads, slots_cap)
    out["overflow"] = overflow
    out["matched"] = matched.to(INT_ACC)
    # the one host sync of the compact path: the post is sized from it
    rows = min(int(matched), valid.shape[0])
    keys = comp[0][:rows]
    pls = tuple(c[:rows] for c in comp[1:])
    if _needs_sort(plan) and xfer_sparse:
        _sorted_post_sparse(sum_jobs, mm_jobs, ord_modes, keys, pls,
                            space, GROUP_XFER_CAP, out)
    elif _needs_sort(plan):
        _sorted_post(sum_jobs, mm_jobs, ord_modes, keys, pls, space, out)
    else:
        _factorized_post(sum_jobs, keys, pls, space, out)


def _factorized_post(sum_jobs, keys: Tensor, payloads, space: int,
                     out: Dict[str, Tensor]) -> None:
    """Small-space sums over the compacted rows: int64 / float64
    scatter-adds, one per distinct payload slot (the reference's two-sided
    one-hot matmul has the same dense (space,) output)."""
    k = keys.long()
    counts = _segment_sum(torch.ones_like(k), k, space)
    out["group_count"] = counts
    done: Dict[int, Tensor] = {}
    for i, spec, slot in sum_jobs:
        name = _agg_name(i, spec)
        s = done.get(slot)
        if s is None:
            s = done[slot] = _segment_sum(
                payloads[slot].to(_acc_dtype(spec)), k, space)
        if spec.kind == "avg":
            out[name + "_sum"] = s
            out[name + "_cnt"] = counts
        else:
            out[name] = s


def _sorted_post_common(sum_jobs, mm_jobs, keys: Tensor, payloads):
    """The slot dedup + ONE lexicographic sort both sorted posts share:
    by group key, then by the first min/max orderable. Returns
    (sorted_keys, sorted sum payloads {slot: tensor}, sorted orderables
    {slot: tensor})."""
    sum_slots: List[int] = []
    for _i, _s, slot in sum_jobs:
        if slot not in sum_slots:
            sum_slots.append(slot)
    mm_slots: List[int] = []
    for _i, _s, slot in mm_jobs:
        if slot not in mm_slots:
            mm_slots.append(slot)
    perm = None
    if mm_slots:
        perm = torch.sort(payloads[mm_slots[0]], stable=True).indices
    k = keys if perm is None else keys[perm]
    order = torch.sort(k, stable=True).indices
    if perm is not None:
        order = perm[order]
    sk = keys[order]
    sorted_sums = {s: payloads[s][order] for s in sum_slots}
    sorted_ord: Dict[int, Tensor] = {}
    for j, slot in enumerate(mm_slots):
        if j == 0:
            sorted_ord[slot] = payloads[slot][order]
        else:
            # each further distinct min/max expression needs its own
            # (key, orderable) order of the same rows
            p2 = torch.sort(payloads[slot], stable=True).indices
            p2 = p2[torch.sort(keys[p2], stable=True).indices]
            sorted_ord[slot] = payloads[slot][p2]
    return sk, sorted_sums, sorted_ord


def _run_sums(sorted_vals: Tensor, dtype: torch.dtype, starts: Tensor,
              ends: Tensor) -> Tensor:
    cs = torch.cumsum(sorted_vals.to(dtype), 0)
    tot = torch.cat([torch.zeros(1, dtype=dtype, device=cs.device), cs])
    return tot[ends] - tot[starts]


def _pick_minmax(mm_jobs, ord_modes, sorted_ord, starts: Tensor,
                 ends: Tensor, counts: Tensor, n_rows: int,
                 out: Dict[str, Tensor]) -> None:
    """Group min = first element of the run, max = last; empty groups take
    the kind's extreme (dense-path convention)."""
    for i, spec, slot in mm_jobs:
        name = _agg_name(i, spec)
        pos = starts if spec.kind == "min" else ends - 1
        pos = pos.clamp(0, max(n_rows - 1, 0))
        acc = _acc_dtype(spec)
        if n_rows:
            vals = _from_orderable64(sorted_ord[slot][pos],
                                     ord_modes[slot]).to(acc)
        else:
            vals = torch.zeros(pos.shape, dtype=acc, device=pos.device)
        out[name] = torch.where(
            counts > 0, vals,
            _extreme(acc, 1 if spec.kind == "min" else -1, vals.device))


def _sorted_post(sum_jobs, mm_jobs, ord_modes, keys: Tensor, payloads,
                 space: int, out: Dict[str, Tensor]) -> None:
    """Sort once, aggregate many: dense (space,) outputs from one sort of
    the compacted rows and one searchsorted edges array."""
    sk, sorted_sums, sorted_ord = _sorted_post_common(
        sum_jobs, mm_jobs, keys, payloads)
    probes = torch.arange(space + 1, dtype=sk.dtype, device=sk.device)
    edges = torch.searchsorted(sk.contiguous(), probes)
    starts, ends = edges[:-1], edges[1:]
    counts = (ends - starts).to(INT_ACC)
    out["group_count"] = counts
    _emit_sums(sum_jobs, sorted_sums, starts, ends, counts, out)
    _pick_minmax(mm_jobs, ord_modes, sorted_ord, starts, ends, counts,
                 sk.shape[0], out)


def _emit_sums(sum_jobs, sorted_sums, starts, ends, counts, out) -> None:
    done: Dict[Tuple[int, bool], Tensor] = {}
    for i, spec, slot in sum_jobs:
        name = _agg_name(i, spec)
        s = done.get((slot, spec.integral))
        if s is None:
            s = done[(slot, spec.integral)] = _run_sums(
                sorted_sums[slot], _acc_dtype(spec), starts, ends)
        if spec.kind == "avg":
            out[name + "_sum"] = s
            out[name + "_cnt"] = counts
        else:
            out[name] = s


def _sorted_post_sparse(sum_jobs, mm_jobs, ord_modes, keys: Tensor,
                        payloads, space: int, cap: int,
                        out: Dict[str, Tensor]) -> None:
    """Sparse sorted post (big spaces): (group_idx, value) pairs straight
    from the one sort, one entry per live group; more than ``cap`` live
    groups sets ``group_overflow`` (the executor reruns dense), as the
    reference's fixed-size output does."""
    sk, sorted_sums, sorted_ord = _sorted_post_common(
        sum_jobs, mm_jobs, keys, payloads)
    n_rows = sk.shape[0]
    first = torch.ones(n_rows, dtype=torch.bool, device=sk.device)
    if n_rows:
        first[1:] = sk[1:] != sk[:-1]
    starts = torch.nonzero(first).flatten()
    n_live = starts.shape[0]
    out["group_overflow"] = torch.tensor(int(n_live > cap),
                                         dtype=torch.int32,
                                         device=sk.device)
    ends = torch.cat([starts[1:], starts.new_tensor([n_rows])]) \
        if n_live else starts
    starts, ends = starts[:cap], ends[:cap]
    out["group_idx"] = sk[starts].to(torch.int32)
    counts = (ends - starts).to(INT_ACC)
    out["group_count"] = counts
    _emit_sums(sum_jobs, sorted_sums, starts, ends, counts, out)
    _pick_minmax(mm_jobs, ord_modes, sorted_ord, starts, ends, counts,
                 n_rows, out)


def _compact_group_xfer(plan: KernelPlan, out: Dict[str, Tensor]) -> None:
    """Replace dense (space,) group outputs with GROUP_XFER_CAP gathered
    rows, the live groups first: group_idx holds their dense space ids
    (the sentinel space past the live count, whose rows are zero);
    more than GROUP_XFER_CAP live groups sets group_overflow (the executor
    reruns with xfer_compact=False). The shapes are fixed, so no host
    sync is needed and same-plan segments stack. Any 2-D output (grouped
    DISTINCTCOUNT presence) keeps the whole result dense, since extraction
    indexes every output with one positions array."""
    space = plan.group_space
    if space < GROUP_XFER_SPACE:
        return
    dense = {k: v for k, v in out.items()
             if k not in ("matched", "overflow")}
    if not all(v.dim() == 1 and v.shape[0] == space
               for v in dense.values()):
        return
    live = out["group_count"] > 0
    dev = live.device
    rank = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32) - 1
    # live group j lands at slot rank[j]; everything else at a dump slot
    slot = torch.where(live & (rank < GROUP_XFER_CAP), rank, GROUP_XFER_CAP)
    idx = torch.full((GROUP_XFER_CAP + 1,), space, dtype=torch.int32,
                     device=dev)
    idx.scatter_(0, slot.long(), torch.arange(space, dtype=torch.int32,
                                              device=dev))
    idx = idx[:GROUP_XFER_CAP]
    out["group_idx"] = idx
    out["group_overflow"] = (rank[-1] + 1 > GROUP_XFER_CAP).to(torch.int32)
    hit = idx < space
    gather = idx.clamp(max=space - 1).long()
    for k, v in dense.items():
        out[k] = torch.where(hit, v[gather], torch.zeros((), dtype=v.dtype,
                                                         device=dev))


def _value_col_indices(ve) -> set:
    """EVERY stored-column index a value expression references, through
    Func args and Case branches too: the segmented kernel puts its segment
    column past the largest one."""
    if isinstance(ve, (Col, MvReduce)):
        return {ve.col}
    if isinstance(ve, Bin):
        return _value_col_indices(ve.lhs) | _value_col_indices(ve.rhs)
    if isinstance(ve, Func):
        return set().union(*[_value_col_indices(a) for a in ve.args])
    if isinstance(ve, Case):
        out = _value_col_indices(ve.else_)
        for pred, val in ve.whens:
            out |= _pred_col_indices(pred) | _value_col_indices(val)
        return out
    return set()


def _pred_col_indices(p) -> set:
    """Stored-column indices a predicate references."""
    if isinstance(p, (EqId, IdRange, InSet, InBitmap)):
        return {p.col}
    if isinstance(p, Cmp):
        return _value_col_indices(p.lhs)
    if isinstance(p, (And, Or)):
        return set().union(*[_pred_col_indices(c) for c in p.children])
    if isinstance(p, Not):
        return _pred_col_indices(p.child)
    return set()


# ---------------------------------------------------------------------------
# device selection (K9)
# ---------------------------------------------------------------------------

def build_select_kernel(plan: SelectPlan, bucket: int):
    """fn(cols, n_docs, params) -> {"sel_<i>": (k,) stored values,
    "ord_<j>": (k,) order-key ids/values, "matched": scalar}.

    The composite order key packs the (col, desc, card) entries most-
    significant-first into one int64; the winners are the first k of a
    stable descending sort of the negated key, so among equal keys the
    lower row comes first, as ``lax.top_k`` orders them. Rows beyond
    min(matched, k) are garbage: extraction slices by matched."""
    def kernel(cols: Tuple[Tensor, ...], n_docs: int,
               params: Tuple[Tensor, ...]) -> Dict[str, Tensor]:
        dev = _device_of(cols, params)
        mask = (torch.arange(bucket, device=dev) < n_docs) \
            & _eval_pred(plan.pred, cols, params, bucket, dev)
        if plan.order:
            key = torch.zeros(bucket, dtype=torch.int64, device=dev)
            for col, desc, card in plan.order:
                v = cols[col].to(torch.int64)
                if card:  # dict ids: sorted dictionary => id order
                    if desc:
                        v = (card - 1) - v
                    key = key * card + v
                else:     # a raw integral key: the planner emits it alone
                    key = -v if desc else v
            sort_key = torch.where(mask, -key, _IMIN64)
        else:
            # doc order: earliest rows win
            sort_key = torch.where(
                mask, -torch.arange(bucket, dtype=torch.int64, device=dev),
                _IMIN64)
        idx = torch.sort(sort_key, descending=True, stable=True
                         ).indices[:plan.k]
        out: Dict[str, Tensor] = {"matched": mask.sum(dtype=INT_ACC)}
        for i, col in enumerate(plan.select_cols):
            out[f"sel_{i}"] = cols[col][idx]
        for j, (col, _d, _c) in enumerate(plan.order):
            out[f"ord_{j}"] = cols[col][idx]
        return out

    return kernel


# ---------------------------------------------------------------------------
# kernel assembly
# ---------------------------------------------------------------------------

def build_kernel(plan: KernelPlan, bucket: int,
                 slots_cap: Optional[int] = None,
                 xfer_compact: bool = True,
                 device: Optional[torch.device] = None,
                 local_segments: int = 1):
    """Return fn(cols, n_docs, params) -> dict of partial aggregation
    states. Every cols[i] has the same (bucket * local_segments,) length;
    params are tensors on the same device (engine/executor.resolve_params).
    slots_cap sizes the compaction output for the 'compact' strategy
    (default ops/compact.default_slots_cap of the total rows); its
    "overflow" output tells the executor to retry at full capacity.
    ``device`` is the segment's (inferred from the inputs when None).

    With ``local_segments`` > 1 the cols are that many same-bucket
    segments concatenated along the row axis (a mesh shard's, the
    reference's ``local_segments`` path) and ``n_docs`` holds their
    ``local_segments`` doc counts."""
    total = bucket * local_segments

    def kernel(cols: Tuple[Tensor, ...], n_docs,
               params: Tuple[Tensor, ...]) -> Dict[str, Tensor]:
        dev = device if device is not None else _device_of(cols, params)
        if local_segments == 1:
            valid = torch.arange(total, device=dev) < n_docs
        else:
            docs = torch.as_tensor(n_docs, dtype=torch.int64, device=dev)
            valid = (torch.arange(bucket, device=dev)[None, :]
                     < docs[:, None]).reshape(total)
        mask = valid & _eval_pred(plan.pred, cols, params, total, dev)
        out: Dict[str, Tensor] = {}
        if plan.is_group_by and plan.strategy == "compact":
            from .compact import default_slots_cap
            cap = slots_cap or default_slots_cap(total)
            sparse = (xfer_compact and _needs_sort(plan)
                      and plan.group_space >= GROUP_XFER_SPACE)
            _compact_group_aggs(plan, mask, cols, params, cap, out,
                                xfer_sparse=sparse)
            if xfer_compact and not sparse:
                _compact_group_xfer(plan, out)
            return out
        out["matched"] = mask.sum(dtype=INT_ACC)
        if plan.is_group_by:
            _group_aggs(plan, mask, cols, params, out)
            if xfer_compact:
                _compact_group_xfer(plan, out)
        else:
            for i, spec in enumerate(plan.aggs):
                _scalar_agg(i, spec, mask, cols, params, out)
        return out

    return kernel


# ---------------------------------------------------------------------------
# segmented compact group-by (K11): S same-bucket segments, one compaction
# ---------------------------------------------------------------------------

def _dict_value_refs(plan: KernelPlan) -> Dict[int, List[int]]:
    """col index -> the dict-values param indices of every Col(dict_param=
    ..) an aggregation value expression references. One column can carry
    several (SUM(v), MIN(v) each bind one); every one of them flattens,
    where the JAX package flattens only the last and reads out of range
    with the others."""
    found: Dict[int, List[int]] = {}

    def walk(ve) -> None:
        if isinstance(ve, Col) and ve.dict_param is not None:
            found.setdefault(ve.col, []).append(ve.dict_param)
        elif isinstance(ve, Bin):
            walk(ve.lhs)
            walk(ve.rhs)
        elif isinstance(ve, Func):
            for a in ve.args:
                walk(a)

    for spec in plan.aggs:
        if spec.value is not None:
            walk(spec.value)
    return found


def _has_case(ve) -> bool:
    if isinstance(ve, Case):
        return True
    if isinstance(ve, Bin):
        return _has_case(ve.lhs) or _has_case(ve.rhs)
    if isinstance(ve, Func):
        return any(_has_case(a) for a in ve.args)
    return False


def segmented_compact_ok(plan: KernelPlan) -> bool:
    """Whether a compact group-by plan can run the segmented kernel: no
    column may serve as both a group key and a dictionary-value source,
    and no aggregation value may hold a CASE (the per-segment offsetting
    of dict ids would corrupt the keys or the CASE's id predicates)."""
    if not (plan.is_group_by and plan.strategy == "compact"):
        return False
    if any(_has_case(s.value) for s in plan.aggs if s.value is not None):
        return False
    key_cols = {ci for ci, _ in plan.group_keys}
    return not (key_cols & set(_dict_value_refs(plan)))


def segmented_inputs(plan: KernelPlan, bucket: int,
                     cols: Sequence[Tensor], n_docs: Sequence[int],
                     params: Sequence[Tuple[Tensor, ...]]):
    """The segmented kernel's prefix: each segment's predicate on its own
    row of the stacked (S, bucket) columns with its own params, into one
    (S*bucket,) mask, and the flattened columns and params the one
    compaction and its post run over. Dictionary-value params flatten to
    (S*card,) with the referencing dict-id columns offset by seg*card; the
    segment index becomes the leading group-key factor through an extra
    column. Returns (plan2, mask, flat_cols, flat_params)."""
    n_seg = len(n_docs)
    total = n_seg * bucket
    dev = cols[0].device
    seg_col = 1 + max(
        [ci for ci, _ in plan.group_keys]
        + [c for s in plan.aggs if s.value is not None
           for c in _value_col_indices(s.value)]
        + list(_pred_col_indices(plan.pred)) + [-1])
    plan2 = dc_replace(plan, group_keys=((seg_col, n_seg),)
                       + plan.group_keys)
    mask = torch.empty((n_seg, bucket), dtype=torch.bool, device=dev)
    rows = torch.arange(bucket, device=dev)
    for s in range(n_seg):
        mask[s] = (rows < n_docs[s]) & _eval_pred(
            plan.pred, tuple(c[s] for c in cols), params[s], bucket, dev)
    seg2d = torch.arange(n_seg, dtype=torch.int32,
                         device=dev)[:, None].expand(n_seg, bucket)
    dict_refs = _dict_value_refs(plan)
    flat: List[Tensor] = []
    for ci, c in enumerate(cols):
        pis = dict_refs.get(ci)
        if pis:  # offset ids into the flattened dictionary
            c = c.to(torch.int32) + seg2d * params[0][pis[0]].shape[0]
        flat.append(c.reshape(total))
    while len(flat) <= seg_col:
        flat.append(torch.zeros(total, dtype=torch.int32, device=dev))
    flat[seg_col] = seg2d.reshape(total)
    dict_pis = {pi for pis in dict_refs.values() for pi in pis}
    flat_params = tuple(
        torch.cat([p[i] for p in params]) if i in dict_pis else params[0][i]
        for i in range(len(params[0])))
    return plan2, mask.reshape(total), tuple(flat), flat_params


def build_segmented_compact_kernel(plan: KernelPlan, bucket: int,
                                   slots_cap: Optional[int] = None,
                                   xfer_compact: bool = True):
    """Multi-segment compact group-by with ONE compaction: fn(cols,
    n_docs, params) over stacked (S, bucket) columns, S doc counts and S
    param tuples. Outputs are those of the compact group-by over the
    S*space combined key (dense (S*space,) arrays, or live groups with
    group_idx) plus per-segment "matched" (S,); the executor splits the
    segments apart host-side and decodes each against its own
    dictionaries."""
    from .compact import default_slots_cap

    def kernel(cols: Sequence[Tensor], n_docs: Sequence[int],
               params: Sequence[Tuple[Tensor, ...]]) -> Dict[str, Tensor]:
        plan2, mask, flat, flat_params = segmented_inputs(
            plan, bucket, cols, n_docs, params)
        total = mask.shape[0]
        cap = slots_cap or default_slots_cap(total)
        out: Dict[str, Tensor] = {}
        sparse = (xfer_compact and _needs_sort(plan2)
                  and plan2.group_space >= GROUP_XFER_SPACE)
        _compact_group_aggs(plan2, mask, flat, flat_params, cap, out,
                            xfer_sparse=sparse)
        out["matched"] = mask.reshape(len(n_docs), bucket).sum(
            1, dtype=INT_ACC)
        if xfer_compact and not sparse:
            _compact_group_xfer(plan2, out)
        return out

    return kernel
