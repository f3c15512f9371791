"""Window function execution over a Relation.

Port of ``pinot_tpu/multistage/window.py``. The evaluator is host numpy,
as in the reference; its two device functions (K17) run on the caller's
device: the segmented running scan through ``ops/segscan.seg_scan`` (a
hand-written CUDA kernel on the card) and the per-partition aggregate of
an unordered window as torch ops (``_segment_agg``). Both take the device
path at ``PINOT_DEVICE_WINDOW_MIN_ROWS`` rows (default 200,000) and
above, for clean numeric inputs.

Reference parity: pinot-query-runtime/.../runtime/operator/
WindowAggregateOperator.java + window/ (aggregate window functions over
partitions, value functions LEAD/LAG/FIRST_VALUE/LAST_VALUE, rank
functions ROW_NUMBER/RANK/DENSE_RANK/NTILE; default frame = whole
partition without ORDER BY, RANGE UNBOUNDED PRECEDING..CURRENT ROW with;
explicit ROWS frames). A window is sort + segmented scan — everything
here is one lexsort followed by vectorized segmented prefix ops (cumsum /
offset-trick segmented cummin/cummax / prefix-sum differences for sliding
frames); no per-row or per-partition Python loops. Above the threshold
the same scans run on the device.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..engine import host_eval
from ..ops.segscan import seg_scan
from ..query.sql import (FuncCall, Identifier, OrderItem, SelectItem,
                         SelectStmt, SqlError, WindowFunc)

RANK_FUNCS = {"row_number", "rank", "dense_rank", "ntile"}
VALUE_FUNCS = {"lag", "lead", "first_value", "last_value"}
AGG_FUNCS = {"sum", "min", "max", "count", "avg"}


def find_windows(stmt: SelectStmt) -> List[WindowFunc]:
    """Window calls in SELECT items / ORDER BY (the only legal spots)."""
    out: List[WindowFunc] = []

    def walk(e: Any) -> None:
        if isinstance(e, WindowFunc):
            if e not in out:
                out.append(e)
            return  # nested windows are illegal; args walked at eval
        from ..query.sql import ast_children
        for c in ast_children(e):
            walk(c)

    for item in stmt.select:
        walk(item.expr)
    for o in stmt.order_by:
        walk(o.expr)
    return out


def has_window(stmt) -> bool:
    return isinstance(stmt, SelectStmt) and bool(find_windows(stmt))


def rewrite_windows(stmt: SelectStmt, names: Dict[WindowFunc, str]
                    ) -> SelectStmt:
    """Replace each WindowFunc with an Identifier over its computed
    column, leaving a plain selection statement."""
    from ..query.sql import expr_to_sql, map_expr

    def rw(e: Any) -> Any:
        return Identifier(names[e]) if isinstance(e, WindowFunc) else e

    def item_alias(i: SelectItem) -> Any:
        if i.alias is not None:
            return i.alias
        has_wf = False

        def probe(e):
            nonlocal has_wf
            if isinstance(e, WindowFunc):
                has_wf = True
            return e
        map_expr(i.expr, probe)
        # label the output column with the original expression text, not
        # the internal __wN rewrite name
        return expr_to_sql(i.expr) if has_wf else None

    return SelectStmt(
        select=[SelectItem(map_expr(i.expr, rw), item_alias(i))
                for i in stmt.select],
        table=stmt.table, distinct=stmt.distinct,
        table_alias=stmt.table_alias, joins=stmt.joins,
        where=stmt.where, group_by=stmt.group_by, having=stmt.having,
        order_by=[OrderItem(map_expr(o.expr, rw), o.ascending)
                  for o in stmt.order_by],
        limit=stmt.limit, offset=stmt.offset, options=stmt.options,
        explain=stmt.explain)


# ---------------------------------------------------------------------------
# segmented-scan primitives (all vectorized)
# ---------------------------------------------------------------------------

def _codes(arr: np.ndarray, ascending: bool = True) -> np.ndarray:
    """Factorize any dtype to int64 sort codes; negate for DESC."""
    _, inv = np.unique(np.asarray(arr), return_inverse=True)
    codes = inv.astype(np.int64)
    return codes if ascending else -codes


def _part_starts(new_part: np.ndarray) -> np.ndarray:
    """For each row (sorted domain), index of its partition's first row."""
    n = len(new_part)
    idx = np.where(new_part, np.arange(n, dtype=np.int64), 0)
    return np.maximum.accumulate(idx)


def _group_ids(new_grp: np.ndarray) -> np.ndarray:
    return np.cumsum(new_grp) - 1


def _ends_from_starts(new_grp: np.ndarray) -> np.ndarray:
    """For each row, index of its group's last row."""
    n = len(new_grp)
    starts = np.where(new_grp)[0]
    ends = np.r_[starts[1:] - 1, n - 1]
    return ends[_group_ids(new_grp)]


def _seg_cumsum(v: np.ndarray, part_start: np.ndarray) -> np.ndarray:
    cs = np.cumsum(v)
    base = cs[part_start] - v[part_start]
    return cs - base


def _seg_cummax(v: np.ndarray, part_ids: np.ndarray) -> np.ndarray:
    """Segmented running max via the monotonic-offset trick: shift each
    partition into its own disjoint value band, one global accumulate,
    shift back (no per-partition loop)."""
    v = v.astype(np.float64)
    vmin, vmax = float(v.min()), float(v.max())
    span = (vmax - vmin) + 1.0
    shifted = (v - vmin) + part_ids * span
    return np.maximum.accumulate(shifted) - part_ids * span + vmin


def _seg_cummin(v: np.ndarray, part_ids: np.ndarray) -> np.ndarray:
    return -_seg_cummax(-v.astype(np.float64), part_ids)


# ---------------------------------------------------------------------------
# device segmented scans: ORDER BY frames — running SUM/COUNT/AVG prefix
# sums, running MIN/MAX, and the rank-function scans — run as one
# segmented scan on the device (ops/segscan.py, K17) with the classic
# monoid: elements are (reset_flag, value) and
#   combine((fa,va),(fb,vb)) = (fa|fb, fb ? vb : op(va, vb))
# so partition boundaries reset the accumulation.
# ---------------------------------------------------------------------------

def _device_seg_scan(op: str, v: np.ndarray, new_part: np.ndarray,
                     device: Union[str, torch.device]) -> np.ndarray:
    acc = torch.int64 if v.dtype.kind in "iub" else torch.float64
    vals = torch.from_numpy(np.ascontiguousarray(v)).to(device=device,
                                                        dtype=acc)
    flags = torch.from_numpy(np.ascontiguousarray(new_part, dtype=bool)
                             ).to(device)
    out = seg_scan(op, vals, flags).cpu().numpy()
    return out.astype(v.dtype, copy=False)


def _scan_on_device(n: int, *vs: np.ndarray) -> bool:
    """Device scans above the row threshold for clean numeric inputs;
    NaN min/max semantics and object dtypes stay with the host
    machinery. Sums are int64 or float64 on every device."""
    if n < _device_window_min_rows():
        return False
    for v in vs:
        if v.dtype.kind not in "iufb":
            return False
        if v.dtype.kind == "f" and np.isnan(v).any():
            return False
    return True


def _seg_run(op: str, v: np.ndarray, new_part: np.ndarray,
             part_start: np.ndarray, part_ids: np.ndarray,
             device: Union[str, torch.device]) -> np.ndarray:
    """Segmented running scan: the device scan above the threshold, host
    cumsum/offset-trick below."""
    if _scan_on_device(len(v), v):
        return _device_seg_scan(op, v, new_part, device)
    if op == "sum":
        return _seg_cumsum(v, part_start)
    if op == "max":
        return _seg_cummax(v, part_ids)
    return _seg_cummin(v, part_ids)


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------

def compute_window(rel, wf: WindowFunc,
                   device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Evaluate one window call over the relation, in original row order;
    the device functions run on ``device``."""
    n = rel.n_rows
    name = wf.func.name
    if name not in RANK_FUNCS | VALUE_FUNCS | AGG_FUNCS:
        raise SqlError(f"unsupported window function {name!r}")
    if name in RANK_FUNCS and not wf.spec.order_by:
        raise SqlError(f"{name.upper()} needs ORDER BY in its OVER clause")
    if n == 0:
        return np.empty(0, dtype=np.float64)

    # ---- global sort: partition keys primary, then order keys -----------
    part_cols = [_codes(host_eval.eval_value(p, rel))
                 for p in wf.spec.partition_by]
    order_cols = [_codes(host_eval.eval_value(o.expr, rel), o.ascending)
                  for o in wf.spec.order_by]
    if part_cols:
        pk = part_cols[0]
        for c in part_cols[1:]:  # combine to one partition id
            pk = pk * (c.max() + 1) + c
        _, pk = np.unique(pk, return_inverse=True)
    else:
        pk = np.zeros(n, dtype=np.int64)
    # device fast path: a partition-only unordered aggregate window IS a
    # segment reduction + gather — at scale that runs on the device
    # instead of the host sort machinery (the sort/scan shapes below stay
    # the general path)
    pre_v = None
    if (name in AGG_FUNCS and not wf.spec.order_by
            and wf.spec.frame is None and not wf.func.distinct
            and n >= _device_window_min_rows()):
        out, pre_v = _device_partition_agg(rel, wf, pk, device)
        if out is not None:
            return out
        # bail path: the evaluated argument is reused below, not
        # re-evaluated (large-n queries are exactly where that matters)

    sort_keys = list(reversed(order_cols)) + [pk]  # lexsort: last = primary
    sidx = np.lexsort(sort_keys)

    part = pk[sidx]
    new_part = np.r_[True, part[1:] != part[:-1]]
    part_start = _part_starts(new_part)
    part_ids = _group_ids(new_part)
    new_peer = new_part.copy()
    for oc in order_cols:
        o = oc[sidx]
        new_peer |= np.r_[True, o[1:] != o[:-1]]
    pos = np.arange(n, dtype=np.int64)

    out = _compute_sorted(rel, wf, sidx, pos, part, new_part, part_start,
                          part_ids, new_peer, device, pre_v)

    unsorted = np.empty(n, dtype=np.asarray(out).dtype)
    unsorted[sidx] = out
    return unsorted


def _value_frame_positions(rel, wf: WindowFunc, sidx, pos, part,
                           new_part, part_start, part_ids):
    """Explicit-frame window bounds for FIRST_VALUE/LAST_VALUE, or None
    for the default frame (whole partition / peer semantics). Covers
    both ROWS row offsets and RANGE value offsets."""
    frame = wf.spec.frame
    if frame is None:
        return None
    mode, lo, hi = frame
    part_end = _ends_from_starts(new_part)
    if lo is None and hi is None:     # whole partition, either mode
        return part_start, part_end, np.zeros(len(pos), dtype=bool)
    if mode == "range":
        if lo is None and hi == 0:
            return None               # default running-frame semantics
        return _range_positions(rel, wf, sidx, new_part, part_start,
                                part_ids, lo, hi)
    lo_pos = part_start if lo is None \
        else np.clip(pos + lo, part_start, part_end + 1)
    hi_pos = part_end if hi is None \
        else np.clip(pos + hi, part_start - 1, part_end)
    return lo_pos, hi_pos, hi_pos < lo_pos


def _range_positions(rel, wf: WindowFunc, sidx, new_part, part_start,
                     part_ids, lo, hi):
    """-> (lo_pos, hi_pos, empty) window bounds for a RANGE value-offset
    frame: the window of row i is every partition row whose ORDER BY
    key lies in [v_i + lo, v_i + hi] (direction-normalized, so DESC
    works via the sign flip). ONE global searchsorted via the partition
    banding trick (keys are sorted within partitions; shifting each
    partition into a disjoint band keeps the array globally sorted) —
    no per-partition Python loops."""
    ob = wf.spec.order_by
    if len(ob) != 1:
        raise SqlError("RANGE offset frames need exactly one ORDER BY "
                       "key")
    v = np.asarray(host_eval.eval_value(ob[0].expr, rel))
    if v.dtype.kind not in "iuf":
        raise SqlError("RANGE offset frames need a numeric ORDER BY key")
    v = v.astype(np.float64)[sidx]
    if np.isnan(v).any():
        raise SqlError("RANGE offset frames need non-null ORDER BY keys")
    u = v if ob[0].ascending else -v
    part_end = _ends_from_starts(new_part)
    off = max(abs(float(lo)) if lo is not None else 0.0,
              abs(float(hi)) if hi is not None else 0.0)
    span = float(u.max() - u.min()) + off + 1.0
    ub = (u - u.min()) + part_ids * span
    lo_pos = (np.searchsorted(ub, ub + float(lo), side="left")
              if lo is not None else part_start)
    hi_pos = (np.searchsorted(ub, ub + float(hi), side="right") - 1
              if hi is not None else part_end)
    return lo_pos, hi_pos, hi_pos < lo_pos


def _range_frame(rel, wf: WindowFunc, acc: np.ndarray, sidx,
                 new_part, part_start, part_ids, lo, hi,
                 device: Union[str, torch.device]) -> np.ndarray:
    """RANGE value-offset aggregate frames (reference:
    pinot-query-runtime/.../operator/window/ range operators):
    SUM/COUNT/AVG by prefix-sum differences, MIN/MAX by a sparse-table
    (prefix-doubling) range query. Empty windows follow SQL: COUNT 0,
    everything else NULL."""
    fname = wf.func.name
    lo_pos, hi_pos, empty = _range_positions(
        rel, wf, sidx, new_part, part_start, part_ids, lo, hi)
    n = len(acc)

    if fname in ("sum", "count", "avg"):
        # the prefix sums ride the device scan above the row threshold,
        # like every other framed aggregate
        P = _seg_run("sum", acc.astype(np.float64), new_part, part_start,
                     part_ids, device)
        Pm1 = np.where(lo_pos > part_start,
                       P[np.maximum(lo_pos - 1, 0)], 0.0)
        total = np.where(empty, 0.0,
                         P[np.minimum(np.maximum(hi_pos, 0), n - 1)] - Pm1)
        if fname == "count":
            return total.astype(np.int64)        # empty window counts 0
        if fname == "avg":
            cnt = np.where(empty, 1, hi_pos - lo_pos + 1)
            return np.where(empty, np.nan, total / cnt)
        if np.any(empty):                        # SUM over empty is NULL
            return np.where(empty, np.nan, total)
        return total.astype(np.int64) if acc.dtype.kind in "iu" \
            else total
    # sliding min/max over monotone-but-variable-width windows
    out = _sparse_range_minmax(acc.astype(np.float64), lo_pos, hi_pos,
                               fname == "max")
    out = np.where(empty, np.nan, out)
    return out.astype(acc.dtype) if acc.dtype.kind in "iu" \
        and not np.any(empty) else out


def _sparse_range_minmax(a: np.ndarray, lo_pos, hi_pos,
                         is_max: bool) -> np.ndarray:
    """O(n log n) prefix-doubling table; each [lo, hi] query is the
    reduction of two overlapping power-of-two blocks."""
    n = len(a)
    op = np.maximum if is_max else np.minimum
    table = [a]
    j = 1
    while (1 << j) <= n:
        prev = table[-1]
        half = 1 << (j - 1)
        length = n - (1 << j) + 1
        table.append(op(prev[:length], prev[half:half + length]))
        j += 1
    width = hi_pos - lo_pos + 1
    out = np.empty(n, dtype=a.dtype)
    valid = width > 0
    if valid.any():
        k = np.zeros(n, dtype=np.int64)
        k[valid] = np.floor(np.log2(width[valid])).astype(np.int64)
        for lvl in np.unique(k[valid]):
            m = valid & (k == lvl)
            t = table[lvl]
            out[m] = op(t[lo_pos[m]],
                        t[hi_pos[m] - (1 << lvl) + 1])
    return out


def _device_window_min_rows() -> int:
    return int(os.environ.get("PINOT_DEVICE_WINDOW_MIN_ROWS", 200_000))


def _device_partition_agg(rel, wf: WindowFunc, pk: np.ndarray,
                          device: Union[str, torch.device]
                          ) -> Tuple[Optional[np.ndarray],
                                     Optional[np.ndarray]]:
    """SUM/COUNT/AVG/MIN/MAX OVER (PARTITION BY ...) on device:
    segment reduction over the factorized partition ids, then a
    row-aligned gather. The segment count buckets to powers of two, as
    in the reference. Output dtypes mirror the host whole-partition
    branch (int64 for integral sum/count/min/max, float64 otherwise).
    Returns (result, evaluated_arg); result None -> caller keeps the
    host path, reusing the evaluated argument."""
    from ..query.sql import Star
    name = wf.func.name
    args = wf.func.args
    if name == "count" or not args or isinstance(args[0], Star):
        v = np.ones(rel.n_rows, dtype=np.int64)
    else:
        v = np.asarray(host_eval.eval_value(args[0], rel))
        if v.dtype.kind not in "iufb":
            return None, v           # string aggs stay on host
        if v.dtype.kind == "f" and np.isnan(v).any():
            return None, v  # NaN semantics stay with the host machinery
    integral = v.dtype.kind in "iub" and name != "avg"

    n_seg = int(pk.max()) + 1
    n_seg_p = 1 << (n_seg - 1).bit_length() if n_seg > 1 else 1
    vals = torch.from_numpy(np.ascontiguousarray(
        v, dtype=np.int64 if integral else np.float64)).to(device)
    ids = torch.from_numpy(np.ascontiguousarray(pk, dtype=np.int64)
                           ).to(device)
    out = _segment_agg(name, n_seg_p, vals, ids)
    return out.cpu().numpy(), v


# calls of _segment_agg on a CUDA tensor (chip_smoke.py resets and reads
# it), under a lock like the kernels' counters
segment_agg_launches = 0
_LAUNCH_LOCK = threading.Lock()


def _segment_agg(op: str, segs: int, vals: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """Per-segment sum/count/avg/min/max of ``vals`` over ``segs``
    segments keyed by ``ids``, gathered back to the rows (the reference's
    ``_segment_agg_jit``, as torch ops)."""
    global segment_agg_launches
    if op in ("sum", "count"):
        per = torch.zeros(segs, dtype=vals.dtype, device=vals.device
                          ).index_add_(0, ids, vals)
    elif op == "avg":
        s = torch.zeros(segs, dtype=vals.dtype, device=vals.device
                        ).index_add_(0, ids, vals)
        c = torch.zeros(segs, dtype=vals.dtype, device=vals.device
                        ).index_add_(0, ids, torch.ones_like(vals))
        per = s / c
    else:
        fill = (torch.iinfo(vals.dtype) if vals.dtype == torch.int64
                else torch.finfo(vals.dtype))
        per = torch.full((segs,), fill.max if op == "min" else fill.min,
                         dtype=vals.dtype, device=vals.device
                         ).scatter_reduce_(0, ids, vals,
                                           "amin" if op == "min" else "amax")
    if vals.device.type == "cuda":
        with _LAUNCH_LOCK:
            segment_agg_launches += 1
    return per.index_select(0, ids)


def _arg_value(rel, wf: WindowFunc, sidx: np.ndarray, i: int = 0,
               pre: Optional[np.ndarray] = None) -> np.ndarray:
    from ..query.sql import Star
    args = wf.func.args
    if not args or isinstance(args[0], Star):
        return np.ones(len(sidx), dtype=np.int64)
    if i == 0 and pre is not None:
        return pre[sidx]     # reuse the device-path bail evaluation
    v = np.asarray(host_eval.eval_value(args[i], rel))
    return v[sidx]


def _lit(wf: WindowFunc, i: int, default: Any) -> Any:
    from ..query.sql import Literal
    if len(wf.func.args) <= i:
        return default
    arg = wf.func.args[i]
    if not isinstance(arg, Literal):
        raise SqlError(f"{wf.func.name.upper()} argument {i + 1} must be "
                       f"a literal, got {type(arg).__name__}")
    return arg.value


def _compute_sorted(rel, wf: WindowFunc, sidx, pos, part, new_part,
                    part_start, part_ids, new_peer,
                    device: Union[str, torch.device],
                    pre_v: Optional[np.ndarray] = None) -> np.ndarray:
    name = wf.func.name
    n = len(sidx)
    if name in ("row_number", "rank", "dense_rank") and _scan_on_device(n):
        # rank scans on device: row_number is the segmented running
        # count, rank the running max of row_number at peer starts,
        # dense_rank the running count of peer starts — one segmented
        # scan each over (reset=new_part, value). NTILE stays host-side:
        # its formula needs only part sizes and the O(1)-per-row
        # row_number arithmetic below.
        if name == "dense_rank":
            return _device_seg_scan(
                "sum", new_peer.astype(np.int64), new_part, device)
        rn = _device_seg_scan("sum", np.ones(n, dtype=np.int64), new_part,
                              device)
        if name == "row_number":
            return rn
        return _device_seg_scan("max", np.where(new_peer, rn, 0),
                                new_part, device)
    row_number = pos - part_start + 1

    if name == "row_number":
        return row_number
    if name == "rank":
        peer_start = _part_starts(new_peer)
        return peer_start - part_start + 1
    if name == "dense_rank":
        dense = np.cumsum(new_peer)
        return dense - dense[part_start] + 1
    if name == "ntile":
        k = int(_lit(wf, 0, 1))
        sizes = np.bincount(part)[part]
        return ((row_number - 1) * k) // sizes + 1

    if name in ("lag", "lead"):
        v = _arg_value(rel, wf, sidx)
        off = int(_lit(wf, 1, 1))
        default = _lit(wf, 2, None)
        shift = -off if name == "lag" else off
        src = pos + shift
        valid = (src >= part_start) & (src <= _ends_from_starts(new_part))
        fill = np.nan if default is None and v.dtype.kind in "fiu" \
            else default
        out = np.empty(n, dtype=np.float64 if v.dtype.kind in "fiu"
                       else object)
        out[:] = fill
        out[valid] = v[src[valid]]
        return out
    if name in ("first_value", "last_value"):
        v = _arg_value(rel, wf, sidx)
        fpos = _value_frame_positions(rel, wf, sidx, pos, part, new_part,
                                      part_start, part_ids)
        if fpos is not None:
            # explicit frame: the framed first/last row's value
            lo_pos, hi_pos, empty = fpos
            src = lo_pos if name == "first_value" else hi_pos
            out = v[np.clip(src, 0, n - 1)].astype(np.float64) \
                if v.dtype.kind in "iuf" else v[np.clip(src, 0, n - 1)]
            if v.dtype.kind in "iuf":
                return np.where(empty, np.nan, out)
            out = out.astype(object)
            out[empty] = None
            return out
        if name == "first_value":
            return v[part_start]
        if wf.spec.order_by and wf.spec.frame is None:
            return v[_ends_from_starts(new_peer)]  # end of peer group
        return v[_ends_from_starts(new_part)]

    # ---- aggregate window functions -------------------------------------
    if wf.func.distinct:
        if name != "count" or wf.spec.order_by or wf.spec.frame is not None:
            raise SqlError(
                "DISTINCT in window aggregates is supported only for "
                "COUNT(DISTINCT x) OVER (PARTITION BY ...) without "
                "ORDER BY or frames")
        # distinct count per partition, broadcast to every row
        v = _arg_value(rel, wf, sidx, pre=pre_v)
        _, vc_codes = np.unique(v, return_inverse=True)
        pair = part * (int(vc_codes.max()) + 1) + vc_codes
        order2 = np.argsort(pair, kind="stable")
        sp = pair[order2]
        first = np.r_[True, sp[1:] != sp[:-1]]  # one row per (part, value)
        uniq_per_part = np.bincount(part[order2][first],
                                    minlength=int(part.max()) + 1)
        return uniq_per_part[part]
    v = _arg_value(rel, wf, sidx, pre=pre_v)
    if name == "count":
        v = np.ones(n, dtype=np.int64)
    acc = v.astype(np.int64) if v.dtype.kind in "iub" and name != "avg" \
        else v.astype(np.float64)

    frame = wf.spec.frame
    if frame is None and not wf.spec.order_by:
        frame = ("rows", None, None)          # whole partition
    if frame is not None and frame[0] == "range":
        if not wf.spec.order_by:
            raise SqlError("RANGE frames require ORDER BY in the OVER "
                           "clause")
        if frame[1] is None and frame[2] == 0:
            # explicit RANGE UNBOUNDED PRECEDING..CURRENT ROW is the
            # default frame — peer-aware, unlike a ROWS 0 bound
            frame = None
        elif frame[1] is None and frame[2] is None:
            frame = ("rows", None, None)      # whole partition
        else:
            return _range_frame(rel, wf, acc, sidx, new_part,
                                part_start, part_ids, frame[1], frame[2],
                                device)
    if frame is None:
        # RANGE UNBOUNDED PRECEDING..CURRENT ROW incl. peers
        peer_end = _ends_from_starts(new_peer)
        if name in ("sum", "count"):
            return _seg_run("sum", acc, new_part, part_start,
                            part_ids, device)[peer_end]
        if name == "avg":
            s = _seg_run("sum", acc, new_part, part_start,
                         part_ids, device)[peer_end]
            c = _seg_run("sum", np.ones(n), new_part, part_start,
                         part_ids, device)[peer_end]
            return s / c
        run = _seg_run(name, acc, new_part, part_start, part_ids, device)
        out = run[peer_end]
        return out.astype(acc.dtype) if acc.dtype.kind in "iu" else out

    mode, lo, hi = frame
    part_end = _ends_from_starts(new_part)
    if lo is None and hi is None:
        # whole-partition reductions: part is the primary sort key here,
        # so reduceat over the run starts is both vectorized AND exact
        # in the native dtype — int64 sums/extrema past 2^53 stay exact
        # and identical to the device segment_* path
        starts = np.where(new_part)[0]
        if name in ("sum", "count"):
            t = np.add.reduceat(acc, starts)
            return t[part_ids]
        if name == "avg":
            t = np.add.reduceat(acc.astype(np.float64), starts)
            return t[part_ids] / np.bincount(part)[part]
        ext = np.maximum.reduceat(acc, starts) if name == "max" \
            else np.minimum.reduceat(acc, starts)
        return ext[part_ids]

    # ROWS frame with at least one finite bound
    lo_pos = part_start if lo is None \
        else np.clip(pos + lo, part_start, part_end + 1)
    hi_pos = part_end if hi is None \
        else np.clip(pos + hi, part_start - 1, part_end)
    empty = hi_pos < lo_pos
    if name in ("sum", "count", "avg"):
        P = _seg_run("sum", acc.astype(np.float64), new_part, part_start,
                     part_ids, device)
        Pm1 = np.where(lo_pos > part_start, P[np.maximum(lo_pos - 1, 0)], 0.0)
        total = np.where(empty, 0.0, P[np.minimum(hi_pos, len(P) - 1)] - Pm1)
        if name == "count":
            return total.astype(np.int64)    # empty window counts 0
        if name == "avg":
            cnt = np.where(empty, 1, hi_pos - lo_pos + 1)
            return np.where(empty, np.nan, total / cnt)
        if np.any(empty):                    # SQL: SUM over empty is NULL
            return np.where(empty, np.nan, total)
        return total.astype(np.int64) if acc.dtype.kind in "iu" else total
    # sliding min/max
    if lo is None:                      # prefix up to hi_pos
        run = _seg_run(name, acc, new_part, part_start, part_ids, device)
        out = run[np.maximum(hi_pos, 0)]
    elif hi is None:                    # suffix from lo_pos: reverse scan
        racc = acc[::-1]
        # reversed partition ids DECREASE; the offset trick needs
        # nondecreasing ids, so renumber (the raw reversal would leak
        # maxima across partitions), and reversed reset flags mark each
        # partition's LAST row
        rnew = np.r_[True, part[::-1][1:] != part[::-1][:-1]]
        if _scan_on_device(n, racc):
            rrun = _device_seg_scan(name, racc, rnew, device)
        else:
            rpart = (int(part_ids[-1]) - part_ids)[::-1]
            rrun = _seg_cummax(racc, rpart) if name == "max" \
                else _seg_cummin(racc, rpart)
        run = rrun[::-1]
        out = run[np.minimum(lo_pos, len(acc) - 1)]
    else:                               # both finite: O(n·w) masked view
        w = hi - lo + 1
        idx = np.arange(len(acc))[:, None] + np.arange(w)[None, :] + lo
        vals = acc.astype(np.float64)[np.clip(idx, 0, len(acc) - 1)]
        valid = (idx >= lo_pos[:, None]) & (idx <= hi_pos[:, None])
        sent = -np.inf if name == "max" else np.inf
        vals = np.where(valid, vals, sent)
        out = vals.max(axis=1) if name == "max" else vals.min(axis=1)
    ident = np.nan
    out = np.where(empty, ident, out)
    return out.astype(acc.dtype) if acc.dtype.kind in "iu" and \
        not np.any(empty) else out
