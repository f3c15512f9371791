"""Phase-level decomposition of the fused group-by kernels.

Port of ``pinot_tpu/ops/phase_profile.py``: one implementation of the
mask / fuse / compact / sort / aggregate / transfer timing ladder, which
EXPLAIN ANALYZE with OPTION(profilePhases=true) attaches as child spans of
the segment kernel span (engine/executor.py, engine/batch.py).

Each phase time is the per-launch time of a prefix of the kernel
pipeline, so successive phases are CUMULATIVE — ``t_compact_ms``
includes mask+fuse — and deltas attribute the increments. On the card a
prefix is timed with CUDA events around ``iters`` back-to-back launches
after a warm one (device time, the host's issue included), the best of
three such windows; on the CPU with ``time.perf_counter``.
``t_transfer_ms`` is the full kernel minus the no-transfer-compaction
variant. The prefixes launch K1 like the kernel does; this is a
profiling surface, never part of the untraced query path.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import torch


WINDOWS = 3     # timed windows a prefix; the best one counts


def timeit(fn, *args, iters: int = 5) -> float:
    """Per-launch seconds of ``fn(*args)``: warm once, then the best of
    WINDOWS windows of ``iters`` launches each (CUDA events on the card,
    the host clock on the CPU). The best window drops the host's one-off
    stalls, so a longer prefix of the pipeline does not read faster than
    a shorter one by noise alone."""
    out = fn(*args)
    dev = _device(out)
    best = float("inf")
    if dev is not None and dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        stream.synchronize()
        for _ in range(WINDOWS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(iters):
                fn(*args)
            end.record(stream)
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / iters)
        return max(best, 1e-9)
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        best = min(best, (time.perf_counter() - t0) / iters)
    return max(best, 1e-9)


def _device(out: Any):
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for o in out:
            dev = _device(o)
            if dev is not None:
                return dev
    return None


PHASE_KEYS = ("t_mask_ms", "t_fuse_ms", "t_compact_ms", "t_sort_ms",
              "t_aggregate_ms", "t_kernel_ms", "t_transfer_ms")


def profile_plan(plan, iters: int = 5) -> Dict[str, Any]:
    """Decompose a compiled 'kernel' plan's device time into phases.

    -> {strategy, space, n_cols, est_selectivity, cost_trace, needs_sort,
        t_mask_ms, [compact-path: slots_cap, cap_rows, t_fuse_ms,
        t_compact_ms, [t_sort_ms], t_aggregate_ms, matched,
        measured_selectivity, n_valid_rows, overflow, inflation],
        t_kernel_ms, [t_transfer_ms]}
    """
    from ..engine.executor import resolve_params
    from . import kernels
    from .compact import LANES, compact, full_slots_cap
    from .kernels import _needs_sort, _payload_columns, build_kernel

    seg = plan.segment
    kp = plan.kernel_plan
    bucket = seg.bucket
    dev = seg.device
    n = seg.n_docs
    cols = seg.device_cols(plan.col_names)
    params = resolve_params(plan)

    res: Dict[str, Any] = {
        "strategy": kp.strategy,
        "space": kp.group_space if kp.is_group_by else 0,
        "n_cols": len(cols),
        "est_selectivity": plan.est_selectivity,
        "cost_trace": plan.strategy_trace,
        "needs_sort": _needs_sort(kp) if kp.is_group_by else None,
    }

    # phase 1: predicate mask only
    def mask_fn(cols, n, params):
        valid = torch.arange(bucket, device=dev) < n
        return valid & kernels._eval_pred(kp.pred, cols, params, bucket,
                                          dev)

    res["t_mask_ms"] = round(
        timeit(mask_fn, cols, n, params, iters=iters) * 1e3, 2)

    if kp.strategy == "compact":
        cap = plan.slots_cap or full_slots_cap(bucket)
        res["slots_cap"] = cap
        res["cap_rows"] = cap * LANES

        # phase 2: + fused key/payload materialization
        def fuse_fn(cols, n, params):
            m = mask_fn(cols, n, params)
            m, keys = kernels._group_keys_sentinel(kp, m, cols, params)
            payloads, *_meta = _payload_columns(kp, m, cols, params)
            return (m, keys) + tuple(payloads)

        res["t_fuse_ms"] = round(
            timeit(fuse_fn, cols, n, params, iters=iters) * 1e3, 2)

        # phase 3: + one compaction of [key] + payloads
        def comp_fn(cols, n, params):
            m = mask_fn(cols, n, params)
            m, keys = kernels._group_keys_sentinel(kp, m, cols, params)
            payloads, *_meta = _payload_columns(kp, m, cols, params)
            return compact(m, (keys,) + tuple(payloads), cap)

        res["t_compact_ms"] = round(
            timeit(comp_fn, cols, n, params, iters=iters) * 1e3, 2)
        _v, ccols, n_valid, matched, overflow = comp_fn(cols, n, params)
        matched, n_valid = int(matched), int(n_valid)
        res["matched"] = matched
        res["measured_selectivity"] = round(matched / max(n, 1), 8)
        res["n_valid_rows"] = n_valid
        res["overflow"] = int(overflow)
        res["inflation"] = round(n_valid / max(matched, 1), 2)

        if res["needs_sort"]:
            # phase 3b: + the sort-once pass over the compacted keys
            def sort_fn(cols, n, params):
                _valid, ccols, *_rest = comp_fn(cols, n, params)
                return torch.sort(ccols[0]).values

            res["t_sort_ms"] = round(
                timeit(sort_fn, cols, n, params, iters=iters) * 1e3, 2)

        # phase 4: + post-aggregation (full kernel minus transfer
        # compaction)
        f_noxfer = build_kernel(kp, bucket, plan.slots_cap,
                                xfer_compact=False, device=dev)
        res["t_aggregate_ms"] = round(
            timeit(f_noxfer, cols, n, params, iters=iters) * 1e3, 2)

    # phase 5: full kernel (as shipped, with transfer compaction)
    ffull = build_kernel(kp, bucket, plan.slots_cap, device=dev)
    res["t_kernel_ms"] = round(
        timeit(ffull, cols, n, params, iters=iters) * 1e3, 2)
    if "t_aggregate_ms" in res:
        res["t_transfer_ms"] = round(
            max(res["t_kernel_ms"] - res["t_aggregate_ms"], 0.0), 2)
    return res


def attach_phase_spans(prof: Dict[str, Any]) -> None:
    """Attach a profile's phase ladder to the current span as child
    event spans (EXPLAIN ANALYZE's OPTION(profilePhases=true) path).
    Cumulative ladder times are converted to per-phase increments."""
    from ..utils.spans import add_event

    if prof.get("t_aggregate_ms") is not None:   # compact decomposition
        ladder = [k for k in ("t_mask_ms", "t_fuse_ms", "t_compact_ms",
                              "t_sort_ms", "t_aggregate_ms")
                  if prof.get(k) is not None]
        prev = 0.0
        for k in ladder:
            cum = float(prof[k])
            add_event("phase_" + k[2:-3], max(cum - prev, 0.0),
                      cumulative_ms=cum)
            prev = cum
        add_event("phase_transfer", float(prof.get("t_transfer_ms", 0.0)))
        return
    # dense kernels: mask, then the fused aggregate remainder
    mask_ms = float(prof.get("t_mask_ms", 0.0))
    kernel_ms = float(prof.get("t_kernel_ms", 0.0))
    add_event("phase_mask", mask_ms)
    add_event("phase_aggregate", max(kernel_ms - mask_ms, 0.0),
              cumulative_ms=kernel_ms)
