"""Per-segment execution: run the kernel, extract mergeable partials.

Port of ``pinot_tpu/engine/executor.py``. ``run_kernel`` runs a kernel
plan's torch function on the segment's device and brings the outputs back
as host numpy in one transfer; ``extract_partial`` (copied) turns them
into the same value-space partial states as the reference, so the broker
reduce merges them unchanged. ``pruned`` and ``fast`` plans answer
directly, ``host`` plans run the numpy host path (engine/host_eval.py) and
``kselect`` plans the device selection kernel (ops/kernels.py). Every
transferred output passes the accountant's ``track_result`` fence
(engine/accounting.py). Under a trace each path records the reference's
spans (``segment_host``, ``segment_kselect``, ``segment_kernel`` with
``device_execute`` / ``device_transfer`` children, the retries,
``extract_partial``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..ops import aggregations
from ..ops.compact import full_slots_cap
from ..ops.kernels import build_kernel, build_select_kernel
from ..ops.phase_profile import attach_phase_spans, profile_plan
from ..ops.plan_cache import global_plan_cache
from ..query.context import QueryContext
from ..query.planner import (AggBinding, CompiledPlan, SegmentPlanner,
                             _truthy)
from ..query.sql import Star
from ..segment.immutable import ImmutableSegment
from ..utils.metrics import global_metrics
from ..utils.spans import (annotate, device_fence, span,
                           tracing_active)
from . import host_eval
from .accounting import global_accountant
from .tier import global_tier


@dataclass
class AggPartial:
    states: List[Any]  # aligned with ctx.aggregations


@dataclass
class GroupByPartial:
    groups: Dict[Tuple, List[Any]]  # key values -> states per aggregation


@dataclass
class SelectionPartial:
    labels: List[str]
    rows: List[tuple]
    order_keys: List[tuple] = field(default_factory=list)


def empty_partial(ctx: QueryContext):
    if ctx.is_group_by:
        return GroupByPartial({})
    if ctx.is_aggregation:
        na = host_eval.null_aware(ctx)
        # with null handling, SUM over zero rows is null, not 0 (the merge
        # is null-absorbing, so any segment with rows still wins)
        return AggPartial([None if na and a.kind == "sum"
                           else aggregations.empty_state(a)
                           for a in ctx.aggregations])
    return SelectionPartial([], [])


def execute_segment(ctx: QueryContext, segment: ImmutableSegment):
    """Plan and execute one query over one segment (a star-tree rollup's
    path, startree/query.py)."""
    return execute_plan(SegmentPlanner(ctx, segment).plan())


def execute_plan(plan: CompiledPlan):
    ctx, seg = plan.ctx, plan.segment
    if plan.kind == "pruned":
        if not ctx.is_aggregation and plan.select_names:
            return SelectionPartial(list(plan.select_names), [])
        return empty_partial(ctx)
    if plan.kind == "fast":
        return AggPartial(list(plan.fast_states))
    if plan.kind == "host":
        with span("segment_host", segment=seg.name):
            if host_eval.null_aware(ctx):
                mask, _ = host_eval.eval_filter_3vl(ctx.filter, seg)
            else:
                mask = host_eval.eval_filter(ctx.filter, seg)
            vd = seg.valid_docs
            if vd is not None and \
                    not _truthy(ctx.options.get("skipUpsert")):
                mask = mask & vd[: seg.n_docs]
            if ctx.is_group_by:
                return GroupByPartial(
                    host_eval.host_group_by(ctx, seg, mask))
            if ctx.is_aggregation:
                return AggPartial(host_eval.host_aggregate(ctx, seg, mask))
            labels, rows, okeys = host_eval.host_selection(ctx, seg, mask)
            return SelectionPartial(labels, rows, okeys)
    if plan.kind == "kselect":
        return extract_select(plan, run_select_kernel(plan))
    if plan.kind != "kernel":
        raise ValueError(f"unknown plan kind {plan.kind!r}")
    out = run_kernel(plan)
    with span("extract_partial", segment=seg.name):
        return extract_partial(plan, out)


def to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Every output tensor on the host as numpy, in ONE device-to-host
    transfer: the outputs' bytes are packed into one buffer on their
    device, copied once, and split back apart on the host."""
    if not out:
        return {}
    parts = [v.detach().reshape(-1).contiguous() for v in out.values()]
    buf = torch.cat([p.view(torch.uint8) for p in parts]).cpu().numpy()
    host: Dict[str, np.ndarray] = {}
    pos = 0
    for (k, v), p in zip(out.items(), parts):
        nbytes = p.numel() * p.element_size()
        dt = torch.empty(0, dtype=v.dtype).numpy().dtype
        host[k] = buf[pos:pos + nbytes].view(dt).reshape(tuple(v.shape))
        pos += nbytes
    return host


def run_select_kernel(plan: CompiledPlan) -> Dict[str, np.ndarray]:
    seg = plan.segment
    with span("segment_kselect", segment=seg.name, bucket=seg.bucket):
        cols = seg.device_cols(plan.col_names)
        params = resolve_params(plan)
        fn = build_select_kernel(plan.select_plan, seg.bucket)
        host = fenced_run(fn, cols, seg.n_docs, params)
        global_accountant.track_result(host)
        return host


def fenced_run(fn, *args) -> Dict[str, np.ndarray]:
    """Launch ``fn(*args)`` and bring its outputs to the host, as the
    ``device_execute`` and ``device_transfer`` spans of a trace: under a
    trace the stream is synchronized between the two (``device_fence``),
    so the first covers the device work and the second the copy alone;
    untraced, the launches stay asynchronous and the copy waits."""
    with span("device_execute"):
        dev = fn(*args)
        device_fence(dev)
    with span("device_transfer"):
        return to_host(dev)


def extract_select(plan: CompiledPlan, out: Dict[str, np.ndarray]
                   ) -> "SelectionPartial":
    """Device top-k winners -> SelectionPartial (values resolved through
    the segment dictionaries; order keys resolved the same way so the
    broker's cross-segment merge compares values, not ids)."""
    seg, sp = plan.segment, plan.select_plan
    n = min(int(out["matched"]), sp.k)
    cols_vals: List[np.ndarray] = []
    for i, name in enumerate(plan.select_names):
        stored = np.asarray(out[f"sel_{i}"])[:n]
        d = seg.dictionary(name)
        cols_vals.append(d.values_for(stored) if d is not None else stored)
    rows = [tuple(_py(c[r]) for c in cols_vals) for r in range(n)]
    okeys_cols: List[np.ndarray] = []
    for j, (col, _d, card) in enumerate(sp.order):
        stored = np.asarray(out[f"ord_{j}"])[:n]
        name = plan.col_names[col]
        d = seg.dictionary(name)
        okeys_cols.append(d.values_for(stored) if d is not None else stored)
    okeys = [tuple(_py(c[r]) for c in okeys_cols) for r in range(n)]
    ctx = plan.ctx
    if any(isinstance(i, Star) for i in ctx.select_items):
        labels = list(plan.select_names)
    else:
        labels = list(ctx.labels)
    return SelectionPartial(labels, rows, okeys)


def resolve_params(plan: CompiledPlan) -> Tuple[torch.Tensor, ...]:
    """Planner params as tensors on the segment's device: symbolic
    markers hit the segment's device cache, literal scalars and arrays
    upload (tiny)."""
    seg = plan.segment
    out = []
    for p in plan.params:
        if isinstance(p, tuple) and len(p) == 2 and p[0] == "dictvals":
            out.append(seg.device_dict_values(p[1]))
        elif isinstance(p, tuple) and len(p) == 2 and p[0] == "hash64":
            # per-dict-id 64-bit hash table for sketch aggregations
            out.append(seg.device_dict_hashes(p[1]))
        elif isinstance(p, tuple) and len(p) == 2 and p[0] == "nullmask":
            out.append(seg.device_null_mask(p[1]))
        elif isinstance(p, tuple) and len(p) == 2 and p[0] == "validdocs":
            out.append(seg.device_valid_mask())
        elif isinstance(p, tuple) and len(p) == 2 and p[0] == "docmask":
            # host-computed doc mask, padded to the segment bucket
            mask = np.asarray(p[1], dtype=bool)
            padded = np.zeros(seg.bucket, dtype=bool)
            padded[: len(mask)] = mask
            out.append(torch.as_tensor(padded, device=seg.device))
        else:
            out.append(torch.as_tensor(np.asarray(p), device=seg.device))
    return tuple(out)


def _run(plan: CompiledPlan, cols, params, slots_cap, xfer_compact: bool
         ) -> Dict[str, np.ndarray]:
    seg = plan.segment
    fn = build_kernel(plan.kernel_plan, seg.bucket, slots_cap,
                      xfer_compact=xfer_compact, device=seg.device)
    return fenced_run(fn, cols, seg.n_docs, params)


def run_kernel(plan: CompiledPlan,
               xfer_compact: bool = True) -> Dict[str, np.ndarray]:
    """Run a kernel plan at the planner's compaction capacity, with the
    segment pinned in the device tier for the whole run (an admission of
    its own columns must not demote it).

    On ``overflow`` (the selectivity estimate undershot) it runs once more
    at ``full_slots_cap``, which cannot overflow, and remembers it
    (ops/plan_cache): the next run of the same plan at the same capacity
    goes straight to full capacity. After the run the matched fraction,
    read from the outputs already on the host, is recorded as the plan's
    measured selectivity, which the planner's drift re-quantization reads.
    On ``group_overflow`` (more live groups than the transfer cap) it runs
    again with dense (space,) outputs (``xfer_compact=False``)."""
    seg, kp = plan.segment, plan.kernel_plan
    with span("segment_kernel", segment=seg.name, bucket=seg.bucket,
              strategy=kp.strategy, est_sel=plan.est_selectivity,
              slots_cap=plan.slots_cap), global_tier.pinned({seg.uid}):
        cols = seg.device_cols(plan.col_names)
        params = resolve_params(plan)
        cap = plan.slots_cap
        if plan.drift_requantized:
            annotate(drift_requantized=True)
        if global_plan_cache.overflowed(kp, seg.bucket, cap):
            # this capacity overflowed before for this plan: skip the
            # doomed tight run and its retry
            cap = full_slots_cap(seg.bucket)
            annotate(slots_cap=cap, known_overflow=True)
        host = _run(plan, cols, params, cap, xfer_compact)
        if "matched" in host:
            matched = int(np.asarray(host["matched"]).sum())
            global_plan_cache.record_measured(
                kp, seg.bucket, matched, seg.n_docs, segment=seg,
                params=plan.params)
            annotate(matched=matched,
                     meas_sel=matched / max(seg.n_docs, 1))
        if int(host.pop("overflow", 0)):
            global_plan_cache.mark_overflowed(kp, seg.bucket, cap)
            global_metrics.count("compact_overflow_retries")
            cap = full_slots_cap(seg.bucket)
            with span("overflow_retry", slots_cap=cap):
                host = _run(plan, cols, params, cap, xfer_compact)
            host.pop("overflow", None)
            annotate(overflow_retry=True, slots_cap=cap)
        if int(host.pop("group_overflow", 0)):
            global_metrics.count("group_xfer_overflow_retries")
            with span("group_overflow_retry"):
                host = _run(plan, cols, params, cap, False)
            host.pop("overflow", None)
            annotate(group_overflow_retry=True)
        if tracing_active() and _truthy(
                plan.ctx.options.get("profilePhases")):
            # EXPLAIN ANALYZE deep mode: re-measure the kernel's mask /
            # fuse / compact / sort / aggregate / transfer ladder and
            # attach it as child spans (opt-in: it reruns the plan)
            with span("phase_profile"):
                attach_phase_spans(profile_plan(plan, iters=2))
        global_accountant.track_result(host)
        return host


def extract_partial(plan: CompiledPlan, out: Dict[str, np.ndarray]):
    ctx, seg = plan.ctx, plan.segment
    matched = int(out["matched"])
    if not ctx.is_group_by:
        na = host_eval.null_aware(ctx)
        states: List[Any] = []
        for b in plan.agg_bindings:
            states.append(_scalar_state(b, out, matched, seg, na))
        return AggPartial(states)

    gi = out.get("group_idx")
    gc = out["group_count"]
    if gi is not None:
        # device-compacted outputs: arrays are gathered non-empty rows,
        # gi holds their dense space ids (sentinel rows have count 0)
        sel = np.nonzero(gc > 0)[0]
        idxs = np.asarray(gi)[sel]
    else:
        idxs = np.nonzero(gc > 0)[0]
        sel = idxs
    # decode dense cartesian keys -> per-key ids -> values
    key_cols: List[np.ndarray] = []
    rem = idxs.copy()
    decoders = plan.group_decoders or [
        ("dict", name, seg.columns[name].cardinality)
        for name in plan.group_cols]
    for dec in reversed(decoders):
        card = dec[-1]
        ids = rem % card
        rem = rem // card
        if dec[0] == "dict":
            key_cols.append(seg.dictionary(dec[1]).values_for(ids))
        else:  # ("int", lo, stride, card): expression keys (YEAR(ts)...)
            key_cols.append(dec[1] + ids.astype(np.int64) * dec[2])
    key_cols.reverse()
    keys = [tuple(_py(kc[i]) for kc in key_cols) for i in range(len(idxs))]

    groups: Dict[Tuple, List[Any]] = {k: [] for k in keys}
    for b in plan.agg_bindings:
        per_group = _group_state(b, out, sel, seg)
        for k_i, k in enumerate(keys):
            groups[k].append(per_group[k_i])
    return GroupByPartial(groups)


def _scalar_state(b: AggBinding, out: Dict[str, np.ndarray], matched: int,
                  seg: ImmutableSegment, na: bool = False) -> Any:
    name = f"agg{b.index}_{_kind(b)}"
    k = _kind(b)
    # null-aware plans emit the aggregation's own non-null row count
    # (AggSpec.null_param); all-null input finalizes SUM/MIN/MAX to null
    nnz = out.get(name + "_nnz")
    eff = int(nnz) if nnz is not None else matched
    if k == "count":
        return int(out[name])
    if k == "sum":
        # COUNTMV rides the sum state but keeps COUNT semantics: empty
        # input is 0, never null
        if na and eff == 0 and b.agg.kind != "count_mv":
            return None
        v = out[name]
        return int(v) if b.integral else float(v)
    if k in ("min", "max"):
        if eff == 0:
            return None
        v = out[name]
        return int(v) if b.integral else float(v)
    if k == "avg":
        s = out[name + "_sum"]
        c = int(out[name + "_cnt"])
        return (int(s) if b.integral else float(s), c)
    if k == "distinct_count":
        present = out[name + "_present"]
        ids = np.nonzero(present)[0]
        vals = seg.dictionary(b.dict_col).values_for(ids)
        return set(_py(v) for v in vals)
    # device sketch partials -> host AggImpl state formats (the broker
    # reduce merges them through ops/aggregations like any host partial);
    # RAW forms share their base sketch's state (RawAgg delegates)
    k = {"raw_hll": "distinct_count_hll",
         "raw_theta": "distinct_count_theta",
         "percentile_raw_sketch": "percentile_sketch"}.get(k, k)
    if k == "distinct_count_hll":
        return _hll_registers(out[name + "_present"], b)[0]
    if k == "distinct_count_theta":
        # int64 bit patterns of the uint64 hashes; all ones is the sentinel
        h = np.asarray(out[name + "_hashes"]).view(np.uint64)
        sent = np.uint64(0xFFFFFFFFFFFFFFFF)
        return [int(x) for x in h if x != sent]
    if k == "percentile_sketch":
        means = np.asarray(out[name + "_pc_mean"])
        ws = np.asarray(out[name + "_pc_w"])
        return [[float(m_), float(w_)]
                for m_, w_ in zip(means, ws) if w_ > 0]
    raise ValueError(k)


def _group_state(b: AggBinding, out: Dict[str, np.ndarray],
                 idxs: np.ndarray, seg: ImmutableSegment) -> List[Any]:
    name = f"agg{b.index}_{_kind(b)}"
    k = _kind(b)
    if k == "count":
        # group COUNT is served by the kernel's shared count row
        return [int(x) for x in out["group_count"][idxs]]
    if k in ("sum", "min", "max"):
        arr = out[name][idxs]
        return [int(x) for x in arr] if b.integral else [float(x) for x in arr]
    if k == "avg":
        s = out[name + "_sum"][idxs]
        c = out[name + "_cnt"][idxs]
        if b.integral:
            return [(int(s[i]), int(c[i])) for i in range(len(idxs))]
        return [(float(s[i]), int(c[i])) for i in range(len(idxs))]
    if k == "distinct_count":
        present = out[name + "_present"][idxs]  # (n_groups, card)
        d = seg.dictionary(b.dict_col)
        res = []
        for row in present:
            ids = np.nonzero(row)[0]
            res.append(set(_py(v) for v in d.values_for(ids)))
        return res
    if k in ("distinct_count_hll", "raw_hll"):
        return _hll_registers(np.asarray(out[name + "_present"])[idxs], b)
    raise ValueError(k)


def _hll_registers(pm: np.ndarray, b: AggBinding) -> List[List[int]]:
    """(n?, m*R) presence bitmap(s) -> per-row HllAgg register lists,
    vectorized across groups (one reshape + two reductions)."""
    from ..ops.aggregations import HllAgg
    p = HllAgg(b.agg).log2m
    r_levels = 64 - p + 1
    pm = np.asarray(pm)
    if pm.ndim == 1:
        pm = pm[None, :]
    rr = pm.reshape(pm.shape[0], 1 << p, r_levels)
    ranks = np.arange(1, r_levels + 1, dtype=np.int64)
    regs = np.where(rr.any(axis=2), (rr * ranks).max(axis=2), 0)
    return [row.tolist() for row in regs]


def _kind(b: AggBinding) -> str:
    # MV kinds lower to their base kind's device states/names
    # (SUMMV -> agg<i>_sum etc.; ops/aggregations.MV_BASE_KIND)
    return aggregations.base_kind(b.agg.kind)


def _py(v: Any) -> Any:
    return v.item() if isinstance(v, np.generic) else v
