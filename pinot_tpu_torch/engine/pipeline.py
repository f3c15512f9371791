"""Pipelined (double-buffered) segment scan, K13: the next segment's
host-to-device copy overlaps the kernel of the current one.

Port of ``pinot_tpu/engine/pipeline.py``. This path exists for dense
groups whose stacked working set exceeds the device budget: the resident
path (engine/batch.py) makes every segment's columns resident and stacks
them, which is faster but needs the data to fit; this one holds at most
TWO segments' columns on the device at a time and streams the rest.

The JAX package gets its overlap from asynchronous dispatch and
``jax.device_put``. In torch a ``.to(device)`` from pageable memory
blocks, and a fresh ``pin_memory()`` per segment page-locks each time, so
on CUDA the port streams through buffers allocated once per call:

- one copy stream per device (``torch.cuda.Stream``, created lazily);
- per column, two pinned host buffers and two device buffers of
  ``bucket`` rows (slots 0 and 1; the device buffers are allocated on the
  compute stream, which owns them);
- segment *k* uses slot *s = k mod 2*:
  1. the host waits on ``h2d_done[s]`` (the copy out of ``pinned[s]`` for
     segment *k-2*), then fills ``pinned[s]`` straight from the memmap
     (``ImmutableSegment.fill_col_padded``: widen and pad in one pass);
  2. the copy stream waits on ``kernel_done[s]`` (the kernel of segment
     *k-2*, the last reader of ``dev[s]``), copies ``pinned[s]`` into
     ``dev[s]`` and records ``h2d_done[s]``;
  3. the compute stream waits on ``h2d_done[s]``, runs the kernel and
     records ``kernel_done[s]``.
  The copy of segment *k+1* is issued before kernel *k* is launched. Each
  segment's outputs stay on the device; they come over in one stacked
  transfer at the end, as engine/batch._run_batched does.

Drop any one of those waits and a slot is overwritten while the previous
segment still reads it: the answer is then wrong and nothing fails.
tests/test_torch_cuda.py widens each race with spins queued on the two
streams, holds every segment's partial to the CPU's, and shows that
dropping any one of the waits changes the partials. On the CPU the same loop stages each segment's padded host
arrays in turn, with no copy.

The pipeline touches neither the tier nor the heat table (its buffers are
transient, not a devmem pool), and a ``group_overflow`` segment reruns
from freshly staged columns, never through ``run_kernel``, whose device
cache would make resident the very working set this path avoids.

The router (engine/batch.execute_plans_batched) sends a dense group here
when ``group_stack_bytes`` exceeds ``hbm_budget_bytes``. The accountant
samples before each segment (a killed or timed-out query stops there) and
sizes the transferred outputs (``track_result``).
"""
from __future__ import annotations

import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels import build_kernel
from ..query.planner import CompiledPlan
from ..segment.immutable import _upload
from .accounting import global_accountant
from .executor import extract_partial, to_host

# the JAX package's default, half of a 16 GB TPU v5e; the port uses it on
# the CPU and half the card's memory on CUDA
_DEFAULT_BUDGET = 8 << 30
# device index -> half the card's total memory
_HALF_CARD: Dict[Optional[int], int] = {}

# how many pipelined streams ran (tests read exact counts)
STATS = {"pipelined_groups": 0, "pipelined_segments": 0}
_STATS_LOCK = threading.Lock()
# the last pipelined group's host fill time and, on CUDA, one timing event
# pair and byte count per copy on the copy stream (read by chip_smoke.py
# after the query has synced)
LAST_RUN: Dict[str, Any] = {"fill_s": 0.0, "h2d": []}
_COPY_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _bump(name: str) -> None:
    with _STATS_LOCK:
        STATS[name] += 1


def hbm_budget_bytes(device: Optional[torch.device] = None) -> int:
    """Resident-scan budget: PINOT_HBM_BUDGET_BYTES when set; else half of
    the card's memory (``total_memory``) on CUDA and 8 GiB on the CPU. The
    budget moves a dense group between the resident and the streamed
    route, never a row: both give the same partials."""
    raw = os.environ.get("PINOT_HBM_BUDGET_BYTES")
    if raw:
        return int(raw)
    if device is not None and device.type == "cuda":
        half = _HALF_CARD.get(device.index)
        if half is None:
            # read once per card: the router asks for every dense group
            half = _HALF_CARD[device.index] = \
                torch.cuda.get_device_properties(device).total_memory // 2
        return half
    return _DEFAULT_BUDGET


def group_stack_bytes(plans: List[CompiledPlan], bucket: int) -> int:
    """Footprint of stacking this group's columns on the device (what
    engine/batch.py would upload, in the segments' padded layout)."""
    return sum(math.prod(p.segment.padded_shape(c, bucket))
               * p.segment.padded_dtype(c).itemsize
               for p in plans for c in p.col_names)


def _copy_stream(dev: torch.device) -> torch.cuda.Stream:
    s = _COPY_STREAMS.get(dev.index)
    if s is None:
        s = _COPY_STREAMS[dev.index] = torch.cuda.Stream(device=dev)
    return s


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


def _slots(seg, names: List[str], bucket: int, dev: torch.device,
           copy: torch.cuda.Stream
           ) -> List[List[Tuple[torch.Tensor, torch.Tensor]]]:
    """The two staging slots of one call: per slot and column a pinned
    host buffer and a device buffer in the padded layout of ``seg``."""
    out = []
    for _s in range(2):
        bufs = []
        for c in names:
            shape = seg.padded_shape(c, bucket)
            dt = _torch_dtype(seg.padded_dtype(c))
            d = torch.empty(shape, dtype=dt, device=dev)
            # the copy stream writes it: its memory is not handed out again
            # before that stream's work is done
            d.record_stream(copy)
            bufs.append((torch.empty(shape, dtype=dt, pin_memory=True), d))
        out.append(bufs)
    return out


def _stream_cuda(group: List[CompiledPlan], bucket: int, fn,
                 params: List[Tuple]) -> List[Dict[str, torch.Tensor]]:
    dev = group[0].segment.device
    compute = torch.cuda.current_stream(dev)
    copy = _copy_stream(dev)
    slots = _slots(group[0].segment, group[0].col_names, bucket, dev, copy)
    h2d_done: List[Optional[torch.cuda.Event]] = [None, None]
    kernel_done: List[Optional[torch.cuda.Event]] = [None, None]

    def stage(k: int) -> None:
        s, seg = k % 2, group[k].segment
        if h2d_done[s] is not None:
            h2d_done[s].synchronize()        # pinned[s] is free again
        bufs = slots[s]
        t0 = time.perf_counter()
        for c, (pinned, _d) in zip(group[k].col_names, bufs):
            if _torch_dtype(seg.padded_dtype(c)) != pinned.dtype:
                # one group stacks one layout; a cast could truncate
                raise ValueError(f"column {c!r} of {seg.name!r} is "
                                 f"{seg.padded_dtype(c)}, the group's is "
                                 f"{pinned.dtype}")
            seg.fill_col_padded(c, pinned.numpy())
        LAST_RUN["fill_s"] += time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(copy):
            if kernel_done[s] is not None:
                copy.wait_event(kernel_done[s])   # dev[s] is free again
            start.record(copy)
            for pinned, d in bufs:
                d.copy_(pinned, non_blocking=True)
            done.record(copy)
        h2d_done[s] = done
        LAST_RUN["h2d"].append((start, done,
                                sum(int(d.nbytes) for _p, d in bufs)))

    outs = []
    stage(0)
    for k, plan in enumerate(group):
        global_accountant.sample()
        s = k % 2
        if k + 1 < len(group):
            stage(k + 1)                     # next copy before this kernel
        compute.wait_event(h2d_done[s])
        outs.append(fn(tuple(d for _p, d in slots[s]), plan.segment.n_docs,
                       params[k]))
        done = torch.cuda.Event()
        done.record(compute)
        kernel_done[s] = done
        _bump("pipelined_segments")
    return outs


def _stream_host(group: List[CompiledPlan], bucket: int, fn,
                 params: List[Tuple]) -> List[Dict[str, torch.Tensor]]:
    outs = []
    for k, plan in enumerate(group):
        global_accountant.sample()
        t0 = time.perf_counter()
        cols = _staged_cols(plan, bucket)
        LAST_RUN["fill_s"] += time.perf_counter() - t0
        outs.append(fn(cols, plan.segment.n_docs, params[k]))
        _bump("pipelined_segments")
    return outs


def _staged_cols(plan: CompiledPlan, bucket: int) -> Tuple[torch.Tensor, ...]:
    """A segment's padded columns on its device, outside the segment's
    device cache (the group_overflow rerun, and every segment on the
    CPU)."""
    seg = plan.segment
    return tuple(_upload(seg.host_col_padded(c, bucket), seg.device)
                 for c in plan.col_names)


def execute_kernel_plans_pipelined(plans: List[CompiledPlan],
                                   plan_struct, bucket: int,
                                   resolved_params: Dict[int, Tuple],
                                   idxs: List[int]) -> List[Any]:
    """Run same-structure dense kernel plans one segment at a time with the
    next segment's copy in flight; returns the partials in ``idxs``
    order."""
    group = [plans[i] for i in idxs]
    params = [resolved_params[i] for i in idxs]
    dev = group[0].segment.device
    fn = build_kernel(plan_struct, bucket, device=dev)
    _bump("pipelined_groups")
    LAST_RUN.update(fill_s=0.0, h2d=[])
    run = _stream_cuda if dev.type == "cuda" else _stream_host
    outs = run(group, bucket, fn, params)
    host = to_host({name: torch.stack([o[name] for o in outs])
                    for name in outs[0]})
    global_accountant.track_result(host)
    results = []
    dense_fn = None
    for k, plan in enumerate(group):
        per_seg = {name: v[k] for name, v in host.items()}
        if int(per_seg.pop("group_overflow", 0)):
            # more live groups than the transfer cap: rerun this segment
            # with dense outputs from freshly staged columns
            if dense_fn is None:
                dense_fn = build_kernel(plan_struct, bucket,
                                        xfer_compact=False, device=dev)
            per_seg = to_host(dense_fn(_staged_cols(plan, bucket),
                                       plan.segment.n_docs, params[k]))
            per_seg.pop("group_overflow", None)
            global_accountant.track_result(per_seg)
        results.append(extract_partial(plan, per_seg))
    return results
