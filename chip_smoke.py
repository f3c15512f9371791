#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (pinot_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. device  - the card's name and power limit (nvidia-smi);
2. build   - every hand-written CUDA kernel, compiled with nvcc from the
             sources in this checkout (one nvcc per source, in parallel);
3. kernel  - each kernel against its plain PyTorch version on the card
             (exact equality on every output) over a grid of sizes,
             selectivities, column sets and capacities, with its time,
             the plain version's, the library yardstick's and the bound;
             then the compaction's edge cases (sizes at the edges of the
             kernel's tile, n = 1, matched == cap, masks and columns off
             a 16-byte boundary, all 8 columns in mixed types, a bool
             mask viewing bytes other than 0 and 1) and 20
             back-to-back launches with no sync between, bitwise equal;
4. segment - the flat SSB lineorder segment at PINOT_SMOKE_ROWS rows
             (default 2^26, about SSB SF11), built with the port's own
             builder and cached under .torch_cache/;
5. main    - Broker(device="cuda") serves the 13 SSB queries through
             connect(broker)(sql), one warm-up and ITERS timed runs each;
             every digest must equal the numpy oracle's, the compaction
             kernel must have launched, and every resident column must
             be on the card. Each query is then run once more split by
             layer (host clock) and once under torch.profiler (device
             time by op, idle share), and the compaction kernel is timed
             on each compact query's own inputs, with the device time of
             its pass and its tail fill apart (torch.profiler).
6. table   - the same seeded rows split into 8 segments of N_ROWS / 8
             rows (2^23 by default), cached under .torch_cache/;
7. multi   - Broker(device="cuda") over the 8-segment table serves the 13
             SSB queries, one warm-up and ITERS timed runs each; every
             digest must equal the single segment's and the oracle's, each
             query must take its expected route (segmented compaction,
             batched dense, or per segment), and each segmented compaction
             is held against the plain version on its own inputs and timed
             like the single-segment ones;
8. surface - one query or more per plan kind (fast, kselect, device
             sketches, host; tools/ssb.SURFACE) on the single segment and
             on the 8-segment table: each must plan its kind and equal the
             same query under OPTION(forceHostExecution=true) (the numpy
             host path): sketch states bitwise, percentile centroids
             against a numpy build of the same split to a relative 1e-9.

The line before the last is the JSON kernel table; the last line is
{"ok": true, "device": {...}}. Exits non-zero without CUDA, and without
the pinot_tpu_torch package beside it.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ROWS = int(os.environ.get("PINOT_SMOKE_ROWS", 1 << 26))
ITERS = 3
TABLE_SEGMENTS = 8
CACHE = os.path.join(ROOT, ".torch_cache")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
SSB_SF10_ROWS = 59_986_052       # lineorder rows at SSB scale factor 10
CHECK_N = (1 << 26, (1 << 26) - 12_345)
CHECK_SEL = (0.0, 0.001, 0.03, 0.25, 1.0)


def phase(label: str, /, **fields) -> None:
    print(json.dumps({"phase": label, **fields}), flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_time_ms(fn, reps: int) -> float:
    """Mean host time to issue fn() over reps calls, no sync between: the
    wrapper's cost on the host clock, not the device's."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def same_outputs(a, b) -> float:
    """Max abs difference over every output of two compactions; raises
    unless they are bitwise equal."""
    import torch

    valid_a, cols_a, nv_a, m_a, of_a = a
    valid_b, cols_b, nv_b, m_b, of_b = b
    if not torch.equal(valid_a, valid_b):
        raise AssertionError("valid flags differ")
    for x, y in zip(cols_a, cols_b):
        if x.dtype != y.dtype or not torch.equal(
                x.view(torch.int32 if x.element_size() == 4
                       else torch.int64),
                y.view(torch.int32 if y.element_size() == 4
                       else torch.int64)):
            raise AssertionError(f"{x.dtype} column differs")
    for x, y, what in ((nv_a, nv_b, "n_valid"), (m_a, m_b, "matched"),
                       (of_a, of_b, "overflow")):
        if int(x) != int(y):
            raise AssertionError(f"{what} {int(x)} != {int(y)}")
    return 0.0


def device_phase():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def build_phase() -> None:
    from pinot_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    phase("build", seconds=time.perf_counter() - t0, libraries=sorted(logs),
          ptxas=[ln for log in logs.values() for ln in log.splitlines()
                 if "registers" in ln or "smem" in ln])


MIXED8 = ("int32", "int64", "float32", "float64") * 2


def _column(name: str, n: int, dev, g):
    import torch

    if name in ("int32", "int64"):
        lim = 2**31 - 1 if name == "int32" else 2**62
        return torch.randint(-lim, lim, (n,), device=dev,
                             dtype=getattr(torch, name), generator=g)
    return torch.randn(n, device=dev, dtype=getattr(torch, name),
                       generator=g) * 1e9


def kernel_phase(device: str = "cuda") -> float:
    """The compaction kernel against compact_reference at every listed
    shape; returns the max abs error seen (0: all bitwise equal)."""
    import torch

    from pinot_tpu_torch.ops import compact as C

    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(1992)
    col_sets = (("int32",), ("int32", "int64"),
                ("int32", "float64", "float32"))
    err = 0.0
    for n in CHECK_N:
        pool = {k: _column(k, n, dev, g)
                for k in ("int32", "int64", "float64", "float32")}
        u = torch.rand(n, device=dev, generator=g)
        for sel in CHECK_SEL:
            mask = u < sel
            matched = int(mask.sum())
            for names in col_sets:
                cols = tuple(pool[k] for k in names)
                caps = {"tight": max(matched // (2 * C.LANES), 1),
                        "default": C.default_slots_cap(n),
                        "full": C.full_slots_cap(n)}
                for cap_name, cap in caps.items():
                    got = C.compact(mask, cols, cap)
                    want = C.compact_reference(mask, cols, cap)
                    err = max(err, same_outputs(got, want))
                    if cap_name == "tight" and matched > cap * C.LANES \
                            and int(got[4]) != 1:
                        raise AssertionError("tight cap did not overflow")
                    reps = 5
                    ms = cuda_time_ms(lambda: C.compact(mask, cols, cap),
                                      reps)
                    plain = cuda_time_ms(
                        lambda: C.compact_reference(mask, cols, cap), reps)
                    lib = cuda_time_ms(
                        lambda: [torch.masked_select(c, mask)
                                 for c in cols], reps)
                    bound = C.compact_bytes(n, cols, cap, matched) \
                        / HBM_BYTES_PER_S * 1e3
                    phase("kernel", kernel="compact", n=n, sel=sel,
                          cols=list(names), cap=cap_name,
                          slots_cap=cap, matched=matched,
                          overflow=int(got[4]), equal=True, ms=ms,
                          plain_ms=plain, masked_select_ms=lib,
                          bound_ms=bound)
        del pool, u
    return err


def edge_phase(tile: int, device: str = "cuda") -> float:
    """The compaction at the shapes that stress the look-back and the
    head/tail handling: n at the edges of the tile, n = 1, exactly cap
    matched rows, mask and columns sliced 3 rows into their allocations
    (off a 16-byte boundary), and all 8 columns in mixed 4- and 8-byte
    types. Returns the max abs error seen (0: all bitwise equal)."""
    import torch

    from pinot_tpu_torch.ops import compact as C

    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(2024)
    cases = [(n, sel, 0, ("int32", "float64"))
             for n in (tile - 1, tile, tile + 1, 33 * tile + 7, 1)
             for sel in (0.03, 0.5, 1.0)]
    cases += [(n, sel, off, MIXED8) for n in (33 * tile + 7, 1 << 20)
              for sel in (0.03, 0.5) for off in (0, 3)]
    cases += [(1, 0.5, 3, MIXED8)]
    err = 0.0
    for n, sel, off, names in cases:
        mask = (torch.rand(n + off, device=dev, generator=g) < sel)[off:]
        cols = tuple(_column(k, n + off, dev, g)[off:] for k in names)
        matched = int(mask.sum())
        caps = {"tight": max(matched // (2 * C.LANES), 1),
                "default": C.default_slots_cap(n),
                "full": C.full_slots_cap(n)}
        for cap_name, cap in caps.items():
            got = C.compact(mask, cols, cap)
            err = max(err, same_outputs(
                got, C.compact_reference(mask, cols, cap)))
            if int(got[4]) != int(matched > cap * C.LANES):
                raise AssertionError(f"overflow flag wrong at n={n}")
            phase("kernel_edge", n=n, sel=sel, offset=off,
                  mask_addr_mod16=mask.data_ptr() % 16, cols=list(names),
                  cap=cap_name, slots_cap=cap, matched=matched,
                  overflow=int(got[4]), equal=True)
    # exactly cap matched rows: no overflow, every slot valid
    n, slots_cap = 33 * tile + 7, 40
    cap = slots_cap * C.LANES
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[torch.randperm(n, device=dev, generator=g)[:cap]] = True
    cols = tuple(_column(k, n, dev, g) for k in MIXED8)
    got = C.compact(mask, cols, slots_cap)
    err = max(err, same_outputs(
        got, C.compact_reference(mask, cols, slots_cap)))
    if (int(got[2]), int(got[3]), int(got[4])) != (cap, cap, 0):
        raise AssertionError("matched == cap case: wrong scalars")
    phase("kernel_edge", n=n, case="matched == cap", slots_cap=slots_cap,
          matched=cap, overflow=0, equal=True)
    # a bool mask viewing bytes other than 0 and 1 keeps every non-zero row
    n = 33 * tile + 7
    raw = torch.randint(0, 4, (n + 3,), device=dev, dtype=torch.uint8,
                        generator=g)[3:]
    cols = tuple(_column(k, n, dev, g) for k in MIXED8)
    for slots_cap in (C.default_slots_cap(n), C.full_slots_cap(n)):
        err = max(err, same_outputs(
            C.compact(raw.view(torch.bool), cols, slots_cap),
            C.compact_reference(raw != 0, cols, slots_cap)))
    phase("kernel_edge", n=n, case="mask bytes 0..3", offset=3,
          equal=True)
    return err


def repeat_check(n: int, device: str = "cuda") -> None:
    """20 launches back to back with no sync between: every one bitwise
    equal to the first, and the first to the plain version."""
    import torch

    from pinot_tpu_torch.ops import compact as C

    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(20)
    mask = torch.rand(n, device=dev, generator=g) < 0.03
    cols = (_column("int32", n, dev, g), _column("int32", n, dev, g))
    cap = C.default_slots_cap(n)
    runs = [C.compact(mask, cols, cap) for _ in range(20)]
    same_outputs(runs[0], C.compact_reference(mask, cols, cap))
    for r in runs[1:]:
        same_outputs(r, runs[0])
    phase("kernel_repeat", n=n, launches=len(runs), slots_cap=cap,
          matched=int(runs[0][3]), equal=True)


def segment_phase() -> str:
    from pinot_tpu_torch.tools import ssb

    out_dir = os.path.join(CACHE, f"ssb_flat_{N_ROWS}")
    # a build cut off half way leaves no metadata.json and is rebuilt
    seg_dir = os.path.join(out_dir, "seg_0")
    t0 = time.perf_counter()
    cached = os.path.exists(os.path.join(seg_dir, "metadata.json"))
    if not cached:
        ssb.build_segment_dir(N_ROWS, out_dir)
    cuts = [f"{N_ROWS} rows of lineorder in one segment; SSB SF10 has "
            f"{SSB_SF10_ROWS} (scale factor here "
            f"{N_ROWS / SSB_SF10_ROWS * 10:.2f})",
            "dimension tables denormalized onto lineorder (as bench.py)"]
    if "PINOT_SMOKE_ROWS" in os.environ:
        cuts.append(f"PINOT_SMOKE_ROWS={N_ROWS} overrides the default "
                    f"{1 << 26}")
    phase("segment", rows=N_ROWS, dir=os.path.relpath(seg_dir, ROOT),
          cached=cached, seconds=time.perf_counter() - t0, cuts=cuts)
    return seg_dir


def _compact_inputs(plan):
    """The compaction kernel's inputs for a compact-strategy plan, built
    by the port's own prefix functions (mask, key, payloads)."""
    import torch

    from pinot_tpu_torch.engine.executor import resolve_params
    from pinot_tpu_torch.ops import kernels as K

    seg, kp = plan.segment, plan.kernel_plan
    cols = seg.device_cols(plan.col_names)
    params = resolve_params(plan)
    mask = (torch.arange(seg.bucket, device=seg.device) < seg.n_docs) \
        & K._eval_pred(kp.pred, cols, params, seg.bucket, seg.device)
    mask, keys = K._group_keys_sentinel(kp, mask, cols, params)
    payloads = K._payload_columns(kp, mask, cols, params)[0]
    return mask, (keys,) + payloads


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def layer_breakdown(query_sql: str, seg, device: str) -> dict:
    """One run of a query split by layer on the host clock (each layer
    ends in a device sync): parse + plan, kernel (device work and the
    transfer of its outputs), extract, reduce."""
    from pinot_tpu_torch.engine.executor import extract_partial, run_kernel
    from pinot_tpu_torch.engine.reduce import reduce_partials
    from pinot_tpu_torch.query.context import build_query_context
    from pinot_tpu_torch.query.planner import SegmentPlanner
    from pinot_tpu_torch.query.sql import parse_sql

    out = {}
    t0 = time.perf_counter()
    ctx = build_query_context(parse_sql(query_sql))
    plan = SegmentPlanner(ctx, seg).plan()
    t1 = time.perf_counter()
    host = run_kernel(plan)
    _sync(device)
    t2 = time.perf_counter()
    partial = extract_partial(plan, host)
    t3 = time.perf_counter()
    reduce_partials(ctx, [partial])
    t4 = time.perf_counter()
    out.update(plan_ms=(t1 - t0) * 1e3, kernel_ms=(t2 - t1) * 1e3,
               extract_ms=(t3 - t2) * 1e3, reduce_ms=(t4 - t3) * 1e3)
    return out


COMPACT_KERNELS = ("compact_pass", "compact_fill")


def _dev_ms(e) -> float:
    us = getattr(e, "self_device_time_total", None)
    if us is None:
        us = getattr(e, "self_cuda_time_total", 0.0)
    return float(us or 0.0) / 1e3


def _on_device(events):
    return [e for e in events if str(e.device_type).endswith("CUDA")]


def compact_split_ms(fn, reps: int = 10) -> dict:
    """Device time per call of the compaction's three device operations
    (scratch memset, pass, fill) from torch.profiler over ``reps``
    calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"pass_ms": 0.0, "fill_ms": 0.0, "memset_ms": 0.0}
    for e in _on_device(prof.key_averages()):
        key = ("pass_ms" if "compact_pass" in e.key else
               "fill_ms" if "compact_fill" in e.key else
               "memset_ms" if "emset" in e.key else None)
        if key:
            out[key] += _dev_ms(e) / reps
    return out


def profile_query(query, sql: str, top: int = 6) -> dict:
    """One run of a query under torch.profiler: the device's busy time
    (the sum of its kernels' times), its idle share of the run's wall
    time, the compaction kernel's share, and the torch ops with the most
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        query(sql)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = prof.key_averages()
    on_device = _on_device(events)
    busy_ms = sum(_dev_ms(e) for e in on_device)
    compact_ms = sum(_dev_ms(e) for e in on_device
                     if any(k in e.key for k in COMPACT_KERNELS))
    ops = sorted(((e.key, _dev_ms(e), e.count) for e in events
                  if e not in on_device and _dev_ms(e) > 0),
                 key=lambda t: -t[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "compact_kernel_ms": compact_ms,
            "top_ops": [{"op": k, "ms": ms, "calls": n}
                        for k, ms, n in ops[:top]]}


def main_phase(seg_dir: str, tile: int, device: str = "cuda"):
    """The main path on ``device`` ("cuda" for the check; "cpu" rehearses
    the flow on a machine without a card, with the kernels' plain
    versions)."""
    import torch

    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.ops import compact as C
    from pinot_tpu_torch.query.context import build_query_context
    from pinot_tpu_torch.query.planner import SegmentPlanner
    from pinot_tpu_torch.query.sql import parse_sql
    from pinot_tpu_torch.server import TableDataManager
    from pinot_tpu_torch.tools import ssb

    dm = TableDataManager("lineorder", device=device)
    seg = dm.add_segment_dir(seg_dir)
    broker = Broker(device=device)
    broker.register_table(dm)
    query = connect(broker)

    sqls = [(qid, ssb.spec_to_sql(p, v, g), p, v, g)
            for qid, p, v, g in ssb.QUERIES]
    C.launches = 0                       # the main path's run starts here
    results = {}
    for qid, sql, *_spec in sqls:
        before = C.launches
        res = query(sql)                 # warm-up (uploads columns)
        times = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            res = query(sql)            # rows are on the host: synced
            times.append((time.perf_counter() - t0) * 1e3)
        results[qid] = (res, times, C.launches - before)
    main_launches = C.launches           # ... and ends here

    residency = seg.resident_devices()
    off_card = {c: d for c, d in residency.items()
                if not d.startswith(device)}
    if off_card:
        raise AssertionError(f"columns resident off the card: {off_card}")
    compact_plans = []
    for qid, sql, p, v, g in sqls:
        res, times, launched = results[qid]
        plan = SegmentPlanner(build_query_context(parse_sql(sql)),
                              seg).plan()
        expected, oracle_s = ssb.oracle_run(seg, p, v, g)
        ok = ssb._digest(res.rows) == ssb._digest(expected)
        strategy = plan.kernel_plan.strategy if g else "scalar"
        phase("query", qid=qid, ok=ok, kind=plan.kind, strategy=strategy,
              slots_cap=plan.slots_cap, rows=len(res.rows),
              p50_ms=statistics.median(times), times_ms=times,
              compact_launches=launched, oracle_ms=oracle_s * 1e3,
              layers=layer_breakdown(sql, seg, device),
              profile=(profile_query(query, sql)
                       if device.startswith("cuda") else None),
              columns={c: residency.get(c) for c in plan.col_names})
        if not ok:
            raise AssertionError(f"{qid}: digest differs from the oracle")
        if g and strategy == "compact":
            if launched == 0:
                raise AssertionError(f"{qid}: compact plan never launched "
                                     "the compaction kernel")
            compact_plans.append((qid, plan))
    if main_launches == 0:
        raise AssertionError("the main path never launched the compaction "
                             "kernel")

    # the kernel at the main path's own shapes: one launch per compact
    # query on that query's real inputs (a first profiler session can
    # come back without device events, so one is run and dropped)
    if compact_plans:
        mask, cols = _compact_inputs(compact_plans[0][1])
        compact_split_ms(lambda: C.compact(mask, cols,
                                           compact_plans[0][1].slots_cap))
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "bound_ms": 0.0, "pass_ms": 0.0, "fill_ms": 0.0,
              "memset_ms": 0.0, "device_ms": 0.0, "host_ms": 0.0}
    for qid, plan in compact_plans:
        mask, cols = _compact_inputs(plan)
        cap = plan.slots_cap
        got = C.compact(mask, cols, cap)
        same_outputs(got, C.compact_reference(mask, cols, cap))
        row = {"ms": cuda_time_ms(lambda: C.compact(mask, cols, cap), 20),
               "plain_ms": cuda_time_ms(
                   lambda: C.compact_reference(mask, cols, cap), 20),
               "library_ms": cuda_time_ms(
                   lambda: [torch.masked_select(c, mask) for c in cols],
                   20),
               "bound_ms": C.compact_bytes(mask.shape[0], cols, cap,
                                           int(got[3]))
               / HBM_BYTES_PER_S * 1e3,
               **compact_split_ms(lambda: C.compact(mask, cols, cap)),
               "host_ms": host_time_ms(
                   lambda: C.compact(mask, cols, cap), 20)}
        row["device_ms"] = row["pass_ms"] + row["fill_ms"] + row["memset_ms"]
        for k in totals:
            totals[k] += row[k]
        phase("kernel_at_main_path", qid=qid, n=mask.shape[0],
              tiles=-(-mask.shape[0] // tile),
              cols=[str(c.dtype) for c in cols], slots_cap=cap,
              matched=int(got[3]), **row)
    digests = {qid: ssb._digest(results[qid][0].rows) for qid, *_r in sqls}
    return main_launches, totals, len(compact_plans), digests


def table_phase() -> str:
    from pinot_tpu_torch.tools import ssb

    n_seg = TABLE_SEGMENTS
    sizes = [N_ROWS // n_seg] * n_seg
    out_dir = os.path.join(CACHE, f"ssb_table_{N_ROWS}_{n_seg}")
    t0 = time.perf_counter()
    # a build cut off half way leaves a segment without metadata.json
    cached = os.path.isdir(out_dir) and sum(
        os.path.exists(os.path.join(out_dir, d, "metadata.json"))
        for d in os.listdir(out_dir)) == n_seg
    if not cached:
        shutil.rmtree(out_dir, ignore_errors=True)
        ssb.build_table_dir(sizes, out_dir)
    cuts = [f"{n_seg} segments of {sizes[0]} rows: the {sum(sizes)} rows of "
            "the single segment, in order, split",
            "dimension tables denormalized onto lineorder (as bench.py)"]
    phase("table", segments=n_seg, rows=sum(sizes),
          dir=os.path.relpath(out_dir, ROOT), cached=cached,
          seconds=time.perf_counter() - t0, cuts=cuts)
    return out_dir


def _expected_route(plans) -> str:
    """The route the batched dispatch should give a query's plans (all
    segments share one bucket here)."""
    from pinot_tpu_torch.engine import batch
    from pinot_tpu_torch.ops.kernels import (COMPACT_GROUP_LIMIT,
                                             segmented_compact_ok)

    p = plans[0]
    if p.kind != "kernel":
        return p.kind
    kp = p.kernel_plan
    if kp.strategy != "compact":
        return batch.BATCHED
    if segmented_compact_ok(kp) and \
            len(plans) * kp.group_space <= COMPACT_GROUP_LIMIT:
        return batch.SEGMENTED
    return batch.PER_SEGMENT


def _segmented_inputs(plans):
    """The compaction kernel's inputs for one segmented group, built by
    the port's own prefix functions, and the capacity the dispatch uses."""
    from pinot_tpu_torch.engine import batch
    from pinot_tpu_torch.engine.executor import resolve_params
    from pinot_tpu_torch.multistage.costs import scaled_compact_cap
    from pinot_tpu_torch.ops import kernels as K

    kp, bucket = plans[0].kernel_plan, plans[0].segment.bucket
    n_docs = [p.segment.n_docs for p in plans]
    plan2, mask, flat, params = K.segmented_inputs(
        kp, bucket, batch._stacked_cols(plans, bucket), n_docs,
        [resolve_params(p) for p in plans])
    mask, keys = K._group_keys_sentinel(plan2, mask, flat, params)
    payloads = K._payload_columns(plan2, mask, flat, params)[0]
    return mask, (keys,) + payloads, scaled_compact_cap(plans[0],
                                                         sum(n_docs))


def multi_phase(table_dir: str, digests: dict, tile: int,
                device: str = "cuda"):
    """The 13 SSB queries over the many-segment table: digests, routes,
    K1 launches, p50, device busy time, and every segmented compaction
    held against the plain version and timed at its real inputs."""
    import torch

    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.engine import batch, serving
    from pinot_tpu_torch.ops import compact as C
    from pinot_tpu_torch.query.context import build_query_context
    from pinot_tpu_torch.query.sql import parse_sql
    from pinot_tpu_torch.server import TableDataManager
    from pinot_tpu_torch.tools import ssb

    dm = TableDataManager("lineorder", device=device)
    segs = dm.add_table_dir(table_dir)
    broker = Broker(device=device)
    broker.register_table(dm)
    query = connect(broker)
    sqls = [(qid, ssb.spec_to_sql(p, v, g)) for qid, p, v, g in ssb.QUERIES]

    C.launches = 0                       # the multi path's run starts here
    runs = {}
    for qid, sql in sqls:
        before = C.launches
        res = query(sql)                 # warm-up (uploads, stacks)
        times = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            res = query(sql)
            times.append((time.perf_counter() - t0) * 1e3)
        runs[qid] = (res, times, C.launches - before)
    multi_launches = C.launches          # ... and ends here

    totals = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "pass_ms", "fill_ms", "memset_ms",
                               "device_ms", "host_ms")}
    n_segmented = 0
    for qid, sql in sqls:
        res, times, launched = runs[qid]
        ex = serving.execute_segments(build_query_context(parse_sql(sql)),
                                      segs)
        routes = sorted(set(ex.routes))
        want = _expected_route(ex.plans)
        ok = ssb._digest(res.rows) == digests[qid]
        phase("multi_query", qid=qid, ok=ok, routes=routes,
              expected_route=want, segments=len(segs),
              strategy=(ex.plans[0].kernel_plan.strategy
                        if ex.plans[0].kind == "kernel" else None),
              rows=len(res.rows), p50_ms=statistics.median(times),
              times_ms=times, compact_launches=launched,
              num_docs_scanned=res.num_docs_scanned,
              profile=(profile_query(query, sql)
                       if device.startswith("cuda") else None))
        if not ok:
            raise AssertionError(f"{qid}: the 8-segment digest differs from "
                                 "the single segment's and the oracle's")
        if routes != [want]:
            raise AssertionError(f"{qid}: routes {routes}, expected {want}")
        if want in (batch.SEGMENTED, batch.PER_SEGMENT) and launched == 0:
            raise AssertionError(f"{qid}: compact query never launched the "
                                 "compaction kernel")
        if want != batch.SEGMENTED:
            continue
        n_segmented += 1
        mask, cols, cap = _segmented_inputs(ex.plans)
        got = C.compact(mask, cols, cap)
        same_outputs(got, C.compact_reference(mask, cols, cap))
        row = {"ms": cuda_time_ms(lambda: C.compact(mask, cols, cap), 20),
               "plain_ms": cuda_time_ms(
                   lambda: C.compact_reference(mask, cols, cap), 20),
               "library_ms": cuda_time_ms(
                   lambda: [torch.masked_select(c, mask) for c in cols],
                   20),
               "bound_ms": C.compact_bytes(mask.shape[0], cols, cap,
                                           int(got[3]))
               / HBM_BYTES_PER_S * 1e3,
               **compact_split_ms(lambda: C.compact(mask, cols, cap)),
               "host_ms": host_time_ms(
                   lambda: C.compact(mask, cols, cap), 20)}
        row["device_ms"] = row["pass_ms"] + row["fill_ms"] + row["memset_ms"]
        for k in totals:
            totals[k] += row[k]
        phase("kernel_at_segmented_path", qid=qid, n=mask.shape[0],
              segments=len(segs), tiles=-(-mask.shape[0] // tile),
              cols=[str(c.dtype) for c in cols], slots_cap=cap,
              matched=int(got[3]), equal=True, **row)
    if multi_launches == 0 or n_segmented == 0:
        raise AssertionError("the segmented path never ran the compaction "
                             "kernel")
    return multi_launches, totals, n_segmented, segs


def _percentile_reference(seg_list, sql: str, c: int):
    """The device percentile sketch's centroids built with numpy from the
    same matched values: per segment, equal-count chunks with bounds
    floor(j * m / c), means from float64 prefix sums."""
    import numpy as np

    from pinot_tpu_torch.engine import host_eval
    from pinot_tpu_torch.query.context import build_query_context
    from pinot_tpu_torch.query.sql import parse_sql

    ctx = build_query_context(parse_sql(sql))
    out = []
    for seg in seg_list:
        mask = host_eval.eval_filter(ctx.filter, seg)
        v = np.sort(host_eval.eval_value(ctx.aggregations[0].arg, seg)
                    [mask].astype(np.float64))
        ps = np.concatenate([[0.0], np.cumsum(v)])
        bounds = np.arange(c + 1, dtype=np.int64) * len(v) // c
        w = np.diff(bounds)
        sums = ps[bounds[1:]] - ps[bounds[:-1]]
        out.append([[s / k, float(k)] for s, k in zip(sums, w) if k > 0])
    return out


def _state(partial):
    """A partial's mergeable states (aggregation or group-by)."""
    return partial.states if hasattr(partial, "states") else partial.groups


def surface_phase(seg_list, label: str):
    """Each surface query plans its kind and equals its forceHostExecution
    twin (the numpy host path); the twin and host-kind queries run once
    (numpy on the host CPU), the others warm up and run ITERS times."""
    import numpy as np

    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.engine import serving
    from pinot_tpu_torch.engine.reduce import reduce_partials
    from pinot_tpu_torch.ops.aggregations import TDIGEST_MAX_CENTROIDS
    from pinot_tpu_torch.query import planner
    from pinot_tpu_torch.query.context import build_query_context
    from pinot_tpu_torch.query.sql import parse_sql
    from pinot_tpu_torch.server import TableDataManager
    from pinot_tpu_torch.tools import ssb

    device = seg_list[0].device
    dm = TableDataManager("lineorder", device=device)
    for seg in seg_list:
        dm.add_segment(seg)
    broker = Broker(device=device)
    broker.register_table(dm)
    query = connect(broker)
    host_opt = " OPTION(forceHostExecution=true)"
    for name, sql, kind in ssb.SURFACE:
        if name == "hll_grouped" and seg_list[0].bucket * (7 + 1) \
                > planner.DENSE_ONEHOT_BUDGET:
            # the reference planner's dense budget on a GPU (7 years)
            kind = "host"
        ctx = build_query_context(parse_sql(sql))
        ex = serving.execute_segments(ctx, seg_list)
        kinds = sorted({p.kind for p in ex.plans})
        if kinds != [kind]:
            raise AssertionError(f"{name}: planned {kinds}, expected {kind}")
        hctx = build_query_context(parse_sql(sql + host_opt))
        hx = serving.execute_segments(hctx, seg_list)
        host = reduce_partials(hctx, hx.partials)
        on_card = kind != "host"
        times = []
        for _ in range(ITERS if on_card else 1):
            t0 = time.perf_counter()
            res = query(sql)
            times.append((time.perf_counter() - t0) * 1e3)
        check = "rows equal"
        if name == "percentile":
            # the host sketch chunks with np.array_split, the device sketch
            # with floor bounds: the states are held to a numpy build of
            # the device's split, the result to the sketch's tolerance
            ref = _percentile_reference(seg_list, sql,
                                        TDIGEST_MAX_CENTROIDS)
            for got, want in zip([p.states[0] for p in ex.partials], ref):
                g, w = np.asarray(got), np.asarray(want)
                if g.shape != w.shape or (g[:, 1] != w[:, 1]).any() or \
                        not np.allclose(g[:, 0], w[:, 0], rtol=1e-9,
                                        atol=0):
                    raise AssertionError("percentile centroids differ from "
                                         "the numpy build")
            spread = float(seg_list[0].columns["lo_revenue"].max
                           - seg_list[0].columns["lo_revenue"].min)
            if abs(res.rows[0][0] - host.rows[0][0]) > 0.02 * spread:
                raise AssertionError("percentile off the host's by more "
                                     "than 2% of the value range")
            check = ("centroids == numpy build (rel 1e-9); result within "
                     "2% of the range of the host's")
        else:
            if name.startswith(("hll", "theta")) and \
                    [_state(p) for p in ex.partials] != \
                    [_state(p) for p in hx.partials]:
                raise AssertionError(f"{name}: sketch states differ from "
                                     "the host path's")
            if res.rows != host.rows:
                raise AssertionError(f"{name}: rows differ from the host "
                                     "path's")
        phase("surface", table=label, name=name, kind=kind, check=check,
              rows=len(res.rows), p50_ms=statistics.median(times),
              times_ms=times, routes=sorted(set(ex.routes)),
              profile=(profile_query(query, sql)
                       if on_card and device.type == "cuda" else None))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pinot_tpu_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
    smi = device_phase()
    build_phase()
    from pinot_tpu_torch.ops import compact as C
    tile = C.tile_rows()
    err = max(kernel_phase(), edge_phase(tile))
    repeat_check(CHECK_N[0])
    seg_dir = segment_phase()
    launches, totals, n_compact, digests = main_phase(seg_dir, tile)
    table_dir = table_phase()
    seg_launches, seg_totals, n_segmented, segs = multi_phase(
        table_dir, digests, tile)
    from pinot_tpu_torch.segment import load_segment
    surface_phase([load_segment(seg_dir, "cuda")], "1 segment")
    surface_phase(segs, f"{len(segs)} segments")
    phase("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{
        "name": "compact",
        "route": "cuda",
        "source": "pinot_tpu_torch/ops/csrc/compact.cu",
        "replaces": "pinot_tpu/ops/compact.py:252",
        "launches": launches + seg_launches,
        "max_abs_err": err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes",
        "library_ms": totals["library_ms"],
        "pass_ms": totals["pass_ms"],
        "fill_ms": totals["fill_ms"],
        "memset_ms": totals["memset_ms"],
        "device_ms": totals["device_ms"],
        "host_ms": totals["host_ms"],
        "tile_rows": tile,
        "single_segment_launches": launches,
        "segmented_launches": seg_launches,
        **{f"segmented_{k}": v for k, v in seg_totals.items()},
        "at": f"sum of one launch per compact-strategy SSB query "
              f"({n_compact}) at {N_ROWS} rows; library = "
              "torch.masked_select per column; ms, plain_ms, library_ms = "
              "CUDA events over 20 back-to-back calls (host included); "
              "pass/fill/memset = device time by torch.profiler, "
              "device_ms their sum; host_ms = host clock to issue a call; "
              f"segmented_* = the same sums over one launch per "
              f"segmented-route query ({n_segmented}) on the "
              f"{TABLE_SEGMENTS}-segment table; launches = the single-"
              "segment run's plus the 8-segment run's"}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
