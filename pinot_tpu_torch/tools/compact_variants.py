"""Time design variants of the compaction kernel against each other.

    python3 -m pinot_tpu_torch.tools.compact_variants [--rows N]
        [--rounds R] [--reps K] [--out FILE.jsonl]

Needs the card and nvcc. Each variant is ``ops/csrc/compact.cu`` with
anchored text substitutions; a substitution whose anchor is not found
exactly once fails the run. Each variant is built with the same nvcc
flags as the library, under ``build/torch_kernels/variants/``:

- ``committed``: the source as it is;
- ``acq_rel``: status words loaded with acquire and stored with release
  ordering instead of relaxed;
- ``subtiles2``, ``subtiles1``: tiles of 2 and 1 sub-tiles instead of 4;
- ``zero_first``: the outputs cleared by memsets before the pass instead
  of the tail fill after it.

The cases are uniform random masks over ``--rows`` rows with two int32
columns, at keep rates and capacities like those of the SSB compact
queries at 2^26 rows. Every variant must equal ``compact_reference``
bitwise at every case. Then, in ``--rounds`` rounds with the variants'
order rotated each round, each case is timed: device time per call
(torch.profiler, all of the call's device operations summed) and CUDA
events over ``--reps`` back-to-back calls (host included). One JSON
object a line goes to stdout (and ``--out``): the card, one per timing,
and a summary of each variant's total device ms over the cases, per
round.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from pinot_tpu_torch.ops import compact as C
from pinot_tpu_torch.ops import cuda_build

# (keep rate, slots_cap): like q3.4, q2.3, q4.2, q2.1, q4.1 and q3.1
CASES = ((1e-6, 8), (1e-4, 512), (0.0046, 8192), (0.008, 32768),
         (0.016, 32768), (0.034, 131072))

_PASS = "  if (nb > 0) {\n    compact_pass<<<"
_MEMSETS = ("  err = cudaMemsetAsync(valid, 0, (size_t)cap, s);\n"
            "  for (int c = 0; c < ncols && err == cudaSuccess; ++c)\n"
            "    err = cudaMemsetAsync(cols.out[c], 0,\n"
            "                          (size_t)(cap * esizes[c]), s);\n"
            "  if (err != cudaSuccess) return (int)err;\n")
_FILL = "  compact_fill<<<"

VARIANTS = {
    "committed": (),
    "acq_rel": (("ld.relaxed.gpu.global.u64", "ld.acquire.gpu.global.u64"),
                ("st.relaxed.gpu.global.u64", "st.release.gpu.global.u64")),
    "subtiles2": (("#define SUBTILES 4", "#define SUBTILES 2"),),
    "subtiles1": (("#define SUBTILES 4", "#define SUBTILES 1"),),
    "zero_first": ((_PASS, _MEMSETS + _PASS),
                   (_FILL, "  if (0) compact_fill<<<")),
}


def variant_source(subs) -> str:
    with open(os.path.join(cuda_build.CSRC, "compact.cu")) as fh:
        src = fh.read()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found exactly once: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(names):
    """Build every variant, one nvcc each, all started together; returns
    {name: (pinot_compact, tile rows, header words)}."""
    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        cu = os.path.join(out_dir, f"compact_{name}.cu")
        with open(cu, "w") as fh:
            fh.write(variant_source(VARIANTS[name]))
        so = os.path.join(out_dir, f"libcompact_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    kernels = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        kernels[name] = C.bind(ctypes.CDLL(so))
    return kernels


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bool:
        return t
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def _equal(a, b) -> bool:
    return (torch.equal(a[0], b[0])
            and all(torch.equal(_bits(x), _bits(y))
                    for x, y in zip(a[1], b[1]))
            and all(int(x) == int(y) for x, y in zip(a[2:], b[2:])))


def device_ms(fn, reps: int) -> float:
    """Device time per call of fn(), summed over every device operation,
    from torch.profiler over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            us += float(t or 0.0)
    return us / reps / 1e3


def events_ms(fn, reps: int) -> float:
    """Mean time per call over ``reps`` back-to-back calls, by CUDA
    events (host included)."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 26)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1992)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compact_variants: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "w") if args.out else None

    def emit(**rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit(card=smi, rows=args.rows, rounds=args.rounds, reps=args.reps)
    names = list(VARIANTS)
    kernels = build_variants(names)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    n = args.rows
    u = torch.rand(n, device=dev, generator=g)
    cols = tuple(torch.randint(-2**31, 2**31 - 1, (n,), device=dev,
                               dtype=torch.int32, generator=g)
                 for _ in range(2))
    cases = [(u < sel, sel, cap) for sel, cap in CASES]
    saved = C._KERNEL
    try:
        for name in names:
            C._KERNEL = kernels[name]
            for mask, sel, cap in cases:
                if not _equal(C.compact(mask, cols, cap),
                              C.compact_reference(mask, cols, cap)):
                    raise AssertionError(f"variant {name} differs from the "
                                         f"plain version at keep rate {sel}")
            emit(variant=name, tile_rows=kernels[name][1], equal=True)
        totals = {name: [] for name in names}
        for r in range(args.rounds):
            order = names[r % len(names):] + names[:r % len(names)]
            for name in order:
                C._KERNEL = kernels[name]
                tot = 0.0
                for mask, sel, cap in cases:
                    fn = (lambda m=mask, c=cap: C.compact(m, cols, c))
                    dms = device_ms(fn, args.reps)
                    tot += dms
                    emit(round=r, variant=name, keep=sel, slots_cap=cap,
                         matched=int(mask.sum()), device_ms=dms,
                         events_ms=events_ms(fn, args.reps))
                totals[name].append(tot)
    finally:
        C._KERNEL = saved
    emit(summary="total device ms over the cases, per round",
         card=smi, totals=totals)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
