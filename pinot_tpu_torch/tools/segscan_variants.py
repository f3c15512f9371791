"""Time design variants of the segmented scan kernel (K17) against each other.

    python3 -m pinot_tpu_torch.tools.segscan_variants [--rows N]
        [--rounds R] [--reps K] [--variants a,b,...] [--out FILE.jsonl]

Needs the card and nvcc. Each variant is ``ops/csrc/segscan.cu`` with
anchored text substitutions; a substitution whose anchor is not found
exactly once fails the run. Each variant is built with the library's nvcc
flags under ``build/torch_kernels/variants/`` and its ptxas lines are
printed. The variants (``VARIANTS``):

- ``committed``: the source as it is;
- ``items8``, ``items32``: 8 or 32 rows a thread instead of 16 (tiles of
  2,048 or 8,192 rows);
- ``threads512``: 512 threads a block instead of 256 (tiles of 8,192);
- ``max4``: at most 4 blocks an SM instead of 8.

The cases are the chip check's window scan at its shape (``--rows``,
default 4,197,786: int64 running sums over 25 partitions, values like the
star schema's prices), a float64 sum over one partition (the longest
look-backs) and a float64 min with a partition start every ~1,000 rows,
made with numpy from a seed. Every variant must equal
``seg_scan_reference`` on every case (bitwise; float64 sums to a relative
1e-12). Then, in ``--rounds`` rounds with the variants' order rotated each
round, each case is timed: CUDA events over ``--reps`` back-to-back calls
(host included) beside a copy of the values (``copy_``, 16 of the scan's
17 bytes a row: the streaming rate the card reaches at this size), the same with a 128 MiB write before each call (the L2
cold), the host's time to issue a call, and the device time per call of
each device operation (torch.profiler). One JSON object a line goes to
stdout (and ``--out``).

The tool runs against whichever ``pinot_tpu_torch`` is first on the path,
so it can time an older checkout's kernel through that checkout's wrapper
(run it from that checkout's root with ``--variants committed``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from pinot_tpu_torch.ops import cuda_build
from pinot_tpu_torch.ops import segscan as S
from pinot_tpu_torch.tools.vec_variants import (FLUSH_BYTES, cold_ms,
                                                events_ms, host_ms,
                                                ptxas_lines, split_ms)

PATH_ROWS = 4_197_786          # the chip check's window scan (star schema)
VARIANTS = {
    "committed": (),
    "items8": (("#define ITEMS 16", "#define ITEMS 8"),),
    "items32": (("#define ITEMS 16", "#define ITEMS 32"),),
    "threads512": (("#define THREADS 256", "#define THREADS 512"),),
    "max4": (("#define MAX_BLOCKS_PER_SM 8", "#define MAX_BLOCKS_PER_SM 4"),),
}


def variant_source(subs) -> str:
    with open(os.path.join(cuda_build.CSRC, "segscan.cu")) as fh:
        src = fh.read()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found exactly once: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(names) -> dict:
    """Build every variant, one nvcc each, all started together; returns
    {name: (bound kernel, ptxas lines)}."""
    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        cu = os.path.join(out_dir, f"segscan_{name}.cu")
        with open(cu, "w") as fh:
            fh.write(variant_source(VARIANTS[name]))
        so = os.path.join(out_dir, f"libsegscan_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        built[name] = (S.bind(ctypes.CDLL(so)), ptxas_lines(log))
    return built


def case_arrays(n: int, seed: int):
    """(label, op, values, flags) as numpy arrays."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(np.arange(1, n), 24, replace=False))
    path_f = np.zeros(n, dtype=bool)
    path_f[0] = True
    path_f[starts] = True
    path_v = rng.integers(3751, 10_004, n).astype(np.int64)
    one_f = np.zeros(n, dtype=bool)
    one_f[0] = True
    sparse_f = rng.random(n) < 0.001
    sparse_f[0] = True
    return [("path_int64_sum", "sum", path_v, path_f),
            ("one_float64_sum", "sum", rng.random(n) * 1e9, one_f),
            ("sparse_float64_min", "min",
             np.round(rng.normal(0, 1e3, n), 1), sparse_f)]


def _check(name, label, op, got, want) -> None:
    if got.dtype == torch.float64 and op == "sum":
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    elif not torch.equal(got.view(torch.int64), want.view(torch.int64)):
        raise AssertionError(f"variant {name} differs at {label}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=PATH_ROWS)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1717)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("segscan_variants: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None

    def emit(**rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit(card=smi, source=os.path.abspath(cuda_build.CSRC), rows=args.rows,
         rounds=args.rounds, reps=args.reps, bound_ms=S.scan_bytes(args.rows)
         / 3.35e12 * 1e3)
    names = args.variants.split(",")
    built = build_variants(names)
    for name, (_k, ptx) in built.items():
        emit(variant=name, ptxas=ptx)
    todo = [(label, op, torch.from_numpy(v).cuda(),
             torch.from_numpy(f).cuda())
            for label, op, v, f in case_arrays(args.rows, args.seed)]
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    copy = torch.empty(args.rows, dtype=torch.int64, device="cuda")
    saved = S._KERNEL
    try:
        for name in names:
            S._KERNEL = built[name][0]
            for label, op, vals, flags in todo:
                _check(name, label, op, S.seg_scan(op, vals, flags),
                       S.seg_scan_reference(op, vals, flags))
            emit(variant=name, equal=True)
        for r in range(args.rounds):
            for name in names[r % len(names):] + names[:r % len(names)]:
                S._KERNEL = built[name][0]
                for label, op, vals, flags in todo:
                    def fn(op=op, vals=vals, flags=flags):
                        return S.seg_scan(op, vals, flags)
                    emit(round=r, variant=name, case=label,
                         copy_ms=events_ms(lambda v=vals: copy.copy_(v),
                                           args.reps),
                         ms=events_ms(fn, args.reps),
                         cold_ms=cold_ms(fn, args.reps, flush),
                         host_ms=host_ms(fn, args.reps),
                         split_ms=split_ms(fn, args.reps))
    finally:
        S._KERNEL = saved
    emit(done=True, card=smi)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
