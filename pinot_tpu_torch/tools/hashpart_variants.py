"""Time design variants of the hash-bucket partition kernel against each other.

    python3 -m pinot_tpu_torch.tools.hashpart_variants [--rows N]
        [--rounds R] [--reps K] [--variants a,b,...] [--out FILE.jsonl]

Needs the card and nvcc. ``committed`` is the kernel as the package
builds it (``ops/cuda_build``); every other variant is
``ops/csrc/hashpart.cu`` with anchored text substitutions (an anchor not
found exactly once fails the run), built with the library's nvcc flags
under ``build/torch_kernels/variants/`` and bound through the wrapper's
``bind``. Every build's ptxas lines are printed. The variants
(``VARIANTS``):

- ``committed``: the source as it is (8 rows a thread: tiles of 2,048
  rows);
- ``items4``, ``items16``, ``items32``: 4, 16 or 32 rows a thread (tiles
  of 1,024, 4,096 or 8,192 rows).

The cases (``case_arrays``, numpy from a seed): the mesh phase's widest
input's shape (``--rows`` rows, default 2^20, 4 partitions, cap 2^19,
three int32 payloads), the same rows with zipf-skewed keys, 64 partitions
(cap 2^15), a shuffle join's exchange (one int64 row id), and a small
host-bound call (4,096 rows, cap 2,048, three int32 payloads). Every
variant must equal ``hash_partition_reference`` bitwise on every case.
Then, in ``--rounds`` rounds with the variants' order rotated each round,
each case is timed: CUDA events over ``--reps`` back-to-back calls (host
included), the same with a 128 MiB write before each call (the L2 cold),
the host's time to issue a call, and the device time per call of each
device operation (torch.profiler), beside the bytes bound
(``partition_bytes`` over 3.35 TB/s). One JSON object a line goes to
stdout (and ``--out``).

The tool calls only the public ``hash_partition``,
``hash_partition_reference`` and ``partition_bytes`` for ``committed``,
so it times an older checkout's kernel through that checkout's wrapper:
run this file from that checkout's root with ``PYTHONPATH=.`` and
``--variants committed``.
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
from pinot_tpu_torch.ops import hashpart as H
from pinot_tpu_torch.tools.vec_variants import (FLUSH_BYTES, cold_ms,
                                                events_ms, host_ms,
                                                ptxas_lines, split_ms)

PATH_ROWS = 1 << 20            # the mesh phase's widest input, a shard
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
VARIANTS = {
    "committed": (),
    "items4": (("#define ITEMS 8 ", "#define ITEMS 4 "),),
    "items16": (("#define ITEMS 8 ", "#define ITEMS 16 "),),
    "items32": (("#define ITEMS 8 ", "#define ITEMS 32 "),),
}


def variant_source(subs) -> str:
    with open(os.path.join(cuda_build.CSRC, "hashpart.cu")) as fh:
        src = fh.read()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found exactly once: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(names) -> dict:
    """Build every variant but ``committed``, one nvcc each, all started
    together; returns {name: (bound kernel, ptxas lines)}."""
    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        if name == "committed":
            continue
        cu = os.path.join(out_dir, f"hashpart_{name}.cu")
        with open(cu, "w") as fh:
            fh.write(variant_source(VARIANTS[name]))
        so = os.path.join(out_dir, f"libhashpart_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        built[name] = (H.bind(ctypes.CDLL(so)), ptxas_lines(log))
    return built


def committed_ptxas() -> list:
    """The package build's ptxas lines (built now if it is not)."""
    cuda_build.library("hashpart")
    with open(cuda_build._target("hashpart") + ".log") as fh:
        return ptxas_lines(fh.read())


def case_arrays(seed: int, rows: int = PATH_ROWS):
    """(label, codes, payloads, n_dev, cap) as numpy arrays."""
    rng = np.random.default_rng(seed)

    def i32(k, n):
        return [rng.integers(-2**31, 2**31, n).astype(np.int32)
                for _ in range(k)]

    uniform = rng.integers(-1, rows, rows).astype(np.int32)
    skewed = (rng.zipf(1.3, rows) % rows - 1).astype(np.int32)
    ids = rng.permutation(rows).astype(np.int64) + (1 << 40)
    small = 4096
    return [
        ("widest", uniform, i32(3, rows), 4, rows // 2),
        ("skewed", skewed, i32(3, rows), 4, rows // 2),
        ("dev64", uniform, i32(3, rows), 64, rows // 32),
        ("int64_ids", uniform, [ids], 4, rows // 2),
        ("small", rng.integers(-1, small, small).astype(np.int32),
         i32(3, small), 4, small // 2),
    ]


def _same(name, label, got, want) -> None:
    (gb, go), (wb, wo) = got, want
    if len(gb) != len(wb) or not all(
            x.dtype == y.dtype and torch.equal(x, y)
            for x, y in zip(gb, wb)) or not torch.equal(go, wo):
        raise AssertionError(f"variant {name} differs at {label}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=PATH_ROWS)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1719)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hashpart_variants: no CUDA device", file=sys.stderr)
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
         rounds=args.rounds, reps=args.reps)
    names = args.variants.split(",")
    built = build_variants(names)
    if "committed" in names:
        emit(variant="committed", ptxas=committed_ptxas())
    for name, (_k, ptx) in built.items():
        emit(variant=name, ptxas=ptx)
    todo = []
    for label, codes, pays, n_dev, cap in case_arrays(args.seed, args.rows):
        c = torch.from_numpy(codes).cuda()
        p = tuple(torch.from_numpy(x).cuda() for x in pays)
        bound = H.partition_bytes(len(codes), [x.itemsize for x in pays],
                                  n_dev, cap) / HBM_BYTES_PER_S * 1e3
        todo.append((label, c, p, n_dev, cap, bound,
                     H.hash_partition_reference(c, p, n_dev, cap)))
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    H.hash_partition(*todo[-1][1:5])      # the package's build, bound
    saved = H._KERNEL
    try:
        for name in names:
            H._KERNEL = built[name][0] if name in built else saved
            for label, c, p, n_dev, cap, _b, want in todo:
                _same(name, label, H.hash_partition(c, p, n_dev, cap), want)
            emit(variant=name, equal=True)
        for r in range(args.rounds):
            for name in names[r % len(names):] + names[:r % len(names)]:
                H._KERNEL = built[name][0] if name in built else saved
                for label, c, p, n_dev, cap, bound, _w in todo:
                    def fn(c=c, p=p, n_dev=n_dev, cap=cap):
                        return H.hash_partition(c, p, n_dev, cap)
                    split = split_ms(fn, args.reps)
                    emit(round=r, variant=name, case=label, n=c.shape[0],
                         n_dev=n_dev, cap=cap, bound_ms=bound,
                         ms=events_ms(fn, args.reps),
                         cold_ms=cold_ms(fn, args.reps, flush),
                         host_ms=host_ms(fn, args.reps),
                         device_ms=sum(split.values()), split_ms=split)
    finally:
        H._KERNEL = saved
    emit(done=True, card=smi)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
