"""Time design variants of the vector search kernels (K15) against each other.

    python3 -m pinot_tpu_torch.tools.vec_variants [--rows N] [--rounds R]
        [--reps K] [--variants a,b,...] [--extra NAME=FILE.cu]
        [--out FILE.jsonl]

Needs the card and nvcc. Each variant is ``ops/csrc/vecsearch.cu`` with
anchored text substitutions; a substitution whose anchor is not found
exactly once fails the run. ``--extra`` adds a whole other source with the
same C interface (an earlier commit's ``vecsearch.cu``, say). Every source
is built with the library's nvcc flags under
``build/torch_kernels/variants/``, and its ptxas lines are printed:

- ``committed``: the source as it is;
- ``local_thr``: the fused top-k filters by each block's own threshold
  only, not by the queries' thresholds shared across blocks;
- ``small2``: the flat scan's small top-k at 2 blocks an SM instead of 3;
- ``lanes_q1``, ``lanes_q2``: the warp's lanes in 1 or 2 query groups (32
  or 16 row groups) instead of 4, the same 16 dot products a thread;
- ``diag_nocompute``, ``diag_noload``, ``diag_noepi``: the scan without
  its FMAs, without the copies after a block's first tile, or without its
  epilogue (and so without the FMAs only it reads); ``diag_ivf_noscan``:
  the IVF probe without its centroid scores (for where the time goes: flat
  or IVF cases only, their results not checked).

The data is one segment's worth of the chip check's 128-d l2 column:
``--rows`` rows (default 2^19) from ``tools/vec.gen_clustered`` (seed
11), the IVF layer at ``default_n_lists(rows)`` lists (seed 7), uploaded
through ``VectorIndexReader``. The cases are the flat scan and the IVF
probe at the default nprobe, 16 queries and 1, k_pad 16 and 128 (k 10
and 100). Each variant must give the committed build's bits (they change
the schedule, not the arithmetic); an extra source is compared with them
(max score difference, share of equal ids) and not held to them. Then,
in ``--rounds`` rounds with the order rotated each round, every case is
timed: CUDA events over ``--reps`` back-to-back calls (host included),
the host's time to issue a call, device ms per call by kernel
(torch.profiler), and for one query the
probe after a 128 MiB write (the L2 cold, events around each call). One
JSON object a line goes to stdout (and ``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from pinot_tpu_torch.ops import cuda_build
from pinot_tpu_torch.ops import vecsearch as V

VARIANTS = {
    "committed": (),
    "local_thr": (("    lim[j] = g > t ? g : t;", "    lim[j] = t;"),),
    "small2": (("#define SMALL_BLOCKS_PER_SM 3 ",
                "#define SMALL_BLOCKS_PER_SM 2 "),),
    "lanes_q1": (("  static constexpr int QG = NQ >= 4 ? 4 : NQ;",
                  "  static constexpr int QG = 1;"),),
    "lanes_q2": (("  static constexpr int QG = NQ >= 4 ? 4 : NQ;",
                  "  static constexpr int QG = NQ >= 2 ? 2 : 1;"),),
    # diagnostics: a scan without one of its parts (wrong results: not
    # held to the committed bits)
    "diag_nocompute": (("    score_stage<NQ>(st, acc);\n", ""),),
    "diag_noload": (("      vu.fill(sm.stages + f.slot",
                     "      if (f.lt == 0) vu.fill(sm.stages + f.slot"),),
    "diag_noepi": (("      epi((t0 + c.lt * step)",
                    "      if (nt < 0) epi((t0 + c.lt * step)"),),
    "diag_ivf_noscan": (("  scan<1, VEC>(R, q, 1, mode, nullptr, 0,",
                         "  if (nprobe < 0) scan<1, VEC>(R, q, 1, mode, "
                         "nullptr, 0,"),),
}
FLUSH_BYTES = 128 << 20       # written between cold calls: over the 50 MB L2


def variant_source(subs) -> str:
    with open(os.path.join(cuda_build.CSRC, "vecsearch.cu")) as fh:
        src = fh.read()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found exactly once: {old!r}")
        src = src.replace(old, new)
    return src


def build_sources(sources: dict) -> dict:
    """Build {name: source text}, one nvcc each, all started together;
    returns {name: (bound functions, ptxas lines)}."""
    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = os.path.join(out_dir, f"vecsearch_{name}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        so = os.path.join(out_dir, f"libvecsearch_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (V.bind(ctypes.CDLL(so)), ptxas_lines(log))
    return built


def ptxas_lines(log: str) -> list:
    """The compiler's per-kernel lines: entry, registers, spills."""
    keep = ("Compiling entry", "registers", "spill")
    return [ln.strip() for ln in log.splitlines()
            if any(k in ln for k in keep)]


def _runs(name: str, label: str) -> bool:
    """Whether variant name runs case label (a diagnostic only its own
    kind: diag_ivf_ the IVF cases, other diag_ the flat ones)."""
    if name.startswith("diag_ivf_"):
        return label.startswith("ivf")
    return not name.startswith("diag_") or label.startswith("flat")


def _bits(out):
    return out[0].view(torch.int32), out[1]


def events_ms(fn, reps: int) -> float:
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


def host_ms(fn, reps: int) -> float:
    """Mean host ms to issue fn() over reps calls with no sync between."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def cold_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean ms of fn() with events around each call, after a write of
    ``flush`` (the L2 holds none of fn's inputs)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.fill_(1)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def split_ms(fn, reps: int) -> dict:
    """Device ms per call of each kernel of fn (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + float(t) / reps / 1e3
    return out


def cases(reader, qs):
    """(label, search function) of every timed case."""
    dev = reader.ensure_device()
    nprobe = reader.nprobe_default
    max_pages = reader.max_pages_for(nprobe)
    n = len(reader.matrix)
    out = []
    for b in (len(qs), 1):
        q = qs[:b].contiguous()
        for k_pad in (16, 128):
            out.append((f"flat_b{b}_k{k_pad}", lambda q=q, k=k_pad:
                        V.flat_search(q, dev["matrix"], dev["row_sq"], "l2",
                                      k)))
            out.append((f"ivf_b{b}_k{k_pad}", lambda q=q, k=k_pad:
                        V.ivf_search(q, dev["paged"], dev["paged_sq"],
                                     dev["centroids"], dev["cent_sq"],
                                     dev["pages"], dev["pageptr"], "l2", k,
                                     nprobe, max_pages, n)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 19)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--extra", action="append", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vec_variants: no CUDA device", file=sys.stderr)
        return 2
    from pinot_tpu_torch.index.vector import (VectorIndexReader,
                                              default_n_lists)
    from pinot_tpu_torch.tools.vec import COLUMNS, gen_clustered

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
    names = args.variants.split(",")
    sources = {name: variant_source(VARIANTS[name]) for name in names}
    extras = []
    for spec in args.extra:
        name, path = spec.split("=", 1)
        with open(path) as fh:
            sources[name] = fh.read()
        extras.append(name)
    built = build_sources(sources)
    for name, (_k, ptx) in built.items():
        emit(variant=name, ptxas=ptx)

    dim, metric, seed = COLUMNS["emb_l2"]
    mat, queries = gen_clustered(args.rows, dim, 64, seed, n_queries=16)
    reader = VectorIndexReader.from_matrix(mat, metric, device="cuda")
    reader.build_ivf(default_n_lists(args.rows), seed=7)
    qs = torch.from_numpy(np.stack([reader._query_vec(q)
                                    for q in queries])).cuda()
    todo = cases(reader, qs)
    saved = V._KERNEL
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    try:
        V._KERNEL = built["committed"][0] if "committed" in built \
            else built[names[0]][0]
        want = {label: _bits(fn()) for label, fn in todo}
        for name in built:
            V._KERNEL = built[name][0]
            for label, fn in todo:
                if not _runs(name, label):
                    continue
                got = _bits(fn())
                if name in extras:
                    diff = float((got[0].view(torch.float32)
                                  - want[label][0].view(torch.float32))
                                 .abs().max())
                    same = float((got[1] == want[label][1]).float().mean())
                    emit(variant=name, case=label, max_score_diff=diff,
                         equal_id_share=same)
                elif name.startswith("diag_"):
                    continue
                elif not (torch.equal(got[0], want[label][0])
                          and torch.equal(got[1], want[label][1])):
                    raise AssertionError(f"variant {name} differs at "
                                         f"{label}")
        order = list(built)
        for r in range(args.rounds):
            rot = order[r % len(order):] + order[:r % len(order)]
            for name in rot:
                V._KERNEL = built[name][0]
                for label, fn in todo:
                    if not _runs(name, label):
                        continue
                    rec = dict(round=r, variant=name, case=label,
                               ms=events_ms(fn, args.reps),
                               host_ms=host_ms(fn, args.reps),
                               split_ms=split_ms(fn, args.reps))
                    if label.startswith("ivf_b1_"):
                        rec["cold_ms"] = cold_ms(fn, args.reps, flush)
                    emit(**rec)
    finally:
        V._KERNEL = saved
    emit(done=True, card=smi)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
