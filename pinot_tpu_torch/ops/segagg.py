"""Partition aggregate of the window stage (K17): the CUDA kernel, its plain
version.

Port of ``_segment_agg_jit`` in ``pinot_tpu/multistage/window.py:451``.
``segment_agg(op, segs, vals, ids)`` returns ``per[ids]``, where ``per``
is the per-segment ``sum``, ``count``, ``avg``, ``min`` or ``max`` of
``vals`` over ``segs`` segments keyed by ``ids`` (int64, in ``[0,
segs)``). ``vals`` is int64 or float64; the result is float64 for ``avg``
and ``vals``' type otherwise. ``count`` counts each segment's rows (the
window stage passes ones, so this is the reference's ``segment_sum`` of
them); ``avg`` divides a sum by a float64 count; int64 sums wrap; ``min``
keeps -0.0 over +0.0 and ``max`` +0.0 over -0.0, as the reference's
``segment_min`` / ``segment_max`` do. NaN never arrives (the window stage
keeps NaN columns on the host).

On a CUDA tensor ``segment_agg`` launches the kernel (``csrc/segagg.cu``,
design and bound in its header) or raises. On a CPU tensor it runs
``segment_agg_reference``, the plain PyTorch version: ``index_add_`` /
``scatter_reduce_`` into the segments, then ``index_select`` back to the
rows. The kernel is held against it on the card: bitwise for int64, for
counts and for min/max, to a relative 1e-12 for float64 sums and
averages, which the two add in different orders. No single PyTorch call
computes it.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .stream_scratch import StreamScratch, device_scope

OPS = {"sum": 0, "count": 1, "avg": 2, "min": 3, "max": 4}
DTYPES = {torch.int64: 0, torch.float64: 1}

# calls that launched the CUDA kernels (chip_smoke.py resets and reads
# it); concurrent queries launch from many threads, so it moves under the
# scratch's lock, taken for each launch
launches = 0
_SCRATCH = StreamScratch()


def segment_agg(op: str, segs: int, vals: torch.Tensor, ids: torch.Tensor
                ) -> torch.Tensor:
    """The partition aggregate of ``vals`` gathered to the rows (see the
    module doc)."""
    _check(op, segs, vals, ids)
    if vals.device.type == "cpu":
        return segment_agg_reference(op, segs, vals, ids)
    return _segment_agg_cuda(op, segs, vals, ids)


def _check(op: str, segs: int, vals: torch.Tensor, ids: torch.Tensor
           ) -> None:
    if op not in OPS:
        raise ValueError(f"unsupported aggregate {op!r}; have {list(OPS)}")
    if not isinstance(segs, int) or not 1 <= segs < 1 << 31:
        raise ValueError(f"segs must be an int in [1, 2^31), got {segs!r}")
    if vals.dtype not in DTYPES or vals.dim() != 1 \
            or not vals.is_contiguous():
        raise ValueError("vals must be a contiguous 1-D int64 or float64 "
                         "tensor")
    if ids.dtype != torch.int64 or ids.shape != vals.shape \
            or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous int64 tensor shaped "
                         "like vals")
    if ids.device != vals.device:
        raise ValueError(f"ids on {ids.device}, vals on {vals.device}")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no segment aggregate on {vals.device}")


def out_dtype(op: str, vals: torch.Tensor) -> torch.dtype:
    return torch.float64 if op == "avg" else vals.dtype


def segment_agg_reference(op: str, segs: int, vals: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version on any device: the window stage's torch ops
    (``index_add_`` / ``scatter_reduce_`` into ``segs`` segments, then
    ``index_select``), with float64 min/max zeros settled as the
    reference settles them."""
    dev = vals.device
    if op in ("sum", "count"):
        src = torch.ones_like(vals) if op == "count" else vals
        per = torch.zeros(segs, dtype=vals.dtype, device=dev
                          ).index_add_(0, ids, src)
    elif op == "avg":
        s = torch.zeros(segs, dtype=vals.dtype, device=dev
                        ).index_add_(0, ids, vals)
        c = torch.zeros(segs, dtype=vals.dtype, device=dev
                        ).index_add_(0, ids, torch.ones_like(vals))
        per = s.to(torch.float64) / c.to(torch.float64)
    else:
        fill = (torch.iinfo(vals.dtype) if vals.dtype == torch.int64
                else torch.finfo(vals.dtype))
        per = torch.full((segs,), fill.max if op == "min" else fill.min,
                         dtype=vals.dtype, device=dev
                         ).scatter_reduce_(0, ids, vals,
                                           "amin" if op == "min" else "amax")
        if vals.is_floating_point():
            # scatter_reduce_ keeps whichever zero comes first; the
            # reference's min keeps -0.0, its max +0.0
            pick = (vals == 0) & (torch.signbit(vals) == (op == "min"))
            hit = torch.zeros(segs, dtype=torch.int64, device=dev
                              ).index_add_(0, ids, pick.long()) > 0
            per = torch.where((per == 0) & hit,
                              torch.tensor(-0.0 if op == "min" else 0.0,
                                           dtype=vals.dtype, device=dev),
                              per)
    return per.index_select(0, ids)


def agg_bytes(op: str, n: int) -> int:
    """The least bytes a call must move: each id (8 B) and value (8 B;
    none for count) read once, each result (8 B) written once."""
    return n * (16 if op == "count" else 24)


def _segment_agg_cuda(op: str, segs: int, vals: torch.Tensor,
                      ids: torch.Tensor) -> torch.Tensor:
    """Launch the kernels on the current stream: the reduce and the gather
    (segs <= cap), or a memset, the atomics and the gather."""
    global launches
    k = _bound_kernel()
    n = vals.shape[0]
    dev = vals.device
    out = torch.empty(n, dtype=out_dtype(op, vals), device=dev)
    if n == 0:
        return out
    per = torch.empty((2 if op == "avg" else 1) * segs, dtype=torch.int64,
                      device=dev)
    with device_scope(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with _SCRATCH.lock:
            # the stream's scratch; the kernel says how many words it needs
            # when that is short (and launches nothing)
            words = 1
            while True:
                scratch, _epoch = _SCRATCH.take(dev, stream, words)
                rc = k["agg"](vals.data_ptr(), ids.data_ptr(),
                              out.data_ptr(), n, segs, DTYPES[vals.dtype],
                              OPS[op], per.data_ptr(), scratch.data_ptr(),
                              scratch.numel(), stream)
                if rc >= 0:
                    break
                words = -rc
            if rc != 0:
                _SCRATCH.drop(dev, stream)
            else:
                launches += 1
    if rc != 0:
        raise RuntimeError(f"segment aggregate kernel launch failed: CUDA "
                           f"error {rc}")
    return out


_KERNEL = None  # {"agg", "cap"}


def _bound_kernel():
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.library("segagg")    # builds under its lock
        with cuda_build._LOCK:                # bind once, for every thread
            if _KERNEL is None:
                _KERNEL = bind(lib)
    return _KERNEL


def bind(lib: ctypes.CDLL) -> dict:
    """The entry points of a loaded build of segagg.cu."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.pinot_segagg.argtypes = [vp, vp, vp, i64, i32, i32, i32, vp, vp,
                                 i64, vp]
    lib.pinot_segagg.restype = i32
    lib.pinot_segagg_cap.argtypes = []
    lib.pinot_segagg_cap.restype = i32
    return {"agg": lib.pinot_segagg, "cap": lib.pinot_segagg_cap()}


def cap() -> int:
    """The most segments the shared-memory route takes (builds the
    library)."""
    return _bound_kernel()["cap"]
