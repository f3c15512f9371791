"""Segmented inclusive scan (K17): the CUDA kernel, its plain version.

Port of the device scan of the window stage, ``_seg_scan_jit`` in
``pinot_tpu/multistage/window.py:154`` (a ``jax.lax.associative_scan``).
``seg_scan(op, vals, flags)`` returns ``out`` with ``out[i]`` = ``op``
(sum, min or max) over ``vals[s..i]``, where ``s`` is the last index at or
before ``i`` whose flag is set (the start of ``i``'s partition; before the
first set flag the scan runs from 0). ``vals`` is int64 or float64. This
is the monoid ``combine((fa, va), (fb, vb)) = (fa | fb, fb ? vb : op(va,
vb))`` of the reference.

On a CUDA tensor ``seg_scan`` launches the kernel (``csrc/segscan.cu``,
design and bound in its header) or raises. On a CPU tensor it runs
``seg_scan_reference``, the plain PyTorch version: a log-step
(Hillis-Steele) scan, exact for int64 and for min/max. The kernel is held
against it on the card: bitwise for int64 and for min/max (both keep the
older value on ties), to rounding for float64 sums, which the two add in
different orders. No single PyTorch call computes a segmented scan.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

OPS = {"sum": 0, "min": 1, "max": 2}
DTYPES = {torch.int64: 0, torch.float64: 1}

# calls that launched the CUDA kernel (chip_smoke.py resets and reads it);
# concurrent queries launch from many threads, so it moves under a lock
launches = 0
_LAUNCH_LOCK = threading.Lock()


def seg_scan(op: str, vals: torch.Tensor, flags: torch.Tensor
             ) -> torch.Tensor:
    """The segmented inclusive scan of ``vals`` (see module doc)."""
    _check(op, vals, flags)
    if vals.device.type == "cpu":
        return seg_scan_reference(op, vals, flags)
    return _seg_scan_cuda(op, vals, flags)


def _check(op: str, vals: torch.Tensor, flags: torch.Tensor) -> None:
    if op not in OPS:
        raise ValueError(f"unsupported scan op {op!r}; have {list(OPS)}")
    if vals.dtype not in DTYPES or vals.dim() != 1 \
            or not vals.is_contiguous():
        raise ValueError("vals must be a contiguous 1-D int64 or float64 "
                         "tensor")
    if flags.dtype != torch.bool or flags.shape != vals.shape \
            or not flags.is_contiguous():
        raise ValueError("flags must be a contiguous bool tensor shaped "
                         "like vals")
    if flags.device != vals.device:
        raise ValueError(f"flags on {flags.device}, vals on {vals.device}")


def _op(op: str, older: torch.Tensor, newer: torch.Tensor) -> torch.Tensor:
    if op == "sum":
        return older + newer
    if op == "min":
        return torch.where(newer < older, newer, older)
    return torch.where(newer > older, newer, older)


def seg_scan_reference(op: str, vals: torch.Tensor, flags: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch segmented scan: ceil(log2 n) steps, each combining
    every element with the one ``d`` before it (Hillis-Steele). Works on
    any device; the wrapper uses it for CPU tensors."""
    v = vals.clone()
    f = flags.clone()
    n = v.shape[0]
    d = 1
    while d < n:
        new_v = torch.where(f[d:], v[d:], _op(op, v[:-d], v[d:]))
        new_f = f[d:] | f[:-d]
        v = torch.cat([v[:d], new_v])
        f = torch.cat([f[:d], new_f])
        d <<= 1
    return v


def scan_bytes(n: int) -> int:
    """The least bytes a call must move: each value (8 B) and flag (1 B)
    read once, each result (8 B) written once."""
    return n * 17


def _seg_scan_cuda(op: str, vals: torch.Tensor, flags: torch.Tensor
                   ) -> torch.Tensor:
    """Launch the kernel: one scratch memset and the pass on the current
    stream."""
    global launches
    fn, tile, header = _bound_kernel()
    n = vals.shape[0]
    dev = vals.device
    out = torch.empty_like(vals)
    words = header + 3 * -(-n // tile)
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = fn(vals.data_ptr(), flags.data_ptr(), out.data_ptr(), n,
                DTYPES[vals.dtype], OPS[op], scratch.data_ptr(), words,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segmented scan kernel launch failed: CUDA "
                           f"error {rc}")
    with _LAUNCH_LOCK:
        launches += 1
    return out


_KERNEL = None  # (pinot_segscan, tile rows, scratch header words)


def _bound_kernel():
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.library("segscan")   # builds under its lock
        with cuda_build._LOCK:                # bind once, for every thread
            if _KERNEL is None:
                _KERNEL = bind(lib)
    return _KERNEL


def bind(lib: ctypes.CDLL):
    """(pinot_segscan, tile rows, scratch header words) of a loaded build
    of segscan.cu."""
    vp = ctypes.c_void_p
    lib.pinot_segscan.argtypes = [vp, vp, vp, ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int, vp, ctypes.c_int64, vp]
    lib.pinot_segscan.restype = ctypes.c_int
    for fn in (lib.pinot_segscan_tile, lib.pinot_segscan_header_words):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    return (lib.pinot_segscan, lib.pinot_segscan_tile(),
            lib.pinot_segscan_header_words())


def tile_rows() -> int:
    """Rows per tile of the CUDA kernel (builds the library)."""
    return _bound_kernel()[1]
