"""Masked row compaction: the CUDA kernel, its plain version, the contract.

Port of ``pinot_tpu/ops/compact.py``. ``compact(mask, cols, slots_cap)``
moves the rows of ``cols`` where ``mask`` is True to the front, in their
original order, and returns ``(valid, out_cols, n_valid, matched,
overflow)``:

- ``valid`` and every ``out_cols[i]`` have ``slots_cap * 128`` entries;
  ``valid[:min(matched, cap)]`` is True, and every slot past ``matched``
  is False / zero;
- ``n_valid = n_slots * 128`` with ``n_slots = min(ceil(matched / 128),
  slots_cap)``; ``matched`` is the mask's count; ``overflow`` is 1 when
  ``matched > slots_cap * 128`` (only the first ``cap`` rows are written:
  retry at ``full_slots_cap``, which can never overflow).

This is exactly what the JAX package's exact fallback ``_compact_xla``
returns. Its TPU kernel (``_kernel``) is loose and unordered; here the
CUDA kernel (``csrc/compact.cu``, design and bound in its header) is
exact on the card, so no consumer needs the loose-output machinery.

On a CUDA tensor ``compact`` launches the kernel or raises. On a CPU
tensor it runs ``compact_reference``, the plain PyTorch version, which is
also what the kernel is held against on the card. Columns of 4 and 8
bytes (int32, int64, float32, float64) move natively.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import torch

from . import cuda_build

LANES = 128
# smallest capacity the cost model asks for (multistage/costs.py)
MIN_SLOTS = 8
MAX_COLS = 8
# most rows one call takes (compact.cu rejects more: tile starts are int32)
MAX_ROWS = (1 << 31) - 1 - (1 << 16)

# calls that launched the CUDA kernel (chip_smoke.py resets and reads it);
# concurrent queries launch from many threads, so it moves under a lock
launches = 0
_LAUNCH_LOCK = threading.Lock()


def default_slots_cap(n: int) -> int:
    """Capacity when the planner gives none: 1/16 of the input (compaction
    is exact, so capacity tracks matched rows; denser masks overflow and
    the executor retries at full_slots_cap)."""
    return max(-(-n // (16 * LANES)), MIN_SLOTS)


def full_slots_cap(n: int) -> int:
    """Capacity that can never overflow: one slot per row."""
    return max(-(-n // LANES), 1)


def compact(mask: torch.Tensor, cols: Sequence[torch.Tensor],
            slots_cap: int):
    """Compact the masked rows of ``cols`` to the front (see module doc).
    A bool mask whose bytes hold values other than 0 and 1 (a view of
    other data) keeps every row whose byte is non-zero."""
    _check(mask, cols, slots_cap)
    if mask.device.type == "cpu":
        return compact_reference(mask, cols, slots_cap)
    return _compact_cuda(mask, cols, slots_cap)


def _check(mask: torch.Tensor, cols: Sequence[torch.Tensor],
           slots_cap: int) -> None:
    if mask.dtype != torch.bool or mask.dim() != 1 \
            or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous 1-D bool tensor")
    if mask.shape[0] > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows a call, got "
                         f"{mask.shape[0]}")
    if len(cols) > MAX_COLS:
        raise ValueError(f"at most {MAX_COLS} columns, got {len(cols)}")
    if slots_cap < 1:
        raise ValueError(f"slots_cap must be positive, got {slots_cap}")
    for c in cols:
        if c.shape != mask.shape or not c.is_contiguous():
            raise ValueError("columns must be contiguous and shaped like "
                             "the mask")
        if c.device != mask.device:
            raise ValueError(f"column on {c.device}, mask on {mask.device}")
        if c.element_size() not in (4, 8) or c.dtype.is_complex:
            raise ValueError(f"unsupported column dtype {c.dtype}; "
                             "4- and 8-byte columns move natively")


def _scalars(matched: torch.Tensor, slots_cap: int):
    cap = slots_cap * LANES
    n_slots = torch.clamp((matched + LANES - 1) // LANES, max=slots_cap)
    overflow = (matched > cap).to(torch.int32)
    return n_slots * LANES, overflow


def compact_reference(mask: torch.Tensor, cols: Sequence[torch.Tensor],
                      slots_cap: int):
    """Plain PyTorch compaction: one running count, a binary search for
    the k-th matched row, a gather (``_compact_xla`` of the JAX
    package). Works on any device; the wrapper uses it for CPU tensors."""
    n = mask.shape[0]
    dev = mask.device
    cap = slots_cap * LANES
    size = min(cap, n)
    cs = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    matched = cs[-1] if n else torch.zeros((), dtype=torch.int32,
                                           device=dev)
    ks = torch.arange(1, size + 1, dtype=torch.int32, device=dev)
    idx = torch.searchsorted(cs, ks).clamp_(max=max(n - 1, 0))
    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    valid[:size] = torch.arange(size, device=dev) < matched
    outs = []
    for c in cols:
        o = torch.zeros(cap, dtype=c.dtype, device=dev)
        if size:
            o[:size] = torch.where(valid[:size], c[idx],
                                   torch.zeros((), dtype=c.dtype,
                                               device=dev))
        outs.append(o)
    n_valid, overflow = _scalars(matched, slots_cap)
    return valid, tuple(outs), n_valid, matched, overflow


def scratch_words(n: int, tile: int, header: int) -> int:
    """64-bit scratch words of one kernel call: the header (ticket and
    scalars) and one status word per tile. A mask slice that is not
    16-byte aligned shifts its rows by up to 15, so the tiles are counted
    for n + 15 rows."""
    return header + -(-(n + 15) // tile)


def tile_rows() -> int:
    """Rows per tile of the CUDA kernel (builds the library)."""
    return _bound_kernel()[1]


def _compact_cuda(mask: torch.Tensor, cols: Sequence[torch.Tensor],
                  slots_cap: int):
    """Launch the kernel: one scratch memset, the pass and the tail fill
    on the current stream."""
    global launches
    fn, tile, header = _bound_kernel()
    n = mask.shape[0]
    dev = mask.device
    cap = slots_cap * LANES
    words = scratch_words(n, tile, header)
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    outs = tuple(torch.empty(cap, dtype=c.dtype, device=dev) for c in cols)
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    args = (mask.data_ptr(), n, len(cols),
            (ctypes.c_void_p * MAX_COLS)(*[c.data_ptr() for c in cols]),
            (ctypes.c_void_p * MAX_COLS)(*[o.data_ptr() for o in outs]),
            (ctypes.c_int * MAX_COLS)(*[c.element_size() for c in cols]),
            valid.data_ptr(), slots_cap, scratch.data_ptr(), words,
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"compaction kernel launch failed: CUDA error "
                           f"{rc}")
    with _LAUNCH_LOCK:
        launches += 1
    # scratch words 1..2 hold the int32 scalars the last tile wrote
    n_valid, matched, overflow = scratch.view(torch.int32)[2:5].unbind()
    return valid, outs, n_valid, matched, overflow


_KERNEL = None  # (pinot_compact, tile rows, scratch header words)


def _bound_kernel():
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.library("compact")   # builds under its lock
        with cuda_build._LOCK:                # bind once, for every thread
            if _KERNEL is None:
                _KERNEL = bind(lib)
    return _KERNEL


def bind(lib: ctypes.CDLL):
    """(pinot_compact, tile rows, scratch header words) of a loaded
    build of compact.cu."""
    vp = ctypes.c_void_p
    lib.pinot_compact.argtypes = [
        vp, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(vp), ctypes.POINTER(vp),
        ctypes.POINTER(ctypes.c_int), vp, ctypes.c_int64,
        vp, ctypes.c_int64, vp]
    lib.pinot_compact.restype = ctypes.c_int
    for fn in (lib.pinot_compact_tile, lib.pinot_compact_max_cols,
               lib.pinot_compact_header_words):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    if lib.pinot_compact_max_cols() != MAX_COLS:
        raise RuntimeError("compact.cu MAX_COLS disagrees with the Python "
                           "wrapper")
    return (lib.pinot_compact, lib.pinot_compact_tile(),
            lib.pinot_compact_header_words())


def compact_bytes(n: int, cols: Sequence[torch.Tensor], slots_cap: int,
                  matched: int) -> int:
    """The least bytes a compaction of this data must move: the mask read
    once, the column values of the rows it keeps (min(matched, cap))
    read once, and the valid flags and every output column written once
    over the whole capacity."""
    row = sum(c.element_size() for c in cols)
    cap = slots_cap * LANES
    return n + min(matched, cap) * row + cap * (1 + row)

