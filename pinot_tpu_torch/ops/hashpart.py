"""Hash-bucket partition of the mesh exchanges: the CUDA kernel, its plain
version.

``hash_partition(codes, payloads, n_dev, cap)`` computes the per-device
step that ``_shuffle_exchange_jit`` (``pinot_tpu/ops/join.py:92-115``)
and ``_fused_program._exchange`` (``pinot_tpu/multistage/fused.py:
333-347``) trace for XLA: each row's int32 key code is hashed by
``splitmix32`` to a partition in ``[0, n_dev)`` (a code below 0 routes to
the pseudo-partition ``n_dev`` and is never written), each row takes its
stable rank within its partition (input order, as ``jnp.argsort`` ranks
it), and the code and every payload of a row ranked below ``cap`` land in
slot ``[partition, rank]`` of ``(n_dev, cap)`` buckets. Returns
``(buckets, overflow)``: ``buckets`` a tuple of the codes' bucket then one
a payload (each of its column's dtype), unwritten slots ``-1``;
``overflow`` a 1-element bool tensor, set when a live partition holds
more than ``cap`` rows. Codes are int32, payloads int32 or int64 (the
shuffle join's row ids are int64), ``n_dev`` 1 to 64, ``cap`` a power of
two, at most 16 payloads.

On a CUDA tensor ``hash_partition`` launches the kernel
(``csrc/hashpart.cu``: a per-block histogram, a scan of the block offsets
per partition, a stable warp-ballot scatter; design and bound in its
header) or raises. On a CPU tensor it runs ``hash_partition_reference``,
the plain PyTorch version: a stable sort of the partitions, run starts by
``searchsorted``, and a masked ``index_put``. The kernel is held against
it bitwise on the card. No single PyTorch call computes it; the sort half
alone is ``torch.sort(stable=True)`` of the partition ids.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import torch

from . import cuda_build
from .stream_scratch import device_scope

MAX_DEV = 64
MAX_PAYLOADS = 16
_M32 = 0xFFFFFFFF

# calls that launched the CUDA kernels (chip_smoke.py resets and reads it)
launches = 0
_LAUNCH_LOCK = threading.Lock()


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 ``x`` in [0, 2^32): the multiply split
    in 16-bit halves of ``m`` so no int64 product overflows (torch's
    uint32 has no multiply on every backend)."""
    hi, lo = m >> 16, m & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def splitmix32(codes: torch.Tensor) -> torch.Tensor:
    """``pinot_tpu/ops/join.py:74`` ``_splitmix32`` of each code's low 32
    bits, as int64 values in [0, 2^32)."""
    x = codes.to(torch.int64) & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def partition_of(codes: torch.Tensor, n_dev: int) -> torch.Tensor:
    """Each row's partition (int64): ``splitmix32(code) % n_dev``, and
    ``n_dev`` for a code below 0."""
    part = splitmix32(codes) % n_dev
    return torch.where(codes >= 0, part, torch.full_like(part, n_dev))


def hash_partition(codes: torch.Tensor, payloads: Sequence[torch.Tensor],
                   n_dev: int, cap: int
                   ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """The buckets and the overflow flag (module doc)."""
    payloads = tuple(payloads)
    _check(codes, payloads, n_dev, cap)
    if codes.device.type == "cpu":
        return hash_partition_reference(codes, payloads, n_dev, cap)
    return _hash_partition_cuda(codes, payloads, n_dev, cap)


def _check(codes: torch.Tensor, payloads: Tuple[torch.Tensor, ...],
           n_dev: int, cap: int) -> None:
    if codes.dtype != torch.int32 or codes.dim() != 1 \
            or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous 1-D int32 tensor")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no hash partition on {codes.device}")
    if len(payloads) > MAX_PAYLOADS:
        raise ValueError(f"at most {MAX_PAYLOADS} payloads, got "
                         f"{len(payloads)}")
    for p in payloads:
        if p.dtype not in (torch.int32, torch.int64) \
                or p.shape != codes.shape or not p.is_contiguous():
            raise ValueError("each payload must be a contiguous int32 or "
                             "int64 tensor shaped like codes")
        if p.device != codes.device:
            raise ValueError(f"a payload on {p.device}, codes on "
                             f"{codes.device}")
    if not isinstance(n_dev, int) or not 1 <= n_dev <= MAX_DEV:
        raise ValueError(f"n_dev must be an int in [1, {MAX_DEV}], got "
                         f"{n_dev!r}")
    if not isinstance(cap, int) or cap < 1 or cap & (cap - 1):
        raise ValueError(f"cap must be a power of two, got {cap!r}")


def hash_partition_reference(codes: torch.Tensor,
                             payloads: Sequence[torch.Tensor], n_dev: int,
                             cap: int
                             ) -> Tuple[Tuple[torch.Tensor, ...],
                                        torch.Tensor]:
    """Plain PyTorch version on any device: the reference's formulation
    (stable sort of the partitions, rank = position - run start, a masked
    write into the buckets)."""
    dev = codes.device
    m = codes.shape[0]
    sp, order = torch.sort(partition_of(codes, n_dev), stable=True)
    within = torch.arange(m, device=dev) - torch.searchsorted(sp, sp)
    live = sp < n_dev
    ok = (within < cap) & live
    overflow = ((within >= cap) & live).any().reshape(1)
    rows, slots, taken = sp[ok], within[ok], order[ok]
    buckets = []
    for col in (codes, *payloads):
        b = torch.full((n_dev, cap), -1, dtype=col.dtype, device=dev)
        b.index_put_((rows, slots), col[taken])
        buckets.append(b)
    return tuple(buckets), overflow


def partition_bytes(n: int, widths: Sequence[int], n_dev: int,
                    cap: int) -> int:
    """The least bytes a call must move: each code (4 B) and payload
    (``widths``) read once, each bucket slot of the codes and payloads
    and the flag written once."""
    row = 4 + sum(widths)
    return n * row + n_dev * cap * row + 1


def _hash_partition_cuda(codes: torch.Tensor,
                         payloads: Tuple[torch.Tensor, ...], n_dev: int,
                         cap: int
                         ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Launch the memsets and the three kernels on the current stream."""
    global launches
    k = _bound_kernel()
    n = codes.shape[0]
    dev = codes.device
    cols = (codes, *payloads)
    outs = tuple(torch.empty((n_dev, cap), dtype=c.dtype, device=dev)
                 for c in cols)
    overflow = torch.empty(1, dtype=torch.bool, device=dev)
    counts = torch.empty(max(n_dev * (-(-n // k["tile"])), 1),
                         dtype=torch.int32, device=dev)
    n_cols = len(cols)
    srcs = (ctypes.c_void_p * n_cols)(*[c.data_ptr() for c in cols])
    dsts = (ctypes.c_void_p * n_cols)(*[o.data_ptr() for o in outs])
    widths = (ctypes.c_int * n_cols)(*[c.element_size() for c in cols])
    with device_scope(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = k["run"](codes.data_ptr(), n, n_dev, cap, n_cols, srcs, dsts,
                      widths, overflow.data_ptr(), counts.data_ptr(),
                      stream)
    if rc != 0:
        raise RuntimeError(f"hash partition kernel launch failed: CUDA "
                           f"error {rc}")
    with _LAUNCH_LOCK:
        launches += 1
    return outs, overflow


_KERNEL = None  # {"run", "tile"}


def _bound_kernel():
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.library("hashpart")  # builds under its lock
        with cuda_build._LOCK:                # bind once, for every thread
            if _KERNEL is None:
                _KERNEL = bind(lib)
    return _KERNEL


def bind(lib: ctypes.CDLL) -> dict:
    """The entry points of a loaded build of hashpart.cu."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.pinot_hashpart.argtypes = [vp, i64, i32, i64, i32, vp, vp, vp, vp,
                                   vp, vp]
    lib.pinot_hashpart.restype = i32
    lib.pinot_hashpart_tile.argtypes = []
    lib.pinot_hashpart_tile.restype = i32
    return {"run": lib.pinot_hashpart, "tile": lib.pinot_hashpart_tile()}


def tile_rows() -> int:
    """Rows a block of the kernel takes (builds the library)."""
    return _bound_kernel()["tile"]
