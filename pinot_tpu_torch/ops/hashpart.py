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
(``csrc/hashpart.cu``: one pass over ticketed tiles with a decoupled
look-back over every partition and a coalesced scatter of each
partition's run, then a fill of the buckets' tails; design and bound in
its header) or raises. Its host path is lean: the buckets of every column
and the flag are views carved from one allocation (``bucket_layout``),
the scratch is the stream's (``stream_scratch.StreamScratch``, no
memset), and the pointers go to the C entry in one argument block filled
in place. On a CPU tensor it runs ``hash_partition_reference``,
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
from .stream_scratch import StreamScratch, device_scope

MAX_DEV = 64
MAX_PAYLOADS = 16
_M32 = 0xFFFFFFFF

# calls that launched the CUDA kernels (chip_smoke.py resets and reads it)
launches = 0
_LAUNCH_LOCK = threading.Lock()
# per (device, stream) ticket counter and status words; its lock is held
# from taking the scratch to the launch, and guards the argument block
_SCRATCH = StreamScratch()
ALIGN = 16          # each column's buckets start on a 16-byte boundary
_PAYLOAD_DTYPES = (torch.int32, torch.int64)


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
    if not codes.is_cuda:
        return hash_partition_reference(codes, payloads, n_dev, cap)
    return _hash_partition_cuda(codes, payloads, n_dev, cap)


def _check(codes: torch.Tensor, payloads: Tuple[torch.Tensor, ...],
           n_dev: int, cap: int) -> None:
    if codes.dtype != torch.int32 or codes.dim() != 1 \
            or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous 1-D int32 tensor")
    dev = codes.device
    if not codes.is_cuda and not codes.is_cpu:
        raise ValueError(f"no hash partition on {dev}")
    if len(payloads) > MAX_PAYLOADS:
        raise ValueError(f"at most {MAX_PAYLOADS} payloads, got "
                         f"{len(payloads)}")
    shape = codes.shape
    for p in payloads:
        if p.dtype not in _PAYLOAD_DTYPES or p.shape != shape \
                or not p.is_contiguous():
            raise ValueError("each payload must be a contiguous int32 or "
                             "int64 tensor shaped like codes")
        if p.device != dev:
            raise ValueError(f"a payload on {p.device}, codes on {dev}")
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


def bucket_layout(widths: Sequence[int], n_dev: int, cap: int
                  ) -> Tuple[Tuple[int, ...], int, int]:
    """(byte offset of each column's buckets, byte offset of the flag,
    bytes in all) in the one allocation of a call. Each column's
    ``(n_dev, cap)`` buckets start on an ``ALIGN``-byte boundary (an
    int64 view's alignment, and the kernel's 16-byte -1 stores) and take
    a whole number of ``ALIGN``-byte chunks; the flag is the byte after
    them, and the total is a whole number of chunks (every dtype views
    it)."""
    offs, at = [], 0
    for w in widths:
        offs.append(at)
        at += -(-n_dev * cap * w // ALIGN) * ALIGN
    return tuple(offs), at, at + ALIGN


def scratch_words(n: int, n_dev: int, tile: int) -> int:
    """64-bit scratch words a call needs: the ticket counter and one
    status word a (tile, partition)."""
    return 1 + -(-n // tile) * n_dev


def _buckets(cols: Tuple[torch.Tensor, ...], n_dev: int, cap: int):
    """One allocation carved into each column's ``(n_dev, cap)`` buckets
    (its dtype) and the 1-element bool flag -> (buckets, flag, the
    buckets' addresses, the flag's address). Nothing is filled: the
    kernel writes every byte of them."""
    widths = [c.element_size() for c in cols]
    offs, flag_at, size = bucket_layout(widths, n_dev, cap)
    buf = torch.empty(size, dtype=torch.uint8, device=cols[0].device)
    typed = {}
    outs = []
    for c, w, off in zip(cols, widths, offs):
        v = typed.get(c.dtype)
        if v is None:
            v = typed[c.dtype] = buf.view(c.dtype)
        outs.append(v.as_strided((n_dev, cap), (cap, 1), off // w))
    flag = buf.as_strided((1,), (1,), flag_at).view(torch.bool)
    base = buf.data_ptr()
    return tuple(outs), flag, [base + o for o in offs], base + flag_at


def _stream(dev: torch.device) -> int:
    """The handle of the current CUDA stream on a tensor's device, read
    as PyTorch's generated code reads it (no Stream object a call)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _marshal(args, cols: Tuple[torch.Tensor, ...], dsts, flag_addr: int,
             n_dev: int, cap: int, scratch: torch.Tensor,
             epoch: int) -> None:
    """Fill the argument block in place (the layout of ``ARG_WORDS`` in
    ``csrc/hashpart.cu``); the caller holds ``_SCRATCH.lock``."""
    head = [cols[0].shape[0], n_dev, cap, len(cols), flag_addr,
            scratch.data_ptr(), scratch.numel(), epoch]
    head += [c.data_ptr() for c in cols]
    head += dsts
    head += [c.element_size() for c in cols]
    args[:len(head)] = head


def _hash_partition_cuda(codes: torch.Tensor,
                         payloads: Tuple[torch.Tensor, ...], n_dev: int,
                         cap: int
                         ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Carve the outputs and launch the pass and the fill on the current
    stream."""
    global launches
    k = _bound_kernel()
    cols = (codes, *payloads)
    outs, overflow, dsts, flag_addr = _buckets(cols, n_dev, cap)
    dev = codes.device
    with device_scope(dev):
        stream = _stream(dev)
        with _SCRATCH.lock:
            scratch, epoch = _SCRATCH.take(
                dev, stream, scratch_words(codes.shape[0], n_dev,
                                           k["tile"]))
            _marshal(k["args"], cols, dsts, flag_addr, n_dev, cap, scratch,
                     epoch)
            rc = k["run"](k["args_ptr"], stream)
            if rc != 0:
                _SCRATCH.drop(dev, stream)    # its counter may be off
    if rc != 0:
        raise RuntimeError(f"hash partition kernel launch failed: CUDA "
                           f"error {rc}")
    with _LAUNCH_LOCK:
        launches += 1
    return outs, overflow


_KERNEL = None  # {"run", "tile", "args", "args_ptr"}


def _bound_kernel():
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.library("hashpart")  # builds under its lock
        with cuda_build._LOCK:                # bind once, for every thread
            if _KERNEL is None:
                _KERNEL = bind(lib)
    return _KERNEL


def bind(lib: ctypes.CDLL) -> dict:
    """The entry points of a loaded build of hashpart.cu, and the
    argument block its calls fill in place."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pinot_hashpart.argtypes = [vp, vp]
    lib.pinot_hashpart.restype = i32
    for name in ("tile", "arg_words"):
        getattr(lib, f"pinot_hashpart_{name}").argtypes = []
        getattr(lib, f"pinot_hashpart_{name}").restype = i32
    args = (ctypes.c_int64 * lib.pinot_hashpart_arg_words())()
    return {"run": lib.pinot_hashpart, "tile": lib.pinot_hashpart_tile(),
            "args": args, "args_ptr": ctypes.addressof(args)}


def tile_rows() -> int:
    """Rows a block of the kernel takes (builds the library)."""
    return _bound_kernel()["tile"]
