"""Collectives over the shards of a mesh, from one process.

The counterparts of ``lax.psum`` / ``pmin`` / ``pmax`` (``all_reduce``)
and ``lax.all_to_all(x, axis, 0, 0, tiled=True)`` (``all_to_all``) that
the JAX package runs inside ``shard_map``. Each takes one tensor per shard
(shard ``d``'s on the mesh's device ``d``) and returns one per shard,
written over ``.to(shard_device)`` and ``torch.cat``: shards that share a
device pay no copy, shards on distinct devices pay a device-to-device
copy, and the same code serves both. The order of every combine is the
shard order, so a result does not depend on which devices the shards lie
on. (Across processes, one per card, NCCL would take this module's place.)
"""
from __future__ import annotations

from typing import List, Sequence

import torch

OPS = ("sum", "min", "max", "or")


def reduce_local(op: str, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts``, all on one device, reduced elementwise in their order
    (one shard's combine over its segments' outputs, the reference's
    ``v.sum(axis=0)`` / ``min`` / ``max`` over the vmapped segment axis);
    the dtype stays the inputs' (int32 sums wrap as ``psum``'s do), bool
    sums are a logical or."""
    if not parts:
        raise ValueError("nothing to reduce")
    acc = parts[0]
    for p in parts[1:]:
        if op == "sum":
            acc = acc | p if acc.dtype == torch.bool else acc + p
        elif op == "min":
            acc = torch.minimum(acc, p)
        elif op == "max":
            acc = torch.maximum(acc, p)
        elif op == "or":
            acc = acc | p if acc.dtype == torch.bool else \
                torch.logical_or(acc, p)
        else:
            raise ValueError(f"unknown reduce op {op!r}; have {OPS}")
    if op == "or" and acc.dtype != torch.bool:
        acc = acc != 0
    return acc


def all_reduce(op: str, shards: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """Every shard's tensor combined with ``op`` ("sum", "min", "max",
    "or"); each shard receives the result on its own device."""
    if not shards:
        raise ValueError("no shards")
    home = shards[0].device
    red = reduce_local(op, [t.to(home) for t in shards])
    return [red if t.device == home else red.to(t.device) for t in shards]


def all_to_all(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Tiled all-to-all over axis 0: each shard's tensor splits along
    axis 0 into ``len(shards)`` equal chunks, chunk ``d`` goes to shard
    ``d``, and shard ``d`` receives ``[src 0's chunk d; src 1's chunk d;
    ...]`` concatenated along axis 0, the layout of
    ``lax.all_to_all(x, axis, 0, 0, tiled=True)``."""
    n = len(shards)
    if n == 0:
        raise ValueError("no shards")
    rows = shards[0].shape[0]
    if rows % n or any(t.shape != shards[0].shape for t in shards):
        raise ValueError(f"all_to_all takes {n} same-shape tensors whose "
                         f"axis 0 splits in {n}")
    chunks = [t.tensor_split(n, dim=0) for t in shards]
    return [torch.cat([chunks[s][d].to(shards[d].device) for s in range(n)])
            for d in range(n)]
