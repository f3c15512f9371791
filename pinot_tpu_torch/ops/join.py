"""On-device equi-join over dict-encoded keys (K16), one device.

Port of ``device_equi_join`` from ``pinot_tpu/ops/join.py:42``, as torch
ops on the keys' device. The mesh variants (broadcast over a mesh, the
hash-shuffle exchange and the per-device partition join) are not ported.

A hash table is the wrong shape for a static-shape device program, so the
join is sort + bounded-run probe:

- sort the right side's key column once (a STABLE sort, as
  ``jnp.argsort`` is: it keeps build rows of equal keys in their original
  order, which is the pair order ``materialize_join`` emits and the slot
  order of the fused plane's ``pos``);
- each probe row binary-searches its run start (``torch.searchsorted``);
- the run is materialized as ``max_dup`` candidate slots per probe row
  (``max_dup`` = the right side's maximum key multiplicity, a static
  bound the caller takes from build stats), with a match mask killing
  slots past the run.

Output is a dense (L, max_dup) pair matrix + mask. The bound on the card
is bytes: the probe codes read once, the (L, max_dup) match and index
matrices written once (the build side is tiny beside them).
"""
from __future__ import annotations

import threading
from typing import Tuple

import torch

# calls that ran the join on a CUDA tensor (chip_smoke.py resets and reads
# it); concurrent queries call from many threads, so it moves under a lock
launches = 0
_LAUNCH_LOCK = threading.Lock()


def device_equi_join(lk: torch.Tensor, rk: torch.Tensor, max_dup: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (match (L, max_dup) bool, r_idx (L, max_dup) int32).

    Pair (i, r_idx[i, j]) is a join match iff match[i, j]. ``lk`` and
    ``rk`` are 1-D integer tensors of one dtype on one device. Rows of rk
    with a key multiplicity beyond max_dup are silently truncated —
    callers size max_dup from build-side stats so that cannot happen.
    """
    global launches
    if lk.dim() != 1 or rk.dim() != 1 or lk.dtype != rk.dtype \
            or lk.device != rk.device:
        raise ValueError("device_equi_join takes two 1-D key tensors of "
                         "one dtype on one device")
    n_r = rk.shape[0]
    rs, order = torch.sort(rk, stable=True)
    start = torch.searchsorted(rs, lk.contiguous())              # (L,)
    cand = start[:, None] + torch.arange(max_dup, device=lk.device)[None, :]
    cand_c = cand.clamp(0, max(n_r - 1, 0))
    if n_r:
        match = (rs[cand_c] == lk[:, None]) & (cand < n_r)
        r_idx = order[cand_c].to(torch.int32)
    else:
        match = torch.zeros(cand.shape, dtype=torch.bool, device=lk.device)
        r_idx = torch.zeros(cand.shape, dtype=torch.int32, device=lk.device)
    if lk.device.type == "cuda":
        with _LAUNCH_LOCK:
            launches += 1
    return match, r_idx
