"""On-device equi-join over dict-encoded keys (K16), on one device and
over a mesh.

Port of ``pinot_tpu/ops/join.py``: ``device_equi_join`` (``:42``) as
torch ops on the keys' device, and its mesh variants over the logical
shards of ``parallel/mesh.py``: ``mesh_equi_join`` (the broadcast join,
``_mesh_join_jit``: the probe side sharded, the build side replicated,
the join per shard) and ``mesh_shuffle_join`` (``_shuffle_exchange_jit``
and ``_partition_join_jit``: both sides bucket-partitioned by key hash
with the hand-written ``ops/hashpart.py`` kernel, exchanged with one
``all_to_all``, joined per shard, and put back in ``hash_join``'s order).

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
from typing import Optional, Sequence, Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# the mesh variants
# ---------------------------------------------------------------------------

def _shard_rows(arr: np.ndarray, n_dev: int, fill: int) -> np.ndarray:
    """``arr`` padded with ``fill`` to a multiple of the shard count."""
    pad = (-len(arr)) % n_dev
    if pad:
        arr = np.concatenate([arr, np.full(pad, fill, dtype=arr.dtype)])
    return arr


def _shards(arr: np.ndarray, mesh) -> list:
    """Contiguous equal slices of ``arr``, one on each shard's device."""
    m = len(arr) // mesh.size
    return [torch.from_numpy(np.ascontiguousarray(arr[d * m:(d + 1) * m])
                             ).to(dev) for d, dev in enumerate(mesh)]


def mesh_equi_join(mesh, lk: np.ndarray, rk: np.ndarray, max_dup: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Broadcast join over a mesh: probe keys sharded over the shards,
    build keys replicated, ``device_equi_join`` on each shard. Returns
    host (L, max_dup) match / r_idx (the probe side is padded to a shard
    multiple and trimmed back)."""
    n = len(lk)
    lk_p = _shard_rows(np.asarray(lk), mesh.size, -1)
    rk_t = torch.from_numpy(np.ascontiguousarray(rk))
    match, r_idx = [], []
    for lk_d in _shards(lk_p, mesh):
        m_d, r_d = device_equi_join(lk_d, rk_t.to(lk_d.device), max_dup)
        match.append(m_d.cpu().numpy())
        r_idx.append(r_d.cpu().numpy())
    return np.concatenate(match)[:n], np.concatenate(r_idx)[:n]


def mesh_join_bytes(n_probe: int, n_build: int, key_bytes: int,
                    max_dup: int, n_dev: int) -> int:
    """The least bytes ``mesh_equi_join`` must move on its shards: the
    probe keys read once, the build keys read once on each shard (they
    are replicated), the (L, max_dup) match (1 B) and r_idx (4 B)
    matrices written once."""
    return (n_probe + n_dev * n_build) * key_bytes + n_probe * max_dup * 5


def shuffle_join_bytes(n_left: int, n_right: int, n_pairs: int) -> int:
    """The least bytes ``mesh_shuffle_join`` must move on its shards: each
    side's int32 codes and int64 row ids read once, each matched pair's
    two int64 indices written once (the buckets, the exchange and the
    per-shard join are its own traffic, not the function's)."""
    return (n_left + n_right) * 12 + n_pairs * 16


def shuffle_cap(rows: int, n_dev: int, slack: float) -> int:
    """The pow2 bucket capacity for a shard of ``rows`` rows over
    ``n_dev`` partitions (``mesh_shuffle_join``'s rule)."""
    cap = max(int(rows / n_dev * slack) + 16, 16)
    return 1 << (cap - 1).bit_length()


def shuffle_exchange(mesh, codes: Sequence[torch.Tensor],
                     ids: Sequence[torch.Tensor], cap: int
                     ) -> Optional[Tuple[list, list]]:
    """``_shuffle_exchange_jit``: each shard's (code, id) pairs bucketed
    by key hash (``hash_partition``), then one ``all_to_all``; returns each
    shard's received (n_dev*cap,) codes and ids, -1 padded, or None when
    a bucket overflowed on any shard."""
    from ..parallel.collectives import all_to_all
    from .hashpart import hash_partition

    parts = [hash_partition(c, (i,), mesh.size, cap)
             for c, i in zip(codes, ids)]
    if any(bool(ovf.any()) for _b, ovf in parts):
        return None
    rc = all_to_all([b[0] for b, _o in parts])
    ri = all_to_all([b[1] for b, _o in parts])
    return ([t.reshape(-1) for t in rc], [t.reshape(-1) for t in ri])


def partition_join(lc: torch.Tensor, li: torch.Tensor, rc: torch.Tensor,
                   ri: torch.Tensor, max_dup: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_partition_join_jit``'s per-shard body: the shard's received
    partition joined locally -> (match, left ids, right ids), each
    (L, max_dup)."""
    match, r_pos = device_equi_join(lc, rc, max_dup)
    match = match & (lc >= 0)[:, None]            # dead probe entries
    r_glob = ri[r_pos.to(torch.int64)]
    return match, li[:, None].expand(match.shape), r_glob


def mesh_shuffle_join(mesh, lk: np.ndarray, rk: np.ndarray, max_dup: int,
                      slack: float = 2.0
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Distributed hash-shuffle INNER join: both key arrays shard over the
    mesh, ONE all_to_all redistributes (code, row id) pairs so equal codes
    land on the same shard, then every shard joins its partition locally.
    Returns global (l_idx, r_idx) matched pairs in ``hash_join``'s order,
    or None when a hash bucket overflowed its capacity (the caller retries
    with more slack or falls back to the host join). Keys are int32 codes
    (-1 for a null); a key past int32 returns None."""
    n_dev = mesh.size
    out = []
    for keys in (lk, rk):
        keys = np.asarray(keys)
        if len(keys) and (keys.max() > np.iinfo(np.int32).max
                          or keys.min() < np.iinfo(np.int32).min):
            return None
        codes = _shard_rows(keys.astype(np.int32), n_dev, -1)
        ids = _shard_rows(np.arange(len(keys), dtype=np.int64), n_dev, -1)
        cap = shuffle_cap(len(codes) // n_dev, n_dev, slack)
        got = shuffle_exchange(mesh, _shards(codes, mesh),
                               _shards(ids, mesh), cap)
        if got is None:
            return None
        out.append(got)
    (lc, li), (rc, ri) = out
    match, l_glob, r_glob = [], [], []
    for d in range(n_dev):
        m, lg, rg = partition_join(lc[d], li[d], rc[d], ri[d], max_dup)
        match.append(m.cpu().numpy())
        l_glob.append(lg.cpu().numpy())
        r_glob.append(rg.cpu().numpy())
    match = np.concatenate(match)
    pairs = np.nonzero(match)
    l_idx = np.concatenate(l_glob)[pairs]
    r_idx = np.concatenate(r_glob)[pairs]
    keep = (l_idx >= 0) & (r_idx >= 0)
    l_idx, r_idx = l_idx[keep], r_idx[keep]
    # restore hash_join's exact output order (left-major; within a left
    # row matches share one code, and the stable build sort emits them by
    # ascending original right index)
    o = np.lexsort((r_idx, l_idx))
    return l_idx[o], r_idx[o]
