"""Device-backed equi-join for the multi-stage engine, on one device.

Port of ``pinot_tpu/multistage/device_join.py``: dict-encodable
equi-joins whose build side fits the broadcast bound route through
``ops.join.device_equi_join`` (K16) on the broker's device, with numpy
``hash_join`` as the fallback for shapes the dense formulation does not
fit. Key factorization stays on the host (it is a dictionary build); the
O(L log R) probe runs on the device. The mesh backends (broadcast over a
mesh, the hash shuffle) are not ported: ``try_mesh_shuffle_join`` returns
None, as the reference does on one device.

Output is BYTE-IDENTICAL to numpy ``hash_join``, including row order
(left-major, build rows within a run in stable sorted-key order): the
device join resolves pairs through the same stable sort of the same
factorized codes, so the executor switches backends per join with no
downstream difference. The per-join tensors are scratch of the call:
only host arrays leave it.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.join import device_equi_join
from ..utils.stats import make_bump
from .join import _composite_codes, _key_nulls, materialize_join
from .relation import Relation

# probe sides below this skip the device (a device round trip costs more
# than numpy on small relations); tests set it to 0
MIN_PROBE_ROWS = 200_000
# dense (L, max_dup) candidate matrices stop paying past this bound
MAX_DUP_BOUND = 64

# thread-safe (utils/stats): the broker serves concurrent queries and
# tests assert exact counts
STATS = {"device_joins": 0, "mesh_joins": 0, "numpy_joins": 0}
bump = make_bump(STATS)


def _min_probe_rows() -> int:
    return int(os.environ.get("PINOT_DEVICE_JOIN_MIN_ROWS",
                              MIN_PROBE_ROWS))


def _max_dup_bound() -> int:
    return int(os.environ.get("PINOT_DEVICE_JOIN_MAX_DUP", MAX_DUP_BOUND))


def predict_backend(probe_rows: float, build_rows: float, how: str,
                    broadcast_threshold: int) -> str:
    """The backend the cost model expects for estimated cardinalities
    (the runtime choice re-checks actuals). Mirrors the runtime
    build-side swap for INNER joins (executor._join puts the smaller
    side on the build)."""
    if how == "inner" and probe_rows < build_rows:
        probe_rows, build_rows = build_rows, probe_rows
    if how not in ("inner", "left") or build_rows > broadcast_threshold:
        return "numpy_shuffle" if how == "inner" else "numpy"
    if probe_rows < _min_probe_rows():
        return "numpy"
    return "device_broadcast"


def _poisoned_codes(left: Relation, right: Relation,
                    lkeys: List[str], rkeys: List[str]):
    """Factorized join codes with NULL keys poisoned to -1 on both
    sides (a null key never matches)."""
    code_l, code_r = _composite_codes(
        [left.raw_values(k) for k in lkeys],
        [right.raw_values(k) for k in rkeys])
    lnull = _key_nulls(left, lkeys)
    if lnull is not None:
        code_l = np.where(lnull, np.int64(-1), code_l)
    rnull = _key_nulls(right, rkeys)
    if rnull is not None:
        code_r = np.where(rnull, np.int64(-1), code_r)
    return code_l, code_r


def _bounded_max_dup(valid_build_codes: np.ndarray) -> Optional[int]:
    """Build-side key multiplicity rounded to a power of two, or None
    past the dense-candidate bound."""
    max_dup = int(np.unique(valid_build_codes,
                            return_counts=True)[1].max())
    if max_dup > _max_dup_bound():
        return None
    return 1 << (max_dup - 1).bit_length() if max_dup > 1 else 1


def try_mesh_shuffle_join(left: Relation, right: Relation,
                          lkeys: List[str], rkeys: List[str]
                          ) -> Optional[Relation]:
    """The device hash-shuffle join over a mesh of devices. The port runs
    on one device, where the reference returns None too: the caller
    falls back to the mailbox HashExchange."""
    return None


def try_device_join(left: Relation, right: Relation,
                    lkeys: List[str], rkeys: List[str], how: str,
                    broadcast_threshold: int, device: torch.device
                    ) -> Tuple[Optional[Relation], str]:
    """-> (joined relation, backend) or (None, fallback reason).

    Eligibility: INNER/LEFT equi-join, build side within the broadcast
    bound, probe side worth a device dispatch, build-side key
    multiplicity within the dense candidate bound.
    """
    if how not in ("inner", "left"):
        return None, "join_type"
    if left.n_rows == 0 or right.n_rows == 0:
        return None, "empty_side"
    if right.n_rows > broadcast_threshold:
        return None, "build_too_big"
    if left.n_rows < _min_probe_rows():
        return None, "probe_too_small"

    code_l, code_r = _poisoned_codes(left, right, lkeys, rkeys)
    # drop the build side's null rows instead of carrying poisoned entries
    keep_r = code_r >= 0
    if not keep_r.all():
        valid_r = np.nonzero(keep_r)[0]
        code_r = code_r[valid_r]
    else:
        valid_r = None
    if len(code_r) == 0:
        return None, "empty_build"
    max_dup = _bounded_max_dup(code_r)
    if max_dup is None:
        return None, "max_dup"

    if code_l.max(initial=0) < 2**31 and code_r.max(initial=0) < 2**31 \
            and code_l.min(initial=0) >= -(2**31):
        code_l = code_l.astype(np.int32)
        code_r = code_r.astype(np.int32)

    match, r_dense = device_equi_join(
        torch.from_numpy(code_l).to(device),
        torch.from_numpy(code_r).to(device), max_dup)
    match = match.cpu().numpy()
    r_dense = r_dense.cpu().numpy()
    backend = "device"
    bump("device_joins")

    counts = match.sum(axis=1)
    li, j = np.nonzero(match)             # left-major, sorted-run order
    if how == "inner":
        l_idx = li
        r_idx = r_dense[li, j].astype(np.int64)
        matched = np.ones(len(l_idx), dtype=bool)
    else:
        out_counts = np.maximum(counts, 1)
        total = int(out_counts.sum())
        l_idx = np.repeat(np.arange(left.n_rows), out_counts)
        matched = np.repeat(counts > 0, out_counts)
        r_idx = np.zeros(total, dtype=np.int64)
        r_idx[matched] = r_dense[li, j]   # both orders are left-major
    if valid_r is not None:
        r_idx = np.where(matched, valid_r[r_idx], 0)
    return materialize_join(left, right, l_idx, r_idx, matched,
                            how), backend
