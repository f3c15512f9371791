"""Whole-plan compilation: the join pipeline as ONE device program (K19).

Port of ``pinot_tpu/multistage/fused.py``. The mailbox plane
(exchange.py) pays a device->host->device round trip at every stage
boundary; this module runs a co-located plan's whole join chain as one
function over tensors (``_fused_program``, the reference's ``shard_map``
body) on the broker's device, or over the shards of its default mesh
(``parallel/mesh.py``) in lockstep, stage by stage, with every stage
boundary an explicit ``ops.ir.Exchange`` node checked by
``analysis/plan_verify``.

Execution model: the program never moves relation payloads — only int32
key codes and row indices. The pipeline state is, per joined table, a
gather index into that table's leaf relation (-1 = null-extended), plus
one canonical-position accumulator ``pos`` that composes each stage's
left-major dense layout (``pos' = pos * max_dup + slot``, int32, gated by
``pos_bound``). The probe seed is sharded in contiguous slices over the
mesh. Without a hash exchange nothing permutes the state, so the rows
with ``pos >= 0`` come back already in numpy ``hash_join``'s exact pair
order; after a hash exchange the host sorts them by ``pos``. The host
then materializes the joined relation with one gather per column, and
the final/window stages run over it through the same host evaluators as
the mailbox plane, so results are byte-identical by construction.

Join kinds: ``csr`` (the build side pre-sorted by code on the host into a
run table, so the join body is pure gathers) when the joint key domain is
at most ``PINOT_FUSED_MAX_CSR``, else ``sort`` (the K16 sort + bounded-run
probe inside the chain); both replicate the build side on every shard.
``hash`` (an INNER join whose build side passes ``PINOT_FUSED_HASH_MIN``
and the broadcast threshold, on a mesh of more than one shard) instead
repartitions the state and the build side by key hash: each shard buckets
its rows with the hand-written ``ops/hashpart.py`` kernel and one
``all_to_all`` per column exchanges the buckets (``_exchange``, the
reference's ``:327-349``); received build fills are remapped to -2 so a
-1 (null or dead) probe code never matches one. A bucket overflow retries
once at doubled slack (``PINOT_FUSED_SLACK``), then falls back. The
``device.overflow`` fault point (site ``"multistage.fused"``) forces the
fallback, as a bucket overflow would.

Fallback: any ineligibility (non-equi outer joins, key-cardinality or
state-size overflow, a shard count that is not a power of two) returns
None and the executor re-runs the plan through the classic per-join path.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis.plan_verify import check_fused_plan
from ..ops import ir
from ..ops.join import device_equi_join
from ..utils import faults
from ..utils import phases as ph
from ..utils.spans import span
from ..utils.stats import make_bump
from . import device_join
from .join import _default_for, _key_nulls
from .relation import Relation

# thread-safe counters (utils/stats): tests assert exact routing
STATS = {"fused_plans": 0, "fused_fallbacks": 0, "fused_overflow": 0}
bump = make_bump(STATS)

_MAX_STATE_DEFAULT = 1 << 23   # dense state rows across the mesh

# programs run on a CUDA device (chip_smoke.py resets and reads it)
launches = 0
_LAUNCH_LOCK = threading.Lock()


def _max_state_rows() -> int:
    return int(os.environ.get("PINOT_FUSED_MAX_STATE", _MAX_STATE_DEFAULT))


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# planning: SQL joins -> per-stage runtime arrays + the FusedPlan IR
# ---------------------------------------------------------------------------

class _Stage:
    """Host-side stage record: the FusedJoin statics plus the runtime
    arrays the program is parameterized with."""

    __slots__ = ("kind", "how", "max_dup", "owners", "cards",
                 "slot_codes", "build_codes", "build_ids", "cap",
                 "cap_b", "deferred")

    def __init__(self):
        self.deferred: List[Any] = []


def _slot_codes(lv: np.ndarray, rv: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Joint factorization of one key slot (join.py _composite_codes
    semantics: equal values share codes across sides).

    Dense-integer fast path: surrogate-key joins have tight value
    ranges, so ``value - min`` IS a joint code and the sort inside
    np.unique is skipped. Codes only need to preserve equality;
    canonical order rides ``pos``, never the code values themselves.
    """
    if lv.dtype.kind in "iu" and rv.dtype.kind in "iu" and \
            (len(lv) or len(rv)):
        mn = min(int(a.min()) for a in (lv, rv) if len(a))
        mx = max(int(a.max()) for a in (lv, rv) if len(a))
        width = mx - mn + 1
        if width <= max(4 * (len(lv) + len(rv)), 1024):
            return (lv.astype(np.int64) - mn,
                    rv.astype(np.int64) - mn, width)
    if lv.dtype == object or rv.dtype == object or \
            lv.dtype.kind in "US" or rv.dtype.kind in "US":
        lv = np.asarray(lv, dtype=object).astype(str)
        rv = np.asarray(rv, dtype=object).astype(str)
    both = np.concatenate([lv, rv])
    uniq, inv = np.unique(both, return_inverse=True)
    return inv[: len(lv)], inv[len(lv):], len(uniq)


def plan_fused(ex, ordered_joins: Sequence[Any], leafs: List[Relation],
               broadcast_threshold: int, n_dev: int = 1
               ) -> Tuple[Optional[ir.FusedPlan],
                          Optional[List[_Stage]], str]:
    """-> (FusedPlan IR, per-stage runtime arrays, fallback_reason).

    ``ex`` is the MultiStageExecutor (owner_of/_split_on reuse);
    ``leafs`` are the scanned leaf relations in execution order
    ([base] + one per ordered join); ``n_dev`` is the mesh's shard count.
    A None plan means the mailbox plane must serve this query.
    """
    if n_dev & (n_dev - 1):
        return None, None, "non_pow2_devices"
    labels = [ex.tables[0].label] + [j.table.label for j in ordered_joins]
    ordinal = {lbl: i for i, lbl in enumerate(labels)}
    max_dup_bound = device_join._max_dup_bound()

    n_base = leafs[0].n_rows
    base_pad = n_dev * _pow2(max(-(-n_base // n_dev), 1))
    shard = base_pad // n_dev
    pos_bound = base_pad
    stages: List[_Stage] = []
    ir_stages: List[ir.FusedJoin] = []
    joined = {labels[0]}
    for i, j in enumerate(ordered_joins):
        label = j.table.label
        right = leafs[i + 1]
        if j.join_type not in ("inner", "left"):
            return None, None, f"join_type:{j.join_type}"
        equi, rest = ex._split_on(j.on, joined, label)
        joined.add(label)
        if not equi:
            return None, None, "no_equi_keys"
        if rest and j.join_type != "inner":
            # outer joins with non-equi ON conjuncts null-extend on
            # conjunct failure — that body is the executor's special
            # numpy path, not a fused sub-computation
            return None, None, "outer_non_equi"

        st = _Stage()
        st.how = j.join_type
        st.deferred = list(rest)
        owners: List[int] = []
        cards: List[int] = []
        slot_codes: List[np.ndarray] = []
        comb_r: Optional[np.ndarray] = None
        total_card = 1
        for lref, rref in equi:
            owner = ordinal[lref.split(".", 1)[0]]
            lc, rc, card = _slot_codes(leafs[owner].raw_values(lref),
                                       right.raw_values(rref))
            lnull = _key_nulls(leafs[owner], [lref])
            if lnull is not None:
                lc = np.where(lnull, -1, lc)
            rnull = _key_nulls(right, [rref])
            if rnull is not None:
                rc = np.where(rnull, -1, rc)
            total_card *= max(card, 1)
            if total_card > 2**31 - 1:
                return None, None, "key_cardinality"
            owners.append(owner)
            cards.append(card)
            # pow2-pad the gather source; pads are never indexed
            # (idx < n_rows) but carry the null code
            pad = _pow2(max(len(lc), 1))
            lc32 = np.full(pad, -1, dtype=np.int32)
            lc32[: len(lc)] = lc.astype(np.int32)
            slot_codes.append(lc32)
            comb_r = rc.astype(np.int64) if comb_r is None else \
                np.where((comb_r < 0) | (rc < 0), -1,
                         comb_r * card + rc)
        st.owners = tuple(owners)
        st.cards = tuple(cards)
        st.slot_codes = slot_codes

        valid_r = comb_r >= 0
        bids = np.nonzero(valid_r)[0].astype(np.int32)
        bcodes = comb_r[valid_r].astype(np.int32)

        # hash (the all_to_all repartition) only pays when the build side
        # is too big to replicate on every shard; below that, broadcast —
        # and when the joint code domain is dense enough it lowers to a
        # host-built CSR table so the join body is pure gathers with no
        # device-side sort at all
        hash_min = max(broadcast_threshold,
                       int(os.environ.get("PINOT_FUSED_HASH_MIN", 1 << 20)))
        csr_max = int(os.environ.get("PINOT_FUSED_MAX_CSR", 1 << 22))
        if right.n_rows > hash_min and n_dev > 1 \
                and j.join_type == "inner":
            st.kind = "hash"
        elif total_card <= csr_max:
            st.kind = "csr"
        else:
            st.kind = "sort"
        if st.kind == "csr":
            counts = np.bincount(bcodes, minlength=total_card) \
                if len(bcodes) else np.zeros(total_card, dtype=np.int64)
            mc = int(counts.max()) if len(bcodes) else 1
            if mc > max_dup_bound:
                return None, None, "max_dup"
            md = _pow2(max(mc, 1))
        elif len(bcodes):
            md = device_join._bounded_max_dup(bcodes)
            if md is None:
                return None, None, "max_dup"
        else:
            md = 1
        st.max_dup = md

        if st.kind == "hash":
            # both sides pad to a shard multiple and ride the bucket
            # all_to_all; bucket caps are pow2. The slack is tight:
            # splitmix32 mixes distinct codes uniformly, so bucket load
            # concentrates around shard / n_dev and 1.25x (+ pow2
            # rounding) is dozens of sigma of headroom; every doubling of
            # cap doubles the post-exchange state the rest of the chain
            # drags. Genuine skew overflows retry once at 2x, then mailbox.
            slack = float(os.environ.get("PINOT_FUSED_SLACK", 1.25))
            b_pad = n_dev * _pow2(max(-(-len(bcodes) // n_dev), 1))
            bc = np.full(b_pad, -1, dtype=np.int32)
            bc[: len(bcodes)] = bcodes
            bi = np.full(b_pad, -1, dtype=np.int32)
            bi[: len(bids)] = bids
            st.cap = _pow2(max(int(shard / n_dev * slack) + 16, 16))
            st.cap_b = _pow2(max(int((b_pad // n_dev) / n_dev * slack)
                                 + 16, 16))
            shard = n_dev * st.cap
        elif st.kind == "csr":
            # build side pre-sorted by code on the host: runs[c] ..
            # runs[c+1] index the build rows for code c in original
            # (stable) order, so the program probes with gathers only.
            # runs pads past the code domain hold the terminal offset
            # (empty run); sids pads are never reachable (cand < end)
            runs_core = np.zeros(total_card + 1, dtype=np.int64)
            np.cumsum(counts, out=runs_core[1:])
            r_pad = _pow2(total_card + 2)
            bc = np.full(r_pad, len(bcodes), dtype=np.int32)
            bc[: total_card + 1] = runs_core
            b_pad = _pow2(max(len(bids), 1))
            bi = np.full(b_pad, -1, dtype=np.int32)
            if mc <= 1:
                # unique build keys (the surrogate-key norm): each
                # present code's sorted position IS its prefix rank,
                # so a scatter replaces the argsort
                bi[runs_core[bcodes]] = bids
            else:
                bi[: len(bids)] = bids[np.argsort(bcodes,
                                                  kind="stable")]
            st.cap = st.cap_b = 0
        else:
            b_pad = _pow2(max(len(bcodes), 1))
            bc = np.full(b_pad, -2, dtype=np.int32)   # -2: matches no
            bc[: len(bcodes)] = bcodes                # probe code, -1
            bi = np.full(b_pad, -1, dtype=np.int32)   # (null) included
            bi[: len(bids)] = bids
            st.cap = st.cap_b = 0
        st.build_codes = bc
        st.build_ids = bi
        shard *= md
        pos_bound *= md
        if pos_bound > 2**31 - 1:
            return None, None, "pos_bound"
        if shard * n_dev > _max_state_rows():
            return None, None, "state_rows"
        stages.append(st)
        # csr and sort are both broadcast exchanges at the IR level —
        # the CSR table is just the replication-friendly lowering
        ir_stages.append(ir.FusedJoin(
            exchange=ir.Exchange(
                kind="hash" if st.kind == "hash" else "broadcast",
                partitions=n_dev, key_slots=st.owners, key_dtype="int32",
                cap=st.cap),
            how=st.how, max_dup=md, build_rows=b_pad))

    plan = ir.FusedPlan(stages=tuple(ir_stages), n_tables=len(labels),
                        base_rows=base_pad, partitions=n_dev,
                        pos_bound=pos_bound)
    return plan, stages, ""


# ---------------------------------------------------------------------------
# the program: the whole join chain over tensors, per shard in lockstep
# ---------------------------------------------------------------------------

def _probe_codes(pos: torch.Tensor, idxs: List[torch.Tensor],
                 slots: Sequence[torch.Tensor], owners: Tuple[int, ...],
                 cards: Tuple[int, ...]) -> torch.Tensor:
    """The stage's probe key: each slot's code gathered through its
    owner's index column, combined by cartesian dict arithmetic; -1 where
    the row is dead or a slot is null."""
    pc = None
    ok = pos >= 0
    for s, src in enumerate(slots):
        ix = idxs[owners[s]]
        sc = src.index_select(0, ix.clamp(0, src.shape[0] - 1))
        sc = torch.where(ix >= 0, sc, -1)
        ok = ok & (sc >= 0)
        pc = sc if pc is None else pc * cards[s] + sc
    return torch.where(ok, pc, -1)


def _join_body(kind: str, how: str, d: int, pc: torch.Tensor,
               pos: torch.Tensor, idxs: List[torch.Tensor],
               bcodes: torch.Tensor, bids: torch.Tensor
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One shard's join of its probe codes against its build side, and
    the state's left-major expansion by ``d`` slots."""
    slot_j = torch.arange(d, dtype=torch.int32, device=pc.device)[None, :]
    if kind == "csr":
        # bcodes is the CSR run-start table, bids the code-sorted build
        # rows: the join body is pure gathers
        runs, sids = bcodes, bids
        safe = pc.clamp(0, runs.shape[0] - 2)
        start = runs.index_select(0, safe)
        end = runs.index_select(0, safe + 1)
        cand = start[:, None] + slot_j
        match = (cand < end[:, None]) & (pc >= 0)[:, None]
        r_glob = sids.index_select(
            0, cand.clamp(0, sids.shape[0] - 1).reshape(-1)
        ).reshape(cand.shape)
    else:
        match, r_pos = device_equi_join(pc, bcodes, d)
        match = match & (pc >= 0)[:, None]
        r_glob = bids.index_select(0, r_pos.reshape(-1)
                                   ).reshape(r_pos.shape)
    if how == "left":
        nomatch = ~match.any(dim=1)
        keep = match.clone()
        keep[:, 0] |= nomatch & (pos >= 0)
    else:
        keep = match
    new_r = torch.where(match, r_glob, -1)
    pos = torch.where(keep, pos[:, None] * d + slot_j, -1).reshape(-1)
    idxs = [ix[:, None].expand(-1, d).reshape(-1) for ix in idxs]
    idxs.append(new_r.reshape(-1))
    return pos, idxs


def _exchange(mesh, shards: List[List[torch.Tensor]], cap: int
              ) -> Tuple[List[List[torch.Tensor]], List[torch.Tensor]]:
    """Hash-partition each shard's rows by their first column (the key
    codes) with ``hash_partition`` and exchange every column's buckets
    with one ``all_to_all``: shard d receives each column as (n*cap,)
    rows, -1 filled. Returns (received columns per shard, overflow flag
    per shard)."""
    from ..ops.hashpart import hash_partition
    from ..parallel.collectives import all_to_all

    parts = [hash_partition(cols[0], cols[1:], mesh.size, cap)
             for cols in shards]
    recv = [all_to_all([b[k] for b, _o in parts])
            for k in range(len(shards[0]))]
    return ([[recv[k][d].reshape(-1) for k in range(len(recv))]
             for d in range(mesh.size)], [o for _b, o in parts])


def _fused_program(spec: Tuple, seed_pos: torch.Tensor,
                   seed_idx: torch.Tensor, args: Sequence[torch.Tensor],
                   mesh=None) -> Tuple[torch.Tensor, ...]:
    """The reference's per-device body (``fused.py:349-420``), on one
    device or, given a ``mesh``, on each of its shards in lockstep.
    ``spec`` entries: (kind, how, max_dup, n_slots, owners, cards, cap,
    cap_b); ``args``: per stage its slot code columns, build codes (the
    CSR run table for ``csr``) and build row ids, all int32. The seeds
    shard in contiguous slices over the mesh, so do a hash stage's build
    codes and ids; the other args are replicated. Returns (pos, idx of
    each table, overflow) with -1 for dead or null-extended entries, each
    the shards' outputs concatenated on the first shard's device; overflow
    holds one bool a shard (only the hash kind can set it)."""
    global launches
    devs = tuple(mesh) if mesh is not None else (seed_pos.device,)
    n = len(devs)

    def split(t: torch.Tensor) -> List[torch.Tensor]:
        if n == 1:
            return [t.to(devs[0])]
        return [p.to(dev) for p, dev in zip(t.tensor_split(n), devs)]

    def replicate(t: torch.Tensor) -> List[torch.Tensor]:
        on = {}
        return [on.setdefault(dev, t.to(dev)) for dev in devs]

    pos = split(seed_pos)
    idxs = [[ix] for ix in split(seed_idx)]
    overflow = [torch.zeros(1, dtype=torch.bool, device=dev) for dev in devs]
    ai = 0
    for kind, how, max_dup, n_slots, owners, cards, cap, cap_b in spec:
        slots = [replicate(a) for a in args[ai:ai + n_slots]]
        side = split if kind == "hash" else replicate
        bcodes, bids = side(args[ai + n_slots]), side(args[ai + n_slots + 1])
        ai += n_slots + 2
        pcs = [_probe_codes(pos[d], idxs[d], [sl[d] for sl in slots],
                            owners, cards) for d in range(n)]
        if kind == "hash":
            # the collective stage boundary: state and build side
            # repartition by key hash so equal codes co-locate
            got, ovf_p = _exchange(mesh, [[pcs[d], pos[d], *idxs[d]]
                                          for d in range(n)], cap)
            pcs = [g[0] for g in got]
            pos = [g[1] for g in got]
            idxs = [list(g[2:]) for g in got]
            bgot, ovf_b = _exchange(mesh, [[bcodes[d], bids[d]]
                                           for d in range(n)], cap_b)
            # received fills are -1: remap build fills so a -1 (null or
            # dead) probe code never matches one
            bcodes = [torch.where(g[0] >= 0, g[0], -2) for g in bgot]
            bids = [g[1] for g in bgot]
            overflow = [o | a | b for o, a, b in zip(overflow, ovf_p,
                                                     ovf_b)]
        for d in range(n):
            pos[d], idxs[d] = _join_body(kind, how, max_dup, pcs[d],
                                         pos[d], idxs[d], bcodes[d],
                                         bids[d])
    if devs[0].type == "cuda":
        with _LAUNCH_LOCK:
            launches += 1
    if n == 1:
        return (pos[0], *idxs[0], overflow[0])
    home = devs[0]

    def gather(ts: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat([t.to(home) for t in ts])

    return (gather(pos), *[gather([idxs[d][k] for d in range(n)])
                           for k in range(len(idxs[0]))], gather(overflow))


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _run_program(plan: ir.FusedPlan, stages: List[_Stage], n_base: int,
                 device: torch.device, mesh=None
                 ) -> Optional[Tuple[np.ndarray, ...]]:
    """Run the whole-plan program on ``device``, or over ``mesh``'s
    shards when the plan is partitioned; None on bucket overflow. Only
    host arrays leave: the device tensors are scratch of the call."""
    spec = tuple(
        (st.kind, st.how, st.max_dup, len(st.owners), st.owners, st.cards,
         st.cap, st.cap_b) for st in stages)
    seed = np.full(plan.base_rows, -1, dtype=np.int32)
    seed[:n_base] = np.arange(n_base, dtype=np.int32)
    seed_d = torch.from_numpy(seed).to(device)
    args: List[torch.Tensor] = []
    for st in stages:
        args.extend(torch.from_numpy(a).to(device) for a in st.slot_codes)
        args.append(torch.from_numpy(st.build_codes).to(device))
        args.append(torch.from_numpy(st.build_ids).to(device))
    if plan.partitions > 1:
        res = _fused_program(spec, seed_d, seed_d, args, mesh)
    else:
        res = _fused_program(spec, seed_d, seed_d, args)
    out = [t.cpu().numpy() for t in res]
    if bool(out[-1].any()):
        bump("fused_overflow")
        return None
    return tuple(out[:-1])


def execute_fused(ex, ordered_joins: Sequence[Any],
                  needed: Dict[str, set], pushed: Dict[str, List[Any]],
                  broadcast_threshold: int) -> Optional[Relation]:
    """Run the join pipeline as one fused program on the broker's device
    or its default mesh; None routes the executor back to the classic
    per-join path."""
    from ..engine import host_eval
    from ..parallel.mesh import default_mesh
    from .executor import _and

    with span(ph.FUSED_PLAN, joins=len(ordered_joins)) as fsp:
        leafs: List[Relation] = []
        for tref in [ex.tables[0]] + [j.table for j in ordered_joins]:
            with span(ph.LEAF_SCAN, table=tref.label) as sp:
                rel = ex.leaf_scan(tref, needed[tref.label],
                                   _and(pushed[tref.label]))
                if sp is not None:
                    sp.annotate(rows=rel.n_rows)
            leafs.append(rel)
        if leafs[0].n_rows == 0:
            # an empty probe seed joins to the empty relation on every
            # plane; materialize it without a device round-trip
            return _materialize(leafs, [np.empty(0, dtype=np.int64)
                                        for _ in leafs])

        device = ex.broker.device
        mesh = default_mesh(device)
        # stage planning is span-visible per exchange: the host-side
        # factorization is what each stage boundary moves
        with span(ph.COLLECTIVE_EXCHANGE, stages=len(ordered_joins)):
            plan, stages, reason = plan_fused(ex, ordered_joins, leafs,
                                              broadcast_threshold,
                                              mesh.size)
        if plan is None:
            bump("fused_fallbacks")
            if fsp is not None:
                fsp.annotate(fallback=reason)
            return None
        check_fused_plan(plan)
        if fsp is not None:
            fsp.annotate(stages=[(s.kind, s.max_dup) for s in stages],
                         partitions=plan.partitions,
                         base_rows=plan.base_rows)

        if faults.fault_fires("device.overflow", "multistage.fused"):
            # a forced bucket overflow takes the real fallback edge: the
            # mailbox plane serves the query
            bump("fused_fallbacks")
            if fsp is not None:
                fsp.annotate(fallback="device.overflow")
            return None

        with span(ph.FUSED_EXECUTE, partitions=plan.partitions) as esp:
            out = _run_program(plan, stages, leafs[0].n_rows, device, mesh)
            if out is None:
                # one skew retry at 2x bucket slack, then mailbox
                retry = _retry_with_slack(ex, ordered_joins, leafs,
                                          broadcast_threshold, device, mesh)
                if retry is None:
                    bump("fused_fallbacks")
                    if fsp is not None:
                        fsp.annotate(fallback="bucket_overflow")
                    return None
                plan, stages, out = retry
            if esp is not None:
                esp.annotate(rows=int(plan.base_rows))

        pos = out[0]
        order = np.nonzero(pos >= 0)[0]
        if any(st.kind == "hash" for st in stages):
            order = order[np.argsort(pos[order], kind="stable")]
        # else without a hash exchange nothing permutes the state: the
        # seed shards are contiguous slices and every stage's row-major
        # slot expansion is monotone in pos, so the program output is
        # already in canonical (hash_join) order
        final_idx = [np.asarray(ix)[order].astype(np.int64)
                     for ix in out[1:]]
        rel = _materialize(leafs, final_idx)
        # deferred non-equi inner conjuncts: filtering the materialized
        # relation commutes with the downstream joins' pair formation
        # (inner never preserves, left never drops probe rows)
        for st in stages:
            for conj in st.deferred:
                m = host_eval.eval_filter(conj, rel)
                rel = rel.take(np.nonzero(m)[0])
        bump("fused_plans")
        if fsp is not None:
            fsp.annotate(rows=rel.n_rows)
        return rel


def _retry_with_slack(ex, ordered_joins, leafs, broadcast_threshold,
                      device, mesh):
    """One bucket-overflow retry at doubled slack (the reference's
    ladder; the slack sizes the buckets of the hash kind, the one kind
    that can overflow); returns (plan, stages, out) or None."""
    prev = os.environ.get("PINOT_FUSED_SLACK")
    os.environ["PINOT_FUSED_SLACK"] = str(
        2.0 * float(prev if prev is not None else 2.0))
    try:
        plan, stages, _reason = plan_fused(ex, ordered_joins, leafs,
                                           broadcast_threshold, mesh.size)
        if plan is None:
            return None
        check_fused_plan(plan)
        out = _run_program(plan, stages, leafs[0].n_rows, device, mesh)
        if out is None:
            return None
        return plan, stages, out
    finally:
        if prev is None:
            os.environ.pop("PINOT_FUSED_SLACK", None)
        else:
            os.environ["PINOT_FUSED_SLACK"] = prev


def _materialize(leafs: List[Relation],
                 final_idx: List[np.ndarray]) -> Relation:
    """Gather the joined relation in canonical order (materialize_join
    + null_extend semantics: -1 indices take the column default with
    the null mask set)."""
    total = len(final_idx[0]) if final_idx else 0
    data: Dict[str, np.ndarray] = {}
    nulls: Dict[str, np.ndarray] = {}
    name_parts = []
    for leaf, ix in zip(leafs, final_idx):
        name_parts.append(leaf.name)
        m = ix >= 0
        safe = np.where(m, ix, 0)
        all_matched = bool(m.all())
        for k, v in leaf.data.items():
            col = v[safe] if len(v) else np.zeros(total, dtype=v.dtype)
            nm = leaf.nulls.get(k)
            nm = nm[safe] if nm is not None and len(v) else None
            if not all_matched:
                col = col.copy()
                col[~m] = _default_for(col.dtype)
                nm = (np.zeros(total, dtype=bool) if nm is None
                      else nm.copy()) | ~m
            if nm is not None and nm.any():
                nulls[k] = nm
            data[k] = col
    return Relation(data, nulls, "*".join(name_parts) or "fused")
