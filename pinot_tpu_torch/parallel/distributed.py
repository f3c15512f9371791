"""Distributed execution: a table's segments stacked over the shards of a
mesh, one dispatch per query, collectives for the combine (K18).

Port of ``pinot_tpu/parallel/distributed.py``. The reference stacks a
table's segments into (n_segments, bucket) arrays laid over a 1-D mesh
axis, runs the leaf kernel on each device's local segments inside one
``shard_map`` program and combines the dense outputs with
``psum`` / ``pmin`` / ``pmax`` (``_distributed_kernel_cached``,
``:247-312``). Here each shard's stack lives on its mesh device
(``parallel/mesh.py``); per shard the compact group-by runs ONCE over the
shard's segments flattened along the row axis (K1 on the card, through
``build_kernel(..., local_segments=L)``), the other plans run per segment
and combine locally, then ``parallel/collectives.all_reduce`` combines
across shards. The result is the same on every shard: shard 0's is read.

Requirements for the dense combine (as in the reference):
- all segments share table-level dictionaries
  (``segment/builder.build_table_dictionaries``), so dict ids and group
  spaces agree across shards;
- plans whose params are per-segment data (null masks, valid docs, doc
  masks), MV columns and sketches that do not combine positionally
  (theta, percentile) take the per-segment path (``try_execute`` -> None).

Memory: the stacked columns are charged to ``utils/devmem``'s
``mesh_stack`` pool, one entry a (table, column, shard), and freed by
``close()`` (``TableDataManager.set_distributed`` closes the table it
replaces) or when the table is collected; ``engine/tier.reconcile_devmem``
holds the pool to the stacks of the live tables.
"""
from __future__ import annotations

import copy
import itertools
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.executor import extract_partial, to_host
from ..ops.kernels import build_kernel
from ..query.context import QueryContext
from ..query.planner import CompiledPlan, SegmentPlanner
from ..segment.immutable import ImmutableSegment, bucket_for
from ..utils.devmem import global_device_memory
from ..utils.spans import annotate, device_fence, span
from .collectives import all_reduce, reduce_local
from .mesh import Mesh, default_mesh

POOL = "mesh_stack"                 # utils/devmem pool of the stacks

_UID = itertools.count(1)
# live tables (engine/tier.reconcile_devmem sums their stacks)
_LIVE: "weakref.WeakSet[DistributedTable]" = weakref.WeakSet()
_LIVE_LOCK = threading.Lock()


def live_tables() -> List["DistributedTable"]:
    with _LIVE_LOCK:
        return list(_LIVE)


def _reduce_op(name: str) -> str:
    if name.endswith("_present"):
        return "or"
    if name.endswith("_min"):
        return "min"
    if name.endswith("_max"):
        return "max"
    return "sum"  # matched, counts, sums, avg parts, group_count, overflow


def _release(uid: int, keys: List[Tuple[str, int]]) -> None:
    for name, d in keys:
        global_device_memory.remove(POOL, (uid, name, d), evicted=False)


class DistributedTable:
    """A table resident across a mesh as stacked per-shard columns."""

    def __init__(self, segments: List[ImmutableSegment],
                 mesh: Optional[Mesh] = None):
        if not segments:
            raise ValueError("no segments")
        self.segments = list(segments)
        self.mesh = mesh or default_mesh(segments[0].device)
        self.n_dev = self.mesh.size
        self.bucket = max(bucket_for(s.n_docs) for s in segments)
        # pad the segment count to a multiple of the mesh (empty segments
        # are inert: n_docs 0 -> all-false validity masks)
        self.n_slots = -(-len(segments) // self.n_dev) * self.n_dev
        self.local = self.n_slots // self.n_dev
        docs = [s.n_docs for s in segments] + \
            [0] * (self.n_slots - len(segments))
        self._n_docs = [docs[d * self.local:(d + 1) * self.local]
                        for d in range(self.n_dev)]
        self._cols: Dict[str, List[torch.Tensor]] = {}
        self._lock = threading.Lock()
        self.uid = next(_UID)
        self._keys: List[Tuple[str, int]] = []
        self._check_shared_dicts()
        self._finalizer = weakref.finalize(self, _release, self.uid,
                                           self._keys)
        with _LIVE_LOCK:
            _LIVE.add(self)

    def _check_shared_dicts(self) -> None:
        s0 = self.segments[0]
        for s in self.segments[1:]:
            for name, m in s0.columns.items():
                m2 = s.columns[name]
                if m.has_dict != m2.has_dict:
                    raise ValueError(
                        f"segment {s.name!r} column {name!r} does not share "
                        "the table dictionary (build with shared_dicts=...)")
                if m.has_dict:
                    v0 = np.asarray(s0.dictionary(name).values)
                    v1 = np.asarray(s.dictionary(name).values)
                    if len(v0) != len(v1) or not np.array_equal(v0, v1):
                        raise ValueError(
                            f"segment {s.name!r} column {name!r} dictionary "
                            "differs from the table dictionary")

    def _plan_view(self):
        """A table-wide planning view: segment 0's shape with min/max/nulls
        widened across every mesh-resident segment. Planning against one
        segment's statistics is wrong table-wide: its min/max would
        constant-fold predicates other segments do not satisfy, and limb
        widths sized from one segment's value range would truncate other
        segments' group sums."""
        s0 = self.segments[0]
        view = copy.copy(s0)
        view.columns = {}
        for name, m0 in s0.columns.items():
            m = copy.copy(m0)
            for s in self.segments[1:]:
                m2 = s.columns[name]
                if m.min is not None:
                    m.min = None if m2.min is None else min(m.min, m2.min)
                if m.max is not None:
                    m.max = None if m2.max is None else max(m.max, m2.max)
                m.has_nulls = m.has_nulls or m2.has_nulls
                m.is_sorted = m.is_sorted and m2.is_sorted
            view.columns[name] = m
        # ANY segment with upsert-invalidated docs puts the validdocs
        # param into the plan (-> try_execute falls back), not just
        # segment 0's
        view.valid_docs = next(
            (s.valid_docs for s in self.segments
             if getattr(s, "valid_docs", None) is not None), None)
        return view

    # -- sharded residency -------------------------------------------------
    def device_col(self, name: str) -> List[torch.Tensor]:
        """The column stacked (local, bucket) on each shard's device."""
        cols = self._cols.get(name)
        if cols is not None:
            return cols
        with self._lock:
            cols = self._cols.get(name)
            if cols is None:
                m = self.segments[0].columns[name]
                stack = np.zeros(
                    (self.n_slots, self.bucket),
                    dtype=np.int32 if m.has_dict else m.fwd_dtype)
                for i, s in enumerate(self.segments):
                    stack[i, : s.n_docs] = np.asarray(s.fwd(name)).astype(
                        stack.dtype, copy=False)
                cols = []
                for d, dev in enumerate(self.mesh):
                    part = stack[d * self.local:(d + 1) * self.local]
                    t = torch.from_numpy(np.ascontiguousarray(part))
                    cols.append(t if dev.type == "cpu" else t.to(dev))
                    global_device_memory.add(POOL, (self.uid, name, d),
                                             int(cols[-1].nbytes))
                    self._keys.append((name, d))
                self._cols[name] = cols
        return cols

    def device_bytes(self) -> int:
        """Bytes of the stacks this table holds now."""
        return sum(int(t.nbytes) for cols in list(self._cols.values())
                   for t in cols)

    def close(self) -> None:
        """Drop the stacks and their accounting (the table leaves the
        mesh); a later query stacks them again."""
        with self._lock:
            self._cols.clear()
            _release(self.uid, self._keys)
            self._keys.clear()

    # -- execution ---------------------------------------------------------
    def plan(self, ctx: QueryContext) -> CompiledPlan:
        """Plan against the widened table view; shared dictionaries make
        the dict-id params valid table-wide. Compact-strategy group-bys
        run flattened per shard, so the planner chooses strategies
        exactly as the single-device path does."""
        return SegmentPlanner(ctx, self._plan_view()).plan()

    def try_execute(self, ctx: QueryContext):
        """The distributed partial, or None when the plan needs the
        per-segment path (host fallbacks, per-segment data params, MV
        columns, sketches that do not combine positionally)."""
        plan = self.plan(ctx)
        if plan.kind != "kernel":
            return None
        if any(isinstance(p, tuple)
               and p[0] in ("nullmask", "validdocs", "docmask")
               for p in plan.params):
            return None
        if any(not getattr(self.segments[0].columns[c], "single_value",
                           True) for c in plan.col_names):
            return None
        if plan.kernel_plan is not None and any(
                s.kind in ("distinct_count_theta", "percentile_sketch",
                           "raw_theta", "percentile_raw_sketch")
                for s in plan.kernel_plan.aggs):
            # theta hash lists and percentile centroids do not combine
            # positionally across shards (HLL presence does: 'or')
            return None
        out = self._run(plan)
        return extract_partial(plan, out)

    def _cost_model_cap(self, plan: CompiledPlan) -> Optional[int]:
        """The planner's cost-model compaction capacity scaled to one
        shard's local rows (local segments x bucket), through the rule the
        segmented dispatch shares (multistage/costs.scaled_compact_cap)."""
        if plan.kernel_plan.strategy != "compact":
            return None
        from ..multistage.costs import scaled_compact_cap
        return scaled_compact_cap(plan, self.local * self.bucket)

    def _params(self, plan: CompiledPlan) -> List[Tuple[torch.Tensor, ...]]:
        """The plan's params on each shard's device: dictionary values and
        hashes from segment 0's device cache (shared dictionaries), literal
        scalars and arrays uploaded (tiny)."""
        s0 = self.segments[0]
        host: List[Any] = []
        for p in plan.params:
            if isinstance(p, tuple) and len(p) == 2 and p[0] == "dictvals":
                host.append(s0.device_dict_values(p[1]))
            elif isinstance(p, tuple) and len(p) == 2 and p[0] == "hash64":
                host.append(s0.device_dict_hashes(p[1]))
            else:
                host.append(np.asarray(p))
        per_dev = {}
        for dev in self.mesh.distinct_devices:
            per_dev[dev] = tuple(
                v.to(dev) if isinstance(v, torch.Tensor)
                else torch.as_tensor(v, device=dev) for v in host)
        return [per_dev[dev] for dev in self.mesh]

    def _run(self, plan: CompiledPlan) -> Dict[str, np.ndarray]:
        cols = [self.device_col(n) for n in plan.col_names]
        params = self._params(plan)
        cap = self._cost_model_cap(plan)
        with span("mesh_dispatch", devices=self.n_dev,
                  local_segments=self.local, bucket=self.bucket,
                  strategy=plan.kernel_plan.strategy, slots_cap=cap,
                  est_sel=plan.est_selectivity):
            with span("device_execute"):
                dev_out = distributed_kernel(plan.kernel_plan, self.bucket,
                                             self.mesh, cols, self._n_docs,
                                             params, cap)
                device_fence(dev_out)
            with span("device_transfer"):
                host = to_host(dev_out)
            if int(host.pop("overflow", 0)):
                # compact capacity exceeded on some shard: rerun at the
                # cannot-overflow capacity of a full local shard
                from ..ops.compact import full_slots_cap
                full = full_slots_cap(self.local * self.bucket)
                with span("overflow_retry", slots_cap=full):
                    host = to_host(distributed_kernel(
                        plan.kernel_plan, self.bucket, self.mesh, cols,
                        self._n_docs, params, full))
                host.pop("overflow", None)
                annotate(overflow_retry=True, slots_cap=full)
            if "matched" in host:
                matched = int(np.asarray(host["matched"]).sum())
                annotate(matched=matched,
                         meas_sel=matched / max(
                             sum(s.n_docs for s in self.segments), 1))
            return host


def kernel_bytes(cols: Sequence[Sequence[torch.Tensor]],
                 n_docs: Sequence[Sequence[int]],
                 params: Sequence[Tuple[torch.Tensor, ...]],
                 out: Dict[str, torch.Tensor]) -> int:
    """The least bytes ``distributed_kernel`` must move: each shard's
    live rows of each column read once (a stack's padding past a
    segment's ``n_docs`` is not data), each shard's params read once, the
    combined outputs written once."""
    rows = [sum(d) for d in n_docs]
    read = sum(r * c[d].element_size() for c in cols
               for d, r in enumerate(rows))
    read += sum(int(p.nbytes) for ps in params for p in ps)
    return read + sum(int(v.nbytes) for v in out.values())


def distributed_kernel(kernel_plan, bucket: int, mesh: Mesh,
                       cols: Sequence[Sequence[torch.Tensor]],
                       n_docs: Sequence[Sequence[int]],
                       params: Sequence[Tuple[torch.Tensor, ...]],
                       slots_cap: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
    """K18: the leaf kernel on every shard's local segments, then the
    combine across shards. ``cols[c][d]`` is column c's (local, bucket)
    stack on shard d, ``n_docs[d]`` shard d's local doc counts,
    ``params[d]`` the params on shard d's device. Returns the combined
    dense outputs on shard 0's device."""
    compact_gb = (kernel_plan.is_group_by
                  and kernel_plan.strategy == "compact")
    local_outs: List[Dict[str, torch.Tensor]] = []
    for d, dev in enumerate(mesh):
        shard = [c[d] for c in cols]
        local_segs = len(n_docs[d])
        if compact_gb:
            # the local segments flattened into one row axis: shared
            # dictionaries make params segment-agnostic, so one
            # compaction (K1) and one group pass serve the whole shard
            kern = build_kernel(kernel_plan, bucket, slots_cap,
                                xfer_compact=False, device=dev,
                                local_segments=local_segs)
            local_outs.append(kern(
                tuple(c.reshape(local_segs * bucket) for c in shard),
                n_docs[d] if local_segs > 1 else n_docs[d][0], params[d]))
        else:
            kern = build_kernel(kernel_plan, bucket, slots_cap,
                                xfer_compact=False, device=dev)
            outs = [kern(tuple(c[i] for c in shard), n_docs[d][i],
                         params[d]) for i in range(local_segs)]
            local_outs.append({k: reduce_local(_reduce_op(k),
                                               [o[k] for o in outs])
                               for k in outs[0]})
    return {k: all_reduce(_reduce_op(k), [o[k] for o in local_outs])[0]
            for k in local_outs[0]}
