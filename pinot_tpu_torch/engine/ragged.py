"""Cross-query micro-batching: one fused device dispatch for N queries.

Port of ``pinot_tpu/engine/ragged.py``. A short admission window
(engine/scheduler.MicroBatchQueue) collects in-flight queries that share
a plan structure (KernelPlan, bucket, param signature) and fuses each
group into one dispatch (K14):

- ONE unmasked group-by over the union of the predicate and group
  dimensions builds a literal-free **cube** per segment (an int64
  ``index_add_`` of the in-domain rows over the cube key, one buffer for
  the count and one per deduped integral sum), cached on the device in
  ops/plan_cache.global_cube_cache and keyed by segment uid;
- each query's literal params stack on a leading item axis and its
  predicate (ops/kernels._eval_pred) is evaluated over the cube's id grid
  -- a few thousand cells instead of millions of rows -- by
  ``torch.func.vmap`` over the N items (a per-item loop is the plain
  version the tests hold it to);
- items are (query, segment) pairs padded to a power of two (pads repeat
  item 0 and are sliced off), one masked reduction of ``cells[seg_idx]``
  gives ``[N, G]`` or ``[N]`` per output, and the results are extracted
  per item through the ordinary ``extract_partial``, so fused results
  equal solo ones (exact integer sums only: float sums would
  reassociate and never fuse).

Admission: a query with no concurrent peer, a plan the cube cost model
rejects and a query near its deadline dispatch solo at once, never
queue-blocked; the reason is counted as ``solo_fallback_<reason>``.
Batching is on by default (``PINOT_MICROBATCH=0``,
``Broker(micro_batch=False)`` or ``global_batcher.configure`` turn it
off).

What differs from the JAX package:
- the cube is published to the cache only after its build has finished
  on the device (``_fence``: an event recorded on the building thread's
  stream and waited on by the host), the counterpart of JAX's
  ``device_fence``; threads on other streams then read finished cells;
- a ``CubeSpec`` also carries the plan's column names. The JAX package
  keys the spec memo, the cube cache and the admission queue by the
  KernelPlan, which holds column indices only, so two queries whose
  plans differ only in which columns they read (``WHERE a < 5`` against
  ``WHERE b < 5``) share a spec there and the second is answered from
  the first one's cube (ROADMAP Queue 3);
- no jit, so no kernel registry or retrace detector: the cube and
  combine closures are built per dispatch (a few Python objects); the
  overload governor's window scaling is not ported. The spans are the
  reference's (``ragged_dispatch``, ``cube_build``, ``fused_execute``,
  with the same annotations).
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import INT_ACC
from ..ops.ir import (And, Bin, Case, Cmp, Col, EqId, FalseP, Func, IdRange,
                      InBitmap, InSet, Lit, MvReduce, Not, Or, TrueP)
from ..ops.kernels import (GROUP_XFER_SPACE, _agg_name, _device_of,
                           _eval_pred, _eval_value, _pred_col_indices)
from ..ops.plan_cache import global_cube_cache
from ..utils import phases as ph
from ..utils.metrics import global_metrics
from ..utils.spans import annotate, device_fence, span
from .accounting import global_accountant
from .executor import extract_partial, resolve_params, to_host
from .scheduler import MicroBatchQueue

# cost-model caps: the cube must stay small next to the data it collapses,
# the per-item masked-cell work must stay bounded, and raw (no-dictionary)
# predicate columns join as dims only over a small value span
CUBE_SPACE_LIMIT = 1 << 20
RAW_DIM_SPAN_CAP = 1 << 12
ITEM_CELL_BUDGET = 1 << 23          # pow2-padded items x cube_space
DEFAULT_WINDOW_MS = 4.0
DEFAULT_MAX_BATCH = 32

# why a submission dispatched solo instead of fusing
_SOLO_REASONS = ("incompatible", "no_peers", "deadline",
                 "window_expired", "timeout", "leader_error")


@dataclass(frozen=True)
class CubeSpec:
    """Literal-free fusion recipe for one plan structure on one segment
    shape. Hashable: it keys the cube cache, the built closures and the
    admission queue."""
    kp: Any                       # ops.ir.KernelPlan
    cols: Tuple[str, ...]         # the plan's column names, by index
    bucket: int
    n_cols: int
    # (col_idx, card, base, is_dict) in cube-key order: group dims first
    # (the plan's own arithmetic), then predicate-only dims
    dims: Tuple[Tuple[int, int, int, bool], ...]
    group_space: int              # G (1 for scalar aggregations)
    pred_space: int               # P
    cube_space: int               # G * P


def _value_param_indices(ve) -> Tuple[set, set]:
    """(dict-value param indices, other param indices) referenced by an
    aggregation value: a literal inside an aggregation value makes the
    cube literal-dependent, so unshareable."""
    dicts: set = set()
    other: set = set()

    def walk(e):
        if isinstance(e, (Col, MvReduce)):
            if e.dict_param is not None:
                dicts.add(e.dict_param)
        elif isinstance(e, Lit):
            other.add(e.param)
        elif isinstance(e, Bin):
            walk(e.lhs)
            walk(e.rhs)
        elif isinstance(e, Func):
            for a in e.args:
                walk(a)
        elif isinstance(e, Case):
            other.add(-1)  # a CASE may hide predicate params: ineligible
    walk(ve)
    return dicts, other


def _pred_fusable(p) -> bool:
    """Allowlist walk of the predicate IR: only node shapes the grid
    evaluator is vetted for fuse; MaskParam, MvReduce/Case values and any
    future node fail closed."""

    def value_ok(ve) -> bool:
        if isinstance(ve, (Col, Lit)):
            return True
        if isinstance(ve, Bin):
            return value_ok(ve.lhs) and value_ok(ve.rhs)
        if isinstance(ve, Func):
            return all(value_ok(a) for a in ve.args)
        return False

    if isinstance(p, (TrueP, FalseP, EqId, IdRange, InSet, InBitmap)):
        return True
    if isinstance(p, Cmp):
        return value_ok(p.lhs)
    if isinstance(p, (And, Or)):
        return all(_pred_fusable(c) for c in p.children)
    if isinstance(p, Not):
        return _pred_fusable(p.child)
    return False


# (kernel plan, column names, segment uid) -> (spec, reason): both inputs
# are immutable per load uid, so peers microseconds apart share it
_SPEC_MEMO: "OrderedDict[Tuple, Tuple[Optional[CubeSpec], str]]" = \
    OrderedDict()
_SPEC_MEMO_MAX = 512
_spec_lock = threading.Lock()


def cube_spec_for(plan) -> Tuple[Optional[CubeSpec], str]:
    """The fusion recipe of a compiled kernel plan, or (None, reason) when
    the cube cost model rejects it: every predicate column a bounded
    single-value dimension, aggregations exact under cell re-association
    (COUNT / integral SUM / AVG), the cube small next to the segment.
    Memoized by (plan, column names, segment uid)."""
    kp = plan.kernel_plan
    uid = getattr(plan.segment, "uid", None)
    key = None
    if kp is not None and uid is not None:
        key = (kp, tuple(plan.col_names), uid)
        with _spec_lock:
            hit = _SPEC_MEMO.get(key)
            if hit is not None:
                _SPEC_MEMO.move_to_end(key)
                return hit
    out = _derive_cube_spec(plan)
    if key is not None:
        with _spec_lock:
            _SPEC_MEMO[key] = out
            _SPEC_MEMO.move_to_end(key)
            while len(_SPEC_MEMO) > _SPEC_MEMO_MAX:
                _SPEC_MEMO.popitem(last=False)
    return out


def _derive_cube_spec(plan) -> Tuple[Optional[CubeSpec], str]:
    kp = plan.kernel_plan
    if kp is None:
        return None, "incompatible"
    if kp.key_exprs:
        return None, "incompatible"          # expression group keys
    if INT_ACC != torch.int64:
        # cube cells accumulate int64 subtotals (always so in the port)
        return None, "incompatible"
    for spec in kp.aggs:
        if spec.kind not in ("count", "sum", "avg"):
            return None, "incompatible"      # sketches / min-max / distinct
        if spec.kind in ("sum", "avg") and not spec.integral:
            return None, "incompatible"      # float sums reassociate
        if spec.null_param is not None:
            return None, "incompatible"      # null handling masks per agg
        if spec.value is not None:
            _dicts, other = _value_param_indices(spec.value)
            if other:
                return None, "incompatible"  # literal inside an agg value
    if not _pred_fusable(kp.pred):
        return None, "incompatible"
    for p in plan.params:
        if isinstance(p, tuple) and len(p) == 2 and \
                p[0] in ("nullmask", "validdocs", "docmask", "hash64"):
            return None, "incompatible"      # per-row masks can't cube
    seg = plan.segment
    if getattr(seg, "uid", None) is None:
        return None, "incompatible"          # cache key contract
    group_cols = {ci for ci, _ in kp.group_keys}
    dims: List[Tuple[int, int, int, bool]] = [
        (ci, card, 0, True) for ci, card in kp.group_keys]
    pred_only = sorted(_pred_col_indices(kp.pred) - group_cols)
    pred_space = 1
    for ci in pred_only:
        if ci >= len(plan.col_names):
            return None, "incompatible"
        name = plan.col_names[ci]
        meta = seg.columns.get(name)
        if meta is None or not getattr(meta, "single_value", True):
            return None, "incompatible"      # MV predicate semantics
        if seg.dictionary(name) is not None:
            card, base, is_dict = int(meta.cardinality), 0, True
        else:
            lo, hi = getattr(meta, "min", None), getattr(meta, "max", None)
            if not isinstance(lo, int) or not isinstance(hi, int):
                return None, "incompatible"
            span = hi - lo + 1
            if span <= 0 or span > RAW_DIM_SPAN_CAP:
                return None, "incompatible"
            card, base, is_dict = span, lo, False
        if card <= 0:
            return None, "incompatible"
        dims.append((ci, card, base, is_dict))
        pred_space *= card
    group_space = kp.group_space if kp.is_group_by else 1
    if group_space >= GROUP_XFER_SPACE:
        # the fused kernel emits dense [items, G] outputs; past the
        # sparse-transfer threshold the solo path moves far fewer bytes
        return None, "incompatible"
    cube_space = group_space * pred_space
    if cube_space > CUBE_SPACE_LIMIT or cube_space > seg.bucket:
        return None, "incompatible"          # the cube must beat the scan
    return CubeSpec(kp=kp, cols=tuple(plan.col_names), bucket=seg.bucket,
                    n_cols=len(plan.col_names), dims=tuple(dims),
                    group_space=group_space, pred_space=pred_space,
                    cube_space=cube_space), ""


# ---------------------------------------------------------------------------
# kernels (K14)
# ---------------------------------------------------------------------------

def _dim_digits(spec: CubeSpec, cols) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cube key [bucket] int32, in-domain mask): the plan's own group-key
    arithmetic extended by the predicate-only dims."""
    key = ok = None
    for ci, card, base, _is_dict in spec.dims:
        digit = cols[ci].to(torch.int32) - base
        in_dom = (digit >= 0) & (digit < card)
        ok = in_dom if ok is None else ok & in_dom
        key = digit if key is None else key * card + digit
    return key, ok


def _grid_cols(spec: CubeSpec, device) -> Tuple[torch.Tensor, ...]:
    """Per-dim id/value arrays over the cube cells: the domain each
    query's predicate is evaluated on (columns outside the dims are
    zeros, which no fusable predicate reads)."""
    idx = torch.arange(spec.cube_space, dtype=torch.int32, device=device)
    cols: List[Optional[torch.Tensor]] = [None] * spec.n_cols
    div = spec.cube_space
    for ci, card, base, _is_dict in spec.dims:
        div //= card
        cols[ci] = torch.remainder(torch.div(idx, div, rounding_mode="floor"),
                                   card) + base
    zero = torch.zeros(spec.cube_space, dtype=torch.int32, device=device)
    return tuple(zero if c is None else c for c in cols)


def _cube_jobs(spec: CubeSpec):
    """The deduped integral sum payload slots (the ops/kernels
    _payload_columns contract, restricted to the cube-eligible kinds)."""
    jobs = []
    slots: Dict[Tuple, int] = {}
    for i, agg in enumerate(spec.kp.aggs):
        if agg.kind == "count":
            jobs.append((i, agg, None))
            continue
        key = (agg.value, agg.integral)
        slot = slots.setdefault(key, len(slots))
        jobs.append((i, agg, slot))
    return jobs, len(slots)


def build_cube_kernel(spec: CubeSpec):
    """fn(cols, n_docs, params) -> {"cnt": [cube] int64, "s<k>": [cube]
    int64}: the literal-free cube, one unmasked pass over the segment."""
    jobs, _n_slots = _cube_jobs(spec)
    slot_values = {}
    for _i, agg, slot in jobs:
        if slot is not None and slot not in slot_values:
            slot_values[slot] = agg.value
    nseg = spec.cube_space + 1

    def kernel(cols, n_docs: int, params) -> Dict[str, torch.Tensor]:
        dev = _device_of(cols, params)
        keep = torch.arange(spec.bucket, dtype=torch.int32,
                            device=dev) < n_docs
        key, ok = _dim_digits(spec, cols)
        if ok is not None:
            keep &= ok
            keys_s = torch.where(keep, key, spec.cube_space)
        else:                                # no dims: one cell
            keys_s = torch.where(keep, 0, spec.cube_space).to(torch.int32)

        def scatter(vals: torch.Tensor) -> torch.Tensor:
            acc = torch.zeros(nseg, dtype=torch.int64, device=dev)
            return acc.index_add_(0, keys_s, vals)[: spec.cube_space]

        out = {"cnt": scatter(keep.to(torch.int64))}
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        for slot, ve in slot_values.items():
            v = _eval_value(ve, cols, params, promote=True)
            out[f"s{slot}"] = scatter(torch.where(keep, v.to(torch.int64),
                                                  zero))
        return out

    return kernel


def cube_masks(spec: CubeSpec, grid, params, n: int, vmap: bool = True
               ) -> torch.Tensor:
    """[n, cube] bool: each item's predicate over the cube grid, from the
    n-stacked ``params``. ``vmap=True`` maps ops/kernels._eval_pred over
    the items with torch.func.vmap, which carries every node kind
    ``_pred_fusable`` admits; ``vmap=False`` is the plain version, a loop
    over the items. A plan without params (no literal in its predicate)
    gives every item the same mask."""
    pred, dev = spec.kp.pred, grid[0].device
    if not params:
        return _eval_pred(pred, grid, (), spec.cube_space, dev).expand(n, -1)
    if vmap:
        return torch.func.vmap(
            lambda *ps: _eval_pred(pred, grid, ps, spec.cube_space, dev))(
                *params)
    return torch.stack([
        _eval_pred(pred, grid, tuple(p[k] for p in params),
                   spec.cube_space, dev) for k in range(n)])


def build_cube_combine_kernel(spec: CubeSpec, vmap: bool = True):
    """fn(cubes, seg_idx [N], params [N-stacked]) -> per-item outputs named
    like the solo kernel's (matched / group_count / agg<i>_*), so
    extract_partial is oblivious to the fusion."""
    jobs, _n_slots = _cube_jobs(spec)
    G, P = spec.group_space, spec.pred_space
    grouped = spec.kp.is_group_by

    def kernel(cubes, seg_idx: torch.Tensor, params
               ) -> Dict[str, torch.Tensor]:
        dev = cubes["cnt"].device
        n = seg_idx.shape[0]
        masks = cube_masks(spec, _grid_cols(spec, dev), params, n, vmap)
        zero = torch.zeros((), dtype=torch.int64, device=dev)

        def reduce_cells(cells):
            sel = torch.where(masks, cells[seg_idx], zero)  # [N, cube]
            if grouped:
                return sel.reshape(n, G, P).sum(-1)         # [N, G]
            return sel.sum(-1)                              # [N]

        counts = reduce_cells(cubes["cnt"])
        out: Dict[str, torch.Tensor] = {}
        if grouped:
            out["group_count"] = counts
            out["matched"] = counts.sum(-1)
        else:
            out["matched"] = counts
        slot_sums: Dict[int, torch.Tensor] = {}
        for i, agg, slot in jobs:
            name = _agg_name(i, agg)
            if agg.kind == "count":
                if not grouped:
                    out[name] = counts
                continue  # a grouped COUNT rides group_count
            s = slot_sums.get(slot)
            if s is None:
                s = slot_sums[slot] = reduce_cells(cubes[f"s{slot}"])
            if agg.kind == "avg":
                out[name + "_sum"] = s
                out[name + "_cnt"] = counts
            else:
                out[name] = s
        return out

    return kernel


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _fence(tree: Dict[str, torch.Tensor]) -> None:
    """Wait on the host until the work that wrote ``tree`` on this
    thread's current stream has finished: a cube is published only after
    its build completed, whatever stream a reader later uses."""
    t = next(iter(tree.values()))
    if t.device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        done.synchronize()


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------

def default_enabled() -> bool:
    """The process-default batching switch: on unless PINOT_MICROBATCH=0."""
    return os.environ.get("PINOT_MICROBATCH") != "0"


class _Submission:
    __slots__ = ("plans", "resolved", "future", "query_id", "t0",
                 "n_items", "abandoned")

    def __init__(self, plans, resolved, query_id):
        self.plans = plans
        self.resolved = resolved
        self.future: "Future[Any]" = Future()
        self.query_id = query_id
        self.t0 = time.perf_counter()
        self.n_items = len(plans)
        # set by a follower that gave up waiting and re-dispatched solo:
        # the leader must not report it as batched
        self.abandoned = False


class RaggedBatcher:
    """The cross-query micro-batching dispatcher (module docstring)."""

    def __init__(self, window_ms: float = DEFAULT_WINDOW_MS,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 enabled: Optional[bool] = None):
        self.window_ms = window_ms
        self.max_batch = max_batch
        self.enabled = (default_enabled()
                        if enabled is None else bool(enabled))
        self.queue = MicroBatchQueue()
        self._lock = threading.Lock()
        self._est_ms: Dict[Any, float] = {}

    def configure(self, enabled: Optional[bool] = None,
                  window_ms: Optional[float] = None,
                  max_batch: Optional[int] = None) -> "RaggedBatcher":
        if enabled is not None:
            self.enabled = bool(enabled)
        if window_ms is not None:
            self.window_ms = float(window_ms)
        if max_batch is not None:
            self.max_batch = int(max_batch)
        return self

    # -- admission ---------------------------------------------------------
    def estimate_ms(self, key: Any) -> Optional[float]:
        """EWMA of the fused dispatch's wall ms for a compatibility key."""
        with self._lock:
            return self._est_ms.get(key)

    def _record_ms(self, key: Any, ms: float) -> None:
        with self._lock:
            prev = self._est_ms.get(key)
            self._est_ms[key] = ms if prev is None \
                else 0.7 * prev + 0.3 * ms
            if len(self._est_ms) > 512:
                self._est_ms.pop(next(iter(self._est_ms)))

    @staticmethod
    def _solo(reason: str) -> None:
        global_metrics.count(f"solo_fallback_{reason}")
        annotate(batched=False, solo_reason=reason)
        return None

    def submit(self, plans: List[Any], resolved: List[Tuple],
               bucket: int, group_sig: Tuple) -> Optional[List[Any]]:
        """Try to fuse one query's kernel-plan group with concurrent
        peers. Returns per-plan partials, or None: the caller then runs
        the ordinary solo dispatch (the reason counted in
        solo_fallback_*). Ineligible, peerless and deadline-pressed
        queries bail before they enqueue."""
        if not self.enabled:
            return None
        # a lone query never waits the window: checked first, it costs
        # one lock, while the spec below walks the plan and the metadata
        if len(global_accountant.running()) < 2:
            return self._solo("no_peers")
        spec, _why = cube_spec_for(plans[0])
        if spec is None:
            return self._solo("incompatible")
        # the budget bounds what the combine executes: the pow2-padded
        # item count, not the raw one
        if _pow2(len(plans)) * spec.cube_space > ITEM_CELL_BUDGET:
            return self._solo("incompatible")
        # dim cardinalities are segment state: every segment of the group
        # must derive the same spec or the shared grid would mis-decode
        seen_uids = {plans[0].segment.uid}
        for plan in plans[1:]:
            if plan.segment.uid in seen_uids:
                continue
            seen_uids.add(plan.segment.uid)
            other, _w = cube_spec_for(plan)
            if other != spec:
                return self._solo("incompatible")
        qid = global_accountant.current_query_id()
        key = (spec, bucket, group_sig)
        window_ms = self.window_ms
        usage = global_accountant.usage(qid) if qid else None
        if usage is not None and usage.deadline is not None:
            rem_ms = (usage.deadline - time.perf_counter()) * 1e3
            est = self.estimate_ms(key) or window_ms
            if rem_ms < window_ms + 2.0 * est:
                return self._solo("deadline")
        sub = _Submission(plans, resolved, qid)
        # weight cap = the largest pow2 <= the budgeted item count, so the
        # padded batch still fits ITEM_CELL_BUDGET
        budget_items = max(ITEM_CELL_BUDGET // max(spec.cube_space, 1), 1)
        max_weight = 1 << max(budget_items.bit_length() - 1, 0)
        # one ragged_dispatch span a query, on its own thread, around its
        # wait and its share of the fused dispatch; the leader's also
        # parents the cube_build / fused_execute children
        with span(ph.RAGGED_DISPATCH, bucket=bucket,
                  strategy=spec.kp.strategy):
            global_metrics.gauge("batch_queue_depth", self.queue.depth())
            batch = self.queue.offer(
                key, sub, window_ms / 1e3, self.max_batch,
                max_weight=max_weight, weight=sub.n_items)
            global_metrics.gauge("batch_queue_depth", self.queue.depth())
            if batch is None:
                return self._await_follower(sub, usage)
            if len(batch) == 1:
                annotate(queue_wait_ms=round(
                    (time.perf_counter() - sub.t0) * 1e3, 3))
                return self._solo("window_expired")
            return self._lead(key, spec, batch, sub)

    def _await_follower(self, sub: _Submission, usage) -> Optional[List]:
        timeout = 60.0
        if usage is not None and usage.deadline is not None:
            # keep half the remaining budget for the solo fallback
            rem = usage.deadline - time.perf_counter()
            timeout = max(min(rem * 0.5, 60.0), 0.05)
        reason = "leader_error"
        try:
            result = sub.future.result(timeout=timeout)
        except FutureTimeout:
            # abandon before the last-chance re-check: either the leader
            # already set the result (use it) or it sees the flag
            sub.abandoned = True
            result = sub.future.result(0) if sub.future.done() else None
            reason = "timeout"
        except Exception:
            result = None
        wait_ms = (time.perf_counter() - sub.t0) * 1e3
        if result is None:
            return self._solo(reason)
        partials, batch_size, exec_ms = result
        annotate(batched=True, batch_size=batch_size,
                 queue_wait_ms=round(wait_ms - exec_ms, 3),
                 fused_share_ms=round(
                     exec_ms * sub.n_items / max(batch_size, 1), 3))
        return partials

    # -- fused execution (leader thread) -----------------------------------
    def _lead(self, key, spec: CubeSpec, batch: List[_Submission],
              own: _Submission) -> Optional[List]:
        t_exec = time.perf_counter()
        try:
            results = self._execute_fused(spec, batch)
        except BaseException as e:  # followers must not hang
            for sub in batch:
                if sub is not own and not sub.future.done():
                    sub.future.set_result(None)
            global_metrics.count("fused_dispatch_errors")
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            return self._solo("leader_error")
        exec_ms = (time.perf_counter() - t_exec) * 1e3
        self._record_ms(key, exec_ms)
        n_queries = len(batch)
        global_metrics.count("batched_dispatches")
        global_metrics.count("batched_queries", n_queries)
        global_metrics.count(_size_bucket(n_queries))
        for sub in batch:
            if sub.query_id and not sub.abandoned:
                global_accountant.note_batched(sub.query_id, n_queries)
            if sub is not own:
                sub.future.set_result((results[id(sub)], n_queries,
                                       exec_ms))
        annotate(batched=True, batch_size=n_queries, leader=True,
                 fused_items=sum(s.n_items for s in batch),
                 queue_wait_ms=round((t_exec - own.t0) * 1e3, 3),
                 fused_ms=round(exec_ms, 3))
        return results[id(own)]

    def _execute_fused(self, spec: CubeSpec,
                       batch: List[_Submission]) -> Dict[int, List]:
        items: List[Tuple[_Submission, Any, Tuple]] = []
        for sub in batch:
            for plan, params in zip(sub.plans, sub.resolved):
                items.append((sub, plan, params))

        # one cube per distinct segment (cached on the device: one
        # unmasked scan each when cold, none when warm)
        seg_order: Dict[int, int] = {}
        seg_plans: List[Any] = []
        for _sub, plan, _p in items:
            uid = plan.segment.uid
            if uid not in seg_order:
                seg_order[uid] = len(seg_plans)
                seg_plans.append(plan)
        cubes = [global_cube_cache.entry(
            spec, plan.segment, lambda p=plan: self._build_cube(spec, p))
            for plan in seg_plans]
        stacked = global_cube_cache.stacked(
            spec, [p.segment for p in seg_plans], cubes)

        # ragged pack: pow2-padded item axis (pads repeat item 0 and are
        # sliced off at unpack)
        n_items = len(items)
        npad = _pow2(n_items)
        dev = stacked["cnt"].device
        seg_idx = np.zeros(npad, dtype=np.int64)
        for k, (_s, plan, _p) in enumerate(items):
            seg_idx[k] = seg_order[plan.segment.uid]
        params0 = items[0][2]
        stacked_params = tuple(
            torch.stack([items[k][2][j] if k < n_items else params0[j]
                         for k in range(npad)])
            for j in range(len(params0)))
        with span(ph.FUSED_EXECUTE, queries=len(batch), items=n_items,
                  padded=npad, segments=len(cubes),
                  cube_space=spec.cube_space):
            out = build_cube_combine_kernel(spec)(
                stacked, torch.as_tensor(seg_idx, device=dev),
                stacked_params)
            device_fence(out)
            host = to_host(out)
        # apportioned per participant (outputs are [npad, ...], so every
        # item owns an equal slice): the leader must not carry the batch
        total_bytes = sum(v.nbytes for v in host.values())
        per_item = total_bytes // max(npad, 1)
        for sub in batch:
            if sub.query_id:
                global_accountant.track_memory_for(
                    sub.query_id, per_item * sub.n_items)
        results: Dict[int, List[Any]] = {id(s): [] for s in batch}
        for k, (sub, plan, _p) in enumerate(items):
            per = {name: v[k] for name, v in host.items()}
            results[id(sub)].append(extract_partial(plan, per))
        return results

    def _build_cube(self, spec: CubeSpec, plan) -> Dict[str, torch.Tensor]:
        seg = plan.segment
        fn = build_cube_kernel(spec)
        with span(ph.CUBE_BUILD, segment=seg.name, bucket=seg.bucket,
                  cube_space=spec.cube_space):
            cols = seg.device_cols(plan.col_names)
            out = fn(cols, seg.n_docs, resolve_params(plan))
            _fence(out)
            return out

    def clear(self) -> None:
        """Drop the estimates (the cube cache is cleared through
        ops/plan_cache.global_cube_cache)."""
        with self._lock:
            self._est_ms.clear()


def _size_bucket(n: int) -> str:
    for b in (2, 4, 8, 16, 32):
        if n <= b:
            return f"fused_batch_size_le_{b}"
    return "fused_batch_size_gt_32"


global_batcher = RaggedBatcher()


def batching_health(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """The micro-batching block of a metrics snapshot: fused dispatches,
    solo fallbacks by reason, the batch-size histogram, the queue depth
    and the cube cache's device bytes."""
    c = snapshot["counters"]
    out = {k: c.get(k, 0) for k in (
        "batched_dispatches", "batched_queries", "fused_dispatch_errors",
        "cube_cache_hits", "cube_cache_misses")}
    out["solo_fallbacks"] = {r: c.get(f"solo_fallback_{r}", 0)
                             for r in _SOLO_REASONS}
    out["batch_size_histogram"] = {
        f"le_{b}": c.get(f"fused_batch_size_le_{b}", 0)
        for b in (2, 4, 8, 16, 32)}
    out["batch_size_histogram"]["gt_32"] = c.get(
        "fused_batch_size_gt_32", 0)
    g = snapshot["gauges"]
    out["batch_queue_depth"] = g.get("batch_queue_depth", 0)
    out["cube_cache_bytes"] = int(g.get("device_bytes_cube_cache", 0)
                                  + g.get("device_bytes_cube_stacked", 0))
    out["enabled"] = global_batcher.enabled
    return out
