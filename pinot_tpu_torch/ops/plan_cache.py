"""Kernel-plan feedback: measured selectivity and known overflows.

Port of the feedback half of ``pinot_tpu/ops/plan_cache.py``. The JAX
package caches one compiled XLA program per (plan, bucket, slots_cap);
the port compiles nothing, so it keeps only what that cache learns from
runs:

- the measured selectivity of the last run of a plan on a segment with
  the same literal params (``record_measured`` / ``measured_for``), which
  the planner's drift re-quantization reads (query/planner.py);
- a per-(plan, bucket, slots_cap) overflowed flag, so that a capacity
  that overflowed once goes straight to full capacity next time instead
  of paying the doomed tight run and its retry (engine/executor.py).

It also holds the cube cache of cross-query micro-batching
(``CubeCache``, engine/ragged.py). The reference's cache of compiled
programs (its hit/miss counters, the ``cache=hit|miss`` span attribute,
the retrace detector and the donated accumulators) has no counterpart:
building a torch kernel function compiles nothing.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..engine.tier import global_tier
from ..utils.devmem import global_device_memory, nbytes_of
from ..utils.metrics import global_metrics

MAX_ENTRIES = 512


class KernelPlanCache:
    def __init__(self, maxsize: int = MAX_ENTRIES):
        self._lock = threading.Lock()
        self._maxsize = maxsize
        self._measured: "OrderedDict[Tuple, float]" = OrderedDict()
        self._overflowed: "OrderedDict[Tuple, bool]" = OrderedDict()

    def _put(self, d: OrderedDict, key: Tuple, value: Any) -> None:
        # caller holds self._lock
        d[key] = value
        d.move_to_end(key)
        while len(d) > self._maxsize:
            d.popitem(last=False)

    @staticmethod
    def _measured_key(plan, bucket: int, segment, params) -> Tuple:
        """KernelPlan hoists literals into params, so two queries that
        differ only in a literal (WHERE f <= 1 vs f <= 99), or identical
        plans on different tables, share the plan object. The key
        therefore carries the segment's identity and a params
        fingerprint: one query's measured selectivity must never set
        another's capacity."""
        seg_id = getattr(segment, "uid", None) \
            or getattr(segment, "name", None)
        fp = []
        for p in params or ():
            if isinstance(p, np.ndarray):
                fp.append((str(p.dtype), p.shape, p.tobytes()))
            else:
                fp.append(repr(p))  # scalars + ("dictvals", col) markers
        return (plan, bucket, seg_id, tuple(fp))

    def record_measured(self, plan, bucket: int, matched: int, rows: int,
                        segment=None, params=None) -> None:
        """A run's measured selectivity (matched / live rows): the
        executor's post-run feedback write."""
        if not rows:
            return
        key = self._measured_key(plan, bucket, segment, params)
        with self._lock:
            self._put(self._measured, key, int(matched) / int(rows))

    def measured_for(self, plan, bucket: int, segment=None,
                     params=None) -> Optional[float]:
        """The last measured selectivity of this exact (plan, bucket,
        segment, literal params), or None before its first run."""
        key = self._measured_key(plan, bucket, segment, params)
        with self._lock:
            return self._measured.get(key)

    def mark_overflowed(self, plan, bucket: int, slots_cap) -> None:
        """This capacity overflowed for this plan (the executor's retry
        ladder)."""
        with self._lock:
            self._put(self._overflowed, (plan, bucket, slots_cap), True)

    def overflowed(self, plan, bucket: int, slots_cap) -> bool:
        with self._lock:
            return self._overflowed.get((plan, bucket, slots_cap), False)

    def clear(self) -> None:
        with self._lock:
            self._measured.clear()
            self._overflowed.clear()


class CubeCache:
    """(cube spec, segment uid) -> the device-resident literal-free cube of
    engine/ragged.py. Queries sharing a plan structure differ only in
    their literal params, so one unmasked group-by over the union of the
    predicate and group dimensions answers all of them. Keyed by the
    segment's process-unique load uid (names recur across tables and
    reloads; uids never do), so a reload never serves stale cells; the
    name rides along for ``evict_containing``.

    A cube is published only once its build has completed on the device
    (engine/ragged._build_cube fences before returning), so a reader on
    any thread or stream sees finished cells. Neither the cache's lock
    nor a build runs inside the other: builds take the segment's and the
    tier's locks, and a demotion calls ``evict_containing`` from inside
    the tier, so ``global_tier.enforce`` is called outside this lock."""

    def __init__(self, maxsize: int = 16):
        self._entries: "OrderedDict[Tuple, Dict[str, torch.Tensor]]" = \
            OrderedDict()
        # (spec, uid tuple, name tuple) -> {name: [S, ...]} stacked cubes:
        # a warm fused dispatch would otherwise re-stack every cube
        self._stacked: "OrderedDict[Tuple, Dict[str, torch.Tensor]]" = \
            OrderedDict()
        # key -> Event while a build is in flight: concurrent leaders
        # missing the same key must not each run the full segment scan
        self._building: Dict[Tuple, threading.Event] = {}
        self._maxsize = maxsize
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def entry(self, spec, segment, build_fn) -> Dict[str, torch.Tensor]:
        key = (spec, segment.uid, segment.name)
        while True:
            with self._lock:
                hit = self._entries.get(key)
                if hit is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    waiting = None
                else:
                    waiting = self._building.get(key)
                    if waiting is None:
                        self._building[key] = threading.Event()
                        self.misses += 1
            if hit is not None:
                global_metrics.count("cube_cache_hits")
                return hit
            if waiting is None:
                break               # this thread builds
            # another leader is scanning this segment: wait for its cube
            # (on its failure the loop re-enters and this thread builds)
            waiting.wait(timeout=600)
        global_metrics.count("cube_cache_misses")
        try:
            built = build_fn()
        except BaseException:
            with self._lock:
                ev = self._building.pop(key, None)
            if ev is not None:
                ev.set()
            raise
        with self._lock:
            # publish before signalling: a woken waiter must find the entry
            built = self._entries.setdefault(key, built)
            global_device_memory.add("cube_cache", key, nbytes_of(built))
            self._entries.move_to_end(key)
            while len(self._entries) > self._maxsize:
                old_key, _old = self._entries.popitem(last=False)
                global_device_memory.remove("cube_cache", old_key)
            global_metrics.gauge("cube_cache_entries", len(self._entries))
            ev = self._building.pop(key, None)
        if ev is not None:
            ev.set()
        # shared-budget admission outside self._lock: the cube is a new
        # device resident charged to the one budget
        global_tier.enforce(protect={segment.uid})
        return built

    def stacked(self, spec, segments, per_segment: List[Dict[str, Any]]
                ) -> Dict[str, torch.Tensor]:
        """{name: [S, ...]} stack of the given segments' cubes, cached by
        (spec, uid tuple) so a warm fused dispatch copies nothing.
        ``per_segment`` are the ``entry`` results for the same segments,
        in order."""
        key = (spec, tuple(s.uid for s in segments),
               tuple(s.name for s in segments))
        with self._lock:
            hit = self._stacked.get(key)
            if hit is not None:
                self._stacked.move_to_end(key)
                return hit
        stacked = {name: torch.stack([c[name] for c in per_segment])
                   for name in per_segment[0]}
        with self._lock:
            stacked = self._stacked.setdefault(key, stacked)
            global_device_memory.add("cube_stacked", key,
                                     nbytes_of(stacked))
            self._stacked.move_to_end(key)
            while len(self._stacked) > self._maxsize:
                old_key, _old = self._stacked.popitem(last=False)
                global_device_memory.remove("cube_stacked", old_key)
        global_tier.enforce(protect={s.uid for s in segments})
        return stacked

    def resident_uids(self) -> set:
        """Segment uids with a resident per-segment cube: the placement
        signal a server node's residency heartbeat reports."""
        with self._lock:
            return {k[1] for k in self._entries}

    def evict_containing(self, segment_name: str) -> None:
        with self._lock:
            for key in [k for k in self._entries if k[2] == segment_name]:
                del self._entries[key]
                global_device_memory.remove("cube_cache", key)
            for key in [k for k in self._stacked if segment_name in k[2]]:
                del self._stacked[key]
                global_device_memory.remove("cube_stacked", key)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._entries),
                    "stacked": len(self._stacked)}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._stacked.clear()
            self.hits = 0
            self.misses = 0
        global_device_memory.drop_pool("cube_cache")
        global_device_memory.drop_pool("cube_stacked")


global_plan_cache = KernelPlanCache()
global_cube_cache = CubeCache()
