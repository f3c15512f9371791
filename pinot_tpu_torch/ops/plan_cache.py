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

The retrace detector, donated accumulators and the cube cache come with
the micro-batching slice.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional, Tuple

import numpy as np

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


global_plan_cache = KernelPlanCache()
