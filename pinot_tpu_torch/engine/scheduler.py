"""Micro-batch admission: the window that collects concurrent queries.

Port of ``MicroBatchQueue`` and ``_Bucket`` from
``pinot_tpu/engine/scheduler.py``. The FCFS and priority
``QueryScheduler`` family of that module serves the cluster's server
node and comes with the slice that ports it.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional


class _Bucket:
    __slots__ = ("items", "weight", "cond", "closed")

    def __init__(self, cond):
        self.items: list = []
        self.weight = 0
        self.cond = cond
        self.closed = False


class MicroBatchQueue:
    """Cross-query micro-batch admission window.

    The first ``offer`` for a compatibility key becomes the *leader*: it
    holds the window open (``window_s``) and returns every submission that
    arrived for the key, its own included, once the window expires or the
    batch fills (``max_items`` submissions or ``max_weight`` total
    weight). Later offers for an open key are *followers*: ``offer``
    returns None at once and the follower waits on whatever completion
    handle it attached to its item (engine/ragged.py uses a Future). A key
    whose leader is already executing starts a fresh bucket, so no
    submission waits behind a dispatch in flight.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: Dict[Any, _Bucket] = {}

    def depth(self) -> int:
        with self._lock:
            return sum(len(b.items) for b in self._buckets.values())

    def offer(self, key: Any, item: Any, window_s: float,
              max_items: int, max_weight: Optional[int] = None,
              weight: int = 1) -> Optional[list]:
        """-> the closed batch (leader) or None (follower)."""
        with self._lock:
            b = self._buckets.get(key)
            if b is not None and not b.closed:
                if max_weight is not None and b.items \
                        and b.weight + weight > max_weight:
                    # admitting this item would exceed the weight budget
                    # (a hard bound): close the bucket for its leader and
                    # lead a fresh one below
                    b.closed = True
                    b.cond.notify_all()
                    if self._buckets.get(key) is b:
                        del self._buckets[key]
                else:
                    b.items.append(item)
                    b.weight += weight
                    if len(b.items) >= max_items or (
                            max_weight is not None
                            and b.weight >= max_weight):
                        b.closed = True
                        b.cond.notify_all()
                    return None
            b = _Bucket(threading.Condition(self._lock))
            b.items.append(item)
            b.weight += weight
            self._buckets[key] = b
            deadline = time.monotonic() + window_s
            while not b.closed:
                rem = deadline - time.monotonic()
                if rem <= 0 or len(b.items) >= max_items or (
                        max_weight is not None and b.weight >= max_weight):
                    break
                b.cond.wait(rem)
            b.closed = True
            if self._buckets.get(key) is b:
                del self._buckets[key]
            return list(b.items)
