"""Query scheduler: admission control + ordered execution of query jobs.

Reference parity: pinot-core/.../query/scheduler/QueryScheduler.java:93
(submit -> ListenableFuture of serialized response), QuerySchedulerFactory
.java:45-47 (fcfs | prioritized by config key `query.scheduler.name`), and
the multi-level PriorityScheduler with per-group resource accounting
(scheduler/resources/). TPU-native shape: one query = a few large XLA
launches, so the scheduler's job is admission (bound concurrent queries so
device/HBM pressure stays sane) and ordering (priority queues per
workload), not thread juggling; execution itself stays in the caller's
callable.

Port of ``pinot_tpu/engine/scheduler.py``.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional

from ..query.sql import SqlError
from ..utils.metrics import global_metrics
from .accounting import ResourceAccountant, global_accountant


class SchedulerRejectedError(SqlError):
    """Queue full — the 'server busy, scheduler rejected' analog
    (Pinot's SERVER_OUT_OF_CAPACITY, error code 211). A ``SqlError``
    (not a bare RuntimeError) so it can never escape the HTTP plane as
    a 500: cluster/http_util.JsonHandler renders any exception carrying
    ``error_code``/``retry_after_ms`` as structured retryable JSON, and
    the broker/server query handlers surface it the same way the
    overload sheds are surfaced (broker/workload.OverloadShedError)."""

    error_code = 211  # broker/workload.ERR_SERVER_OUT_OF_CAPACITY

    def __init__(self, msg: str, retry_after_ms: int = 200):
        super().__init__(msg)
        self.retry_after_ms = int(retry_after_ms)

    def payload(self):
        return {"error": str(self), "errorCode": self.error_code,
                "retryAfterMs": self.retry_after_ms}


class _Job:
    __slots__ = ("fn", "future", "query_id", "priority", "seq")

    def __init__(self, fn, future, query_id, priority, seq):
        self.fn = fn
        self.future = future
        self.query_id = query_id
        self.priority = priority
        self.seq = seq


class QueryScheduler:
    """Base: worker pool draining an ordered queue.

    FCFS = single priority level (arrival order); PriorityScheduler orders
    by (priority, arrival). Both bound the queue (admission control).
    """

    name = "fcfs"

    def __init__(self, num_workers: int = 4, max_pending: int = 64,
                 accountant: Optional[ResourceAccountant] = None):
        self.accountant = accountant or global_accountant
        self.max_pending = max_pending
        self._heap: list = []
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._stopped = False
        self._workers = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(num_workers)]
        for w in self._workers:
            w.start()
        self.started = time.time()

    # -- submission --------------------------------------------------------
    def _priority_of(self, priority: int) -> int:
        return 0  # FCFS: arrival order only

    def submit(self, fn: Callable[[], Any], query_id: str,
               priority: int = 0) -> "Future[Any]":
        """Enqueue a query callable; returns a Future (QueryScheduler.submit
        ListenableFuture analog). Raises SchedulerRejectedError when the
        pending queue is full."""
        future: Future = Future()
        job = _Job(fn, future, query_id, self._priority_of(priority),
                   next(self._seq))
        with self._lock:
            if self._stopped:
                raise SchedulerRejectedError("scheduler stopped")
            if len(self._heap) >= self.max_pending:
                global_metrics.count("scheduler_rejected")
                # retryAfterMs scales with the backlog: a full queue of
                # short queries drains in tens of ms per entry
                raise SchedulerRejectedError(
                    f"{len(self._heap)} queries pending >= "
                    f"{self.max_pending}",
                    retry_after_ms=50 + 10 * len(self._heap))
            heapq.heappush(self._heap, (job.priority, job.seq, job))
            self._work.notify()
        return future

    def execute(self, fn: Callable[[], Any], query_id: str,
                priority: int = 0, timeout_s: Optional[float] = None) -> Any:
        return self.submit(fn, query_id, priority).result(timeout=timeout_s)

    # -- workers -----------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._heap and not self._stopped:
                    self._work.wait()
                if self._stopped and not self._heap:
                    return
                _, _, job = heapq.heappop(self._heap)
            if not job.future.set_running_or_notify_cancel():
                continue
            self.accountant.attach_thread(job.query_id)
            try:
                job.future.set_result(job.fn())
            except BaseException as e:  # noqa: BLE001 — future carries it
                job.future.set_exception(e)

    def pending(self) -> int:
        with self._lock:
            return len(self._heap)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            self._work.notify_all()


class _Bucket:
    __slots__ = ("items", "weight", "cond", "closed")

    def __init__(self, cond):
        self.items: list = []
        self.weight = 0
        self.cond = cond
        self.closed = False


class MicroBatchQueue:
    """Cross-query micro-batch admission window — the
    scheduler grown beyond FCFS/priority ordering: instead of ordering
    independent jobs, it COLLECTS compatible in-flight submissions.

    The first ``offer`` for a compatibility key becomes the *leader*:
    it holds the admission window open (``window_s``) and returns every
    submission that arrived for the key — its own included — once the
    window expires or the batch fills (``max_items`` submissions or
    ``max_weight`` total weight). Later offers for an open key are
    *followers*: ``offer`` returns None immediately and the follower
    waits on whatever completion handle it attached to its item (the
    RaggedBatcher uses a Future). A key whose leader is already
    executing starts a fresh bucket, so submissions are never blocked
    behind a dispatch in flight.
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
                    # admitting this item would blow the weight budget
                    # (a hard resource bound, not a target): close the
                    # bucket for its leader and lead a fresh one below
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


class FcfsScheduler(QueryScheduler):
    name = "fcfs"


class PriorityScheduler(QueryScheduler):
    """Lower priority value runs first; queries of equal priority are FCFS
    (multi-level queue analog of scheduler/PriorityScheduler.java)."""

    name = "priority"

    def _priority_of(self, priority: int) -> int:
        return priority


def make_scheduler(config: Optional[Dict[str, Any]] = None) -> QueryScheduler:
    """QuerySchedulerFactory.java:45-47 analog: pick by
    `query.scheduler.name`."""
    cfg = config or {}
    name = str(cfg.get("query.scheduler.name", "fcfs")).lower()
    workers = int(cfg.get("query.scheduler.workers", 4))
    pending = int(cfg.get("query.scheduler.max_pending", 64))
    cls = {"fcfs": FcfsScheduler, "priority": PriorityScheduler}.get(name)
    if cls is None:
        raise ValueError(f"unknown scheduler {name!r}; use fcfs|priority")
    return cls(num_workers=workers, max_pending=pending)
