"""Per-query resource accounting and query killing.

Port of ``pinot_tpu/engine/accounting.py``: a process-global registry of
running queries (thread -> query), with per-query host-memory totals, a
deadline, and a kill flag. ``sample()`` is the interrupt check:
the engine calls it between per-segment launches and dispatch groups
(engine/batch.py, engine/pipeline.py, engine/executor.py), and it raises
``QueryKilledError`` on the query's own thread once the query was killed
or its deadline passed. The broker registers every query it executes and
turns a deadline kill into ``QueryTimeoutError``; the cross-query
micro-batcher (engine/ragged.py) reads ``running()`` to decide whether
any peer exists to fuse with.

Left out (ROADMAP Queue 3): the fault plane's ``accounting.oom_kill``
point inside ``sample`` and the tenant budgets fed from ``unregister``
(``broker/workload.py``), neither of which the port has; without a
workload manager a query has no tenant or tier, and
``kill_most_expensive`` ranks every running query alike. The SQL text
the JAX package keeps for its compile forensics is not kept either, nor
the per-thread CPU time it adds up at every sample point: the port has
no consumer for it, and on the H100's host a per-thread CPU clock read
costs tens of microseconds in the middle of a query (chip_smoke.py's
``hooks`` phase prints it), ten reads a query on 8 segments.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..query.sql import SqlError
from ..utils.metrics import global_metrics


class QueryKilledError(SqlError):
    """Raised inside the query's own execution path after a kill flag.
    ``is_deadline`` tells a timeout from an operator or watcher kill."""

    def __init__(self, msg: str, is_deadline: bool = False):
        super().__init__(msg)
        self.is_deadline = is_deadline


_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def process_rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        return 0


@dataclass
class QueryUsage:
    query_id: str
    start: float = field(default_factory=time.perf_counter)
    deadline: Optional[float] = None
    mem_bytes: int = 0
    killed_reason: Optional[str] = None
    # fused dispatches this query rode (engine/ragged.py) and the largest
    # batch it shared
    batched_dispatches: int = 0
    max_batch_size: int = 0

    @property
    def wall_s(self) -> float:
        return time.perf_counter() - self.start

    def cost(self) -> float:
        """Kill ordering: tracked memory first, wall time breaks ties."""
        return self.mem_bytes + self.wall_s * 1e6


class ResourceAccountant:
    """Global registry: thread -> running query, with kill and timeout
    checks at sample points."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_query: Dict[str, QueryUsage] = {}
        self._by_thread: Dict[int, str] = {}

    # -- registration ------------------------------------------------------
    def register(self, query_id: str,
                 deadline: Optional[float] = None) -> QueryUsage:
        u = QueryUsage(query_id, deadline=deadline)
        with self._lock:
            self._by_query[query_id] = u
            self._by_thread[threading.get_ident()] = query_id
        return u

    def attach_thread(self, query_id: str) -> None:
        """A worker thread executing on behalf of a query calls this so
        its sample points check that query."""
        with self._lock:
            if query_id in self._by_query:
                self._by_thread[threading.get_ident()] = query_id

    def unregister(self, query_id: str) -> Optional[QueryUsage]:
        with self._lock:
            u = self._by_query.pop(query_id, None)
            for tid in [t for t, q in self._by_thread.items()
                        if q == query_id]:
                del self._by_thread[tid]
        return u

    def usage(self, query_id: str) -> Optional[QueryUsage]:
        with self._lock:
            return self._by_query.get(query_id)

    def current_query_id(self) -> Optional[str]:
        """The query this thread is executing on behalf of, if any."""
        with self._lock:
            return self._by_thread.get(threading.get_ident())

    def running(self) -> List[QueryUsage]:
        with self._lock:
            return list(self._by_query.values())

    # -- hot-loop hooks ----------------------------------------------------
    def sample(self) -> None:
        """Call between per-segment launches: raises if the query this
        thread runs was killed or is past its deadline."""
        with self._lock:
            qid = self._by_thread.get(threading.get_ident())
            u = self._by_query.get(qid) if qid else None
        if u is None:
            return
        if u.killed_reason is not None:
            raise QueryKilledError(
                f"query {u.query_id} killed: {u.killed_reason}")
        if u.deadline is not None and time.perf_counter() > u.deadline:
            global_metrics.count("query_deadline_kills")
            raise QueryKilledError(
                f"query {u.query_id} killed: deadline exceeded",
                is_deadline=True)

    def note_batched(self, query_id: str, batch_size: int) -> None:
        """A fused dispatch included this query (the leader annotates
        every participant, hence the lock)."""
        with self._lock:
            u = self._by_query.get(query_id)
            if u is not None:
                u.batched_dispatches += 1
                u.max_batch_size = max(u.max_batch_size, int(batch_size))

    def track_memory(self, nbytes: int) -> None:
        tid = threading.get_ident()
        with self._lock:
            qid = self._by_thread.get(tid)
            u = self._by_query.get(qid) if qid else None
            if u is not None:
                u.mem_bytes += max(int(nbytes), 0)

    def track_memory_for(self, query_id: str, nbytes: int) -> None:
        """Bytes charged to a named query whatever the calling thread: a
        fused leader apportions the batch's host outputs per
        participant."""
        with self._lock:
            u = self._by_query.get(query_id)
            if u is not None:
                u.mem_bytes += max(int(nbytes), 0)

    def track_result(self, host: Dict[str, Any]) -> None:
        """The post-execution fence: size a kernel's host output dict
        once, after its transfer. Every dispatch path accounts through
        here."""
        self.track_memory(sum(np.asarray(v).nbytes for v in host.values()))

    def set_deadline(self, query_id: str, deadline: Optional[float]) -> None:
        with self._lock:
            u = self._by_query.get(query_id)
            if u is not None:
                u.deadline = deadline

    # -- killing -----------------------------------------------------------
    def kill(self, query_id: str, reason: str) -> bool:
        with self._lock:
            u = self._by_query.get(query_id)
        if u is None:
            return False
        u.killed_reason = reason
        global_metrics.count("queries_killed")
        return True

    def kill_most_expensive(self, reason: str) -> Optional[str]:
        """Flag the running query with the highest ``cost`` (none of the
        reference's tenant tiers: every query is untiered here)."""
        candidates = [u for u in self.running() if u.killed_reason is None]
        if not candidates:
            return None
        victim = max(candidates, key=QueryUsage.cost)
        victim.killed_reason = reason
        global_metrics.count("queries_killed")
        return victim.query_id


class HeapWatcher:
    """Background memory-pressure watcher: when the process RSS crosses
    the panic share of its limit, kill the most expensive running
    query."""

    def __init__(self, accountant: ResourceAccountant,
                 rss_limit_bytes: int, panic_fraction: float = 0.9,
                 interval_s: float = 0.2):
        self.accountant = accountant
        self.rss_limit = int(rss_limit_bytes)
        self.panic = panic_fraction
        self.interval = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.kills = 0

    def start(self) -> "HeapWatcher":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.check_once()

    def check_once(self) -> Optional[str]:
        rss = process_rss_bytes()
        if self.rss_limit and rss > self.rss_limit * self.panic:
            victim = self.accountant.kill_most_expensive(
                f"heap pressure: rss {rss >> 20}MiB > "
                f"{int(self.rss_limit * self.panic) >> 20}MiB")
            if victim is not None:
                self.kills += 1
                global_metrics.count("queries_killed_oom")
            return victim
        return None

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


global_accountant = ResourceAccountant()
