"""Periodic task framework for the controller.

Reference parity: pinot-core/.../periodictask/{BasePeriodicTask,
PeriodicTaskScheduler}.java — named tasks with an interval and an
initial delay, run serially by a scheduler thread, with manual
run-now triggering (the controller REST /periodictask/run analog).

Port of ``pinot_tpu/cluster/periodic.py``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional


class BasePeriodicTask:
    """Subclass or wrap a callable; run() must be idempotent — the
    scheduler may invoke it concurrently with a manual trigger only if
    the subclass opts out of the serial lock."""

    def __init__(self, name: str, interval_s: float,
                 fn: Optional[Callable[[], None]] = None,
                 initial_delay_s: float = 0.0):
        self.name = name
        self.interval_s = interval_s
        self.initial_delay_s = initial_delay_s
        self._fn = fn
        self._lock = threading.Lock()
        self.run_count = 0
        self.last_error: Optional[str] = None
        self.last_run_ms: float = 0.0

    def run(self) -> None:
        if self._fn is None:
            raise NotImplementedError
        self._fn()

    def run_once(self) -> None:
        """Serialized entry used by the scheduler and manual triggers."""
        with self._lock:
            t0 = time.perf_counter()
            try:
                self.run()
                self.last_error = None
            except Exception as e:  # tasks must not kill the scheduler
                self.last_error = f"{type(e).__name__}: {e}"
            finally:
                self.run_count += 1
                self.last_run_ms = (time.perf_counter() - t0) * 1e3


class PeriodicTaskScheduler:
    def __init__(self):
        self._tasks: Dict[str, BasePeriodicTask] = {}
        self._next_run: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, task: BasePeriodicTask) -> None:
        self._tasks[task.name] = task
        self._next_run[task.name] = time.monotonic() + task.initial_delay_s

    def start(self, tick_s: float = 0.1) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, args=(tick_s,),
                                        daemon=True)
        self._thread.start()

    def _loop(self, tick_s: float) -> None:
        while not self._stop.wait(tick_s):
            now = time.monotonic()
            for name, task in list(self._tasks.items()):
                if now >= self._next_run.get(name, 0.0):
                    self._next_run[name] = now + task.interval_s
                    task.run_once()

    def trigger(self, name: str) -> bool:
        """Run a task now (controller REST /periodictask/run analog)."""
        task = self._tasks.get(name)
        if task is None:
            return False
        task.run_once()
        return True

    def status(self) -> List[Dict[str, object]]:
        return [{"name": t.name, "intervalSeconds": t.interval_s,
                 "runCount": t.run_count, "lastError": t.last_error,
                 "lastRunMs": round(t.last_run_ms, 3)}
                for t in self._tasks.values()]

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
