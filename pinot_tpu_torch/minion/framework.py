"""Minion task framework: specs, executor registry, worker, generators.

Reference parity: pinot-minion/.../executor/ (PinotTaskExecutor +
TaskExecutorFactoryRegistry — executors registered by task type and
instantiated per task) and pinot-controller/.../helix/core/minion/
PinotTaskManager (periodic generators scan table state and emit task
configs; Helix task framework runs them on minions). Here the queue is
in-process, the worker is a thread, and task state is tracked on the spec
(Helix workflow states analog).

Port of ``pinot_tpu/minion/framework.py``.
"""
from __future__ import annotations

import enum
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..server.data_manager import TableDataManager
from ..utils.metrics import global_metrics


class TaskState(enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"


@dataclass
class TaskSpec:
    task_type: str
    table: str
    config: Dict[str, Any] = field(default_factory=dict)
    task_id: str = field(default_factory=lambda: uuid.uuid4().hex[:12])
    state: TaskState = TaskState.PENDING
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    created_at: float = field(default_factory=time.time)


@dataclass
class MinionContext:
    """What executors get to work with: the table registry plus scratch
    space for built segments (deep-store working dir analog)."""
    tables: Dict[str, TableDataManager]
    out_dir: str
    # offline counterpart tables for RealtimeToOffline (hybrid tables)
    offline_tables: Dict[str, TableDataManager] = field(default_factory=dict)

    def table(self, name: str) -> TableDataManager:
        if name not in self.tables:
            raise KeyError(f"table {name!r} not registered with minion")
        return self.tables[name]


# executor: (spec, context) -> result dict
TaskExecutorFn = Callable[[TaskSpec, MinionContext], Dict[str, Any]]

_EXECUTORS: Dict[str, TaskExecutorFn] = {}


def register_task_executor(task_type: str, fn: TaskExecutorFn) -> None:
    _EXECUTORS[task_type] = fn


def task_executor_types() -> List[str]:
    return sorted(_EXECUTORS)


class MinionWorker:
    """Pulls pending tasks and executes them (one at a time, like a
    single-threaded minion instance)."""

    def __init__(self, context: MinionContext):
        self.context = context
        self._queue: List[TaskSpec] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.history: List[TaskSpec] = []

    def submit(self, spec: TaskSpec) -> TaskSpec:
        if spec.task_type not in _EXECUTORS:
            raise ValueError(f"no executor for task type {spec.task_type!r}; "
                             f"have {task_executor_types()}")
        with self._lock:
            self._queue.append(spec)
        return spec

    def run_once(self) -> Optional[TaskSpec]:
        """Execute the next pending task synchronously; None if idle."""
        with self._lock:
            spec = self._queue.pop(0) if self._queue else None
        if spec is None:
            return None
        spec.state = TaskState.RUNNING
        global_metrics.count(f"minion_task_{spec.task_type}")
        try:
            spec.result = _EXECUTORS[spec.task_type](spec, self.context)
            spec.state = TaskState.COMPLETED
        except Exception as e:  # noqa: BLE001 — task failure is task state
            spec.state = TaskState.FAILED
            spec.error = f"{type(e).__name__}: {e}"
            spec.result = {"traceback": traceback.format_exc()}
            global_metrics.count("minion_task_failures")
        self.history.append(spec)
        return spec

    def drain(self) -> List[TaskSpec]:
        done = []
        while True:
            spec = self.run_once()
            if spec is None:
                return done
            done.append(spec)

    def start(self, poll_interval: float = 0.2) -> None:
        def loop():
            while not self._stop.wait(poll_interval):
                while self.run_once() is not None:
                    pass
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


# task generator: context -> list of TaskSpec (PinotTaskGenerator analog)
TaskGeneratorFn = Callable[[MinionContext], List[TaskSpec]]


class TaskManager:
    """Controller-side: periodic generators emit tasks into the worker
    (PinotTaskManager + generator registry analog)."""

    def __init__(self, worker: MinionWorker):
        self.worker = worker
        self._generators: List[TaskGeneratorFn] = []

    def register_generator(self, fn: TaskGeneratorFn) -> None:
        self._generators.append(fn)

    def generate_and_submit(self) -> List[TaskSpec]:
        out = []
        for gen in self._generators:
            for spec in gen(self.worker.context):
                out.append(self.worker.submit(spec))
        return out


# -- built-in generators -----------------------------------------------------

def merge_rollup_generator(min_small_segments: int = 3,
                           small_segment_rows: int = 1 << 16,
                           **task_config) -> TaskGeneratorFn:
    """Emit a MergeRollupTask when a table accumulates enough small
    segments (MergeRollupTaskGenerator analog)."""

    def gen(ctx: MinionContext) -> List[TaskSpec]:
        out = []
        for name, dm in ctx.tables.items():
            small = [s for s in dm.acquire_segments()
                     if s.n_docs < small_segment_rows]
            if len(small) >= min_small_segments:
                cfg = dict(task_config)
                cfg["segments"] = [s.name for s in small]
                out.append(TaskSpec("MergeRollupTask", name, cfg))
        return out
    return gen


def upsert_compaction_generator(invalid_fraction: float = 0.3,
                                **task_config) -> TaskGeneratorFn:
    """Emit an UpsertCompactionTask for segments whose invalid-doc fraction
    crosses the threshold (UpsertCompactionTaskGenerator analog)."""

    def gen(ctx: MinionContext) -> List[TaskSpec]:
        out = []
        for name, dm in ctx.tables.items():
            worth = []
            for s in dm.acquire_segments():
                vd = getattr(s, "valid_docs", None)
                if vd is not None and s.n_docs and \
                        1.0 - vd[: s.n_docs].mean() >= invalid_fraction:
                    worth.append(s.name)
            if worth:
                cfg = dict(task_config)
                cfg["segments"] = worth
                out.append(TaskSpec("UpsertCompactionTask", name, cfg))
        return out
    return gen
