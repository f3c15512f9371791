"""Tracing: per-request phase timings and operator stats.

Port of ``pinot_tpu/utils/trace.py``.
Reference parity: pinot-spi/.../trace/Tracing.java (global tracer
registry, request registration) + BuiltInTracer per-operator timings when
the query sets trace=true, and the phase timers of
ServerQueryExecutorV1Impl.java:154-159 (ServerQueryPhase). Python-native:
a thread-local request scope; `with scope.phase("planning"):` records
wall-ms; operators attach counters (docs scanned, segments matched). The
scope serializes into the response envelope when tracing is on.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional


class RequestScope:
    def __init__(self, query_id: str, enabled: bool = True):
        self.query_id = query_id
        self.enabled = enabled
        self.phases: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}
        self._t0 = time.perf_counter()

    @contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + \
                (time.perf_counter() - t0) * 1e3

    def count(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self.counters[name] = self.counters.get(name, 0) + n

    def to_dict(self) -> Dict[str, Any]:
        return {
            "queryId": self.query_id,
            "totalMs": (time.perf_counter() - self._t0) * 1e3,
            "phases": {k: round(v, 3) for k, v in self.phases.items()},
            "counters": dict(self.counters),
        }


class _Tracing:
    """Global registry with a thread-local active scope."""

    def __init__(self):
        self._local = threading.local()

    def register(self, query_id: str, enabled: bool = True) -> RequestScope:
        scope = RequestScope(query_id, enabled)
        self._local.scope = scope
        return scope

    def active(self) -> Optional[RequestScope]:
        return getattr(self._local, "scope", None)

    @contextmanager
    def phase(self, name: str):
        scope = self.active()
        if scope is None:
            yield
            return
        with scope.phase(name):
            yield

    def count(self, name: str, n: int = 1) -> None:
        scope = self.active()
        if scope is not None:
            scope.count(name, n)

    def unregister(self) -> None:
        self._local.scope = None


Tracing = _Tracing()
