"""Metrics: counters and gauges in one global registry.

Port of the subset of ``pinot_tpu/utils/metrics.py`` that the device
memory plane uses: ``count``, ``gauge``, ``snapshot`` and ``clear``. The
timers, the gauge ages and the Prometheus rendering come with the slices
that read them.
"""
from __future__ import annotations

import threading
from typing import Any, Dict


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges)}

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


global_metrics = MetricsRegistry()
