"""Thread-safe module STATS counters.

Port of ``pctl`` and ``make_bump`` from ``pinot_tpu/utils/stats.py``. The broker
serves concurrent queries and tests assert exact counter values, so a
bare ``STATS[k] += 1`` could lose increments. Modules declare their dict
and wrap it:

    STATS = {"things": 0}
    bump = make_bump(STATS)
"""
from __future__ import annotations

import threading
from typing import Callable, Dict


def pctl(sorted_vals, frac: float) -> float:
    """The one fleet percentile definition (p50 = s[n//2], p99 =
    s[min(n-1, int(n*0.99))]): cluster/rollup's fleet aggregation uses
    it, as the reference's metrics snapshots do, so trend lines stay
    comparable."""
    if not sorted_vals:
        return 0.0
    if frac == 0.5:
        return sorted_vals[len(sorted_vals) // 2]
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(len(sorted_vals) * frac))]


def make_bump(stats: Dict[str, int]) -> Callable[[str], None]:
    lock = threading.Lock()

    def bump(key: str) -> None:
        with lock:
            stats[key] += 1

    return bump
