"""Thread-safe module STATS counters.

Port of ``make_bump`` from ``pinot_tpu/utils/stats.py``. The broker
serves concurrent queries and tests assert exact counter values, so a
bare ``STATS[k] += 1`` could lose increments. Modules declare their dict
and wrap it:

    STATS = {"things": 0}
    bump = make_bump(STATS)
"""
from __future__ import annotations

import threading
from typing import Callable, Dict


def make_bump(stats: Dict[str, int]) -> Callable[[str], None]:
    lock = threading.Lock()

    def bump(key: str) -> None:
        with lock:
            stats[key] += 1

    return bump
