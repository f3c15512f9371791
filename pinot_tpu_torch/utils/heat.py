"""Per-segment access heat: which segments queries actually touch.

Port of ``pinot_tpu/utils/heat.py``. Two recording sites, both host-side:

- ``touch()``: engine/serving.plan_segments, once per (query, executed
  segment): touches and rows scanned, folded into a time-decayed score;
- ``device_access()``: segment/immutable.ImmutableSegment.device_col, per
  column read: whether the padded device tensor was already resident
  (hit) or had to be uploaded (miss).

Entries key on the segment's process-unique load uid (names recur across
tables and reloads) with the name and table carried for display; the
table is a bounded LRU. The decayed scores are the tier's eviction
ranking (engine/tier.py).
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

MAX_ENTRIES = 2048

# time-decayed heat score: each touch adds 1 + rows/ROWS_HEAT_UNIT and the
# accumulated score halves every half-life, so a one-time full scan of a
# big segment cannot pin it hot for the life of the process
DEFAULT_HALF_LIFE_S = 300.0
ROWS_HEAT_UNIT = 1e6


def _env_half_life() -> float:
    try:
        return float(os.environ.get("PINOT_HEAT_HALFLIFE_S",
                                    DEFAULT_HALF_LIFE_S))
    except ValueError:
        return DEFAULT_HALF_LIFE_S


class SegmentHeat:
    def __init__(self, max_entries: int = MAX_ENTRIES,
                 half_life_s: Optional[float] = None):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Any, Dict[str, Any]]" = OrderedDict()
        self._max = max_entries
        self.half_life_s = (half_life_s if half_life_s is not None
                            else _env_half_life())

    @staticmethod
    def _key(segment) -> Any:
        # immutable segments carry the process-unique load uid; anything
        # without one keys by name
        uid = getattr(segment, "uid", None)
        return uid if uid is not None else f"m:{segment.name}"

    def _entry(self, segment) -> Dict[str, Any]:  # holds-lock: _lock
        # caller holds self._lock
        key = self._key(segment)
        e = self._entries.get(key)
        if e is None:
            e = {"segment": segment.name, "table": None, "touches": 0,
                 "rows_scanned": 0, "device_hits": 0, "device_misses": 0,
                 "last_touch": 0.0, "heat": 0.0, "heat_ts": 0.0}
            self._entries[key] = e
        self._entries.move_to_end(key)
        while len(self._entries) > self._max:
            self._entries.popitem(last=False)
        return e

    def _decayed(self, e: Dict[str, Any], now: float) -> float:
        """Entry heat decayed to ``now`` (pure read; 2**-dt/half_life)."""
        dt = now - e["heat_ts"]
        if dt <= 0 or not e["heat"]:
            return e["heat"]
        return e["heat"] * 2.0 ** (-dt / self.half_life_s)

    def touch(self, segment, table: Optional[str], rows: int,
              now: Optional[float] = None) -> None:
        """One query executed (kernel or host plan) over this segment.
        ``now`` pins the decay clock for deterministic tests."""
        now = time.time() if now is None else now
        with self._lock:
            e = self._entry(segment)
            if table:
                e["table"] = table
            e["touches"] += 1
            e["rows_scanned"] += int(rows)
            e["last_touch"] = now
            # fold the elapsed decay in at write time, then add this touch
            e["heat"] = self._decayed(e, now) + 1.0 + rows / ROWS_HEAT_UNIT
            e["heat_ts"] = now

    def device_access(self, segment, hit: bool) -> None:
        """One padded-column device read: resident (hit) or uploaded. The
        warm case skips the LRU bookkeeping; touch() refreshes recency."""
        key = self._key(segment)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entry(segment)
            e["device_hits" if hit else "device_misses"] += 1

    def scores(self, now: Optional[float] = None) -> Dict[Any, float]:
        """{entry key: decayed heat score at ``now``}: the ranking the
        tier's coldest-first demotion sorts by."""
        now = time.time() if now is None else now
        with self._lock:
            return {k: self._decayed(e, now)
                    for k, e in self._entries.items()}

    def snapshot(self, top: Optional[int] = None) -> List[Dict[str, Any]]:
        """Heat table sorted hottest-first (touches, then rows scanned),
        each row with its device-cache hit ratio and decayed score."""
        now = time.time()
        with self._lock:
            rows = [dict(e) for e in self._entries.values()]
        rows.sort(key=lambda e: (-e["touches"], -e["rows_scanned"],
                                 e["segment"]))
        if top is not None:
            rows = rows[: max(top, 0)]
        for e in rows:
            acc = e["device_hits"] + e["device_misses"]
            e["device_hit_ratio"] = round(e["device_hits"] / acc, 4) \
                if acc else None
            e["last_touch"] = round(e["last_touch"], 3)
            dt = now - e.pop("heat_ts")
            e["heat"] = round(e["heat"] * 2.0 ** (-max(dt, 0.0)
                                                  / self.half_life_s), 4) \
                if e["heat"] else 0.0
        return rows

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


global_segment_heat = SegmentHeat()
