"""Per-table query quotas (QPS rate limiting at the broker).

Reference parity: pinot-broker/.../queryquota/
HelixExternalViewBasedQueryQuotaManager.java — per-table max QPS from
table config, enforced with a token bucket at each broker; queries over
quota are rejected up front (BrokerMeter.QUERY_QUOTA_EXCEEDED). The
reference divides the table quota by the number of LIVE brokers (its
``processQueryRateLimitingExternalViewChange`` recomputes the per-broker
rate whenever the broker resource's external view changes); here the
divisor is refreshed the same way from the controller's heartbeat-fresh
broker list (``routing_snapshot()["liveBrokers"]``;
brokers register+heartbeat like servers), via ``set_num_brokers`` on
every quota check. A standalone in-process broker keeps the divisor at
its default of 1.

Port of ``pinot_tpu/broker/quota.py``. The per-broker divisor follows
the cluster's live broker count through ``set_num_brokers``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..query.sql import SqlError


class QuotaExceededError(SqlError):
    pass


class _TokenBucket:
    def __init__(self, qps: float, burst: Optional[float] = None):
        self.qps = float(qps)
        self.capacity = burst if burst is not None else max(self.qps, 1.0)
        self.tokens = self.capacity
        self.t0 = time.monotonic()

    def try_acquire(self) -> bool:
        now = time.monotonic()
        self.tokens = min(self.capacity,
                          self.tokens + (now - self.t0) * self.qps)
        self.t0 = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def rescale(self, qps: float) -> None:
        """Change the rate IN PLACE, preserving the spent fraction of
        the burst. A live-broker-count change must not mint a fresh
        full burst — heartbeat flapping would otherwise let a client
        sustain a multiple of the configured QPS by cashing a new
        bucket on every flip."""
        now = time.monotonic()
        self.tokens = min(self.capacity,
                          self.tokens + (now - self.t0) * self.qps)
        self.t0 = now
        frac = self.tokens / self.capacity if self.capacity else 0.0
        self.qps = float(qps)
        self.capacity = max(self.qps, 1.0)
        self.tokens = frac * self.capacity


class QueryQuotaManager:
    """table -> token bucket, built from table config quotaQps divided
    by the live broker count."""

    def __init__(self, num_brokers: int = 1):
        self._lock = threading.Lock()
        self._buckets: Dict[str, _TokenBucket] = {}
        self._qps: Dict[str, float] = {}       # effective (per-broker)
        self._raw: Dict[str, float] = {}       # configured table rate
        self.num_brokers = max(num_brokers, 1)

    def set_num_brokers(self, n: int) -> None:
        """Refresh the live-broker divisor (the external-view-change
        analog). Existing buckets re-divide only when the count
        actually changed — a broker joining/leaving the fleet rescales
        every table's per-broker rate."""
        n = max(int(n), 1)
        with self._lock:
            if n == self.num_brokers:
                return
            self.num_brokers = n
            for table, raw in self._raw.items():
                per_broker = raw / n
                self._qps[table] = per_broker
                # rescale in place (spent-burst fraction preserved):
                # a fresh bucket per membership flip would mint a full
                # burst each flip and bypass the quota
                self._buckets[table].rescale(per_broker)

    def set_quota(self, table: str, qps: Optional[float]) -> None:
        with self._lock:
            if qps is None or qps <= 0:
                self._buckets.pop(table, None)
                self._qps.pop(table, None)
                self._raw.pop(table, None)
                return
            self._raw[table] = float(qps)
            per_broker = qps / self.num_brokers
            if self._qps.get(table) != per_broker:
                self._qps[table] = per_broker
                self._buckets[table] = _TokenBucket(per_broker)

    def effective_qps(self, table: str) -> Optional[float]:
        """The per-broker rate currently enforced (tests + consoles)."""
        with self._lock:
            return self._qps.get(table)

    def check(self, table: str) -> None:
        """Raise QuotaExceededError when the table is over its QPS."""
        with self._lock:
            bucket = self._buckets.get(table)
            if bucket is not None and not bucket.try_acquire():
                raise QuotaExceededError(
                    f"table {table!r} exceeded its query quota "
                    f"({self._qps[table]:g} qps/broker across "
                    f"{self.num_brokers} live broker(s))")
