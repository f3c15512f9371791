"""Per-table query quotas (QPS rate limiting at the broker).

Port of ``pinot_tpu/broker/quota.py`` for the in-process broker: per-table
max QPS from the table config (``TableConfig.quota_qps``), enforced with a
token bucket; a query over quota is rejected before it plans, with the
reference's error text. Reference system: pinot-broker/.../queryquota/
HelixExternalViewBasedQueryQuotaManager.java (BrokerMeter.
QUERY_QUOTA_EXCEEDED). The reference divides a table's rate by the live
broker count its cluster reports; an in-process broker is the only one,
so the divisor stays 1 and the rescaling on membership changes waits for
the cluster's broker node.
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


class QueryQuotaManager:
    """table -> token bucket, built from the table config's quotaQps."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: Dict[str, _TokenBucket] = {}
        self._qps: Dict[str, float] = {}       # effective (per-broker)
        self.num_brokers = 1                   # the in-process broker

    def set_quota(self, table: str, qps: Optional[float]) -> None:
        with self._lock:
            if qps is None or qps <= 0:
                self._buckets.pop(table, None)
                self._qps.pop(table, None)
                return
            per_broker = qps / self.num_brokers
            if self._qps.get(table) != per_broker:
                self._qps[table] = per_broker
                self._buckets[table] = _TokenBucket(per_broker)

    def check(self, table: str) -> None:
        """Raise QuotaExceededError when the table is over its QPS."""
        with self._lock:
            bucket = self._buckets.get(table)
            if bucket is not None and not bucket.try_acquire():
                raise QuotaExceededError(
                    f"table {table!r} exceeded its query quota "
                    f"({self._qps[table]:g} qps/broker across "
                    f"{self.num_brokers} live broker(s))")
