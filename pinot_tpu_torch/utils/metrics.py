"""Metrics: counters, gauges, timers with a global registry.

Port of ``pinot_tpu/utils/metrics.py``: counters, gauges with their ages,
timers, ``snapshot``, the Prometheus rendering (``prometheus``,
``render_prometheus``) and the ``ingest_health`` / ``overload_health``
blocks, which read whichever of their counters the port increments (the
realtime and overload planes are not ported yet, so theirs read 0).
``clear`` is the port's own (its tests reset the process-global
registry).
Reference parity: pinot-common/.../metrics/AbstractMetrics.java +
pinot-spi metrics SPI (pluggable yammer/dropwizard backends). The registry
snapshot serves the /metrics endpoints of the cluster roles; a Prometheus
text formatter is a render method away.
"""
from __future__ import annotations

import re
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        # per-gauge last-update timestamp (monotonic seconds): a gauge
        # value alone cannot distinguish "freshness 50 ms" from
        # "freshness gauge dead for 10 minutes" — the SLO plane
        # (utils/slo.py) trips the freshness objective on stale gauges
        # instead of silently passing them. ``_now`` is injectable so
        # staleness tests don't sleep.
        self._gauge_ts: Dict[str, float] = {}
        self._now = time.monotonic  # guarded-by: none — test injection
        self._timers: Dict[str, List[float]] = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value
            self._gauge_ts[name] = self._now()

    def remove_gauge(self, name: str) -> None:
        """Drop a gauge (no-op when absent): a stopped table's last
        freshness EWMA must not pin console rollups forever, and table
        churn must not grow the gauge set without bound."""
        with self._lock:
            self._gauges.pop(name, None)
            self._gauge_ts.pop(name, None)

    def gauge_age_s(self, name: str) -> Optional[float]:
        """Seconds since the gauge was last written (None when the
        gauge does not exist) — the dead-gauge signal."""
        with self._lock:
            ts = self._gauge_ts.get(name)
            if ts is None:
                return None
            return max(self._now() - ts, 0.0)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self._timers.setdefault(name, []).append(dt)
                if len(self._timers[name]) > 1024:  # bound memory
                    self._timers[name] = self._timers[name][-512:]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            timers = {}
            for name, vals in self._timers.items():
                if not vals:
                    continue
                s = sorted(vals)
                timers[name] = {
                    "count": len(s),
                    "p50": s[len(s) // 2],
                    "p99": s[min(len(s) - 1, int(len(s) * 0.99))],
                    "max": s[-1],
                }
            # ``gauge_age_s`` rides beside ``gauges`` (a NEW key — every
            # existing consumer reads ``gauges`` as plain name->float
            # and keeps working): seconds since each gauge's last write,
            # so snapshot readers can spot a dead gauge
            now = self._now()
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "gauge_age_s": {
                        k: round(max(now - ts, 0.0), 3)
                        for k, ts in self._gauge_ts.items()},
                    "timers": timers}

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._gauge_ts.clear()
            self._timers.clear()

    def prometheus(self) -> str:
        return render_prometheus(self.snapshot())


INGEST_COUNTERS = (
    "ingest_rows", "ingest_commits", "ingest_commit_retries",
    "ingest_commit_failures", "ingest_rebalance_resets",
    "ingest_stream_retries", "ingest_upsert_replays",
    "ingest_orphans_cleaned", "ingest_handoff_retries",
    # a consumer thread surviving errors past its bounded retries: the
    # wedged-consumer signal must surface where operators look
    "ingest_consume_errors",
)


def ingest_health(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """The realtime-plane health block the broker /metrics endpoint and
    both consoles render next to the round-9 scatter counters: recovery
    counters (realtime/manager.py ``ingest_*``) + the end-to-end
    freshness gauges (per table; ``freshness_ms`` is the WORST table —
    the operationally interesting number when several share a
    process)."""
    c = snapshot["counters"]
    out: Dict[str, Any] = {k: c.get(k, 0) for k in INGEST_COUNTERS}
    prefix = "ingest_freshness_ms_"
    by_table = {k[len(prefix):]: v for k, v in snapshot["gauges"].items()
                if k.startswith(prefix)}
    out["freshness_by_table"] = by_table
    out["freshness_ms"] = max(by_table.values()) if by_table else None
    # gauge staleness (ISSUE 17): seconds since each freshness gauge
    # last moved — a frozen gauge under live ingest is a dead writer,
    # and the SLO freshness objective trips on it instead of trusting
    # the last value forever
    ages = snapshot.get("gauge_age_s") or {}
    out["freshness_age_s"] = {k[len(prefix):]: v
                              for k, v in ages.items()
                              if k.startswith(prefix)}
    return out


OVERLOAD_COUNTERS = (
    "overload_shed", "overload_brownout_clamped",
    "overload_retries_suppressed", "scheduler_rejected",
)


def overload_health(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """The overload-protection block (broker/workload.py) the broker
    /metrics endpoint and both consoles render: shed totals, the
    current degradation rung, shed counts by rung, and per-tenant
    shed counters / in-flight gauges. Tenant names embed in metric
    names (``tenant_shed_<tenant>``) — the Prometheus renderer
    sanitizes them through ``_prom_name``."""
    c = snapshot["counters"]
    g = snapshot["gauges"]
    out: Dict[str, Any] = {k: c.get(k, 0) for k in OVERLOAD_COUNTERS}
    out["rung"] = g.get("overload_rung", 0)
    out["pressure"] = g.get("overload_pressure", 0.0)
    # derived from whatever rung counters exist: budget sheds
    # (inflight/cpu/bytes/retry) land on the CURRENT rung — 0/1
    # included — and the breakdown must sum to the shed total
    rung_prefix = "overload_shed_rung_"
    out["shed_by_rung"] = {k[len(rung_prefix):]: v
                           for k, v in c.items()
                           if k.startswith(rung_prefix)}
    shed_prefix = "tenant_shed_"
    out["shed_by_tenant"] = {k[len(shed_prefix):]: v
                             for k, v in c.items()
                             if k.startswith(shed_prefix)}
    infl_prefix = "tenant_inflight_"
    out["inflight_by_tenant"] = {k[len(infl_prefix):]: v
                                 for k, v in g.items()
                                 if k.startswith(infl_prefix)}
    return out


def _prom_name(name: str) -> str:
    """Sanitize to the Prometheus metric-name alphabet: registry names
    may embed user-supplied strings (ingest_freshness_ms_<table>), and
    one illegal character would make Prometheus reject the whole
    scrape."""
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def render_prometheus(snapshot: Dict[str, Any],
                      prefix: str = "pinot_tpu") -> str:
    """Prometheus exposition text from a snapshot — the ONE place the
    name/suffix rules live (the /metrics endpoints and the textfile sink
    both render through here)."""
    lines = []
    for k, v in snapshot["counters"].items():
        lines.append(f"{prefix}_{_prom_name(k)}_total {v}")
    for k, v in snapshot["gauges"].items():
        lines.append(f"{prefix}_{_prom_name(k)} {v}")
    for k, t in snapshot["timers"].items():
        lines.append(f"{prefix}_{_prom_name(k)}_ms_p50 {t['p50']:.3f}")
        lines.append(f"{prefix}_{_prom_name(k)}_ms_p99 {t['p99']:.3f}")
    return "\n".join(lines) + "\n"


global_metrics = MetricsRegistry()
