"""Pluggable metrics sinks: statsd lines, Prometheus textfiles, callbacks.

Reference parity: pinot-plugins/pinot-metrics/ — the yammer/dropwizard
PinotMetricsFactory implementations behind the metrics SPI, chosen by
config name (pinot.broker.metrics.factory.className). Here each sink is
a plugin (spi/plugin.py short names "statsd", "prometheus_file",
"callback") fed by a periodic flush task, so operators wire exporters
without touching engine code.

Port of ``pinot_tpu/utils/metrics_sinks.py``, unchanged: the same
datagrams, textfile and ledger records for the same registry snapshot,
over the port's ``cluster/periodic.py`` and ``utils/metrics.py``; the
sinks register under the same short names in ``spi/plugin`` when this
module is imported.
"""
from __future__ import annotations

import os
import socket
from typing import Any, Callable, Dict, List, Optional

from ..cluster.periodic import BasePeriodicTask
from .metrics import MetricsRegistry, global_metrics


class MetricsSink:
    """emit() receives a MetricsRegistry.snapshot() dict."""

    def emit(self, snapshot: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class StatsdSink(MetricsSink):
    """Fire-and-forget UDP statsd lines (counters |c, gauges |g, timer
    p50/p99 as gauges) — the statsd/datadog exporter shape."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8125,
                 prefix: str = "pinot_tpu"):
        self.addr = (host, int(port))
        self.prefix = prefix
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._last_counters: Dict[str, int] = {}

    def emit(self, snapshot: Dict[str, Any]) -> None:
        # counters first, each advancing its baseline as its datagram is
        # handed to the kernel: a mid-flush OSError then neither loses a
        # delivered delta (no re-send) nor drops an unsent one (re-emits
        # next flush); gauges/timers are absolute and safely droppable
        for k, v in snapshot["counters"].items():
            delta = v - self._last_counters.get(k, 0)
            if not delta:
                continue
            try:
                self.sock.sendto(f"{self.prefix}.{k}:{delta}|c".encode(),
                                 self.addr)
            except OSError:
                return  # exporter gone: never fail the engine
            self._last_counters[k] = v
        lines: List[str] = []
        for k, v in snapshot["gauges"].items():
            lines.append(f"{self.prefix}.{k}:{v}|g")
        for k, t in snapshot["timers"].items():
            lines.append(f"{self.prefix}.{k}.p50:{t['p50']:.3f}|g")
            lines.append(f"{self.prefix}.{k}.p99:{t['p99']:.3f}|g")
        for line in lines:
            try:
                self.sock.sendto(line.encode(), self.addr)
            except OSError:
                return

    def close(self) -> None:
        self.sock.close()


class PrometheusFileSink(MetricsSink):
    """Atomic textfile for the node-exporter textfile collector."""

    def __init__(self, path: str, prefix: str = "pinot_tpu"):
        self.path = path
        self.prefix = prefix

    def emit(self, snapshot: Dict[str, Any]) -> None:
        # renders from the SNAPSHOT (the sink contract) through the one
        # shared exposition formatter
        from .metrics import render_prometheus
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(render_prometheus(snapshot, self.prefix))
        os.replace(tmp, self.path)


class CallbackSink(MetricsSink):
    def __init__(self, fn: Callable[[Dict[str, Any]], None]):
        self.fn = fn

    def emit(self, snapshot: Dict[str, Any]) -> None:
        self.fn(snapshot)


class LedgerSink(MetricsSink):
    """Appends each snapshot as a v2 ``metrics_snapshot`` record to the
    unified perf ledger (utils/ledger.py) — engine counters land in the
    same validated JSONL history the bench and phase profiles use."""

    def __init__(self, path: str = "PERF_LEDGER.jsonl"):
        self.path = path

    def emit(self, snapshot: Dict[str, Any]) -> None:
        from . import ledger as uledger
        uledger.append_record(
            uledger.make_record("metrics_snapshot",
                                counters=snapshot.get("counters", {}),
                                gauges=snapshot.get("gauges", {}),
                                timers=snapshot.get("timers", {})),
            self.path)


class MetricsFlushTask(BasePeriodicTask):
    """Periodic emitter: snapshot once, fan out to every sink
    (the metrics factory's scheduled reporters analog)."""

    def __init__(self, sinks: List[MetricsSink], interval_s: float = 10.0,
                 registry: MetricsRegistry = None):
        super().__init__("metricsFlush", interval_s, self._flush)
        self.sinks = list(sinks)
        self.registry = registry or global_metrics

    def _flush(self) -> None:
        snap = self.registry.snapshot()
        for sink in self.sinks:
            try:
                sink.emit(snap)
            except Exception:
                # one broken exporter (read-only textfile path, closed
                # socket) must not starve the sinks after it
                continue


def sinks_from_config(conf: List[Dict[str, Any]]) -> List[MetricsSink]:
    """[{"type": "statsd", "host": ..., ...}, ...] -> sink instances via
    the plugin loader (createInstance by config name)."""
    from ..spi.plugin import create_instance
    out: List[MetricsSink] = []
    for entry in conf:
        kwargs = {k: v for k, v in entry.items() if k != "type"}
        out.append(create_instance(entry["type"], **kwargs))
    return out


def _register() -> None:
    from ..spi.plugin import register_plugin
    register_plugin("statsd", StatsdSink)
    register_plugin("prometheus_file", PrometheusFileSink)
    register_plugin("callback", CallbackSink)
    register_plugin("ledger", LedgerSink)


_register()
