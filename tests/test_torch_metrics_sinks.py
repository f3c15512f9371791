"""The port's metrics sinks against the JAX package's.

``pinot_tpu_torch/utils/metrics_sinks.py`` is the reference's module
over the port's ``cluster/periodic.py`` and ``utils/metrics.py``: for
the same registry snapshot the statsd sink sends the same datagrams
(counter deltas against its last flush, gauges, timer p50/p99), the
Prometheus sink writes the same textfile and the ledger sink appends
the same validated ``metrics_snapshot`` record; the sinks resolve by
their short names through ``spi/plugin``; a flush task fans one
snapshot out to every sink, past a broken one.
"""
import json
import socket

import pytest

import pinot_tpu.utils.metrics as jmetrics
import pinot_tpu.utils.metrics_sinks as jsinks
import pinot_tpu_torch.utils.metrics as tmetrics
import pinot_tpu_torch.utils.metrics_sinks as tsinks


def _registry(mod, step: int):
    """A registry of ``mod`` with counters, gauges and timers; ``step``
    moves the counters on."""
    reg = mod.MetricsRegistry()
    reg._now = lambda: 100.0
    reg.count("queries", 7 + 5 * step)
    reg.count("ingest_rows", 1000 * (step + 1))
    if step:
        reg.count("overload_shed", step)
    reg.gauge("ingest_freshness_ms", 12.5 + step)
    reg.gauge("overload_rung", step)
    for ms in (1.0, 2.5, 4.0, 9.75):
        reg._timers.setdefault("query_ms", []).append(ms * (step + 1))
    return reg


def _datagrams(sinks_mod, metrics_mod, prefix=None):
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(2.0)
    kw = {} if prefix is None else {"prefix": prefix}
    sink = sinks_mod.StatsdSink("127.0.0.1", rx.getsockname()[1], **kw)
    got = []
    try:
        for step in (0, 1, 1, 2):
            sink.emit(_registry(metrics_mod, step).snapshot())
            rx.settimeout(0.02)
            while True:
                try:
                    got.append(rx.recv(65536).decode())
                except socket.timeout:
                    break
    finally:
        sink.close()
        rx.close()
    return got


@pytest.mark.parametrize("prefix", [None, "pinot"])
def test_statsd_datagrams_match_reference(prefix):
    mine = _datagrams(tsinks, tmetrics, prefix)
    assert mine == _datagrams(jsinks, jmetrics, prefix)
    assert any(d.endswith("|c") for d in mine)
    assert any(".p99:" in d for d in mine)


def test_prometheus_file_and_ledger_match_reference(tmp_path):
    snap = _registry(tmetrics, 1).snapshot()
    jsnap = _registry(jmetrics, 1).snapshot()
    assert snap == jsnap
    texts = []
    for mod, s in ((tsinks, snap), (jsinks, jsnap)):
        path = tmp_path / f"{mod.__name__}.prom"
        mod.PrometheusFileSink(str(path)).emit(s)
        texts.append(path.read_text())
    assert texts[0] == texts[1] and "pinot_tpu_queries" in texts[0]
    recs = []
    for mod, s in ((tsinks, snap), (jsinks, jsnap)):
        path = tmp_path / f"{mod.__name__}.jsonl"
        mod.LedgerSink(str(path)).emit(s)
        mod.LedgerSink(str(path)).emit(s)
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        for r in lines:
            r.pop("ts")
        recs.append(lines)
    assert recs[0] == recs[1] and recs[0][0]["kind"] == "metrics_snapshot"
    from pinot_tpu_torch.utils import ledger

    assert ledger.validate_file(str(
        tmp_path / f"{tsinks.__name__}.jsonl"))["errors"] == []


def test_sinks_resolve_by_name_and_the_flush_fans_out(tmp_path):
    from pinot_tpu_torch.spi.plugin import create_instance

    seen = []
    sinks = tsinks.sinks_from_config([
        {"type": "prometheus_file", "path": str(tmp_path / "m.prom")},
        {"type": "callback", "fn": seen.append},
        {"type": "ledger", "path": str(tmp_path / "l.jsonl")},
    ])
    assert [type(s).__name__ for s in sinks] == [
        "PrometheusFileSink", "CallbackSink", "LedgerSink"]
    assert type(create_instance("statsd", port=9)).__name__ == "StatsdSink"

    class Broken(tsinks.MetricsSink):
        def emit(self, snapshot):
            raise OSError("exporter gone")

    reg = _registry(tmetrics, 2)
    task = tsinks.MetricsFlushTask([Broken(), *sinks], interval_s=0.05,
                                   registry=reg)
    assert task.name == "metricsFlush"
    task.run_once()
    assert seen == [reg.snapshot()]
    assert "pinot_tpu_overload_shed" in (tmp_path / "m.prom").read_text()
    assert len((tmp_path / "l.jsonl").read_text().splitlines()) == 1
    assert tsinks.MetricsFlushTask([]).registry is tmetrics.global_metrics
