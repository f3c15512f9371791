"""chip_smoke.py's K1 device split, on the CPU with a stubbed profiler.

``compact_split_ms`` reads the compaction's device time from
torch.profiler. A window that records nothing (or not every call) is
retried up to ``PROFILE_TRIES`` times and then reported as None, never
as 0.0; a window that records the pass on every call gives the split.
``add_measured`` keeps an unmeasured part out of a sum: its total
becomes None. The trace phase's gates: broker_overhead over 10% of the
root fails; each device_execute span runs inside a record_function range
of its own, whose device time is read by correlation (or, where that is
0, by the device events starting inside the range) and is 0 when the
window missed it.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


class _Event:
    def __init__(self, key, count, us):
        self.key, self.count = key, count
        self.device_type = "DeviceType.CUDA"
        self.self_device_time_total = us


def _stub_profiler(monkeypatch, windows):
    """torch.profiler.profile whose successive windows report the given
    event lists; returns the list of windows opened."""
    opened = []

    class _Prof:
        def __init__(self, activities=None):
            self.events = windows[min(len(opened), len(windows) - 1)]
            opened.append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", _Prof)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return opened


def test_an_empty_window_is_retried_then_not_measured(monkeypatch):
    opened = _stub_profiler(monkeypatch, [[]])
    calls = []
    assert chip_smoke.compact_split_ms(lambda: calls.append(1), reps=4) \
        is None
    assert len(opened) == chip_smoke.PROFILE_TRIES
    assert len(calls) == 1 + 4 * chip_smoke.PROFILE_TRIES


def test_a_partial_window_is_retried(monkeypatch):
    part = [_Event("compact_pass", 2, 40.0)]          # 2 of 4 calls
    whole = [_Event("compact_pass", 4, 80.0),
             _Event("compact_fill", 4, 8.0),
             _Event("Memset (Device)", 4, 4.0)]
    opened = _stub_profiler(monkeypatch, [part, whole])
    got = chip_smoke.compact_split_ms(lambda: None, reps=4)
    assert len(opened) == 2
    assert got == pytest.approx({"pass_ms": 0.02, "fill_ms": 0.002,
                                 "memset_ms": 0.001})


def test_add_measured_keeps_unmeasured_parts_none():
    totals = {"ms": 0.0, "device_ms": 0.0}
    chip_smoke.add_measured(totals, {"ms": 1.5, "device_ms": 0.5})
    assert totals == {"ms": 1.5, "device_ms": 0.5}
    chip_smoke.add_measured(totals, {"ms": 1.0, "device_ms": None})
    chip_smoke.add_measured(totals, {"ms": 1.0, "device_ms": 0.25})
    assert totals == {"ms": 3.5, "device_ms": None}


class _S:
    """A finished span: name, start (s, host clock), ms, children."""

    def __init__(self, name, t0, ms, children=()):
        self.name, self._t0, self.duration_ms = name, t0, ms
        self.children = list(children)


def _tree(prefix_ms, kids_ms, gap_ms=0.0):
    """A root whose children start after ``prefix_ms`` and run back to
    back, with ``gap_ms`` between the first two."""
    kids, t = [], prefix_ms
    for i, (name, ms) in enumerate(kids_ms):
        kids.append(_S(name, t / 1e3, ms))
        t += ms + (gap_ms if i == 0 else 0.0)
    return _S("query", 0.0, t, kids)


def test_time_after_the_prefix_in_no_span_fails():
    ok = _tree(1.0, [("planning", 1.0), ("execution", 8.0)], gap_ms=0.5)
    fails, covs = chip_smoke._coverage_check([ok], "q")
    assert fails == [] and covs[0]["prefix_ms"] == pytest.approx(1.0)
    assert covs[0]["gap_ms"] == pytest.approx(0.5)
    # a large prefix (the broker's own step) is reported, not bounded
    slow_broker = _tree(3.0, [("planning", 1.0), ("execution", 6.0)])
    assert chip_smoke._coverage_check([slow_broker], "q")[0] == []
    bad = _tree(0.2, [("planning", 1.0), ("execution", 6.0)], gap_ms=1.5)
    assert "in no span" in chip_smoke._coverage_check([bad], "q")[0][0]
    # the median of the runs: one stalled run does not decide
    assert chip_smoke._coverage_check([ok, bad, ok], "q")[0] == []
    assert chip_smoke._coverage_check([bad, ok, bad], "q")[0]
    # children past the root (overlapping spans) fail too
    over = _tree(0.0, [("planning", 1.0), ("execution", 8.0)])
    over.duration_ms = 8.0
    assert "past the root" in chip_smoke._coverage_check([over], "q")[0][-1]


def test_analyzed_roots_capture_every_explain_analyze(tmp_path):
    """On the CPU: the broker's analyzed roots are captured from a wave
    of threads, their children start after the root and cover it after
    the prefix, and the broker is restored afterwards."""
    import threading

    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.broker import broker as bmod
    from pinot_tpu_torch.server import TableDataManager
    from pinot_tpu_torch.tools import ssb

    real = bmod.finalize_analyze
    dm = TableDataManager("lineorder", device="cpu")
    dm.add_segment_dir(ssb.build_segment_dir(1 << 12, str(tmp_path / "s")))
    b = Broker(device="cpu")
    b.register_table(dm)
    q = connect(b)
    sqls = [ssb.spec_to_sql(p, v, g) for _qid, p, v, g in ssb.QUERIES[:3]]
    with chip_smoke._analyzed_roots() as roots:
        threads = [threading.Thread(target=q, args=("EXPLAIN ANALYZE " + s,))
                   for s in sqls]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert bmod.finalize_analyze is real
    assert len(roots) == len(sqls)
    for r in roots:
        c = chip_smoke._coverage(r)
        assert [k.name for k in r.children][:3] == [
            "planning", "execution", "reduce"]
        assert c["prefix_ms"] > 0 and c["gap_ms"] >= -1e-6
        assert c["overhead_ms"] == pytest.approx(
            r.child("broker_overhead").duration_ms)


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Fn:
    def __init__(self, name, device_type, start, end, device_us=0.0):
        self.name, self.device_type = name, device_type
        self.time_range = _Range(start, end)
        self.device_time_total = device_us


class _Span:
    def __init__(self, ms):
        self.duration_ms = ms


def test_span_device_ms_by_correlation_then_by_window():
    class _P:
        def events(self):
            return [
                _Fn("device_execute#0", "DeviceType.CPU", 0, 900, 500.0),
                _Fn("device_execute#1", "DeviceType.CPU", 1000, 2000),
                _Fn("device_execute#1", "DeviceType.CUDA", 1100, 1900),
                _Fn("k", "DeviceType.CUDA", 1100, 1400),
                _Fn("k", "DeviceType.CUDA", 1500, 1700),
                _Fn("k", "DeviceType.CUDA", 2100, 2200),    # after it
            ]

    opened = {"device_execute#0": _Span(0.9), "device_execute#1": _Span(1.0),
              "device_execute#2": _Span(0.3)}
    got = chip_smoke._span_device_ms(_P(), opened)
    assert got["device_execute#0"] == (0.9, pytest.approx(0.5),
                                       "correlation")
    # the GPU-side annotation event is not counted as work
    assert got["device_execute#1"] == (1.0, pytest.approx(0.5 + 0.8),
                                       "window")
    assert got["device_execute#2"] == (0.3, 0.0, None)      # missed


def test_ranged_spans_label_every_device_execute(tmp_path):
    """On the CPU: a traced query's device_execute spans each open a
    record_function range the profiler records, and the tracer is
    restored afterwards."""
    from torch.profiler import ProfilerActivity, profile

    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.server import TableDataManager
    from pinot_tpu_torch.tools import ssb
    from pinot_tpu_torch.utils.spans import span_tracer

    dm = TableDataManager("lineorder", device="cpu")
    dm.add_segment_dir(ssb.build_segment_dir(1 << 12, str(tmp_path / "s")))
    b = Broker(device="cpu")
    b.register_table(dm)
    q = connect(b)
    qid, p, v, g = ssb.QUERIES[3]
    sql = "EXPLAIN ANALYZE " + ssb.spec_to_sql(p, v, g)
    with chip_smoke._ranged_spans("device_execute") as opened, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        res = q(sql)
    assert "span" not in vars(span_tracer)
    n_spans = sum(1 for r in res.rows if r[0] == "device_execute")
    assert n_spans >= 1 and sorted(opened) == [
        f"device_execute#{i}" for i in range(n_spans)]
    names = {e.name for e in prof.events()}
    assert set(opened) <= names
    assert all(sp.duration_ms > 0 for sp in opened.values())


@pytest.mark.parametrize("strategy", ["compact", "dense", "scalar"])
def test_profile_phases_check_on_cpu(tmp_path, strategy, monkeypatch):
    """profile_phases_check passes on the CPU path for the plans the trace
    phase runs it on (compact, scalar) and a dense group-by. The prefix
    timer is replaced by one whose times grow with each call, so the
    check's reading of the ladder is tested and not this machine's load;
    a ladder that shrinks fails it."""
    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.ops import phase_profile
    from pinot_tpu_torch.server import TableDataManager
    from pinot_tpu_torch.tools import ssb

    calls = []

    def growing(fn, *args, iters=5):
        fn(*args)
        calls.append(1)
        return 1e-4 * len(calls)

    monkeypatch.setattr(phase_profile, "timeit", growing)

    dm = TableDataManager("lineorder", device="cpu")
    dm.add_segment_dir(ssb.build_segment_dir(1 << 15, str(tmp_path / "s")))
    b = Broker(device="cpu")
    b.register_table(dm)
    qid, p, v, g = ssb.QUERIES[{"compact": 3, "dense": 10,
                                "scalar": 0}[strategy]]
    sql = ssb.spec_to_sql(p, v, g)
    if strategy != "scalar":
        sql = chip_smoke._with_option(sql, f"groupByStrategy={strategy}")
    chip_smoke.profile_phases_check(connect(b), sql, f"{qid}:{strategy}")
    assert calls
    if strategy == "compact":
        def shrinking(fn, *args, iters=5):
            calls.append(1)
            return 1e-2 / len(calls)

        monkeypatch.setattr(phase_profile, "timeit", shrinking)
        with pytest.raises(AssertionError, match="nondecreasing"):
            chip_smoke.profile_phases_check(connect(b), sql, qid)


def test_realtime_phase_on_cpu(tmp_path, monkeypatch):
    """The realtime phase end to end on the CPU at 2^13 rows (the plain
    versions of the kernels; a wrapper counts the compaction's calls as
    launches): every check of the phase holds, K1 was called on the
    realtime path and held on the inputs of each of its tables."""
    from pinot_tpu_torch.ops import compact
    from pinot_tpu_torch.ops.plan_cache import global_cube_cache
    from test_torch_tier import reset_port_memory

    reset_port_memory()
    real = compact.compact

    def counted(*a, **k):
        compact.launches += 1
        return real(*a, **k)

    monkeypatch.setattr(compact, "compact", counted)
    monkeypatch.setattr(chip_smoke, "RT_ROWS", 1 << 13)
    monkeypatch.setattr(chip_smoke, "CACHE", str(tmp_path))
    printed = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda label, **f: printed.append((label, f)))
    try:
        launches = chip_smoke.realtime_phase(4096, device="cpu")
    finally:
        global_cube_cache.clear()
    assert launches > 0
    seen = {label for label, _f in printed}
    assert {"realtime_setup", "realtime_ingest", "realtime_query",
            "realtime_upsert", "realtime_dedup", "realtime_live",
            "kernel_at_realtime_path", "kernel_at_upsert_path",
            "realtime_done"} <= seen
    ingest = dict(printed)["realtime_ingest"]
    assert ingest["sealed_segments"] == 8 and ingest["consuming_docs"] > 0
    upsert = dict(printed)["realtime_upsert"]
    assert upsert["invalidated_after_upload"]
    held = {f["query"].split(":")[0] for label, f in printed
            if label in ("kernel_at_realtime_path", "kernel_at_upsert_path")}
    assert held == {"offline", "realtime", "hybrid", "live",
                    "upsert_before", "upsert_after"}
    assert upsert["count"] == upsert["keys"]


def _counting_compact(monkeypatch):
    """The compaction's plain version, counted as launches."""
    from pinot_tpu_torch.ops import compact

    real = compact.compact

    def counted(*a, **k):
        compact.launches += 1
        return real(*a, **k)

    monkeypatch.setattr(compact, "compact", counted)


def test_wire_phase_on_cpu(tmp_path, monkeypatch):
    """The wire phase end to end on the CPU at 2^13 Kafka rows: the
    Kafka table resumes from the checkpoints of its first manager (past
    each partition's first seal) with no row lost or doubled, every
    plugin's table answers as the offline rows, K1 launched on the path
    and held on every compact input of it."""
    from pinot_tpu_torch.ops.plan_cache import global_cube_cache
    from test_torch_tier import reset_port_memory

    reset_port_memory()
    _counting_compact(monkeypatch)
    monkeypatch.setattr(chip_smoke, "WIRE_KAFKA_ROWS", 1 << 13)
    monkeypatch.setattr(chip_smoke, "WIRE_CRC_BYTES", 1 << 16)
    monkeypatch.setattr(chip_smoke, "CACHE", str(tmp_path))
    printed = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda label, **f: printed.append((label, f)))
    try:
        launches = chip_smoke.wire_phase(4096, device="cpu")
    finally:
        global_cube_cache.clear()
    assert launches > 0
    ingest = {f["plugin"]: f for label, f in printed
              if label == "wire_ingest"}
    assert sorted(ingest) == ["kafka", "kinesis", "pulsar", "wire"]
    kafka = ingest["kafka"]
    assert kafka["restart"]["sealed_segments"] == 4
    assert kafka["sealed_segments"] == 4 and kafka["consuming_docs"] > 0
    assert kafka["rows_consumed"] - kafka["rows"] == \
        kafka["re_consumed_after_restart"] > 0
    assert ingest["wire"]["restarted_latest"]
    assert {f["plugin"] for label, f in printed
            if label == "wire_query"} == {"pulsar", "kinesis", "wire"}
    held = {f["query"].split(":")[0] for label, f in printed
            if label == "kernel_at_wire_path"}
    assert held == {"wire_kafka", "wire_pulsar", "wire_kinesis",
                    "wire_wire"}
    crc = dict(printed)["wire_crc32c"]
    assert crc["route"] in ("sse42", "tables", "plain")


def test_overload_phase_on_cpu(tmp_path, monkeypatch):
    """The overload phase end to end on the CPU over a 2^14-row SSB
    segment and the same rows in 8 segments: pinned sheds equal to the
    pure ladder's twice over, the live ladder sheds besteffort and
    settles, each device fault keeps the rows, the kill order prefers
    besteffort."""
    from pinot_tpu_torch.ops.plan_cache import global_cube_cache
    from pinot_tpu_torch.segment import load_segment
    from pinot_tpu_torch.tools import ssb
    from test_torch_tier import reset_port_memory

    n = 1 << 14
    single = load_segment(ssb.build_segment_dir(n, str(tmp_path / "one")),
                          "cpu")
    table = ssb.build_table_dir([n // 8] * 8, str(tmp_path / "eight"))
    segs = [load_segment(os.path.join(table, d), "cpu")
            for d in sorted(os.listdir(table))]
    digests = {qid: ssb._digest(ssb.oracle_run(single, p, v, g)[0])
               for qid, p, v, g in ssb.QUERIES}
    reset_port_memory([single] + segs)
    _counting_compact(monkeypatch)
    monkeypatch.setattr(chip_smoke, "TIER_BUDGET", sum(
        s.bucket * 4 * len(s.columns) for s in segs) // 9)
    printed = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda label, **f: printed.append((label, f)))
    try:
        launches = chip_smoke.overload_phase(single, segs, digests, 4096,
                                             device="cpu")
    finally:
        global_cube_cache.clear()
        reset_port_memory([single] + segs)
    assert launches > 0
    got = dict(printed)
    pinned = [f for label, f in printed if label == "overload_pinned"]
    assert [f["rung"] for f in pinned] == [0, 1, 2, 3] * 2
    assert pinned[3]["deadlines_clamped"] == pinned[3]["admitted"] > 0
    assert got["overload_shed_stream"]["same_on_second_run"]
    assert got["overload_live"]["shed_by_tier"].get("besteffort")
    assert got["overload_overflow"]["reruns"] == \
        len(got["overload_overflow"]["compact_queries"]) > 0
    assert got["overload_tier_evict"]["fault_demotions"] > 0
    assert got["overload_kills"]["kill_order_victim"].startswith(
        "order_besteffort")
