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
window missed it; where every window misses, the CUDA events each span
recorded give the device time, and the check fails only when they
measure nothing either. The phases are rehearsed end to end at tiny
sizes; the cluster, control, fuzz and remote phases hold K1 on every
input their path launched, the servers' taken from the plans each
execution ran (recorded inside it, also when a move's drain lands in
the middle), and the control and remote phases also hold every launch
on its own inputs as it launches and fail on one they did not hold. The
mesh phase holds every K1 and hash_partition launch of its path as
captured.
"""
import contextlib
import os
import re
import sys
import time

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
            self._events = windows[min(len(opened), len(windows) - 1)]
            opened.append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self._events

        def events(self):
            return []

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


def test_kernel_split_ms_with_no_memset_expected(monkeypatch):
    """memsets=0 (the hash partition: its pass and its fill, no memset):
    a window without a memset is taken, with the memset at 0; a window
    that shows one is not, and the next is tried."""
    calls = [_Event("hp_pass", 4, 80.0), _Event("hp_fill", 4, 20.0)]
    opened = _stub_profiler(monkeypatch, [calls])
    got = chip_smoke.kernel_split_ms(lambda: None, chip_smoke.HP_KERNELS,
                                     reps=4, memsets=0)
    assert len(opened) == 1
    assert got == pytest.approx({"hp_pass": 0.02, "hp_fill": 0.005,
                                 "memset": 0.0})
    opened = _stub_profiler(monkeypatch, [
        calls + [_Event("Memset (Device)", 1, 4.0)], calls])
    assert chip_smoke.kernel_split_ms(
        lambda: None, chip_smoke.HP_KERNELS, reps=4, memsets=0) == got
    assert len(opened) == 2


def test_table_phase_waits_for_its_worker(tmp_path, monkeypatch):
    """The 8-segment table built by a worker process started before the
    kernels' build, then waited for; a second call finds it cached."""
    monkeypatch.setattr(chip_smoke, "CACHE", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "N_ROWS", 1 << 12)
    printed = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda name, /, **f: printed.append((name, f)))
    job = chip_smoke.start_table_build()
    assert job is not None
    out = chip_smoke.table_phase(job)
    segs = sorted(os.listdir(out))
    assert len(segs) == chip_smoke.TABLE_SEGMENTS and all(
        os.path.exists(os.path.join(out, d, "metadata.json")) for d in segs)
    assert printed[-1][1]["cached"] is False
    assert chip_smoke.start_table_build() is None
    assert chip_smoke.table_phase() == out
    assert printed[-1][1]["cached"] is True


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


def _fingerprinted_compact(monkeypatch, holder: str, within: str = ""):
    """The compaction's plain version, counted as launches; returns two
    lists of the inputs' digests: those of the path's launches (only
    those inside the context manager chip_smoke.<within> when given) and
    those launched inside chip_smoke.<holder> (the checks that hold
    K1)."""
    import hashlib

    from pinot_tpu_torch.ops import compact

    real, real_holder = compact.compact, getattr(chip_smoke, holder)
    launched, held, holding, inside = [], [], [], []

    def digest(mask, cols, cap) -> str:
        h = hashlib.sha256(repr(int(cap)).encode())
        for t in (mask, *cols):
            h.update(str(t.dtype).encode())
            h.update(t.contiguous().numpy().tobytes())
        return h.hexdigest()

    def fingerprinted(mask, cols, cap):
        if holding:
            held.append(digest(mask, cols, cap))
        elif inside or not within:
            launched.append(digest(mask, cols, cap))
        compact.launches += 1
        return real(mask, cols, cap)

    def holding_checks(*a, **k):
        holding.append(True)
        try:
            return real_holder(*a, **k)
        finally:
            holding.pop()

    monkeypatch.setattr(compact, "compact", fingerprinted)
    monkeypatch.setattr(chip_smoke, holder, holding_checks)
    if within:
        real_within = getattr(chip_smoke, within)

        @contextlib.contextmanager
        def marked(*a, **k):
            inside.append(True)
            try:
                with real_within(*a, **k):
                    yield
            finally:
                inside.pop()

        monkeypatch.setattr(chip_smoke, within, marked)
    return launched, held


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


def test_cluster_phase_on_cpu(tmp_path, monkeypatch):
    """The cluster phase end to end on the CPU: two server nodes and a
    broker node over loopback HTTP answer the 13 SSB queries over 8
    segments of 2^14 rows with the in-process digests, both servers
    answer part of the segments, K1 is held on every server's compact
    inputs, the wave, the deep store, the dispatch and the failover
    hold, the gRPC plane answers the same queries and a mailbox
    relation, and memory, mailboxes and the planes' threads come
    back."""
    from pinot_tpu_torch.ops.plan_cache import global_cube_cache
    from pinot_tpu_torch.segment import load_segment
    from pinot_tpu_torch.tools import ssb, star
    from test_torch_tier import reset_port_memory

    n = 1 << 14
    table = ssb.build_table_dir([n // 8] * 8, str(tmp_path / "eight"))
    segs = [load_segment(os.path.join(table, d), "cpu")
            for d in sorted(os.listdir(table))]
    single = load_segment(ssb.build_segment_dir(n, str(tmp_path / "one")),
                          "cpu")
    digests = {qid: ssb._digest(ssb.oracle_run(single, p, v, g)[0])
               for qid, p, v, g in ssb.QUERIES}
    tables = star.star_tables(1 << 13)
    dirs = star.build_tables(str(tmp_path / "star"), tables)
    reset_port_memory(segs)
    _counting_compact(monkeypatch)
    monkeypatch.setattr(chip_smoke, "CACHE", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "ITERS", 1)
    monkeypatch.setattr(chip_smoke, "CLUSTER_DS_ROWS", 1 << 13)
    printed = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda label, **f: printed.append((label, f)))
    try:
        launches = chip_smoke.cluster_phase(table, dirs, tables, digests,
                                            {}, 4096, segs, device="cpu")
    finally:
        global_cube_cache.clear()
        reset_port_memory(segs)
    assert launches["launches"] > 0 and launches["grpc_launches"] > 0
    got = dict(printed)
    grpc = [f for label, f in printed if label == "cluster_grpc_query"]
    assert [f["qid"] for f in grpc] == [q for q, *_ in ssb.QUERIES]
    assert all(set(f["per_server"]) == {"server_0", "server_1"}
               for f in grpc)
    assert all(v["first_block_p50_ms"] > 0 for f in grpc
               for v in f["per_server"].values())
    held = [f for label, f in printed if label == "kernel_at_grpc_path"]
    assert held and all(f["equal"] for f in held)
    assert got["cluster_grpc"]["held_as_launched"] == launches[
        "grpc_launches"]
    assert got["cluster_grpc_mailbox"]["statuses"]["over_4_mib"][0] == \
        "RESOURCE_EXHAUSTED"
    assert got["cluster_grpc_mailbox"]["rows"] == 1 << 13
    assert got["cluster_done"]["grpc_threads_left"] == 0
    queries = [f for label, f in printed if label == "cluster_query"]
    assert [f["qid"] for f in queries] == [q for q, *_ in ssb.QUERIES]
    assert all(f["segments_queried"] == 8 for f in queries)
    held = {f["query"].split("@")[1] for label, f in printed
            if label == "kernel_at_cluster_path"}
    assert held == {"server_0", "server_1"}
    assert got["cluster_dispatch"]["rows"] == (1 << 13) // 7
    assert got["cluster_failover"]["both_down_codes"] == [427]
    assert got["cluster_done"]["partials_encoded"] > 0
    assert got["cluster_done"]["bytes_left"] == 0


def test_control_phase_on_cpu(tmp_path, monkeypatch):
    """The control phase end to end on the CPU at 2^13 realtime rows and
    8 segments of 2^13 rows: two replicas commit 8 segments through the
    controller (one COMMIT_SUCCESS each, the other replica adopts, the
    armed commit.http_error and handoff.stall fire once each), the
    servers and the broker node answer the oracle's digests, a rollup
    and a rebalancer pass move a segment with the digests unchanged,
    the autopsy names the move, the minion's offline segments and a
    merge keep the digests, and the quickstart answers in a subprocess;
    K1 is held on every compact input of the path: each input a launch
    of the path was given is among the inputs the phase held."""
    from pinot_tpu_torch.ops.plan_cache import global_cube_cache
    from pinot_tpu_torch.segment import load_segment
    from pinot_tpu_torch.tools import ssb
    from test_torch_tier import reset_port_memory

    n = 1 << 13
    table = ssb.build_table_dir([n // 8] * 8, str(tmp_path / "eight"))
    single = load_segment(ssb.build_segment_dir(n, str(tmp_path / "one")),
                          "cpu")
    digests = {qid: ssb._digest(ssb.oracle_run(single, p, v, g)[0])
               for qid, p, v, g in ssb.QUERIES}
    reset_port_memory([single])
    launched, held = _fingerprinted_compact(monkeypatch, "_control_k1")
    monkeypatch.setattr(chip_smoke, "CACHE", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "ITERS", 1)
    monkeypatch.setattr(chip_smoke, "CONTROL_ROWS", 1 << 13)
    monkeypatch.setattr(chip_smoke, "CONTROL_QS_ROWS", 500)
    printed = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda label, **f: printed.append((label, f)))
    try:
        out = chip_smoke.control_phase(table, digests, 4096, [single],
                                       device="cpu")
    finally:
        global_cube_cache.clear()
        reset_port_memory([single])
    assert out["launches"] > 0
    got = dict(printed)
    commit = got["control_commit"]
    assert commit["segments"] == 8
    assert [p for p, _k in commit["faults_fired"]] == [
        "commit.http_error", "handoff.stall"]
    assert {s["committer"] for s in commit["per_segment"].values()} == {
        "replica_0", "replica_1"}
    moved = got["control_rebalance"]
    assert moved["pass_result"]["executed"] >= 1
    assert all(m["donor_device_bytes"] == 0 for m in moved["moves"])
    assert got["control_autopsy"]["scores"]["rebalance_churn"] > 0
    assert got["control_minion"]["r2o"]["rows"] == 1 << 13
    assert "cpu" in got["control_quickstart"]["served"]
    labels = {f["query"].split(":")[0] for label, f in printed
              if label == "kernel_at_control_path"}
    assert labels == {"replica_0", "replica_1", "server", "minion",
                      "merged"}
    servers = {f["query"].split("@")[1].split("/")[0] for label, f in printed
               if label == "kernel_at_control_path"
               and f["query"].startswith("server:")}
    assert servers == {"server_0", "server_1"}
    assert launched and set(launched) <= set(held)
    assert got["control_done"]["bytes_left"] == 0


class _CudaEvent:
    """torch.cuda.Event on the CPU: every pair measures ``ms``."""
    ms = 0.0
    recorded = 0

    def __init__(self, enable_timing=False):
        pass

    def record(self, stream=None):
        _CudaEvent.recorded += 1

    def elapsed_time(self, other):
        return _CudaEvent.ms


@pytest.mark.parametrize("event_ms,error", [
    (0.001, None), (0.0, "no device fence"),
    (1e9, "shorter than their device work")])
def test_missed_profiler_windows_fall_through_to_events(tmp_path,
                                                        monkeypatch,
                                                        event_ms, error):
    """The profiler's window empty: each device_execute span's device
    time comes from the CUDA events it recorded as it opened and at its
    device fence (device_source "events"), the profiler's 0 printed
    beside it; where the events measure nothing, or more than a span
    lasted, the check fails."""
    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.server import TableDataManager
    from pinot_tpu_torch.tools import ssb
    from pinot_tpu_torch.utils import spans

    opened = _stub_profiler(monkeypatch, [[]])
    monkeypatch.setattr(_CudaEvent, "ms", event_ms)
    monkeypatch.setattr(_CudaEvent, "recorded", 0)
    monkeypatch.setattr(torch.cuda, "Event", _CudaEvent)
    fences = []
    real_fence = spans.device_fence
    monkeypatch.setattr(spans, "device_fence",
                        lambda out: fences.append(_CudaEvent.recorded)
                        or real_fence(out))
    printed = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda name, /, **f: printed.append((name, f)))
    dm = TableDataManager("lineorder", device="cpu")
    dm.add_segment_dir(ssb.build_segment_dir(1 << 12, str(tmp_path / "s")))
    b = Broker(device="cpu")
    b.register_table(dm)
    qid, p, v, g = ssb.QUERIES[3]
    sql = ssb.spec_to_sql(p, v, g)
    if error is None:
        row = chip_smoke.trace_check(connect(b), sql, qid, profile=True)
    else:
        with pytest.raises(AssertionError, match=error):
            chip_smoke.trace_check(connect(b), sql, qid, profile=True)
        row = dict(printed)["trace_check"]
    assert len(opened) == 1
    assert row["device_source"] == "events"
    assert row["profiled_spans"] and all(
        d == event_ms and prof == 0.0 and by is None
        for _s, d, prof, by in row["profiled_spans"])
    n_spans = len(row["profiled_spans"])
    assert _CudaEvent.recorded == 2 * n_spans
    # each span's end event is recorded just before its fence waits:
    # the fences see an even count, the start and the end of each span
    assert len(fences) >= n_spans
    assert all(n % 2 == 0 for n in fences[-n_spans:])
    assert row["ok"] == (error is None)
    # the patched fences are put back
    from pinot_tpu_torch.engine import batch, executor, ragged
    assert batch.device_fence is executor.device_fence is \
        ragged.device_fence is real_fence


@pytest.mark.parametrize("drain_at", ["before_acquire", "after_acquire",
                                      "killed"])
def test_recorded_group_is_the_one_that_ran(tmp_path, monkeypatch,
                                            drain_at):
    """A move's drain lands inside an execution, before or after it
    acquires its segments, or the execution is killed after its launches
    (a deadline): the group the control phase records for K1 is the
    group that ran, object for object and in order, and the plans it
    holds are the plans that ran, over those objects."""
    from pinot_tpu_torch.cluster import Controller, ServerNode
    from pinot_tpu_torch.cluster import server_node as SN
    from pinot_tpu_torch.engine import serving
    from pinot_tpu_torch.tools import ssb
    from test_torch_tier import reset_port_memory

    table = ssb.build_table_dir([1 << 10] * 3, str(tmp_path / "t"))
    dirs = sorted(os.path.join(table, d) for d in os.listdir(table))
    ctrl = Controller(str(tmp_path / "ctrl"), heartbeat_timeout=30.0,
                      reconcile_interval=0.2)
    node = None
    try:
        node = ServerNode("server_0", ctrl.url, poll_interval=0.1,
                          device="cpu")
        ctrl.add_table("lineorder", chip_smoke._seg_schema(dirs[0]),
                       replication=1)
        for d in dirs:
            ctrl.add_segment("lineorder", os.path.basename(d), d)
        assert node.wait_for_version(ctrl.routing_snapshot()["version"],
                                     60.0)
        ctrl.stop()                  # no reconcile undoes the drain
        dm = node._tables["lineorder"]
        names = sorted(x.name for x in dm.acquire_segments())
        drained = names[1]
        log, ran = [], []

        def drain():
            if drained in {x.name for x in dm.acquire_segments()}:
                dm.remove_segment(drained)

        real_ctx, real_plan, real_exec = SN.build_query_context, \
            serving.plan_segments, serving.execute_planned

        def ctx_then_drain(stmt):
            if drain_at == "before_acquire":
                drain()
            return real_ctx(stmt)

        def drain_then_plan(ctx, segments, *a, **k):
            if drain_at == "after_acquire":
                drain()
            ran.append(tuple(segments))
            return real_plan(ctx, segments, *a, **k)

        def execute_then_kill(ex):
            out = real_exec(ex)
            if drain_at == "killed":
                raise RuntimeError("killed after its launches")
            return out

        monkeypatch.setattr(SN, "build_query_context", ctx_then_drain)
        monkeypatch.setattr(serving, "plan_segments", drain_then_plan)
        monkeypatch.setattr(serving, "execute_planned", execute_then_kill)
        chip_smoke._record_executions(node, log)
        qid, p, v, g = ssb.QUERIES[3]
        sql = ssb.spec_to_sql(p, v, g)
        if drain_at == "killed":
            with pytest.raises(RuntimeError, match="killed"):
                node._execute(sql, names)
        else:
            node._execute(sql, names)
        assert len(log) == len(ran) == 1
        assert log[0][2] == ran[0]
        assert [x.name for x in ran[0]] == (
            [n for n in names if n != drained]
            if drain_at == "before_acquire" else names)
        [(label, plans)] = chip_smoke._executed_plans(log, {sql: qid},
                                                      "server")
        assert label == f"server:{qid}@server_0/{len(ran[0])}"
        assert [pl.segment for pl in plans] == list(ran[0])
        assert plans is log[0][3]
    finally:
        if node is not None:
            node.stop()
        ctrl.stop()
        reset_port_memory()


@pytest.mark.parametrize("known", [False, True])
def test_control_k1_holds_a_known_overflow_at_full_capacity(
        tmp_path, monkeypatch, known):
    """A per-segment compact plan whose capacity the plan cache knows to
    overflow is launched at full capacity directly (engine/executor), so
    _control_k1 holds its input there too, though the planned capacity
    does not overflow on this segment."""
    from pinot_tpu_torch.engine import executor
    from pinot_tpu_torch.ops import compact
    from pinot_tpu_torch.ops.plan_cache import global_plan_cache
    from pinot_tpu_torch.segment import load_segment
    from pinot_tpu_torch.tools import ssb

    seg = load_segment(ssb.build_segment_dir(1 << 14, str(tmp_path / "s")),
                       "cpu")
    qid, p, v, g = ssb.QUERIES[3]
    [plan] = chip_smoke._plans(ssb.spec_to_sql(p, v, g), [seg])
    assert plan.kernel_plan.strategy == "compact"
    launched, held = _fingerprinted_compact(monkeypatch, "_control_k1")
    monkeypatch.setattr(chip_smoke, "phase", lambda name, /, **f: None)
    global_plan_cache.clear()
    try:
        if known:
            global_plan_cache.mark_overflowed(
                plan.kernel_plan, seg.bucket, plan.slots_cap)
        executor.execute_plan(plan)
        n = chip_smoke._control_k1([(qid, [plan])], 4096, False)
    finally:
        global_plan_cache.clear()
    caps = {plan.slots_cap, compact.full_slots_cap(seg.bucket)}
    assert len(caps) == 2
    assert n == len(held) == (2 if known else 1)
    assert launched and set(launched) <= set(held)


def test_hold_stragglers_waits_for_the_last_execution(tmp_path,
                                                      monkeypatch):
    """A hedge straggler that is still running when its phase holds K1
    logs its execution later: _hold_stragglers waits until none of the
    phase's queries runs, then holds what the straggler ran."""
    import threading

    from pinot_tpu_torch.engine.accounting import global_accountant
    from pinot_tpu_torch.segment import load_segment
    from pinot_tpu_torch.tools import ssb

    seg = load_segment(ssb.build_segment_dir(1 << 14, str(tmp_path / "s")),
                       "cpu")
    qid, p, v, g = ssb.QUERIES[3]
    sql = ssb.spec_to_sql(p, v, g)
    [plan] = chip_smoke._plans(sql, [seg])
    monkeypatch.setattr(chip_smoke, "phase", lambda name, /, **f: None)
    ran: list = []
    global_accountant.register("straggler", sql=sql)

    def straggler():
        time.sleep(0.3)
        ran.append(("server_1", sql, (seg,), [plan]))
        global_accountant.unregister("straggler")

    t = threading.Thread(target=straggler)
    t.start()
    try:
        n = chip_smoke._hold_stragglers(ran, {sql: qid}, "server", 4096,
                                        False)
    finally:
        t.join()
        global_accountant.unregister("straggler")
    assert n >= 1 and ran


def test_loadgen_phase_on_cpu(tmp_path, monkeypatch):
    """The loadgen phase end to end on the CPU at 2^11 rows: two tables
    of four partitions over the Kafka fake and the wire stream, chaos
    armed, drained to the oracle's rows, the ledger records valid with
    backend "cpu", a restart with commit.crash fired, tracked == held."""
    from test_torch_tier import reset_port_memory

    reset_port_memory()
    launched, held = _fingerprinted_compact(monkeypatch, "same_outputs")
    monkeypatch.setattr(chip_smoke, "CACHE", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "LG_ROWS", 1 << 11)
    printed = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda name, /, **f: printed.append((name, f)))
    try:
        launches = chip_smoke.loadgen_phase(device="cpu")
    finally:
        reset_port_memory()
    got = dict(printed)["loadgen"]
    assert got["rows"] == 1 << 11 and got["partitions"] == 8
    assert got["restarts"] >= 1 and "commit.crash" in got["fired_points"]
    assert got["backend"] == "cpu" and got["queries"] > 0
    assert all(t["oracle_ok"] for t in got["per_table"].values())
    assert got["ledger_kinds"] == {"ingest_bench": 1, "ingest_stats": 2}
    assert launches == got["compact_launches"] == got["k1_held_at_launch"]
    assert len(launched) == launches and not held


def test_fuzz_phase_on_cpu(tmp_path, monkeypatch):
    """The fuzz phase end to end on the CPU: 24 specs three ways on a
    2^11-row segment and the aggregations of _fuzz_at_scale device
    against host on a 2^12-row one built by a worker process, every
    route taken, and K1 held on every input the corpus launched, as
    captured at launch."""
    from test_torch_tier import reset_port_memory

    reset_port_memory()
    launched, held = _fingerprinted_compact(monkeypatch, "_hold_captured")
    monkeypatch.setattr(chip_smoke, "CACHE", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "FUZZ_ROWS", 1 << 12)
    monkeypatch.setattr(chip_smoke, "FUZZ_ORACLE_ROWS", 1 << 11)
    monkeypatch.setattr(chip_smoke, "FUZZ_SEED", 23)
    monkeypatch.setattr(chip_smoke, "FUZZ_SPECS", 24)
    printed = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda name, /, **f: printed.append((name, f)))
    try:
        launches = chip_smoke.fuzz_phase(4096, device="cpu")
    finally:
        reset_port_memory()
    got = dict(printed)["fuzz"]
    assert launches > 0 and got["specs"] == 24
    assert set(got["kinds"]) == {"agg", "select", "window"}
    small, scale = (got[k]["specs_per_route"]
                    for k in ("oracle_size", "scale"))
    assert {"compact", "host", "multistage"} <= set(small)
    assert sum(scale.values()) == got["specs_at_scale"] > 0
    assert "compact" in scale and "multistage" not in scale
    assert got["scale_build_s"] > 0
    assert launched and set(launched) <= set(held)
    assert len(launched) == launches == got["k1_checked"] == sum(
        1 for name, _f in printed if name == "kernel_at_fuzz_path")
    assert {f["query"].split(":")[0] for name, f in printed
            if name == "kernel_at_fuzz_path"} == {"oracle", "scale"}


def test_remote_phase_on_cpu(tmp_path, monkeypatch):
    """The remote phase end to end on the CPU at 2^13 rows in 8 Avro
    files: the batch job pushes to s3:// past an injected 500, two
    server nodes download and answer the in-process digests, each other
    scheme's segment answers q1.1 and q2.1, the sinks count the broker's
    queries, the extra formats read, and K1 is held on every compact
    input the servers launched."""
    from test_torch_tier import reset_port_memory

    reset_port_memory()
    launched, held = _fingerprinted_compact(monkeypatch, "_control_k1")
    monkeypatch.setattr(chip_smoke, "CACHE", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "ITERS", 1)
    monkeypatch.setattr(chip_smoke, "REMOTE_ROWS", 1 << 13)
    monkeypatch.setattr(chip_smoke, "REMOTE_WORKERS", 1)
    printed = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda name, /, **f: printed.append((name, f)))
    try:
        launches = chip_smoke.remote_phase(4096, device="cpu")
    finally:
        reset_port_memory()
    got = dict(printed)
    assert launches > 0
    assert got["remote_batch"]["segments"] == 8
    assert sorted(got["remote_schemes"]["schemes"]) == ["abfs", "gs",
                                                        "hdfs"]
    assert set(got["remote_metrics"]["sinks"].values()) == {
        got["remote_metrics"]["broker_queries"]}
    assert got["remote_formats"]["thrift"] == 3
    assert launched and set(launched) <= set(held)
    assert got["remote_done"]["bytes_left"] == 0


def test_fuzz_close_takes_a_rounding_tie_and_refuses_a_difference():
    """fuzzer.digest rounds floats to 9 significant digits, so a value
    on a rounding tie (50.408203125) digests differently 1 ulp apart;
    the fuzz phase's one rule takes that as a tie, and nothing wider."""
    from pinot_tpu_torch.tools import fuzzer

    a = [(87, None, 50.408203125), (3, 1.0, 2.5)]
    b = [(3, 1.0, 2.5), (87, None, 50.408203125 + 7.2e-15)]
    assert fuzzer.digest(a) != fuzzer.digest(b)
    assert chip_smoke._fuzz_close(a, b, a[::-1]) == [(True, True),
                                                      (True, False)]
    for bad in ([(87, None, 50.4082), (3, 1.0, 2.5)],
                [(86, None, 50.408203125), (3, 1.0, 2.5)],
                [(87, 0.0, 50.408203125), (3, 1.0, 2.5)],
                a[:1]):
        assert chip_smoke._fuzz_close(a, b, bad) == [(True, True),
                                                     (False, False)]


def test_compat_phase_on_cpu(tmp_path, monkeypatch):
    """The compat phase end to end on the CPU at 2^13 rows in 8
    segments: the yaml suite rolls every role, the golden segment and
    wire blobs check out, the SSB table answers the in-process digests
    before, during and after each roll (controller, each server, broker),
    and K1 is held on every compact input the phase launched (the
    in-process digests before the path are not the path's)."""
    from test_torch_tier import reset_port_memory

    reset_port_memory()
    launched, held = _fingerprinted_compact(monkeypatch, "_hold_captured",
                                            "_fuzz_recording")
    monkeypatch.setattr(chip_smoke, "CACHE", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "COMPAT_ROWS", 1 << 13)
    printed = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda name, /, **f: printed.append((name, f)))
    from pinot_tpu_torch.utils.devmem import global_device_memory

    try:
        out = chip_smoke.compat_phase(4096, device="cpu")
        # no stack of a stopped server's (retired) segments outlives it
        left = global_device_memory.snapshot()["total"]["bytes"]
    finally:
        reset_port_memory()
    got = dict(printed)
    assert left == 0
    assert out["launches"] > 0 and out["held"] > 0
    assert launched and set(launched) <= set(held)
    assert got["compat_suite"]["rolled"] == [
        "rolled server", "rolled controller", "rolled broker",
        "rolled server", "rolled controller"]
    assert got["compat_golden"]["n_docs"] == 500
    rolls = [f for name, f in printed if name == "compat_roll"]
    assert [r["role"] for r in rolls] == ["controller", "server", "broker"]
    assert sorted(rolls[1]["p50_during_ms"]) == ["server_0", "server_1"]
    assert got["compat_done"]["bytes_left"] == 0
    assert got["compat_done"]["compact_launches"] == out["launches"]
    assert out["held"] == out["launches"] == len(launched)


def _launch_aside(monkeypatch, name: str):
    """chip_smoke.<name> runs, then K1's count moves by one launch that
    never passed the hold (a kernel call that bypassed
    ``ops.compact.compact``)."""
    from pinot_tpu_torch.ops import compact

    real = getattr(chip_smoke, name)

    def with_a_launch_aside(*a, **k):
        out = real(*a, **k)
        compact.launches += 1
        return out

    monkeypatch.setattr(chip_smoke, name, with_a_launch_aside)


def test_control_phase_fails_on_a_launch_it_did_not_hold(tmp_path,
                                                         monkeypatch):
    """The control phase holds every K1 launch of its path on its own
    inputs as it launches and fails on one it did not hold: one launch
    past the hold, right after the replicated commit, fails the
    phase."""
    from pinot_tpu_torch.ops.plan_cache import global_cube_cache
    from pinot_tpu_torch.segment import load_segment
    from pinot_tpu_torch.tools import ssb
    from test_torch_tier import reset_port_memory

    n = 1 << 13
    table = ssb.build_table_dir([n // 8] * 8, str(tmp_path / "eight"))
    single = load_segment(ssb.build_segment_dir(n, str(tmp_path / "one")),
                          "cpu")
    digests = {qid: ssb._digest(ssb.oracle_run(single, p, v, g)[0])
               for qid, p, v, g in ssb.QUERIES}
    reset_port_memory([single])
    _counting_compact(monkeypatch)
    _launch_aside(monkeypatch, "_control_commit")
    monkeypatch.setattr(chip_smoke, "CACHE", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "ITERS", 1)
    monkeypatch.setattr(chip_smoke, "CONTROL_ROWS", 1 << 13)
    monkeypatch.setattr(chip_smoke, "CONTROL_QS_ROWS", 500)
    monkeypatch.setattr(chip_smoke, "phase", lambda label, **f: None)
    try:
        with pytest.raises(AssertionError, match="held at launch"):
            chip_smoke.control_phase(table, digests, 4096, [single],
                                     device="cpu")
    finally:
        global_cube_cache.clear()
        reset_port_memory([single])


def test_remote_phase_fails_on_a_launch_it_did_not_hold(tmp_path,
                                                        monkeypatch):
    """The remote phase fails on a K1 launch of its path that it did not
    hold as it launched (one launch past the hold as the gs:// segment is
    pushed)."""
    from pinot_tpu_torch.cluster import deepstore
    from pinot_tpu_torch.ops import compact
    from test_torch_tier import reset_port_memory

    reset_port_memory()
    _counting_compact(monkeypatch)
    real_upload = deepstore.upload_segment

    def upload_with_a_launch_aside(*a, **k):
        compact.launches += 1
        return real_upload(*a, **k)

    monkeypatch.setattr(deepstore, "upload_segment",
                        upload_with_a_launch_aside)
    monkeypatch.setattr(chip_smoke, "CACHE", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "ITERS", 1)
    monkeypatch.setattr(chip_smoke, "REMOTE_ROWS", 1 << 13)
    monkeypatch.setattr(chip_smoke, "REMOTE_WORKERS", 1)
    monkeypatch.setattr(chip_smoke, "phase", lambda name, /, **f: None)
    try:
        with pytest.raises(AssertionError, match="held at launch"):
            chip_smoke.remote_phase(4096, device="cpu")
    finally:
        reset_port_memory()


def test_mesh_phase_on_cpu(tmp_path, monkeypatch):
    """The mesh phase end to end on the CPU: the SSB table at 2^14 rows in
    8 shared-dictionary segments answers the same digests per segment and
    resident on 1 and 4 logical shards (every query through the mesh),
    the star schema at 2^13 orders rows takes the mesh shuffle, the mesh
    broadcast and the fused hash stages with the oracle's rows, and every
    K1 and hash_partition launch of the path is held as launched."""
    from pinot_tpu_torch.ops import hashpart
    from test_torch_tier import reset_port_memory

    reset_port_memory()
    _counting_compact(monkeypatch)
    real_hp = hashpart.hash_partition
    hp_calls = []

    def counted_hp(*a, **k):
        hp_calls.append(1)
        hashpart.launches += 1
        return real_hp(*a, **k)

    monkeypatch.setattr(hashpart, "hash_partition", counted_hp)
    monkeypatch.setenv("PINOT_DEVICE_JOIN_MIN_ROWS", "0")
    monkeypatch.setattr(chip_smoke, "CACHE", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "ITERS", 1)
    monkeypatch.setattr(chip_smoke, "MESH_ROWS", 1 << 14)
    monkeypatch.setattr(chip_smoke, "MS_ROWS", 1 << 13)
    printed = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda name, /, **f: printed.append((name, f)))
    try:
        tables, dirs = chip_smoke.star_phase()
        out = chip_smoke.mesh_phase(dirs, tables, 4096, device="cpu")
    finally:
        reset_port_memory()
    got = dict(printed)
    assert out["k1_launches"] > 0 and out["hp_launches"] > 0
    done = got["mesh_done"]
    assert done["k1_held_at_launch"] == out["k1_launches"]
    assert done["hashpart_held_at_launch"] == out["hp_launches"]
    assert done["bytes_left"] == 0
    ms = got["mesh_multistage"]
    assert ms["joins"]["mesh_joins"] >= 2 and ms["fused"]["fused_plans"] == 2
    assert ["hash", "hash"] in ms["stage_kinds"]
    queries = [f for name, f in printed if name == "mesh_query"]
    assert len(queries) == 13 and all(q["ok"] for q in queries)
    assert got["hashpart_edges"]["overflow_cases"] == [
        "one_partition_overflow", "tile_past_cap_for_one_partition"]
    # K18 on each query's first call and both K16 mesh joins, alone
    alone = [f for name, f in printed if name == "traced_at_mesh_path"]
    assert {f["name"] for f in alone} == {
        "k18_distributed_kernel", "k16_mesh_shuffle_join",
        "k16_mesh_equi_join"}
    assert all(f["bound_ms"] > 0 for f in alone)
    assert len(out["alone"]["k18"]) == 13
    # one launch a query a shard on the 4-shard arm's compact queries
    labels = [f["query"] for name, f in printed
              if name == "kernel_at_mesh_path"]
    assert any(lb.startswith("mesh_4:") for lb in labels)
    assert any(lb.startswith("per_segment:") for lb in labels)


def cpu_baselines(monkeypatch, tmp_path) -> None:
    """The ratchets' default baselines become a span and a freshness
    baseline of this environment (the CPU's header, as ``update`` writes
    it) that hold no shape and no scenario: the env pin and the exit
    codes run as on the card, while no wall-clock bar is judged on the
    CPU (the committed baselines are the card's, where the bars are)."""
    import json

    from pinot_tpu_torch.tools import freshness_gate, span_diff

    env = span_diff.capture_env("cpu")
    span, fresh = tmp_path / "span_cpu.json", tmp_path / "fresh_cpu.json"
    span.write_text(json.dumps({"v": 1, "env": env, "shapes": {}}))
    fresh.write_text(json.dumps({"v": 1, "env": env, "scenarios": {}}))
    monkeypatch.setattr(span_diff, "DEFAULT_BASELINE", str(span))
    monkeypatch.setattr(freshness_gate, "DEFAULT_BASELINE", str(fresh))


# the gates phase's modes at CPU sizes (the card runs GATES_MODES)
_CPU_GATES = (
    ("base", ["--rows", "4096", "--queries", "q3.2,q4.1"]),
    ("tier", ["--tier", "--rows", "512", "--queries", "q2.1,q4.1"]),
    ("overload", ["--overload", "--rows", "512", "--replay-queries",
                  "24"]),
    ("autopsy", ["--autopsy", "--rows", "512"]),
    ("rebalance", ["--rebalance", "--rows", "512", "--queries", "q2.1"]),
    ("vector", ["--vector", "--rows", "1024"]),
    ("fused", ["--fused", "--rows", "1024"]),
    ("rate", ["--rate", "--rows", "200", "--gate-iters", "1"]),
    ("ingest", ["--ingest", "--seeds", "40"]),
)


def _gates(monkeypatch, tmp_path, modes):
    from test_torch_tier import reset_port_memory

    reset_port_memory()
    monkeypatch.setattr(chip_smoke, "CACHE", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "GATES_MODES", modes)
    printed = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda name, /, **f: printed.append((name, f)))
    cpu_baselines(monkeypatch, tmp_path)
    return printed, dict(device="cpu")


def test_gates_phase_on_cpu(tmp_path, monkeypatch):
    """The gates phase end to end on the CPU at small rows: all nine
    chaos_smoke modes green through the CLI entry point, the span
    capture checked against a CPU baseline with exit 0, K1 held on every
    compact input the path launched, K15's calls held, nothing armed or
    pinned afterwards, tracked == held, and every node's threads ended
    and ports closed."""
    from pinot_tpu_torch.broker.workload import global_governor
    from pinot_tpu_torch.utils import faults
    from pinot_tpu_torch.utils.devmem import global_device_memory
    from test_torch_tier import reset_port_memory

    launched, held = _fingerprinted_compact(monkeypatch, "_hold_captured",
                                            "_fuzz_recording")
    printed, kw = _gates(monkeypatch, tmp_path, _CPU_GATES)
    try:
        out = chip_smoke.gates_phase(4096, **kw)
        left = global_device_memory.snapshot()["total"]["bytes"]
    finally:
        reset_port_memory()
    got = dict(printed)
    modes = [f for name, f in printed if name == "gates_mode"]
    assert [m["mode"] for m in modes] == [m for m, _a in _CPU_GATES]
    assert all(m["ok"] and m["exit"] == 0 and m["seconds"] > 0
               for m in modes)
    assert all(m["faults_fired"] >= 1 for m in modes), modes
    assert got["gates_span"]["exit"] == 0
    assert got["gates_span"]["env_mismatch"] is None
    assert got["gates_replay"]["shed_by_tenant"].get("ten_besteffort", 0) \
        >= 1 and got["gates_replay"]["deterministic"] is True
    assert "ten_protected" not in got["gates_replay"]["shed_by_tenant"]
    assert out["launches"] > 0 and out["held"] == out["launches"]
    assert launched and set(launched) <= set(held)
    assert out["held"] == len(launched)
    assert out["k15_held"] > 0 and out["k15_launches"] == 0   # CPU
    done = got["gates_done"]
    assert done["tracked_equals_held"] and done["bytes_left"] == 0
    assert left == 0
    # 3 HTTP nodes and 2 gRPC listeners a cluster at least, all closed
    assert done["listeners_checked"] >= 5 and done["listeners_left"] == 0
    assert done["server_threads_left"] == 0
    assert sorted(done["mode_seconds"]) == sorted(
        [m for m, _a in _CPU_GATES] + ["span"])
    assert not faults.active() and not global_governor.snapshot()["pinned"]


# one gate whose path launches K1 on the CPU
_ONE_GATE = (("base", ["--rows", "4096", "--queries", "q3.2"]),)


def test_gates_phase_fails_on_a_launch_it_did_not_hold(tmp_path,
                                                       monkeypatch):
    """One K1 launch past the capture, right after a gate, fails the
    phase."""
    from test_torch_tier import reset_port_memory

    _counting_compact(monkeypatch)
    _launch_aside(monkeypatch, "_run_gate")
    _printed, kw = _gates(monkeypatch, tmp_path, _ONE_GATE)
    try:
        with pytest.raises(AssertionError, match="of them held") as e:
            chip_smoke.gates_phase(4096, **kw)
    finally:
        reset_port_memory()
    launched, held = map(int, re.findall(r"(\d+) K1 launches, (\d+)",
                                         str(e.value))[0])
    assert launched == held + 1 and held > 0


def test_no_armed_plan_or_pinned_rung_survives_the_gates(tmp_path,
                                                         monkeypatch):
    """A gate that leaves a fault plan armed and a rung pinned (its
    mode's own work done) is cleaned up by chaos_smoke on the way out:
    the phase passes and neither survives it; and a phase whose tool did
    not clean up fails."""
    from pinot_tpu_torch.broker.workload import global_governor
    from pinot_tpu_torch.tools import chaos_smoke as CS
    from pinot_tpu_torch.utils import faults
    from test_torch_tier import reset_port_memory

    real_base = CS.main_base

    def base_then_arm(args):
        rc = real_base(args)
        faults.install("seed=1; rpc.drop: match=nowhere, times=-1")
        global_governor.pin_rungs({"gates_q": 3})
        return rc

    monkeypatch.setattr(CS, "main_base", base_then_arm)
    _counting_compact(monkeypatch)
    _printed, kw = _gates(monkeypatch, tmp_path, _ONE_GATE)
    try:
        chip_smoke.gates_phase(4096, **kw)
        assert not faults.active()
        assert not global_governor.snapshot()["pinned"]
        # without chaos_smoke's clean-up the phase itself refuses
        monkeypatch.setattr(CS, "restore_globals", lambda: None)
        with pytest.raises(AssertionError, match="outlived the phase"):
            chip_smoke.gates_phase(4096, **kw)
    finally:
        faults.clear()
        global_governor.unpin()
        reset_port_memory()


@pytest.mark.parametrize("left", ["thread", "port"])
def test_gates_phase_fails_on_a_node_left_running(tmp_path, monkeypatch,
                                                  left):
    """A gate that leaves an HTTP server of its own running (its thread
    alive) or listening (its thread ended, its socket open) fails the
    phase."""
    from pinot_tpu_torch.cluster.http_util import JsonHandler, start_http
    from pinot_tpu_torch.tools import chaos_smoke as CS
    from test_torch_tier import reset_port_memory

    real_base = CS.main_base
    started = []

    def base_then_serve(args):
        rc = real_base(args)
        srv, port, thread = start_http(JsonHandler)
        started.append(srv)
        if left == "port":
            srv.shutdown()
            thread.join(timeout=10)
            assert not thread.is_alive()
        return rc

    monkeypatch.setattr(CS, "main_base", base_then_serve)
    monkeypatch.setattr(chip_smoke, "SERVER_DRAIN_S", 0.5)
    _counting_compact(monkeypatch)
    _printed, kw = _gates(monkeypatch, tmp_path, _ONE_GATE)
    want = "outlive the nodes" if left == "thread" else "still listens"
    try:
        with pytest.raises(AssertionError, match=want):
            chip_smoke.gates_phase(4096, **kw)
    finally:
        for srv in started:
            if left == "thread":
                srv.shutdown()
            srv.server_close()
        reset_port_memory()


def test_concurrent_waves_refuses_without_a_card(capsys):
    """The waves A/B of the concurrent phase runs on the card only: here
    it exits 2 before building anything."""
    from pinot_tpu_torch.tools import concurrent_waves

    assert not torch.cuda.is_available()
    assert concurrent_waves.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
