"""The port's CUDA kernels on the card (skipped without a GPU).

Run on the machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The compaction kernel must equal its plain version bitwise: at sizes on
and around its tile edges, with masks and columns that start off a
16-byte boundary, with all 8 columns in mixed 4- and 8-byte types, with
exactly ``cap`` matched rows, with a bool mask that views bytes other
than 0 and 1, on a side stream, and over 20 launches in a row. The
port's broker on ``"cuda"`` must answer the SSB queries as the numpy
oracle does, through the kernel; over a four-segment table it must give
the CPU's rows for the SSB and surface queries, through the segmented
compaction; and the selection kernel must cut a run of equal order keys
where the CPU does. The over-budget pipeline (K13) must give every
segment of a nine-segment table the CPU's partial, 20 times in a row (a
missing wait between the copy stream and the compute stream would let a
staging slot be overwritten while a kernel still reads it), also with each
race widened by spins queued on the streams, and with any one of its three
waits dropped under the widened race it must give wrong partials (so the
equality above is what would catch the loss of a wait); and the
device tier must give the CPU's rows with the segments hot, warm, cold
and under a budget below the working set. Cross-query micro-batching
(K14) must give the serial rows under 32 concurrent threads with its
cubes on the card, and a cube read by a follower while its build is
still queued behind a spin on another stream must equal the CPU's;
published without the fence on its build, it must not. The segmented
scan (K17) must equal its plain version (bitwise for int64 and for
min/max, to a relative 1e-12 for float64 sums) at sizes on and around
its tile, with one partition, every row a reset, partition starts on
tile edges and flags off a word boundary; the star schema's join and
window shapes on the card must give the CPU's rows on every plane, and a
fuzzer seed on the card the oracle's. A BITPACK and a COMPRESSED copy of
the SSB segment must give the PLAIN segment's digests on the card, star-tree
rollups the CPU's rows with their tensors accounted, EXPLAIN ANALYZE
on the card a tree of the expected phases whose children do not sum past
its wall time, and OPTION(profilePhases=true) a phase ladder timed with
CUDA events. A two-server cluster fleet on the card (server nodes, a
broker node over loopback HTTP) must give the CPU fleet's rows through
K1 on its servers, with host values only on the wire and every resident
column on the card by the servers' /debug/memory. Two realtime replicas
on the card must commit and adopt through the controller the segments
the CPU's do, answer with the CPU's rows through K1, and the minion's
offline segments built from them must load on the card with those rows.
A chaos-armed loadgen run on the card must end in the CPU run's rows, and
the query fuzzer's corpus on the card must give the host path's and the
oracle's rows through K1.
"""
import json
import os
import time

import pytest
import torch

from pinot_tpu_torch.tools import ssb

pytestmark = pytest.mark.cuda

SIZES = [1 << 20, (1 << 20) - 333, 0, 1, "tile-1", "tile", "tile+1",
         "33*tile+7"]
TILE_EDGES = {"tile-1": lambda t: t - 1, "tile": lambda t: t,
              "tile+1": lambda t: t + 1, "33*tile+7": lambda t: 33 * t + 7}
TWO = ("int32", "float64")
MIXED8 = ("int32", "int64", "float32", "float64") * 2
LAYOUTS = {"aligned": (0, TWO), "offset3": (3, TWO),
           "mixed8": (0, MIXED8), "offset3-mixed8": (3, MIXED8)}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _size(n, tile):
    """A size in rows; the names are edges of the kernel's tile."""
    return TILE_EDGES[n](tile) if isinstance(n, str) else n


def _inputs(dev, n, sel, offset, names, seed):
    """mask and columns of n rows, sliced ``offset`` rows into their
    allocations (so data_ptr() is off a 16-byte boundary when offset
    is not a multiple of 16)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    m = n + offset
    mask = (torch.rand(m, device=dev, generator=g) < sel)[offset:]
    make = {
        "int32": lambda: torch.randint(-2**31, 2**31 - 1, (m,), device=dev,
                                       dtype=torch.int32, generator=g),
        "int64": lambda: torch.randint(-2**62, 2**62, (m,), device=dev,
                                       dtype=torch.int64, generator=g),
        "float32": lambda: torch.randn(m, device=dev, dtype=torch.float32,
                                       generator=g),
        "float64": lambda: torch.randn(m, device=dev, dtype=torch.float64,
                                       generator=g)}
    return mask, tuple(make[k]()[offset:] for k in names)


def _assert_equal(got, want):
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int64 if a.element_size() == 8
                                  else torch.int32),
                           b.view(torch.int64 if b.element_size() == 8
                                  else torch.int32))
    for a, b in zip(got[2:], want[2:]):
        assert a.dtype == torch.int32 and int(a) == int(b)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("n", SIZES, ids=str)
@pytest.mark.parametrize("sel", [0.0, 0.01, 0.5, 1.0])
def test_compact_kernel_equals_plain_version(cuda, n, sel, layout):
    from pinot_tpu_torch.ops import compact as C

    n = _size(n, C.tile_rows())
    offset, names = LAYOUTS[layout]
    mask, cols = _inputs(cuda, n, sel, offset, names, n + int(sel * 100))
    if offset and n:
        assert mask.data_ptr() % 16 != 0
    matched = int(mask.sum())
    for cap in (1, max(matched // (2 * C.LANES), 1), C.default_slots_cap(n),
                C.full_slots_cap(n)):
        before = C.launches
        got = C.compact(mask, cols, cap)
        want = C.compact_reference(mask, cols, cap)
        torch.cuda.synchronize()
        assert C.launches == before + 1
        _assert_equal(got, want)
        assert int(got[4]) == int(matched > cap * C.LANES)


def test_compact_kernel_matched_equals_cap(cuda):
    from pinot_tpu_torch.ops import compact as C

    n = 33 * C.tile_rows() + 7
    slots_cap = 40
    cap = slots_cap * C.LANES
    g = torch.Generator(device=cuda)
    g.manual_seed(40)
    mask = torch.zeros(n, dtype=torch.bool, device=cuda)
    mask[torch.randperm(n, device=cuda, generator=g)[:cap]] = True
    _m, cols = _inputs(cuda, n, 0.0, 0, MIXED8, 41)
    got = C.compact(mask, cols, slots_cap)
    _assert_equal(got, C.compact_reference(mask, cols, slots_cap))
    assert (int(got[2]), int(got[3]), int(got[4])) == (cap, cap, 0)
    assert bool(got[0].all())


@pytest.mark.parametrize("offset", [0, 3])
def test_compact_kernel_keeps_every_nonzero_mask_byte(cuda, offset):
    from pinot_tpu_torch.ops import compact as C

    n = 33 * C.tile_rows() + 7
    g = torch.Generator(device=cuda)
    g.manual_seed(50 + offset)
    raw = torch.randint(0, 4, (n + offset,), device=cuda, dtype=torch.uint8,
                        generator=g)[offset:]
    _m, cols = _inputs(cuda, n, 0.0, offset, MIXED8, 51)
    for cap in (C.default_slots_cap(n), C.full_slots_cap(n)):
        got = C.compact(raw.view(torch.bool), cols, cap)
        _assert_equal(got, C.compact_reference(raw != 0, cols, cap))


def test_compact_kernel_on_side_stream(cuda):
    from pinot_tpu_torch.ops import compact as C

    n = 33 * C.tile_rows() + 7
    mask, cols = _inputs(cuda, n, 0.2, 3, MIXED8, 7)
    want = C.compact_reference(mask, cols, C.default_slots_cap(n))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = C.compact(mask, cols, C.default_slots_cap(n))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    _assert_equal(got, want)


def test_compact_kernel_repeats_bitwise(cuda):
    from pinot_tpu_torch.ops import compact as C

    n = (1 << 22) + 5
    mask, cols = _inputs(cuda, n, 0.03, 0, ("int32", "int32"), 20)
    cap = C.default_slots_cap(n)
    runs = [C.compact(mask, cols, cap) for _ in range(20)]  # no sync between
    torch.cuda.synchronize()
    _assert_equal(runs[0], C.compact_reference(mask, cols, cap))
    for r in runs[1:]:
        _assert_equal(r, runs[0])


def test_ssb_on_cuda_matches_oracle(cuda, tmp_path):
    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.ops import compact as C
    from pinot_tpu_torch.server import TableDataManager

    seg_dir = ssb.build_segment_dir(1 << 16, str(tmp_path))
    dm = TableDataManager("lineorder", device=cuda)
    seg = dm.add_segment_dir(seg_dir)
    b = Broker(device=cuda)
    b.register_table(dm)
    before = C.launches
    for _qid, p, v, g in ssb.QUERIES:
        rows = connect(b)(ssb.spec_to_sql(p, v, g)).rows
        expected, _ = ssb.oracle_run(seg, p, v, g)
        assert ssb._digest(rows) == ssb._digest(expected)
    assert C.launches > before
    assert all(d.startswith("cuda") for d in
               seg.resident_devices().values())


def _close(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= 1e-9 * max(abs(a), abs(b), 1e-300)
    return type(a) is type(b) and a == b


def test_many_segments_on_cuda_match_cpu(cuda, tmp_path):
    """A four-segment table (three share a bucket) on the card and on the
    CPU: every SSB and surface query gives the same rows, the compact
    group-bys through the segmented compaction on the card."""
    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.engine import batch, serving
    from pinot_tpu_torch.ops import compact as C
    from pinot_tpu_torch.query.context import build_query_context
    from pinot_tpu_torch.query.sql import parse_sql
    from pinot_tpu_torch.server import TableDataManager

    d = ssb.build_table_dir([50_000, 40_000, 60_000, 30_000], str(tmp_path))
    queries = {}
    for dev in (cuda, "cpu"):
        dm = TableDataManager("lineorder", device=dev)
        dm.add_table_dir(d)
        b = Broker(device=dev)
        b.register_table(dm)
        queries[str(dev)] = (dm, connect(b))
    dm, on_card = queries["cuda"]
    _dm_cpu, on_cpu = queries["cpu"]
    sqls = [ssb.spec_to_sql(p, v, g) for _q, p, v, g in ssb.QUERIES] \
        + [sql for _n, sql, _k in ssb.SURFACE]
    routes = set()
    before = C.launches
    for sql in sqls:
        assert _close(on_card(sql).rows, on_cpu(sql).rows), sql
        ex = serving.execute_segments(build_query_context(parse_sql(sql)),
                                      dm.acquire_segments())
        routes |= set(ex.routes)
    assert batch.SEGMENTED in routes and batch.BATCHED in routes
    assert C.launches > before


def test_select_kernel_tie_order_on_cuda(cuda):
    """A LIMIT that cuts a run of equal order keys selects the same rows
    on the card as on the CPU: the lowest rows of the run."""
    from pinot_tpu_torch.ops import ir
    from pinot_tpu_torch.ops.kernels import build_select_kernel

    bucket, n_docs = 1 << 20, (1 << 20) - 77
    g = torch.Generator().manual_seed(5)
    cols = (torch.randint(0, 3, (bucket,), dtype=torch.int32, generator=g),
            torch.arange(bucket, dtype=torch.int32))
    for order in (((0, False, 3),), ((0, True, 3),), ()):
        sp = ir.SelectPlan(pred=ir.TrueP(), select_cols=(1, 0),
                           order=order, k=1000)
        fn = build_select_kernel(sp, bucket)
        want = fn(cols, n_docs, ())
        got = fn(tuple(c.to(cuda) for c in cols), n_docs, ())
        for key in want:
            assert torch.equal(got[key].cpu(), want[key]), (order, key)


PIPE_SQL = [ssb.spec_to_sql(p, v, g) for qid, p, v, g in ssb.QUERIES
            if qid.startswith("q1")] + [
    "SELECT d_year, SUM(lo_revenue), MIN(lo_quantity), COUNT(*) FROM "
    "lineorder WHERE lo_discount BETWEEN 1 AND 3 GROUP BY d_year "
    "ORDER BY d_year OPTION(groupByStrategy=dense)"]


@pytest.fixture()
def nine_segments(tmp_path):
    """Nine segments of distinct rows on the card and on the CPU: an odd
    count reuses each of the pipeline's two slots several times."""
    from pinot_tpu_torch.server import TableDataManager

    d = ssb.build_table_dir([100_000 + 1_000 * k for k in range(9)],
                                str(tmp_path))
    out = {}
    for dev in ("cuda", "cpu"):
        dm = TableDataManager("lineorder", device=dev)
        dm.add_table_dir(d)
        out[dev] = dm
    return out


def _pipelined_partials(dm, sql):
    from pinot_tpu_torch.engine import batch, serving
    from pinot_tpu_torch.query.context import build_query_context
    from pinot_tpu_torch.query.sql import parse_sql

    ex = serving.execute_segments(build_query_context(parse_sql(sql)),
                                  dm.acquire_segments())
    assert set(ex.routes) == {batch.PIPELINED}, (sql, ex.routes)
    return ex.partials


@pytest.mark.parametrize("query", range(len(PIPE_SQL)))
def test_pipeline_on_cuda_matches_cpu_per_segment(cuda, nine_segments,
                                                  monkeypatch, query):
    """Every segment's partial streamed through the double buffer on the
    card equals the CPU's, and the streamed columns stay out of the
    segments' device cache."""
    from pinot_tpu_torch.engine import pipeline

    monkeypatch.setenv("PINOT_HBM_BUDGET_BYTES", "1")
    sql = PIPE_SQL[query]
    before = pipeline.STATS["pipelined_segments"]
    got = _pipelined_partials(nine_segments["cuda"], sql)
    assert pipeline.STATS["pipelined_segments"] == before + 9
    assert len(pipeline.LAST_RUN["h2d"]) == 9      # one copy per segment
    assert got == _pipelined_partials(nine_segments["cpu"], sql)
    segs = nine_segments["cuda"].acquire_segments()
    assert not [k for s in segs for k in s._device
                if not k[0].startswith("__")]


def test_pipeline_on_cuda_repeats_20_times(cuda, nine_segments,
                                           monkeypatch):
    monkeypatch.setenv("PINOT_HBM_BUDGET_BYTES", "1")
    sql = PIPE_SQL[-1]
    want = _pipelined_partials(nine_segments["cpu"], sql)
    for _ in range(20):
        assert _pipelined_partials(nine_segments["cuda"], sql) == want


SLEEP_CYCLES = 50_000_000        # about 25 ms at the H100's 1.98 GHz


def _seg_device(dm):
    """The device the segments resolved to (``cuda:N``: the pipeline keys
    its copy stream by the index)."""
    return dm.acquire_segments()[0].device


def _widen_race(monkeypatch, dev, kernel_sleep: bool, copy_sleep: bool):
    """Make every pipeline race wide: a spin of SLEEP_CYCLES queued on the
    compute stream before each pipelined kernel and/or on the copy stream
    before each copy event. The host fill of a 100k-row segment is far
    shorter than that, so a missing wait lets a slot be read before its
    copy lands or overwritten while a kernel still reads it. The device
    slots start from zeros: a read too early then sees valid dictionary
    ids (zeros or another segment's), never garbage."""
    from pinot_tpu_torch.engine import pipeline

    slots = pipeline._slots

    def zeroed(*a, **k):
        out = slots(*a, **k)
        for bufs in out:
            for _pinned, d in bufs:
                d.zero_()
        torch.cuda.synchronize()
        return out
    monkeypatch.setattr(pipeline, "_slots", zeroed)
    if kernel_sleep:
        build = pipeline.build_kernel

        def slow_build(*a, **k):
            fn = build(*a, **k)

            def slow(*args):
                torch.cuda._sleep(SLEEP_CYCLES)
                return fn(*args)
            return slow
        monkeypatch.setattr(pipeline, "build_kernel", slow_build)
    if copy_sleep:
        copy = pipeline._copy_stream(dev)
        record = torch.cuda.Event.record

        def slow_record(self, stream=None):
            if stream is not None and stream == copy:
                with torch.cuda.stream(copy):
                    torch.cuda._sleep(SLEEP_CYCLES)
            return record(self, stream)
        monkeypatch.setattr(torch.cuda.Event, "record", slow_record)


@pytest.mark.parametrize("sleep", ["kernel", "copy", "both"])
@pytest.mark.parametrize("query", [0, len(PIPE_SQL) - 1])
def test_pipeline_on_cuda_matches_cpu_with_wide_races(cuda, nine_segments,
                                                      monkeypatch, sleep,
                                                      query):
    """With slow kernels, slow copies or both, every wait holds: each
    segment's partial still equals the CPU's."""
    monkeypatch.setenv("PINOT_HBM_BUDGET_BYTES", "1")
    sql = PIPE_SQL[query]
    want = _pipelined_partials(nine_segments["cpu"], sql)
    _widen_race(monkeypatch, _seg_device(nine_segments["cuda"]),
                sleep in ("kernel", "both"),
                sleep in ("copy", "both"))
    assert _pipelined_partials(nine_segments["cuda"], sql) == want


# each wait, and the sleep that opens the race it closes: the host's wait
# on the slot's last copy (slow copies: the refill lands before the copy
# reads), the copy stream's wait on the slot's last kernel (slow kernels:
# the next copy overwrites the slot under it), the compute stream's wait
# on the copy (slow copies: the kernel reads the slot before it lands)
WAITS = {"host": "copy", "copy": "kernel", "compute": "copy"}


@pytest.mark.parametrize("wait", list(WAITS))
def test_pipeline_on_cuda_needs_each_wait(cuda, nine_segments, monkeypatch,
                                          wait):
    """Dropping any one of the three waits gives wrong partials once the
    race it closes is wide: the test above would catch its loss."""
    from pinot_tpu_torch.engine import pipeline

    monkeypatch.setenv("PINOT_HBM_BUDGET_BYTES", "1")
    sql = PIPE_SQL[0]
    want = _pipelined_partials(nine_segments["cpu"], sql)
    dev = _seg_device(nine_segments["cuda"])
    _widen_race(monkeypatch, dev, WAITS[wait] == "kernel",
                WAITS[wait] == "copy")
    if wait == "host":
        monkeypatch.setattr(torch.cuda.Event, "synchronize",
                            lambda self: None)
    else:
        copy = pipeline._copy_stream(dev)
        wait_event = torch.cuda.Stream.wait_event

        def some_waits(self, event):
            if (self == copy) == (wait == "copy"):
                return None              # the dropped wait
            return wait_event(self, event)
        monkeypatch.setattr(torch.cuda.Stream, "wait_event", some_waits)
    got = _pipelined_partials(nine_segments["cuda"], sql)
    torch.cuda.synchronize()
    assert got != want, f"dropping the {wait} wait changed nothing"


def test_tier_demote_and_promote_on_cuda(cuda, nine_segments):
    """Rows on the card equal the CPU's with the segments hot, warm, cold
    and under a budget below the working set; the tracked device bytes
    equal the tensors held after each step."""
    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.engine import batch
    from pinot_tpu_torch.engine.tier import (TIER_COLD, TIER_WARM,
                                             global_tier, reconcile_devmem)
    from pinot_tpu_torch.utils.devmem import global_device_memory

    brokers = {}
    for dev, dm in nine_segments.items():
        b = Broker(device=dev)
        b.register_table(dm)
        brokers[dev] = connect(b)
    segs = nine_segments["cuda"].acquire_segments()
    sqls = [ssb.spec_to_sql(p, v, g) for _q, p, v, g in ssb.QUERIES]
    want = [brokers["cpu"](sql).rows for sql in sqls]
    # the registry is process-wide: start it from what these tables hold
    # (segments of earlier tests were dropped without remove_segment)
    live = segs + nine_segments["cpu"].acquire_segments()
    for s in live:
        s.evict_device()
    batch.clear_stack_cache()
    global_device_memory.clear()

    def check():
        for sql, rows in zip(sqls, want):
            assert _close(brokers["cuda"](sql).rows, rows), sql
            rec = reconcile_devmem(live)
            assert all(r["tracked"] == r["actual"] for r in rec.values()), \
                rec

    try:
        global_tier.configure(budget_bytes=1 << 40)
        check()
        for to in (TIER_WARM, TIER_COLD):
            for s in segs:
                assert global_tier.demote(s, to)
            p0 = global_tier.promotions
            check()
            assert global_tier.promotions >= p0 + len(segs)
        d0 = global_tier.demotions
        global_tier.configure(budget_bytes=16 << 20)
        check()
        assert global_tier.demotions > d0
    finally:
        global_tier.configure(budget_bytes=None)
        for s in live:
            s.evict_device()
        batch.clear_stack_cache()


@pytest.fixture()
def cube_table(tmp_path):
    """One 2^17-row SSB segment on the card and on the CPU (every
    concurrent shape's cube fits its bucket), with an empty cube cache
    before and after (the tier tests above reconcile the cube pools)."""
    from pinot_tpu_torch.engine.ragged import global_batcher
    from pinot_tpu_torch.ops.plan_cache import global_cube_cache
    from pinot_tpu_torch.server import TableDataManager

    seg_dir = ssb.build_segment_dir(1 << 17, str(tmp_path))
    global_cube_cache.clear()
    out = {}
    for dev in ("cuda", "cpu"):
        dm = TableDataManager("lineorder", device=dev)
        dm.add_segment_dir(seg_dir)
        out[dev] = dm
    yield out
    global_batcher.configure(enabled=True, window_ms=4.0, max_batch=32)
    global_cube_cache.clear()
    for dm in out.values():
        for s in dm.acquire_segments():
            s.evict_device()


def test_fused_vs_serial_under_32_threads_on_cuda(cuda, cube_table):
    """32 concurrent variants of each concurrent shape on the card: the
    fused rows equal the serial ones and the CPU's, the waves fuse, and
    every cube lives on the card."""
    import threading

    from pinot_tpu_torch.broker import Broker
    from pinot_tpu_torch.engine.ragged import global_batcher
    from pinot_tpu_torch.ops.plan_cache import global_cube_cache
    from pinot_tpu_torch.utils.metrics import global_metrics

    brokers = {}
    for dev, dm in cube_table.items():
        brokers[dev] = Broker(device=dev)
        brokers[dev].register_table(dm)
    counters = global_metrics.snapshot()["counters"]
    fused0 = counters.get("batched_dispatches", 0)
    errors0 = counters.get("fused_dispatch_errors", 0)
    for _shape, make in ssb.CONCURRENT:
        sqls = [make(k) + " OPTION(timeoutMs=600000)" for k in range(32)]
        global_batcher.configure(enabled=False)
        serial = [brokers["cuda"].query(s).rows for s in sqls]
        assert all(_close(a, brokers["cpu"].query(s).rows)
                   for a, s in zip(serial, sqls))
        global_batcher.configure(enabled=True, window_ms=8.0, max_batch=32)
        rows = [None] * 32
        errs = []
        barrier = threading.Barrier(32)

        def run(k):
            try:
                barrier.wait(30)
                rows[k] = brokers["cuda"].query(sqls[k]).rows
            except Exception as e:  # noqa: BLE001 - asserted below
                errs.append(repr(e))

        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        assert rows == serial
    counters = global_metrics.snapshot()["counters"]
    assert counters.get("batched_dispatches", 0) > fused0
    assert counters.get("fused_dispatch_errors", 0) == errors0
    cubes = list(global_cube_cache._entries.values()) \
        + list(global_cube_cache._stacked.values())
    assert cubes and all(t.device.type == "cuda"
                         for c in cubes for t in c.values())


RACE_CYCLES = 40 * SLEEP_CYCLES   # about 1 s


def _cube_race(cube_table, fence: bool, monkeypatch):
    """A leader builds a q1.1 cube on a side stream held back by a spin;
    a follower on the default stream asks the cache for the same cube
    while that build is in flight and runs the fused path on it. Returns
    (the follower's partial, the CPU's)."""
    import threading

    from pinot_tpu_torch.engine import ragged
    from pinot_tpu_torch.engine.executor import (extract_partial,
                                                 resolve_params,
                                                 run_kernel)
    from pinot_tpu_torch.ops.plan_cache import global_cube_cache
    from pinot_tpu_torch.query.context import build_query_context
    from pinot_tpu_torch.query.planner import SegmentPlanner
    from pinot_tpu_torch.query.sql import parse_sql

    if not fence:
        monkeypatch.setattr(ragged, "_fence", lambda tree: None)
    # the spin goes inside the cube build, after the build's own uploads
    # of its params (a pageable upload waits for the stream, spin and all)
    build = ragged.build_cube_kernel

    def slow_build(spec):
        fn = build(spec)

        def slow(*args):
            torch.cuda._sleep(RACE_CYCLES)
            return fn(*args)
        return slow
    monkeypatch.setattr(ragged, "build_cube_kernel", slow_build)
    sql = ssb.CONCURRENT[0][1](3)
    plans = {dev: SegmentPlanner(build_query_context(parse_sql(sql)),
                                 dm.acquire_segments()[0]).plan()
             for dev, dm in cube_table.items()}
    want = extract_partial(plans["cpu"], run_kernel(plans["cpu"]))
    plan = plans["cuda"]
    spec = ragged.cube_spec_for(plan)[0]
    params = resolve_params(plan)
    plan.segment.device_cols(plan.col_names)      # resident before
    side = torch.cuda.Stream()
    # poison the side stream's free blocks of the cube's size: a read
    # before the build writes them sees -7s, not a stale cube
    with torch.cuda.stream(side):
        junk = [torch.full((spec.cube_space + 1,), -7, dtype=torch.int64,
                           device="cuda") for _ in range(4)]
    torch.cuda.synchronize()
    del junk
    global_cube_cache.clear()
    batcher = ragged.RaggedBatcher(enabled=True)
    got = {}

    def leader():
        with torch.cuda.stream(side):
            sub = ragged._Submission([plan], [params], None)
            got["leader"] = batcher._execute_fused(spec, [sub])[id(sub)][0]

    t = threading.Thread(target=leader)
    t.start()
    deadline = time.perf_counter() + 10
    while not global_cube_cache._building and "leader" not in got:
        assert time.perf_counter() < deadline
        time.sleep(1e-4)
    sub = ragged._Submission([plan], [params], None)
    follower = batcher._execute_fused(spec, [sub])[id(sub)][0]
    t.join(30)
    torch.cuda.synchronize()
    assert global_cube_cache.stats()["misses"] == 1   # one build, shared
    return follower, want


def test_cube_read_during_its_build_equals_cpu(cuda, cube_table,
                                               monkeypatch):
    follower, want = _cube_race(cube_table, True, monkeypatch)
    assert vars(follower) == vars(want)


def test_cube_read_during_its_build_needs_the_fence(cuda, cube_table,
                                                    monkeypatch):
    """Publishing the cube before its build finished lets the follower
    read unwritten cells: the test above would catch the fence's loss."""
    follower, want = _cube_race(cube_table, False, monkeypatch)
    assert vars(follower) != vars(want)


# -- the multi-stage engine: K17's segmented scan, K16, K19 ---------------

SCAN_SIZES = [1, 2, "tile-1", "tile", "tile+1", "33*tile+7", 1 << 22]
SCAN_FLAGS = ("first", "every", "sparse", "tile_edges", "none")


def _scan_inputs(n, flags_kind, dtype, op, tile, seed):
    """Values and flags on the host, from a seed: int64 values past 2^53
    (sums kept inside int64), float64 sums of positive values (so a
    relative bound means something), signed floats with both zeros for
    min and max."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if dtype == "int64":
        lim = 2**50 if op == "sum" else 2**62
        v = rng.integers(-lim, lim, n).astype(np.int64)
    elif op == "sum":
        v = rng.random(n) * 1e9
    else:
        v = np.round(rng.normal(0, 1e3, n), 1)
        v[rng.random(n) < 0.01] = -0.0
    f = np.zeros(n, dtype=bool)
    if flags_kind == "every":
        f[:] = True
    elif flags_kind == "sparse":
        f = rng.random(n) < 0.001
    elif flags_kind == "tile_edges":
        for k in range(0, n, tile):
            f[k:k + 1] = True
            f[max(k - 1, 0)] = True
    if flags_kind != "none" and n:
        f[0] = True
    return v, f


def _scan_equal(got, want, dtype, op):
    if dtype == "float64" and op == "sum":
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    else:
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("flags_kind", SCAN_FLAGS)
@pytest.mark.parametrize("n", SCAN_SIZES, ids=str)
def test_segscan_kernel_equals_plain_version(cuda, n, flags_kind, dtype,
                                             op):
    """Bitwise for int64 and for min/max, relative 1e-12 for float64
    sums (the two add in different orders)."""
    from pinot_tpu_torch.ops import segscan as S

    tile = S.tile_rows()
    n = _size(n, tile)
    v, f = _scan_inputs(n, flags_kind, dtype, op, tile, n + 7)
    vals = torch.from_numpy(v).to(cuda)
    flags = torch.from_numpy(f).to(cuda)
    before = S.launches
    got = S.seg_scan(op, vals, flags)
    torch.cuda.synchronize()
    assert S.launches == before + 1
    _scan_equal(got, S.seg_scan_reference(op, vals, flags), dtype, op)


@pytest.mark.parametrize("offset", [1, 3])
def test_segscan_kernel_flags_off_a_word_boundary(cuda, offset):
    """A flags slice that does not start on a 4-byte boundary takes the
    kernel's byte loads."""
    from pinot_tpu_torch.ops import segscan as S

    n = 5 * S.tile_rows() + 11
    v, f = _scan_inputs(n + offset, "sparse", "int64", "sum", 4096, 3)
    flags = torch.from_numpy(f).to(cuda)[offset:]
    vals = torch.from_numpy(v).to(cuda)[offset:]
    _scan_equal(S.seg_scan("sum", vals, flags),
                S.seg_scan_reference("sum", vals, flags), "int64", "sum")


def test_segscan_kernel_repeats_bitwise(cuda):
    from pinot_tpu_torch.ops import segscan as S

    v, f = _scan_inputs(1 << 22, "sparse", "float64", "sum", 4096, 5)
    vals = torch.from_numpy(v).to(cuda)
    flags = torch.from_numpy(f).to(cuda)
    runs = [S.seg_scan("sum", vals, flags) for _ in range(20)]
    torch.cuda.synchronize()
    # one kernel, one association order: bitwise across launches
    for r in runs[1:]:
        assert torch.equal(r, runs[0])


def test_segscan_back_to_back_sizes_on_one_scratch(cuda):
    """Calls of different n, one after another on one stream and so on one
    scratch buffer, each checked: a status word an earlier call left (its
    epoch) must never read as this call's."""
    from pinot_tpu_torch.ops import segscan as S

    tile = S.tile_rows()
    runs = []
    for k, n in enumerate((300 * tile + 5, 3 * tile, 1, 1000 * tile + 77,
                           2 * tile - 1, 300 * tile + 5)):
        for op, dtype in (("sum", "float64"), ("max", "int64")):
            v, f = _scan_inputs(n, "none" if k % 2 else "sparse", dtype, op,
                                tile, n + k)
            vals = torch.from_numpy(v).to(cuda)
            flags = torch.from_numpy(f).to(cuda)
            runs.append((S.seg_scan(op, vals, flags), vals, flags, dtype, op))
    torch.cuda.synchronize()
    for got, vals, flags, dtype, op in runs:
        _scan_equal(got, S.seg_scan_reference(op, vals, flags), dtype, op)


def test_segscan_two_streams_from_two_threads(cuda):
    """Two threads scanning at once, each on its own stream (each with
    its own scratch), 10 calls each: every result equals the plain
    version."""
    import threading

    from pinot_tpu_torch.ops import segscan as S

    n = 200 * S.tile_rows() + 3
    inputs = []
    for seed in (1, 2):
        v, f = _scan_inputs(n, "none", "float64", "sum", 4096, seed)
        inputs.append((torch.from_numpy(v).to(cuda),
                       torch.from_numpy(f).to(cuda)))
    want = [S.seg_scan("sum", v, f) for v, f in inputs]
    torch.cuda.synchronize()
    got, errors = [[], []], []

    def work(i):
        try:
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                for _ in range(10):
                    got[i].append(S.seg_scan("sum", *inputs[i]))
            s.synchronize()
        except Exception as e:          # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i in (0, 1):
        assert len(got[i]) == 10
        for g in got[i]:
            assert torch.equal(g, want[i])   # one association order


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_segscan_8_and_16_byte_routes_give_the_same_bits(cuda, op, dtype):
    """vals[1:] is 8-byte aligned only (the 8-byte copies); its contiguous
    clone is 16-byte aligned (the 16-byte copies): the same bits, float64
    sums included."""
    from pinot_tpu_torch.ops import segscan as S

    n = 37 * S.tile_rows() + 9
    v, f = _scan_inputs(n + 1, "sparse", dtype, op, 4096, 11)
    vals = torch.from_numpy(v).to(cuda)[1:]
    flags = torch.from_numpy(f).to(cuda)[1:]
    assert vals.data_ptr() % 16 == 8
    aligned = vals.clone()
    assert aligned.data_ptr() % 16 == 0
    a = S.seg_scan(op, vals, flags)
    b = S.seg_scan(op, aligned, flags.clone())
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    _scan_equal(a, S.seg_scan_reference(op, vals, flags), dtype, op)


# -- K17's partition aggregate (ops/csrc/segagg.cu) ---------------------

AGG_OPS = ("sum", "count", "avg", "min", "max")
AGG_SEGS = (1, 2, 8, "cap-1", "cap", "cap+1", 65536)
AGG_N = (1, 4095, 4096, 4097, 1 << 22)


def _agg_inputs(op, dtype, segs, n, seed):
    """Values and ids on the host, from a seed: int64 over the whole range
    (sums wrap, as the plain version's), positive float64 sums (so a
    relative bound means something), signed floats with both zeros for
    min and max; ones for count, as the window stage passes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, segs, n).astype(np.int64)
    if op == "count":
        v = np.ones(n, dtype=np.int64 if dtype == "int64" else np.float64)
    elif dtype == "int64":
        v = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    elif op in ("sum", "avg"):
        v = rng.random(n) * 1e9
    else:
        v = np.round(rng.normal(0, 1e3, n), 1)
        v[rng.random(n) < 0.02] = 0.0
        v[rng.random(n) < 0.02] = -0.0
    return v, ids


def _agg_equal(got, want, op):
    assert got.dtype == want.dtype
    if got.dtype == torch.float64 and op in ("sum", "avg"):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    else:
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def _agg_segs(segs, cap):
    return {"cap-1": cap - 1, "cap": cap, "cap+1": cap + 1}.get(segs, segs)


@pytest.mark.parametrize("n", AGG_N)
@pytest.mark.parametrize("segs", AGG_SEGS, ids=str)
@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("op", AGG_OPS)
def test_segagg_kernel_equals_plain_version(cuda, op, dtype, segs, n):
    """Bitwise for int64, counts and min/max (against the plain version on
    the CPU: on the card scatter_reduce_ keeps either zero), relative
    1e-12 for float64 sums and averages."""
    from pinot_tpu_torch.ops import segagg as A

    segs = _agg_segs(segs, A.cap())
    v, ids = _agg_inputs(op, dtype, segs, n, segs + n)
    vals = torch.from_numpy(v).to(cuda)
    idt = torch.from_numpy(ids).to(cuda)
    before = A.launches
    got = A.segment_agg(op, segs, vals, idt)
    torch.cuda.synchronize()
    assert A.launches == before + 1
    want = A.segment_agg_reference(op, segs, torch.from_numpy(v),
                                   torch.from_numpy(ids))
    _agg_equal(got.cpu(), want, op)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("segs", [8, 1 << 16])
def test_segagg_both_zeros(cuda, op, segs):
    """A segment holding +0.0 and -0.0 gives -0.0 for min and +0.0 for max,
    whichever comes first, on both routes."""
    import numpy as np

    from pinot_tpu_torch.ops import segagg as A

    v = np.array([0.0, -0.0, -0.0, 0.0, 3.0, -0.0, 0.0, -2.0] * 1000)
    ids = np.tile(np.array([0, 0, 1, 1, 2, 2, 3, 3]), 1000).astype(np.int64)
    got = A.segment_agg(op, segs, torch.from_numpy(v).to(cuda),
                        torch.from_numpy(ids).to(cuda)).cpu()
    want = A.segment_agg_reference(op, segs, torch.from_numpy(v),
                                   torch.from_numpy(ids))
    _agg_equal(got, want, op)
    # segments 0 and 1 hold only zeros: their min and max are zeros
    zeros = got[torch.from_numpy(ids <= 1)]
    assert bool(torch.all(zeros == 0))
    assert bool(torch.all(torch.signbit(zeros) == (op == "min")))


@pytest.mark.parametrize("op", ["sum", "avg"])
def test_segagg_repeats_bitwise_on_the_shared_memory_route(cuda, op):
    from pinot_tpu_torch.ops import segagg as A

    for segs in (8, A.cap()):
        v, ids = _agg_inputs(op, "float64", segs, 1 << 22, 5)
        vals = torch.from_numpy(v).to(cuda)
        idt = torch.from_numpy(ids).to(cuda)
        runs = [A.segment_agg(op, segs, vals, idt) for _ in range(20)]
        torch.cuda.synchronize()
        for r in runs[1:]:
            assert torch.equal(r, runs[0])


def test_segagg_int64_near_the_limits(cuda):
    import numpy as np

    from pinot_tpu_torch.ops import segagg as A

    lim = np.iinfo(np.int64)
    v = np.array([lim.max, lim.min, lim.max, 1, lim.min, -1, 0, lim.max],
                 dtype=np.int64)
    ids = np.array([0, 0, 1, 1, 2, 2, 3, 3], dtype=np.int64)
    for op in AGG_OPS:
        for segs in (4, 1 << 13):
            got = A.segment_agg(op, segs, torch.from_numpy(v).to(cuda),
                                torch.from_numpy(ids).to(cuda)).cpu()
            want = A.segment_agg_reference(op, segs, torch.from_numpy(v),
                                           torch.from_numpy(ids))
            assert torch.equal(got.view(torch.int64),
                               want.view(torch.int64)), (op, segs)


def test_segagg_two_streams_from_two_threads(cuda):
    import threading

    from pinot_tpu_torch.ops import segagg as A

    inputs = []
    for seed in (1, 2):
        v, ids = _agg_inputs("sum", "float64", 64, 1 << 20, seed)
        inputs.append((torch.from_numpy(v).to(cuda),
                       torch.from_numpy(ids).to(cuda)))
    want = [A.segment_agg("sum", 64, v, i) for v, i in inputs]
    torch.cuda.synchronize()
    got, errors = [[], []], []

    def work(k):
        try:
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                for _ in range(10):
                    got[k].append(A.segment_agg("sum", 64, *inputs[k]))
            s.synchronize()
        except Exception as e:          # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for k in (0, 1):
        assert len(got[k]) == 10
        for g in got[k]:
            assert torch.equal(g, want[k])


def test_star_schema_on_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """The star schema's shapes on every plane: the card's rows equal
    the CPU's, through K16, K17 and K19 on the card."""
    from pinot_tpu_torch.ops import join as ops_join
    from pinot_tpu_torch.ops import segagg, segscan
    from pinot_tpu_torch.multistage import fused
    from pinot_tpu_torch.tools import star

    for k in ("PINOT_DEVICE_JOIN_MIN_ROWS", "PINOT_DEVICE_WINDOW_MIN_ROWS",
              "PINOT_FUSED_MIN_ROWS"):
        monkeypatch.setenv(k, "0")
    dirs = star.build_tables(str(tmp_path), star.star_tables(1 << 15))
    on_card = star.load_broker(dirs, "cuda")
    on_cpu = star.load_broker(dirs, "cpu")
    counts0 = (ops_join.launches, segscan.launches, segagg.launches,
               fused.launches)
    for csr in ("4194304", "0"):
        monkeypatch.setenv("PINOT_FUSED_MAX_CSR", csr)
        for name, make in star.SHAPES:
            for opt in ("true", "false"):
                sql = make(1) + f" OPTION(multistageFused={opt})"
                assert on_card.query(sql).rows == on_cpu.query(sql).rows, \
                    (name, opt, csr)
    counts = (ops_join.launches, segscan.launches, segagg.launches,
              fused.launches)
    assert all(b > a for a, b in zip(counts0, counts)), (counts0, counts)


def test_fuzz_on_cuda_matches_oracle(cuda, tmp_path, monkeypatch):
    """A fuzzer seed through Broker(device="cuda") on both paths, with
    the window stage's device functions on (K17 on the card)."""
    from test_torch_fuzz import fuzz_broker, run_specs

    monkeypatch.setenv("PINOT_DEVICE_WINDOW_MIN_ROWS", "0")
    broker, data = fuzz_broker(str(tmp_path), "cuda")
    failures, kinds = run_specs(broker, data, 5, 60)
    assert not failures, failures[:5]
    assert "window" in kinds


# ---------------------------------------------------------------------------
# K15: vector search (ops/csrc/vecsearch.cu)
# ---------------------------------------------------------------------------

def _vec_data(n, dim, seed, dup=False):
    import numpy as np
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, dim)).astype(np.float32)
    if dup:
        m[1::2] = m[0::2][: n // 2]          # every odd row repeats
    return m


def _upload_flat(m, metric, dev):
    """The reader's flat upload set (sentinel row, squared norms)."""
    from pinot_tpu_torch.index.vector import VectorIndexReader
    r = VectorIndexReader.from_matrix(m, metric, device=dev)
    return r, r.ensure_device()


def _vs_queries(m, nq, seed, zero=False):
    import numpy as np
    rng = np.random.default_rng(seed)
    qs = m[rng.integers(0, len(m), nq)] + 0.01 * rng.standard_normal(
        (nq, m.shape[1])).astype(np.float32)
    if zero:
        qs[:] = 0.0
    return qs.astype(np.float32)


def _term_scale(m, qs, metric):
    """The magnitude of the terms a score sums: 1 for cosine (unit
    rows and queries), 2 |m||q| + |m|^2 + |q|^2 <= 4 max(|m|^2, |q|^2)
    for l2, whose expanded form cancels them down to the distance."""
    import numpy as np
    if metric == "cosine":
        return 1.0
    sq = max(float((m.astype(np.float64) ** 2).sum(1).max()),
             float((qs.astype(np.float64) ** 2).sum(1).max()))
    return 4.0 * max(sq, 1.0)


def _ids_equal_where_apart(got_s, got_i, want_s, want_i, scale, tol=1e-5):
    """Scores within tol x scale (float32 sums in another order; scale is
    the magnitude of the summed terms); ids equal at every rank whose
    score is more than twice that from its neighbours' (the last rank's
    successor is not shown, so the last rank is never compared)."""
    import numpy as np
    got_s, want_s = np.asarray(got_s), np.asarray(want_s)
    fin = np.isfinite(want_s)
    assert np.array_equal(fin, np.isfinite(got_s))
    assert np.allclose(got_s[fin], want_s[fin], rtol=0, atol=tol * scale)
    gap = np.abs(np.diff(want_s.astype(np.float64), axis=1)) > 2 * tol * scale
    lo = np.concatenate([np.ones_like(gap[:, :1]), gap], axis=1)
    hi = np.concatenate([gap, np.zeros_like(gap[:, :1])], axis=1)
    apart = lo & hi
    assert np.array_equal(np.asarray(got_i)[apart], np.asarray(want_i)[apart])


SELECT_CASES = [  # (nq, S, k, kind)
    (1, 1, 1, "randn"), (3, 724, 23, "randn"), (16, 70001, 16, "randn"),
    (2, 5000, 5000, "randn"), (2, 9000, 4097, "randn"),
    (3, 4096, 1, "zeros"), (3, 3000, 2048, "signed-zeros"),
    (4, 10000, 100, "few-values"), (2, 3000, 64, "neg-inf"),
    (1, 1 << 19, 1 << 19, "few-values"), (4, 300000, 100, "few-values"),
    (2, 200000, 16, "signed-zeros"), (3, 150000, 1, "zeros")]


@pytest.mark.parametrize("nq,S,k,kind", SELECT_CASES,
                         ids=[f"{a}x{b}-k{c}-{d}" for a, b, c, d in
                              SELECT_CASES])
def test_vecsearch_select_equals_plain_version(cuda, nq, S, k, kind):
    """The top-k kernels, bitwise against the stable sort on the same
    scores: ties to the lower position, -0.0 below +0.0, -inf last; rows
    up to 2^17 with k <= 4096 take the one-block select, the rest the
    multi-block radix select."""
    from pinot_tpu_torch.ops import vecsearch as V
    g = torch.Generator(device=cuda)
    g.manual_seed(S + k)
    s = torch.randn(nq, S, device=cuda, generator=g)
    if kind == "zeros":
        s.zero_()
    elif kind == "signed-zeros":
        s = torch.where(s > 0, 0.0, -0.0)
    elif kind == "few-values":
        s = torch.round(s * 2) / 2
    elif kind == "neg-inf":
        s[:, ::3] = float("-inf")
    vals, idx = V.select(s.contiguous(), k)
    wv, wi = V.select_reference(s, k)
    torch.cuda.synchronize()
    assert torch.equal(vals.view(torch.int32), wv.view(torch.int32))
    assert torch.equal(idx, wi)


VEC_SHAPES = [  # (n, dim, nq, metric)
    (3001, 128, 16, "l2"), (3001, 100, 3, "cosine"), (70001, 128, 1, "l2"),
    (4097, 3, 16, "cosine"), (1001, 1, 3, "l2"), (2000, 256, 16, "cosine"),
    (513, 36, 5, "l2")]


@pytest.mark.parametrize("n,dim,nq,metric", VEC_SHAPES,
                         ids=[f"{a}x{b}-b{c}-{d}" for a, b, c, d in
                              VEC_SHAPES])
def test_vecsearch_flat_equals_plain_version(cuda, n, dim, nq, metric):
    """Scores to float32 rounding against the plain version, the search
    equal bitwise to the select of the kernel's own scores, ids equal to
    the plain search where the scores are apart, and batched == solo."""
    import numpy as np
    from pinot_tpu_torch.ops import vecsearch as V
    m = _vec_data(n, dim, n + dim)
    r, dev = _upload_flat(m, metric, cuda)
    qn = np.stack([r._query_vec(q) for q in _vs_queries(m, nq, dim)])
    qs = torch.from_numpy(qn).to(cuda)
    mode = V._mode(metric)
    s = V.score(dev["matrix"], n, dev["row_sq"], qs, mode)
    want = torch.stack([V.score_reference(dev["matrix"][:n],
                                          dev["row_sq"][:n], q, mode)
                        for q in qs])
    scale = _term_scale(m, qn, metric)
    assert torch.allclose(s, want, rtol=0, atol=1e-5 * scale)
    for k in (1, 64, n):
        k_pad = min(V._pow2(k), n)
        vals, idx = V.flat_search(qs, dev["matrix"], dev["row_sq"], metric,
                                  k_pad)
        sv, si = V.select(s, k_pad)
        assert torch.equal(vals.view(torch.int32), sv.view(torch.int32))
        assert torch.equal(idx, si)
        wv, wi = V.flat_search_reference(qs, dev["matrix"], dev["row_sq"],
                                         metric, k_pad)
        _ids_equal_where_apart(vals.cpu(), idx.cpu(), wv.cpu(), wi.cpu(),
                               scale)
        for i in range(nq):
            ov, oi = V.flat_search(qs[i:i + 1].contiguous(), dev["matrix"],
                                   dev["row_sq"], metric, k_pad)
            assert torch.equal(ov.view(torch.int32),
                               vals[i:i + 1].view(torch.int32))
            assert torch.equal(oi, idx[i:i + 1])
    r.evict_device()


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("case", ["duplicates", "zero-query"])
def test_vecsearch_ties_equal_plain_version(cuda, metric, case):
    """A zero query scores every row +0.0 under cosine in both versions
    (the tie rule alone decides) and -|m|^2 exactly under l2: the ids and
    scores are exactly the plain version's. Duplicate
    rows score the same bits in the kernel, so each returned pair sits in
    adjacent ranks, lower row first (the flat scan's tie rule); elsewhere
    the ids equal the plain version's where the scores are apart."""
    import numpy as np
    from pinot_tpu_torch.index.vector import VectorIndexReader
    m = _vec_data(3000, 12, 7, dup=case == "duplicates")
    qs = _vs_queries(m, 3, 9, zero=case == "zero-query")
    for nprobe in (None, 16):            # the IVF probe, the exact scan
        got = VectorIndexReader.from_matrix(m, metric, device=cuda) \
            .build_ivf(n_lists=16, seed=7).search_batch(qs, 64, nprobe)
        want = VectorIndexReader.from_matrix(m, metric, device="cpu") \
            .build_ivf(n_lists=16, seed=7).search_batch(qs, 64, nprobe)
        if case == "zero-query":
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])
            assert metric == "l2" or not got[0].any()
            continue
        _ids_equal_where_apart(*got, *want, _term_scale(m, qs, metric))
        if nprobe is None:
            continue
        for scores, ids in zip(*got):
            rank = {int(d): r for r, d in enumerate(ids)}
            for d, r in rank.items():
                partner = rank.get(d ^ 1)
                if partner is not None and d < d ^ 1:
                    assert partner == r + 1
                    assert scores[r] == scores[partner]


@pytest.mark.parametrize("metric,dim", [("cosine", 100), ("l2", 128),
                                        ("l2", 3)])
@pytest.mark.parametrize("k", [1, 10, 100, 2048])
def test_vecsearch_ivf_equals_plain_version(cuda, metric, dim, k):
    """The IVF probe at nprobe 1, the default and 4x it against the
    plain version (ids where apart), k_pad past max_pages x 64 on the
    small probes, and batched == solo bitwise."""
    import numpy as np
    from pinot_tpu_torch.index.vector import VectorIndexReader
    m = _vec_data(6000, dim, dim + k)
    qs = _vs_queries(m, 16, k)
    got_r = VectorIndexReader.from_matrix(m, metric, device=cuda) \
        .build_ivf(n_lists=64, seed=7)
    want_r = VectorIndexReader.from_matrix(m, metric, device="cpu") \
        .build_ivf(n_lists=64, seed=7)
    for nprobe in (1, got_r.nprobe_default, 4 * got_r.nprobe_default):
        gs, gd = got_r.search_batch(qs, k, nprobe)
        ws, wd = want_r.search_batch(qs, k, nprobe)
        _ids_equal_where_apart(gs, gd, ws, wd, _term_scale(m, qs, metric))
        assert np.array_equal(gd < 0, wd < 0)
        for i in (0, 7, 15):
            ss, sd = got_r.search_batch(qs[i:i + 1], k, nprobe)
            assert np.array_equal(ss.view(np.int32), gs[i:i + 1].view(np.int32))
            assert np.array_equal(sd, gd[i:i + 1])
    got_r.evict_device()


# the fused top-k's cap on k_pad (vecsearch.cu KCAP): 127 and 128 take the
# fused route, 129 the scores route
ROUTE_KS = (127, 128, 129)


def _bits_equal(a, b):
    return torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) \
        and torch.equal(a[1], b[1])


def _ivf_reader(m, metric, dev, n_lists=16):
    from pinot_tpu_torch.index.vector import VectorIndexReader
    return VectorIndexReader.from_matrix(m, metric, device=dev) \
        .build_ivf(n_lists=n_lists, seed=7)


def _ivf_call(r, qs, k_pad, nprobe):
    """The arguments of ivf_search as the reader passes them."""
    dev = r.ensure_device()
    return (qs, dev["paged"], dev["paged_sq"], dev["centroids"],
            dev["cent_sq"], dev["pages"], dev["pageptr"], r.metric, k_pad,
            nprobe, r.max_pages_for(nprobe), len(r.matrix))


def _ivf_by_stages(args):
    """The IVF search through its stage kernels: centroid scores, their
    top nprobe, the pages' scores, their top k mapped to documents."""
    from pinot_tpu_torch.ops import vecsearch as V
    (qs, paged, paged_sq, cents, cent_sq, pages, pageptr, metric, k_pad,
     nprobe, max_pages, n) = args
    cs = V.score(cents, cents.shape[0], cent_sq, qs, V._mode(metric, False))
    lists = V.select(cs, nprobe)[1]
    sims, pidx = V.score_pages(qs, paged, paged_sq, pages, pageptr, lists,
                               max_pages, n, V._mode(metric))
    return V.select(sims, k_pad, pages=pages, page_idx=pidx)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_vecsearch_fused_route_equals_scores_route(cuda, metric):
    """k_pad just below, at and above the fused top-k's cap, at n not a
    multiple of the 128-row tile: the flat search equals the select of the
    score kernel's output bitwise, and the fused routes' results are the
    prefixes of the scores route's (the keys are unique)."""
    import numpy as np
    from pinot_tpu_torch.ops import vecsearch as V
    n, dim = 128 * 37 + 45, 128
    m = _vec_data(n, dim, 31)
    r, dev = _upload_flat(m, metric, cuda)
    qn = np.stack([r._query_vec(q) for q in _vs_queries(m, 16, 5)])
    qs = torch.from_numpy(qn).to(cuda)
    s = V.score(dev["matrix"], n, dev["row_sq"], qs, V._mode(metric))
    got = {}
    for k in ROUTE_KS:
        got[k] = V.flat_search(qs, dev["matrix"], dev["row_sq"], metric, k)
        assert _bits_equal(got[k], V.select(s, k))
    for k in ROUTE_KS[:2]:
        assert _bits_equal(got[k], tuple(t[:, :k].contiguous()
                                         for t in got[ROUTE_KS[2]]))
    r.evict_device()


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_vecsearch_ivf_fused_route_equals_stages(cuda, metric):
    """The IVF probe at k_pad just below, at and above the fused top-k's
    cap equals its stage kernels bitwise (the fused routes merge each
    block's keys in the last block; the scores route selects among all)."""
    import numpy as np
    m = _vec_data(6000, 100, 41)
    r = _ivf_reader(m, metric, cuda)
    qn = np.stack([r._query_vec(q) for q in _vs_queries(m, 16, 6)])
    qs = torch.from_numpy(qn).to(cuda)
    from pinot_tpu_torch.ops import vecsearch as V
    got = {}
    for k in ROUTE_KS:
        args = _ivf_call(r, qs, k, 4)
        got[k] = V.ivf_search(*args)
        assert _bits_equal(got[k], _ivf_by_stages(args))
    for k in ROUTE_KS[:2]:
        assert _bits_equal(got[k], tuple(t[:, :k].contiguous()
                                         for t in got[ROUTE_KS[2]]))
    r.evict_device()


def _off_boundary(t):
    """A copy of ``t`` whose data starts 4 bytes past a 16-byte boundary
    (the kernels then take their 4-byte copies)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("dim", [1, 3, 36, 100, 128, 256])
def test_vecsearch_copy_routes_score_alike(cuda, dim):
    """The 16-byte-copy route (dim % 4 == 0 on 16-byte aligned data) and
    the 4-byte-copy route (the same data one float off the boundary) give
    the same bits: scores, flat searches on both sides of the fused cap,
    and the IVF probe."""
    import numpy as np
    from pinot_tpu_torch.ops import vecsearch as V
    n = 3001
    m = _vec_data(n, dim, dim)
    r, dev = _upload_flat(m, "l2", cuda)
    qn = np.stack([r._query_vec(q) for q in _vs_queries(m, 5, dim)])
    qs = torch.from_numpy(qn).to(cuda)
    mat, q_off, mat_off = dev["matrix"], _off_boundary(qs), \
        _off_boundary(dev["matrix"])
    mode = V._mode("l2")
    assert torch.equal(V.score(mat, n, dev["row_sq"], qs, mode).view(
        torch.int32), V.score(mat_off, n, dev["row_sq"], q_off, mode).view(
        torch.int32))
    for k in (16, 256):
        assert _bits_equal(
            V.flat_search(qs, mat, dev["row_sq"], "l2", k),
            V.flat_search(q_off, mat_off, dev["row_sq"], "l2", k))
    r.evict_device()
    ri = _ivf_reader(m, "l2", cuda)
    for k in (16, 256):
        a = _ivf_call(ri, qs, k, 4)
        assert _bits_equal(V.ivf_search(*a),
                           V.ivf_search(q_off, *a[1:]))
    ri.evict_device()


@pytest.mark.parametrize("nq", [1, 3, 16, 17])
def test_vecsearch_batches_equal_solo(cuda, nq):
    """B in {1, 3, 16, 17} (17 takes two scan launches): every query's
    row of a batched flat search and IVF probe equals its solo search
    bitwise, and the flat search equals select(score(...))."""
    import numpy as np
    from pinot_tpu_torch.ops import vecsearch as V
    m = _vec_data(5000, 128, 51)
    r = _ivf_reader(m, "l2", cuda, n_lists=32)
    dev = r.ensure_device()
    qn = np.stack([r._query_vec(q) for q in _vs_queries(m, nq, nq)])
    qs = torch.from_numpy(qn).to(cuda)
    n = len(m)
    flat = V.flat_search(qs, dev["matrix"], dev["row_sq"], "l2", 16)
    assert _bits_equal(flat, V.select(V.score(dev["matrix"], n,
                                              dev["row_sq"], qs,
                                              V._mode("l2")), 16))
    ivf = V.ivf_search(*_ivf_call(r, qs, 16, 6))
    for i in range(nq):
        one = qs[i:i + 1].contiguous()
        assert _bits_equal(
            V.flat_search(one, dev["matrix"], dev["row_sq"], "l2", 16),
            (flat[0][i:i + 1], flat[1][i:i + 1]))
        assert _bits_equal(V.ivf_search(*_ivf_call(r, one, 16, 6)),
                           (ivf[0][i:i + 1], ivf[1][i:i + 1]))
    r.evict_device()


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_vecsearch_document_scores_alike_in_both_plans(cuda, metric):
    """A document that the IVF probe and the exact scan both return for a
    query carries the same score bits in both (the same chain over a
    bitwise copy of its row and norm)."""
    import numpy as np
    m = _vec_data(8000, 100 if metric == "cosine" else 128, 61)
    r = _ivf_reader(m, metric, cuda, n_lists=32)
    qs = _vs_queries(m, 8, 7)
    ivf_s, ivf_d = r.search_batch(qs, 64, 24)
    flat_s, flat_d = r.search_batch(qs, 64, r.n_lists)
    common = 0
    for i in range(len(qs)):
        flat = dict(zip(flat_d[i].tolist(), flat_s[i].view(np.int32)))
        for d, s in zip(ivf_d[i].tolist(), ivf_s[i].view(np.int32)):
            if d >= 0 and d in flat:
                assert flat[d] == s
                common += 1
    assert common >= len(qs) * 8
    r.evict_device()


def test_vecsearch_ivf_repeats_bitwise(cuda):
    """20 IVF searches in a row give the same bits (each probe zeroes the
    tickets its last blocks merge by)."""
    import numpy as np
    from pinot_tpu_torch.ops import vecsearch as V
    m = _vec_data(6000, 128, 71)
    r = _ivf_reader(m, "l2", cuda)
    qs = torch.from_numpy(np.stack([r._query_vec(q) for q in
                                    _vs_queries(m, 16, 8)])).to(cuda)
    args = _ivf_call(r, qs, 16, 4)
    first = V.ivf_search(*args)
    for _ in range(20):
        assert _bits_equal(V.ivf_search(*args), first)
    r.evict_device()


def test_vecsearch_ivf_past_the_probe_shared_memory(cuda):
    """More lists than vec_probe keeps centroid scores for in shared
    memory (8,192) and more probed lists than it ranks there (4,096): the
    probe's global-memory paths equal its stage kernels bitwise and the
    plain version where the scores are apart."""
    import numpy as np
    from pinot_tpu_torch.ops import vecsearch as V
    m = _vec_data(12_000, 8, 81)
    r = _ivf_reader(m, "l2", cuda, n_lists=8_200)
    qn = np.stack([r._query_vec(q) for q in _vs_queries(m, 3, 9)])
    qs = torch.from_numpy(qn).to(cuda)
    args = _ivf_call(r, qs, 16, 4_200)
    got = V.ivf_search(*args)
    assert _bits_equal(got, _ivf_by_stages(args))
    want = V.ivf_search_reference(*args)
    _ids_equal_where_apart(got[0].cpu(), got[1].cpu(), want[0].cpu(),
                           want[1].cpu(), _term_scale(m, qn, "l2"))
    r.evict_device()


# ---------------------------------------------------------------------------
# geospatial doc masks and the statement surface on the card
# ---------------------------------------------------------------------------

GEO_LAT, GEO_LNG = 40.758, -73.9855
GEO_PT = f"ST_POINT({GEO_LNG}, {GEO_LAT}, 1)"
GEO_POLY = (f"POLYGON (({GEO_LNG - 0.05} {GEO_LAT - 0.05}, {GEO_LNG + 0.03} "
            f"{GEO_LAT - 0.05}, {GEO_LNG + 0.03} {GEO_LAT + 0.04}, "
            f"{GEO_LNG - 0.05} {GEO_LAT + 0.04}, {GEO_LNG - 0.05} "
            f"{GEO_LAT - 0.05}), ({GEO_LNG - 0.01} {GEO_LAT - 0.01}, "
            f"{GEO_LNG} {GEO_LAT - 0.01}, {GEO_LNG} {GEO_LAT}, "
            f"{GEO_LNG - 0.01} {GEO_LAT}, {GEO_LNG - 0.01} {GEO_LAT - 0.01}))")
GEO_SQL = [
    f"SELECT COUNT(*), SUM(fare) FROM geo WHERE ST_DISTANCE(pickup, "
    f"{GEO_PT}) < 3000",
    f"SELECT zone, COUNT(*), SUM(fare) FROM geo WHERE ST_DISTANCE(pickup, "
    f"{GEO_PT}) < 5000 GROUP BY zone ORDER BY zone LIMIT 1000",
    f"SELECT COUNT(*) FROM geo WHERE ST_DISTANCE(pickup, {GEO_PT}) < 300000",
    f"SELECT zone, COUNT(*) FROM geo WHERE ST_WITHIN(pickup, "
    f"ST_GEOM_FROM_TEXT('{GEO_POLY}')) = 1 GROUP BY zone ORDER BY zone "
    "LIMIT 1000",
    f"SELECT zone, COUNT(*) FROM geo WHERE ST_WITHIN(pickup, "
    f"ST_GEOM_FROM_TEXT('{GEO_POLY}')) = 0 GROUP BY zone ORDER BY zone "
    "LIMIT 1000",
    # at this size the planner prices a dense group-by; the compact one
    # is the strategy of the geo cell's grouped queries (K1)
    f"SELECT zone, COUNT(*), SUM(fare) FROM geo WHERE ST_DISTANCE(pickup, "
    f"{GEO_PT}) < 5000 GROUP BY zone ORDER BY zone LIMIT 1000 "
    "OPTION(groupByStrategy=compact)",
]


def _geo_tables(out, n=60_000):
    """{device: broker} over seeded points with a geo index, 2 segments."""
    import numpy as np
    from pinot_tpu_torch.broker import Broker
    from pinot_tpu_torch.geo import Geometry, to_wkb
    from pinot_tpu_torch.segment import SegmentBuilder
    from pinot_tpu_torch.server import TableDataManager
    from pinot_tpu_torch.spi import (DataType, FieldSpec, FieldType,
                                     IndexingConfig, Schema, TableConfig)

    rng = np.random.default_rng(3)
    lat = GEO_LAT + rng.normal(0, 0.03, n)
    lng = GEO_LNG + rng.normal(0, 0.03, n)
    pick = [to_wkb(Geometry.point(x, y, True)).hex()
            for x, y in zip(lng, lat)]
    pick[7] = ""
    data = {"pickup": np.asarray(pick, dtype=object),
            "zone": rng.integers(0, 265, n).astype(np.int32),
            "fare": rng.integers(250, 9000, n).astype(np.int64)}
    schema = Schema("geo", [
        FieldSpec("pickup", DataType.BYTES),
        FieldSpec("zone", DataType.INT),
        FieldSpec("fare", DataType.LONG, FieldType.METRIC)])
    cfg = TableConfig("geo", indexing=IndexingConfig(
        geo_index_columns={"pickup": {"resolution": 16}}))
    dirs = [SegmentBuilder(schema, cfg).build(
        {k: v[sl] for k, v in data.items()}, str(out), f"g{i}")
        for i, sl in enumerate((slice(0, n // 2), slice(n // 2, n)))]
    brokers = {}
    for dev in ("cuda", "cpu"):
        dm = TableDataManager("geo", device=dev, table_config=cfg)
        for d in dirs:
            dm.add_segment_dir(d)
        brokers[dev] = Broker(device=dev)
        brokers[dev].register_table(dm)
    return brokers


def test_geo_docmask_on_card_matches_cpu(cuda, tmp_path):
    """Indexed geo filters (a distance under the cover and past it into
    the sweep, a polygon with a hole and its complement) on the card give
    the CPU's rows; they plan the kernel with a docmask param, the mask
    reaches the card bitwise, and the grouped ones launch the
    compaction."""
    import numpy as np
    from pinot_tpu_torch.broker import connect
    from pinot_tpu_torch.engine.executor import resolve_params
    from pinot_tpu_torch.ops import compact
    from pinot_tpu_torch.query.context import build_query_context
    from pinot_tpu_torch.query.planner import SegmentPlanner
    from pinot_tpu_torch.query.sql import parse_sql

    brokers = _geo_tables(tmp_path)
    before = compact.launches
    for sql in GEO_SQL:
        assert connect(brokers["cuda"])(sql).rows == \
            connect(brokers["cpu"])(sql).rows, sql
    assert compact.launches > before
    seg = brokers["cuda"].table("geo").acquire_segments()[0]
    for sql in GEO_SQL:
        plan = SegmentPlanner(build_query_context(parse_sql(sql)),
                              seg).plan()
        masks = [p[1] for p in plan.params if isinstance(p, tuple)
                 and p[0] == "docmask"]
        assert plan.kind == "kernel" and len(masks) == 1, sql
        on_card = [t for t in resolve_params(plan) if t.dtype == torch.bool
                   and t.shape[0] == seg.bucket]
        assert on_card and on_card[0].is_cuda
        assert np.array_equal(on_card[0][:seg.n_docs].cpu().numpy(),
                              masks[0])


STATEMENT_SQL = [
    "SELECT o_part, COUNT(*), SUM(o_price) FROM orders WHERE o_cust IN "
    "(SELECT c_id FROM customers WHERE c_nation = 'de') GROUP BY o_part "
    "ORDER BY o_part LIMIT 3000",
    "SELECT COUNT(*) FROM orders WHERE o_price > (SELECT AVG(o_price) "
    "FROM orders)",
    "SELECT o_part, COUNT(*) FROM orders o WHERE NOT EXISTS (SELECT c_id "
    "FROM customers c WHERE c.c_id = o.o_cust AND c.c_nation = 'us') "
    "GROUP BY o_part ORDER BY o_part LIMIT 3000",
    "WITH t AS (SELECT o_part, SUM(o_price) AS rev FROM orders GROUP BY "
    "o_part LIMIT 10000) SELECT COUNT(*), SUM(rev), MAX(rev) FROM t",
    "WITH big AS (SELECT c_id, c_nation FROM customers WHERE c_id < 20000 "
    "LIMIT 100000) SELECT b.c_nation, SUM(o.o_price), COUNT(*) FROM orders "
    "o JOIN big b ON o.o_cust = b.c_id GROUP BY b.c_nation ORDER BY "
    "b.c_nation",
    "SELECT o_part FROM orders WHERE o_price > 4900 UNION SELECT p_id FROM "
    "parts WHERE p_brand = 'acme' ORDER BY 1 LIMIT 3000",
    "SELECT o_part FROM orders WHERE o_price > 4900 EXCEPT ALL SELECT p_id "
    "FROM parts ORDER BY 1 LIMIT 3000",
    "EXPLAIN PLAN FOR SELECT o_part, SUM(o_price) FROM orders GROUP BY "
    "o_part",
]


def test_statements_on_card_match_cpu(cuda, tmp_path):
    """Subqueries, CTEs (their segments on the card), set operations and
    EXPLAIN on the card give the CPU's rows, and after each statement the
    tracked device bytes equal the tensors held, no CTE bytes left."""
    from pinot_tpu_torch.broker import connect
    from pinot_tpu_torch.broker import broker as bmod
    from pinot_tpu_torch.engine import batch
    from pinot_tpu_torch.engine.tier import reconcile_devmem
    from pinot_tpu_torch.tools import star
    from pinot_tpu_torch.utils.devmem import global_device_memory

    dirs = star.build_tables(str(tmp_path), star.star_tables(1 << 16))
    brokers = {dev: star.load_broker(dirs, dev) for dev in ("cuda", "cpu")}
    cte_devices = []
    real = bmod._cte_table

    def spy(*a, **kw):
        dm = real(*a, **kw)
        cte_devices.extend(s.device.type for s in dm.acquire_segments())
        return dm

    # the registry is process-wide: start it from what these tables hold
    live = [s for b in brokers.values() for t in b.table_names
            for s in b.table(t).acquire_segments()]
    for s in live:
        s.evict_device()
    batch.clear_stack_cache()
    global_device_memory.clear()
    bmod._cte_table = spy
    try:
        for sql in STATEMENT_SQL:
            got = connect(brokers["cuda"])(sql).rows
            assert got == connect(brokers["cpu"])(sql).rows, sql
            for pool, v in reconcile_devmem(live).items():
                assert v["tracked"] == v["actual"], (sql, pool, v)
    finally:
        bmod._cte_table = real
    assert "cuda" in cte_devices and "cpu" in cte_devices


FORMAT_CONFIGS = {
    "bitpack": {"bit_packed_ids": True},
    # ZSTD, written as ZLIB (and named so) where the native library was
    # built without zstd (chip_smoke.py prints whether zstd.h is there)
    "compressed": {"no_dictionary_columns": ["lo_revenue",
                                             "lo_extendedprice",
                                             "lo_supplycost", "lo_discount",
                                             "lo_quantity"],
                   "compression": "ZSTD"},
}


def _ssb_broker(seg_dir, dev):
    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.server import TableDataManager

    dm = TableDataManager("lineorder", device=dev)
    dm.add_segment_dir(seg_dir)
    b = Broker(device=dev)
    b.register_table(dm)
    return connect(b), dm


@pytest.mark.parametrize("fmt", list(FORMAT_CONFIGS))
def test_segment_formats_on_card_match_plain(cuda, tmp_path, fmt):
    """A BITPACK and a COMPRESSED copy of the SSB segment decode on the
    host and serve the 13 queries on the card with the PLAIN segment's
    digests, through the compaction kernel."""
    from pinot_tpu_torch import native
    from pinot_tpu_torch.ops import compact as C
    from pinot_tpu_torch.spi import IndexingConfig, TableConfig

    assert native.available()
    cfg = dict(FORMAT_CONFIGS[fmt])
    plain = ssb.build_segment_dir(1 << 16, str(tmp_path / "plain"))
    copy = ssb.build_segment_dir(1 << 16, str(tmp_path / fmt), TableConfig(
        "lineorder", indexing=IndexingConfig(**cfg)))
    with open(os.path.join(copy, "metadata.json")) as fh:
        meta = json.load(fh)["columns"]
    for col in cfg.get("no_dictionary_columns", ()):
        assert meta[col]["codec"] == (
            "ZSTD" if native.zstd_available() else "ZLIB"), col
    (qp, dmp), (qc, dmc) = _ssb_broker(plain, "cuda"), \
        _ssb_broker(copy, "cuda")
    before = C.launches
    for qid, p, v, g in ssb.QUERIES:
        sql = ssb.spec_to_sql(p, v, g)
        assert ssb._digest(qc(sql).rows) == ssb._digest(qp(sql).rows), qid
    assert C.launches > before
    for dm in (dmp, dmc):
        for s in dm.acquire_segments():
            s.evict_device()


def test_rollups_on_card_match_cpu(cuda, tmp_path):
    """A rollup is a segment on the card: rows equal the CPU's and the
    raw path's (the same rows without rollups), and the device-memory
    registry holds the rollup's tensors, which leave with their
    segment."""
    import os

    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.engine import batch
    from pinot_tpu_torch.engine.tier import reconcile_devmem
    from pinot_tpu_torch.segment import load_segment
    from pinot_tpu_torch.server import TableDataManager
    from pinot_tpu_torch.startree import RollupConfig, build_rollup
    from pinot_tpu_torch.utils.devmem import global_device_memory

    sizes = [40_000, 30_000]
    raw_dir = ssb.build_table_dir(sizes, str(tmp_path / "raw"))
    table = ssb.build_table_dir(sizes, str(tmp_path / "t"))
    for d in sorted(os.listdir(table)):
        build_rollup(load_segment(os.path.join(table, d), "cpu"),
                     RollupConfig(["d_year", "p_category", "p_brand1",
                                   "s_region"], [("sum", "lo_revenue")]))
    out = {}
    for name, dev, d in (("cuda", "cuda", table), ("cpu", "cpu", table),
                         ("raw", "cuda", raw_dir)):
        dm = TableDataManager("lineorder", device=dev)
        dm.add_table_dir(d)
        b = Broker(device=dev)
        b.register_table(dm)
        out[name] = (connect(b), dm)
    segs = out["cuda"][1].acquire_segments()
    # the registry is process-wide: start it from what these tables hold
    live = [s for _q, dm in out.values() for s in dm.acquire_segments()]
    batch.clear_stack_cache()
    global_device_memory.clear()
    for qid, p, v, g in ssb.QUERIES[3:6]:        # Q2.1-Q2.3
        sql = ssb.spec_to_sql(p, v, g)
        rows = out["cuda"][0](sql).rows
        assert rows == out["cpu"][0](sql).rows, qid
        assert rows == out["raw"][0](sql).rows, qid
        assert all(s.rollup_segments() for s in segs)
        for pool, v in reconcile_devmem(live).items():
            assert v["tracked"] == v["actual"], (qid, pool, v)
    for s in live:
        s.evict_device()
        assert all(not r._device for r in s.rollup_segments())


def test_explain_analyze_on_card(cuda, tmp_path):
    """EXPLAIN ANALYZE on the card: the root's children are planning,
    execution and reduce (then broker_overhead, the root's time no span
    measured), which do not sum past the root; every span name is known,
    each query has a fenced device_execute span, and the inner rows equal
    the untraced query's. chip_smoke.py bounds the time no child covers
    after the broker's prefix, at 2^25 rows; at this test's 2^18 rows the
    broker's fixed 0.3-0.5 ms is 10-21% of a query."""
    from pinot_tpu_torch.utils import phases

    seg_dir = ssb.build_segment_dir(1 << 18, str(tmp_path / "s"))
    q, dm = _ssb_broker(seg_dir, "cuda")

    def names(sp):
        yield sp["name"]
        for c in sp["children"]:
            yield from names(c)

    for qid, p, v, g in ssb.QUERIES:
        sql = ssb.spec_to_sql(p, v, g)
        q("EXPLAIN ANALYZE " + sql)
        res = q("EXPLAIN ANALYZE " + sql)
        root = res.trace["spans"]
        kids = [c["name"] for c in root["children"]]
        assert kids[:3] == ["planning", "execution", "reduce"], (qid, kids)
        assert kids[3:] in ([], ["broker_overhead"]), (qid, kids)
        covered = sum(c["ms"] for c in root["children"][:3])
        assert covered <= 1.1 * root["ms"], (qid, root)
        assert set(names(root)) <= phases.SPAN_NAMES
        assert root["attrs"]["rows"] == len(q(sql).rows)
        assert "device_execute" in set(names(root)), qid
    for s in dm.acquire_segments():
        s.evict_device()


@pytest.mark.parametrize("strategy", ["compact", "dense"])
def test_profile_phases_on_card(cuda, tmp_path, strategy):
    """EXPLAIN ANALYZE OPTION(profilePhases=true) on the card: the phase
    ladder is timed with CUDA events (the compact prefix relaunches K1),
    its phase_* children carry positive, nondecreasing cumulative times,
    and the inner rows equal the untraced query's."""
    from pinot_tpu_torch.ops import compact as C

    seg_dir = ssb.build_segment_dir(1 << 20, str(tmp_path / "s"))
    q, dm = _ssb_broker(seg_dir, "cuda")
    qid, p, v, g = ssb.QUERIES[3 if strategy == "compact" else 10]
    sql = ssb.spec_to_sql(p, v, g) + \
        f" OPTION(groupByStrategy={strategy})"
    plain = q(sql)
    q("EXPLAIN ANALYZE " + sql)
    before = C.launches
    res = q("EXPLAIN ANALYZE " + sql.replace(
        " OPTION(", " OPTION(profilePhases=true,"))
    root = res.trace["spans"]
    assert root["attrs"]["rows"] == len(plain.rows)
    profs = []

    def walk(sp):
        if sp["name"] == "phase_profile":
            profs.append(sp)
        for c in sp["children"]:
            walk(c)

    walk(root)
    assert profs
    for sp in profs:
        kids = [c for c in sp["children"] if c["name"].startswith("phase_")]
        cums = [c["attrs"]["cumulative_ms"] for c in kids
                if "cumulative_ms" in c["attrs"]]
        assert cums and all(c > 0 for c in cums), kids
        assert cums == sorted(cums), kids
        if strategy == "compact":
            assert {"phase_mask", "phase_fuse", "phase_compact",
                    "phase_aggregate", "phase_transfer"} <= \
                {c["name"] for c in kids}
    if strategy == "compact":
        # the query's own launch plus the profile's compact prefix
        assert C.launches - before >= 2
    for s in dm.acquire_segments():
        s.evict_device()


def _rt_cols(n):
    cols = ssb.gen_columns(n)
    cols.update(ssb.gen_lineorder_keys(n))
    return cols


def _rt_table(dev, data_dir, rows, schema, flush, **kw):
    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.realtime import (InMemoryStream,
                                          RealtimeTableDataManager,
                                          StreamConfig)

    stream = InMemoryStream(2, partitioner=lambda r: r["lo_orderkey"])
    stream.produce_many(rows)
    dm = RealtimeTableDataManager(
        "lineorder", schema, StreamConfig(
            "lineorder", num_partitions=2, flush_threshold_rows=flush,
            consumer_factory=stream), str(data_dir), device=dev, **kw)
    for p in range(2):
        dm.consume_once(p)
    b = Broker(device=dev)
    b.register_table(dm)
    return dm, connect(b), stream


def _ssb_rows(query):
    return {qid: ssb._digest(query(ssb.spec_to_sql(p, v, g)).rows)
            for qid, p, v, g in ssb.QUERIES}


def _held_k1(dm):
    """K1 on each compact plan's inputs of the sealed segments held to
    its plain version bitwise; returns the inputs checked."""
    import chip_smoke
    from pinot_tpu_torch.ops import compact as C

    sealed = [s for s in dm.acquire_segments()
              if not getattr(s, "is_mutable", False)]
    checked = 0
    for _qid, p, v, g in ssb.QUERIES:
        for plan in chip_smoke._plans(ssb.spec_to_sql(p, v, g), sealed):
            if plan.kind != "kernel" or \
                    plan.kernel_plan.strategy != "compact":
                continue
            mask, cols = chip_smoke._compact_inputs(plan)
            chip_smoke.same_outputs(
                C.compact(mask, cols, plan.slots_cap),
                C.compact_reference(mask, cols, plan.slots_cap))
            checked += 1
    return checked


def test_realtime_sealed_on_card_matches_cpu(cuda, tmp_path):
    """A realtime table whose sealed segments are on the card answers the
    SSB queries as the same table on the CPU (the plain versions), K1
    launches on the sealed segments, each compact input of theirs gives
    K1's plain version's outputs bitwise, and the tracked device bytes
    equal the tensors held."""
    from pinot_tpu_torch.engine.tier import reconcile_devmem
    from pinot_tpu_torch.ops import compact as C

    cols = _rt_cols(40_000)
    rows = ssb.row_dicts(cols)
    schema = ssb.keyed_schema(cols)
    got = {}
    for dev in ("cuda", "cpu"):
        before = C.launches
        dm, query, _s = _rt_table(dev, tmp_path / dev, rows, schema, 8_000)
        assert dm.num_segments == 4 and dm.consuming_docs == 8_000
        got[dev] = _ssb_rows(query)
        if dev == "cuda":
            assert C.launches > before
            assert _held_k1(dm) > 0
            sealed = [s for s in dm.acquire_segments()
                      if not getattr(s, "is_mutable", False)]
            assert {d for s in sealed
                    for d in s.resident_devices().values()} == {"cuda:0"}
            rec = reconcile_devmem(sealed)["segment_cols"]
            assert rec["tracked"] >= rec["actual"] > 0
            for s in sealed:
                s.evict_device()
    assert got["cuda"] == got["cpu"]


def test_upsert_invalidation_after_upload_on_card(cuda, tmp_path):
    """A full-upsert table on the card: the first queries upload the
    sealed segments' valid masks, updates then invalidate documents of
    those segments, and the queries again equal the CPU table's; no
    superseded mask stays on the card, and K1 holds bitwise on the
    masked inputs."""
    import numpy as np

    from pinot_tpu_torch.upsert import UpsertConfig

    n = 24_000
    cols = _rt_cols(n)
    rng = np.random.default_rng(7)
    again = np.nonzero(rng.random(n) < 1 / 16)[0][1:]
    src = (rng.random(len(again)) * again).astype(np.int64)
    for k in ("lo_orderkey", "lo_linenumber"):
        cols[k][again] = cols[k][src]
    upd = ssb.take_rows(cols, rng.integers(0, n, 6_000))
    upd["lo_revenue"] = rng.integers(10_000, 6_000_000, 6_000).astype(
        np.int32)
    schema = ssb.keyed_schema(cols)
    cfg = UpsertConfig(pk_columns=["lo_orderkey", "lo_linenumber"])
    got = {}
    for dev in ("cuda", "cpu"):
        dm, query, stream = _rt_table(dev, tmp_path / dev,
                                      ssb.row_dicts(cols), schema, 8_000,
                                      upsert_config=cfg)
        before = _ssb_rows(query)
        sealed = [s for s in dm.acquire_segments()
                  if not getattr(s, "is_mutable", False)]
        versions = {s.name: s.valid_docs_version for s in sealed}
        if dev == "cuda":
            assert any(k[0].startswith("__valid__") for s in sealed
                       for k in s._device)
        stream.produce_many(ssb.row_dicts(upd))
        for p in range(2):
            dm.consume_once(p)
        assert any(s.valid_docs_version > versions[s.name] for s in sealed)
        got[dev] = (before, _ssb_rows(query))
        if dev == "cuda":
            for s in sealed:
                keys = [k[0] for k in s._device
                        if k[0].startswith("__valid__")]
                assert keys in ([], [f"__valid__v{s.valid_docs_version}"])
            assert _held_k1(dm) > 0
            for s in sealed:
                s.evict_device()
    assert got["cuda"] == got["cpu"]
    assert got["cuda"][0] != got["cuda"][1]


def test_kafka_fed_table_on_card_holds_k1(cuda, tmp_path):
    """A realtime table fed through the Kafka protocol (the port's fake
    broker and consumer) seals segments on the card that answer the SSB
    queries as the same table on the CPU, and every compact input of
    theirs gives K1's plain version's outputs bitwise."""
    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.ops import compact as C
    from pinot_tpu_torch.realtime import (RealtimeTableDataManager,
                                          StreamConfig)
    from pinot_tpu_torch.realtime.kafka import (FakeKafkaBroker,
                                                KafkaProducer, KafkaStream)

    cols = _rt_cols(30_000)
    rows = ssb.row_dicts(cols)
    schema = ssb.keyed_schema(cols)
    kafka = FakeKafkaBroker({"lineorder": 2})
    try:
        prod = KafkaProducer("127.0.0.1", kafka.port)
        for p in range(2):
            part = [r for r in rows if r["lo_orderkey"] % 2 == p]
            for lo in range(0, len(part), 4096):
                prod.produce_many("lineorder", p, part[lo:lo + 4096])
        prod.close()
        got = {}
        for dev in ("cuda", "cpu"):
            before = C.launches
            dm = RealtimeTableDataManager(
                "lineorder", schema, StreamConfig(
                    "lineorder", num_partitions=2, flush_threshold_rows=6_000,
                    consumer_factory=KafkaStream("lineorder",
                                                 port=kafka.port)),
                str(tmp_path / dev), device=dev)
            for p in range(2):
                dm.consume_once(p)
            assert dm.num_segments >= 4
            b = Broker(device=dev)
            b.register_table(dm)
            got[dev] = _ssb_rows(connect(b))
            if dev == "cuda":
                assert C.launches > before
                assert _held_k1(dm) > 0
                for s in dm.acquire_segments():
                    if not getattr(s, "is_mutable", False):
                        s.evict_device()
        assert got["cuda"] == got["cpu"]
    finally:
        kafka.stop()


def _fault_table(tmp_path, dev, n_segs):
    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.server import TableDataManager

    d = ssb.build_table_dir([1 << 16] * n_segs, str(tmp_path / f"t{n_segs}"))
    dm = TableDataManager("lineorder", device=dev)
    dm.add_table_dir(d)
    b = Broker(device=dev)
    b.register_table(dm)
    return dm, connect(b)


def test_forced_overflow_on_card(cuda, tmp_path):
    """``device.overflow`` at p = 1 on one segment on the card: each
    compact query reruns at full capacity once, with the rows it gives
    unarmed, and K1 holds bitwise on the full-capacity inputs."""
    import chip_smoke
    from pinot_tpu_torch.ops import compact as C
    from pinot_tpu_torch.utils import faults
    from pinot_tpu_torch.utils.metrics import global_metrics

    dm, query = _fault_table(tmp_path, "cuda", 1)
    opt = " OPTION(timeoutMs=600000, groupByStrategy=compact)"
    sqls = {qid: ssb.spec_to_sql(p, v, g) + opt
            for qid, p, v, g in ssb.QUERIES if g}
    want = {qid: query(sql).rows for qid, sql in sqls.items()}
    r0 = global_metrics.snapshot()["counters"].get(
        "compact_overflow_retries", 0)
    plan = faults.install("seed=1; device.overflow: p=1")
    try:
        for qid, sql in sqls.items():
            assert query(sql).rows == want[qid], qid
    finally:
        faults.clear()
    assert len(plan.fired) == len(sqls)
    assert global_metrics.snapshot()["counters"][
        "compact_overflow_retries"] == r0 + len(sqls)
    seg = dm.acquire_segments()[0]
    for sql in sqls.values():
        for p in chip_smoke._plans(sql, [seg]):
            if p.kind == "kernel" and p.kernel_plan.strategy == "compact":
                mask, cols = chip_smoke._compact_inputs(p)
                cap = C.full_slots_cap(seg.bucket)
                chip_smoke.same_outputs(C.compact(mask, cols, cap),
                                        C.compact_reference(mask, cols, cap))
    seg.evict_device()


def test_tier_evict_mid_query_on_card(cuda, tmp_path):
    """``tier.evict`` at p = 0.25 under a budget on a four-segment table
    on the card: the rows equal the unarmed rows, segments are demoted
    with reason ``fault`` mid-query and come back, and the tracked device
    bytes equal the tensors held after every query."""
    from pinot_tpu_torch.engine import batch
    from pinot_tpu_torch.engine.tier import global_tier, reconcile_devmem
    from pinot_tpu_torch.utils import faults
    from pinot_tpu_torch.utils.devmem import global_device_memory

    # earlier tests' segments (dropped without remove_segment) keep their
    # tracked bytes: start the accounting afresh for this table
    batch.clear_stack_cache()
    global_device_memory.clear()
    global_tier.clear()
    dm, query = _fault_table(tmp_path, "cuda", 4)
    segs = dm.acquire_segments()
    sqls = {qid: ssb.spec_to_sql(p, v, g) + " OPTION(timeoutMs=600000)"
            for qid, p, v, g in ssb.QUERIES}
    want = {qid: query(sql).rows for qid, sql in sqls.items()}
    global_tier.configure(budget_bytes=1 << 40)
    d0 = len(global_tier.decisions)
    faults.install("seed=5; tier.evict: p=0.25")
    try:
        for qid, sql in sqls.items():
            assert query(sql).rows == want[qid], qid
            rec = reconcile_devmem(segs)
            assert all(r["tracked"] == r["actual"]
                       for r in rec.values()), (qid, rec)
    finally:
        faults.clear()
        global_tier.configure(budget_bytes=None)
    log = global_tier.decisions[d0:]
    assert any(d[0] == "demote" and d[4] == "fault" for d in log)
    assert any(d[0] == "promote" for d in log)
    for s in segs:
        s.evict_device()


def _cluster_fleet(tmp_path, dev, table_dir):
    """A port fleet on ``dev``: a controller, two server nodes and a
    broker node over loopback HTTP, the table at replication 2."""
    from pinot_tpu_torch.cluster import BrokerNode, Controller, ServerNode

    ctrl = Controller(str(tmp_path / f"ctrl_{dev}"), heartbeat_timeout=60.0,
                      reconcile_interval=0.2)
    servers = [ServerNode(f"server_{i}", ctrl.url, poll_interval=0.1,
                          device=dev) for i in range(2)]
    broker = BrokerNode(ctrl.url, routing_refresh=0.1)
    dirs = sorted(os.path.join(table_dir, d) for d in os.listdir(table_dir))
    with open(os.path.join(dirs[0], "metadata.json")) as fh:
        schema = json.load(fh)["schema"]
    ctrl.add_table("lineorder", schema, replication=2)
    for d in dirs:
        ctrl.add_segment("lineorder", os.path.basename(d), d)
    v = ctrl.routing_snapshot()["version"]
    assert all(s.wait_for_version(v, 60.0) for s in servers)
    assert broker.wait_for_version(v, 60.0)
    return ctrl, servers, broker


def _stop_fleet(ctrl, servers, broker):
    broker.stop()
    for s in servers:
        s.stop()
        for dm in list(s._tables.values()):
            for seg in dm.acquire_segments():
                seg.evict_device()
        s._tables.clear()
    ctrl.stop()


def test_cluster_fleet_on_card_matches_cpu(cuda, tmp_path):
    """A two-server fleet on the card answers the 13 SSB queries over
    HTTP with the CPU fleet's rows, through K1 on the servers; no torch
    tensor reaches encode_partial; each server's /debug/memory reports
    the card for itself and every resident column."""
    from pinot_tpu_torch.clients import HttpConnection
    from pinot_tpu_torch.cluster.http_util import http_json
    from pinot_tpu_torch.engine import datablock
    from pinot_tpu_torch.ops import compact as C

    table_dir = ssb.build_table_dir([1 << 16] * 4, str(tmp_path / "t"))
    sqls = [ssb.spec_to_sql(p, v, g) for _q, p, v, g in ssb.QUERIES]
    real = datablock.encode_partial
    seen = []

    def checked(p):
        stack = [p]
        while stack:
            x = stack.pop()
            assert not isinstance(x, torch.Tensor), type(x)
            if isinstance(x, dict):
                stack += list(x.keys()) + list(x.values())
            elif isinstance(x, (list, tuple, set)):
                stack += list(x)
            elif hasattr(x, "__dataclass_fields__"):
                stack += [getattr(x, f) for f in x.__dataclass_fields__]
        seen.append(type(p).__name__)
        return real(p)

    got = {}
    datablock.encode_partial = checked
    try:
        for dev in ("cuda", "cpu"):
            fleet = _cluster_fleet(tmp_path, dev, table_dir)
            try:
                conn = HttpConnection(fleet[2].url)
                before = C.launches
                got[dev] = [sorted(map(tuple, conn(q).rows), key=repr)
                            for q in sqls]
                if dev == "cuda":
                    assert C.launches > before
                    for s in fleet[1]:
                        mem = http_json("GET", f"{s.url}/debug/memory")
                        assert mem["device"].startswith("cuda")
                        devs = {d for by_seg in mem["columns"].values()
                                for cols in by_seg.values()
                                for d in cols.values()}
                        assert devs and all(d.startswith("cuda")
                                            for d in devs)
            finally:
                _stop_fleet(*fleet)
    finally:
        datablock.encode_partial = real
    assert seen
    assert got["cuda"] == got["cpu"]


def _control_commit(tmp_path, dev, rows, flush):
    """Two replicas on ``dev`` commit one segment of ``flush`` rows in
    each of two partitions through a controller; returns the replicas
    after both adopted every segment."""
    import numpy as np

    from pinot_tpu_torch.cluster import Controller
    from pinot_tpu_torch.cluster.completion import CompletionClient
    from pinot_tpu_torch.realtime import (InMemoryStream,
                                          RealtimeTableDataManager,
                                          StreamConfig)

    ctrl = Controller(str(tmp_path / f"ctrl_{dev}"), heartbeat_timeout=60.0,
                      reconcile_interval=5.0)
    schema = ssb.keyed_schema(rows)
    ctrl.add_table("lineorder_REALTIME", schema.to_dict(), replication=2)
    stream = InMemoryStream(2, name=f"ctl_{dev}")
    part = rows["lo_orderkey"] % 2
    for p in range(2):
        # exactly one segment's rows a partition: nothing stays consuming
        idx = np.nonzero(part == p)[0][:flush]
        stream.produce_many(ssb.row_dicts(ssb.take_rows(rows, idx)),
                            partition=p)
    reps = []
    for i in range(2):
        m = RealtimeTableDataManager(
            "lineorder_REALTIME", schema, StreamConfig(
                "ctl", num_partitions=2, flush_threshold_rows=flush,
                flush_threshold_seconds=1e9, consumer_factory=stream),
            str(tmp_path / f"rep_{dev}_{i}"), device=dev,
            completion_client=CompletionClient(
                ctrl.url, f"rep_{i}", f"file://{tmp_path}/deep_{dev}"))
        m.report_interval_s = 0.0
        reps.append(m)
    try:
        for p in range(2):
            for m in reps:
                m.consume_once(p)
            name = f"lineorder_REALTIME__{p}__0"
            deadline = time.monotonic() + 60.0
            while not all(name in m._partition_state(p)["segments"]
                          for m in reps):
                assert time.monotonic() < deadline
                for m in reps:
                    m._maybe_seal(p)
    finally:
        ctrl.stop()
    return reps


def test_control_commit_and_minion_on_card_match_cpu(cuda, tmp_path):
    """Replicas on the card commit and adopt through the controller the
    segments the CPU replicas do, hold them on the card, and answer the
    SSB queries with the CPU's rows through K1; the minion's
    RealtimeToOfflineSegments builds offline segments on the card with
    the same rows."""
    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.minion import (MinionContext, MinionWorker,
                                        TaskSpec, TaskState)
    from pinot_tpu_torch.ops import compact as C
    from pinot_tpu_torch.server import TableDataManager

    n = 1 << 15
    cols = ssb.gen_columns(n)
    cols.update(ssb.gen_lineorder_keys(n))
    flush = 1 << 13
    sqls = [ssb.spec_to_sql(p, v, g).replace("FROM lineorder",
                                            "FROM lineorder_REALTIME")
            for _q, p, v, g in ssb.QUERIES]
    got = {}
    for dev in ("cuda", "cpu"):
        reps = _control_commit(tmp_path, dev, cols, flush)
        out = []
        for m in reps:
            segs = m.acquire_segments()
            assert all(s.device.type == dev for s in segs
                       if not getattr(s, "is_mutable", False))
            b = Broker(device=dev)
            b.register_table(m)
            q = connect(b)
            before = C.launches
            out.append([sorted(map(tuple, q(s).rows), key=repr)
                        for s in sqls])
            if dev == "cuda":
                assert C.launches > before
        assert out[0] == out[1]
        off = TableDataManager("lineorder_OFFLINE", device=dev)
        w = MinionWorker(MinionContext(
            {"lineorder_REALTIME": reps[0]}, str(tmp_path / f"min_{dev}"),
            offline_tables={"lineorder_REALTIME": off}))
        spec = w.submit(TaskSpec("RealtimeToOfflineSegmentsTask",
                                 "lineorder_REALTIME", {"targetRows": n // 4},
                                 task_id="fixed"))
        w.drain()
        assert spec.state == TaskState.COMPLETED, spec.error
        assert all(s.device.type == dev for s in off.acquire_segments())
        b = Broker(device=dev)
        b.register_table(off)
        q = connect(b)
        out.append([sorted(map(tuple, q(s.replace(
            "lineorder_REALTIME", "lineorder_OFFLINE")).rows), key=repr)
            for s in sqls])
        assert out[2] == out[0]
        got[dev] = out[0]
        for x in [*off.acquire_segments(), *reps[1].acquire_segments()]:
            x.evict_device()
    assert got["cuda"] == got["cpu"]


def test_loadgen_on_card_matches_cpu(cuda, tmp_path):
    """A drained loadgen run on the card (two tables over the Kafka fake
    and the wire stream, chaos armed) ends in the CPU run's final rows
    and the oracle's, with its sealed segments on the card while it
    runs and backend "cuda" in its summary."""
    from pinot_tpu_torch.engine import loadgen as LG
    from pinot_tpu_torch.tools import ingest_fuzz

    got = {}
    for dev in ("cuda", "cpu"):
        cfg = LG.LoadgenConfig(
            tables=[LG.TableLoadSpec("lg_a", partitions=2, backend="kafka",
                                     threshold=96),
                    LG.TableLoadSpec("lg_u", partitions=2, upsert=True,
                                     protocol=True, backend="wire",
                                     threshold=96)],
            seed=5, rows_per_partition=400, query_concurrency=2,
            fault_plan=ingest_fuzz.ingest_plan(5, protocol=True))
        lg = LG.IngestLoadGen(str(tmp_path / dev), cfg, device=dev)
        try:
            s = lg.run()
            assert s["ok"] and s["backend"] == dev, s
            sealed = [x for t in lg.tables
                      for x in t.current()[1].acquire_segments()
                      if not getattr(x, "is_mutable", False)]
            assert sealed and {x.device.type for x in sealed} == {dev}
            got[dev] = {t.spec.name: sorted(lg._queryable_rows(t.spec.name))
                        for t in lg.tables}
        finally:
            lg.close()
    assert got["cuda"] == got["cpu"]


def test_fuzz_rounding_tie_spec_on_card(cuda, tmp_path):
    """Spec 201 of seed 20260730 at 2^16 rows, the one a whole check of
    the fuzz phase stopped on when it compared digests alone: the card's
    rows equal the host path's and the oracle's under the phase's rule
    (chip_smoke._fuzz_close); prints whether each pair's digests differ
    (a float on a rounding tie of the digest)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from pinot_tpu_torch.broker import Broker
    from pinot_tpu_torch.server import TableDataManager
    from pinot_tpu_torch.tools import fuzzer

    n = 1 << 16
    seg = fuzzer.build_fuzz_segment(n, str(tmp_path), device="cuda")
    dm = TableDataManager("fz", device="cuda")
    dm.add_segment(seg)
    b = Broker(device="cuda")
    b.register_table(dm)
    gen = fuzzer.QueryGenerator(20260730)
    for _ in range(201):
        gen.generate()
    spec = gen.generate()
    assert spec.seed[:2] == (20260730, 201)
    sql = fuzzer.render_sql(spec)
    got = b.query(sql).rows
    host = b.query(sql.replace("OPTION(",
                               "OPTION(forceHostExecution=true,")).rows
    want = fuzzer.oracle_rows(spec, fuzzer.make_data(n), n)
    res = dict(zip(("host", "oracle"),
                   chip_smoke._fuzz_close(got, host, want)))
    print(json.dumps({"fuzz_tie_spec": list(spec.seed[:2]), "rows": n,
                      "equal_and_tie": res, "sql": sql}))
    assert all(equal for equal, _tie in res.values()), res
    seg.evict_device()


def test_fuzz_corpus_on_card_matches_host_path(cuda, tmp_path):
    """The fuzzer's corpus over build_fuzz_segment on the card: every
    spec's rows through Broker("cuda") equal the host path's and the
    oracle's, and the corpus launches K1."""
    from pinot_tpu_torch.broker import Broker
    from pinot_tpu_torch.ops import compact as C
    from pinot_tpu_torch.server import TableDataManager
    from pinot_tpu_torch.tools import fuzzer

    n = 1 << 14
    seg = fuzzer.build_fuzz_segment(n, str(tmp_path), device="cuda")
    assert seg.device.type == "cuda"
    data = fuzzer.make_data(n)
    dm = TableDataManager("fz", device="cuda")
    dm.add_segment(seg)
    b = Broker(device="cuda")
    b.register_table(dm)
    gen = fuzzer.QueryGenerator(23)
    before = C.launches
    for _ in range(80):
        spec = gen.generate()
        sql = fuzzer.render_sql(spec)
        got = fuzzer.digest(b.query(sql).rows)
        host = fuzzer.digest(b.query(sql.replace(
            "OPTION(", "OPTION(forceHostExecution=true,")).rows)
        assert got == host == fuzzer.digest(
            fuzzer.oracle_rows(spec, data, n)), (spec.seed, sql)
    assert C.launches > before
    seg.evict_device()
