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
fuzzer seed on the card the oracle's.
"""
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


RACE_CYCLES = 4 * SLEEP_CYCLES    # about 100 ms


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


def test_star_schema_on_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """The star schema's shapes on every plane: the card's rows equal
    the CPU's, through K16, K17 and K19 on the card."""
    from pinot_tpu_torch.multistage import window
    from pinot_tpu_torch.ops import join as ops_join
    from pinot_tpu_torch.ops import segscan
    from pinot_tpu_torch.multistage import fused
    from pinot_tpu_torch.tools import star

    for k in ("PINOT_DEVICE_JOIN_MIN_ROWS", "PINOT_DEVICE_WINDOW_MIN_ROWS",
              "PINOT_FUSED_MIN_ROWS"):
        monkeypatch.setenv(k, "0")
    dirs = star.build_tables(str(tmp_path), star.star_tables(1 << 15))
    on_card = star.load_broker(dirs, "cuda")
    on_cpu = star.load_broker(dirs, "cpu")
    counts0 = (ops_join.launches, segscan.launches,
               window.segment_agg_launches, fused.launches)
    for csr in ("4194304", "0"):
        monkeypatch.setenv("PINOT_FUSED_MAX_CSR", csr)
        for name, make in star.SHAPES:
            for opt in ("true", "false"):
                sql = make(1) + f" OPTION(multistageFused={opt})"
                assert on_card.query(sql).rows == on_cpu.query(sql).rows, \
                    (name, opt, csr)
    counts = (ops_join.launches, segscan.launches,
              window.segment_agg_launches, fused.launches)
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
