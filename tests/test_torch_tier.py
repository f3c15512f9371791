"""The port's device tier, heat and device-memory accounting, on the CPU.

Held to the JAX package on the same inputs: the heat scores of one touch
sequence with the clock pinned, and the decision log of the tier's replay
sequence (``tests/test_tier.py``'s ``SEQ``), each package with its own
registries. Then on ``Broker(device="cpu")`` over a two-segment SSB table:
every SSB query gives the JAX ``Broker``'s rows (computed once, with no
budget) when its segments are hot, warm, cold, under a budget smaller than
the working set, and with a demotion forced mid-query through the tier's
``on_access`` hook. Also: the demote/promote transitions, a constrained
budget against evicting everything between queries (fewer uploads, the
tracked device bytes equal to the tensors held), the warm budget's trim
of a hot segment's stash, and ``remove_segment``.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402
from pinot_tpu.broker import Broker as JaxBroker  # noqa: E402
from pinot_tpu.engine.tier import TierManager as JaxTier  # noqa: E402
from pinot_tpu.server import TableDataManager as JaxTable  # noqa: E402
from pinot_tpu.utils.devmem import DeviceMemoryRegistry as JaxDevmem  # noqa
from pinot_tpu.utils.heat import SegmentHeat as JaxHeat  # noqa: E402
from pinot_tpu_torch.broker import Broker, connect  # noqa: E402
from pinot_tpu_torch.engine import batch  # noqa: E402
from pinot_tpu_torch.index import vector  # noqa: E402
from pinot_tpu_torch.ops.plan_cache import global_cube_cache  # noqa: E402
from pinot_tpu_torch.engine.tier import (TIER_COLD, TIER_HOT,  # noqa: E402
                                         TIER_WARM, TierManager,
                                         global_tier, reconcile_devmem,
                                         segment_tier, tier_health)
from pinot_tpu_torch.server import TableDataManager  # noqa: E402
from pinot_tpu_torch.tools import ssb  # noqa: E402
from pinot_tpu_torch.utils.devmem import (DeviceMemoryRegistry,  # noqa
                                          global_device_memory)
from pinot_tpu_torch.utils.heat import (SegmentHeat,  # noqa: E402
                                        global_segment_heat)
from pinot_tpu_torch.utils.metrics import global_metrics  # noqa: E402

SIZES = [1800, 1500]
SSB_SQL = [(qid, ssb.spec_to_sql(p, v, g)) for qid, p, v, g in ssb.QUERIES]


def reset_port_memory(segments=()) -> None:
    """Evict the given segments and start every process-global registry
    of the port's memory plane afresh."""
    vars(global_tier).pop("on_access", None)    # a test's hook
    for s in segments:
        s.evict_device()
    for r in vector.live_readers():             # the vector pool
        r.evict_device()
    batch.clear_stack_cache()
    global_cube_cache.clear()           # its bytes are the tracker's too
    global_device_memory.clear()
    global_segment_heat.clear()
    global_tier.clear()


class _Seg:
    """Bare segment stand-in for the heat and tier state machines."""

    def __init__(self, uid, name, devmem=None):
        self.uid = uid
        self.name = name
        self._devmem = devmem
        self._device = {}
        self._warm = {}

    def demote_device(self, drop_warm: bool = False) -> None:
        for key in list(self._device):
            self._devmem.remove("segment_cols", (self.uid, key))
        self._device.clear()
        if drop_warm:
            self._warm.clear()


# ---------------------------------------------------------------------------
# heat and the tier's state machine, against the JAX package's
# ---------------------------------------------------------------------------

TOUCHES = [(1, 1000, 1.0), (2, 5_000_000, 2.0), (1, 0, 30.0),
           (3, 250_000, 31.5), (2, 10, 400.0), (1, 7, 401.0)]


@pytest.mark.parametrize("now", [401.0, 1000.0, 5000.0])
def test_heat_scores_match_jax(now):
    segs = {u: _Seg(u, f"s{u}") for u in (1, 2, 3)}
    port, ref = SegmentHeat(half_life_s=60.0), JaxHeat(half_life_s=60.0)
    for uid, rows, t in TOUCHES:
        port.touch(segs[uid], "t", rows, now=t)
        ref.touch(segs[uid], "t", rows, now=t)
    assert port.scores(now=now) == ref.scores(now=now)
    port.device_access(segs[1], True)
    ref.device_access(segs[1], True)
    strip = [{k: v for k, v in e.items() if k != "heat"}
             for e in port.snapshot()]
    assert strip == [{k: v for k, v in e.items() if k != "heat"}
                     for e in ref.snapshot()]


# the replay of tests/test_tier.py
SEQ = [
    ("touch", 1, 1000, 1.0), ("admit", 1, 1000),
    ("touch", 2, 1000, 2.0), ("admit", 2, 1000),
    ("touch", 3, 1000, 3.0), ("admit", 3, 1000),
    ("touch", 4, 1000, 4.0), ("admit", 4, 1000),
    ("touch", 2, 1000, 5.0),
    ("touch", 5, 1000, 6.0), ("admit", 5, 1000),
]


def _replay(seq, tier_cls, devmem_cls, heat_cls):
    devmem = devmem_cls()
    heat = heat_cls(half_life_s=60.0)
    mgr = tier_cls(devmem=devmem, heat=heat, budget_bytes=3000)
    segs = {i: _Seg(i, f"s{i}", devmem) for i in range(1, 6)}
    for ev in seq:
        if ev[0] == "touch":
            _, uid, rows, now = ev
            heat.touch(segs[uid], "t", rows, now=now)
        else:
            _, uid, nbytes = ev
            key = f"c{len(segs[uid]._device)}"
            segs[uid]._device[key] = None
            devmem.add("segment_cols", (uid, key), nbytes)
            mgr.admitted(segs[uid])
    return mgr


def test_tier_decisions_match_jax():
    port = _replay(SEQ, TierManager, DeviceMemoryRegistry, SegmentHeat)
    ref = _replay(SEQ, JaxTier, JaxDevmem, JaxHeat)
    assert port.decisions == ref.decisions
    demotes = [d for d in port.decisions if d[0] == "demote"]
    assert demotes[0][1] == "s1" and demotes[0][4] == "budget"
    assert (port.promotions, port.demotions) == (ref.promotions,
                                                 ref.demotions)
    assert port.occupancy()["hot"] == ref.occupancy()["hot"]


def test_tier_transitions_hot_warm_cold_hot():
    devmem = DeviceMemoryRegistry()
    mgr = TierManager(devmem=devmem, heat=SegmentHeat(half_life_s=60.0))
    s = _Seg(11, "s11", devmem)
    s._device["c0"] = None
    devmem.add("segment_cols", (11, "c0"), 100)
    mgr.admitted(s)
    assert mgr.occupancy()["hot"] == {"segments": 1, "bytes": 100}
    s._warm["c0"] = object()
    assert mgr.demote(s, TIER_WARM)       # hot -> warm
    assert not s._device and s._warm and segment_tier(s) == TIER_WARM
    assert mgr.occupancy()["warm"]["segments"] == 1
    assert not mgr.demote(s, TIER_WARM)   # warm -> warm: no transition
    assert mgr.demote(s, TIER_COLD)
    assert not s._warm and segment_tier(s) == TIER_COLD
    assert not mgr.demote(s, TIER_COLD)
    p0 = mgr.promotions
    s._device["c0"] = None
    devmem.add("segment_cols", (11, "c0"), 100)
    mgr.admitted(s)
    assert mgr.promotions == p0 + 1 and segment_tier(s) == TIER_HOT
    assert [d[2:4] for d in mgr.decisions] == [
        (TIER_COLD, TIER_HOT), (TIER_HOT, TIER_WARM),
        (TIER_WARM, TIER_COLD), (TIER_COLD, TIER_HOT)]


# ---------------------------------------------------------------------------
# the SSB table on Broker(device="cpu") against the JAX Broker
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Two two-segment SSB tables (the second with other rows) on the
    port, and the JAX Broker's rows of the first, computed once."""
    root = tmp_path_factory.mktemp("tier")
    d = ssb.build_table_dir(SIZES, str(root / "a"))
    d2 = ssb.build_table_dir([1200, 1700], str(root / "b"))
    os.environ["PINOT_CPU_FAST_GROUPBY"] = "1"
    try:
        jdm = JaxTable("lineorder")
        jdm.add_table_dir(d)
        jb = JaxBroker()
        jb.register_table(jdm)
        want = {qid: jb.query(sql + bench.OPTION).rows
                for qid, sql in SSB_SQL}
    finally:
        os.environ["PINOT_CPU_FAST_GROUPBY"] = "0"
    dm = TableDataManager("lineorder", device="cpu")
    dm.add_table_dir(d)
    dm2 = TableDataManager("lineorder2", device="cpu")
    dm2.add_table_dir(d2)
    b = Broker(device="cpu")
    b.register_table(dm)
    b.register_table(dm2)
    return dm, dm2, connect(b), want


@pytest.fixture(autouse=True)
def _fresh_memory(request):
    segs = []
    if "tables" in request.fixturenames:
        dm, dm2, _q, _w = request.getfixturevalue("tables")
        segs = dm.acquire_segments() + dm2.acquire_segments()
    reset_port_memory(segs)
    yield
    reset_port_memory(segs)


def _reconciled(segs) -> bool:
    rec = reconcile_devmem(segs)
    return all(r["tracked"] == r["actual"] for r in rec.values())


def _demote_all(segs, to):
    for s in segs:
        assert global_tier.demote(s, to)
    assert all(segment_tier(s) == to for s in segs)


MODES = ["hot", "warm", "cold", "constrained", "forced"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("qid,sql", SSB_SQL, ids=[q for q, _ in SSB_SQL])
def test_ssb_rows_equal_jax_in_every_tier(tables, qid, sql, mode):
    dm, dm2, query, want = tables
    segs = dm.acquire_segments()
    if mode == "constrained":
        # well under one segment's columns: every admission demotes
        global_tier.configure(budget_bytes=4096)
    elif mode != "hot":
        global_tier.configure(budget_bytes=1 << 40)
    assert query(sql).rows == want[qid]
    if mode in ("warm", "cold"):
        _demote_all(segs, TIER_WARM if mode == "warm" else TIER_COLD)
        p0 = global_tier.promotions
        assert query(sql).rows == want[qid]
        assert global_tier.promotions >= p0 + len(segs)
        assert all(segment_tier(s) == TIER_HOT for s in segs)
    elif mode == "forced":
        seen = []

        def demote_first(seg):
            if not seen:
                seen.append(seg)
                global_tier.demote(seg, TIER_WARM, reason="test")

        global_tier.on_access = demote_first
        assert query(sql).rows == want[qid]
        assert seen and segment_tier(seen[0]) == TIER_HOT
        name = seen[0].name
        log = [d[:2] for d in global_tier.decisions]
        assert ("demote", name) in log
        assert ("promote", name) in log[log.index(("demote", name)):]
    else:
        assert query(sql).rows == want[qid]
    assert _reconciled(dm.acquire_segments() + dm2.acquire_segments())


def _uploads() -> int:
    return sum(e["device_misses"] for e in global_segment_heat.snapshot())


def test_constrained_budget_beats_evict_all(tables):
    dm, dm2, query, want = tables
    segs = dm.acquire_segments() + dm2.acquire_segments()
    mix = []
    for qid, sql in SSB_SQL:
        if qid in ("q1.1", "q2.1", "q4.1"):
            mix += [(qid, sql), (qid, sql.replace("FROM lineorder ",
                                                  "FROM lineorder2 "))]

    def run_mix():
        return [query(sql).rows for _q, sql in mix]

    base = run_mix()
    peak = global_device_memory.snapshot()["total"]["bytes"]
    u0 = _uploads()
    straw = []
    for _qid, sql in mix:
        for s in segs:
            s.evict_device()
        straw.append(query(sql).rows)
    straw_uploads = _uploads() - u0
    assert straw == base
    for s in segs:
        s.evict_device()
    global_tier.configure(budget_bytes=peak // 2)
    d0 = global_tier.demotions
    run_mix()                              # settle under the budget
    u1 = _uploads()
    assert run_mix() == base
    assert base[0] == want["q1.1"]
    assert global_tier.demotions > d0, "the constrained budget never demoted"
    assert _uploads() - u1 < straw_uploads
    assert _reconciled(segs)
    snap = tier_health(global_metrics.snapshot())
    assert snap["armed"] and snap["demotions"] == global_tier.demotions
    counters = global_metrics.snapshot()["counters"]
    assert counters["tier_demotions"] >= global_tier.demotions - d0


def test_warm_budget_trims_hot_stash(tables):
    dm, _dm2, query, want = tables
    segs = dm.acquire_segments()
    global_tier.configure(budget_bytes=1 << 40)
    sql = dict(SSB_SQL)["q1.1"]
    assert query(sql).rows == want["q1.1"]
    assert all(s._warm for s in segs), "armed runs stash warm"
    before = {s.uid: dict(s._device) for s in segs}
    global_tier.configure(warm_budget_bytes=1)
    assert all(not s._warm for s in segs)
    assert {s.uid: dict(s._device) for s in segs} == before
    assert [d[0] for d in global_tier.decisions].count("trim_warm") == 2
    assert query(sql).rows == want["q1.1"]


def test_remove_segment_drops_devmem_and_stacks(tmp_path):
    d = ssb.build_table_dir(SIZES, str(tmp_path))
    dm = TableDataManager("lineorder", device="cpu")
    dm.add_table_dir(d)
    b = Broker(device="cpu")
    b.register_table(dm)
    query = connect(b)
    segs = dm.acquire_segments()
    # a segmented compact group-by stacks both segments' columns
    sql = dict(SSB_SQL)["q2.1"] + " OPTION(groupByStrategy=compact)"
    query(sql)
    assert batch._STACK_CACHE and _reconciled(segs)
    gone = segs[0]
    dm.remove_segment(gone.name)
    assert dm.num_segments == 1 and not gone._device
    assert not any(k[0] == gone.uid
                   for k in global_device_memory._pools["segment_cols"])
    assert not batch._STACK_CACHE
    assert global_device_memory.pool_bytes("stack_cache") == 0
    assert _reconciled(segs)
    dm.replace_segment(gone)
    assert dm.num_segments == 2
    assert query(sql).rows
