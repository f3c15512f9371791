"""The broker's overload plane and the device fault points in the port
against the JAX package, on the CPU.

``pinot_tpu_torch.broker.workload`` is the reference's module: the shed
ladder, ``retryAfterMs``, the governor's rungs (watermarks, hysteresis,
pins) and a pinned shed stream are equal in both packages over a seeded
qid list. The accountant carries tenant, tier and SQL, feeds the tenant
buckets at ``unregister`` and kills the least protected tier first. The
in-process broker admits each user query once (never a plan-only
EXPLAIN), sheds with the structured error, clamps the deadline at rung 3
and skips trace sampling at rung 1. One ``FaultPlan`` seed fires at the
same sites in both packages over the same queries, and the rows under
each device fault (``device.overflow`` on the compact rerun and on the
fused plane, ``tier.evict`` under a budget, ``accounting.oom_kill`` on one
named query) equal the unarmed rows. Then the leak tracker
(``utils/leak``) at the reference's registration points.
"""
import gc
import os
import sys
import threading

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the broker)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import pinot_tpu.broker.workload as jwl  # noqa: E402
import pinot_tpu.utils.faults as jfaults  # noqa: E402
from pinot_tpu.broker import Broker as JaxBroker  # noqa: E402
from pinot_tpu.server import TableDataManager as JaxTable  # noqa: E402
import pinot_tpu_torch.broker.workload as twl  # noqa: E402
import pinot_tpu_torch.utils.faults as tfaults  # noqa: E402
from pinot_tpu_torch.broker import Broker, connect  # noqa: E402
from pinot_tpu_torch.engine.accounting import (QueryKilledError,  # noqa
                                               ResourceAccountant,
                                               global_accountant)
from pinot_tpu_torch.engine.ragged import global_batcher  # noqa: E402
from pinot_tpu_torch.engine.tier import (global_tier,  # noqa: E402
                                         reconcile_devmem)
from pinot_tpu_torch.multistage import fused  # noqa: E402
from pinot_tpu_torch.query.sql import SqlError  # noqa: E402
from pinot_tpu_torch.segment import (ImmutableSegment,  # noqa: E402
                                     SegmentBuilder)
from pinot_tpu_torch.server import TableDataManager  # noqa: E402
from pinot_tpu_torch.spi import (DataType, FieldSpec,  # noqa: E402
                                 FieldType, Schema, TableConfig)
from pinot_tpu_torch.tools import ssb  # noqa: E402
from pinot_tpu_torch.utils import leak  # noqa: E402
from pinot_tpu_torch.utils.metrics import (global_metrics,  # noqa: E402
                                           overload_health,
                                           render_prometheus)
from test_torch_multistage import star_schema  # noqa: E402
from test_torch_tier import reset_port_memory  # noqa: E402

QIDS = [f"q{i:03d}" for i in range(160)]
TIERS = ("protected", "standard", "besteffort")


@pytest.fixture(autouse=True)
def _inert():
    """Workload state, fault plans and the batcher's window scale are
    process-global: every test starts and ends inert."""
    for m in (jwl, twl):
        m.global_workload.reset()
    for f in (jfaults, tfaults):
        f.clear()
    yield
    for m in (jwl, twl):
        m.global_workload.reset()
    for f in (jfaults, tfaults):
        f.clear()
    global_batcher.window_scale = 1.0


def _counter(name: str) -> int:
    return global_metrics.snapshot()["counters"].get(name, 0)


# ---------------------------------------------------------------------------
# the pure ladder and the governor, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rung", [0, 1, 2, 3])
def test_shed_decisions_and_retry_after_equal_reference(rung):
    for tier in TIERS:
        for qid in QIDS:
            for tenant in ("ten_a", "ten_b"):
                assert twl.shed_decision(qid, tenant, tier, rung) == \
                    jwl.shed_decision(qid, tenant, tier, rung)
                assert twl.retry_after_ms(qid, tenant, rung) == \
                    jwl.retry_after_ms(qid, tenant, rung)
    if rung == 2:
        shed = [q for q in QIDS
                if twl.shed_decision(q, "t", "standard", 2)]
        assert 0.3 * len(QIDS) < len(shed) < 0.7 * len(QIDS)
    for tier in TIERS + (None, "unknown"):
        assert twl.tier_shed_rank(tier) == jwl.tier_shed_rank(tier)


def test_governor_rungs_equal_reference():
    rng = np.random.default_rng(13)
    levels = np.concatenate([rng.uniform(0, 100, 60),
                             np.linspace(95, 0, 40),
                             [74.0, 72.0, 71.0, 49.0, 46.0, 44.0]])
    rungs = []
    for m in (jwl, twl):
        gov = m.OverloadGovernor()
        gov.POLL_S = 0.0
        level = [0.0]
        gov.add_signal("x", lambda: level[0], 100.0)
        seq = []
        for i, v in enumerate(levels):
            level[0] = float(v)
            seq.append(gov.rung(now=1000.0 + i))
        rungs.append(seq)
        assert [m.OverloadGovernor.rung_for_pressure(p / 100.0)
                for p in range(0, 120, 3)] == \
            [jwl.OverloadGovernor.rung_for_pressure(p / 100.0)
             for p in range(0, 120, 3)]
    assert rungs[1] == rungs[0]
    assert set(rungs[0]) == {0, 1, 2, 3}


def _shed_run(m, seed):
    """A pinned, seeded offered load through one package's manager: the
    admissions (tenant, tier, rung, brownout) and the shed stream."""
    rng = np.random.default_rng(seed)
    wm = m.WorkloadManager()
    for t, tier in zip(("ten_p", "ten_s", "ten_b"), TIERS):
        wm.set_tenant(t, tier=tier)
        wm.set_table_tenant(f"tbl_{tier}", t)
    wm.set_tenant("ten_r", tier="standard", retries_per_s=0.001)
    wm.set_table_tenant("tbl_retry", "ten_r")
    tables = [f"tbl_{t}" for t in TIERS] + ["tbl_retry", "unconfigured"]
    pins = {q: int(r) for q, r in zip(QIDS, rng.integers(0, 4, len(QIDS)))}
    wm.governor.pin_rungs(pins)
    out = []
    for q in QIDS:
        table = tables[int(rng.integers(0, len(tables)))]
        retry = int(rng.integers(0, 2))
        try:
            t = wm.admit(q, table, retry_attempt=retry, now=5.0)
        except m.OverloadShedError as e:
            out.append(("shed", q, e.tenant, e.tier, e.rung, e.reason,
                        e.retry_after_ms, e.payload()["errorCode"]))
        else:
            out.append(("admit", q, t.tenant, t.tier, t.rung, t.brownout,
                        t.degraded))
            wm.release(t)
    return out, wm.shed_stream()


@pytest.mark.parametrize("seed", [1, 2])
def test_pinned_shed_stream_equals_reference(seed):
    (jout, jstream), (tout, tstream) = [_shed_run(m, seed)
                                        for m in (jwl, twl)]
    assert tout == jout and tstream == jstream
    assert any(x[0] == "shed" for x in tout)
    # the same seed gives the same stream twice
    assert _shed_run(twl, seed) == (tout, tstream)


def test_parse_retry_attempt_and_clamp():
    assert twl.parse_retry_attempt({}) == 0
    assert twl.parse_retry_attempt({"retryAttempt": "2"}) == 2
    for bad in ("soon", -1):
        with pytest.raises(SqlError):
            twl.parse_retry_attempt({"retryAttempt": bad})
    opts = {"timeoutMs": "600000"}
    twl.clamp_brownout(opts, 10_000)
    assert opts == {"timeoutMs": int(twl.BROWNOUT_DEADLINE_MS),
                    "allowPartialResults": "true"}
    with pytest.raises(SqlError):
        twl.clamp_brownout({"timeoutMs": "x"}, 10_000)


def test_governor_pins_widen_the_batch_window_and_unstick():
    gov = twl.global_workload.governor
    gov.pin_rungs({"qa": 3, "qb": 0}, default=1)
    try:
        assert (gov.rung_for("qa"), gov.rung_for("qb"),
                gov.rung_for("other")) == (3, 0, 1)
        assert global_batcher.window_scale == twl.WINDOW_SCALE == 4.0
        assert gov.shed_speculative()
    finally:
        gov.unpin()
    assert global_batcher.window_scale == 1.0
    assert gov.brownout_deadline_ms() is None
    live = twl.OverloadGovernor()
    live.POLL_S = 0.0
    live.add_signal("x", lambda: 95.0, 100.0)
    assert live.rung() == 3
    live.remove_signal("x")
    assert live.rung() == 0


def test_governor_reads_no_clock_when_pinned_or_inert(monkeypatch):
    def _no_clock():
        raise AssertionError("the pinned plane read time.monotonic()")

    gov = twl.OverloadGovernor()
    monkeypatch.setattr(twl.time, "monotonic", _no_clock)
    assert gov.rung() == 0 and gov.rung_for("q1") == 0
    gov.add_signal("x", lambda: 95.0, 100.0)
    gov.pin_rungs({"q2": 2}, default=1)
    assert (gov.rung_for("q2"), gov.rung_for("q3"), gov.rung()) == (2, 1, 2)
    gov.unpin()
    assert gov.rung(now=1000.0) == 3


# ---------------------------------------------------------------------------
# budgets and the accountant's fields
# ---------------------------------------------------------------------------

def test_inflight_cpu_bytes_and_retry_budgets():
    m = twl.WorkloadManager()
    m.set_tenant("cap", max_inflight=2)
    m.set_table_tenant("t", "cap")
    t1, t2 = m.admit("q1", "t"), m.admit("q2", "t")
    with pytest.raises(twl.OverloadShedError) as ei:
        m.admit("q3", "t")
    assert ei.value.reason == "inflight_budget" and ei.value.error_code == 429
    m.release(t1)
    t3 = m.admit("q3", "t")
    for t in (t2, t3, t3):
        m.release(t)
    assert m.inflight("cap") == 0

    m.set_tenant("busy", cpu_ms_per_s=100.0)
    m.set_table_tenant("c", "busy")
    m.release(m.admit("c1", "c", now=1000.0), cpu_ms=500.0, now=1000.0)
    with pytest.raises(twl.OverloadShedError, match="cpu_budget"):
        m.admit("c2", "c", now=1000.0)
    m.release(m.admit("c2", "c", now=1005.0))

    m.set_tenant("bytes", result_bytes_per_s=1000.0)
    m.set_table_tenant("b", "bytes")
    m.release(m.admit("b1", "b", now=50.0), result_bytes=10_000.0, now=50.0)
    with pytest.raises(twl.OverloadShedError, match="bytes_budget"):
        m.admit("b2", "b", now=50.1)

    m.set_tenant("re", tier="protected", retries_per_s=0.001)
    m.set_table_tenant("r", "re")
    m.governor.pin_rungs({}, default=2)
    m.release(m.admit("r1", "r", retry_attempt=1, now=10.0))
    c0 = _counter("overload_retries_suppressed")
    with pytest.raises(twl.OverloadShedError, match="retry_budget"):
        m.admit("r2", "r", retry_attempt=1, now=10.01)
    assert _counter("overload_retries_suppressed") == c0 + 1
    m.release(m.admit("r3", "r", now=10.02))


def test_inert_fast_path_counts_nothing():
    m = twl.WorkloadManager()
    c0 = _counter("tenant_admitted_default")
    t = m.admit("q1", "whatever")
    assert t.counted is False and t.rung == 0
    m.release(t)
    assert _counter("tenant_admitted_default") == c0 and m.inflight() == 0


def test_accountant_feeds_the_tenant_buckets_with_cpu_and_bytes():
    twl.global_workload.set_tenant("fed", result_bytes_per_s=1024.0,
                                   cpu_ms_per_s=1e9)
    twl.global_workload.set_table_tenant("t", "fed")
    acct = ResourceAccountant()
    u = acct.register("qf", tenant="fed", tier="standard", sql="SELECT 1")
    assert (u.tenant, u.tier, u.sql) == ("fed", "standard", "SELECT 1")
    sum(i * i for i in range(200_000))       # CPU time on this thread
    acct.sample()
    assert u.cpu_s > 0.0
    acct.track_memory(1 << 20)
    acct.unregister("qf")                    # -> global_workload.observe
    with pytest.raises(twl.OverloadShedError, match="bytes_budget"):
        twl.global_workload.admit("q2", "t")


def test_kill_most_expensive_prefers_the_least_protected_tier():
    acct = ResourceAccountant()
    prot = acct.register("vip", tenant="a", tier="protected")
    acct.register("cheap", tenant="b", tier="besteffort")
    std = acct.register("mid", tenant="c", tier="standard")
    prot.mem_bytes, std.mem_bytes = 1 << 30, 1 << 20
    assert acct.kill_most_expensive("pressure") == "cheap"
    assert acct.kill_most_expensive("pressure") == "mid"
    assert prot.killed_reason is None
    assert acct.kill_most_expensive("pressure") == "vip"
    for q in ("vip", "cheap", "mid"):
        acct.unregister(q)


def test_arm_default_signals_sheds_live_on_the_devmem_signal():
    m = twl.WorkloadManager()
    m.governor.POLL_S = 0.0
    twl.arm_default_signals(m, inflight_capacity=4,
                            rss_limit_bytes=1 << 50,
                            devmem_budget_bytes=1 << 40,
                            queue_depth_fn=lambda: 0.0, queue_capacity=8)
    assert sorted(m.governor.snapshot()["signals"]) == \
        ["devmem", "inflight", "queue", "rss"]
    m.set_tenant("be", tier="besteffort")
    m.set_table_tenant("t", "be")
    tickets = [m.admit(f"q{i}", "t") for i in range(3)]
    assert m.governor.rung() == 2
    with pytest.raises(twl.OverloadShedError):
        m.admit("q3", "t")
    for t in tickets:
        m.release(t)
    assert m.governor.rung() == 0
    m.release(m.admit("q4", "t"))


# ---------------------------------------------------------------------------
# the in-process broker
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tenant_brokers(tmp_path_factory):
    """Two tables on two tenants, in the JAX broker and the port's."""
    rng = np.random.default_rng(3)
    n = 512
    cols = {"k": rng.integers(0, 8, n).astype(np.int32),
            "v": rng.integers(0, 100, n).astype(np.int32)}
    fields = [FieldSpec("k", DataType.INT, FieldType.DIMENSION),
              FieldSpec("v", DataType.INT, FieldType.METRIC)]
    jb, tb = JaxBroker(), Broker(device="cpu")
    for table, tenant in (("ovl_prot", "ten_p"), ("ovl_be", "ten_b")):
        cfg = TableConfig(table, tenant=tenant)
        d = SegmentBuilder(Schema(table, fields), cfg).build(
            cols, str(tmp_path_factory.mktemp(table)), "s0")
        dm = TableDataManager(table, device="cpu", table_config=cfg)
        dm.add_segment_dir(d)
        tb.register_table(dm)
        jdm = JaxTable(table)
        from pinot_tpu.spi import TableConfig as JaxConfig
        jdm.table_config = JaxConfig(table, tenant=tenant)
        jdm.add_segment_dir(d)
        jb.register_table(jdm)
    return jb, tb


def _tenants_on(m):
    """The tenants' tiers, and the tables' tenants again (each test
    starts from the inert default; register_table set them once)."""
    m.global_workload.set_tenant("ten_p", tier="protected")
    m.global_workload.set_tenant("ten_b", tier="besteffort")
    m.global_workload.set_table_tenant("ovl_prot", "ten_p")
    m.global_workload.set_table_tenant("ovl_be", "ten_b")


SHED_SQL = [("SELECT COUNT(*), SUM(v) FROM ovl_be OPTION(queryId=sq{i})"),
            ("SELECT k, SUM(v) FROM ovl_prot GROUP BY k ORDER BY k "
             "OPTION(queryId=sq{i})")]


def _broker_stream(m, broker, pins):
    _tenants_on(m)
    m.global_workload.governor.pin_rungs(pins)
    out = []
    try:
        for i in range(len(pins)):
            sql = SHED_SQL[i % 2].format(i=i)
            try:
                out.append(("rows", [tuple(r) for r in
                                     broker.query(sql).rows]))
            except m.OverloadShedError as e:
                out.append(("shed", e.payload()))
        return out, m.global_workload.shed_stream()
    finally:
        m.global_workload.governor.unpin()


def test_broker_shed_stream_equals_reference(tenant_brokers):
    jb, tb = tenant_brokers
    pins = {f"sq{i}": i % 4 for i in range(16)}
    (jout, jstream), (tout, tstream) = (_broker_stream(jwl, jb, pins),
                                        _broker_stream(twl, tb, pins))
    assert tout == jout and tstream == jstream
    sheds = [p for kind, p in tout if kind == "shed"]
    assert sheds and all(p["errorCode"] == 429 and p["retryAfterMs"] > 0
                         and p["tenant"] == "ten_b" for p in sheds)
    # the protected tenant is never shed, and answers its rows
    assert all(kind == "rows" for i, (kind, _p) in enumerate(tout)
               if i % 2 == 1)


def test_broker_brownout_clamps_and_explain_is_not_admitted(tenant_brokers):
    _jb, tb = tenant_brokers
    _tenants_on(twl)
    twl.global_governor.pin_rungs({}, default=3)
    c0 = _counter("overload_brownout_clamped")
    a0 = _counter("tenant_admitted_ten_p")
    try:
        res = tb.query("SELECT COUNT(*) FROM ovl_prot "
                       "OPTION(queryId=bq1, timeoutMs=600000)")
        assert res.rows[0][0] == 512
        # a plan-only EXPLAIN is never admitted, so never shed
        assert tb.query("EXPLAIN PLAN FOR SELECT COUNT(*) FROM ovl_be").rows
        with pytest.raises(twl.OverloadShedError):
            tb.query("SELECT COUNT(*) FROM ovl_be")
    finally:
        twl.global_governor.unpin()
    assert _counter("overload_brownout_clamped") == c0 + 1
    assert _counter("tenant_admitted_ten_p") == a0 + 1


def test_broker_rung1_skips_trace_sampling(tenant_brokers):
    _jb, tb = tenant_brokers
    _tenants_on(twl)
    tb._trace_ratio = 1.0
    try:
        s0 = _counter("sampled_traces")
        twl.global_governor.pin_rungs({}, default=1)
        try:
            tb.query("SELECT COUNT(*) FROM ovl_prot OPTION(queryId=tr1)")
        finally:
            twl.global_governor.unpin()
        assert _counter("sampled_traces") == s0
        tb.query("SELECT COUNT(*) FROM ovl_prot OPTION(queryId=tr2)")
        assert _counter("sampled_traces") == s0 + 1
    finally:
        tb._trace_ratio = 0.0


def test_broker_registers_tenant_tier_and_sql(tenant_brokers):
    _jb, tb = tenant_brokers
    _tenants_on(twl)
    seen = []
    real = global_accountant.register

    def spy(query_id, **kw):
        seen.append((query_id, kw.get("tenant"), kw.get("tier"),
                     kw.get("sql")))
        return real(query_id, **kw)

    global_accountant.register = spy
    try:
        sql = "SELECT COUNT(*) FROM ovl_be OPTION(queryId=reg1)"
        tb.query(sql)
        tb.query("SELECT COUNT(*) FROM ovl_prot")
    finally:
        del global_accountant.register
    assert seen[0] == ("reg1", "ten_b", "besteffort", sql)
    assert seen[1][1:3] == ("ten_p", "protected")
    assert twl.global_workload.resolve("never") == ("default", "standard")


def test_overload_health_block_and_prometheus(tenant_brokers):
    _jb, tb = tenant_brokers
    _tenants_on(twl)
    twl.global_governor.pin_rungs({"hq": 2})
    try:
        with pytest.raises(twl.OverloadShedError):
            tb.query("SELECT COUNT(*) FROM ovl_be OPTION(queryId=hq)")
    finally:
        twl.global_governor.unpin()
    snap = global_metrics.snapshot()
    h = overload_health(snap)
    assert h["overload_shed"] >= 1 and h["shed_by_rung"].get("2", 0) >= 1
    assert h["shed_by_tenant"].get("ten_b", 0) >= 1
    assert "ten_b" in h["inflight_by_tenant"] or h["inflight_by_tenant"]
    assert "pinot_tpu_overload_shed_total" in render_prometheus(snap)


# ---------------------------------------------------------------------------
# the device fault points
# ---------------------------------------------------------------------------

OPT = " OPTION(timeoutMs=600000, groupByStrategy=compact, queryId={q})"
COMPACT = [(qid, ssb.spec_to_sql(p, v, g)) for qid, p, v, g in ssb.QUERIES
           if g]


@pytest.fixture(scope="module")
def ssb_tables(tmp_path_factory):
    """One SSB segment and a 3-segment table on the port (CPU), the same
    segment in the JAX broker, and the port's unarmed rows."""
    root = tmp_path_factory.mktemp("ovl_ssb")
    one = ssb.build_table_dir([3000], str(root / "one"))
    three = ssb.build_table_dir([1500, 1200, 1400], str(root / "three"))
    jdm = JaxTable("lineorder")
    jdm.add_table_dir(one)
    jb = JaxBroker()
    jb.register_table(jdm)
    b = Broker(device="cpu")
    dm = TableDataManager("lineorder", device="cpu")
    dm.add_table_dir(one)
    dm3 = TableDataManager("lineorder3", device="cpu")
    dm3.add_table_dir(three)
    b.register_table(dm)
    b.register_table(dm3)
    q = connect(b)
    want = {qid: q(sql + OPT.format(q="w" + qid)).rows
            for qid, sql in COMPACT}
    want3 = {qid: q(sql.replace("FROM lineorder", "FROM lineorder3")
                    + OPT.format(q="w3" + qid)).rows
             for qid, sql in COMPACT}
    return jb, b, dm, dm3, want, want3


def _fired(plan):
    return sorted((f["point"], f["key"], f["hit"], f.get("q", ""))
                  for f in plan.fired)


@pytest.mark.parametrize("seed", [7, 8])
def test_one_seed_fires_at_the_same_sites_in_both_packages(ssb_tables,
                                                           seed,
                                                           monkeypatch):
    """device.overflow at p=0.5 and accounting.oom_kill on one named
    query over the compact SSB queries: the same (point, site, hit,
    query) in both packages, the same rows or the same kill."""
    jb, b, _dm, _dm3, want, _w3 = ssb_tables
    monkeypatch.setenv("PINOT_CPU_FAST_GROUPBY", "1")
    victim = f"f{seed}q3.1"
    text = (f"seed={seed}; device.overflow: p=0.5; "
            f"accounting.oom_kill: match={victim}, times=1")
    runs = []
    for f, broker in ((jfaults, jb), (tfaults, b)):
        plan = f.install(text)
        out = []
        for qid, sql in COMPACT:
            try:
                out.append(broker.query(sql + OPT.format(
                    q=f"f{seed}{qid}")).rows)
            except Exception as e:       # either package's QueryKilledError
                out.append(type(e).__name__)
        f.clear()
        runs.append((out, _fired(plan)))
    (jout, jfired), (tout, tfired) = runs
    assert tfired == jfired
    assert {p for p, *_ in tfired} == {"device.overflow",
                                       "accounting.oom_kill"}
    assert tout == jout
    assert tout == [("QueryKilledError" if f"f{seed}{qid}" == victim
                     else want[qid]) for qid, _sql in COMPACT]


def test_forced_overflow_reruns_every_compact_query_with_the_same_rows(
        ssb_tables):
    _jb, b, _dm, _dm3, want, _w3 = ssb_tables
    q = connect(b)
    r0 = _counter("compact_overflow_retries")
    plan = tfaults.install("seed=1; device.overflow: p=1")
    try:
        for qid, sql in COMPACT:
            assert q(sql + OPT.format(q="ov" + qid)).rows == want[qid], qid
    finally:
        tfaults.clear()
    assert len(plan.fired) == len(COMPACT)
    assert _counter("compact_overflow_retries") == r0 + len(COMPACT)


def test_tier_evict_under_a_budget_keeps_rows_and_memory(ssb_tables):
    _jb, b, _dm, dm3, _w, want3 = ssb_tables
    segs = dm3.acquire_segments()
    reset_port_memory(segs)
    global_tier.configure(budget_bytes=1 << 40)
    q = connect(b)
    plan = tfaults.install("seed=5; tier.evict: p=0.25")
    try:
        for qid, sql in COMPACT:
            sql = sql.replace("FROM lineorder", "FROM lineorder3")
            assert q(sql + OPT.format(q="ev" + qid)).rows == want3[qid]
            rec = reconcile_devmem(segs)
            assert all(r["tracked"] == r["actual"] for r in rec.values())
    finally:
        tfaults.clear()
        global_tier.configure(budget_bytes=None)
    faults = [d for d in global_tier.decisions
              if d[0] == "demote" and d[4] == "fault"]
    # a fault on a segment already demoted in this query moves nothing
    assert 0 < len(faults) <= len(plan.fired)
    reset_port_memory(segs)


def test_oom_kill_names_one_of_eight_concurrent_queries(ssb_tables):
    _jb, b, _dm, _dm3, want, _w3 = ssb_tables
    q = connect(b)
    jobs = [(f"cc{i}", COMPACT[i % len(COMPACT)]) for i in range(8)]
    victim = jobs[3][0]
    out = {}
    tfaults.install(f"seed=2; accounting.oom_kill: match={victim}")

    def run(name, qid, sql):
        try:
            out[name] = q(sql + OPT.format(q=name)).rows == want[qid]
        except QueryKilledError as e:
            out[name] = e

    try:
        threads = [threading.Thread(target=run, args=(n, qid, sql))
                   for n, (qid, sql) in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        tfaults.clear()
    assert isinstance(out.pop(victim), QueryKilledError)
    assert out == {n: True for n, _j in jobs if n != victim}


def test_fused_overflow_falls_back_to_the_mailbox_plane(tmp_path,
                                                        monkeypatch):
    for k in ("PINOT_DEVICE_JOIN_MIN_ROWS", "PINOT_DEVICE_WINDOW_MIN_ROWS",
              "PINOT_FUSED_MIN_ROWS"):
        monkeypatch.setenv(k, "0")
    dirs = star_schema(str(tmp_path / "star"), n_orders=2048)
    b = Broker(device="cpu")
    for name, ds in dirs.items():
        dm = TableDataManager(name, device="cpu")
        for d in ds:
            dm.add_segment_dir(d)
        b.register_table(dm)
    sql = ("SELECT c.c_nation, SUM(o.o_price), COUNT(*) FROM orders o "
           "JOIN customers c ON o.o_cust = c.c_id GROUP BY c.c_nation "
           "ORDER BY c.c_nation OPTION(multistageFused=true)")
    want = b.query(sql).rows
    s0 = dict(fused.STATS)
    plan = tfaults.install("seed=1; device.overflow: match=multistage.fused")
    try:
        with leak.leak_check("mailbox"):
            assert b.query(sql).rows == want
            gc.collect()
    finally:
        tfaults.clear()
    assert [f["key"] for f in plan.fired] == ["multistage.fused"]
    assert fused.STATS["fused_fallbacks"] == s0["fused_fallbacks"] + 1
    assert leak.live("mailbox") == []


# ---------------------------------------------------------------------------
# the leak tracker
# ---------------------------------------------------------------------------

def _leak_segment(tmpdir, name="s0", n=3000, seed=7):
    rng = np.random.default_rng(seed)
    schema = Schema("lr", [FieldSpec("k", DataType.INT, FieldType.DIMENSION),
                           FieldSpec("v", DataType.LONG, FieldType.METRIC)])
    return SegmentBuilder(schema, TableConfig("lr")).build(
        {"k": rng.integers(0, 9, n).astype(np.int32),
         "v": rng.integers(0, 100, n).astype(np.int64)}, str(tmpdir), name)


def test_segment_lifecycle_no_leak_and_survivor_caught(tmp_path):
    d = _leak_segment(tmp_path)
    with leak.leak_check("segment"):
        dm = TableDataManager("lr", device="cpu")
        dm.add_segment_dir(d)
        b = Broker(device="cpu")
        b.register_table(dm)
        assert b.query("SELECT COUNT(*) FROM lr").rows[0][0] == 3000
        dm.remove_segment("s0")
        del dm, b
        gc.collect()
    keep = []
    with pytest.raises(AssertionError, match="leaked"):
        with leak.leak_check("segment"):
            keep.append(ImmutableSegment.load(d, "cpu"))
    keep.clear()
    with leak.leak_check("segment"):       # released: no survivor now
        keep.append(ImmutableSegment.load(d, "cpu"))
        keep.clear()


def test_concurrent_queries_and_segment_churn(tmp_path):
    dm = TableDataManager("lr", device="cpu")
    dirs = [_leak_segment(tmp_path / f"g{i}", f"s{i}", n=2000, seed=i)
            for i in range(4)]
    for d in dirs[:2]:
        dm.add_segment_dir(d)
    b = Broker(device="cpu")
    b.register_table(dm)
    valid = {2000 * k for k in range(1, 5)}
    errors = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                n = b.query("SELECT COUNT(*) FROM lr").rows[0][0]
                assert n in valid, n
            except Exception as e:
                errors.append(e)
                return

    def churner():
        try:
            for _ in range(10):
                dm.add_segment_dir(dirs[2])
                dm.add_segment_dir(dirs[3])
                dm.remove_segment("s3")
                dm.remove_segment("s2")
        except Exception as e:
            errors.append(e)

    readers = [threading.Thread(target=reader) for _ in range(3)]
    ch = threading.Thread(target=churner)
    for t in readers + [ch]:
        t.start()
    ch.join()
    stop.set()
    for t in readers:
        t.join()
    assert not errors, errors[:1]
