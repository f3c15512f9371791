"""Selectivity-drift feedback on the port's solo kernel path, on the CPU.

One SSB segment of 2^16 rows (large enough that the compaction capacity
clears its ``MIN_SLOTS`` floor) and a compact group-by over correlated
predicates: ``d_year = 1994 AND d_yearmonthnum BETWEEN 199401 AND
199412``. The IR estimate multiplies them (1/7 x 12/84 = 1/49) while the
true fraction is 1/7, so the first run overflows its capacity. Held to
the JAX package on the same segment: on the second planning both planners
count ``selectivity_drift_detected`` and carry the same measured
selectivity, the port re-derives its capacity (``drift_requantized``),
and both brokers give equal rows. The two cost models size capacities
differently, so the caps themselves are not compared. Also: a plan that
overflowed before goes straight to full capacity, with no doomed tight
run.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pinot_tpu.broker import Broker as JaxBroker  # noqa: E402
from pinot_tpu.query.context import build_query_context as j_ctx  # noqa
from pinot_tpu.query.planner import SegmentPlanner as JPlanner  # noqa
from pinot_tpu.query.sql import parse_sql as j_parse  # noqa: E402
from pinot_tpu.server import TableDataManager as JaxTable  # noqa: E402
from pinot_tpu.utils.metrics import global_metrics as j_metrics  # noqa
from pinot_tpu_torch.broker import Broker, connect  # noqa: E402
from pinot_tpu_torch.engine import executor  # noqa: E402
from pinot_tpu_torch.multistage import costs  # noqa: E402
from pinot_tpu_torch.ops import compact  # noqa: E402
from pinot_tpu_torch.ops.plan_cache import global_plan_cache  # noqa: E402
from pinot_tpu_torch.query.context import build_query_context  # noqa
from pinot_tpu_torch.query.planner import SegmentPlanner  # noqa: E402
from pinot_tpu_torch.query.sql import parse_sql  # noqa: E402
from pinot_tpu_torch.server import TableDataManager  # noqa: E402
from pinot_tpu_torch.tools import ssb  # noqa: E402
from pinot_tpu_torch.utils.metrics import global_metrics  # noqa: E402
from test_torch_tier import reset_port_memory  # noqa: E402

N = 1 << 16
SQL = ("SELECT d_yearmonthnum, SUM(lo_revenue), COUNT(*) FROM lineorder "
       "WHERE d_year = 1994 AND d_yearmonthnum BETWEEN 199401 AND 199412 "
       "GROUP BY d_yearmonthnum ORDER BY d_yearmonthnum LIMIT 20")
PORT_OPT = " OPTION(groupByStrategy=compact)"
JAX_OPT = " OPTION(groupByStrategy=compact,timeoutMs=600000)"
DETECTED = "selectivity_drift_detected"
REQUANT = "selectivity_drift_requantized"


@pytest.fixture()
def segments(tmp_path):
    """A fresh segment per test (the measurements key on its uid) on both
    packages, with the port's feedback and metrics cleared."""
    d = ssb.build_segment_dir(N, str(tmp_path))
    dm = TableDataManager("lineorder", device="cpu")
    seg = dm.add_segment_dir(d)
    b = Broker(device="cpu")
    b.register_table(dm)
    jdm = JaxTable("lineorder")
    jseg = jdm.add_segment_dir(d)
    jb = JaxBroker()
    jb.register_table(jdm)
    global_plan_cache.clear()
    global_metrics.clear()
    yield seg, connect(b), jseg, jb
    reset_port_memory([seg])
    global_plan_cache.clear()


@pytest.fixture()
def caps(monkeypatch):
    """The capacity of every kernel run of the solo path, in order."""
    seen = []
    run = executor._run

    def spy(plan, cols, params, slots_cap, xfer_compact):
        seen.append(slots_cap)
        return run(plan, cols, params, slots_cap, xfer_compact)

    monkeypatch.setattr(executor, "_run", spy)
    return seen


def _count(metrics, name) -> int:
    return metrics.snapshot()["counters"].get(name, 0)


def test_drift_requantizes_like_jax(segments, caps):
    seg, query, jseg, jb = segments
    first = SegmentPlanner(build_query_context(parse_sql(SQL + PORT_OPT)),
                           seg).plan()
    jfirst = JPlanner(j_ctx(j_parse(SQL + JAX_OPT)), jseg).plan()
    assert first.kernel_plan.strategy == jfirst.kernel_plan.strategy \
        == "compact"
    assert first.est_selectivity == pytest.approx(1 / 49)
    assert first.est_selectivity == jfirst.est_selectivity
    assert not first.drift_requantized

    rows = query(SQL + PORT_OPT).rows
    assert len(rows) == 12
    matched = sum(r[2] for r in rows)
    assert matched > first.slots_cap * compact.LANES
    # the tight run overflowed once, then ran at full capacity
    assert caps == [first.slots_cap, compact.full_slots_cap(seg.bucket)]
    assert _count(global_metrics, "compact_overflow_retries") == 1
    j0 = _count(j_metrics, DETECTED)
    assert jb.query(SQL + JAX_OPT).rows == rows

    second = SegmentPlanner(build_query_context(parse_sql(SQL + PORT_OPT)),
                            seg).plan()
    jsecond = JPlanner(j_ctx(j_parse(SQL + JAX_OPT)), jseg).plan()
    assert _count(global_metrics, DETECTED) == 1
    assert _count(global_metrics, REQUANT) == 1
    assert _count(j_metrics, DETECTED) == j0 + 1
    assert second.est_selectivity == jsecond.est_selectivity \
        == pytest.approx(matched / N)
    assert second.drift_requantized and jsecond.drift_requantized
    assert second.slots_cap * compact.LANES >= matched

    caps.clear()
    assert query(SQL + PORT_OPT).rows == rows
    assert caps == [second.slots_cap]        # one run, no overflow
    assert _count(global_metrics, "compact_overflow_retries") == 1
    assert jb.query(SQL + JAX_OPT).rows == rows


def test_known_overflow_skips_the_tight_run(segments, caps, monkeypatch):
    seg, query, _jseg, jb = segments
    # a drift factor no estimate reaches: the capacity is never
    # re-derived, so only the overflow memory can spare the tight run
    monkeypatch.setattr(costs, "_DRIFT_RATIO_DEFAULT", 1e9)
    plan = SegmentPlanner(build_query_context(parse_sql(SQL + PORT_OPT)),
                          seg).plan()
    full = compact.full_slots_cap(seg.bucket)
    rows = query(SQL + PORT_OPT).rows
    assert caps == [plan.slots_cap, full]
    assert global_plan_cache.overflowed(plan.kernel_plan, seg.bucket,
                                        plan.slots_cap)
    caps.clear()
    assert query(SQL + PORT_OPT).rows == rows
    assert caps == [full]
    assert _count(global_metrics, "compact_overflow_retries") == 1
    assert _count(global_metrics, DETECTED) == 0
    assert rows == jb.query(SQL + JAX_OPT).rows
