"""Query accounting, deadlines and the micro-batch admission window of the
port, on the CPU.

The port's accountant (``engine/accounting.py``) must raise at a sample
point once a query was killed or is past its deadline, as the JAX
package's does; the broker must register every query for its execution
only, name it from ``OPTION(queryId=...)``, count its deadline
(``OPTION(timeoutMs=...)``) from the end of planning and turn a deadline
kill into ``QueryTimeoutError``, as the JAX broker does for the same
query; and ``MicroBatchQueue`` must hand a window's items to its leader,
return at once for a follower and hold its weight budget as a hard bound.
"""
import threading
import time

import numpy as np
import pytest

from pinot_tpu.broker import Broker as JaxBroker
from pinot_tpu.broker.broker import QueryTimeoutError as JaxTimeout
from pinot_tpu.engine.accounting import (ResourceAccountant as
                                         JaxAccountant)
from pinot_tpu.server import TableDataManager as JaxTable
from pinot_tpu_torch.broker import (DEFAULT_TIMEOUT_MS, Broker,
                                    QueryTimeoutError)
from pinot_tpu_torch.broker import broker as broker_mod
from pinot_tpu_torch.engine.accounting import (HeapWatcher,
                                               QueryKilledError,
                                               ResourceAccountant,
                                               global_accountant)
from pinot_tpu_torch.engine.scheduler import MicroBatchQueue
from pinot_tpu_torch.segment import SegmentBuilder
from pinot_tpu_torch.server import TableDataManager
from pinot_tpu_torch.spi import (DataType, FieldSpec, FieldType, Schema,
                                 TableConfig)
from pinot_tpu_torch.utils.metrics import global_metrics

SQL = "SELECT k, SUM(v) FROM t WHERE v > 3 GROUP BY k ORDER BY k"


@pytest.fixture(scope="module")
def seg_dir(tmp_path_factory):
    rng = np.random.default_rng(5)
    n = 4000
    cols = {"k": rng.choice(["a", "b", "c"], n),
            "v": rng.integers(0, 50, n).astype(np.int32)}
    schema = Schema("t", [FieldSpec("k", DataType.STRING),
                          FieldSpec("v", DataType.INT, FieldType.METRIC)])
    return SegmentBuilder(schema, TableConfig("t")).build(
        cols, str(tmp_path_factory.mktemp("acct")), "s0")


@pytest.fixture(scope="module")
def brokers(seg_dir):
    dm = TableDataManager("t", device="cpu")
    dm.add_segment_dir(seg_dir)
    b = Broker(device="cpu")
    b.register_table(dm)
    jdm = JaxTable("t")
    jdm.add_segment_dir(seg_dir)
    jb = JaxBroker()
    jb.register_table(jdm)
    return b, jb


def _counter(name):
    return global_metrics.snapshot()["counters"].get(name, 0)


@pytest.mark.parametrize("make", [ResourceAccountant, JaxAccountant],
                         ids=["port", "jax"])
def test_kill_and_deadline_raise_at_sample(make):
    acct = make()
    acct.sample()                        # no query on this thread: no-op
    acct.register("q1", deadline=time.perf_counter() + 60)
    acct.sample()
    assert acct.current_query_id() == "q1"
    assert acct.kill("q1", "operator")
    with pytest.raises(Exception, match="killed: operator") as e:
        acct.sample()
    assert not e.value.is_deadline
    acct.unregister("q1")
    acct.register("q2", deadline=time.perf_counter() - 1e-3)
    with pytest.raises(Exception, match="deadline exceeded") as e:
        acct.sample()
    assert e.value.is_deadline
    acct.set_deadline("q2", None)
    acct.sample()
    acct.unregister("q2")
    assert acct.running() == [] and acct.current_query_id() is None
    assert not acct.kill("q2", "gone")


def test_usage_counters_and_the_heap_watcher():
    acct = ResourceAccountant()
    u = acct.register("a")
    acct.track_result({"x": np.zeros(10, np.int64),
                       "y": np.zeros(3, np.int32)})
    assert u.mem_bytes == 92
    acct.register("b")                   # this thread now runs b
    acct.track_memory_for("a", 8)
    acct.note_batched("a", 4)
    acct.note_batched("a", 2)
    assert (u.mem_bytes, u.batched_dispatches, u.max_batch_size) == \
        (100, 2, 4)
    assert sorted(x.query_id for x in acct.running()) == ["a", "b"]
    watcher = HeapWatcher(acct, rss_limit_bytes=1)   # always over
    assert watcher.check_once() == "a"   # the most memory
    assert watcher.kills == 1
    assert acct.kill_most_expensive("again") == "b"
    assert acct.kill_most_expensive("none left") is None
    unreg = acct.unregister("a")
    assert unreg is u and acct.usage("a") is None


def test_attach_thread_accounts_a_worker_to_the_query():
    acct = ResourceAccountant()
    acct.register("q")
    acct.kill("q", "stop")
    seen = []

    def worker():
        acct.sample()                    # unattached: no-op
        acct.attach_thread("q")
        try:
            acct.sample()
        except QueryKilledError as e:
            seen.append(str(e))

    t = threading.Thread(target=worker)
    t.start()
    t.join(10)
    assert seen == ["query q killed: stop"]
    acct.unregister("q")
    assert acct.running() == []


def test_broker_registers_each_query_for_its_execution(brokers,
                                                       monkeypatch):
    b, _jb = brokers
    seen = []
    plan = broker_mod.plan_segments

    def spy(ctx, segments):
        u = global_accountant.usage(global_accountant.current_query_id())
        seen.append((u.query_id, u.deadline - u.start))
        return plan(ctx, segments)

    monkeypatch.setattr(broker_mod, "plan_segments", spy)
    b.query(SQL + " OPTION(queryId=mine, timeoutMs=2500)")
    b.query(SQL)
    assert seen[0][0] == "mine" and seen[1][0] != "mine"
    assert seen[0][1] == pytest.approx(2.5, abs=0.05)
    assert seen[1][1] == pytest.approx(DEFAULT_TIMEOUT_MS / 1e3, abs=0.05)
    assert global_accountant.running() == []
    with pytest.raises(Exception, match="not found"):
        b.query("SELECT COUNT(*) FROM missing")
    assert global_accountant.running() == []


def test_timeout_raises_query_timeout_error_like_the_jax_broker(brokers):
    b, jb = brokers
    sql = SQL + " OPTION(timeoutMs=0)"
    before = _counter("broker_query_timeouts")
    with pytest.raises(QueryTimeoutError, match="deadline exceeded"):
        b.query(sql)
    with pytest.raises(JaxTimeout):
        jb.query(sql)
    assert _counter("broker_query_timeouts") == before + 1
    assert global_accountant.running() == []
    # the budget excludes planning: a generous one answers as the JAX
    # broker does
    ok = SQL + " OPTION(timeoutMs=600000)"
    assert b.query(ok).rows == jb.query(ok).rows


def test_deadline_passed_during_execution_is_a_timeout(brokers,
                                                       monkeypatch):
    b, _jb = brokers
    run = broker_mod.execute_planned

    def slow(ex):
        out = run(ex)
        time.sleep(0.05)                 # past the 10 ms budget
        return out

    monkeypatch.setattr(broker_mod, "execute_planned", slow)
    with pytest.raises(QueryTimeoutError, match="timed out"):
        b.query(SQL + " OPTION(timeoutMs=10)")


def test_a_killed_query_raises_its_kill(brokers, monkeypatch):
    b, _jb = brokers
    plan = broker_mod.plan_segments

    def kill_after_planning(ctx, segments):
        out = plan(ctx, segments)
        global_accountant.kill(global_accountant.current_query_id(), "ops")
        return out

    monkeypatch.setattr(broker_mod, "plan_segments", kill_after_planning)
    before = _counter("queries_killed")
    with pytest.raises(QueryKilledError, match="killed: ops") as e:
        b.query(SQL)
    assert not isinstance(e.value, QueryTimeoutError)
    assert _counter("queries_killed") == before + 1
    assert global_accountant.running() == []


def test_micro_batch_queue_leader_and_follower():
    q = MicroBatchQueue()
    got = {}

    def leader():
        got["batch"] = q.offer("k", "L", window_s=1.0, max_items=2)

    t = threading.Thread(target=leader)
    t.start()
    time.sleep(0.05)
    t0 = time.perf_counter()
    assert q.offer("k", "F", window_s=1.0, max_items=2) is None
    assert time.perf_counter() - t0 < 0.5   # a follower never blocks
    t.join(5)
    assert sorted(got["batch"]) == ["F", "L"]   # closed at max_items,
    assert q.depth() == 0                       # well before the window

    # a lone leader returns its own item when the window expires
    t0 = time.perf_counter()
    assert q.offer("solo", "S", window_s=0.05, max_items=4) == ["S"]
    assert 0.04 < time.perf_counter() - t0 < 1.0

    # the weight budget is a hard bound: an item that would exceed it
    # closes the bucket for its leader and leads a fresh one
    def leader_w():
        got["wbatch"] = q.offer("w", "L", window_s=2.0, max_items=8,
                                max_weight=10, weight=6)

    t = threading.Thread(target=leader_w)
    t.start()
    time.sleep(0.05)
    big = q.offer("w", "B", window_s=0.05, max_items=8, max_weight=10,
                  weight=6)
    t.join(5)
    assert got["wbatch"] == ["L"]
    assert big == ["B"]
    assert q.depth() == 0
