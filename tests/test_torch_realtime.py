"""Realtime ingestion in the port against the JAX package, on the CPU.

The same seeded rows go through ``pinot_tpu.realtime`` and
``pinot_tpu_torch.realtime`` (``device="cpu"``): the consuming segment's
snapshot (values, nulls, valid mask, growth past its first capacity,
``index`` row by row against the port's columnar ``index_batch``), sealed
directories byte-equal, consume / seal / checkpoint restart / the
time-threshold seal / the file-log stream through both brokers with
equal rows, background consumption over several partitions with a
``COUNT(*)`` that never falls, the freshness gauge's owner registry, a
hybrid table whose realtime half is consuming, and the stale-mask repair:
a compact group-by on the kernel path, documents of that sealed segment
invalidated, the same query again — the rows change exactly as the JAX
package's do.
"""
import filecmp
import json
import os
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the broker)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import pinot_tpu.broker as jbroker  # noqa: E402
import pinot_tpu.realtime as jrt  # noqa: E402
import pinot_tpu.realtime.filestream as jfs  # noqa: E402
import pinot_tpu.segment as jseg  # noqa: E402
import pinot_tpu.segment.mutable as jmut  # noqa: E402
import pinot_tpu.server as jserver  # noqa: E402
import pinot_tpu.spi as jspi  # noqa: E402
import pinot_tpu.upsert.metadata as jmeta  # noqa: E402
import pinot_tpu_torch.broker as tbroker  # noqa: E402
import pinot_tpu_torch.realtime as trt  # noqa: E402
import pinot_tpu_torch.realtime.filestream as tfs  # noqa: E402
import pinot_tpu_torch.segment as tseg  # noqa: E402
import pinot_tpu_torch.segment.mutable as tmut  # noqa: E402
import pinot_tpu_torch.server as tserver  # noqa: E402
import pinot_tpu_torch.spi as tspi  # noqa: E402
import pinot_tpu_torch.upsert.metadata as tmeta  # noqa: E402
from pinot_tpu_torch.ops import compact  # noqa: E402
from pinot_tpu_torch.realtime import manager as tmanager  # noqa: E402
from pinot_tpu_torch.utils.metrics import global_metrics  # noqa: E402
from test_torch_tier import reset_port_memory  # noqa: E402

OPT = " OPTION(timeoutMs=600000)"


def _pkg(name):
    """One package's realtime surface; the port's on the CPU."""
    if name == "jax":
        return SimpleNamespace(
            spi=jspi, fs=jfs, mut=jmut, seg=jseg, meta=jmeta,
            Stream=jrt.InMemoryStream, Config=jrt.StreamConfig,
            broker=lambda: jbroker.Broker(),
            manager=lambda *a, **k: jrt.RealtimeTableDataManager(*a, **k),
            table=lambda name: jserver.TableDataManager(name),
            load=lambda d: jseg.ImmutableSegment.load(d))
    return SimpleNamespace(
        spi=tspi, fs=tfs, mut=tmut, seg=tseg, meta=tmeta,
        Stream=trt.InMemoryStream, Config=trt.StreamConfig,
        broker=lambda: tbroker.Broker(device="cpu"),
        manager=lambda *a, **k: trt.RealtimeTableDataManager(
            *a, device="cpu", **k),
        table=lambda name: tserver.TableDataManager(name, device="cpu"),
        load=lambda d: tseg.ImmutableSegment.load(d, "cpu"))


PKGS = ("jax", "torch")


def _events_schema(ns):
    s = ns.spi
    return s.Schema("events", [
        s.FieldSpec("kind", s.DataType.STRING),
        s.FieldSpec("value", s.DataType.INT, s.FieldType.METRIC)])


def _rows(n, start=0):
    return [{"kind": "a" if i % 2 == 0 else "b", "value": i}
            for i in range(start, start + n)]


def _manager(ns, tmp, stream, threshold=100, **cfg):
    config = ns.Config("events", num_partitions=stream.num_partitions(),
                       flush_threshold_rows=threshold,
                       consumer_factory=stream, **cfg)
    return ns.manager("events", _events_schema(ns), config, str(tmp))


def _query(ns, dm, sqls):
    b = ns.broker()
    b.register_table(dm)
    return [[tuple(r) for r in b.query(sql + OPT).rows] for sql in sqls]


SQLS = ("SELECT COUNT(*), SUM(value) FROM events",
        "SELECT kind, COUNT(*), SUM(value) FROM events GROUP BY kind "
        "ORDER BY kind",
        "SELECT value FROM events WHERE value > 97 ORDER BY value LIMIT 5")


# ---------------------------------------------------------------------------
# the consuming segment
# ---------------------------------------------------------------------------

def _typed_schema(ns):
    s = ns.spi
    D, F = s.DataType, s.FieldType
    return s.Schema("typed", [
        s.FieldSpec("i", D.INT), s.FieldSpec("l", D.LONG, F.METRIC),
        s.FieldSpec("f", D.FLOAT, F.METRIC),
        s.FieldSpec("d", D.DOUBLE, F.METRIC),
        s.FieldSpec("b", D.BOOLEAN), s.FieldSpec("s", D.STRING),
        s.FieldSpec("tags", D.STRING, single_value=False)])


def _typed_rows(seed, n):
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(n):
        r = {"i": int(rng.integers(-1000, 1000)),
             "l": int(rng.integers(-2 ** 40, 2 ** 40)),
             "f": float(rng.normal()), "d": float(rng.normal()),
             "b": bool(rng.integers(0, 2)), "s": f"s{rng.integers(0, 9)}",
             "tags": [f"t{t}" for t in range(int(rng.integers(0, 3)))]}
        pick = rng.integers(0, 12)
        if pick < 7:                      # a null in one column
            r[list(r)[pick]] = None
        elif pick == 7:
            r["i"] = np.int16(rng.integers(0, 9))   # a numpy scalar
        elif pick == 8:
            r["i"] = "42"                 # a numeric string
        elif pick == 9:
            r["d"] = int(rng.integers(0, 9))        # an int in a double
        elif pick == 10:
            r["b"] = "true"
        else:
            del r["s"]                    # a missing key
        rows.append(r)
    return rows


def _snapshot(view, names):
    return ({c: (np.asarray(view.raw_values(c)).tolist(),
                 None if view.null_mask(c) is None
                 else view.null_mask(c).tolist()) for c in names},
            view.n_docs,
            None if view.valid_docs is None else view.valid_docs.tolist())


@pytest.mark.parametrize("n,batches", [(300, 1), (5000, 1), (5000, 7),
                                       (9000, 3)],
                         ids=["small", "past_capacity", "batches",
                              "two_doublings"])
def test_mutable_snapshot_matches_reference(n, batches):
    """The reference row by row, the port row by row and the port's
    columnar index_batch leave the same snapshot (arrays, nulls, valid
    mask), past the first capacity too; an invalidated doc shows in the
    valid mask of all three."""
    rows = _typed_rows(n, n)
    ref = jmut.MutableSegment(_typed_schema(_pkg("jax")), "m")
    for r in rows:
        ref.index(r)
    by_row = tmut.MutableSegment(_typed_schema(_pkg("torch")), "m")
    for r in rows:
        by_row.index(r)
    by_batch = tmut.MutableSegment(_typed_schema(_pkg("torch")), "m")
    for part in np.array_split(np.arange(n), batches):
        assert by_batch.index_batch([rows[i] for i in part]) == part[-1] + 1
    for m in (ref, by_row, by_batch):
        m.invalidate_doc(n // 3)
    names = [f.name for f in ref.schema.fields]
    want = _snapshot(ref.snapshot(), names)
    assert _snapshot(by_row.snapshot(), names) == want
    assert _snapshot(by_batch.snapshot(), names) == want
    assert by_batch.get_row(n - 1) == ref.get_row(n - 1)


def test_index_batch_refuses_what_index_refuses():
    """A value past the column's range raises in the batch path as in
    the row path (no silent wrap)."""
    schema = _typed_schema(_pkg("torch"))
    with pytest.raises(OverflowError):
        tmut.MutableSegment(schema, "m").index({"i": 2 ** 40})
    with pytest.raises(OverflowError):
        tmut.MutableSegment(schema, "m").index_batch([{"i": 1},
                                                      {"i": 2 ** 40}])


def _dir_files(d):
    return sorted(os.listdir(d))


@pytest.mark.parametrize("kind", ["typed_with_nulls", "strings"])
def test_sealed_directory_byte_equal(tmp_path, kind):
    """seal() of the same rows writes the same files in both packages;
    metadata equal but for its creation time. The port hands a string
    column without nulls to the builder as dictionary codes, one with
    nulls as strings."""
    dirs = []
    for name in PKGS:
        ns = _pkg(name)
        if kind == "strings":
            schema, rows = _events_schema(ns), [
                {"kind": f"k{(i * 7) % 13}", "value": i} for i in range(900)]
        else:
            schema, rows = _typed_schema(ns), _typed_rows(5, 700)
        m = ns.mut.MutableSegment(schema, "sealed")
        m.index_batch(rows)
        dirs.append(m.seal(str(tmp_path / name)))
    a, b = dirs
    assert _dir_files(a) == _dir_files(b)
    for f in _dir_files(a):
        if f == "metadata.json":
            ma, mb = (json.load(open(os.path.join(d, f))) for d in dirs)
            ma.pop("creationTimeMs"), mb.pop("creationTimeMs")
            assert ma == mb
        else:
            assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                               shallow=False), f


def test_seal_codes_keep_only_the_values_used():
    """Dictionary values of rows past the sealed ones stay out of the
    sealed segment's dictionary."""
    cat = tmut._categorical(np.array([2, 0, 2], np.int32),
                            ["a", "b", "c", "d"])
    assert cat.values == ["a", "c"] and cat.codes.tolist() == [1, 0, 1]


# ---------------------------------------------------------------------------
# consume, seal, restart: both packages, equal answers
# ---------------------------------------------------------------------------

def _scenario_consume(ns, tmp):
    stream = ns.Stream(1)
    stream.produce_many(_rows(250))
    dm = _manager(ns, tmp, stream, threshold=100)
    dm.consume_once(0)
    seg = sorted(dm.acquire_segments(), key=lambda s: s.name)[0]
    return ([dm.num_segments, dm.consuming_docs,
             seg.metadata["startOffset"], seg.metadata["endOffset"]]
            + _query(ns, dm, SQLS))


def _scenario_restart(ns, tmp):
    stream = ns.Stream(1)
    stream.produce_many(_rows(150))
    dm = _manager(ns, tmp, stream, threshold=100)
    dm.consume_once(0)
    dm2 = _manager(ns, tmp, stream, threshold=100)   # 'crash', restart
    n_restart = dm2.num_segments
    stream.produce_many(_rows(30, 150))
    dm2.consume_once(0)
    return [n_restart, dm2.consuming_docs] + _query(ns, dm2, SQLS)


def _scenario_time_threshold(ns, tmp):
    stream = ns.Stream(1)
    stream.produce_many(_rows(10))
    dm = _manager(ns, tmp, stream, threshold=10_000,
                  flush_threshold_seconds=0.0)
    dm.consume_once(0)
    dm._maybe_seal(0)
    return [dm.num_segments, dm.consuming_docs] + _query(ns, dm, SQLS[:1])


def _scenario_filelog(ns, tmp):
    """Exactly once across a restart over the file-log stream."""
    log_dir = str(tmp / "log")
    producer = ns.fs.FileLogProducer(log_dir, 1)
    producer.produce_many(_rows(150))
    data_dir = tmp / "data"

    def make():
        return _manager(ns, data_dir, ns.fs.FileLogStream(log_dir),
                        threshold=60)

    dm = make()
    dm.consume_once(0)
    first = dm.num_segments
    producer.produce_many(_rows(50, 150))
    producer.close()
    dm2 = make()
    dm2.consume_once(0)
    return [first, dm2.num_segments, dm2.consuming_docs] + _query(
        ns, dm2, SQLS)


@pytest.mark.parametrize("scenario", [_scenario_consume, _scenario_restart,
                                      _scenario_time_threshold,
                                      _scenario_filelog],
                         ids=["consume_seal", "restart", "time_threshold",
                              "filelog_restart"])
def test_realtime_matches_reference(tmp_path, scenario):
    got = [scenario(_pkg(name), tmp_path / name) for name in PKGS]
    assert got[1] == got[0]


def test_filelog_consumer_matches_reference(tmp_path):
    """Offsets, partial trailing lines and a seek past the end read the
    same from either package's consumer over one log."""
    log_dir = str(tmp_path / "log")
    p = tfs.FileLogProducer(log_dir, 2, partitioner=lambda r: r["value"])
    p.produce_many(_rows(20))
    p.close()
    with open(os.path.join(log_dir, "partition_0.log"), "ab") as fh:
        fh.write(b'{"kind": "a", "va')
    got = []
    for fs in (jfs, tfs):
        stream = fs.FileLogStream(log_dir)
        out = [stream.num_partitions()]
        for part in range(2):
            c = stream.create_consumer(part)
            b1, b2 = c.fetch(0, 4), c.fetch(4, 100)
            out += [c.latest_offset(), b1.next_offset, b2.next_offset,
                    b1.rows + b2.rows, c.fetch(50, 10).rows]
        got.append(out)
    assert got[1] == got[0]
    assert tfs.FileLogProducer(log_dir, 7).num_partitions == 2


def test_background_consumption_count_never_falls(tmp_path):
    """Four partitions consumed in the background while two threads
    query: COUNT(*) never falls (a seal swaps its consuming snapshot out
    in the same step that adds the sealed segment), and ends at the rows
    produced, equal to the JAX package's drain of the same stream."""
    n = 2000
    stream = trt.InMemoryStream(4, partitioner=lambda r: r["value"])
    dm = _manager(_pkg("torch"), tmp_path / "t", stream, threshold=97,
                  fetch_backoff_s=0.001)
    dm.poll_interval = 0.001
    b = tbroker.Broker(device="cpu")
    b.register_table(dm)
    seen = {0: [], 1: []}
    stop = threading.Event()

    def watch(k):
        while not stop.is_set():
            seen[k].append(b.query("SELECT COUNT(*) FROM events").rows[0][0])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    watchers = [threading.Thread(target=watch, args=(k,)) for k in seen]
    try:
        dm.start()
        for t in watchers:
            t.start()
        for lo in range(0, n, 100):
            stream.produce_many(_rows(100, lo))
            time.sleep(0.002)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and \
                b.query("SELECT COUNT(*) FROM events").rows[0][0] < n:
            time.sleep(0.01)
    finally:
        stop.set()
        for t in watchers:
            t.join(10)
        dm.stop()
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in watchers)
    for counts in seen.values():
        assert counts and all(a <= b2 for a, b2 in zip(counts, counts[1:]))
    assert dm.num_segments >= 4
    got = _query(_pkg("torch"), dm, SQLS)

    jstream = jrt.InMemoryStream(4, partitioner=lambda r: r["value"])
    jstream.produce_many(_rows(n))
    jdm = _manager(_pkg("jax"), tmp_path / "j", jstream, threshold=97)
    for part in range(4):
        jdm.consume_once(part)
    assert got == _query(_pkg("jax"), jdm, SQLS)
    assert got[0] == [(n, sum(range(n)))]


def test_freshness_owner_registry_guards_replicas():
    """The per-table freshness gauge is last-writer-wins across replicas
    under the module lock: a stopped replica never removes the gauge a
    live replica wrote last, and the owner's stop removes it."""
    def bare(table):
        m = object.__new__(trt.RealtimeTableDataManager)
        m.table_name = table
        m._stats_lock = threading.Lock()
        m._stats = {"rows": 0}
        m._freshness_ms = None
        m._ingest_t0 = None
        m._stop = threading.Event()
        m._threads = []
        return m

    class _Guarded(dict):
        def __setitem__(self, k, v):
            assert tmanager._FRESHNESS_LOCK.locked()
            dict.__setitem__(self, k, v)

        def get(self, k, *d):
            assert tmanager._FRESHNESS_LOCK.locked()
            return dict.get(self, k, *d)

        def pop(self, k, *d):
            assert tmanager._FRESHNESS_LOCK.locked()
            return dict.pop(self, k, *d)

    saved = tmanager._FRESHNESS_OWNERS
    tmanager._FRESHNESS_OWNERS = _Guarded()
    gname = "ingest_freshness_ms_t_owner_pin"
    try:
        a, b = bare("t_owner_pin"), bare("t_owner_pin")
        a._note_batch(1, time.monotonic())
        b._note_batch(1, time.monotonic())
        a.stop(timeout=0.1)
        assert gname in global_metrics.snapshot()["gauges"]
        b.stop(timeout=0.1)
        assert gname not in global_metrics.snapshot()["gauges"]
        assert gname not in tmanager._FRESHNESS_OWNERS
    finally:
        tmanager._FRESHNESS_OWNERS = saved


def test_manager_defaults_to_cuda_and_refuses_the_protocol(tmp_path):
    """No device means CUDA, which this machine lacks: the manager
    raises rather than run on the CPU. A completion client is taken (the
    controller-arbitrated commit, tests/test_torch_completion.py); the
    ingest ledger writes a record the JAX package's validator accepts."""
    from pinot_tpu.utils.ledger import validate_record
    ns = _pkg("torch")
    cfg = trt.StreamConfig("events", consumer_factory=trt.InMemoryStream(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        trt.RealtimeTableDataManager("events", _events_schema(ns), cfg,
                                     str(tmp_path / "a"))
    client = object()
    dm_b = trt.RealtimeTableDataManager("events", _events_schema(ns), cfg,
                                        str(tmp_path / "b"), device="cpu",
                                        completion_client=client)
    assert dm_b.completion_client is client
    dm = _manager(ns, tmp_path / "c", trt.InMemoryStream(1))
    rec = dm.write_ingest_stats(str(tmp_path / "ledger.jsonl"))
    assert validate_record(rec) == [] and rec["table"] == "events"
    with open(tmp_path / "ledger.jsonl") as fh:
        assert [json.loads(line) for line in fh] == [rec]


def test_reload_skips_consuming_snapshots(tmp_path):
    stream = trt.InMemoryStream(1)
    stream.produce_many(_rows(150))
    dm = _manager(_pkg("torch"), tmp_path, stream, threshold=100)
    dm.consume_once(0)
    assert len(dm.acquire_segments()) == 2
    assert dm.reload(tspi.TableConfig("events")) == {"added": [],
                                                     "removed": []}
    assert dm.schema.name == "events"


# ---------------------------------------------------------------------------
# a hybrid table with a consuming realtime half
# ---------------------------------------------------------------------------

HYBRID_SQLS = ("SELECT COUNT(*), SUM(value) FROM ev",
               "SELECT kind, COUNT(*), SUM(value) FROM ev WHERE value > 40 "
               "GROUP BY kind ORDER BY kind")


def _hybrid(ns, tmp):
    """ev_OFFLINE holds ts 0..79 in one segment, ev_REALTIME ts 60..149
    (one sealed segment, the rest consuming); the boundary is 79."""
    s = ns.spi
    schema = s.Schema("ev", [
        s.FieldSpec("kind", s.DataType.STRING),
        s.FieldSpec("value", s.DataType.INT, s.FieldType.METRIC),
        s.FieldSpec("ts", s.DataType.LONG, s.FieldType.DATE_TIME)])
    rows = [dict(r, ts=r["value"]) for r in _rows(150)]
    off_dir = ns.seg.SegmentBuilder(schema, s.TableConfig("ev_OFFLINE")
                                    ).build(rows[:80], str(tmp / "off"),
                                            "off_0")
    off = ns.table("ev_OFFLINE")
    off.table_config = s.TableConfig("ev_OFFLINE", time_column="ts")
    off.add_segment(ns.load(off_dir))
    stream = ns.Stream(1)
    stream.produce_many(rows[60:])
    cfg = ns.Config("ev", flush_threshold_rows=50, consumer_factory=stream)
    rt = ns.manager("ev_REALTIME", schema, cfg, str(tmp / "rt"))
    rt.consume_once(0)
    b = ns.broker()
    b.register_table(off)
    b.register_table(rt)
    return [rt.num_segments, rt.consuming_docs] + [
        [tuple(r) for r in b.query(sql + OPT).rows] for sql in HYBRID_SQLS]


def test_hybrid_with_consuming_half_matches_reference(tmp_path):
    got = [_hybrid(_pkg(name), tmp_path / name) for name in PKGS]
    assert got[1] == got[0]
    assert got[1][:2] == [1, 40]
    assert got[1][2] == [(150, sum(range(150)))]


# ---------------------------------------------------------------------------
# the stale-mask repair
# ---------------------------------------------------------------------------

def test_invalidation_after_upload_reaches_the_kernel_path(tmp_path,
                                                           monkeypatch):
    """A compact group-by on the kernel path uploads a sealed segment's
    valid mask; documents of that segment are then invalidated (the
    upsert path's _invalidate); the same query must answer from the new
    mask, as the JAX package does, and no stale mask stays resident."""
    monkeypatch.setenv("PINOT_CPU_FAST_GROUPBY", "1")
    reset_port_memory()
    n = 3000
    rng = np.random.default_rng(12)
    cols = {"k": rng.integers(0, 40, n).astype(np.int32),
            "v": rng.integers(0, 1000, n).astype(np.int32)}
    sql = ("SELECT k, COUNT(*), SUM(v) FROM t WHERE v > 100 GROUP BY k "
           "ORDER BY k LIMIT 1000 OPTION(groupByStrategy=compact,"
           "timeoutMs=600000)")
    got = {}
    launches = []
    real = compact.compact

    def counted(*a, **k):
        launches.append(1)
        return real(*a, **k)

    monkeypatch.setattr(compact, "compact", counted)
    for name in PKGS:
        ns = _pkg(name)
        s = ns.spi
        schema = s.Schema("t", [s.FieldSpec("k", s.DataType.INT),
                                s.FieldSpec("v", s.DataType.INT,
                                            s.FieldType.METRIC)])
        d = ns.seg.SegmentBuilder(schema, s.TableConfig("t")).build(
            cols, str(tmp_path / name), "s0")
        seg = ns.load(d)
        seg.set_valid_docs(np.arange(n) % 7 != 0)
        dm = ns.table("t")
        dm.add_segment(seg)
        b = ns.broker()
        b.register_table(dm)
        before = b.query(sql).rows
        for doc in range(1, n, 5):
            ns.meta._invalidate(seg, doc)
        after = b.query(sql).rows
        got[name] = (before, after, seg.valid_docs_version)
        if name == "torch":
            keys = [k for k in seg._device if k[0].startswith("__valid__")]
            assert keys == [(f"__valid__v{seg.valid_docs_version}",
                             seg.bucket)]
            assert not [k for k in seg._warm
                        if k[0].startswith("__valid__")]
            from pinot_tpu_torch.engine.tier import reconcile_devmem
            rec = reconcile_devmem([seg])
            assert rec["segment_cols"]["tracked"] == \
                rec["segment_cols"]["actual"]
            seg.evict_device()
    assert got["torch"] == got["jax"]
    assert got["torch"][0] != got["torch"][1]
    assert len(launches) >= 2          # the port's kernel path, both runs


def test_mask_made_during_set_valid_docs_is_not_cached(tmp_path,
                                                      monkeypatch):
    """A query misses the valid-mask cache, and set_valid_docs publishes
    a newer mask before the query caches its upload (the upsert path
    racing a reader): that upload answers the query once and stays out
    of the device cache, the warm stash and the device-memory registry;
    the next query caches the newer version's mask."""
    from pinot_tpu_torch.engine.tier import global_tier, reconcile_devmem
    from pinot_tpu_torch.segment import immutable

    reset_port_memory()
    global_tier.configure(budget_bytes=1 << 40)   # warm copies stashed
    n = 1000
    ns = _pkg("torch")
    s = ns.spi
    d = ns.seg.SegmentBuilder(
        s.Schema("t", [s.FieldSpec("k", s.DataType.INT)]),
        s.TableConfig("t")).build({"k": np.arange(n, dtype=np.int32)},
                                  str(tmp_path), "s0")
    seg = ns.load(d)
    seg.set_valid_docs(np.arange(n) % 2 == 0)
    newer = np.arange(n) % 3 == 0
    real = immutable._upload

    def racing(host, device):
        if seg.valid_docs is not newer:
            seg.set_valid_docs(newer)
        return real(host, device)

    monkeypatch.setattr(immutable, "_upload", racing)
    try:
        seg.device_valid_mask()
        assert not [k for k in seg._device if k[0].startswith("__valid__")]
        assert not [k for k in seg._warm if k[0].startswith("__valid__")]
        rec = reconcile_devmem([seg])
        assert rec["segment_cols"]["tracked"] == \
            rec["segment_cols"]["actual"]
        again = seg.device_valid_mask()
        assert [k for k in seg._device if k[0].startswith("__valid__")] \
            == [(f"__valid__v{seg.valid_docs_version}", seg.bucket)]
        assert again[:n].numpy().tolist() == newer.tolist()
    finally:
        reset_port_memory([seg])
