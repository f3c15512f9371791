"""The wire-protocol stream plugins in the port against the JAX package.

``pinot_tpu_torch.realtime.{kafka,pulsar,kinesis,wirestream}`` and
``fs/{rest,s3}`` on the CPU: CRC32C from the port's native library equal
to the reference's table loop; Kafka record batches, Pulsar frames and
SigV4 headers byte-equal to the reference's at a fixed clock; each
package's consumers reading the other package's fake brokers with equal
rows and offsets; a realtime table fed by each plugin writing the
reference's checkpoints and sealed files and answering the same rows,
also after a restart; the plugin resolver mapping a reference class
path to the port's without importing the JAX package. Then the cases of
the reference's ``tests/test_{kafka,pulsar,kinesis,wirestream}.py`` on
the port's modules.
"""
import json
import os
import struct
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the broker)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import pinot_tpu.broker as jbroker  # noqa: E402
import pinot_tpu.fs.s3 as js3  # noqa: E402
import pinot_tpu.realtime as jrt  # noqa: E402
import pinot_tpu.realtime.kafka as jkafka  # noqa: E402
import pinot_tpu.realtime.kinesis as jkinesis  # noqa: E402
import pinot_tpu.realtime.pulsar as jpulsar  # noqa: E402
import pinot_tpu.realtime.wirestream as jwire  # noqa: E402
import pinot_tpu.spi as jspi  # noqa: E402
import pinot_tpu_torch.broker as tbroker  # noqa: E402
import pinot_tpu_torch.fs.s3 as ts3  # noqa: E402
import pinot_tpu_torch.realtime as trt  # noqa: E402
import pinot_tpu_torch.realtime.kafka as tkafka  # noqa: E402
import pinot_tpu_torch.realtime.kinesis as tkinesis  # noqa: E402
import pinot_tpu_torch.realtime.pulsar as tpulsar  # noqa: E402
import pinot_tpu_torch.realtime.wirestream as twire  # noqa: E402
import pinot_tpu_torch.spi as tspi  # noqa: E402
from pinot_tpu_torch import native  # noqa: E402
from pinot_tpu_torch.realtime.stream import decode_json_values  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "torch")
PLUGINS = ("kafka", "pulsar", "kinesis", "wire")


def _pkg(name):
    if name == "jax":
        return SimpleNamespace(
            kafka=jkafka, pulsar=jpulsar, kinesis=jkinesis, wire=jwire,
            spi=jspi, rt=jrt, broker=lambda: jbroker.Broker(),
            manager=lambda *a, **k: jrt.RealtimeTableDataManager(*a, **k))
    return SimpleNamespace(
        kafka=tkafka, pulsar=tpulsar, kinesis=tkinesis, wire=twire,
        spi=tspi, rt=trt, broker=lambda: tbroker.Broker(device="cpu"),
        manager=lambda *a, **k: trt.RealtimeTableDataManager(
            *a, device="cpu", **k))


# ---------------------------------------------------------------------------
# CRC32C: the native library against the reference's loop
# ---------------------------------------------------------------------------

def test_crc32c_check_value_and_empty():
    # RFC 3720's check value for "123456789"
    for f in (native.crc32c, native.crc32c_plain, tkafka.crc32c,
              jkafka.crc32c):
        assert f(b"123456789") == 0xE3069283
        assert f(b"") == 0


@pytest.mark.parametrize("seed", range(4))
def test_crc32c_native_equals_plain_on_random_buffers(seed):
    rng = np.random.default_rng(seed)
    sizes = [0, 1, 7, 8, 9, 15, 16, 17, 63, 64, 65, 4095, 70_000]
    sizes += rng.integers(0, 70_001, 6).tolist()
    for n in sizes:
        buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = jkafka.crc32c(buf) if n <= 4096 else native.crc32c_plain(buf)
        assert native.crc32c_plain(buf) == want
        assert native.crc32c(buf) == want, n
        assert native.crc32c(buf, route="tables") == want, n
        # an unaligned start: the slicing-by-8 head loop
        assert native.crc32c(memoryview(buf)[3:]) == \
            native.crc32c_plain(buf[3:])
    assert native.crc32c_route() in ("sse42", "tables")


# ---------------------------------------------------------------------------
# bytes on the wire equal the reference's
# ---------------------------------------------------------------------------

def _records(rng, n):
    out = []
    for _ in range(n):
        key = None if rng.random() < 0.5 else \
            rng.integers(0, 256, int(rng.integers(0, 40)),
                         dtype=np.uint8).tobytes()
        value = rng.integers(0, 256, int(rng.integers(0, 3000)),
                             dtype=np.uint8).tobytes()
        out.append((key, value))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_record_batch_bytes_equal_reference(seed):
    rng = np.random.default_rng(seed)
    recs = _records(rng, int(rng.integers(1, 300)))
    base, ts = int(rng.integers(0, 1 << 40)), int(rng.integers(0, 1 << 41))
    batch = tkafka.encode_record_batch(base, recs, ts)
    assert batch == jkafka.encode_record_batch(base, recs, ts)
    other = jkafka.encode_record_batch(base + len(recs), recs[:5], ts)
    # two batches and a partial trailing one, as a fetch may return
    data = batch + other + other[:30]
    assert tkafka.decode_record_batches(data) == \
        jkafka.decode_record_batches(data)
    corrupt = bytearray(batch)
    corrupt[-1] ^= 0xFF
    for mod in (tkafka, jkafka):
        with pytest.raises(mod.KafkaError, match="CRC32C"):
            mod.decode_record_batches(bytes(corrupt))


@pytest.mark.parametrize("v", [0, 1, -1, 63, -64, 64, 300, -301,
                               (1 << 31) - 1, -(1 << 31), (1 << 40)])
def test_varint_zigzag_matches_reference(v):
    enc = tkafka._varint(v)
    assert enc == jkafka._varint(v) == tkafka._varint_of(v)
    assert tkafka._varint_at(enc, 0, len(enc)) == (v, len(enc))
    assert jkafka._Reader(enc).varint() == v


def test_pulsar_frames_bytes_equal_reference():
    rng = np.random.default_rng(4)
    cmd = (tpulsar._pb_field(1, tpulsar.MESSAGE)
           + tpulsar._pb_bytes(11, tpulsar._pb_field(1, 3)
                               + tpulsar._pb_bytes(
                                   2, tpulsar._encode_message_id(11, 4))))
    assert cmd == (jpulsar._pb_field(1, jpulsar.MESSAGE)
                   + jpulsar._pb_bytes(11, jpulsar._pb_field(1, 3)
                                       + jpulsar._pb_bytes(
                                           2, jpulsar._encode_message_id(
                                               11, 4))))
    md = tpulsar._pb_str(1, "p") + tpulsar._pb_field(2, 1)
    for payload in (b"", b'{"a": 1}',
                    rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()):
        for meta in (None, md):
            frame = tpulsar.encode_frame(cmd, meta, payload)
            assert frame == jpulsar.encode_frame(cmd, meta, payload)
            assert tpulsar.decode_frame(frame[4:]) == \
                jpulsar.decode_frame(frame[4:])
    assert tpulsar.pb_decode(cmd) == jpulsar.pb_decode(cmd)
    off = tpulsar.pack_offset(37, 123)
    assert off == jpulsar.pack_offset(37, 123)
    assert tpulsar.unpack_offset(off) == (37, 123)
    corrupt = bytearray(tpulsar.encode_frame(cmd, md, b"payload")[4:])
    corrupt[-1] ^= 0xFF
    with pytest.raises(tpulsar.PulsarError, match="CRC32C"):
        tpulsar.decode_frame(bytes(corrupt))


@pytest.mark.parametrize("service,query", [
    ("s3", {"list-type": "2", "prefix": "a b/c"}),
    ("kinesis", {})])
def test_sigv4_headers_equal_reference_at_a_fixed_clock(service, query):
    body = b'{"StreamName": "events"}'
    import hashlib
    args = ("POST", "127.0.0.1:4567", "/bucket/key with space", query,
            {"content-type": "application/x-amz-json-1.1",
             "x-amz-target": "Kinesis_20131202.ListShards"},
            hashlib.sha256(body).hexdigest(), "AK", "SK", "us-east-1",
            "20260102T030405Z")
    got = ts3.sigv4_headers(*args, service=service)
    assert got == js3.sigv4_headers(*args, service=service)
    assert got["Authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AK/20260102/us-east-1/")


def test_json_values_decode_in_one_call_as_one_by_one():
    rows = [{"a": 1, "s": "x\"y", "f": 1.5e-9, "n": None, "l": [1, 2]},
            {"b": "é"}, {}]
    vals = [json.dumps(r).encode() for r in rows]
    assert decode_json_values(vals) == [json.loads(v) for v in vals]
    assert decode_json_values([]) == []


# ---------------------------------------------------------------------------
# the fake brokers of either package serve either package's clients
# ---------------------------------------------------------------------------

class _Plugin:
    """One plugin's fake broker from one package, its producer, and a
    consumer factory from any package."""

    def __init__(self, plugin, ns, tmp, parts=2):
        self.plugin, self.ns = plugin, ns
        if plugin == "kafka":
            self.broker = ns.kafka.FakeKafkaBroker({"events": parts})
        elif plugin == "pulsar":
            self.broker = ns.pulsar.FakePulsarBroker(
                [f"events-partition-{i}" for i in range(parts)],
                ledger_entries=5)
        elif plugin == "kinesis":
            self.broker = ns.kinesis.FakeKinesisServer(
                {"events": parts}, access_key="AK", secret_key="SK")
        else:
            self.broker = ns.wire.WireBroker(num_partitions=parts,
                                             log_dir=str(tmp / "wal"))
        self.parts = parts

    def produce(self, partition, rows):
        ns, b = self.ns, self.broker
        if self.plugin == "kafka":
            p = ns.kafka.KafkaProducer("127.0.0.1", b.port)
            p.produce_many("events", partition, rows)
        elif self.plugin == "pulsar":
            p = ns.pulsar.PulsarProducer("127.0.0.1", b.port)
            p.send_many(f"events-partition-{partition}", rows)
        elif self.plugin == "kinesis":
            b.put("events", partition, rows)
            return
        else:
            p = ns.wire.WireProducer("127.0.0.1", b.port)
            p.produce_many(rows, partition=partition)
        p.close()

    def factory(self, ns):
        b = self.broker
        if self.plugin == "kafka":
            return ns.kafka.KafkaStream("events", port=b.port)
        if self.plugin == "pulsar":
            return ns.pulsar.PulsarStream("events", port=b.port,
                                          partitions=self.parts)
        if self.plugin == "kinesis":
            return ns.kinesis.KinesisStream(
                "events", b.endpoint_url, access_key="AK", secret_key="SK")
        return ns.wire.WireStream("127.0.0.1", b.port)

    def stop(self):
        self.broker.stop()


def _rows(seed, n, start=0):
    rng = np.random.default_rng(seed)
    return [{"k": str(rng.choice(["a", "b", "c"])), "v": int(v),
             "i": start + i}
            for i, v in enumerate(rng.integers(0, 1000, n))]


def _read_all(factory, parts):
    """Every partition read in a short and a long fetch, then one past
    the end: rows, next offsets and per-row offsets."""
    out = []
    for p in range(parts):
        c = factory.create_consumer(p)
        try:
            b1 = c.fetch(0, 7)
            b2 = c.fetch(b1.next_offset, 1000)
            b3 = c.fetch(b2.next_offset, 1000)
            out.append([(b.rows, b.next_offset, b.row_offsets)
                        for b in (b1, b2, b3)])
        finally:
            c.close()
    return out


@pytest.mark.parametrize("plugin", PLUGINS)
def test_each_package_reads_the_others_broker(tmp_path, plugin):
    got = {}
    for bname in PKGS:
        fx = _Plugin(plugin, _pkg(bname), tmp_path / bname)
        try:
            fx.produce(0, _rows(1, 23))
            fx.produce(1, _rows(2, 11, 23))
            fx.produce(0, _rows(3, 4, 34))
            for cname in PKGS:
                f = fx.factory(_pkg(cname))
                assert f.num_partitions() == 2
                got[(bname, cname)] = _read_all(f, 2)
        finally:
            fx.stop()
    want = got[("jax", "jax")]
    assert [r["i"] for r in want[0][0][0] + want[0][1][0]] == \
        list(range(23)) + list(range(34, 38))
    for key, value in got.items():
        assert value == want, key


# ---------------------------------------------------------------------------
# a realtime table fed by each plugin: the reference's files and rows
# ---------------------------------------------------------------------------

def _schema(ns):
    s = ns.spi
    return s.Schema("events", [
        s.FieldSpec("k", s.DataType.STRING),
        s.FieldSpec("v", s.DataType.INT, s.FieldType.METRIC),
        s.FieldSpec("i", s.DataType.LONG, s.FieldType.METRIC)])


SQLS = ("SELECT COUNT(*), SUM(v), SUM(i) FROM events",
        "SELECT k, COUNT(*), SUM(v) FROM events GROUP BY k ORDER BY k",
        "SELECT i, v FROM events WHERE v > 500 ORDER BY i LIMIT 7")


def _table_files(data_dir):
    """{relative path: bytes} of the sealed segments and the checkpoint
    (metadata.json without its creation time)."""
    out = {}
    for root, _dirs, files in os.walk(data_dir):
        for f in files:
            path = os.path.join(root, f)
            rel = os.path.relpath(path, data_dir)
            if f == "metadata.json":
                md = json.load(open(path))
                md.pop("creationTimeMs", None)
                out[rel] = md
            elif f == "state.json":
                out[rel] = json.load(open(path))
            else:
                out[rel] = open(path, "rb").read()
    return out


def _feed(plugin, name, tmp):
    ns = _pkg(name)
    fx = _Plugin(plugin, ns, tmp)
    try:
        fx.produce(0, _rows(5, 40))
        fx.produce(1, _rows(6, 25, 40))

        def manager():
            cfg = ns.rt.StreamConfig("events", num_partitions=2,
                                     flush_threshold_rows=15,
                                     consumer_factory=fx.factory(ns))
            return ns.manager("events", _schema(ns), cfg,
                              str(tmp / "data"))

        dm = manager()
        dm.consume_once(0)
        dm.consume_once(1)
        b = ns.broker()
        b.register_table(dm)
        first = [[tuple(r) for r in b.query(s).rows] for s in SQLS]
        snap = [(dm.num_segments, dm.consuming_docs)]
        # 'crash' with consuming tails, restart on the same directory,
        # and consume what arrived meanwhile
        fx.produce(0, _rows(7, 9, 65))
        dm2 = manager()
        snap.append((dm2.num_segments, dm2.consuming_docs))
        dm2.consume_once(0)
        dm2.consume_once(1)
        b2 = ns.broker()
        b2.register_table(dm2)
        after = [[tuple(r) for r in b2.query(s).rows] for s in SQLS]
        snap.append((dm2.num_segments, dm2.consuming_docs))
        return first, after, snap, _table_files(str(tmp / "data"))
    finally:
        fx.stop()


@pytest.mark.parametrize("plugin", PLUGINS)
def test_realtime_table_over_each_plugin_matches_reference(tmp_path,
                                                           plugin):
    (f0, a0, s0, files0), (f1, a1, s1, files1) = [
        _feed(plugin, name, tmp_path / name) for name in PKGS]
    assert f1 == f0 and a1 == a0 and s1 == s0
    assert a0[0][0] == (74, sum(r["v"] for r in _rows(5, 40))
                        + sum(r["v"] for r in _rows(6, 25, 40))
                        + sum(r["v"] for r in _rows(7, 9, 65)),
                        sum(range(74)))
    assert sorted(files1) == sorted(files0)
    assert any(f.endswith(".fwd.bin") for f in files0), sorted(files0)
    for rel, content in files0.items():
        assert files1[rel] == content, rel


# ---------------------------------------------------------------------------
# the plugin resolver never imports the JAX package
# ---------------------------------------------------------------------------

def test_reference_class_paths_resolve_to_the_port_without_jax():
    code = """
import sys
from pinot_tpu_torch.spi.plugin import resolve_class
a = resolve_class("pinot_tpu.realtime.kafka.KafkaStream")
b = resolve_class("pinot_tpu.realtime.filestream.FileLogStream")
assert a.__module__ == "pinot_tpu_torch.realtime.kafka", a.__module__
assert b.__module__ == "pinot_tpu_torch.realtime.filestream"
c = resolve_class("pinot_tpu.cluster.broker_node.BrokerNode")
assert c.__module__ == "pinot_tpu_torch.cluster.broker_node"
d = resolve_class("pinot_tpu.cluster.rebalancer.ClosedLoopRebalanceTask")
assert d.__module__ == "pinot_tpu_torch.cluster.rebalancer"
g = resolve_class("pinot_tpu.cluster.grpc_plane.start_grpc")
assert g.__module__ == "pinot_tpu_torch.cluster.grpc_plane", g.__module__
try:
    resolve_class("pinot_tpu.utils.compileplane.CompileLog")
except KeyError as e:
    assert "pinot_tpu_torch.utils.compileplane" in str(e), e
else:
    raise AssertionError("resolved a module the port lacks")
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
             or k == "pinot_tpu" or k.startswith("pinot_tpu."))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_reference_config_feeds_a_port_table(tmp_path):
    """A StreamConfig written for the reference (its class path) builds
    the port's consumer."""
    b = tkafka.FakeKafkaBroker({"events": 2})
    try:
        b.append("events", 0, [{"k": "z", "v": 1, "i": 0},
                               {"k": "z", "v": 2, "i": 1}])
        cfg = trt.StreamConfig(
            "events", num_partitions=2,
            consumer_factory_class="pinot_tpu.realtime.kafka.KafkaStream",
            consumer_factory_args={"topic": "events", "port": b.port})
        dm = trt.RealtimeTableDataManager("events", _schema(_pkg("torch")),
                                          cfg, str(tmp_path / "t"),
                                          device="cpu")
        assert type(cfg.make_consumer_factory()) is tkafka.KafkaStream
        dm.consume_once(0)
        br = tbroker.Broker(device="cpu")
        br.register_table(dm)
        assert br.query("SELECT SUM(v) FROM events").rows[0][0] == 3
    finally:
        b.stop()


# ---------------------------------------------------------------------------
# the reference's protocol cases on the port's modules
# ---------------------------------------------------------------------------

@pytest.fixture
def kafka():
    broker = tkafka.FakeKafkaBroker({"events": 2})
    yield broker
    broker.stop()


def test_kafka_metadata(kafka):
    assert tkafka.KafkaStream("events", port=kafka.port).num_partitions() \
        == 2
    with pytest.raises(tkafka.KafkaError, match="metadata error 3"):
        tkafka.KafkaStream("missing", port=kafka.port).num_partitions()


def test_kafka_produce_fetch_listoffsets_roundtrip(kafka):
    prod = tkafka.KafkaProducer("127.0.0.1", kafka.port)
    assert prod.produce_many("events", 0,
                             [{"a": 1}, {"a": 2}, {"a": 3}]) == 0
    assert prod.produce_many("events", 0, [{"a": 4}]) == 3
    prod.produce_many("events", 1, [{"b": 9}])
    c0 = tkafka.KafkaPartitionConsumer("events", "127.0.0.1", kafka.port,
                                       0, 5.0)
    batch = c0.fetch(0, 10)
    assert [r["a"] for r in batch.rows] == [1, 2, 3, 4]
    assert batch.next_offset == 4 and c0.latest_offset() == 4
    assert [r["a"] for r in c0.fetch(2, 1).rows] == [3]
    c1 = tkafka.KafkaPartitionConsumer("events", "127.0.0.1", kafka.port,
                                       1, 5.0)
    assert c1.fetch(0, 10).rows == [{"b": 9}]
    for c in (c0, c1, prod):
        c.close()


def test_kafka_fetch_errors_and_bounds(kafka):
    kafka.append("events", 0, [{"i": i} for i in range(50)])
    c = tkafka.KafkaPartitionConsumer("events", "127.0.0.1", kafka.port, 0,
                                      5.0)
    with pytest.raises(tkafka.KafkaOffsetOutOfRange, match="out of range"):
        c.fetch(99, 10)
    batch = c.fetch(0, 7)
    assert [r["i"] for r in batch.rows] == list(range(7))
    assert batch.next_offset == 7
    assert [r["i"] for r in c.fetch(7, 100).rows] == list(range(7, 50))
    empty = tkafka.KafkaPartitionConsumer("events", "127.0.0.1",
                                          kafka.port, 1, 5.0)
    b = empty.fetch(0, 10)
    assert b.rows == [] and b.next_offset == 0
    bad = tkafka.KafkaPartitionConsumer("events", "127.0.0.1", kafka.port,
                                        7, 5.0)
    with pytest.raises(tkafka.KafkaError):
        bad.fetch(0, 10)
    for x in (c, empty, bad):
        x.close()


def test_kafka_value_decoder_is_used(kafka):
    kafka.append("events", 0, [{"a": 1}, {"a": 2}])
    c = tkafka.KafkaPartitionConsumer(
        "events", "127.0.0.1", kafka.port, 0, 5.0,
        value_decoder=lambda v: {"raw": v.decode()})
    assert c.fetch(0, 10).rows == [{"raw": '{"a": 1}'}, {"raw": '{"a": 2}'}]
    c.close()


@pytest.fixture
def pulsar():
    broker = tpulsar.FakePulsarBroker(
        [f"events-partition-{i}" for i in range(2)], ledger_entries=5)
    yield broker
    broker.stop()


def test_pulsar_ledger_rollover_and_resume(pulsar):
    prod = tpulsar.PulsarProducer("127.0.0.1", pulsar.port)
    offs = prod.send_many("events-partition-0",
                          [{"i": i} for i in range(12)])
    assert len({tpulsar.unpack_offset(o)[0] for o in offs}) >= 3
    c = tpulsar.PulsarStream("events", port=pulsar.port,
                             partitions=2).create_consumer(0)
    batch = c.fetch(0, 100)
    assert [r["i"] for r in batch.rows] == list(range(12))
    assert batch.row_offsets == offs
    assert batch.next_offset == offs[-1] + 1
    assert [r["i"] for r in c.fetch(offs[6] + 1, 100).rows] == \
        list(range(7, 12))
    c.close()
    prod.close()


def test_pulsar_send_many_windows_exchange_one_send_at_a_time(monkeypatch):
    """Windowed SEND frames get the receipts one-at-a-time sends get."""
    monkeypatch.setattr(tpulsar.PulsarProducer, "SEND_WINDOW", 4)
    rows = [{"i": i} for i in range(11)]
    got = []
    for windowed in (True, False):
        broker = tpulsar.FakePulsarBroker(["t-partition-0"],
                                          ledger_entries=5)
        prod = tpulsar.PulsarProducer("127.0.0.1", broker.port)
        try:
            got.append(prod.send_many("t-partition-0", rows) if windowed
                       else [prod.send("t-partition-0", r) for r in rows])
        finally:
            prod.close()
            broker.stop()
    assert got[0] == got[1] and len(set(got[0])) == len(rows)


def test_pulsar_latest_empty_unknown_and_permits(pulsar):
    stream = tpulsar.PulsarStream("events", port=pulsar.port, partitions=2)
    c = stream.create_consumer(0)
    assert c.latest_offset() == 0
    offs = pulsar.append("events-partition-0",
                         [{"i": i} for i in range(30)])
    assert c.latest_offset() == offs[-1] + 1
    b1 = c.fetch(0, 7)
    assert len(b1.rows) == 7
    assert [r["i"] for r in c.fetch(b1.next_offset, 100).rows] == \
        list(range(7, 30))
    e = stream.create_consumer(1).fetch(0, 10)
    assert e.rows == [] and e.next_offset == 0
    with pytest.raises(tpulsar.PulsarError, match="no topic"):
        tpulsar.PulsarStream("missing", port=pulsar.port,
                             partitions=1).create_consumer(0)
    c.close()


@pytest.fixture
def kinesis():
    srv = tkinesis.FakeKinesisServer({"events": 2}, access_key="AK",
                                     secret_key="SK")
    yield srv
    srv.stop()


def _kstream(srv, **kw):
    return tkinesis.KinesisStream("events", srv.endpoint_url,
                                  access_key="AK", secret_key="SK", **kw)


def test_kinesis_shards_errors_and_signature(kinesis):
    assert _kstream(kinesis).num_partitions() == 2
    with pytest.raises(tkinesis.KinesisError, match="ResourceNotFound"):
        tkinesis.KinesisStream("missing", kinesis.endpoint_url,
                               access_key="AK",
                               secret_key="SK").num_partitions()
    with pytest.raises(tkinesis.KinesisError) as ei:
        tkinesis.KinesisStream("events", kinesis.endpoint_url,
                               access_key="WRONG",
                               secret_key="nope").num_partitions()
    assert ei.value.status == 403


def test_kinesis_putrecord_nondense_resume_and_expiry(kinesis):
    client = tkinesis.KinesisClient(kinesis.endpoint_url, access_key="AK",
                                    secret_key="SK")
    shard, seq1 = client.put_record("events", b'{"a": 1}', "k1")
    _, seq2 = client.put_record("events", b'{"a": 2}', "k1")
    assert int(seq2) > int(seq1) + 1
    idx = int(shard.rsplit("-", 1)[-1])
    c = _kstream(kinesis).create_consumer(idx)
    batch = c.fetch(0, 100)
    assert [r["a"] for r in batch.rows] == [1, 2]
    assert batch.next_offset == int(seq2) + 1
    again = c.fetch(batch.next_offset, 100)
    assert again.rows == [] and again.next_offset == batch.next_offset
    other = 1 - idx
    kinesis.put("events", other, [{"x": i} for i in range(6)])
    c1 = _kstream(kinesis).create_consumer(other)
    b1 = c1.fetch(0, 3)
    c2 = _kstream(kinesis).create_consumer(other)   # no cached iterator
    assert [r["x"] for r in c2.fetch(b1.next_offset, 100).rows] == [3, 4, 5]


def test_kinesis_retries_through_injected_500s(kinesis):
    s = _kstream(kinesis, backoff=0.01)
    kinesis.inject_failures(2)
    assert s.num_partitions() == 2


def test_kinesis_mid_batch_stream_offsets_exact(kinesis, tmp_path):
    kinesis.put("events", 0, [{"k": "a", "v": i, "i": i} for i in range(9)])
    cfg = trt.StreamConfig("events", num_partitions=2,
                           flush_threshold_rows=1000,
                           consumer_factory=_kstream(kinesis))
    dm = trt.RealtimeTableDataManager("events", _schema(_pkg("torch")),
                                      cfg, str(tmp_path / "t"),
                                      device="cpu")
    dm.consume_once(0)
    seqs = [seq for seq, _pk, _d in kinesis.shards["events"][0]]
    for rows in range(1, 10):
        assert dm._stream_offset(0, rows) == seqs[rows - 1] + 1
    dm.seal_partition(0)
    assert dm._partition_state(0)["next_offset"] == seqs[-1] + 1


def test_wire_protocol_roundtrip_and_bad_partition(tmp_path):
    wire = twire.WireBroker(num_partitions=2, log_dir=str(tmp_path / "wal"))
    try:
        prod = twire.WireProducer("127.0.0.1", wire.port)
        assert prod.num_partitions() == 2
        assert prod.produce_many([{"a": 1}, {"a": 2}], partition=0) == 0
        assert prod.produce({"a": 3}, partition=0) == 2
        prod.produce({"b": 9}, partition=1)
        c0 = twire.WireStreamConsumer("127.0.0.1", wire.port, 0, 5.0)
        batch = c0.fetch(0, 10)
        assert [r["a"] for r in batch.rows] == [1, 2, 3]
        assert batch.next_offset == 3 and c0.latest_offset() == 3
        assert [r["a"] for r in c0.fetch(1, 1).rows] == [2]
        bad = twire.WireStreamConsumer("127.0.0.1", wire.port, 7, 5.0)
        with pytest.raises(twire.BrokerError, match="partition"):
            bad.fetch(0, 10)
        for x in (c0, bad, prod):
            x.close()
    finally:
        wire.stop()


def test_wire_client_reconnects_after_broker_restart(tmp_path):
    wal = str(tmp_path / "wal")
    broker = twire.WireBroker(num_partitions=1, log_dir=wal)
    port = broker.port
    prod = twire.WireProducer("127.0.0.1", port)
    prod.produce_many([{"x": i} for i in range(5)])
    c = twire.WireStreamConsumer("127.0.0.1", port, 0, 5.0)
    assert len(c.fetch(0, 10).rows) == 5
    broker.stop()
    prod.close()
    broker2 = twire.WireBroker(num_partitions=1, port=port, log_dir=wal)
    try:
        assert [r["x"] for r in c.fetch(3, 10).rows] == [3, 4]
        assert c.latest_offset() == 5
    finally:
        c.close()
        broker2.stop()
    # the log files are the reference's: its broker serves the same rows
    jb = jwire.WireBroker(num_partitions=1, log_dir=wal)
    try:
        jc = jwire.WireStreamConsumer("127.0.0.1", jb.port, 0, 5.0)
        assert [r["x"] for r in jc.fetch(0, 10).rows] == list(range(5))
        jc.close()
    finally:
        jb.stop()


def test_wire_torn_tail_truncated_on_recovery(tmp_path):
    path = os.path.join(str(tmp_path), "p0.log")
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 5) + b"hello")
        f.write(struct.pack(">I", 100) + b"torn")
    log = twire._PartitionLog(path)
    assert log.messages == [b"hello"]
    log.append([b"a", b"b"])
    log.close()
    log2 = twire._PartitionLog(path)
    assert log2.messages == [b"hello", b"a", b"b"]
    log2.close()
