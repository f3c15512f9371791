"""The port's input formats against the JAX package's, on the CPU.

``pinot_tpu_torch/inputformat`` reads every format the reference reads:
Avro object-container files (null and deflate) written by either
package are byte-equal and decode to the same rows, Confluent-framed
Avro decodes through the port's ``KafkaStream(value_decoder=...)`` into
a consuming table, and Thrift, CLP, protobuf, ORC and Parquet files give
the reference's rows (protobuf, ORC and Parquet raise the reference's
error where their library is missing). A batch job over Avro input
pushed to an ``s3://`` deep store builds the reference's segment files.
"""
import filecmp
import json
import os
import struct
import sys

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the broker)

import pinot_tpu.inputformat as jin
import pinot_tpu.inputformat.avro as javro
import pinot_tpu_torch.inputformat as tin
import pinot_tpu_torch.inputformat.avro as tavro
import pinot_tpu_torch.inputformat.extended as text
from test_torch_fs import _stop_soon

SCHEMA = {
    "type": "record", "name": "Row", "namespace": "t", "fields": [
        {"name": "k", "type": "string"},
        {"name": "v", "type": "long"},
        {"name": "i", "type": "int"},
        {"name": "f", "type": "double"},
        {"name": "g", "type": "float"},
        {"name": "flag", "type": "boolean"},
        {"name": "opt", "type": ["null", "string"]},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "attrs", "type": {"type": "map", "values": "int"}},
        {"name": "color", "type": {"type": "enum", "name": "Color",
                                   "symbols": ["RED", "GREEN", "BLUE"]}},
        {"name": "raw", "type": "bytes"},
        {"name": "fx", "type": {"type": "fixed", "name": "F4", "size": 4}},
        {"name": "amt", "type": {"type": "bytes", "logicalType": "decimal",
                                 "precision": 9, "scale": 2}},
    ],
}


def _rows(n: int, seed: int = 3):
    import decimal

    rng = np.random.default_rng(seed)
    return [{"k": f"key{int(rng.integers(0, 50))}",
             "v": int(rng.integers(-2 ** 40, 2 ** 40)),
             "i": int(rng.integers(-2 ** 31, 2 ** 31)),
             "f": float(rng.normal()), "g": 0.5 * int(rng.integers(0, 9)),
             "flag": bool(rng.random() < 0.5),
             "opt": None if rng.random() < 0.3 else "x" * int(
                 rng.integers(0, 5)),
             "tags": ["a", "b"][:int(rng.integers(0, 3))],
             "attrs": {"x": int(rng.integers(-9, 9))},
             "color": ["RED", "GREEN", "BLUE"][int(rng.integers(0, 3))],
             "raw": bytes(rng.integers(0, 256, 3).tolist()),
             "fx": b"abcd",
             "amt": decimal.Decimal(int(rng.integers(-99999, 99999))
                                    ).scaleb(-2)} for _ in range(n)]


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_containers_are_byte_equal(tmp_path, codec):
    rows = _rows(300)
    paths = []
    for mod in (tavro, javro):
        p = tmp_path / f"{mod.__name__}.avro"
        mod.write_container(str(p), SCHEMA, rows, codec)
        paths.append(str(p))
    assert filecmp.cmp(*paths, shallow=False)
    got = tin.read_records(paths[1])
    assert got == jin.read_records(paths[0]) == rows
    assert tavro.read_container(paths[0]) == rows
    # the SSB lineorder files the chip check's remote phase writes
    from pinot_tpu_torch.tools import ssb

    cols = ssb.gen_columns(700)
    lo = [str(tmp_path / f"lo_{m.__name__}.avro") for m in (tavro, javro)]
    for m, path in zip((tavro, javro), lo):
        m.write_container(path, ssb.avro_schema(cols), ssb.row_dicts(cols),
                          codec)
    assert filecmp.cmp(*lo, shallow=False)


def test_avro_codec_and_confluent_frames_match_reference():
    rows = _rows(40, seed=9)
    for r in rows:
        a = tavro.AvroCodec(SCHEMA).encode(r)
        assert a == javro.AvroCodec(SCHEMA).encode(r)
        assert tavro.AvroCodec(SCHEMA).decode(a, 0) == (r, len(a))
        assert tavro.confluent_encode(7, tavro.AvroCodec(SCHEMA), r) == \
            javro.confluent_encode(7, javro.AvroCodec(SCHEMA), r)
    for bad in (b"", b"\x01abcd", b"\x00\x00"):
        errs = []
        for mod in (tavro, javro):
            with pytest.raises(mod.AvroError) as ei:
                mod.ConfluentAvroDecoder("http://127.0.0.1:9")(bad)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


def test_confluent_avro_through_the_ports_kafka_stream(tmp_path):
    """Frames registered with either package's registry, put in the
    port's fake Kafka broker, decode through KafkaStream's value decoder
    into a consuming table that answers their sums."""
    from pinot_tpu_torch.broker import Broker
    from pinot_tpu_torch.realtime import (RealtimeTableDataManager,
                                          StreamConfig)
    from pinot_tpu_torch.realtime.kafka import FakeKafkaBroker, KafkaStream
    from pinot_tpu_torch.spi import DataType, FieldSpec, FieldType, Schema

    evt = json.dumps({"type": "record", "name": "Evt", "fields": [
        {"name": "k", "type": "string"}, {"name": "v", "type": "long"}]})
    regs = (tavro.SchemaRegistryStub(), javro.SchemaRegistryStub())
    kafka = FakeKafkaBroker({"evts": 1})
    try:
        rng = np.random.default_rng(13)
        rows = [{"k": str(rng.choice(["a", "b"])), "v": int(v)}
                for v in rng.integers(0, 100, 25)]
        frames = []
        for reg, mod in zip(regs, (tavro, javro)):
            sid = reg.register(evt)
            frames += [mod.confluent_encode(sid, mod.AvroCodec(evt), r)
                       for r in rows]
        # the port's decoder against the reference's registry too
        assert tavro.ConfluentAvroDecoder(regs[1].url)(frames[-1]) == \
            rows[-1]
        log = kafka.topics["evts"][0]
        with log.lock:
            log.records.extend((None, f, 0) for f in frames[:len(rows)])
        dm = RealtimeTableDataManager(
            "ct", Schema("ct", [
                FieldSpec("k", DataType.STRING),
                FieldSpec("v", DataType.LONG, FieldType.METRIC)]),
            StreamConfig("ct", num_partitions=1, flush_threshold_rows=10,
                         consumer_factory=KafkaStream(
                             "evts", port=kafka.port,
                             value_decoder=tavro.ConfluentAvroDecoder(
                                 regs[0].url))),
            str(tmp_path / "t"), device="cpu")
        dm.consume_once(0)
        b = Broker(device="cpu")
        b.register_table(dm)
        assert b.query("SELECT COUNT(*), SUM(v) FROM ct").rows[0] == (
            len(rows), sum(r["v"] for r in rows))
    finally:
        _stop_soon(kafka, *regs)


def _tstring(s: bytes) -> bytes:
    return struct.pack(">i", len(s)) + s


def _thrift_file(path: str) -> dict:
    def field(ttype, fid, payload):
        return struct.pack(">bh", ttype, fid) + payload

    s1 = (field(11, 1, _tstring(b"nyc"))
          + field(10, 2, struct.pack(">q", 1200))
          + field(4, 3, struct.pack(">d", 2.5))
          + field(2, 4, b"\x01")
          + field(15, 5, b"\x08" + struct.pack(">i", 2)
                  + struct.pack(">ii", 7, 9))
          + field(13, 6, b"\x0b\x08" + struct.pack(">i", 1)
                  + _tstring(b"k") + struct.pack(">i", 5))
          + field(8, 42, struct.pack(">i", 7))          # not mapped
          + b"\x00")
    s2 = field(11, 1, _tstring(b"sf")) + field(10, 2, struct.pack(
        ">q", 800)) + b"\x00"
    with open(path, "wb") as fh:
        fh.write(s1 + s2)
    return {"field_names": {1: "city", 2: "fare", 3: "d", 4: "b", 5: "xs",
                            6: "m"}}


def _clp_file(path: str) -> dict:
    with open(path, "w") as fh:
        for i in range(20):
            fh.write(json.dumps({
                "message": f"job_{i} wrote {i * 4096} bytes to host-{i % 3} "
                           f"in {i / 8:.2f} s (attempt 0{i % 2})",
                "level": "INFO" if i % 4 else "ERROR"}) + "\n")
    return {}


def _protobuf_file(path: str, pb) -> dict:
    from google.protobuf import descriptor_pb2

    fd = descriptor_pb2.FileDescriptorProto(name="trip.proto",
                                            package="fmt", syntax="proto3")
    msg = fd.message_type.add(name="Trip")
    F = descriptor_pb2.FieldDescriptorProto
    for i, (name, typ, label) in enumerate([
            ("city", F.TYPE_STRING, F.LABEL_OPTIONAL),
            ("fare", F.TYPE_INT64, F.LABEL_OPTIONAL),
            ("dist", F.TYPE_DOUBLE, F.LABEL_OPTIONAL),
            ("stops", F.TYPE_INT32, F.LABEL_REPEATED),
            ("flagged", F.TYPE_BOOL, F.LABEL_OPTIONAL)], 1):
        msg.field.add(name=name, number=i, type=typ, label=label)
    desc = path + ".desc"
    with open(desc, "wb") as fh:
        fh.write(descriptor_pb2.FileDescriptorSet(file=[fd])
                 .SerializeToString())
    cls = pb._message_class(desc, "fmt.Trip")
    pb.write_protobuf(path, [
        cls(city="nyc", fare=1200, dist=2.5, stops=[1, 2], flagged=True),
        cls(city="sf", fare=800, dist=1.25, stops=[], flagged=False)])
    return {"descriptor_file": desc, "message_type": "fmt.Trip"}


def _arrow_file(path: str, fmt: str) -> dict:
    import pyarrow as pa

    table = pa.table({"city": ["nyc", "sf", "la"], "fare": [1200, 800, 5],
                      "dist": [2.5, None, 0.125]})
    if fmt == "orc":
        from pyarrow import orc
        orc.write_table(table, path)
    else:
        import pyarrow.parquet as pq
        pq.write_table(table, path)
    return {}


@pytest.mark.parametrize("fmt", ["thrift", "clp", "protobuf", "orc",
                                 "parquet", "avro", "csv", "json"])
def test_every_format_reads_the_references_rows(tmp_path, fmt):
    path = str(tmp_path / f"in.{fmt}")
    if fmt == "thrift":
        args = _thrift_file(path)
    elif fmt == "clp":
        args = _clp_file(path)
    elif fmt == "protobuf":
        args = _protobuf_file(path, text)
    elif fmt in ("orc", "parquet"):
        args = _arrow_file(path, fmt)
    elif fmt == "avro":
        tavro.write_container(path, SCHEMA, _rows(20), "deflate")
        args = {}
    else:
        with open(path, "w") as fh:
            fh.write("a,b\n1,x\n2,\n" if fmt == "csv"
                     else '{"a": 1}\n{"a": 2, "b": [1]}\n')
        args = {}
    got = tin.read_records(path, fmt, **args)
    assert got and got == jin.read_records(path, fmt, **args)
    if fmt == "clp":
        row = got[3]
        assert text.clp_decode(row["message_logtype"],
                               row["message_dictionaryVars"],
                               row["message_encodedVars"]) == \
            json.loads(open(path).read().splitlines()[3])["message"]


@pytest.mark.parametrize("fmt,missing", [("protobuf", "google.protobuf"),
                                         ("orc", "pyarrow"),
                                         ("parquet", "pyarrow.parquet")])
def test_missing_libraries_raise_the_references_error(tmp_path, monkeypatch,
                                                      fmt, missing):
    path = str(tmp_path / f"x.{fmt}")
    args = ({"descriptor_file": path + ".desc", "message_type": "m.M"}
            if fmt == "protobuf" else {})
    monkeypatch.setitem(sys.modules, missing, None)
    if fmt == "orc":
        monkeypatch.setitem(sys.modules, "pyarrow.orc", None)
    errs = []
    for mod in (tin, jin):
        with pytest.raises(ImportError if fmt == "protobuf"
                           else RuntimeError) as ei:
            mod.read_records(path, fmt, **args)
        errs.append((type(ei.value).__name__, str(ei.value)))
    assert errs[0] == errs[1]


def test_every_format_is_dispatched():
    assert tin.FORMATS == jin.FORMATS
    with pytest.raises(ValueError, match="protobuf"):
        tin.read_records("/x.bogus", "bogus")


def _lineorder_avro(in_dir: str, files: int, rows_each: int) -> dict:
    """SSB lineorder rows as Avro container files (deflate); returns the
    job's schema dict."""
    from pinot_tpu_torch.tools import ssb

    os.makedirs(in_dir)
    cols = ssb.gen_columns(files * rows_each)
    rows = ssb.row_dicts(cols)
    for f in range(files):
        tavro.write_container(
            os.path.join(in_dir, f"part{f}.avro"), ssb.avro_schema(cols),
            rows[f * rows_each:(f + 1) * rows_each], "deflate")
    return ssb.lineorder_schema(cols).to_dict()


def test_avro_batch_job_pushed_to_s3_builds_the_references_segments(
        tmp_path):
    import pinot_tpu.cluster as jcluster
    import pinot_tpu.fs as jfs
    import pinot_tpu.ingestion as jing
    import pinot_tpu.spi.filesystem as jspi
    import pinot_tpu_torch.cluster as tcluster
    import pinot_tpu_torch.fs as tfs
    import pinot_tpu_torch.ingestion as ting
    import pinot_tpu_torch.spi.filesystem as tspi
    from pinot_tpu_torch.fs.stub import FakeS3Server

    schema = _lineorder_avro(str(tmp_path / "in"), 2, 300)
    srv = FakeS3Server(access_key="ak", secret_key="sk")
    saved = (dict(tspi._REGISTRY), dict(jspi._REGISTRY))
    ctrls = []
    try:
        outs = {}
        for name, fs, spi, cluster, ing in (
                ("torch", tfs, tspi, tcluster, ting),
                ("jax", jfs, jspi, jcluster, jing)):
            fs.S3PinotFS.register(endpoint_url=srv.endpoint_url,
                                  access_key="ak", secret_key="sk")
            ctrl = cluster.Controller(str(tmp_path / f"ctrl_{name}"))
            ctrls.append(ctrl)
            ctrl.add_table("lineorder", schema)
            spec = {"inputDirURI": str(tmp_path / "in"),
                    "outputDirURI": str(tmp_path / f"seg_{name}"),
                    "tableName": "lineorder", "schema": schema,
                    "format": "avro", "rowsPerSegment": 256,
                    "push": {"controllerUrl": ctrl.url,
                             "deepstoreURI": f"s3://deep/{name}"}}
            locs = ing.run_batch_ingestion(spec)
            assert all(u.startswith(f"s3://deep/{name}/") for u in locs)
            segs = ctrl.routing_snapshot()["segments"]["lineorder"]
            assert sorted(e["location"] for e in segs.values()) == \
                sorted(locs)
            outs[name] = spec["outputDirURI"]
        names = sorted(os.listdir(outs["torch"]))
        assert names == sorted(os.listdir(outs["jax"])) and len(names) == 3
        for n in names:
            a, b = (os.path.join(outs[k], n) for k in ("torch", "jax"))
            assert sorted(os.listdir(a)) == sorted(os.listdir(b))
            for f in os.listdir(a):
                if f == "metadata.json":
                    ma, mb = (json.load(open(os.path.join(d, f)))
                              for d in (a, b))
                    ma.pop("creationTimeMs"), mb.pop("creationTimeMs")
                    assert ma == mb
                else:
                    assert filecmp.cmp(os.path.join(a, f),
                                       os.path.join(b, f), shallow=False), f
        keys, _p = tfs.S3Client(srv.endpoint_url, "ak", "sk").list_objects(
            "deep", prefix="torch/")
        assert len(keys) == len(names)
    finally:
        for c in ctrls:
            c.stop()
        tspi._REGISTRY.clear()
        tspi._REGISTRY.update(saved[0])
        tspi._INSTANCES.clear()
        jspi._REGISTRY.clear()
        jspi._REGISTRY.update(saved[1])
        jspi._INSTANCES.clear()
        _stop_soon(srv)
