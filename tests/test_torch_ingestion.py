"""Ingestion in the port against the JAX package, on the CPU.

The record transformers (flatten, derived columns, filter, type coercion,
sanitization, the composite order) give the reference's rows on the same
input; a batch job over CSV and JSON inputs builds byte-equal segments in
both packages (standalone, and the parallel runner's worker processes)
that answer equal rows through both brokers; an ingestion filter and a
derived column apply to a stream as in the reference; a job's push
registers its segments with a controller. What waits for a later slice
(Avro and Parquet input) raises ``NotImplementedError`` naming it.
"""
import csv
import filecmp
import json
import os
import sys

import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the broker)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import pinot_tpu.ingestion as jing  # noqa: E402
import pinot_tpu.inputformat as jin  # noqa: E402
import pinot_tpu_torch.ingestion as ting  # noqa: E402
import pinot_tpu_torch.inputformat as tin  # noqa: E402
from test_torch_realtime import OPT, PKGS, _pkg  # noqa: E402


def _ns(name):
    ns = _pkg(name)
    ns.ing = jing if name == "jax" else ting
    return ns


def _schema(ns):
    s = ns.spi
    return s.Schema("orders", [
        s.FieldSpec("region", s.DataType.STRING),
        s.FieldSpec("amount", s.DataType.INT, s.FieldType.METRIC),
        s.FieldSpec("amount_usd", s.DataType.DOUBLE, s.FieldType.METRIC)])


def _transformers(ns):
    ing = ns.ing
    cfg = ns.spi.TableConfig("orders", ingestion=ns.spi.IngestionConfig(
        filter_function="amount < 0",
        transforms=[{"columnName": "amount_usd",
                     "transformFunction": "amount * 1.5"}]))
    return {
        "flatten": (ing.ComplexTypeTransformer(),
                    [{"a": {"b": 1, "c": {"d": 2}}, "e": 3}]),
        "expression": (ing.ExpressionTransformer([
            {"columnName": "amount_usd", "transformFunction": "amount * 2"}]),
            [{"amount": 5}, {"amount": 7}, {"amount": None}]),
        "expression_missing_source": (ing.ExpressionTransformer([
            {"columnName": "x", "transformFunction": "nope + 1"}]),
            [{"amount": 5}]),
        "filter": (ing.FilterTransformer("amount < 10"),
                   [{"amount": 5}, {"amount": 50}]),
        "coercion": (ing.DataTypeTransformer(_schema(ns)),
                     [{"region": 7, "amount": "42", "amount_usd": "1.5",
                       "junk": "x"}, {"region": None, "amount": 3.0}]),
        "sanitize": (ing.SanitizationTransformer(max_length=4),
                     [{"region": "ab\x00cdef", "amount": 1}]),
        "composite": (ing.CompositeTransformer.from_table_config(
            cfg, _schema(ns)),
            [{"nested": {"ignored": 1}, "region": "eu", "amount": 10},
             {"region": "us", "amount": -5}]),
    }


@pytest.mark.parametrize("name", ["flatten", "expression",
                                  "expression_missing_source", "filter",
                                  "coercion", "sanitize", "composite"])
def test_transformer_matches_reference(name):
    got = []
    for pkg in PKGS:
        t, rows = _transformers(_ns(pkg))[name]
        got.append(t.transform([dict(r) for r in rows]))
    assert got[1] == got[0]
    if name == "composite":
        assert got[1] == [{"region": "eu", "amount": 10,
                           "amount_usd": 15.0}]


def _write_inputs(root):
    os.makedirs(root)
    with open(os.path.join(root, "part1.csv"), "w", newline="") as fh:
        w = csv.DictWriter(fh, ["region", "amount"])
        w.writeheader()
        for i in range(10):
            w.writerow({"region": "east" if i % 2 else "west",
                        "amount": i if i != 4 else ""})
    with open(os.path.join(root, "part2.json"), "w") as fh:
        for i in range(10, 20):
            fh.write(json.dumps({"region": "north", "amount": i}) + "\n")
    with open(os.path.join(root, "part3.json"), "w") as fh:
        json.dump([{"region": "south", "amount": i} for i in range(20, 23)],
                  fh)
    return root


def _spec(ns, tmp):
    cfg = ns.spi.TableConfig("orders", ingestion=ns.spi.IngestionConfig(
        transforms=[{"columnName": "amount_usd",
                     "transformFunction": "amount * 1.1"}]))
    return {"inputDirURI": str(tmp / "in"),
            "outputDirURI": str(tmp / "segments"),
            "tableName": "orders", "schema": _schema(ns).to_dict(),
            "tableConfig": cfg.to_dict(), "rowsPerSegment": 8}


def _same_dirs(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        if f == "metadata.json":
            ma, mb = (json.load(open(os.path.join(d, f))) for d in (a, b))
            ma.pop("creationTimeMs"), mb.pop("creationTimeMs")
            assert ma == mb
        else:
            assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                               shallow=False), f


SQLS = ("SELECT COUNT(*), SUM(amount), SUM(amount_usd) FROM orders",
        "SELECT region, COUNT(*), SUM(amount) FROM orders GROUP BY region "
        "ORDER BY region")


def _rows_of(ns, dirs):
    dm = ns.table("orders")
    for d in dirs:
        dm.add_segment(ns.load(d))
    b = ns.broker()
    b.register_table(dm)
    return [b.query(s + OPT).rows for s in SQLS]


def test_batch_job_matches_reference(tmp_path):
    """CSV and JSON (lines and array) inputs, 23 rows at 8 a segment:
    the standalone runners of both packages write the same segment
    directories, byte for byte, and answer the same rows; the port's
    parallel runner (one worker process a file) answers them too."""
    _write_inputs(str(tmp_path / "in"))
    results = []
    for name in PKGS:
        ns = _ns(name)
        spec = _spec(ns, tmp_path)
        spec["outputDirURI"] = str(tmp_path / name)
        dirs = ns.ing.run_batch_ingestion(spec)
        results.append((dirs, _rows_of(ns, dirs)))
    (jdirs, jrows), (tdirs, trows) = results
    assert [os.path.basename(d) for d in tdirs] == \
        [os.path.basename(d) for d in jdirs] == \
        ["orders_0", "orders_1", "orders_2"]
    for a, b in zip(jdirs, tdirs):
        _same_dirs(a, b)
    assert trows[0][0][:2] == (23, sum(range(23)) - 4)
    assert trows[0][0][2] == pytest.approx(jrows[0][0][2], rel=1e-9)
    assert trows[1] == jrows[1]

    ns = _ns("torch")
    spec = _spec(ns, tmp_path)
    spec["outputDirURI"] = str(tmp_path / "parallel")
    spec["executionFrameworkSpec"] = {"name": "parallel", "numWorkers": 3}
    pdirs = ting.run_batch_ingestion(spec)
    assert [os.path.basename(d) for d in pdirs] == [
        "orders_0_0", "orders_0_1", "orders_1_0", "orders_1_1",
        "orders_2_0"]
    prows = _rows_of(ns, pdirs)
    assert prows[0][0][:2] == trows[0][0][:2]
    assert prows[0][0][2] == pytest.approx(trows[0][0][2], rel=1e-9)
    assert prows[1] == trows[1]


def test_batch_job_edges(tmp_path):
    _write_inputs(str(tmp_path / "in"))
    ns = _ns("torch")
    spec = _spec(ns, tmp_path)
    spec["tableConfig"]["ingestion"]["filterFunction"] = "amount >= 0"
    assert ting.run_batch_ingestion(spec) == []
    spec = _spec(ns, tmp_path)
    spec["includeFileNamePattern"] = "*.nope"
    with pytest.raises(FileNotFoundError):
        ting.run_batch_ingestion(spec)
    from pinot_tpu.cluster.deepstore import pruning_metadata
    from pinot_tpu_torch.cluster import Controller
    ctrl = Controller(str(tmp_path / "ctrl"))
    try:
        spec = _spec(ns, tmp_path)
        ctrl.add_table("orders", spec["schema"])
        spec["push"] = {"controllerUrl": ctrl.url,
                        "deepstoreURI": f"file://{tmp_path}/deep"}
        locs = ting.run_batch_ingestion(spec)
        segs = ctrl.routing_snapshot()["segments"]["orders"]
        assert sorted(segs) == sorted(
            os.path.basename(u)[:-len(".tar.gz")] for u in locs)
        for name, entry in segs.items():
            assert entry["location"].startswith(f"file://{tmp_path}/deep/")
            assert entry["meta"] == pruning_metadata(
                os.path.join(spec["outputDirURI"], name))
    finally:
        ctrl.stop()


@pytest.mark.parametrize("fmt", ["avro", "parquet", "orc"])
def test_unported_formats_raise(tmp_path, fmt):
    with pytest.raises(NotImplementedError, match="inputformat"):
        tin.read_records(str(tmp_path / f"x.{fmt}"))
    with pytest.raises(ValueError, match="unknown input format"):
        tin.read_records(str(tmp_path / "x.xls"))


def test_readers_match_reference(tmp_path):
    root = _write_inputs(str(tmp_path / "in"))
    for f in sorted(os.listdir(root)):
        path = os.path.join(root, f)
        assert tin.read_records(path) == jin.read_records(path)


def test_stream_filter_and_derive_match_reference(tmp_path):
    got = []
    for name in PKGS:
        ns = _ns(name)
        stream = ns.Stream(1)
        for i in range(10):
            stream.produce({"region": "r", "amount": i})
        stream.produce({"region": "bad", "amount": "not a number"})
        cfg = ns.spi.TableConfig("orders", ingestion=ns.spi.IngestionConfig(
            filter_function="amount < 3",
            transforms=[{"columnName": "amount_usd",
                         "transformFunction": "amount * 2.0"}]))
        m = ns.manager("orders", _schema(ns), ns.Config(
            "t", consumer_factory=stream, flush_threshold_rows=1000),
            str(tmp_path / name), table_config=cfg)
        m.consume_once(0)
        b = ns.broker()
        b.register_table(m)
        got.append([b.query(s + OPT).rows for s in SQLS]
                   + [m._mutables[0].n_docs,
                      m._partition_state(0)["next_offset"]])
    assert got[1] == got[0]
