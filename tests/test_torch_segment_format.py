"""BITPACK and COMPRESSED forward indexes: the port against the JAX package.

The SSB ``lineorder`` columns (numpy-seeded, the same rows in both
packages) are written by each package's builder with ``bit_packed_ids``
(every dictionary column BITPACK) and with the five metric columns raw
under each codec (ZSTD, ZLIB, LZ4, SNAPPY, PASS_THROUGH, DELTA). The two
builders' files must be byte-equal (metadata less its timestamp), each
package must load the other's segment with equal decoded rows, and the
13 SSB queries over a BITPACK and a ZSTD copy must return the JAX
broker's rows and the PLAIN segment's digests. A column whose deltas
exceed 32 bits degrades from DELTA to ZLIB in both builders alike.
"""
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402
from pinot_tpu.broker import Broker as JaxBroker  # noqa: E402
from pinot_tpu.segment import ImmutableSegment as JaxSegment  # noqa: E402
from pinot_tpu.segment import SegmentBuilder as JaxBuilder  # noqa: E402
from pinot_tpu.server import TableDataManager as JaxTable  # noqa: E402
from pinot_tpu.spi import DataType as JDT  # noqa: E402
from pinot_tpu.spi import FieldSpec as JFS  # noqa: E402
from pinot_tpu.spi import FieldType as JFT  # noqa: E402
from pinot_tpu.spi import IndexingConfig as JIndexing  # noqa: E402
from pinot_tpu.spi import Schema as JaxSchema  # noqa: E402
from pinot_tpu.spi import TableConfig as JaxConfig  # noqa: E402
from pinot_tpu_torch.broker import Broker, connect  # noqa: E402
from pinot_tpu_torch.segment import SegmentBuilder, load_segment  # noqa
from pinot_tpu_torch.server import TableDataManager  # noqa: E402
from pinot_tpu_torch.spi import (DataType, FieldSpec, FieldType,  # noqa
                                 IndexingConfig, Schema, TableConfig)
from pinot_tpu_torch.tools import ssb  # noqa: E402

N = 3000
METRICS = ["lo_revenue", "lo_extendedprice", "lo_supplycost",
           "lo_discount", "lo_quantity"]
FORMATS = ["bitpack"] + [f"compressed_{c}" for c in (
    "ZSTD", "ZLIB", "LZ4", "SNAPPY", "PASS_THROUGH", "DELTA")]
SSB_SQL = [(qid, ssb.spec_to_sql(p, v, g)) for qid, p, v, g in ssb.QUERIES]


def _indexing(fmt: str, cls):
    if fmt == "plain":
        return cls()
    if fmt == "bitpack":
        return cls(bit_packed_ids=True)
    return cls(no_dictionary_columns=list(METRICS),
               compression=fmt.split("_", 1)[1])


def _files(seg_dir):
    out = {}
    for name in sorted(os.listdir(seg_dir)):
        with open(os.path.join(seg_dir, name), "rb") as fh:
            data = fh.read()
        if name == "metadata.json":
            meta = json.loads(data)
            meta.pop("creationTimeMs")
            data = meta
        out[name] = data
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """{fmt: (port dir, jax dir)} over the same SSB rows."""
    out = tmp_path_factory.mktemp("fmt")
    cols, jcols = ssb.gen_columns(N), bench.gen_columns(N)
    port_schema = Schema("lineorder", ssb._ssb_fields(cols))
    jax_schema = JaxSchema("lineorder", [
        JFS(f.name, JDT[f.data_type.name], JFT[f.field_type.name])
        for f in port_schema.fields])
    dirs = {}
    for fmt in ["plain"] + FORMATS:
        port = SegmentBuilder(port_schema, TableConfig(
            "lineorder", indexing=_indexing(fmt, IndexingConfig))).build(
            cols, str(out / "port" / fmt), "seg_0")
        jax_dir = JaxBuilder(jax_schema, JaxConfig(
            "lineorder", indexing=_indexing(fmt, JIndexing))).build(
            jcols, str(out / "jax" / fmt), "seg_0")
        dirs[fmt] = (port, jax_dir)
    return dirs


@pytest.mark.parametrize("fmt", FORMATS)
def test_files_byte_equal(built, fmt):
    port, jax_dir = built[fmt]
    files = _files(port)
    assert files == _files(jax_dir)
    cmeta = files["metadata.json"]["columns"]
    if fmt == "bitpack":
        packed = [c for c, m in cmeta.items() if m.get("fwdFormat")]
        assert packed and all(cmeta[c]["fwdFormat"] == "BITPACK"
                              for c in packed)
    else:
        codec = fmt.split("_", 1)[1]
        assert {cmeta[c]["codec"] for c in METRICS} == {codec}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_each_package_loads_the_others_format(built, fmt, writer):
    seg_dir = built[fmt][0 if writer == "port" else 1]
    tseg = load_segment(seg_dir, "cpu")
    jseg = JaxSegment.load(seg_dir)
    plain = load_segment(built["plain"][0], "cpu")
    for col in tseg.columns:
        got = tseg.raw_values(col)
        np.testing.assert_array_equal(got, jseg.raw_values(col))
        np.testing.assert_array_equal(got, plain.raw_values(col))
        if tseg.columns[col].fwd_format != "PLAIN":
            np.testing.assert_array_equal(tseg.fwd(col),
                                          np.asarray(jseg.fwd(col)))
            np.testing.assert_array_equal(
                tseg.device_col(col).numpy(),
                np.asarray(jseg.host_col_padded(col)))


def test_wide_deltas_degrade_to_zlib_alike(tmp_path):
    v = np.array([0, 1 << 40, 3, -(1 << 41)], dtype=np.int64)
    metas = []
    for schema, cfg, builder, sub in (
            (Schema("t", [FieldSpec("v", DataType.LONG, FieldType.METRIC)]),
             TableConfig("t", indexing=IndexingConfig(compression="DELTA")),
             SegmentBuilder, "port"),
            (JaxSchema("t", [JFS("v", JDT.LONG, JFT.METRIC)]),
             JaxConfig("t", indexing=JIndexing(compression="DELTA")),
             JaxBuilder, "jax")):
        d = builder(schema, cfg).build({"v": v}, str(tmp_path / sub), "s")
        metas.append(_files(d))
    assert metas[0] == metas[1]
    assert metas[0]["metadata.json"]["columns"]["v"]["codec"] == "ZLIB"
    np.testing.assert_array_equal(
        load_segment(str(tmp_path / "port" / "s"), "cpu").raw_values("v"),
        v)


def test_zstd_without_zstd_writes_zlib(monkeypatch, tmp_path):
    """A library built without zstd: a ZSTD column is written as ZLIB and
    its metadata names ZLIB, with the JAX builder's ZLIB bytes."""
    from pinot_tpu_torch import native as tn

    assert tn.available()
    monkeypatch.setattr(tn, "_zstd", False)
    v = np.random.default_rng(5).integers(0, 1 << 20, 4000).astype(np.int64)
    metas = []
    for schema, cfg, builder, sub in (
            (Schema("t", [FieldSpec("v", DataType.LONG, FieldType.METRIC)]),
             TableConfig("t", indexing=IndexingConfig(compression="ZSTD")),
             SegmentBuilder, "port"),
            (JaxSchema("t", [JFS("v", JDT.LONG, JFT.METRIC)]),
             JaxConfig("t", indexing=JIndexing(compression="ZLIB")),
             JaxBuilder, "jax")):
        d = builder(schema, cfg).build({"v": v}, str(tmp_path / sub), "s")
        metas.append(_files(d))
    assert metas[0] == metas[1]
    assert metas[0]["metadata.json"]["columns"]["v"]["codec"] == "ZLIB"
    np.testing.assert_array_equal(
        load_segment(str(tmp_path / "port" / "s"), "cpu").raw_values("v"),
        v)


@pytest.fixture(scope="module")
def brokers(built):
    out = {}
    for fmt in ("plain", "bitpack", "compressed_ZSTD"):
        dm = TableDataManager("lineorder", device="cpu")
        dm.add_segment_dir(built[fmt][1])     # the JAX builder's files
        b = Broker(device="cpu")
        b.register_table(dm)
        jdm = JaxTable("lineorder")
        jdm.add_segment_dir(built[fmt][0])    # the port builder's files
        jb = JaxBroker()
        jb.register_table(jdm)
        out[fmt] = (connect(b), jb)
    return out


@pytest.mark.parametrize("qid,sql", SSB_SQL)
def test_ssb_rows_equal_across_formats_and_brokers(brokers, qid, sql,
                                                   monkeypatch):
    monkeypatch.setenv("PINOT_CPU_FAST_GROUPBY", "1")
    plain = ssb._digest(brokers["plain"][0](sql).rows)
    for fmt in ("bitpack", "compressed_ZSTD"):
        q, jb = brokers[fmt]
        rows = q(sql).rows
        assert ssb._digest(rows) == plain, (qid, fmt)
        assert ssb._digest(rows) == ssb._digest(jb.query(sql).rows), \
            (qid, fmt)
