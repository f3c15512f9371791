"""The on-disk segment is shared state between the two packages.

The port's builder must write the same files as the JAX builder, byte
for byte, apart from ``creationTimeMs`` and the timestamp in a generated
segment name; and each package must load the other's segments and read
the same forward indexes, dictionaries and null masks.
"""
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402
from pinot_tpu.segment import ImmutableSegment as JaxSegment  # noqa: E402
from pinot_tpu.segment import SegmentBuilder as JaxBuilder  # noqa: E402
from pinot_tpu.spi import Schema as JaxSchema  # noqa: E402
from pinot_tpu.spi import TableConfig as JaxTableConfig  # noqa: E402
from pinot_tpu_torch.segment import SegmentBuilder, load_segment  # noqa
from pinot_tpu_torch.spi import (DataType, FieldSpec, FieldType,  # noqa
                                 Schema, TableConfig)
from pinot_tpu_torch.tools import ssb  # noqa: E402

ROWS = [
    {"city": "oslo", "n": 3, "big": 1 << 40, "x": 1.5, "tags": ["a", "b"],
     "flag": True},
    {"city": None, "n": None, "big": 7, "x": None, "tags": None,
     "flag": False},
    {"city": "rome", "n": 3, "big": -2, "x": -0.25, "tags": ["b"],
     "flag": True},
    {"city": "oslo", "n": 11, "big": 0, "x": 1e10, "tags": [],
     "flag": None},
]
FIELDS = [("city", "STRING", "DIMENSION", True),
          ("n", "INT", "DIMENSION", True),
          ("big", "LONG", "METRIC", True),
          ("x", "DOUBLE", "METRIC", True),
          ("tags", "STRING", "DIMENSION", False),
          ("flag", "BOOLEAN", "DIMENSION", True)]


def _schema(pkg_schema, pkg_field, pkg_dt, pkg_ft):
    return pkg_schema("t", [pkg_field(n, pkg_dt[d], pkg_ft[f], sv)
                            for n, d, f, sv in FIELDS])


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


def _build_both(tmp_path, data_port, data_jax, schema_port, schema_jax,
                name):
    port = SegmentBuilder(schema_port, TableConfig(schema_port.name)).build(
        data_port, str(tmp_path / "port"), name)
    jax_dir = JaxBuilder(schema_jax, JaxTableConfig(schema_jax.name)).build(
        data_jax, str(tmp_path / "jax"), name)
    return port, jax_dir


def test_builder_files_identical_rows_with_nulls(tmp_path):
    from pinot_tpu.spi import DataType as JDT, FieldSpec as JFS, \
        FieldType as JFT
    port, jax_dir = _build_both(
        tmp_path, ROWS, ROWS,
        _schema(Schema, FieldSpec, DataType.__members__,
                FieldType.__members__),
        _schema(JaxSchema, JFS, JDT.__members__, JFT.__members__), "s0")
    assert _files(port) == _files(jax_dir)


def test_builder_files_identical_ssb(tmp_path):
    cols = ssb.gen_columns(5000)
    jcols = bench.gen_columns(5000)
    from pinot_tpu.spi import DataType as JDT, FieldSpec as JFS, \
        FieldType as JFT
    port_schema = Schema("lineorder", ssb._ssb_fields(cols))
    jax_schema = JaxSchema("lineorder", [
        JFS(f.name, JDT[f.data_type.name], JFT[f.field_type.name])
        for f in port_schema.fields])
    port, jax_dir = _build_both(tmp_path, cols, jcols, port_schema,
                                jax_schema, "seg_0")
    assert _files(port) == _files(jax_dir)


def test_generated_segment_name_differs_only_in_timestamp(tmp_path):
    cols = {"v": np.arange(10, dtype=np.int32)}
    schema = Schema("t", [FieldSpec("v", DataType.INT)])
    port = SegmentBuilder(schema).build(cols, str(tmp_path / "a"))
    from pinot_tpu.spi import DataType as JDT, FieldSpec as JFS
    jax_dir = JaxBuilder(JaxSchema("t", [JFS("v", JDT.INT)])).build(
        cols, str(tmp_path / "b"))
    pa, pb = _files(port), _files(jax_dir)
    for meta in (pa["metadata.json"], pb["metadata.json"]):
        name = meta.pop("segmentName")
        assert name.startswith("t_") and name[2:].isdigit()
    assert pa == pb


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_loads_the_others_segment(tmp_path, writer):
    from pinot_tpu.spi import DataType as JDT, FieldSpec as JFS, \
        FieldType as JFT
    port_dir, jax_dir = _build_both(
        tmp_path, ROWS, ROWS,
        _schema(Schema, FieldSpec, DataType.__members__,
                FieldType.__members__),
        _schema(JaxSchema, JFS, JDT.__members__, JFT.__members__), "s0")
    seg_dir = port_dir if writer == "port" else jax_dir
    tseg = load_segment(seg_dir, "cpu")
    jseg = JaxSegment.load(seg_dir)
    assert tseg.n_docs == jseg.n_docs == len(ROWS)
    assert list(tseg.columns) == list(jseg.columns)
    for col in tseg.columns:
        np.testing.assert_array_equal(np.asarray(tseg.fwd(col)),
                                      np.asarray(jseg.fwd(col)))
        td, jd = tseg.dictionary(col), jseg.dictionary(col)
        assert (td is None) == (jd is None)
        if td is not None:
            assert list(td.values) == list(jd.values)
        tn, jn = tseg.null_mask(col), jseg.null_mask(col)
        assert (tn is None) == (jn is None)
        if tn is not None:
            np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(
            tseg.host_col_padded(col), np.asarray(jseg.host_col_padded(col)))
        dev = tseg.device_col(col).numpy()
        np.testing.assert_array_equal(dev, tseg.host_col_padded(col))


def test_unported_formats_raise(tmp_path):
    """The BITPACK and COMPRESSED formats are ported: both build with the
    reference's bytes and load; what still raises is what the reference
    refuses, an unknown codec (KeyError in both packages)."""
    from pinot_tpu.segment import SegmentBuilder as JaxBuilder
    from pinot_tpu.spi import DataType as JDataType
    from pinot_tpu.spi import FieldSpec as JFieldSpec
    from pinot_tpu.spi import FieldType as JFieldType
    from pinot_tpu.spi import Schema as JSchema
    from pinot_tpu.spi import TableConfig as JConfig

    cols = {"v": np.arange(10, dtype=np.int32)}
    for i, (field_type, attr, value) in enumerate((
            ("METRIC", "compression", "ZLIB"),
            ("DIMENSION", "bit_packed_ids", True))):
        schema = Schema("t", [FieldSpec("v", DataType.INT,
                                        FieldType(field_type))])
        jschema = JSchema("t", [JFieldSpec("v", JDataType.INT,
                                           JFieldType(field_type))])
        cfg, jcfg = TableConfig("t"), JConfig("t")
        setattr(cfg.indexing, attr, value)
        setattr(jcfg.indexing, attr, value)
        d = SegmentBuilder(schema, cfg).build(cols, str(tmp_path / "t"),
                                              f"s{i}")
        jd = JaxBuilder(jschema, jcfg).build(cols, str(tmp_path / "j"),
                                             f"s{i}")
        with open(os.path.join(d, "v.fwd.bin"), "rb") as fh, \
                open(os.path.join(jd, "v.fwd.bin"), "rb") as jfh:
            assert fh.read() == jfh.read()
        np.testing.assert_array_equal(
            load_segment(d, "cpu").raw_values("v"), cols["v"])
    cfg = TableConfig("t")
    cfg.indexing.compression = "NOPE"
    schema = Schema("t", [FieldSpec("v", DataType.INT, FieldType.METRIC)])
    with pytest.raises(KeyError):
        SegmentBuilder(schema, cfg).build(cols, str(tmp_path), "bad")
