"""The partial wire formats of the port against the JAX package, on the CPU.

The same query over the same segment goes through each package's
executor (``engine/serving.execute_segments``); the partials it yields,
for every plan kind (aggregation, group-by with HLL, percentile and
distinct states, selection, empty), must encode to the same bytes in the
columnar DataBlock codec (``engine/datablock``) and to the same JSON in
the serde wire (``engine/serde``), and each package must decode the
other's frames to equal partials. Relations (the multi-stage mailbox
blocks) with string and object columns and nulls encode byte-equal too.
"""
import json

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the engine)

import pinot_tpu.engine.datablock as jdb
import pinot_tpu.engine.executor as jex
import pinot_tpu.engine.serde as jserde
import pinot_tpu.multistage.relation as jrel
import pinot_tpu.query.context as jctx
import pinot_tpu.query.sql as jsql
import pinot_tpu.engine.serving as jserving
import pinot_tpu.segment as jseg
import pinot_tpu.spi as jspi
import pinot_tpu_torch.engine.datablock as tdb
import pinot_tpu_torch.engine.executor as tex
import pinot_tpu_torch.engine.serde as tserde
import pinot_tpu_torch.multistage.relation as trel
import pinot_tpu_torch.query.context as tctx
import pinot_tpu_torch.query.sql as tsql
import pinot_tpu_torch.engine.serving as tserving
import pinot_tpu_torch.segment as tseg

ROWS = 3000

QUERIES = {
    "aggregation": "SELECT SUM(v), COUNT(*), AVG(d), MIN(v), MAX(d) "
                   "FROM t WHERE v > 100",
    "groupby_sketches": "SELECT k, DISTINCTCOUNTHLL(v), "
                        "PERCENTILETDIGEST(d, 90), DISTINCTCOUNT(v), "
                        "SUM(v) FROM t GROUP BY k",
    "groupby_percentile": "SELECT k, PERCENTILE(v, 50), AVG(d) FROM t "
                          "GROUP BY k",
    "distinct": "SELECT DISTINCTCOUNT(k), DISTINCTCOUNTHLL(v) FROM t",
    "selection": "SELECT k, v, d FROM t WHERE v < 400 ORDER BY v, k "
                 "LIMIT 50",
    "selection_unordered": "SELECT k, v FROM t WHERE v < 40 LIMIT 30",
    "empty_groupby": "SELECT k, SUM(v) FROM t WHERE v < 0 GROUP BY k",
    "empty_aggregation": "SELECT SUM(v), COUNT(*) FROM t WHERE v < 0",
}


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    rng = np.random.default_rng(14)
    schema = jspi.Schema("t", [
        jspi.FieldSpec("k", jspi.DataType.STRING),
        jspi.FieldSpec("v", jspi.DataType.INT, jspi.FieldType.METRIC),
        jspi.FieldSpec("d", jspi.DataType.DOUBLE, jspi.FieldType.METRIC)])
    out = str(tmp_path_factory.mktemp("datablock"))
    builder = jseg.SegmentBuilder(schema, jspi.TableConfig("t"))
    dirs = []
    for i in range(2):
        cols = {"k": rng.choice(["east", "west", "north", "süd"],
                                ROWS),
                "v": rng.integers(0, 5000, ROWS).astype(np.int32),
                "d": rng.normal(10.0, 3.0, ROWS)}
        dirs.append(builder.build(cols, out, f"s{i}"))
    return dirs


def _partials(pkg: str, dirs, sql: str):
    if pkg == "jax":
        segs = [jseg.ImmutableSegment.load(d) for d in dirs]
        ctx = jctx.build_query_context(jsql.parse_sql(sql))
        return jserving.execute_segments(ctx, segs).partials
    segs = [tseg.ImmutableSegment.load(d, "cpu") for d in dirs]
    ctx = tctx.build_query_context(tsql.parse_sql(sql))
    return tserving.execute_segments(ctx, segs).partials


def _as(mod, p):
    """The same partial as one package's class (the codecs dispatch on
    their own package's partial classes)."""
    cls = getattr(mod, type(p).__name__)
    return cls(**{f: getattr(p, f) for f in p.__dataclass_fields__})


def _close(x, y) -> None:
    """Equal partial values: integers and strings exactly, floats to a
    relative 1e-9 (the two executors may sum in another order)."""
    if isinstance(x, float) or isinstance(y, float):
        assert y == pytest.approx(x, rel=1e-9, abs=1e-12)
    elif isinstance(x, dict):
        assert sorted(map(repr, x)) == sorted(map(repr, y))
        by_repr = {repr(k): v for k, v in y.items()}
        for k, v in x.items():
            _close(v, by_repr[repr(k)])
    elif isinstance(x, (list, tuple)):
        assert type(x) is type(y) and len(x) == len(y)
        for u, v in zip(x, y):
            _close(u, v)
    elif hasattr(x, "__dataclass_fields__"):
        assert type(x).__name__ == type(y).__name__
        for f in x.__dataclass_fields__:
            _close(getattr(x, f), getattr(y, f))
    else:
        assert type(x) is type(y) and x == y


@pytest.mark.parametrize("kind", sorted(QUERIES))
def test_partials_encode_to_the_reference_bytes(segment_dirs, kind):
    """Each package's partial encodes to the same bytes (and the same
    serde JSON) in both codecs, each codec decodes the other's blocks
    and frames, and the two executors' partials agree."""
    sql = QUERIES[kind]
    jp = _partials("jax", segment_dirs, sql)
    tp = _partials("torch", segment_dirs, sql)
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        _close(a, b)
        for p in (a, b):
            jb = jdb.encode_partial(_as(jex, p))
            tb = tdb.encode_partial(_as(tex, p))
            assert tb == jb
            _close(tdb.decode_partial(jb), p)
            _close(jdb.decode_partial(tb), p)
            wire = tserde.partial_to_wire(_as(tex, p))
            assert json.dumps(wire) == json.dumps(
                jserde.partial_to_wire(_as(jex, p)))
            assert tdb.encode_partial(tserde.partial_from_wire(
                json.loads(json.dumps(wire)))) == jb
    header = {"segmentsQueried": 2, "serdeEncodeMs": 0.5}
    for parts in (jp, tp):
        jf = jdb.encode_wire_frame(header, [_as(jex, p) for p in parts])
        tparts = [_as(tex, p) for p in parts]
        assert tdb.encode_wire_frame(header, tparts) == jf
        assert tdb.encode_wire_frame_blocks(
            header, [tdb.encode_partial(p) for p in tparts]) == jf
        for decode in (tdb.decode_wire_frame, jdb.decode_wire_frame):
            h, got = decode(jf)
            assert h == header
            _close(got, parts)


def _relation(mod, with_nulls: bool):
    n = 7
    data = {
        "o.id": np.arange(n, dtype=np.int64) * 3 - 5,
        "o.price": np.linspace(-1.5, 9.25, n),
        "c.name": np.array(["a", "bb", "", "dé", "e", "f", "g"],
                           dtype=object),
        "c.tags": np.array(["x", None, "long tag " * 8, None, "s", "",
                            "t"], dtype=object),
        "c.flag": np.array([True, False] * 3 + [True]),
        "c.small": np.arange(n, dtype=np.int32),
    }
    nulls = ({"o.price": np.array([0, 1, 0, 0, 1, 0, 0], dtype=bool),
              "c.name": np.array([1, 0, 0, 0, 0, 0, 1], dtype=bool)}
             if with_nulls else {})
    return mod.Relation(data, nulls, "o")


@pytest.mark.parametrize("with_nulls", [False, True])
def test_relations_encode_to_the_reference_bytes(with_nulls):
    jr = _relation(jrel, with_nulls)
    tr = _relation(trel, with_nulls)
    jb, tb = jdb.encode_relation(jr), tdb.encode_relation(tr)
    assert tb == jb
    for raw, decode in ((jb, tdb.decode_relation),
                        (tb, jdb.decode_relation)):
        got = decode(raw)
        assert list(got.data) == list(jr.data)
        for c in jr.data:
            assert list(got.data[c]) == list(jr.data[c])
        assert sorted(got.nulls) == sorted(jr.nulls)
        for c in jr.nulls:
            assert np.array_equal(got.nulls[c], jr.nulls[c])
    # an empty relation keeps its schema on the wire
    empty = {c: v[:0] for c, v in jr.data.items()}
    assert tdb.encode_relation(trel.Relation(empty, {}, "o")) == \
        jdb.encode_relation(jrel.Relation(empty, {}, "o"))


def test_corrupt_frames_raise_alike():
    frame = tdb.encode_wire_frame({"segmentsQueried": 0}, [])
    for decode in (tdb.decode_wire_frame, jdb.decode_wire_frame):
        with pytest.raises(ValueError):
            decode(b"nope" + frame[4:])
