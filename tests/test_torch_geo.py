"""Geospatial queries: the port against the JAX package, on the CPU.

Seeded points around downtown San Francisco (``tests/test_geo.py``'s box)
go through both packages: grid cells and covers, the WKT/WKB codecs and
the geometry predicates must give equal outputs (cell ids, covers and
codecs exactly, float measures bitwise); every ST_* function equal; the
geo index's four files and metadata byte-equal; ``distance_mask`` and
``inclusion_mask`` bitwise equal on every route (cell cover, whole-plane
sweep past ``MAX_COVER_CELLS``, each comparison, a geometry and a
geography literal over a geography column, a polygon with a hole, the
negated complement); and SQL over an indexed and an unindexed table, one
and two segments, equal to the JAX broker's rows. An indexed geo filter
must plan the kernel with a ``docmask`` param.
"""
import os

import numpy as np
import pytest

from pinot_tpu import geo as jgeo
from pinot_tpu.broker import Broker as JaxBroker
from pinot_tpu.geo import cells as jcells
from pinot_tpu.geo import geometry as jgeom
from pinot_tpu.query.context import build_query_context as j_ctx
from pinot_tpu.query.functions import call as jcall
from pinot_tpu.query.planner import SegmentPlanner as JPlanner
from pinot_tpu.query.sql import parse_sql as j_parse
from pinot_tpu.segment import SegmentBuilder as JaxBuilder
from pinot_tpu.server import TableDataManager as JaxTable
from pinot_tpu.spi import (IndexingConfig as JaxIndexing,
                           Schema as JaxSchema, TableConfig as JaxConfig)
from pinot_tpu_torch import geo as tgeo
from pinot_tpu_torch.broker import Broker, connect
from pinot_tpu_torch.geo import cells as tcells
from pinot_tpu_torch.geo import geometry as tgeom
from pinot_tpu_torch.index import geo as tindex
from pinot_tpu_torch.query.context import build_query_context
from pinot_tpu_torch.query.functions import call as tcall
from pinot_tpu_torch.query.planner import SegmentPlanner
from pinot_tpu_torch.query.sql import parse_sql
from pinot_tpu_torch.segment import ImmutableSegment, SegmentBuilder
from pinot_tpu_torch.server import TableDataManager
from pinot_tpu_torch.spi import (DataType, FieldSpec, FieldType,
                                 IndexingConfig, Schema, TableConfig)

from test_torch_multistage import same_rows

N = 2000
LAT0, LNG0 = 37.77, -122.42
RES = 13
POLY = (f"POLYGON (({LNG0 - 0.05} {LAT0 - 0.05}, {LNG0 + 0.02} "
        f"{LAT0 - 0.05}, {LNG0 + 0.02} {LAT0 + 0.03}, {LNG0 - 0.05} "
        f"{LAT0 + 0.03}, {LNG0 - 0.05} {LAT0 - 0.05}), "
        f"({LNG0 - 0.02} {LAT0 - 0.02}, {LNG0} {LAT0 - 0.02}, {LNG0} "
        f"{LAT0}, {LNG0 - 0.02} {LAT0}, {LNG0 - 0.02} {LAT0 - 0.02}))")
# a box of 4 x 4 degrees: its cover at RES passes MAX_COVER_CELLS
WIDE_POLY = (f"POLYGON (({LNG0 - 2} {LAT0 - 2}, {LNG0 + 2} "
             f"{LAT0 - 2}, {LNG0 + 2} {LAT0 + 2}, {LNG0 - 2} "
             f"{LAT0 + 2}, {LNG0 - 2} {LAT0 - 2}))")
SWEEP_M = 300_000.0     # a radius whose cover at RES passes it too


def _points(seed: int = 7, n: int = N):
    rng = np.random.default_rng(seed)
    lat = LAT0 + rng.uniform(-0.1, 0.1, n)
    lng = LNG0 + rng.uniform(-0.1, 0.1, n)
    return rng, lat, lng


@pytest.fixture(scope="module")
def geo_data():
    rng, lat, lng = _points()
    vals = [jgeom.to_wkb(jgeom.Geometry.point(x, y, True)).hex()
            for x, y in zip(lng, lat)]
    # empty and blank rows rank with nulls; one point as WKT text and one
    # as big-endian WKB take the per-row decode (undecodable rows, which
    # the host path refuses, are in test_index_build_edges_equal)
    vals[5] = ""
    vals[17] = "  "
    vals[41] = f"POINT ({lng[41]} {lat[41]})"
    be = bytearray(jgeom.to_wkb(jgeom.Geometry.point(lng[52], lat[52])))
    vals[52] = (b"\x00" + be[1:5][::-1] + bytes(be[5:13][::-1])
                + bytes(be[13:21][::-1])).hex()
    # drop-off points: every row valid, so ST_* in the select list and
    # GEOTOH3 evaluate over the whole dictionary
    drop = [jgeom.to_wkb(jgeom.Geometry.point(x + 0.01, y - 0.01, True)
                         ).hex() for x, y in zip(lng, lat)]
    return {"lat": lat, "lng": lng,
            "loc": np.asarray(vals, dtype=object),
            "drop": np.asarray(drop, dtype=object),
            "zone": rng.integers(0, 12, N).astype(np.int32),
            "fare": rng.integers(1, 500, N).astype(np.int64)}


FIELDS = (("loc", "BYTES", "DIMENSION"), ("drop", "BYTES", "DIMENSION"),
          ("zone", "INT", "DIMENSION"),
          ("fare", "LONG", "METRIC"))


def _build(pkg: str, data, out: str, indexed: bool, segments: int):
    """-> a broker of package ``pkg`` ("jax" or "torch") over table geo."""
    if pkg == "jax":
        from pinot_tpu.spi import DataType as D, FieldSpec as F, \
            FieldType as FT
        schema = JaxSchema("geo", [F(n, D[t], FT[k]) for n, t, k in FIELDS])
        idx = JaxIndexing(geo_index_columns={"loc": {"resolution": RES}}) \
            if indexed else JaxIndexing()
        builder = JaxBuilder(schema, JaxConfig("geo", indexing=idx))
        dm, b = JaxTable("geo"), JaxBroker()
    else:
        schema = Schema("geo", [FieldSpec(n, DataType[t], FieldType[k])
                                for n, t, k in FIELDS])
        idx = IndexingConfig(geo_index_columns={"loc": {
            "resolution": RES}}) if indexed else IndexingConfig()
        builder = SegmentBuilder(schema, TableConfig("geo", indexing=idx))
        dm, b = TableDataManager("geo", device="cpu"), Broker(device="cpu")
    bounds = np.linspace(0, N, segments + 1).astype(int)
    for i in range(segments):
        sl = slice(bounds[i], bounds[i + 1])
        dm.add_segment_dir(builder.build(
            {k: data[k][sl] for k, _t, _k in FIELDS}, out, f"s{i}"))
    b.register_table(dm)
    return b


@pytest.fixture(scope="module")
def brokers(geo_data, tmp_path_factory):
    """{(indexed, segments): (jax broker, port broker)}."""
    out = {}
    for indexed in (True, False):
        for segs in (1, 2):
            base = tmp_path_factory.mktemp(f"geo_{indexed}_{segs}")
            out[indexed, segs] = (
                _build("jax", geo_data, str(base / "jax"), indexed, segs),
                _build("torch", geo_data, str(base / "torch"), indexed,
                       segs))
    return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _cell_cases():
    _rng, lat, lng = _points(3, 500)
    lat = np.concatenate([lat, [90.0, -90.0, 0.0, 45.5]])
    lng = np.concatenate([lng, [180.0, -180.0, 359.0, -0.0]])
    return lat, lng


@pytest.mark.parametrize("res", [0, 5, RES, 20, 26])
def test_cells_equal(res):
    lat, lng = _cell_cases()
    jc = jcells.lat_lng_to_cell(lat, lng, res)
    tc = tcells.lat_lng_to_cell(lat, lng, res)
    np.testing.assert_array_equal(tc, jc)
    for a, b in zip(tcells.cell_bounds(tc), jcells.cell_bounds(jc)):
        np.testing.assert_array_equal(a, b)
    for r in range(0, res + 1, max(1, res // 3)):
        np.testing.assert_array_equal(tcells.parent(tc, r),
                                      jcells.parent(jc, r))
    np.testing.assert_array_equal(
        tcells.haversine_m(lat, lng, LAT0, LNG0),
        jcells.haversine_m(lat, lng, LAT0, LNG0))
    assert tcells.pick_resolution(500.0 * (res + 1), 40.0) == \
        jcells.pick_resolution(500.0 * (res + 1), 40.0)


@pytest.mark.parametrize("radius,res", [(50.0, 20), (2000.0, RES),
                                        (5000.0, 12), (SWEEP_M, RES),
                                        (1e7, 3)])
def test_cover_circle_equal(radius, res):
    jc = jcells.cover_circle(LAT0, LNG0, radius, res, cap=8192)
    tc = tcells.cover_circle(LAT0, LNG0, radius, res, cap=8192)
    if jc is None:
        assert tc is None
        return
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wkt,res", [(POLY, RES), (POLY, 16),
                                     (WIDE_POLY, RES), (WIDE_POLY, 8)])
def test_cover_polygon_equal(wkt, res):
    jg, tg = jgeom.parse_wkt(wkt), tgeom.parse_wkt(wkt)
    jc = jcells.cover_polygon(jg.coords, res, cap=8192, holes=jg.holes)
    tc = tcells.cover_polygon(tg.coords, res, cap=8192, holes=tg.holes)
    if jc is None:
        assert tc is None
        return
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

WKTS = ["POINT (-122.42 37.77)", "POINT (1e-7 -3.25)",
        "LINESTRING (0 0, 1 1, 2 0.5)", POLY, WIDE_POLY,
        "POLYGON ((0 0, 10 0, 10 10, 0 10))"]


@pytest.mark.parametrize("wkt", WKTS)
@pytest.mark.parametrize("geography", [False, True])
def test_codecs_equal(wkt, geography):
    jg = jgeom.parse_wkt(wkt, geography)
    tg = tgeom.parse_wkt(wkt, geography)
    assert tgeom.to_wkt(tg) == jgeom.to_wkt(jg)
    wkb = jgeom.to_wkb(jg)
    assert tgeom.to_wkb(tg) == wkb
    back = tgeom.parse_wkb(wkb)
    assert back.geography == geography and back == tg
    assert tgeom.to_wkb(tgeom.coerce(wkb.hex())) == wkb
    assert tgeom.to_wkb(tgeom.coerce(tgeom.to_wkt(tg), geography)) == \
        jgeom.to_wkb(jgeom.coerce(jgeom.to_wkt(jg), geography))
    assert tgeo.area(tg) == jgeo.area(jg)
    assert tg.type_name() == jg.type_name()


@pytest.mark.parametrize("geography", [False, True])
def test_predicates_equal(geography):
    _rng, lat, lng = _points(5, 300)
    for wkt in WKTS:
        jg = jgeom.parse_wkt(wkt, geography)
        tg = tgeom.parse_wkt(wkt, geography)
        if tg.kind == "polygon":
            np.testing.assert_array_equal(
                tgeom.points_in_polygon(lng, lat, tg),
                jgeom.points_in_polygon(lng, lat, jg))
        for x, y in zip(lng[:20], lat[:20]):
            jp = jgeom.Geometry.point(x, y, geography)
            tp = tgeom.Geometry.point(x, y, geography)
            assert tgeo.distance(tp, tg) == jgeo.distance(jp, jg)
            assert tgeo.distance(tg, tp) == jgeo.distance(jg, jp)
            assert tgeo.contains(tg, tp) == jgeo.contains(jg, jp)
    for a in WKTS[2:]:
        for b in WKTS[2:]:
            assert tgeo.distance(tgeom.parse_wkt(a), tgeom.parse_wkt(b)) \
                == jgeo.distance(jgeom.parse_wkt(a), jgeom.parse_wkt(b))


def _st_calls():
    pts = np.array([LNG0, 5.0, 15.0, -73.98]), \
        np.array([LAT0, 5.0, 5.0, 40.75])
    poly = np.array(["POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))", POLY],
                    dtype=object)
    return [
        ("stpoint", (pts[0], pts[1])),
        ("stpoint", (pts[0], pts[1], np.array([1]))),
        ("stgeogfromtext", (np.array(["POINT (-122.41 37.77)", POLY],
                                     dtype=object),)),
        ("stgeomfromtext", (poly,)),
        ("geotoh3", (pts[0], pts[1], np.array([12]))),
    ]


def _outcome(fn, *args):
    """(value, None) or (None, (error class name, message)): the two
    packages raise their own classes of the same name."""
    try:
        return fn(*args), None
    except Exception as e:  # noqa: BLE001 — compared, not swallowed
        return None, (type(e).__name__, str(e))


@pytest.mark.parametrize("i", range(5))
def test_st_functions_equal(i):
    name, args = _st_calls()[i]
    got, want = tcall(name, *args), jcall(name, *args)
    np.testing.assert_array_equal(got, want)
    # every consumer of this output agrees too
    for fn in ("stastext", "stasbinary", "stgeometrytype", "starea",
               "stgeogfromwkb", "stgeomfromwkb"):
        if name == "geotoh3":
            break
        np.testing.assert_array_equal(tcall(fn, got), jcall(fn, want))
    if name == "geotoh3":
        return
    other = jcall("stgeogfromtext", np.array(["POINT (-122.41 37.77)"],
                                             dtype=object))
    box = jcall("stgeomfromtext", np.array(
        ["POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))"], dtype=object))
    for fn, a, b in (("stdistance", got, other), ("stdistance", other, got),
                     ("stcontains", box, got), ("stwithin", got, box),
                     ("stequals", got, got[:1]), ("geotoh3", got, [10])):
        want_v, want_err = _outcome(jcall, fn, a, b)
        got_v, got_err = _outcome(tcall, fn, a, b)
        assert got_err == want_err
        if want_err is None:
            np.testing.assert_array_equal(got_v, want_v)


# ---------------------------------------------------------------------------
# the index: files and masks
# ---------------------------------------------------------------------------

def _seg_dirs(b):
    return [s.dir for s in b.table("geo").acquire_segments()]


def test_index_files_byte_equal(brokers):
    for segs in (1, 2):
        jb, tb = brokers[True, segs]
        for jd, td in zip(_seg_dirs(jb), _seg_dirs(tb)):
            files = sorted(f for f in os.listdir(jd) if ".geo." in f)
            assert files == sorted(f for f in os.listdir(td)
                                   if ".geo." in f)
            assert len(files) == 4
            for f in files:
                with open(os.path.join(jd, f), "rb") as a, \
                        open(os.path.join(td, f), "rb") as b:
                    assert a.read() == b.read(), f
            import json
            with open(os.path.join(jd, "metadata.json")) as a, \
                    open(os.path.join(td, "metadata.json")) as b:
                assert json.load(a)["columns"]["loc"]["indexes"] == \
                    json.load(b)["columns"]["loc"]["indexes"]


@pytest.mark.parametrize("values,err", [
    (["POINT (1 2)", "POLYGON ((0 0, 1 0, 1 1, 0 1, 0 0))"], "POINT"),
    (["", None, float("nan"), b"", "zz", "zz" * 21, "POINT (1 2)"], None),
    ([jgeom.to_wkb(jgeom.Geometry.point(3.0, 4.0)),
      jgeom.to_wkb(jgeom.Geometry.point(3.0, 4.5, True)).hex()], None),
])
def test_index_build_edges_equal(tmp_path, values, err):
    from pinot_tpu.index import geo as jindex
    vals = np.asarray(values, dtype=object)
    if err:
        for mod in (jindex, tindex):
            with pytest.raises(ValueError, match=err) as e:
                mod.build("g", str(tmp_path), values=vals, resolution=RES)
            msg = str(e.value)
        with pytest.raises(ValueError) as je:
            jindex.build("g", str(tmp_path), values=vals, resolution=RES)
        assert msg == str(je.value)
        return
    for pkg, mod in (("j", jindex), ("t", tindex)):
        os.makedirs(tmp_path / pkg)
        meta = mod.build("g", str(tmp_path / pkg), values=vals,
                         resolution=RES)
        assert meta == jindex.build("g", str(tmp_path / pkg), values=vals,
                                    resolution=RES)
    for f in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f


def _readers(brokers):
    jb, tb = brokers[True, 1]
    jseg = jb.table("geo").acquire_segments()[0]
    tseg = tb.table("geo").acquire_segments()[0]
    return jseg.index_reader("loc", "geo"), tseg.index_reader("loc", "geo"), \
        tseg.n_docs


@pytest.mark.parametrize("op", ["<", "<=", ">", ">="])
@pytest.mark.parametrize("radius", [700.0, 4000.0, SWEEP_M])
@pytest.mark.parametrize("literal", ["geography", "geometry"])
def test_distance_mask_equal(brokers, op, radius, literal):
    jr, tr, n = _readers(brokers)
    g = literal == "geography"
    point = jgeom.to_wkb(jgeom.Geometry.point(LNG0, LAT0, g)).hex()
    want = jr.distance_mask(point, radius, op, n)
    got = tr.distance_mask(point, radius, op, n)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    if radius == SWEEP_M and op in ("<", "<="):
        # the cover would pass MAX_COVER_CELLS: the sweep route
        assert tcells.cover_circle(LAT0, LNG0, radius, tr.resolution,
                                   cap=tindex.MAX_COVER_CELLS) is None


def test_reader_without_metadata_defaults_to_geography(brokers):
    _jr, tr, n = _readers(brokers)
    seg_dir = _seg_dirs(brokers[True, 1][1])[0]
    from pinot_tpu.index.geo import GeoIndexReader as JReader
    jr = JReader(seg_dir, "loc", {"resolution": RES})
    bare = tindex.GeoIndexReader(seg_dir, "loc", {"resolution": RES})
    assert bare.geography and jr.geography
    np.testing.assert_array_equal(
        bare.distance_mask("POINT (-122.42 37.77)", 3000.0, "<", n),
        jr.distance_mask("POINT (-122.42 37.77)", 3000.0, "<", n))


@pytest.mark.parametrize("wkt", [POLY, WIDE_POLY])
@pytest.mark.parametrize("positive", [True, False])
def test_inclusion_mask_equal(brokers, wkt, positive):
    jr, tr, n = _readers(brokers)
    want = jr.inclusion_mask(wkt, n, positive=positive)
    got = tr.inclusion_mask(wkt, n, positive=positive)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tr.valid_mask(n), jr.valid_mask(n))
    g = tgeom.parse_wkt(wkt)
    swept = tcells.cover_polygon(g.coords, RES, cap=tindex.MAX_COVER_CELLS,
                                 holes=g.holes) is None
    assert swept == (wkt == WIDE_POLY)
    if not positive:
        # the plain complement: null points match "= 0"
        assert got[~tr.valid_mask(n)].all()


# ---------------------------------------------------------------------------
# SQL through both brokers
# ---------------------------------------------------------------------------

PT = f"ST_POINT({LNG0}, {LAT0}, 1)"
SQL = {
    "dist_sum": f"SELECT COUNT(*), SUM(fare) FROM geo WHERE "
                f"ST_DISTANCE(loc, {PT}) < 4000",
    "dist_le_geometry": "SELECT COUNT(*) FROM geo WHERE ST_DISTANCE(loc, "
                        f"'POINT ({LNG0} {LAT0})') <= 2500",
    "dist_ge": f"SELECT COUNT(*), MAX(fare) FROM geo WHERE "
               f"ST_DISTANCE(loc, {PT}) >= 4000",
    "dist_gb": f"SELECT zone, COUNT(*), SUM(fare) FROM geo WHERE "
               f"ST_DISTANCE(loc, {PT}) < 5000 GROUP BY zone ORDER BY zone "
               "LIMIT 100",
    "sweep": f"SELECT COUNT(*) FROM geo WHERE ST_DISTANCE(loc, {PT}) "
             f"< {SWEEP_M}",
    "within": f"SELECT zone, COUNT(*) FROM geo WHERE ST_WITHIN(loc, "
              f"ST_GEOM_FROM_TEXT('{POLY}')) = 1 GROUP BY zone ORDER BY "
              "zone LIMIT 100",
    "within_not": f"SELECT zone, COUNT(*) FROM geo WHERE ST_WITHIN(loc, "
                  f"ST_GEOM_FROM_TEXT('{POLY}')) = 0 GROUP BY zone ORDER BY "
                  "zone LIMIT 100",
    "contains_bare": "SELECT COUNT(*) FROM geo WHERE ST_CONTAINS("
                     f"ST_GEOM_FROM_TEXT('{WIDE_POLY}'), loc)",
    "contains_and": "SELECT SUM(fare) FROM geo WHERE ST_CONTAINS("
                    f"ST_GEOM_FROM_TEXT('{POLY}'), loc) = 1 AND zone < 6",
    "st_select": f"SELECT ST_ASTEXT(drop), ST_DISTANCE(drop, {PT}), fare "
                 f"FROM geo WHERE ST_DISTANCE(loc, {PT}) < 600 ORDER BY fare, "
                 "ST_ASTEXT(drop) LIMIT 20",
    "st_union": "SELECT ST_UNION(ST_ASTEXT(drop)) FROM geo WHERE "
                f"ST_DISTANCE(loc, {PT}) < 1000",
    "h3_gb": "SELECT GEOTOH3(drop, 10), COUNT(*) FROM geo WHERE "
             f"ST_DISTANCE(loc, {PT}) < 2000 GROUP BY GEOTOH3(drop, 10) "
             "ORDER BY GEOTOH3(drop, 10) LIMIT 100",
    "h3_nulls": "SELECT COUNT(*) FROM geo WHERE GEOTOH3(loc, 10) > 0",
}


@pytest.mark.parametrize("indexed,segs", [(True, 1), (True, 2),
                                           (False, 2)])
@pytest.mark.parametrize("name", sorted(SQL))
def test_sql_rows_match_jax(brokers, name, indexed, segs, monkeypatch):
    monkeypatch.setenv("PINOT_CPU_FAST_GROUPBY", "1")
    jb, tb = brokers[indexed, segs]
    got, got_err = _outcome(lambda q: connect(tb)(q).rows, SQL[name])
    want, want_err = _outcome(lambda q: jb.query(q).rows, SQL[name])
    # GEOTOH3 over a column with null rows raises in both packages
    assert got_err == want_err and (want_err is None) == (name != "h3_nulls")
    if want_err is None:
        same_rows(got, want)


@pytest.mark.parametrize("name", ["dist_sum", "dist_gb", "sweep", "within",
                                  "within_not", "contains_bare"])
def test_indexed_filter_plans_kernel_docmask(brokers, name):
    _jb, tb = brokers[True, 1]
    seg = tb.table("geo").acquire_segments()[0]
    plan = SegmentPlanner(build_query_context(parse_sql(SQL[name])),
                          seg).plan()
    assert plan.kind == "kernel"
    assert any(isinstance(p, tuple) and p[0] == "docmask"
               for p in plan.params)
    # without the index the ST_* function is evaluated over the column's
    # dictionary into an id set (no docmask), in both packages
    jb, ub = brokers[False, 1]
    uplan = SegmentPlanner(build_query_context(parse_sql(SQL[name])),
                           ub.table("geo").acquire_segments()[0]).plan()
    jplan = JPlanner(j_ctx(j_parse(SQL[name])),
                     jb.table("geo").acquire_segments()[0]).plan()
    assert uplan.kind == jplan.kind
    assert not any(isinstance(p, tuple) and p[0] == "docmask"
                   for p in uplan.params)


def test_st_union_over_points_matches_jax(brokers):
    """ST_UNION over WKT points answers the reference's MULTIPOINT; over
    the hex-WKB column itself both packages raise alike."""
    jb, tb = brokers[False, 1]
    rows = connect(tb)(SQL["st_union"]).rows
    assert rows == jb.query(SQL["st_union"]).rows
    assert rows[0][0].startswith("MULTIPOINT (")
    bad = SQL["st_union"].replace("ST_ASTEXT(drop)", "drop")
    got, got_err = _outcome(lambda q: connect(tb)(q).rows, bad)
    want, want_err = _outcome(lambda q: jb.query(q).rows, bad)
    assert (got, got_err) == (want, want_err)


def test_geo_segment_loads_reader(brokers, tmp_path):
    seg = ImmutableSegment.load(_seg_dirs(brokers[True, 1][1])[0], "cpu")
    rd = seg.index_reader("loc", "geo")
    assert isinstance(rd, tindex.GeoIndexReader) and rd.resolution == RES
    assert rd.geography


@pytest.mark.parametrize("name", ["dist_gb", "within", "within_not"])
def test_geo_plans_never_fuse_into_a_cube(brokers, name):
    """A cube answers every literal variant from one literal-free build,
    so a per-query doc mask cannot ride in it: the micro-batcher refuses
    the geo plans and serves them solo."""
    from pinot_tpu_torch.engine.ragged import cube_spec_for

    _jb, tb = brokers[True, 2]
    plan = SegmentPlanner(build_query_context(parse_sql(SQL[name])),
                          tb.table("geo").acquire_segments()[0]).plan()
    assert plan.kind == "kernel"
    assert cube_spec_for(plan) == (None, "incompatible")
