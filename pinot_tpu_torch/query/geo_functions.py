"""Geospatial scalar functions (the ST_* family).

Port of ``pinot_tpu/query/geo_functions.py``, copied line for line.
Reference system: pinot-core/src/main/java/org/apache/pinot/core/
geospatial/transform/function/ — StPointFunction, StDistanceFunction,
StContainsFunction, StWithinFunction, StAreaFunction, StAsTextFunction,
StAsBinaryFunction, StGeogFromTextFunction, StGeomFromTextFunction,
StGeogFromWKBFunction, StGeomFromWKBFunction, StGeometryTypeFunction,
StEqualsFunction, GeoToH3Function — plus ScalarFunctions.java (the
v2-engine scalar mirror). Function NAMES match the reference's SQL
surface (stPoint, stDistance, ..., geoToH3) so queries port verbatim;
geoToH3 returns this framework's grid cell id (geo/cells.py), the drop-in
role H3 ids play in the reference.

Vectorization: columns arrive as object arrays of WKB-hex/WKT; geometry
decoding happens once per array, and point-only arrays collapse to
lng/lat float64 planes so stDistance over a column is one haversine
sweep (no per-row python in the hot path). Dictionary-encoded columns
additionally evaluate once per dictionary value (host_eval's gather).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..geo import cells as _cells
from ..geo import geometry as _geom
from ..geo.geometry import Geometry
from .functions import register
from .sql import SqlError


def _to_geoms(v, geography: Optional[bool] = None) -> List[Geometry]:
    a = np.atleast_1d(np.asarray(v, dtype=object))
    return [_geom.coerce(x, geography) for x in a.ravel()]


def _point_planes(gs: List[Geometry]
                  ) -> Optional[Tuple[np.ndarray, np.ndarray, bool]]:
    """(lng, lat, geography) planes when every geometry is a point."""
    if not all(g is not None and g.kind == "point" for g in gs):
        return None
    lng = np.fromiter((g.lng for g in gs), dtype=np.float64, count=len(gs))
    lat = np.fromiter((g.lat for g in gs), dtype=np.float64, count=len(gs))
    return lng, lat, any(g.geography for g in gs)


def _obj(items) -> np.ndarray:
    out = np.empty(len(items), dtype=object)
    out[:] = items
    return out


@register("stpoint", 2, 3)
def _st_point(x, y, geog=None):
    xs = np.atleast_1d(np.asarray(x, dtype=np.float64))
    ys = np.atleast_1d(np.asarray(y, dtype=np.float64))
    xs, ys = np.broadcast_arrays(xs, ys)
    g = bool(np.atleast_1d(np.asarray(geog))[0]) if geog is not None \
        else False
    return _obj([_geom.to_wkb(Geometry.point(float(a), float(b), g)).hex()
                 for a, b in zip(xs.ravel(), ys.ravel())])


def _from_text(v, geography: bool) -> np.ndarray:
    a = np.atleast_1d(np.asarray(v, dtype=object))
    return _obj([_geom.to_wkb(_geom.parse_wkt(str(t), geography)).hex()
                 for t in a.ravel()])


def _from_wkb(v, geography: bool) -> np.ndarray:
    gs = _to_geoms(v, geography)
    return _obj([_geom.to_wkb(g).hex() for g in gs])


register("stgeogfromtext", 1)(lambda v: _from_text(v, True))
register("stgeomfromtext", 1)(lambda v: _from_text(v, False))
register("stgeogfromwkb", 1)(lambda v: _from_wkb(v, True))
register("stgeomfromwkb", 1)(lambda v: _from_wkb(v, False))


@register("stastext", 1)
def _st_as_text(v):
    return _obj([_geom.to_wkt(g) for g in _to_geoms(v)])


@register("stasbinary", 1)
def _st_as_binary(v):
    return _obj([_geom.to_wkb(g).hex() for g in _to_geoms(v)])


@register("stgeometrytype", 1)
def _st_geometry_type(v):
    return _obj([g.type_name() for g in _to_geoms(v)])


@register("stdistance", 2)
def _st_distance(a, b):
    ga = _to_geoms(a)
    gb = _to_geoms(b)
    if len(ga) == 1 and len(gb) > 1:
        ga, gb = gb, ga
    pa = _point_planes(ga)
    if pa is not None and len(gb) == 1 and gb[0] is not None \
            and gb[0].kind == "point":
        q = gb[0]
        geog = pa[2] or q.geography
        if geog:
            return _cells.haversine_m(pa[1], pa[0], q.lat, q.lng)
        return np.hypot(pa[0] - q.lng, pa[1] - q.lat)
    if len(gb) == 1:
        gb = gb * len(ga)
    return np.asarray([_geom.distance(x, y) if x and y else np.nan
                       for x, y in zip(ga, gb)], dtype=np.float64)


def _containment(outer, inner) -> np.ndarray:
    go = _to_geoms(outer)
    gi = _to_geoms(inner)
    n = max(len(go), len(gi))
    if len(go) == 1:
        # literal polygon vs point column: one vectorized ray-cast
        pi = _point_planes(gi)
        if pi is not None and go[0] is not None \
                and go[0].kind == "polygon":
            m = _geom.points_in_polygon(pi[0], pi[1], go[0])
            return m.astype(np.int32)
        go = go * n
    if len(gi) == 1:
        gi = gi * n
    out = np.asarray([1 if (a and b and _geom.contains(a, b)) else 0
                      for a, b in zip(go, gi)], dtype=np.int32)
    return out


# ST_Contains(a, b): a contains b.  ST_Within(a, b): a within b.
register("stcontains", 2)(lambda a, b: _containment(a, b))
register("stwithin", 2)(lambda a, b: _containment(b, a))


@register("stequals", 2)
def _st_equals(a, b):
    ga = _to_geoms(a)
    gb = _to_geoms(b)
    n = max(len(ga), len(gb))
    if len(ga) == 1:
        ga = ga * n
    if len(gb) == 1:
        gb = gb * n
    return np.asarray([1 if (x and y and x == y) else 0
                       for x, y in zip(ga, gb)], dtype=np.int32)


@register("starea", 1)
def _st_area(v):
    return np.asarray([_geom.area(g) if g else np.nan
                       for g in _to_geoms(v)], dtype=np.float64)


@register("geotoh3", 2, 3)
def _geo_to_h3(*args):
    """geoToH3(geometry, res) | geoToH3(lng, lat, res) -> grid cell id."""
    if len(args) == 3:
        lng, lat, res = args
        lngs = np.atleast_1d(np.asarray(lng, dtype=np.float64))
        lats = np.atleast_1d(np.asarray(lat, dtype=np.float64))
        r = int(np.atleast_1d(np.asarray(res))[0])
        return _cells.lat_lng_to_cell(lats, lngs, r).astype(np.int64)
    v, res = args
    r = int(np.atleast_1d(np.asarray(res))[0])
    pts = _point_planes(_to_geoms(v))
    if pts is None:
        raise SqlError("geoToH3 needs point geometries")
    return _cells.lat_lng_to_cell(pts[1], pts[0], r).astype(np.int64)
