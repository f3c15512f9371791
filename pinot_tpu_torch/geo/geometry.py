"""Geometry model: WKT/WKB codecs + vectorized spatial predicates.

Port of ``pinot_tpu/geo/geometry.py``, copied line for line. The
reference system stores geometry as serialized bytes and evaluates ST_*
transform functions over them (pinot-core/.../geospatial/transform/
function/, GeometryUtils / GeometrySerializer). The geometry/geography
split is kept: *geometry* lives on a Cartesian plane (ST_Distance in
coordinate units, shoelace area), *geography* on the sphere (haversine
meters, spherical excess area), as StDistanceFunction.java does.

Geometry columns are decoded once at index build into lng/lat planes
(index/geo.py), so query-time math is vector arithmetic; the codecs here
are the interchange layer (little-endian WKB for POINT/LINESTRING/
POLYGON, WKT text).
"""
from __future__ import annotations

import math
import struct
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .cells import EARTH_RADIUS_M, haversine_m

_WKB_POINT, _WKB_LINESTRING, _WKB_POLYGON = 1, 2, 3
# geography bit: the reference's GeometrySerializer keeps a geography
# flag outside standard WKB; we carry it in the (otherwise unused) high
# type bit so bytes round-trip losslessly while plain WKB still parses.
_GEOG_FLAG = 0x80000000


class Geometry:
    """POINT / LINESTRING / POLYGON with a geography flag.

    ``coords``: (k, 2) float64 array of (lng, lat) — WKT/WKB order.
    Polygons store shell + optional holes, each a closed (k, 2) ring.
    """
    __slots__ = ("kind", "coords", "holes", "geography")

    def __init__(self, kind: str, coords, holes: Sequence = (),
                 geography: bool = False):
        self.kind = kind
        self.coords = np.atleast_2d(np.asarray(coords, dtype=np.float64))
        self.holes = [np.atleast_2d(np.asarray(h, dtype=np.float64))
                      for h in holes]
        self.geography = bool(geography)

    # -- constructors -------------------------------------------------
    @staticmethod
    def point(lng: float, lat: float, geography: bool = False) -> "Geometry":
        return Geometry("point", [(lng, lat)], geography=geography)

    # -- accessors ----------------------------------------------------
    @property
    def lng(self) -> float:
        return float(self.coords[0, 0])

    @property
    def lat(self) -> float:
        return float(self.coords[0, 1])

    def type_name(self) -> str:
        return {"point": "Point", "linestring": "LineString",
                "polygon": "Polygon"}[self.kind]

    def __eq__(self, other) -> bool:
        return (isinstance(other, Geometry) and self.kind == other.kind
                and self.coords.shape == other.coords.shape
                and np.allclose(self.coords, other.coords)
                and len(self.holes) == len(other.holes)
                and all(a.shape == b.shape and np.allclose(a, b)
                        for a, b in zip(self.holes, other.holes)))

    def __hash__(self):  # pragma: no cover - dict keying only
        return hash((self.kind, self.coords.tobytes()))

    def __repr__(self) -> str:
        return f"Geometry({to_wkt(self)!r}, geography={self.geography})"


# ---------------------------------------------------------------------------
# WKT
# ---------------------------------------------------------------------------

def _fmt(v: float) -> str:
    return f"{v:.10g}"


def to_wkt(g: Geometry) -> str:
    if g.kind == "point":
        return f"POINT ({_fmt(g.lng)} {_fmt(g.lat)})"
    ring = lambda r: "(" + ", ".join(  # noqa: E731
        f"{_fmt(x)} {_fmt(y)}" for x, y in r) + ")"
    if g.kind == "linestring":
        return "LINESTRING " + ring(g.coords)
    rings = [ring(g.coords)] + [ring(h) for h in g.holes]
    return "POLYGON (" + ", ".join(rings) + ")"


def parse_wkt(text: str, geography: bool = False) -> Geometry:
    s = text.strip()
    up = s.upper()

    def nums(body: str) -> np.ndarray:
        pts = []
        for pair in body.split(","):
            parts = pair.split()
            if len(parts) < 2:
                raise ValueError(f"bad WKT coordinate {pair!r}")
            pts.append((float(parts[0]), float(parts[1])))
        return np.asarray(pts, dtype=np.float64)

    def body_of(prefix: str) -> str:
        inner = s[len(prefix):].strip()
        if not (inner.startswith("(") and inner.endswith(")")):
            raise ValueError(f"malformed WKT: {text!r}")
        return inner[1:-1]

    if up.startswith("POINT"):
        c = nums(body_of(s[:5]))
        if len(c) != 1:
            raise ValueError(f"POINT needs one coordinate: {text!r}")
        return Geometry("point", c, geography=geography)
    if up.startswith("LINESTRING"):
        return Geometry("linestring", nums(body_of(s[:10])),
                        geography=geography)
    if up.startswith("POLYGON"):
        inner = body_of(s[:7])
        rings: List[np.ndarray] = []
        depth = 0
        start = None
        for i, ch in enumerate(inner):
            if ch == "(":
                depth += 1
                start = i + 1
            elif ch == ")":
                depth -= 1
                rings.append(nums(inner[start:i]))
        if not rings:
            raise ValueError(f"POLYGON needs a shell: {text!r}")
        rings = [_close_ring(r) for r in rings]
        return Geometry("polygon", rings[0], rings[1:],
                        geography=geography)
    raise ValueError(f"unsupported WKT geometry: {text!r}")


def _close_ring(r: np.ndarray) -> np.ndarray:
    if len(r) < 3:
        raise ValueError("polygon ring needs >= 3 points")
    if not np.array_equal(r[0], r[-1]):
        r = np.vstack([r, r[:1]])
    return r


# ---------------------------------------------------------------------------
# WKB (standard little-endian; geography carried in the high type bit)
# ---------------------------------------------------------------------------

def to_wkb(g: Geometry) -> bytes:
    t = {"point": _WKB_POINT, "linestring": _WKB_LINESTRING,
         "polygon": _WKB_POLYGON}[g.kind]
    if g.geography:
        t |= _GEOG_FLAG
    out = [struct.pack("<BI", 1, t)]
    if g.kind == "point":
        out.append(struct.pack("<dd", g.lng, g.lat))
    elif g.kind == "linestring":
        out.append(struct.pack("<I", len(g.coords)))
        out.append(np.ascontiguousarray(g.coords).tobytes())
    else:
        rings = [g.coords] + list(g.holes)
        out.append(struct.pack("<I", len(rings)))
        for r in rings:
            out.append(struct.pack("<I", len(r)))
            out.append(np.ascontiguousarray(r).tobytes())
    return b"".join(out)


def parse_wkb(raw: bytes) -> Geometry:
    if len(raw) < 5:
        raise ValueError("truncated WKB")
    order = raw[0]
    fmt = "<" if order == 1 else ">"
    (t,) = struct.unpack_from(fmt + "I", raw, 1)
    geography = bool(t & _GEOG_FLAG)
    t &= 0x7FFFFFFF
    off = 5

    def read_ring(off: int) -> Tuple[np.ndarray, int]:
        (k,) = struct.unpack_from(fmt + "I", raw, off)
        off += 4
        arr = np.frombuffer(raw, dtype=fmt + "f8", count=2 * k,
                            offset=off).reshape(k, 2)
        return arr.astype(np.float64), off + 16 * k

    if t == _WKB_POINT:
        x, y = struct.unpack_from(fmt + "dd", raw, off)
        return Geometry("point", [(x, y)], geography=geography)
    if t == _WKB_LINESTRING:
        arr, _ = read_ring(off)
        return Geometry("linestring", arr, geography=geography)
    if t == _WKB_POLYGON:
        (nr,) = struct.unpack_from(fmt + "I", raw, off)
        off += 4
        rings = []
        for _ in range(nr):
            r, off = read_ring(off)
            rings.append(r)
        return Geometry("polygon", rings[0], rings[1:], geography=geography)
    raise ValueError(f"unsupported WKB geometry type {t}")


def coerce(value: Union[Geometry, str, bytes, None],
           geography: Optional[bool] = None) -> Optional[Geometry]:
    """Accept Geometry | WKT str | WKB bytes | WKB-hex str -> Geometry."""
    if value is None:
        return None
    if isinstance(value, float) and math.isnan(value):
        return None
    if isinstance(value, Geometry):
        g = value
    elif isinstance(value, (bytes, bytearray)):
        if not value:
            return None
        g = parse_wkb(bytes(value))
    elif isinstance(value, str):
        st = value.strip()
        if not st:
            return None
        if st[:1].upper() in ("P", "L", "M"):
            g = parse_wkt(st)
        else:
            g = parse_wkb(bytes.fromhex(st))
    else:
        raise ValueError(f"cannot coerce {type(value).__name__} to geometry")
    if geography is not None and g.geography != geography:
        g = Geometry(g.kind, g.coords, g.holes, geography)
    return g


# ---------------------------------------------------------------------------
# predicates / measures (vectorized cores)
# ---------------------------------------------------------------------------

def points_in_ring(px, py, ring: np.ndarray) -> np.ndarray:
    """Ray-cast: are (px, py) points inside the closed ring? Vectorized
    over points x edges; boundary points count as inside."""
    px = np.atleast_1d(np.asarray(px, dtype=np.float64))[:, None]
    py = np.atleast_1d(np.asarray(py, dtype=np.float64))[:, None]
    x1, y1 = ring[:-1, 0][None, :], ring[:-1, 1][None, :]
    x2, y2 = ring[1:, 0][None, :], ring[1:, 1][None, :]
    spans = (y1 > py) != (y2 > py)
    dy = y2 - y1
    dy = np.where(dy == 0.0, 1e-300, dy)
    xint = x1 + (py - y1) / dy * (x2 - x1)
    crossings = (spans & (px < xint)).sum(axis=1)
    inside = (crossings % 2).astype(bool)
    # boundary: point on an edge segment (within eps)
    minx, maxx = np.minimum(x1, x2), np.maximum(x1, x2)
    miny, maxy = np.minimum(y1, y2), np.maximum(y1, y2)
    cross = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    seg_len = np.hypot(x2 - x1, y2 - y1)
    eps = 1e-9 * np.maximum(seg_len, 1.0)
    on_edge = ((np.abs(cross) <= eps * np.maximum(seg_len, 1e-300))
               & (px >= minx - 1e-12) & (px <= maxx + 1e-12)
               & (py >= miny - 1e-12) & (py <= maxy + 1e-12))
    return inside | on_edge.any(axis=1)


def points_in_polygon(px, py, g: Geometry) -> np.ndarray:
    m = points_in_ring(px, py, g.coords)
    for h in g.holes:
        m &= ~points_in_ring(px, py, h)
    return m


def _pt_seg_dist(px, py, x1, y1, x2, y2):
    """Planar point-to-segment distance, vectorized points x segments."""
    dx, dy = x2 - x1, y2 - y1
    ll = dx * dx + dy * dy
    t = np.clip(((px - x1) * dx + (py - y1) * dy)
                / np.where(ll == 0.0, 1.0, ll), 0.0, 1.0)
    cx = x1 + t * dx
    cy = y1 + t * dy
    return np.hypot(px - cx, py - cy)


def _rings(g: Geometry) -> List[np.ndarray]:
    if g.kind == "polygon":
        return [g.coords] + list(g.holes)
    return [g.coords]


def _boundary_dist(px, py, g: Geometry) -> np.ndarray:
    px = np.atleast_1d(np.asarray(px, dtype=np.float64))[:, None]
    py = np.atleast_1d(np.asarray(py, dtype=np.float64))[:, None]
    best = None
    for r in _rings(g):
        x1, y1, x2, y2 = r[:-1, 0], r[:-1, 1], r[1:, 0], r[1:, 1]
        d = _pt_seg_dist(px, py, x1[None, :], y1[None, :],
                         x2[None, :], y2[None, :]).min(axis=1)
        best = d if best is None else np.minimum(best, d)
    return best


def distance(a: Geometry, b: Geometry) -> float:
    """ST_Distance: meters for geography, coordinate units for geometry
    (StDistanceFunction.java's split)."""
    geography = a.geography or b.geography
    if a.kind != "point" and b.kind == "point":
        a, b = b, a
    if a.kind == "point" and b.kind == "point":
        if geography:
            return float(haversine_m(a.lat, a.lng, b.lat, b.lng))
        return float(math.hypot(a.lng - b.lng, a.lat - b.lat))
    if a.kind == "point":
        # point vs polygon/linestring
        if b.kind == "polygon" and bool(
                points_in_polygon([a.lng], [a.lat], b)[0]):
            return 0.0
        d = float(_boundary_dist([a.lng], [a.lat], b)[0])
        if geography:
            # planar degrees -> meters via local scale (small-extent approx)
            return d * EARTH_RADIUS_M * math.pi / 180.0 \
                * max(math.cos(math.radians(a.lat)), 0.01)
        return d
    # polygon/linestring vs polygon/linestring: min over vertices both ways
    d1 = _boundary_dist(b.coords[:, 0], b.coords[:, 1], a).min()
    d2 = _boundary_dist(a.coords[:, 0], a.coords[:, 1], b).min()
    if a.kind == "polygon" and points_in_polygon(
            b.coords[:1, 0], b.coords[:1, 1], a)[0]:
        return 0.0
    if b.kind == "polygon" and points_in_polygon(
            a.coords[:1, 0], a.coords[:1, 1], b)[0]:
        return 0.0
    d = float(min(d1, d2))
    if a.geography or b.geography:
        lat0 = float(a.coords[0, 1])
        return d * EARTH_RADIUS_M * math.pi / 180.0 \
            * max(math.cos(math.radians(lat0)), 0.01)
    return d


def contains(outer: Geometry, inner: Geometry) -> bool:
    """ST_Contains(outer, inner); point/polygon combinations."""
    if outer.kind == "point":
        return outer.kind == inner.kind and \
            bool(np.allclose(outer.coords, inner.coords))
    if outer.kind != "polygon":
        return False
    pts = inner.coords
    return bool(points_in_polygon(pts[:, 0], pts[:, 1], outer).all())


def area(g: Geometry) -> float:
    """Shoelace area; spherical excess (m^2) for geography polygons
    (StAreaFunction.java split)."""
    if g.kind != "polygon":
        return 0.0

    def ring_area_planar(r: np.ndarray) -> float:
        x, y = r[:-1, 0], r[:-1, 1]
        x2, y2 = r[1:, 0], r[1:, 1]
        return 0.5 * float(np.sum(x * y2 - x2 * y))

    def ring_area_sphere(r: np.ndarray) -> float:
        lmb = np.radians(r[:, 0])
        phi = np.radians(r[:, 1])
        dl = np.diff(lmb)
        s = np.sum(dl * (2.0 + np.sin(phi[:-1]) + np.sin(phi[1:])) / 2.0)
        return float(s) * EARTH_RADIUS_M ** 2

    f = ring_area_sphere if g.geography else ring_area_planar
    total = abs(f(g.coords))
    for h in g.holes:
        total -= abs(f(h))
    return abs(total)
