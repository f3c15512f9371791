"""Hierarchical grid-cell system for geospatial indexing.

Port of ``pinot_tpu/geo/cells.py``, its arithmetic copied line for line
so that cell ids, covers and the index files built from them are the
reference's bit for bit. The reference system indexes geometry through
Uber H3 cells (pinot-segment-local/.../geospatial/BaseH3IndexCreator.java,
utils/H3Utils.java) and filters with a full-match / partial-match cell
split (pinot-core/.../operator/filter/H3IndexFilterOperator.java).

A Z-order (Morton) quad grid over lat/lng gives what filter pruning
needs: (a) a hierarchy, (b) point -> cell assignment as branch-free
int64 numpy over whole columns, (c) tight circle/polygon covers with an
exact/maybe split. The public surface mirrors the H3 one:
``lat_lng_to_cell`` (geoToH3), ``parent``, ``cover_circle`` /
``cover_polygon`` (H3Utils.coverGeometry + kRing).

Cell id layout (int64):  [6 bits res][58 bits Morton(y, x)], res 0..26.
At res r each axis splits into 2^r spans: x indexes longitude
[-180, 180), y indexes latitude [90, -90] top-down. Res 26 is ~0.6 m of
longitude at the equator — finer than H3 res 15 (~0.5 m edge).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

MAX_RES = 26
DEFAULT_RES = 14          # ~2.4 km lng cells at the equator (H3 res ~6-7)
EARTH_RADIUS_M = 6371008.8
_M_PER_DEG = EARTH_RADIUS_M * math.pi / 180.0   # meters per degree of lat


def _part1by1(v: np.ndarray) -> np.ndarray:
    """Spread the low 29 bits of each int64: b_i -> bit 2i (Morton half)."""
    v = v.astype(np.int64) & 0x1FFFFFFF
    v = (v | (v << 16)) & 0x0000FFFF0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v << 2)) & 0x3333333333333333
    v = (v | (v << 1)) & 0x5555555555555555
    return v


def _compact1by1(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64) & 0x5555555555555555
    v = (v | (v >> 1)) & 0x3333333333333333
    v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF0000FFFF
    v = (v | (v >> 16)) & 0x00000000FFFFFFFF
    return v


def _xy_to_cell(x: np.ndarray, y: np.ndarray, res: int) -> np.ndarray:
    code = _part1by1(x) | (_part1by1(y) << 1)
    return (np.int64(res) << 58) | code


def cell_res(cell) -> np.ndarray:
    return (np.asarray(cell, dtype=np.int64) >> 58) & 0x3F


def cell_xy(cell) -> Tuple[np.ndarray, np.ndarray]:
    c = np.asarray(cell, dtype=np.int64) & ((np.int64(1) << 58) - 1)
    return _compact1by1(c), _compact1by1(c >> 1)


def lat_lng_to_cell(lat, lng, res: int = DEFAULT_RES) -> np.ndarray:
    """Vectorized point -> cell id (the geoToH3 analog)."""
    if not 0 <= res <= MAX_RES:
        raise ValueError(f"resolution {res} out of range 0..{MAX_RES}")
    n = np.int64(1) << res
    lat = np.asarray(lat, dtype=np.float64)
    lng = np.asarray(lng, dtype=np.float64)
    fx = (np.mod(lng + 180.0, 360.0)) / 360.0
    fy = (90.0 - lat) / 180.0
    x = np.clip((fx * n).astype(np.int64), 0, n - 1)
    y = np.clip((fy * n).astype(np.int64), 0, n - 1)
    return _xy_to_cell(x, y, res)


def cell_bounds(cell) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """-> (lat_south, lat_north, lng_west, lng_east) per cell."""
    c = np.asarray(cell, dtype=np.int64)
    res = cell_res(c)
    n = (np.int64(1) << res).astype(np.float64)
    x, y = cell_xy(c)
    lng_w = x / n * 360.0 - 180.0
    lng_e = (x + 1) / n * 360.0 - 180.0
    lat_n = 90.0 - y / n * 180.0
    lat_s = 90.0 - (y + 1) / n * 180.0
    return lat_s, lat_n, lng_w, lng_e


def parent(cell, res: int) -> np.ndarray:
    """Ancestor of each cell at coarser resolution ``res``."""
    c = np.asarray(cell, dtype=np.int64)
    if (cell_res(c) < res).any():
        raise ValueError(f"parent resolution {res} is finer than the "
                         "cell's own resolution")
    shift = (cell_res(c) - res) * 2
    code = (c & ((np.int64(1) << 58) - 1)) >> shift
    return (np.int64(res) << 58) | code


def pick_resolution(radius_m: float, lat: float,
                    max_cells_across: int = 16) -> int:
    """Finest res whose circle cover stays under ~max_cells_across^2."""
    # lng cell width in meters shrinks with cos(lat); use it (the wider
    # of the two axes in cells) to bound the cover size
    cos = max(abs(math.cos(math.radians(lat))), 1e-6)
    for res in range(MAX_RES, -1, -1):
        cell_m = 360.0 / (1 << res) * _M_PER_DEG * cos
        if 2.0 * radius_m / cell_m <= max_cells_across:
            return res
    return 0


def _rect_dist_range_m(qlat: float, qlng: float, lat_s, lat_n, lng_w,
                       lng_e) -> Tuple[np.ndarray, np.ndarray]:
    """Haversine (min, max) distance from a point to lat/lng rects."""
    # nearest point: clamp, with longitude handled modulo 360
    dl = (np.mod(qlng - lng_w, 360.0))
    width = np.mod(lng_e - lng_w, 360.0)
    in_span = dl <= width
    # distance (deg) to nearer meridian edge when outside the span
    d_west = np.minimum(np.mod(lng_w - qlng, 360.0),
                        np.mod(qlng - lng_w, 360.0))
    d_east = np.minimum(np.mod(lng_e - qlng, 360.0),
                        np.mod(qlng - lng_e, 360.0))
    near_lng = np.where(in_span, qlng,
                        np.where(d_west <= d_east, lng_w, lng_e))
    near_lat = np.clip(qlat, lat_s, lat_n)
    dmin = haversine_m(qlat, qlng, near_lat, near_lng)
    # farthest corner
    best = None
    for la in (lat_s, lat_n):
        for ln in (lng_w, lng_e):
            d = haversine_m(qlat, qlng, la, ln)
            best = d if best is None else np.maximum(best, d)
    return dmin, best


def haversine_m(lat1, lng1, lat2, lng2) -> np.ndarray:
    """Vectorized great-circle distance in meters."""
    p1 = np.radians(np.asarray(lat1, dtype=np.float64))
    p2 = np.radians(np.asarray(lat2, dtype=np.float64))
    dphi = p2 - p1
    dlmb = np.radians(np.asarray(lng2, dtype=np.float64)
                      - np.asarray(lng1, dtype=np.float64))
    a = (np.sin(dphi / 2.0) ** 2
         + np.cos(p1) * np.cos(p2) * np.sin(dlmb / 2.0) ** 2)
    return 2.0 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def _grid_cells(lat_lo: float, lat_hi: float, lng_lo: float, lng_hi: float,
                res: int, cap: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """All (x, y) cells at res intersecting the bbox; None if > cap."""
    n = 1 << res
    y0 = max(int((90.0 - lat_hi) / 180.0 * n), 0)
    y1 = min(int((90.0 - lat_lo) / 180.0 * n), n - 1)
    # longitude, wrap-aware: enumerate x over (possibly two) spans
    fx0 = (lng_lo + 180.0) / 360.0
    fx1 = (lng_hi + 180.0) / 360.0
    if lng_hi - lng_lo >= 360.0:
        xs = np.arange(n, dtype=np.int64)
    else:
        x0 = math.floor(fx0 * n)
        x1 = math.floor(fx1 * n)
        xs = np.mod(np.arange(x0, x1 + 1, dtype=np.int64), n)
        xs = np.unique(xs)
    ys = np.arange(y0, y1 + 1, dtype=np.int64)
    if len(xs) * len(ys) > cap:
        return None
    gx, gy = np.meshgrid(xs, ys)
    return gx.ravel(), gy.ravel()


def cover_circle(lat: float, lng: float, radius_m: float, res: int,
                 cap: int = 1 << 14
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Cells at ``res`` covering the circle -> (full, boundary) cell ids.

    ``full`` cells lie entirely inside the radius (every doc matches);
    ``boundary`` cells intersect it (docs need the exact check) — the
    H3IndexFilterOperator fullMatch/partialMatch split. None when the
    cover would exceed ``cap`` cells (caller falls back to a full scan).
    """
    dlat = radius_m / _M_PER_DEG
    cos = max(abs(math.cos(math.radians(lat))), 1e-9)
    dlng = min(radius_m / (_M_PER_DEG * cos), 360.0)
    xy = _grid_cells(lat - dlat, lat + dlat, lng - dlng, lng + dlng,
                     res, cap)
    if xy is None:
        return None
    cells = _xy_to_cell(xy[0], xy[1], res)
    lat_s, lat_n, lng_w, lng_e = cell_bounds(cells)
    dmin, dmax = _rect_dist_range_m(lat, lng, lat_s, lat_n, lng_w, lng_e)
    full = cells[dmax <= radius_m]
    boundary = cells[(dmin <= radius_m) & (dmax > radius_m)]
    return full, boundary


def _segments_intersect_rect(ax, ay, bx, by, x0, x1, y0, y1) -> np.ndarray:
    """For each rect (x0..y1 arrays), does ANY segment (a->b) intersect it?

    Segments in (lng, lat) planar coords. Vectorized (edges x rects)
    conservative Cohen-Sutherland style test: an edge intersects the rect
    iff the segment's bbox overlaps it and the rect is not strictly on
    one side of the segment's supporting line, or an endpoint is inside.
    """
    ax = ax[:, None]; ay = ay[:, None]; bx = bx[:, None]; by = by[:, None]
    x0 = x0[None, :]; x1 = x1[None, :]; y0 = y0[None, :]; y1 = y1[None, :]
    bbox = ((np.minimum(ax, bx) <= x1) & (np.maximum(ax, bx) >= x0)
            & (np.minimum(ay, by) <= y1) & (np.maximum(ay, by) >= y0))
    # signed side of each rect corner wrt the segment's line
    dx = bx - ax
    dy = by - ay
    s1 = dx * (y0 - ay) - dy * (x0 - ax)
    s2 = dx * (y0 - ay) - dy * (x1 - ax)
    s3 = dx * (y1 - ay) - dy * (x0 - ax)
    s4 = dx * (y1 - ay) - dy * (x1 - ax)
    all_pos = (s1 > 0) & (s2 > 0) & (s3 > 0) & (s4 > 0)
    all_neg = (s1 < 0) & (s2 < 0) & (s3 < 0) & (s4 < 0)
    hit = bbox & ~(all_pos | all_neg)
    return hit.any(axis=0)


def cover_polygon(shell: np.ndarray, res: int, cap: int = 1 << 14,
                  point_in_fn=None, holes=()
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Cells covering a polygon -> (full, boundary). ``shell``/``holes``
    are (k, 2) lng/lat rings.

    A cell crossed by NO boundary edge (shell or hole) is uniformly
    inside or outside (test its center); a crossed cell is boundary.
    Mirrors H3Utils.coverGeometry's fullCover/partialCover split.
    """
    lngs, lats = shell[:, 0], shell[:, 1]
    xy = _grid_cells(float(lats.min()), float(lats.max()),
                     float(lngs.min()), float(lngs.max()), res, cap)
    if xy is None:
        return None
    cells = _xy_to_cell(xy[0], xy[1], res)
    lat_s, lat_n, lng_w, lng_e = cell_bounds(cells)
    rings = [shell] + list(holes)
    ax = np.concatenate([r[:-1, 0] for r in rings])
    ay = np.concatenate([r[:-1, 1] for r in rings])
    bx = np.concatenate([r[1:, 0] for r in rings])
    by = np.concatenate([r[1:, 1] for r in rings])
    crossed = _segments_intersect_rect(ax, ay, bx, by,
                                       lng_w, lng_e, lat_s, lat_n)
    cx = (lng_w + lng_e) / 2.0
    cy = (lat_s + lat_n) / 2.0
    if point_in_fn is None:
        from .geometry import points_in_ring

        def point_in_fn(px, py, _shell=shell, _holes=tuple(holes)):
            m = points_in_ring(px, py, _shell)
            for h in _holes:
                m &= ~points_in_ring(px, py, h)
            return m
    inside = point_in_fn(cx, cy)
    full = cells[~crossed & inside]
    boundary = cells[crossed]
    return full, boundary
