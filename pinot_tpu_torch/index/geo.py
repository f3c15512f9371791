"""Geospatial (H3-analog) index: grid-cell postings + SoA point planes.

Port of ``pinot_tpu/index/geo.py``: the same four files, byte for byte,
and the same metadata. Reference system: pinot-segment-local/.../
creator/impl/inv/geospatial/BaseH3IndexCreator.java + readers/
geospatial/ImmutableH3IndexReader.java (cell -> doc postings at the
configured resolution), consumed by pinot-core/.../operator/filter/
H3IndexFilterOperator.java (ST_Distance range predicates: full-match
docs skip the exact check, partial-match docs get it) and
H3InclusionIndexFilterOperator.java (ST_Contains/ST_Within of a literal
polygon).

Alongside the postings the build decodes every point once into a float64
(n_docs, 2) [lat, lng] plane, so the exact-distance refine over
partial-match docs, and the whole-column sweep when a cover would be too
wide, are one vectorized haversine rather than a per-row decode. The
masks are host numpy; the planner ships them to the device as a
``docmask`` kernel param. Points only (the reference's H3 index has the
same restriction).

What differs from the reference: the build decodes little-endian POINT
rows given as 42-digit hex or 21 raw bytes in one vectorized pass
(``_fast_points``) and runs the reference's per-row ``coerce`` loop only
over the other rows, so a column of millions of points is not decoded
row by row in Python. Both give the same lat/lng bits, flags and errors.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ..geo import cells as _cells
from ..geo import geometry as _geometry

PTS_SUFFIX = ".geo.pts.bin"
CELLS_SUFFIX = ".geo.cells.bin"
OFFS_SUFFIX = ".geo.offs.bin"
DOCS_SUFFIX = ".geo.docs.bin"

# covers wider than this brute-force the point plane instead (one
# vectorized haversine over n_docs beats unioning 16k posting lists)
MAX_COVER_CELLS = 1 << 13


_POINT_WKB_BYTES = 21        # byte order, type word, two float64


def _point_record(v) -> Optional[bytes]:
    """The 21 bytes of a row given as 42 hex digits or 21 raw bytes,
    else None."""
    if type(v) is str and len(v) == 2 * _POINT_WKB_BYTES:
        try:
            v = bytes.fromhex(v)
        except ValueError:
            return None
    if type(v) is bytes and len(v) == _POINT_WKB_BYTES:
        return v
    return None


def _fast_points(vals: np.ndarray, lat: np.ndarray, lng: np.ndarray):
    """Decode every row that is a little-endian WKB POINT, as 42 hex
    digits or 21 raw bytes, into ``lat``/``lng`` in one pass.

    Returns (decoded rows, any of them carrying the geography flag). A
    row decoded here is one ``geometry.coerce`` would parse to a point
    with the same coordinates; every other row is left to the per-row
    loop."""
    n = len(vals)
    fast = np.zeros(n, dtype=bool)
    recs = [_point_record(v) for v in vals]
    idx = np.fromiter((i for i, r in enumerate(recs) if r is not None),
                      dtype=np.int64)
    if not len(idx):
        return fast, False
    blob = b"".join(recs[i] for i in idx.tolist())
    rec = np.frombuffer(blob, dtype=np.uint8).reshape(-1, _POINT_WKB_BYTES)
    kind = rec[:, 1:5].copy().view("<u4").ravel()
    ok = (rec[:, 0] == 1) & ((kind & np.uint32(0x7FFFFFFF)) == 1)
    xy = rec[:, 5:].copy().view("<f8")
    take = idx[ok]
    lng[take] = xy[ok, 0]
    lat[take] = xy[ok, 1]
    fast[take] = True
    geography = bool((kind[ok] & np.uint32(0x80000000)).any())
    return fast, geography


def build(col: str, seg_dir: str, *, values: np.ndarray,
          resolution: int = _cells.DEFAULT_RES, **_: Any) -> Dict[str, Any]:
    n = len(values)
    lat = np.full(n, np.nan, dtype=np.float64)
    lng = np.full(n, np.nan, dtype=np.float64)
    vals = np.asarray(values, dtype=object)
    fast, geography = _fast_points(vals, lat, lng)
    for i in np.nonzero(~fast)[0].tolist():
        v = vals[i]
        try:
            g = _geometry.coerce(v)
        except Exception:
            g = None  # undecodable bytes rank with nulls, as at query time
        if g is None:
            continue
        geography = geography or g.geography
        if g.kind != "point":
            raise ValueError(
                f"geo index on {col!r} supports POINT geometries only "
                f"(got {g.type_name()} at doc {i}) — same restriction as "
                "the reference H3 index")
        lat[i] = g.lat
        lng[i] = g.lng
    pts = np.stack([lat, lng], axis=1)
    pts.tofile(os.path.join(seg_dir, col + PTS_SUFFIX))

    valid = ~np.isnan(lat)
    cells = _cells.lat_lng_to_cell(lat[valid], lng[valid], resolution)
    docs = np.nonzero(valid)[0].astype(np.int32)
    order = np.argsort(cells, kind="stable")
    cells_sorted = cells[order]
    docs_sorted = docs[order]
    uniq, starts = np.unique(cells_sorted, return_index=True)
    offs = np.concatenate([starts, [len(cells_sorted)]]).astype(np.int64)
    uniq.astype(np.int64).tofile(os.path.join(seg_dir, col + CELLS_SUFFIX))
    offs.tofile(os.path.join(seg_dir, col + OFFS_SUFFIX))
    docs_sorted.tofile(os.path.join(seg_dir, col + DOCS_SUFFIX))
    return {"resolution": int(resolution), "numCells": int(len(uniq)),
            "geography": bool(geography)}


class GeoIndexReader:
    def __init__(self, seg_dir: str, col: str, meta: Dict[str, Any]):
        self.resolution = int(meta["resolution"])
        self.geography = bool(meta.get("geography", True))
        from ..segment import segdir
        self.pts = segdir.read_array(seg_dir, col + PTS_SUFFIX,
                                     np.float64).reshape(-1, 2)
        self.cells = np.asarray(segdir.read_array(
            seg_dir, col + CELLS_SUFFIX, np.int64, mmap=False))
        self.offs = np.asarray(segdir.read_array(
            seg_dir, col + OFFS_SUFFIX, np.int64, mmap=False))
        self.docs = segdir.read_array(seg_dir, col + DOCS_SUFFIX, np.int32)

    # -- postings -----------------------------------------------------
    def _docs_for_cells(self, wanted: np.ndarray) -> np.ndarray:
        parts = []
        for i, w in zip(np.searchsorted(self.cells, wanted), wanted):
            if i < len(self.cells) and self.cells[i] == w:
                parts.append(self.docs[self.offs[i]:self.offs[i + 1]])
        if not parts:
            return np.empty(0, dtype=np.int32)
        return np.concatenate(parts)

    def valid_mask(self, n_docs: int) -> np.ndarray:
        """Docs that hold a decodable point."""
        return ~np.isnan(self.pts[:n_docs, 0])

    # -- filters ------------------------------------------------------
    def distance_mask(self, point, radius, op: str,
                      n_docs: int) -> np.ndarray:
        """Docs where haversine(col, point) <op> radius (geography) or
        planar distance (geometry). op in {'<','<=','>','>=' }."""
        g = _geometry.coerce(point)
        # geography-ness belongs to the DATA as much as the literal (the
        # host path sees the per-row flag; the index records it at build)
        geog = g.geography or self.geography
        if op in ("<", "<=") and geog:
            cover = _cells.cover_circle(g.lat, g.lng, float(radius),
                                        self.resolution,
                                        cap=MAX_COVER_CELLS)
            if cover is not None:
                full, boundary = cover
                mask = np.zeros(n_docs, dtype=bool)
                fd = self._docs_for_cells(full)
                mask[fd] = True
                bd = self._docs_for_cells(boundary)
                if len(bd):
                    d = _cells.haversine_m(self.pts[bd, 0], self.pts[bd, 1],
                                           g.lat, g.lng)
                    ok = d < radius if op == "<" else d <= radius
                    mask[bd[ok]] = True
                return mask
        # brute vectorized sweep over the point plane (NaN rows never match)
        if geog:
            d = _cells.haversine_m(self.pts[:, 0], self.pts[:, 1],
                                   g.lat, g.lng)
        else:
            d = np.hypot(self.pts[:, 1] - g.lng, self.pts[:, 0] - g.lat)
        cmp = {"<": np.less, "<=": np.less_equal,
               ">": np.greater, ">=": np.greater_equal}[op]
        with np.errstate(invalid="ignore"):
            m = cmp(d, float(radius))
        m[np.isnan(d)] = False
        return m[:n_docs]

    def inclusion_mask(self, polygon, n_docs: int,
                       positive: bool = True) -> np.ndarray:
        """Docs whose point is inside the literal polygon (ST_Contains
        (poly, col) / ST_Within(col, poly)); H3InclusionIndexFilter."""
        g = _geometry.coerce(polygon)
        if g.kind != "polygon":
            raise ValueError("inclusion filter needs a POLYGON literal")
        mask = np.zeros(n_docs, dtype=bool)
        cover = _cells.cover_polygon(
            g.coords, self.resolution, cap=MAX_COVER_CELLS,
            point_in_fn=(lambda px, py:
                         _geometry.points_in_polygon(px, py, g)),
            holes=g.holes)
        if cover is not None:
            full, boundary = cover
            mask[self._docs_for_cells(full)] = True
            bd = self._docs_for_cells(boundary)
            if len(bd):
                ok = _geometry.points_in_polygon(
                    self.pts[bd, 1], self.pts[bd, 0], g)
                mask[bd[ok]] = True
        else:
            valid = ~np.isnan(self.pts[:n_docs, 0])
            vi = np.nonzero(valid)[0]
            ok = _geometry.points_in_polygon(
                self.pts[vi, 1], self.pts[vi, 0], g)
            mask[vi[ok]] = True
        # negative = plain complement: the ST_Contains scalar returns 0
        # for null/invalid rows, so "= 0" matches them on the host path
        # and the index path must agree
        return mask if positive else ~mask
