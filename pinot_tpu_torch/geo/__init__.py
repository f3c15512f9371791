"""Geospatial subsystem: grid cells, geometry codecs, vector predicates.

Port of ``pinot_tpu/geo`` with the same exports:
- cells.py      <- H3 library use + H3Utils (pinot-segment-local)
- geometry.py   <- GeometryUtils/GeometrySerializer + ST_* function math
- index/geo.py  <- H3IndexCreator/ImmutableH3IndexReader (+ filter
                   operators H3IndexFilterOperator/H3InclusionIndex...)
- query/geo_functions.py <- pinot-core geospatial/transform/function/*
"""
from .cells import (DEFAULT_RES, MAX_RES, cell_bounds, cover_circle,
                    cover_polygon, haversine_m, lat_lng_to_cell, parent,
                    pick_resolution)
from .geometry import (Geometry, area, coerce, contains, distance,
                       parse_wkb, parse_wkt, points_in_polygon, to_wkb,
                       to_wkt)

__all__ = [
    "DEFAULT_RES", "MAX_RES", "cell_bounds", "cover_circle",
    "cover_polygon", "haversine_m", "lat_lng_to_cell", "parent",
    "pick_resolution", "Geometry", "area", "coerce", "contains",
    "distance", "parse_wkb", "parse_wkt", "points_in_polygon", "to_wkb",
    "to_wkt",
]
