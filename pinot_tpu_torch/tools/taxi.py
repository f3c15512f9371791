"""The NYC-taxi group-by corpus, built with the port: the trips schema,
its seeded columns and the four group-by queries (a 265-zone key and a
100k-card dictionary key, each with and without a filter).

``build_segment_dir(n, out_dir)`` writes the one-segment table and
returns its directory; ``QUERIES`` holds (id, key, where) and
``sql(key, where)`` renders one. The static-analysis runner
(``tools/check_static.py``) plans every query over it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..segment import SegmentBuilder
from ..spi import DataType, FieldSpec, FieldType, Schema, TableConfig

N_ZONES = 265
HC_CARD = 100_000


def gen_columns(n: int):
    rng = np.random.default_rng(2016)
    return {
        "pu_loc": rng.integers(0, N_ZONES, n).astype(np.int32),
        "hc_key": rng.integers(0, HC_CARD, n).astype(np.int32),
        "fare": rng.integers(250, 20_000, n).astype(np.int32),  # cents
        "distance": rng.integers(1, 3_000, n).astype(np.int32),
        "passengers": rng.integers(1, 7, n).astype(np.int32),
    }


def schema() -> Schema:
    return Schema("trips", [
        FieldSpec("pu_loc", DataType.INT, FieldType.DIMENSION),
        FieldSpec("hc_key", DataType.INT, FieldType.DIMENSION),
        FieldSpec("fare", DataType.INT, FieldType.METRIC),
        FieldSpec("distance", DataType.INT, FieldType.METRIC),
        FieldSpec("passengers", DataType.INT, FieldType.DIMENSION),
    ])


def build_segment_dir(n: int, out_dir: str) -> str:
    cfg = TableConfig("trips")
    cfg.indexing.dictionary_columns.append("hc_key")  # keep dict past 2^17
    return SegmentBuilder(schema(), cfg).build(gen_columns(n), out_dir,
                                               "seg_0")


QUERIES = [
    ("zones_265", "pu_loc", None),
    ("zones_filtered", "pu_loc", "passengers >= 2"),
    ("hc_100k", "hc_key", None),
    ("hc_100k_filtered", "hc_key", "distance < 1500"),
]


def sql(key: str, where: Optional[str]) -> str:
    w = f" WHERE {where}" if where else ""
    return (f"SELECT {key}, COUNT(*), AVG(fare) FROM trips{w} "
            f"GROUP BY {key} LIMIT 200000")
