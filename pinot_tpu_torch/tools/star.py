"""The multi-stage star schema: orders x customers x parts.

The tables and query shapes of the JAX package's multi-stage benchmark
(``bench.py --multistage``: ``_ms_broker``, ``MS_SHAPES``), built with the
port's own builder. The data is bench.py's, drawn in the same order from
``numpy.random.default_rng(seed)``: customers (60,000 rows, past the
multi-stage engine's 50,000-row broadcast bound, so the mailbox plane
shuffles it) and parts (2,000 rows, the broadcast side) as one segment
each, orders (``n_orders`` rows) in four segments. ``SHAPES`` are
bench.py's ``join_gb``, ``join3_gb`` and ``join_window`` (its
``join_union``, a set operation over two joins, runs in chip_smoke.py's
statements phase) and two window
shapes over ``orders JOIN customers``: a running sum (the segmented scan)
and a partition sum (the segment aggregate).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Tuple

import numpy as np

from ..broker import Broker
from ..segment import SegmentBuilder
from ..server import TableDataManager
from ..spi import DataType, FieldSpec, FieldType, Schema, TableConfig

CUST_ROWS = 60_000
PART_ROWS = 2_000
ORDER_SEGMENTS = 4
NATIONS = ["us", "de", "jp", "br", "cn"]
BRANDS = ["acme", "blitz", "corex"]

# (name, literal variant i -> SQL)
SHAPES: List[Tuple[str, Callable[[int], str]]] = [
    ("join_gb", lambda i:
        f"SELECT c.c_nation, SUM(o.o_price + {i % 7}), COUNT(*) "
        f"FROM orders o JOIN customers c ON o.o_cust = c.c_id "
        f"GROUP BY c.c_nation ORDER BY c.c_nation LIMIT 10"),
    ("join3_gb", lambda i:
        f"SELECT c.c_nation, p.p_brand, SUM(o.o_price * 2 + {i % 5}) "
        f"FROM orders o JOIN customers c ON o.o_cust = c.c_id "
        f"JOIN parts p ON o.o_part = p.p_id "
        f"GROUP BY c.c_nation, p.p_brand "
        f"ORDER BY c.c_nation, p.p_brand LIMIT 40"),
    ("join_window", lambda i:
        f"SELECT c.c_nation, o.o_key + {i % 3}, "
        f"ROW_NUMBER() OVER (PARTITION BY c.c_nation ORDER BY o.o_key) "
        f"FROM orders o JOIN customers c ON o.o_cust = c.c_id "
        f"WHERE o.o_price > 3750 "
        f"ORDER BY c.c_nation, o.o_key LIMIT 50"),
    ("win_running", lambda i:
        f"SELECT c.c_nation, o.o_key, SUM(o.o_price + {i % 4}) OVER "
        f"(PARTITION BY c.c_nation ORDER BY o.o_key) "
        f"FROM orders o JOIN customers c ON o.o_cust = c.c_id "
        f"WHERE o.o_price > 3750 ORDER BY o.o_key DESC LIMIT 50"),
    ("win_partition", lambda i:
        f"SELECT c.c_nation, o.o_key, SUM(o.o_price + {i % 4}) OVER "
        f"(PARTITION BY c.c_nation) "
        f"FROM orders o JOIN customers c ON o.o_cust = c.c_id "
        f"WHERE o.o_price > 3750 ORDER BY o.o_key DESC LIMIT 50"),
]


def star_tables(n_orders: int, seed: int = 16):
    """{table: (columns, fields, n_segments)}: bench.py's draws."""
    rng = np.random.default_rng(seed)
    cust = {"c_id": np.arange(CUST_ROWS).astype(np.int32),
            "c_nation": rng.choice(NATIONS, CUST_ROWS)}
    part = {"p_id": np.arange(PART_ROWS).astype(np.int32),
            "p_brand": rng.choice(BRANDS, PART_ROWS)}
    orders = {
        "o_key": np.arange(n_orders).astype(np.int64),
        "o_cust": rng.choice(CUST_ROWS, n_orders).astype(np.int32),
        "o_part": rng.choice(PART_ROWS, n_orders).astype(np.int32),
        "o_price": rng.integers(10, 5000, n_orders).astype(np.int64),
    }
    return {
        "customers": (cust, [FieldSpec("c_id", DataType.INT),
                             FieldSpec("c_nation", DataType.STRING)], 1),
        "parts": (part, [FieldSpec("p_id", DataType.INT),
                         FieldSpec("p_brand", DataType.STRING)], 1),
        "orders": (orders, [
            FieldSpec("o_key", DataType.LONG),
            FieldSpec("o_cust", DataType.INT),
            FieldSpec("o_part", DataType.INT),
            FieldSpec("o_price", DataType.LONG, FieldType.METRIC)],
            ORDER_SEGMENTS),
    }


def build_tables(out: str, tables) -> Dict[str, List[str]]:
    """Write each table's segments under ``out/<table>/`` (rows split
    evenly over its segment count); {table: segment dirs}. A segment
    already written there (its metadata.json present) is reused."""
    dirs: Dict[str, List[str]] = {}
    for name, (cols, fields, n_seg) in tables.items():
        b = SegmentBuilder(Schema(name, fields), TableConfig(name))
        n = len(next(iter(cols.values())))
        bounds = np.linspace(0, n, n_seg + 1).astype(int)
        dirs[name] = []
        for i in range(n_seg):
            d = os.path.join(out, name, f"{name}_{i}")
            if not os.path.exists(os.path.join(d, "metadata.json")):
                d = b.build({k: v[bounds[i]:bounds[i + 1]]
                             for k, v in cols.items()},
                            os.path.join(out, name), f"{name}_{i}")
            dirs[name].append(d)
    return dirs


def load_broker(dirs: Dict[str, List[str]], device) -> Broker:
    """A broker on ``device`` over the tables' segment directories."""
    broker = Broker(device=device)
    for name, ds in dirs.items():
        dm = TableDataManager(name, device=device)
        for d in ds:
            dm.add_segment_dir(d)
        broker.register_table(dm)
    return broker
