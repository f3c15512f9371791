"""The vector-search table: SIFT1M-shaped and GloVe-100-shaped embeddings.

The shapes are ann-benchmarks' "sift-128-euclidean" (1M base vectors,
128-d, l2, queried at k = 10 and 100) and "glove-100-angular" (100-d,
cosine): one table ``vt`` of ``ROWS`` = 2^20 rows in ``SEGMENTS`` = 2
segments, with ``id`` LONG, ``views`` INT, ``emb_l2`` FLOAT 128-d (l2) and
``emb_cos`` FLOAT 100-d (cosine), both with the IVF layer at the default
list count (``default_n_lists(2^19)`` = 724) and seed 7. The vectors are
generated, not downloaded: ``gen_clustered`` is the JAX package's
bench_vector.py generator (a seeded mixture of gaussians, the coarse
structure IVF exists for, with queries near stored rows), drawn in the
same order. The chip check's vector phase and the CPU tests build their
tables here, so both see the same data for the same arguments.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from ..broker import Broker
from ..index.vector import default_n_lists
from ..segment import SegmentBuilder
from ..server import TableDataManager
from ..spi import DataType, FieldSpec, FieldType, Schema, TableConfig
from ..spi.config import IndexingConfig

ROWS = 1 << 20
SEGMENTS = 2
CLUSTERS = 64            # bench_vector.py's natural clusters
IVF_SEED = 7
# column -> (dim, metric, data seed)
COLUMNS: Dict[str, Tuple[int, str, int]] = {
    "emb_l2": (128, "l2", 11),
    "emb_cos": (100, "cosine", 12),
}


def gen_clustered(rows: int, dim: int, n_clusters: int, seed: int,
                  n_queries: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Mixture-of-gaussians embeddings (rows, dim) float32 and
    ``n_queries`` queries near stored rows (bench_vector.gen_clustered,
    its ``IVF_QUERIES`` made a parameter)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    a = rng.integers(0, n_clusters, rows)
    mat = (centers[a]
           + 0.2 * rng.standard_normal((rows, dim))).astype(np.float32)
    qidx = rng.integers(0, rows, n_queries)
    queries = (mat[qidx] + 0.02 * rng.standard_normal(
        (n_queries, dim))).astype(np.float32)
    return mat, queries


def vec_table(rows: int = ROWS, columns=COLUMNS, n_queries: int = 32,
              seed: int = 5):
    """(column arrays, {vector column: queries}): ``id`` 0..rows-1,
    ``views`` uniform in [0, 1000), and each vector column drawn by
    ``gen_clustered`` with its own seed."""
    rng = np.random.default_rng(seed)
    cols = {"id": np.arange(rows, dtype=np.int64),
            "views": rng.integers(0, 1000, rows).astype(np.int32)}
    queries = {}
    for name, (dim, _metric, s) in columns.items():
        cols[name], queries[name] = gen_clustered(rows, dim, CLUSTERS, s,
                                                  n_queries)
    return cols, queries


def schema_and_config(columns=COLUMNS, seg_rows: int = ROWS // SEGMENTS,
                      n_lists=None) -> Tuple[Schema, TableConfig]:
    """The table's schema and its config: every vector column with the
    IVF layer at ``n_lists`` lists (default ``default_n_lists(seg_rows)``)
    and seed ``IVF_SEED``."""
    fields = [FieldSpec("id", DataType.LONG, FieldType.DIMENSION),
              FieldSpec("views", DataType.INT, FieldType.METRIC)]
    vcfg = {}
    for name, (_dim, metric, _s) in columns.items():
        fields.append(FieldSpec(name, DataType.FLOAT, FieldType.DIMENSION))
        vcfg[name] = {"metric": metric,
                      "nLists": n_lists or default_n_lists(seg_rows),
                      "seed": IVF_SEED}
    return Schema("vt", fields), TableConfig(
        "vt", indexing=IndexingConfig(vector_index_columns=vcfg))


def build_table(out: str, cols, n_seg: int = SEGMENTS, columns=COLUMNS,
                n_lists=None) -> List[str]:
    """Write the rows as ``n_seg`` equal segments under ``out``, one
    thread per segment (the k-means and assignment are numpy, which
    releases the interpreter lock in its heavy loops); a segment already
    written there (its metadata.json present) is reused."""
    n = len(cols["id"])
    schema, cfg = schema_and_config(columns, n // n_seg, n_lists)
    bounds = np.linspace(0, n, n_seg + 1).astype(int)

    def one(i: int) -> str:
        d = os.path.join(out, f"vt_{i}")
        if os.path.exists(os.path.join(d, "metadata.json")):
            return d
        return SegmentBuilder(schema, cfg).build(
            {k: v[bounds[i]:bounds[i + 1]] for k, v in cols.items()}, out,
            f"vt_{i}")

    with ThreadPoolExecutor(n_seg) as pool:
        return list(pool.map(one, range(n_seg)))


def load_broker(dirs: List[str], device) -> Broker:
    """A broker on ``device`` over the table's segment directories."""
    broker = Broker(device=device)
    dm = TableDataManager("vt", device=device)
    for d in dirs:
        dm.add_segment_dir(d)
    broker.register_table(dm)
    return broker


def vs(col: str, q, k: int, nprobe=None) -> str:
    """The SQL of ``VECTOR_SIMILARITY(col, ARRAY[q], k[, nprobe])``; each
    component is written as its float32 value's exact float64 repr, so the
    query vector parses back to the same float32 values."""
    arr = ", ".join(repr(float(np.float32(x))) for x in q)
    tail = f", {nprobe}" if nprobe else ""
    return f"VECTOR_SIMILARITY({col}, ARRAY[{arr}], {k}{tail})"
