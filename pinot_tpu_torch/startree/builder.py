"""Star-tree analog: materialized pre-aggregation rollups.

Port of ``pinot_tpu/startree/builder.py`` (rollup files byte-equal to the
reference builder's). Reference parity: pinot-segment-local/.../startree/
v2/builder/{OffHeapSingleTreeBuilder, MultipleTreesBuilder}.java —
Pinot's star-tree pre-aggregates metrics over dimension subsets and
stores a tree whose star-nodes skip dimensions at query time. Here the
same speedup comes from materializing the FULL group-by over the
configured split dimensions as a small regular segment (one row per
distinct dimension combination, pre-aggregated metric columns). Queries
whose filters and group-bys stay within the rollup dimensions rewrite
onto the rollup (query.py) and scan far fewer rows through the same
kernels on the card: the rollup IS a segment, so every engine feature
applies unchanged. Multiple rollups per segment = MultipleTreesBuilder.
A dictionary dimension factorizes by its ids (``_factorize``): the
reference's ``np.unique`` over decoded strings gives the same values and
inverse at a far higher cost on a 2^25-row segment.

Rollup column naming: dims keep their names; each (func, metric) pair
becomes "<metric>__<func>", plus "__count" (star-tree's implicit COUNT)."""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..segment.builder import SegmentBuilder
from ..segment.immutable import ImmutableSegment
from ..spi.config import TableConfig
from ..spi.schema import DataType, FieldSpec, FieldType, Schema

ROLLUP_META_KEY = "rollups"
SUPPORTED_FUNCS = ("sum", "min", "max")


@dataclass
class RollupConfig:
    """StarTreeIndexConfig analog: dimensionsSplitOrder +
    functionColumnPairs."""
    dims: List[str]
    metrics: List[Tuple[str, str]] = field(default_factory=list)  # (func,col)

    def name(self, index: int) -> str:
        return f"startree{index}"


def _factorize(seg: ImmutableSegment, d: str):
    """(sorted distinct values, inverse) of a dimension: the reference's
    ``np.unique`` over its decoded values (strings as numpy unicode).
    A single-value dictionary column whose sorted integer or string
    dictionary holds exactly the values present (a segment's own
    dictionary does) already has both: its values and its ids, so it
    skips the decode and the sort of 2^25 strings with the same
    result."""
    m = seg.columns[d]
    dic = seg.dictionary(d)
    if dic is not None and m.single_value:
        ids = np.asarray(seg.fwd(d)).astype(np.int64)
        u = np.asarray(dic.values, dtype=object if isinstance(
            dic.values, list) else None)
        if u.dtype == object:
            u = u.astype(str)
        if u.dtype.kind in "iuU" and len(u) and \
                bool(np.all(np.bincount(ids, minlength=len(u)) > 0)):
            return u, ids
    v = np.asarray(seg.raw_values(d))
    if v.dtype == object:
        v = v.astype(str)
    return np.unique(v, return_inverse=True)


def build_rollup(seg: ImmutableSegment, config: RollupConfig,
                 index: int = 0) -> str:
    """Build one rollup under the segment dir; registers it in the segment
    metadata. Returns the rollup directory."""
    for func, col in config.metrics:
        if func not in SUPPORTED_FUNCS:
            raise ValueError(f"unsupported rollup function {func!r}")

    for d in config.dims:
        if seg.null_mask(d) is not None:
            raise ValueError(
                f"rollup dimension {d!r} has nulls; null identity does not "
                "survive materialization — exclude it or disable nulls")

    n = seg.n_docs
    # factorize the dimension tuple
    codes = np.zeros(n, dtype=np.int64)
    uniques: List[np.ndarray] = []
    for d in config.dims:
        u, inv = _factorize(seg, d)
        codes = codes * len(u) + inv
        uniques.append(u)
    ucodes, inv = np.unique(codes, return_inverse=True)
    n_groups = len(ucodes)

    out_cols: Dict[str, np.ndarray] = {}
    fields: List[FieldSpec] = []
    rem = ucodes.copy()
    decoded: List[np.ndarray] = []
    for u in reversed(uniques):
        decoded.append(u[rem % len(u)])
        rem //= len(u)
    decoded.reverse()
    for d, vals in zip(config.dims, decoded):
        spec = seg.schema.field(d)
        out_cols[d] = vals if vals.dtype != object else vals.astype(object)
        fields.append(FieldSpec(d, spec.data_type, FieldType.DIMENSION))

    counts = np.bincount(inv, minlength=n_groups)
    out_cols["__count"] = counts.astype(np.int64)
    fields.append(FieldSpec("__count", DataType.LONG, FieldType.METRIC))

    for func, col in config.metrics:
        v = np.asarray(seg.raw_values(col))
        spec = seg.schema.field(col)
        name = f"{col}__{func}"
        if func == "sum":
            if np.issubdtype(v.dtype, np.integer):
                acc = np.zeros(n_groups, dtype=np.int64)
                np.add.at(acc, inv, v.astype(np.int64))
                out_cols[name] = acc
                fields.append(FieldSpec(name, DataType.LONG,
                                        FieldType.METRIC))
            else:
                acc = np.zeros(n_groups, dtype=np.float64)
                np.add.at(acc, inv, v.astype(np.float64))
                out_cols[name] = acc
                fields.append(FieldSpec(name, DataType.DOUBLE,
                                        FieldType.METRIC))
        elif func in ("min", "max"):
            if np.issubdtype(v.dtype, np.integer):
                init = (np.iinfo(np.int64).max if func == "min"
                        else np.iinfo(np.int64).min)
                acc = np.full(n_groups, init, dtype=np.int64)
                (np.minimum if func == "min" else np.maximum).at(
                    acc, inv, v.astype(np.int64))
                out_cols[name] = acc
                fields.append(FieldSpec(name, DataType.LONG,
                                        FieldType.METRIC))
            else:
                init = np.inf if func == "min" else -np.inf
                acc = np.full(n_groups, init, dtype=np.float64)
                (np.minimum if func == "min" else np.maximum).at(
                    acc, inv, v.astype(np.float64))
                out_cols[name] = acc
                fields.append(FieldSpec(name, DataType.DOUBLE,
                                        FieldType.METRIC))

    rollup_schema = Schema(f"{seg.name}_{config.name(index)}", fields)
    builder = SegmentBuilder(rollup_schema, TableConfig(rollup_schema.name))
    rollup_dir = builder.build(out_cols, seg.dir, config.name(index))

    # register in segment metadata
    meta_path = os.path.join(seg.dir, "metadata.json")
    with open(meta_path) as fh:
        meta = json.load(fh)
    entry = {
        "name": config.name(index),
        "dims": list(config.dims),
        "metrics": [[f, c] for f, c in config.metrics],
    }
    meta.setdefault(ROLLUP_META_KEY, [])
    meta[ROLLUP_META_KEY] = [e for e in meta[ROLLUP_META_KEY]
                             if e["name"] != entry["name"]] + [entry]
    with open(meta_path, "w") as fh:
        json.dump(meta, fh, indent=1)
    seg.metadata = meta
    return rollup_dir
