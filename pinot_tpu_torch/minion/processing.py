"""Segment processing framework: map -> partition -> reduce over segments.

Reference parity: pinot-core/.../segment/processing/framework/
SegmentProcessorFramework (mappers transform rows, partitioners split by
column/time, reducers merge/rollup/dedup; used by the minion merge/rollup
tasks). Columnar shape: columns stay numpy end to end — "rows" never
materialize; transform/filter/rollup are vectorized column ops and the
output is rebuilt through SegmentBuilder.

Port of ``pinot_tpu/minion/processing.py``: the columns are decoded on
the host from the input segments' files (wherever the segments are
loaded) and rebuilt by the port's ``SegmentBuilder``, whose files equal
the reference's byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from ..segment.builder import SegmentBuilder
from ..segment.immutable import ImmutableSegment
from ..spi.config import TableConfig
from ..spi.schema import FieldType, Schema


@dataclass
class RollupConfig:
    """Aggregate duplicate dimension tuples (MergeRollupTask 'rollup' mode):
    metric -> sum|min|max."""
    aggregations: Dict[str, str] = field(default_factory=dict)


@dataclass
class ProcessorConfig:
    # mapper: dict of columns -> dict of columns (vectorized row transform)
    transform: Optional[Callable[[Dict[str, np.ndarray]],
                                 Dict[str, np.ndarray]]] = None
    # rows where this mask is True are DROPPED (purge predicate)
    drop_mask_fn: Optional[Callable[[ImmutableSegment], np.ndarray]] = None
    # partition output by this column's value (one output group per value)
    partition_column: Optional[str] = None
    # ... or by time bucket: (time_column, bucket_ms)
    time_column: Optional[str] = None
    time_bucket_ms: Optional[int] = None
    rollup: Optional[RollupConfig] = None
    target_rows_per_segment: int = 1 << 20
    segment_name_prefix: str = "processed"


def _segment_columns(seg: ImmutableSegment,
                     drop_mask: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
    """Decoded columns honoring upsert validDocIds and an optional extra
    drop mask."""
    keep = np.ones(seg.n_docs, dtype=bool)
    if seg.valid_docs is not None:
        keep &= seg.valid_docs[: seg.n_docs]
    if drop_mask is not None:
        keep &= ~drop_mask
    return {name: seg.raw_values(name)[keep] for name in seg.columns}


def _concat(chunks: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    if not chunks:
        return {}
    out: Dict[str, np.ndarray] = {}
    for name in chunks[0]:
        arrs = [c[name] for c in chunks]
        if arrs[0].dtype == object:
            out[name] = np.concatenate(
                [np.asarray(a, dtype=object) for a in arrs])
        else:
            out[name] = np.concatenate(arrs)
    return out


def _rollup(cols: Dict[str, np.ndarray], schema: Schema,
            cfg: RollupConfig) -> Dict[str, np.ndarray]:
    """Collapse duplicate dimension tuples, aggregating metrics
    (OffHeapSingleTreeBuilder-style rollup without the tree)."""
    dim_cols = [f.name for f in schema.fields
                if f.field_type != FieldType.METRIC and f.name in cols]
    metric_cols = [f.name for f in schema.fields
                   if f.field_type == FieldType.METRIC and f.name in cols]
    if not dim_cols or not cols:
        return cols
    n = len(next(iter(cols.values())))
    if n == 0:
        return cols
    # group key: lexicographic unique over the stacked dim columns
    key_arrays = [np.asarray(cols[d]).astype(str) if cols[d].dtype == object
                  else cols[d] for d in dim_cols]
    order = np.lexsort(key_arrays[::-1])
    sorted_keys = [k[order] for k in key_arrays]
    new_group = np.zeros(n, dtype=bool)
    new_group[0] = True
    for k in sorted_keys:
        new_group[1:] |= k[1:] != k[:-1]
    group_ids = np.cumsum(new_group) - 1
    n_groups = int(group_ids[-1]) + 1
    firsts = order[new_group]
    out: Dict[str, np.ndarray] = {}
    for d in dim_cols:
        out[d] = np.asarray(cols[d])[firsts]
    starts = np.nonzero(new_group)[0]
    for m in metric_cols:
        v = np.asarray(cols[m])[order]
        agg = cfg.aggregations.get(m, "sum")
        if agg == "sum":
            out[m] = np.add.reduceat(v, starts)
        elif agg == "min":
            out[m] = np.minimum.reduceat(v, starts)
        elif agg == "max":
            out[m] = np.maximum.reduceat(v, starts)
        else:
            raise ValueError(f"unknown rollup aggregation {agg!r} "
                             f"for metric {m!r}")
        assert len(out[m]) == n_groups
    return out


def _partition_groups(cols: Dict[str, np.ndarray],
                      config: ProcessorConfig) -> List[Dict[str, np.ndarray]]:
    if not cols:
        return []
    n = len(next(iter(cols.values())))
    if n == 0:
        return []
    if config.partition_column:
        key = cols[config.partition_column]
        uniq = np.unique(key.astype(str) if key.dtype == object else key)
        groups = []
        for u in uniq:
            sel = (key.astype(str) == u) if key.dtype == object else key == u
            groups.append({k: v[sel] for k, v in cols.items()})
        return groups
    if config.time_column and config.time_bucket_ms:
        t = np.asarray(cols[config.time_column]).astype(np.int64)
        bucket = t // config.time_bucket_ms
        groups = []
        for u in np.unique(bucket):
            sel = bucket == u
            groups.append({k: v[sel] for k, v in cols.items()})
        return groups
    return [cols]


def process_segments(schema: Schema, table_config: TableConfig,
                     segments: List[ImmutableSegment], out_dir: str,
                     config: ProcessorConfig) -> List[str]:
    """Run the full map -> partition -> reduce pipeline; returns the built
    segment directories."""
    chunks = []
    for seg in segments:
        drop = config.drop_mask_fn(seg) if config.drop_mask_fn else None
        chunks.append(_segment_columns(seg, drop))
    cols = _concat(chunks)
    if config.transform is not None and cols:
        cols = config.transform(cols)

    builder = SegmentBuilder(schema, table_config)
    out_dirs: List[str] = []
    seq = 0
    for group in _partition_groups(cols, config):
        if config.rollup is not None:
            group = _rollup(group, schema, config.rollup)
        n = len(next(iter(group.values()))) if group else 0
        target = max(config.target_rows_per_segment, 1)
        for lo in range(0, n, target):
            part = {k: v[lo: lo + target] for k, v in group.items()}
            name = f"{config.segment_name_prefix}_{seq}"
            seq += 1
            out_dirs.append(builder.build(part, out_dir, name))
    return out_dirs
