"""Built-in minion tasks.

Reference parity: pinot-plugins/pinot-minion-tasks/
pinot-minion-builtin-tasks/.../tasks/ — MergeRollupTaskExecutor,
PurgeTaskExecutor, RealtimeToOfflineSegmentsTaskExecutor,
SegmentGenerationAndPushTaskExecutor, UpsertCompactionTaskExecutor. Each
executor here is a function (spec, context) -> result dict registered with
the framework; segment swap-in/swap-out mirrors the reference's segment
lineage replace (upload new segments, drop originals).

Port of ``pinot_tpu/minion/tasks.py``. A new segment is registered with
``add_segment_dir``, which loads it on the data manager's device.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np

from ..query.sql import parse_sql
from ..segment.builder import SegmentBuilder
from ..segment.immutable import ImmutableSegment
from ..spi.config import TableConfig
from .framework import MinionContext, TaskSpec, register_task_executor
from .processing import ProcessorConfig, RollupConfig, process_segments


def _table_config(dm, spec: TaskSpec) -> TableConfig:
    cfg = getattr(dm, "table_config", None)
    return cfg if cfg is not None else TableConfig(spec.table)


def _pick_segments(dm, names) -> List[ImmutableSegment]:
    segs = [s for s in dm.acquire_segments()
            if isinstance(s, ImmutableSegment)]
    if names:
        wanted = set(names)
        segs = [s for s in segs if s.name in wanted]
    return segs


def _swap(dm, old_segments: List[ImmutableSegment],
          new_dirs: List[str]) -> Dict[str, Any]:
    """Segment-lineage replace: register the new artifacts, then drop the
    inputs (startReplaceSegments/endReplaceSegments analog)."""
    for d in new_dirs:
        dm.add_segment_dir(d)
    for s in old_segments:
        dm.remove_segment(s.name)
    return {"inputSegments": [s.name for s in old_segments],
            "outputSegments": [os.path.basename(d) for d in new_dirs]}


def merge_rollup_task(spec: TaskSpec, ctx: MinionContext) -> Dict[str, Any]:
    """Merge small segments (optionally rolling up duplicate dim tuples)."""
    dm = ctx.table(spec.table)
    segs = _pick_segments(dm, spec.config.get("segments"))
    if len(segs) < 2:
        return {"skipped": "fewer than 2 input segments"}
    rollup = spec.config.get("rollup")
    pcfg = ProcessorConfig(
        rollup=RollupConfig(dict(rollup)) if rollup is not None else None,
        time_column=spec.config.get("timeColumn"),
        time_bucket_ms=spec.config.get("bucketMs"),
        target_rows_per_segment=int(spec.config.get("targetRows", 1 << 20)),
        segment_name_prefix=spec.config.get("prefix",
                                            f"{spec.table}_merged"
                                            f"_{spec.task_id}"))
    out_dirs = process_segments(dm.schema, _table_config(dm, spec), segs,
                                ctx.out_dir, pcfg)
    return _swap(dm, segs, out_dirs)


def purge_task(spec: TaskSpec, ctx: MinionContext) -> Dict[str, Any]:
    """Rewrite segments dropping rows that match the purge predicate
    (config 'where': SQL boolean expression — the RecordPurger analog)."""
    dm = ctx.table(spec.table)
    segs = _pick_segments(dm, spec.config.get("segments"))
    where = spec.config.get("where")
    if not where:
        raise ValueError("PurgeTask needs config['where']")
    stmt = parse_sql(f"SELECT * FROM {spec.table} WHERE {where} LIMIT 1")
    from ..engine.host_eval import eval_filter

    def drop_mask(seg: ImmutableSegment) -> np.ndarray:
        return eval_filter(stmt.where, seg)

    purged = 0
    new_dirs: List[str] = []
    replaced: List[ImmutableSegment] = []
    builder_cfg = _table_config(dm, spec)
    for seg in segs:
        mask = drop_mask(seg)
        if not mask.any():
            continue  # untouched segments stay as-is
        purged += int(mask.sum())
        pcfg = ProcessorConfig(
            drop_mask_fn=lambda s, m=mask: m,
            target_rows_per_segment=max(seg.n_docs, 1),
            segment_name_prefix=f"{seg.name}_purged")
        new_dirs.extend(process_segments(dm.schema, builder_cfg, [seg],
                                         ctx.out_dir, pcfg))
        replaced.append(seg)
    result = _swap(dm, replaced, new_dirs)
    result["rowsPurged"] = purged
    return result


def upsert_compaction_task(spec: TaskSpec, ctx: MinionContext
                           ) -> Dict[str, Any]:
    """Rewrite segments keeping only validDocIds rows; the compacted
    artifact needs no valid mask (UpsertCompactionTaskExecutor analog)."""
    dm = ctx.table(spec.table)
    segs = _pick_segments(dm, spec.config.get("segments"))
    new_dirs: List[str] = []
    replaced: List[ImmutableSegment] = []
    removed = 0
    builder_cfg = _table_config(dm, spec)
    for seg in segs:
        vd = getattr(seg, "valid_docs", None)
        if vd is None or vd[: seg.n_docs].all():
            continue
        removed += int(seg.n_docs - vd[: seg.n_docs].sum())
        pcfg = ProcessorConfig(
            target_rows_per_segment=max(seg.n_docs, 1),
            segment_name_prefix=f"{seg.name}_compacted")
        # _segment_columns already honors valid_docs
        new_dirs.extend(process_segments(dm.schema, builder_cfg, [seg],
                                         ctx.out_dir, pcfg))
        replaced.append(seg)
    result = _swap(dm, replaced, new_dirs)
    result["invalidDocsRemoved"] = removed
    return result


def realtime_to_offline_task(spec: TaskSpec, ctx: MinionContext
                             ) -> Dict[str, Any]:
    """Move sealed realtime segments into the offline table, re-bucketed by
    time window (RealtimeToOfflineSegmentsTaskExecutor analog)."""
    rt_dm = ctx.table(spec.table)
    off_dm = ctx.offline_tables.get(spec.table)
    if off_dm is None:
        raise ValueError(f"no offline table registered for {spec.table!r}")
    segs = _pick_segments(rt_dm, spec.config.get("segments"))
    if not segs:
        return {"skipped": "no sealed realtime segments"}
    pcfg = ProcessorConfig(
        time_column=spec.config.get("timeColumn"),
        time_bucket_ms=spec.config.get("bucketMs"),
        rollup=(RollupConfig(dict(spec.config["rollup"]))
                if spec.config.get("rollup") is not None else None),
        target_rows_per_segment=int(spec.config.get("targetRows", 1 << 20)),
        segment_name_prefix=spec.config.get(
            "prefix", f"{spec.table}_offline_{spec.task_id}"))
    out_dirs = process_segments(rt_dm.schema, _table_config(rt_dm, spec),
                                segs, ctx.out_dir, pcfg)
    for d in out_dirs:
        off_dm.add_segment_dir(d)
    for s in segs:
        rt_dm.remove_segment(s.name)
    return {"inputSegments": [s.name for s in segs],
            "outputSegments": [os.path.basename(d) for d in out_dirs]}


def segment_generation_and_push_task(spec: TaskSpec, ctx: MinionContext
                                     ) -> Dict[str, Any]:
    """Build a segment from an input file and register it with the table
    (SegmentGenerationAndPushTaskExecutor analog; batch ingestion's
    one-shot path)."""
    dm = ctx.table(spec.table)
    path = spec.config.get("inputPath")
    fmt = str(spec.config.get("format", "csv")).lower()
    if not path or not os.path.exists(path):
        raise ValueError(f"inputPath missing or not found: {path!r}")
    from ..inputformat import read_records
    rows = read_records(path, fmt,
                        **(spec.config.get("formatArgs") or {}))
    schema = dm.schema
    if schema is None:
        raise ValueError(f"table {spec.table!r} has no schema "
                         "(set dm.schema or load a segment first)")
    builder = SegmentBuilder(schema, _table_config(dm, spec))
    name = spec.config.get("segmentName",
                           f"{spec.table}_{spec.task_id}")
    seg_dir = builder.build(rows, ctx.out_dir, name)
    dm.add_segment_dir(seg_dir)
    return {"outputSegments": [name], "rows": len(rows)}


register_task_executor("MergeRollupTask", merge_rollup_task)
register_task_executor("PurgeTask", purge_task)
register_task_executor("UpsertCompactionTask", upsert_compaction_task)
register_task_executor("RealtimeToOfflineSegmentsTask",
                       realtime_to_offline_task)
register_task_executor("SegmentGenerationAndPushTask",
                       segment_generation_and_push_task)
