"""Ecosystem connectors: query results and raw segments as pandas /
numpy / torch structures.

Reference parity: pinot-connectors/ (pinot-spark-connector,
pinot-spark-3-connector, pinot-flink-connector) — their read path plans
a table scan, splits it per segment/server, and hands each split to the
compute framework as that framework's native rows. The Python data
ecosystem's "Spark" is pandas/torch, so the connector surface here is:

- ``read_sql``       broker SQL -> pandas.DataFrame
- ``read_table``     whole-table (or column-projected) scan over the
                     segments a data manager holds -> DataFrame, one
                     per-segment split at a time like the Spark
                     connector's PinotInputPartition
- ``to_torch``       DataFrame/ResultTable -> dict of torch tensors
                     (the feature-ingest handoff)

Writes go the other way through the batch ingestion job spec
(ingestion/batch.py), which is the reference's write-connector shape.

Port of ``pinot_tpu/connectors/__init__.py``. ``to_torch`` puts the
tensors on the device the caller names (``device=``; the CPU when none
is named, as in the reference).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np


def _pandas():
    import pandas as pd
    return pd


def _to_frame(res: Any):
    """ResultTable -> DataFrame (shared by read_sql and to_torch)."""
    pd = _pandas()
    return pd.DataFrame([tuple(r) for r in res.rows], columns=res.columns)


def read_sql(conn: Any, sql: str):
    """Execute SQL through any connection-ish object (in-process
    ``connect()`` callable, Broker, or HttpConnection) -> DataFrame."""
    if callable(conn) and not hasattr(conn, "query") \
            and not hasattr(conn, "execute"):
        res = conn(sql)
    elif hasattr(conn, "execute"):
        res = conn.execute(sql)
    else:
        res = conn.query(sql)
    return _to_frame(res)


def iter_segment_frames(dm: Any, columns: Optional[Sequence[str]] = None
                        ) -> Iterator[Any]:
    """One DataFrame per segment split (PinotInputPartition analog):
    callers stream the table without materializing it whole."""
    pd = _pandas()
    for seg in dm.acquire_segments():
        cols = list(columns) if columns else list(seg.columns)
        data = {}
        for c in cols:
            vals = np.asarray(seg.raw_values(c))
            if not getattr(seg.columns[c], "single_value", True):
                vals = list(vals)  # ragged MV rows stay python lists
            nm = seg.null_mask(c)
            if nm is not None and np.any(nm):
                # surface NULLs as None/NaN, not stored default values
                # (training on default-0 "nulls" silently corrupts).
                # Build the object vector explicitly: np.asarray over
                # equal-length row lists would go 2-D and break pandas
                obj = np.empty(len(vals), dtype=object)
                for i, x in enumerate(vals):
                    obj[i] = x
                obj[np.asarray(nm)] = None
                vals = obj
            data[c] = vals
        frame = pd.DataFrame(data)
        if seg.valid_docs is not None:
            frame = frame[np.asarray(seg.valid_docs)].reset_index(
                drop=True)
        yield frame


def read_table(dm: Any, columns: Optional[Sequence[str]] = None):
    """Whole table -> one DataFrame (concat of the per-segment splits)."""
    pd = _pandas()
    frames = list(iter_segment_frames(dm, columns))
    if not frames:
        return pd.DataFrame(columns=list(columns or []))
    return pd.concat(frames, ignore_index=True)


def to_torch(frame_or_result: Any, device: Any = None) -> Dict[str, Any]:
    """Numeric columns -> torch tensors (strings stay out; the caller
    encodes those through the table dictionaries if needed), on
    ``device`` when one is named."""
    import torch
    if hasattr(frame_or_result, "rows"):  # ResultTable
        frame_or_result = _to_frame(frame_or_result)
    out: Dict[str, Any] = {}
    for name in frame_or_result.columns:
        col = frame_or_result[name].to_numpy()
        if col.dtype == object or col.dtype.kind in "US":
            continue
        # copy: segment memmaps are read-only and torch tensors must be
        # writable (training code mutates feature buffers in place)
        t = torch.from_numpy(np.array(col, copy=True, order="C"))
        out[name] = t if device is None else t.to(device)
    return out
