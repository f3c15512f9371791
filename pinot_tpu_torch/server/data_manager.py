"""Table data manager: the segments of one table on one device.

Port of the segment registry of ``pinot_tpu/server/data_manager.py``
(add, remove, replace, acquire, a table directory, counts, and ``reload``,
which reconciles every segment's secondary indexes with the table config).
Every segment of a table lives on the table's ``device``. A realtime
table (``realtime/manager.py``) adds its consuming snapshots to
``acquire_segments``; ``reload`` skips them, as they have no files yet.
A table may also be resident on a mesh (``set_distributed``, a
``parallel/distributed.DistributedTable``): the broker then prefers it for
kernel-plan aggregations.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Union

import torch

from ..device import resolve_device
from ..ops.plan_cache import global_cube_cache
from ..segment import segdir
from ..segment.immutable import ImmutableSegment


class TableDataManager:
    def __init__(self, table_name: str,
                 device: Union[str, torch.device, None] = None,
                 table_config=None):
        self.table_name = table_name
        self.device = resolve_device(device)
        self.table_config = table_config  # TableConfig | None
        self._segments: Dict[str, ImmutableSegment] = {}
        self._lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._schema = None
        # optional mesh-resident DistributedTable (parallel/distributed.py);
        # the broker prefers it for kernel-plan aggregations
        self.distributed = None

    def set_distributed(self, distributed) -> None:
        """Make ``distributed`` (or None) the table's mesh-resident copy;
        the copy it replaces leaves the mesh (its stacks are freed)."""
        old, self.distributed = self.distributed, distributed
        if old is not None and old is not distributed:
            old.close()

    def add_segment(self, segment: ImmutableSegment) -> None:
        if segment.device != self.device:
            raise ValueError(f"segment {segment.name!r} is on "
                             f"{segment.device}, table {self.table_name!r} "
                             f"on {self.device}")
        with self._lock:
            self._segments = {**self._segments, segment.name: segment}

    def add_segment_dir(self, seg_dir: str) -> ImmutableSegment:
        seg = ImmutableSegment.load(seg_dir, self.device)
        self.add_segment(seg)
        return seg

    def add_table_dir(self, table_dir: str) -> List[ImmutableSegment]:
        """Load every segment directory under a table directory."""
        out = []
        for name in sorted(os.listdir(table_dir)):
            d = os.path.join(table_dir, name)
            if os.path.isdir(d) and os.path.exists(
                    os.path.join(d, "metadata.json")):
                out.append(self.add_segment_dir(d))
        return out

    def remove_segment(self, name: str) -> None:
        """Drop a segment and release its device residency now (padded
        columns, warm copies, every stacked copy and cube holding it), so
        the device-memory registry stops counting it; queries in flight
        keep their own tensor references, and what they upload after this
        is not cached (``ImmutableSegment.retire``)."""
        with self._lock:
            segs = dict(self._segments)
            seg = segs.pop(name, None)
            self._segments = segs
        if seg is not None:
            seg.retire()
            segdir.invalidate(seg.dir)

    def replace_segment(self, segment: ImmutableSegment) -> None:
        """Atomic swap by name; the replaced segment's cubes are released
        (they are keyed by its uid and could never be served again)."""
        old = self._segments.get(segment.name)
        self.add_segment(segment)
        if old is not None and old is not segment:
            global_cube_cache.evict_containing(old.name)

    def reload(self, table_config=None) -> Dict[str, List[str]]:
        """Reconcile every hosted segment's secondary indexes with the
        table config (segment/loader.py) and swap in freshly loaded
        segments. Returns the union of per-segment {'added', 'removed'}
        changes."""
        from ..segment.loader import reconcile_indexes
        cfg = table_config or self.table_config
        if cfg is None:
            raise ValueError("reload needs a TableConfig")
        self.table_config = cfg
        changes: Dict[str, List[str]] = {"added": [], "removed": []}
        with self._reload_lock:  # one reconcile per table at a time
            for seg in self.acquire_segments():
                if getattr(seg, "is_mutable", False):
                    continue  # a consuming snapshot: no files, no indexes
                # in-flight queries may hold the OLD segment and open
                # index files lazily; opening its readers now means it
                # never touches a file this reload is about to delete
                for col, m in seg.columns.items():
                    for kind in list(m.indexes):
                        try:
                            seg.index_reader(col, kind)
                        except OSError:
                            pass    # unreadable: not in use
                delta = reconcile_indexes(seg.dir, cfg)
                if delta["added"] or delta["removed"]:
                    seg.evict_device()
                    self.replace_segment(
                        ImmutableSegment.load(seg.dir, self.device))
                    changes["added"].extend(delta["added"])
                    changes["removed"].extend(delta["removed"])
        return changes

    def acquire_segments(self) -> List[ImmutableSegment]:
        return list(self._segments.values())

    @property
    def schema(self):
        """Table schema: the declared one if set (a realtime table sets it
        at construction), else any loaded segment's (None without
        one)."""
        if self._schema is not None:
            return self._schema
        for s in self._segments.values():
            return s.schema
        return None

    @schema.setter
    def schema(self, value) -> None:
        self._schema = value

    @property
    def num_segments(self) -> int:
        return len(self._segments)

    @property
    def total_docs(self) -> int:
        return sum(s.n_docs for s in self._segments.values())
