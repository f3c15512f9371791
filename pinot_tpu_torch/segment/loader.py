"""Segment reload: reconcile a built segment's indexes with the current
table config, in place.

Reference parity: pinot-segment-local/.../segment/index/loader/ (the
IndexHandler family run by ImmutableSegmentLoader's preprocessing): when
a TableConfig gains or loses index definitions, servers rebuild the
affected index files on the already-built segment instead of re-ingesting
— the reload path behind the controller's "reload table/segment" REST
operations. The TPU-native segment keeps one metadata.json, so
reconciliation is: build missing index files from the stored forward
index + dictionary, delete stale ones, rewrite column metadata
atomically.

Port of ``pinot_tpu/segment/loader.py``. The reconcile reads only host
data, so it loads the segment on the CPU whatever the table's device.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from ..spi.config import TableConfig
from .builder import METADATA_FILE
from . import segdir
from .immutable import ImmutableSegment


def reconcile_indexes(seg_dir: str, table_config: TableConfig
                      ) -> Dict[str, List[str]]:
    """Align the segment's secondary indexes with table_config.

    Returns {"added": ["col:kind", ...], "removed": [...]}. No-ops when
    nothing changed. The forward index and dictionaries are never
    touched — only secondary indexes reconcile (IndexHandler contract).
    """
    from .. import index as index_pkg

    meta_path = os.path.join(seg_dir, METADATA_FILE)
    with open(meta_path) as fh:
        meta = json.load(fh)
    seg = ImmutableSegment.load(seg_dir, "cpu")   # host reads only
    idx_cfg = table_config.indexing

    # pass 1: plan + validate EVERYTHING before touching any file, so a
    # config error can't strand metadata pointing at deleted indexes
    plan: List[tuple] = []  # (name, cmeta, to_add, to_remove)
    for name, cmeta in meta["columns"].items():
        if cmeta.get("encoding") == "VECTOR":
            continue  # vector storage IS the index; no reload semantics
        have = set(cmeta.get("indexes", {}) or {})
        want = set(idx_cfg.indexes_for(name))
        if have == want:
            continue
        to_add = sorted(want - have)
        if "inverted" in to_add and not seg.columns[name].has_dict:
            raise ValueError(f"inverted index needs a dictionary "
                             f"column: {name!r}")
        plan.append((name, cmeta, to_add, sorted(have - want)))

    # pass 2: build additions (new files; a crash here leaves unreferenced
    # extras, never a dangling metadata entry)
    added: List[str] = []
    removed: List[str] = []
    for name, cmeta, to_add, to_remove in plan:
        m = seg.columns[name]
        if to_add:
            built = index_pkg.build_indexes_for_column(
                name, to_add, seg_dir, values=seg.raw_values(name),
                ids=np.asarray(seg.fwd(name)) if m.has_dict else None,
                cardinality=m.cardinality,
                configs={"geo": idx_cfg.geo_index_columns.get(name) or {}})
            cmeta.setdefault("indexes", {}).update(built)
            added.extend(f"{name}:{k}" for k in to_add)
        for kind in to_remove:
            cmeta["indexes"].pop(kind, None)
            removed.append(f"{name}:{kind}")
        if not cmeta.get("indexes"):
            cmeta.pop("indexes", None)

    if not (added or removed):
        return {"added": [], "removed": []}

    # pass 3: atomic metadata swap, THEN delete files nothing references
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(meta, fh, indent=1)
    os.replace(tmp, meta_path)  # readers see old or new, never half
    for name, _cmeta, _a, to_remove in plan:
        for kind in to_remove:
            _remove_index_files(seg_dir, name, kind)
    # v3 segments: absorb freshly built loose index files into the packed
    # file (the reference's v3 SegmentDirectory.Writer appends the same
    # way; removal above only dropped map entries, bytes repack later)
    segdir.fold_new_files(seg_dir)
    return {"added": added, "removed": removed}


def _remove_index_files(seg_dir: str, col: str, kind: str) -> None:
    from ..index.registry import FILE_STEMS  # module-owned suffixes
    for suffix in FILE_STEMS.get(kind, (f".{kind}",)):
        stem = col + suffix
        doomed = [fn for fn in segdir.entry_names(seg_dir)
                  if fn == stem or fn.startswith(stem + ".")]
        segdir.remove_entries(seg_dir, doomed)
        for fn in doomed:
            path = os.path.join(seg_dir, fn)
            if os.path.exists(path):
                os.remove(path)
