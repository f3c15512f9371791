"""Upsert and dedup metadata managers.

Port of ``pinot_tpu/upsert/metadata.py``, line for line. Invalidating a
document of a sealed segment goes through the port's
``ImmutableSegment.set_valid_docs``, which bumps the mask's version and
drops its stale device and warm copies, so the next kernel query uploads
the new mask.

Reference parity: pinot-segment-local/.../upsert/
ConcurrentMapPartitionUpsertMetadataManager.java (primary key -> latest
(segment, docId, comparisonValue); newer-or-equal comparison value wins;
the superseded location's validDocIds bit drops) and dedup/
ConcurrentMapPartitionDedupMetadataManager.java (PK seen -> row dropped at
ingestion). TPU-native difference: validDocIds are plain numpy bool masks
that fold into the kernel's filter mask as a MaskParam (masks replace
RoaringBitmap throughout this engine); restart rehydrates by replaying
committed segments' PK/comparison columns in commit order instead of
reading bitmap snapshots (which are still persisted for inspection).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _compact_crash(key: str) -> None:
    """Named ingest fault hook (``upsert.compact_crash``): simulated
    process death mid metadata replay / TTL eviction. Raises IngestCrash
    — the owning realtime manager must be abandoned and restarted; the
    restart replay rebuilds this manager from committed segments, which
    is what makes the crash recoverable."""
    from ..utils import faults
    if faults.active() and faults.fault_fires("upsert.compact_crash",
                                              key):
        raise faults.IngestCrash(
            f"injected upsert.compact_crash ({key})")


@dataclass
class UpsertConfig:
    pk_columns: List[str]
    comparison_column: Optional[str] = None  # None -> stream order wins
    # partial upsert (reference UpsertConfig.Mode.PARTIAL +
    # partialUpsertStrategies) and metadata TTL (metadataTTL, in
    # comparison-value units)
    mode: str = "full"                       # "full" | "partial"
    partial_strategies: Dict[str, str] = field(default_factory=dict)
    default_strategy: str = "overwrite"
    metadata_ttl: Optional[float] = None

    def __post_init__(self):
        if self.mode not in ("full", "partial"):
            raise ValueError(f"upsert mode must be full|partial, "
                             f"got {self.mode!r}")
        if self.metadata_ttl is not None and self.metadata_ttl <= 0:
            raise ValueError("metadata_ttl must be > 0")


@dataclass
class DedupConfig:
    pk_columns: List[str]


class PartitionUpsertMetadataManager:
    """Tracks PK -> (segment_object, doc_id, comparison_value).

    ``site_key`` carries table/partition identity into the
    upsert.compact_crash fault decisions (faults.py purity contract:
    per-key streams must not be shared across partitions, or
    same-seed fault assignment becomes thread-interleaving-dependent)."""

    def __init__(self, config: UpsertConfig, site_key: str = ""):
        self.config = config
        self.site_key = site_key
        self._map: Dict[Tuple, Tuple[Any, int, Any]] = {}
        self._lock = threading.Lock()
        self._largest_cmp: Any = None   # TTL watermark (reference:
        # BasePartitionUpsertMetadataManager._largestSeenComparisonValue)
        self._last_evict_watermark: Any = None
        self.merger = None
        if config.mode == "partial":
            from .merger import PartialUpsertMerger
            self.merger = PartialUpsertMerger(
                config.pk_columns, config.comparison_column,
                config.partial_strategies, config.default_strategy)

    def prepare_row(self, row) -> Any:
        """Partial upsert: merge the incoming row with the current live
        row for its PK BEFORE indexing (PartialUpsertColumnarMerger is
        applied on ingestion in the reference too). Full mode and
        first-seen PKs return the row unchanged."""
        if self.merger is None:
            return row
        pk = self._pk(row)
        with self._lock:
            cur = self._map.get(pk)
        if cur is None:
            return row
        from .merger import read_row
        seg, doc, _cmp = cur
        return self.merger.merge(read_row(seg, doc), dict(row))

    def _note_cmp(self, cmp_val: Any) -> None:
        if isinstance(cmp_val, (int, float)) and (
                self._largest_cmp is None or cmp_val > self._largest_cmp):
            self._largest_cmp = cmp_val

    def evict_expired(self) -> int:
        """Metadata TTL: drop tracking for PKs whose comparison value
        fell behind the watermark by more than metadata_ttl. Their rows
        stay queryable — only upsert management stops (reference
        removeExpiredPrimaryKeys semantics). Returns evicted count."""
        ttl = self.config.metadata_ttl
        if ttl is None or self._largest_cmp is None:
            return 0
        if self._largest_cmp == self._last_evict_watermark:
            return 0   # watermark unchanged: the O(keys) scan is skipped
        _compact_crash(f"evict/{self.site_key}")
        self._last_evict_watermark = self._largest_cmp
        horizon = self._largest_cmp - ttl
        with self._lock:
            stale = [pk for pk, (_s, _d, c) in self._map.items()
                     if isinstance(c, (int, float)) and c < horizon]
            for pk in stale:
                del self._map[pk]
        return len(stale)

    def _pk(self, row) -> Tuple:
        return tuple(row[c] for c in self.config.pk_columns)

    def _cmp(self, row, fallback: Any) -> Any:
        if self.config.comparison_column is None:
            return fallback
        return row[self.config.comparison_column]

    def add_row(self, segment, doc_id: int, row, order_token: Any
                ) -> bool:
        """Record a newly-indexed row. Returns True if it becomes the live
        one (invalidating any previous location), False if it loses to an
        existing newer record (its own bit should drop)."""
        pk = self._pk(row)
        cmp_val = self._cmp(row, order_token)
        self._note_cmp(cmp_val)
        with self._lock:
            cur = self._map.get(pk)
            if cur is not None:
                cur_seg, cur_doc, cur_cmp = cur
                if cmp_val >= cur_cmp:  # newer-or-equal wins (reference)
                    _invalidate(cur_seg, cur_doc)
                    self._map[pk] = (segment, doc_id, cmp_val)
                    return True
                _invalidate(segment, doc_id)
                return False
            self._map[pk] = (segment, doc_id, cmp_val)
            return True

    def replay_segment(self, segment, rows_pk: List[Tuple],
                       cmp_vals: List[Any]) -> None:
        """Restart rehydration: replay a committed segment's keys in doc
        order; builds this segment's valid mask and supersedes older ones."""
        _compact_crash(getattr(segment, "name", "replay"))
        valid = np.ones(len(rows_pk), dtype=bool)
        for c in cmp_vals:
            self._note_cmp(c)
        with self._lock:
            for doc_id, (pk, cmp_val) in enumerate(zip(rows_pk, cmp_vals)):
                cur = self._map.get(pk)
                if cur is not None:
                    cur_seg, cur_doc, cur_cmp = cur
                    if cmp_val >= cur_cmp:
                        if cur_seg is segment:
                            valid[cur_doc] = False
                        else:
                            _invalidate(cur_seg, cur_doc)
                        self._map[pk] = (segment, doc_id, cmp_val)
                    else:
                        valid[doc_id] = False
                else:
                    self._map[pk] = (segment, doc_id, cmp_val)
        # publish unconditionally AFTER the rebuild: the caller must never
        # pre-clear to None (that would expose superseded rows to queries
        # running concurrently with the replay)
        segment.set_valid_docs(valid if not valid.all() else None)

    def remap_segment(self, old, new, sealed_docs: int) -> None:
        """Seal: locations recorded against the consuming segment now live
        in the committed artifact. Docs >= sealed_docs were indexed after
        the seal snapshot and exist only in the dropped mutable — their
        entries are removed so the re-consumed copies re-register cleanly
        (repointing them would index past the artifact's mask)."""
        with self._lock:
            for pk, (seg, doc, cmp_val) in list(self._map.items()):
                if seg is old:
                    if doc < sealed_docs:
                        self._map[pk] = (new, doc, cmp_val)
                    else:
                        del self._map[pk]

    @property
    def num_keys(self) -> int:
        return len(self._map)


def _invalidate(segment, doc_id: int) -> None:
    if hasattr(segment, "invalidate_doc"):        # MutableSegment
        segment.invalidate_doc(doc_id)
        return
    # ImmutableSegment: copy-on-write mask update + version bump
    vd = segment.valid_docs
    if vd is None:
        vd = np.ones(segment.n_docs, dtype=bool)
    else:
        vd = vd.copy()
    vd[doc_id] = False
    segment.set_valid_docs(vd)


class PartitionDedupMetadataManager:
    """Exactly-once by PK: drop duplicate rows at ingestion."""

    def __init__(self, config: DedupConfig):
        self.config = config
        self._seen: set = set()
        self._lock = threading.Lock()

    def should_drop(self, row) -> bool:
        pk = tuple(row[c] for c in self.config.pk_columns)
        with self._lock:
            if pk in self._seen:
                return True
            self._seen.add(pk)
            return False

    def replay_segment(self, segment, rows_pk: List[Tuple]) -> None:
        with self._lock:
            self._seen.update(rows_pk)

    @property
    def num_keys(self) -> int:
        return len(self._seen)
