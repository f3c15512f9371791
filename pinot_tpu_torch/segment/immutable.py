"""Immutable segment: memmap load + padded device residency in torch.

Port of ``pinot_tpu/segment/immutable.py``. The host side is the same:
forward indexes and dictionaries memmap zero-copy from the segment
directory that either package's builder wrote. The device side keeps
torch tensors on the segment's own ``device``, padded to the same pow2
``bucket`` (``bucket_for``), uploaded from pinned host memory and cached
per column. Every cache insert goes through ``_cache_device``, the one
admission edge of the device tier (``engine/tier.py``): it charges the
device-memory registry (``utils/devmem``), keeps the padded host array
warm while a budget is armed, and lets the tier demote colder segments.
A demoted segment's next read re-promotes it, from the warm copy when
there is one. Secondary indexes load lazily through ``index_reader``
(index/registry.py); a vector index reader lives on the segment's device,
accounts its tensors in the ``vector`` pool as (uid, col) and is demoted
with the segment.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..engine.tier import global_tier
from ..spi.schema import DataType, Schema
from ..utils import leak
from ..utils.devmem import global_device_memory
from ..utils.heat import global_segment_heat
from . import segdir
from .builder import METADATA_FILE
from .dictionary import Dictionary

MIN_BUCKET = 1 << 10

_SEG_UID = itertools.count(1)
# dictionary ids widen to this on the device
_ID_DTYPE = np.dtype(np.int32)


def bucket_for(n_docs: int, min_bucket: int = MIN_BUCKET) -> int:
    b = min_bucket
    while b < n_docs:
        b <<= 1
    return b


class ColumnMeta:
    def __init__(self, name: str, d: Dict[str, Any]):
        self.name = name
        self.data_type = DataType(d["dataType"])
        self.field_type = d["fieldType"]
        self.encoding = d["encoding"]  # DICT | RAW
        self.fwd_dtype = np.dtype(d["fwdDtype"])
        self.fwd_format = d.get("fwdFormat", "PLAIN")  # |BITPACK|COMPRESSED
        self.bits = d.get("bits")
        self.codec = d.get("codec")
        self.raw_size = d.get("rawSize")
        self.cardinality = d.get("cardinality", 0)
        self.is_sorted = d.get("isSorted", False)
        self.min = d.get("min")
        self.max = d.get("max")
        self.has_nulls = d.get("hasNulls", False)
        self.dict_format = d.get("dictFormat")
        self.dict_dtype = d.get("dictDtype")
        self.partitions = d.get("partitions")
        self.single_value = d.get("singleValue", True)
        self.max_values = d.get("maxValues")  # MV: padded row width
        self.indexes: Dict[str, Any] = d.get("indexes", {})

    @property
    def has_dict(self) -> bool:
        return self.encoding == "DICT"


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    host = np.ascontiguousarray(host)
    if not host.flags.writeable:      # a read-only memmap of the segment
        host = host.copy()
    t = torch.from_numpy(host)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class ImmutableSegment:
    """A loaded immutable segment: host memmaps + a device tensor cache on
    ``device``."""

    def __init__(self, seg_dir: str,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        self.dir = seg_dir
        with open(os.path.join(seg_dir, METADATA_FILE)) as fh:
            self.metadata = json.load(fh)
        self.name: str = self.metadata["segmentName"]
        self.n_docs: int = self.metadata["totalDocs"]
        self.schema = Schema.from_dict(self.metadata["schema"])
        self.columns: Dict[str, ColumnMeta] = {
            name: ColumnMeta(name, d)
            for name, d in self.metadata["columns"].items()}
        # process-unique load identity: caches that outlive the segment
        # object (engine/batch's stacked columns) key on it, never on the
        # name, which recurs across tables and reloads at the same bucket
        self.uid: int = next(_SEG_UID)
        self._fwd: Dict[str, np.ndarray] = {}
        self._dicts: Dict[str, Dictionary] = {}
        self._index_readers: Dict[Tuple[str, str], Any] = {}
        self._nulls: Dict[str, Optional[np.ndarray]] = {}
        self._device: Dict[Tuple[str, int], torch.Tensor] = {}
        # warm tier (engine/tier.py): padded host arrays kept after a
        # demotion so re-promotion is one upload, no re-pad; only filled
        # while a tier budget is armed
        self._warm: Dict[Tuple[str, int], np.ndarray] = {}
        # residency lock: a cache insert (+ its devmem add) and a
        # demotion's drain (+ its devmem removes) are atomic with respect
        # to each other, or a concurrent demotion could drop a tensor whose
        # bytes were just registered. Reads (a dict get) take no lock: a
        # racy miss only uploads again.
        self._res_lock = threading.Lock()
        # set by retire(): the segment left its table, so a query still
        # running on it uploads what it reads without caching it
        self._retired = False
        self.valid_docs: Optional[np.ndarray] = None
        # bumped by every set_valid_docs: the device mask is cached under
        # its version, so a mask uploaded before an upsert invalidation is
        # never served after it
        self.valid_docs_version = 0
        if segdir.exists(seg_dir, "valid.bin"):
            # upsert validDocIds: the planner folds them into a
            # "validdocs" kernel param (device_valid_mask)
            bits = np.asarray(segdir.read_array(seg_dir, "valid.bin",
                                                np.uint8, mmap=False))
            self.valid_docs = np.unpackbits(bits)[: self.n_docs].astype(bool)
        leak.track(self, "segment", self.name)

    @classmethod
    def load(cls, seg_dir: str,
             device: Union[str, torch.device, None] = None
             ) -> "ImmutableSegment":
        return cls(seg_dir, device)

    # -- host access -------------------------------------------------------
    def fwd(self, col: str) -> np.ndarray:
        """Stored forward index (dict ids or raw values), host-side.

        PLAIN columns memmap zero-copy; BITPACK and COMPRESSED ones decode
        once through the native runtime (``native``) and stay cached here,
        so the device uploads see an ordinary int32 or raw column."""
        if col not in self._fwd:
            m = self.columns[col]
            name = f"{col}.fwd.bin"
            if m.fwd_format == "BITPACK":
                buf = np.ascontiguousarray(segdir.read_array(
                    self.dir, name, np.uint8))
                arr = native.fixedbit_unpack(buf, self.n_docs, m.bits)
            elif m.fwd_format == "COMPRESSED":
                comp = np.ascontiguousarray(segdir.read_array(
                    self.dir, name, np.uint8))
                raw = native.decompress(comp, m.raw_size, m.codec)
                arr = raw.view(m.fwd_dtype)[: self.n_docs]
            else:
                shape = ((self.n_docs,) if m.single_value
                         else (self.n_docs, m.max_values))
                arr = segdir.read_array(self.dir, name, m.fwd_dtype,
                                        shape=shape)
            self._fwd[col] = arr
        return self._fwd[col]

    def dictionary(self, col: str) -> Optional[Dictionary]:
        m = self.columns[col]
        if not m.has_dict:
            return None
        if col not in self._dicts:
            if m.dict_format == "json":
                vals = segdir.read_json(self.dir, f"{col}.dict.json")
            else:
                vals = np.asarray(segdir.read_array(
                    self.dir, f"{col}.dict.bin", np.dtype(m.dict_dtype),
                    mmap=False))
            self._dicts[col] = Dictionary(vals, m.data_type)
        return self._dicts[col]

    def null_mask(self, col: str) -> Optional[np.ndarray]:
        m = self.columns[col]
        if not m.has_nulls:
            return None
        if col not in self._nulls:
            bits = np.asarray(segdir.read_array(
                self.dir, f"{col}.null.bin", np.uint8, mmap=False))
            self._nulls[col] = np.unpackbits(bits)[: self.n_docs].astype(bool)
        return self._nulls[col]

    def index_reader(self, col: str, kind: str):
        """Lazy secondary-index reader; None when the column has no such
        index."""
        m = self.columns.get(col)
        if m is None or kind not in m.indexes:
            return None
        key = (col, kind)
        if key not in self._index_readers:
            from .. import index as index_pkg
            reader = index_pkg.load_index(self.dir, col, kind,
                                          m.indexes[kind])
            if kind == "vector":
                # the reader's tensors live on this segment's device,
                # account as (uid, col) in the vector pool, and their
                # uploads admit THIS segment to the tier
                reader.attach_owner(self, col)
            self._index_readers[key] = reader
        return self._index_readers[key]

    def raw_values(self, col: str) -> np.ndarray:
        """Decoded values (host-side; the host path and selection
        results)."""
        m = self.columns[col]
        if m.encoding == "VECTOR":
            return np.asarray(self.index_reader(col, "vector").matrix)
        stored = self.fwd(col)
        if not m.single_value:
            d = self.dictionary(col)
            out = np.empty(self.n_docs, dtype=object)
            for i, row in enumerate(np.asarray(stored)):
                ids = row[row >= 0]
                out[i] = list(d.values_for(ids))
            return out
        if m.has_dict:
            return self.dictionary(col).values_for(np.asarray(stored))
        return np.asarray(stored)

    # -- device residency --------------------------------------------------
    @property
    def bucket(self) -> int:
        return bucket_for(self.n_docs)

    def _cache_device(self, key: Tuple[str, int], t: torch.Tensor,
                      host: np.ndarray,
                      current: Optional[Callable[[], bool]] = None
                      ) -> torch.Tensor:
        """Every _device insert goes through here, so the device-memory
        registry reconciles with the cache and the tier sees every
        admission: the insert promotes this segment hot and enforces the
        shared budget. ``host`` is the uploaded host array; while a budget
        is armed it is stashed warm for a cheap re-promotion. When
        ``current()``, asked under the lock, says the key went stale while
        ``t`` was made, ``t`` is returned uncached: nothing would ask for
        that key again to release it."""
        with self._res_lock:
            if self._retired or (current is not None and not current()):
                return t
            self._device[key] = t
            global_device_memory.add("segment_cols", (self.uid, key),
                                     int(t.nbytes))
            if global_tier.armed:
                old = self._warm.get(key)
                self._warm[key] = host
                global_tier.note_warm(
                    self.uid, int(host.nbytes)
                    - (int(old.nbytes) if old is not None else 0))
        # tier admission OUTSIDE _res_lock: enforcement may demote OTHER
        # segments (their _res_lock), never nested under ours
        global_tier.admitted(self)
        return t

    def _cached(self, key: Tuple[str, int], make,
                current: Optional[Callable[[], bool]] = None
                ) -> torch.Tensor:
        """The cached device tensor under ``key``; on a miss, uploads the
        warm copy when one is stashed, else ``make()`` (cached unless
        ``current`` says the key went stale meanwhile). Returns the local
        reference: a racy demotion may drop the key right after."""
        hit = self._device.get(key)
        if hit is None:
            host = self._warm.get(key)
            if host is None:
                host = make()
            hit = self._cache_device(key, _upload(host, self.device), host,
                                     current)
        return hit

    def padded_dtype(self, col: str) -> np.dtype:
        """dtype of the padded representation: dict ids widen to int32,
        raw columns keep their stored dtype."""
        m = self.columns[col]
        return _ID_DTYPE if m.has_dict else m.fwd_dtype

    def padded_shape(self, col: str, bucket: Optional[int] = None
                     ) -> Tuple[int, ...]:
        m = self.columns[col]
        return ((bucket or self.bucket,) if m.single_value
                else (bucket or self.bucket, m.max_values))

    def fill_col_padded(self, col: str, out: np.ndarray) -> np.ndarray:
        """Write the bucket-padded representation of ``col`` into ``out``
        (``padded_shape`` x ``padded_dtype``) in one pass: the stored
        values, widened on the way, then the pad. SV padding is 0 (inert
        under the kernel's validity mask), MV rows pad with -1. The
        pipeline (engine/pipeline.py) fills its pinned staging buffers
        with it."""
        n = self.n_docs
        out[:n] = self.fwd(col)
        out[n:] = 0 if self.columns[col].single_value else -1
        return out

    def host_col_padded(self, col: str, bucket: Optional[int] = None
                        ) -> np.ndarray:
        """The bucket-padded host array device_col uploads (a fresh array
        from ``fill_col_padded``)."""
        return self.fill_col_padded(
            col, np.empty(self.padded_shape(col, bucket),
                          dtype=self.padded_dtype(col)))

    def device_col(self, col: str, bucket: Optional[int] = None
                   ) -> torch.Tensor:
        """Padded device tensor of a column's stored representation. Also
        the tier's re-promotion path: a demoted segment's read misses the
        cache and uploads again, from the warm host array when one is
        stashed, with the same bytes whatever the earlier placement."""
        bucket = bucket or self.bucket
        key = (col, bucket)
        # the observed device-cache hit ratio feeds the heat table
        global_segment_heat.device_access(self, key in self._device)
        # may demote THIS segment mid-query (a tensor already fetched
        # stays alive; later columns re-promote)
        global_tier.on_access(self)
        return self._cached(key, lambda: self.host_col_padded(col, bucket))

    def device_cols(self, cols: List[str], bucket: Optional[int] = None
                    ) -> Tuple[torch.Tensor, ...]:
        bucket = bucket or self.bucket
        return tuple(self.device_col(c, bucket) for c in cols)

    def device_dict_values(self, col: str) -> torch.Tensor:
        """Device-resident sorted dictionary values (id -> value gathers)."""
        m = self.columns[col]
        return self._cached(
            (f"__dict__{col}", 0),
            lambda: np.asarray(self.dictionary(col).values,
                               dtype=m.data_type.np_dtype))

    def device_dict_hashes(self, col: str) -> torch.Tensor:
        """Device-resident per-dict-id 64-bit hashes (the host ``_hash64``,
        md5 for strings) as int64 bit patterns: the sketch aggregations'
        ``hash64`` param, bit-identical to the host path's hashes."""
        from ..ops.aggregations import _hash64
        return self._cached(
            (f"__hash64__{col}", 0),
            lambda: _hash64(np.asarray(self.dictionary(col).values)
                            ).view(np.int64))

    def set_valid_docs(self, mask: Optional[np.ndarray]) -> None:
        """Publish a new upsert validDocIds mask (None: every doc valid)
        under a new version, and drop every stale copy of the old one: the
        device tensors (and their device-memory accounting) and the warm
        host arrays, which must never re-promote a superseded mask."""
        self.valid_docs = mask
        with self._res_lock:
            self.valid_docs_version += 1
            for key in [k for k in self._device
                        if k[0].startswith("__valid__")]:
                del self._device[key]
                global_device_memory.remove("segment_cols", (self.uid, key))
            for key in [k for k in self._warm
                        if k[0].startswith("__valid__")]:
                old = self._warm.pop(key)
                global_tier.note_warm(self.uid, -int(old.nbytes))

    def persist_valid_docs(self) -> None:
        """Snapshot validDocIds next to the segment as ``valid.bin`` (the
        reference's upsert snapshot); no mask removes the file."""
        path = os.path.join(self.dir, "valid.bin")
        if self.valid_docs is None:
            if os.path.exists(path):
                os.remove(path)
            return
        np.packbits(self.valid_docs).tofile(path)

    def device_valid_mask(self, bucket: Optional[int] = None
                          ) -> torch.Tensor:
        """Upsert validDocIds padded to the bucket (all live docs valid
        when the segment has none), cached under the mask's version. A
        mask made while ``set_valid_docs`` published a newer version is
        used once and not cached."""
        bucket = bucket or self.bucket
        version = self.valid_docs_version

        def make() -> np.ndarray:
            padded = np.zeros(bucket, dtype=bool)
            padded[: self.n_docs] = (True if self.valid_docs is None
                                     else self.valid_docs)
            return padded

        return self._cached(
            (f"__valid__v{version}", bucket), make,
            lambda: self.valid_docs_version == version)

    def device_null_mask(self, col: str, bucket: Optional[int] = None
                         ) -> torch.Tensor:
        bucket = bucket or self.bucket

        def make() -> np.ndarray:
            padded = np.zeros(bucket, dtype=bool)
            nm = self.null_mask(col)
            if nm is not None:
                padded[: len(nm)] = nm
            return padded

        return self._cached((f"__null__{col}", bucket), make)

    def resident_devices(self) -> Dict[str, str]:
        """Column -> device of every cached device tensor."""
        return {k[0]: str(t.device) for k, t in self._device.items()}

    def demote_device(self, drop_warm: bool = False) -> None:
        """Tier demotion (engine/tier.py): drop the device residents and
        every stacked copy and cube containing this segment (a demotion
        that left a stacked copy resident would free nothing). The warm host arrays
        survive for a cheap re-promotion unless ``drop_warm`` (host ->
        disk: the memmap is the only copy left). The drain is atomic with
        concurrent inserts (_res_lock), so devmem never tracks a tensor
        this demotion dropped."""
        with self._res_lock:
            for key in list(self._device):
                global_device_memory.remove("segment_cols", (self.uid, key))
            self._device.clear()
            if drop_warm:
                self._drop_warm_locked()
        from ..engine.batch import evict_stacks_containing
        from ..ops.plan_cache import global_cube_cache
        evict_stacks_containing(self.name)
        global_cube_cache.evict_containing(self.name)
        # the vector pool's tensors demote with the segment; the readers
        # upload again on their next search
        for (_col, kind), rd in list(self._index_readers.items()):
            if kind == "vector":
                rd.evict_device()

    def _drop_warm_locked(self) -> bool:  # holds-lock: _res_lock
        # caller holds self._res_lock
        if not self._warm:
            return False
        global_tier.note_warm(
            self.uid, -sum(int(a.nbytes) for a in self._warm.values()))
        self._warm.clear()
        return True

    def drop_warm(self) -> bool:
        """Release ONLY the warm host stash (the tier's warm-budget trim
        of segments that stay hot). True when there was a stash."""
        with self._res_lock:
            return self._drop_warm_locked()

    def evict_device(self) -> None:
        """Full unload: device and warm copies gone, every stacked copy
        holding this segment's columns (engine/batch) and every cube of it
        (ops/plan_cache) dropped, tier state cold; its loaded rollups
        too."""
        self.demote_device(drop_warm=True)
        global_tier.on_evicted(self)
        # a loaded star-tree rollup (startree/query._load_rollup) is a
        # segment of its own on this device and leaves with its parent
        for rollup in self.rollup_segments():
            rollup.evict_device()

    def retire(self) -> None:
        """The segment left its table (an unload, a move to another
        server, a minion's replacement): release its device residency now
        and never cache again. A query that acquired it before keeps
        running on it; its uploads are its own and leave with it, so no
        device byte or tracked byte outlives the unload."""
        with self._res_lock:
            self._retired = True
        self.evict_device()

    @property
    def retired(self) -> bool:
        """The segment left its table (``retire``): no cache keeps a
        device copy of it any more."""
        return self._retired

    def rollup_segments(self) -> List["ImmutableSegment"]:
        """The star-tree rollups loaded from this segment so far."""
        return list(getattr(self, "_rollup_cache", {}).values())

    def __repr__(self) -> str:
        return (f"ImmutableSegment({self.name!r}, docs={self.n_docs}, "
                f"device={self.device}, cols={list(self.columns)})")


def load_segment(seg_dir: str,
                 device: Union[str, torch.device, None] = None
                 ) -> ImmutableSegment:
    """Load a segment directory written by either package's builder."""
    return ImmutableSegment.load(seg_dir, device)
