"""Immutable segment: memmap load + padded device residency in torch.

Port of ``pinot_tpu/segment/immutable.py``. The host side is the same:
forward indexes and dictionaries memmap zero-copy from the segment
directory that either package's builder wrote. The device side keeps
torch tensors on the segment's own ``device``, padded to the same pow2
``bucket`` (``bucket_for``), uploaded once from pinned host memory and
cached per column. The tier, heat and device-memory accounting hooks of
the JAX package are not ported (ROADMAP Slice C), nor are secondary
indexes (``index_reader`` finds none).
"""
from __future__ import annotations

import itertools
import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..spi.schema import DataType, Schema
from . import segdir
from .builder import METADATA_FILE
from .dictionary import Dictionary

MIN_BUCKET = 1 << 10

_SEG_UID = itertools.count(1)


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
        self._nulls: Dict[str, Optional[np.ndarray]] = {}
        self._device: Dict[Tuple[str, int], torch.Tensor] = {}
        self._lock = threading.Lock()
        self.valid_docs: Optional[np.ndarray] = None
        if segdir.exists(seg_dir, "valid.bin"):
            # upsert validDocIds: the planner folds them into a
            # "validdocs" kernel param (device_valid_mask)
            bits = np.asarray(segdir.read_array(seg_dir, "valid.bin",
                                                np.uint8, mmap=False))
            self.valid_docs = np.unpackbits(bits)[: self.n_docs].astype(bool)

    @classmethod
    def load(cls, seg_dir: str,
             device: Union[str, torch.device, None] = None
             ) -> "ImmutableSegment":
        return cls(seg_dir, device)

    # -- host access -------------------------------------------------------
    def fwd(self, col: str) -> np.ndarray:
        """Stored forward index (dict ids or raw values), host-side."""
        if col not in self._fwd:
            m = self.columns[col]
            if m.fwd_format != "PLAIN":
                raise NotImplementedError(
                    f"{m.fwd_format} forward index of {col!r} is not yet "
                    "ported (needs the native codec runtime)")
            shape = ((self.n_docs,) if m.single_value
                     else (self.n_docs, m.max_values))
            self._fwd[col] = segdir.read_array(self.dir, f"{col}.fwd.bin",
                                               m.fwd_dtype, shape=shape)
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
        """Secondary-index reader; the index package is not ported, so
        there is none."""
        return None

    def raw_values(self, col: str) -> np.ndarray:
        """Decoded values (host-side; the host path and selection
        results)."""
        m = self.columns[col]
        if m.encoding == "VECTOR":
            raise NotImplementedError(
                f"VECTOR column {col!r} needs the vector index, which is "
                "not yet ported to pinot_tpu_torch")
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

    def _cached(self, key: Tuple[str, int], make) -> torch.Tensor:
        hit = self._device.get(key)
        if hit is None:
            hit = _upload(make(), self.device)
            with self._lock:
                hit = self._device.setdefault(key, hit)
        return hit

    def host_col_padded(self, col: str, bucket: Optional[int] = None
                        ) -> np.ndarray:
        """The bucket-padded host representation device_col uploads. Dict
        ids widen to int32; raw columns keep their dtype. SV padding is 0
        (inert under the kernel's validity mask), MV rows pad with -1."""
        bucket = bucket or self.bucket
        m = self.columns[col]
        host = np.asarray(self.fwd(col))
        if m.has_dict:
            host = host.astype(np.int32, copy=False)
        if bucket > self.n_docs:
            pad = np.full((bucket - self.n_docs,) + host.shape[1:],
                          -1 if not m.single_value else 0,
                          dtype=host.dtype)
            host = np.concatenate([host, pad])
        return host

    def device_col(self, col: str, bucket: Optional[int] = None
                   ) -> torch.Tensor:
        """Padded device tensor of a column's stored representation."""
        bucket = bucket or self.bucket
        return self._cached((col, bucket),
                            lambda: self.host_col_padded(col, bucket))

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

    def device_valid_mask(self, bucket: Optional[int] = None
                          ) -> torch.Tensor:
        """Upsert validDocIds padded to the bucket (all live docs valid
        when the segment has none)."""
        bucket = bucket or self.bucket

        def make() -> np.ndarray:
            padded = np.zeros(bucket, dtype=bool)
            padded[: self.n_docs] = (True if self.valid_docs is None
                                     else self.valid_docs)
            return padded

        return self._cached(("__valid__", bucket), make)

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

    def evict_device(self) -> None:
        """Drop every cached device tensor, and every stacked copy that
        holds this segment's columns (engine/batch), so eviction frees the
        device memory."""
        with self._lock:
            self._device.clear()
        from ..engine.batch import evict_stacks_containing
        evict_stacks_containing(self.name)

    def __repr__(self) -> str:
        return (f"ImmutableSegment({self.name!r}, docs={self.n_docs}, "
                f"device={self.device}, cols={list(self.columns)})")


def load_segment(seg_dir: str,
                 device: Union[str, torch.device, None] = None
                 ) -> ImmutableSegment:
    """Load a segment directory written by either package's builder."""
    return ImmutableSegment.load(seg_dir, device)
