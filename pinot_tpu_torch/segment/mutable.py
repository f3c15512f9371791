"""Mutable (consuming) segment: row-append buffers, queryable snapshots.

Port of ``pinot_tpu/segment/mutable.py``. The consuming segment stays on
the host, as in the reference: its snapshot is answered by the host path
(the planner's ``is_mutable`` route), and nothing reaches the device
until ``seal`` builds an immutable segment that the table loads there.
``index_batch`` appends a batch column by column (one vectorized store a
column where the values allow it) instead of row by row; the doc ids,
values, null masks and valid mask it leaves are those of ``index`` row
by row, which a test holds it to. Sealed directories are byte-equal to
the reference's (the builders are the same).

Reference parity: pinot-segment-local/.../indexsegment/mutable/
MutableSegmentImpl.java:119 (1364 lines — concurrently-readable in-memory
segment built row-by-row; index(GenericRow) at :488). TPU-native stance:
the consuming segment is a HOST structure (growing numpy buffers with
capacity doubling) queried through the vectorized host path — fresh rows
are few relative to sealed data, so chasing device residency for them
buys nothing; on seal the rows flow through SegmentBuilder into the same
immutable format every other segment uses (sorted dictionaries, minimal
widths) and become device-resident like any offline segment. That mirrors
Pinot's CONSUMING -> ONLINE conversion exactly.

Readers never lock writers: index() appends under a lock; snapshot()
captures (buffers, count) pairs — numpy buffers only grow, so rows
[0, count) are immutable once visible.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..spi.config import TableConfig
from ..spi.schema import DataType, FieldSpec, Schema
from .builder import Categorical, SegmentBuilder
from .dictionary import Dictionary

_INITIAL_CAPACITY = 4096


class _MutableColumn:
    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.is_mv = not spec.single_value
        self.is_string = (spec.data_type == DataType.STRING
                          or not spec.data_type.is_numeric)
        # single-value STRING columns hold ids into a dictionary of their
        # values in first-seen order (the reference system's mutable
        # dictionary): seal hands the builder codes to remap instead of
        # strings to sort
        self.encoded = spec.data_type == DataType.STRING and not self.is_mv
        self.dict_ids: Dict[str, int] = {}
        self.dict_values: List[str] = []
        if self.encoded:
            self.values: Any = np.zeros(_INITIAL_CAPACITY, dtype=np.int32)
        elif self.is_string or self.is_mv:
            # MV columns hold python lists per row (partial upsert's
            # APPEND/UNION need MV on the consuming segment)
            self.values = np.empty(_INITIAL_CAPACITY, dtype=object)
        else:
            self.values = np.zeros(_INITIAL_CAPACITY,
                                   dtype=spec.data_type.np_dtype)
        self.nulls = np.zeros(_INITIAL_CAPACITY, dtype=bool)
        self.any_nulls = False

    def ensure(self, capacity: int) -> None:
        if capacity <= len(self.values):
            return
        new_cap = len(self.values)
        while new_cap < capacity:
            new_cap *= 2
        nv = (np.empty(new_cap, dtype=object)
              if self.values.dtype == object
              else np.zeros(new_cap, dtype=self.values.dtype))
        nv[: len(self.values)] = self.values
        nn = np.zeros(new_cap, dtype=bool)
        nn[: len(self.nulls)] = self.nulls
        self.values, self.nulls = nv, nn

    def _id(self, s: str) -> int:
        i = self.dict_ids.get(s)
        if i is None:
            i = self.dict_ids[s] = len(self.dict_values)
            self.dict_values.append(s)
        return i

    def value(self, i: int) -> Any:
        """The stored value of row ``i`` (decoded)."""
        if self.encoded:
            return self.dict_values[self.values[i]]
        return self.values[i]

    def append_many(self, i0: int, vals: List[Any]) -> None:
        """``append`` of ``vals`` at rows ``i0, i0 + 1, ...``: one store
        for the column where the values convert to its dtype exactly as
        one element at a time would, else ``append`` per value."""
        if self.is_mv or self.spec.data_type == DataType.BOOLEAN:
            for k, v in enumerate(vals):
                self.append(i0 + k, v)
            return
        n = len(vals)
        nulls = [v is None for v in vals]
        if any(nulls):
            self.nulls[i0: i0 + n] = nulls
            self.any_nulls = True
            null_value = self.spec.null_value()
            vals = [null_value if v is None else v for v in vals]
        if self.is_string:
            strs = [str(v) for v in vals]
            if not self.encoded:
                self.values[i0: i0 + n] = strs
                return
            get = self.dict_ids.get
            ids = [get(s) for s in strs]
            if None in ids:
                ids = [self._id(s) if i is None else i
                       for s, i in zip(strs, ids)]
            self.values[i0: i0 + n] = ids
            return
        arr = np.asarray(vals)
        if _casts_exactly(arr, self.values.dtype):
            self.values[i0: i0 + n] = arr
            return
        for k, v in enumerate(vals):
            self.values[i0 + k] = v

    def append(self, i: int, v: Any) -> None:
        if v is None:
            self.nulls[i] = True
            self.any_nulls = True
            if self.is_mv:
                self.values[i] = []
                return
            v = self.spec.null_value()
        if self.is_mv:
            self.values[i] = list(v) if isinstance(v, (list, tuple)) \
                else [v]
        elif self.encoded:
            self.values[i] = self._id(str(v))
        elif self.is_string:
            self.values[i] = str(v)
        else:
            if self.spec.data_type == DataType.BOOLEAN and isinstance(
                    v, (bool, str)):
                v = 1 if v in (True, "true", "True", 1) else 0
            self.values[i] = v

    def snapshot(self) -> Tuple[Any, ...]:
        """What a view needs to read rows published so far: the value
        buffer, the dictionary and its size (encoded columns), the null
        buffer. Caller holds the segment lock."""
        return (self.values, self.dict_values, len(self.dict_values),
                self.nulls, self.any_nulls)


def _casts_exactly(arr: np.ndarray, dtype: np.dtype) -> bool:
    """Whether storing ``arr`` into a ``dtype`` buffer in one cast gives
    the values that storing its elements one by one would: booleans and
    in-range integers into integer columns, numbers that a double holds
    exactly into float columns. Anything else (strings, floats into an
    integer column, integers past the column's range) goes element by
    element, which converts or raises as ``append`` does."""
    kind = arr.dtype.kind
    if arr.ndim != 1:
        return False
    if kind == "b":
        return True
    if kind in "iu" and arr.size:
        lo, hi = int(arr.min()), int(arr.max())
        if dtype.kind in "iu":
            info = np.iinfo(dtype)
            return info.min <= lo and hi <= info.max
        return dtype.kind == "f" and max(-lo, hi) <= 1 << 53
    return kind == "f" and dtype.kind == "f"


class MutableSegment:
    def __init__(self, schema: Schema, name: str,
                 table_config: Optional[TableConfig] = None):
        self.schema = schema
        self.name = name
        self.table_config = table_config or TableConfig(schema.name)
        self._cols: Dict[str, _MutableColumn] = {
            f.name: _MutableColumn(f) for f in schema.fields}
        self._count = 0
        self._lock = threading.Lock()
        self.start_offset: Optional[int] = None
        self.created_at = None
        self.sealed_docs = 0  # set by seal(); authoritative for offsets
        # upsert validDocIds over consuming rows (all-true when not upsert)
        self._valid = np.ones(_INITIAL_CAPACITY, dtype=bool)

    @property
    def n_docs(self) -> int:
        return self._count

    # -- write path --------------------------------------------------------
    def index(self, row: Mapping[str, Any]) -> int:
        """Append one row; returns its doc id (MutableSegmentImpl.index)."""
        with self._lock:
            i = self._count
            for name, col in self._cols.items():
                col.ensure(i + 1)
                col.append(i, row.get(name))
            if i >= len(self._valid):
                nv = np.ones(len(self._valid) * 2, dtype=bool)
                nv[: len(self._valid)] = self._valid
                self._valid = nv
            self._valid[i] = True
            self._count = i + 1  # publish after the row is fully written
            return i

    def invalidate_doc(self, doc_id: int) -> None:
        """Upsert: an earlier row for this PK was superseded. Takes the
        segment lock: a concurrent index_row may be swapping _valid for
        the doubled array, and an unlocked store to the old buffer would
        silently resurrect the superseded row (found by analysis/jaxlint
        unlocked-mutation)."""
        with self._lock:
            self._valid[doc_id] = False

    def get_row(self, doc_id: int) -> Dict[str, Any]:
        """One indexed row in value space (None for nulls) — the
        partial-upsert merge reads the previous live row through this
        (GenericRow readback; MutableSegmentImpl.getRecord analog)."""
        row: Dict[str, Any] = {}
        for name, c in self._cols.items():
            if c.nulls[doc_id]:
                row[name] = None
            elif c.is_mv:
                row[name] = list(c.values[doc_id])
            else:
                v = c.value(doc_id)
                row[name] = v.item() if isinstance(v, np.generic) else v
        return row

    def valid_mask(self, n: int) -> np.ndarray:
        return self._valid[:n]

    def index_batch(self, rows, valid: Optional[np.ndarray] = None,
                    each: Optional[Callable[[int, int], Any]] = None
                    ) -> int:
        """Append rows column by column; the same doc ids, values, nulls
        and valid bits as ``index`` on each row in turn. ``valid`` gives
        the rows' valid bits (all set when None), written before any row
        is published. Without ``each`` the batch is published at once.
        With it the rows are published one at a time and ``each(doc, k)``
        runs right after row ``k`` is, before row ``k + 1`` is: a reader
        sees the batch grow as under ``index`` row by row, so an upsert
        that supersedes a key's old row in ``each`` shows both rows for
        one row at most, as the reference does."""
        rows = list(rows)
        if not rows:
            return self._count
        with self._lock:
            i0 = self._count
            end = i0 + len(rows)
            for name, col in self._cols.items():
                col.ensure(end)
                col.append_many(i0, [r.get(name) for r in rows])
            cap = len(self._valid)
            if end > cap:
                while cap < end:
                    cap *= 2
                nv = np.ones(cap, dtype=bool)
                nv[: len(self._valid)] = self._valid
                self._valid = nv
            self._valid[i0:end] = True if valid is None else valid
            if each is None:
                self._count = end  # publish after the rows are written
                return end
        for k in range(len(rows)):
            with self._lock:
                self._count = i0 + k + 1
            each(i0 + k, k)
        return end

    # -- read path ---------------------------------------------------------
    def snapshot(self) -> "MutableSegmentView":
        with self._lock:
            n = self._count
            cols = {name: c.snapshot() for name, c in self._cols.items()}
            valid = self._valid
        return MutableSegmentView(self, n, cols, valid)

    # -- seal --------------------------------------------------------------
    def seal(self, out_dir: str, segment_name: Optional[str] = None) -> str:
        """Build the immutable segment directory from the current rows
        (CONSUMING -> ONLINE conversion; RealtimeSegmentConverter analog).
        The row count actually sealed is published as self.sealed_docs —
        offset accounting MUST use it, not a later read of n_docs (rows
        indexed concurrently with the build are not in the artifact)."""
        with self._lock:
            n = self._count
        self.sealed_docs = n
        columns: Dict[str, Any] = {}
        for name, c in self._cols.items():
            nulls = c.any_nulls and bool(c.nulls[:n].any())
            if c.encoded and not nulls:
                columns[name] = _categorical(c.values[:n], c.dict_values)
                continue
            vals = (np.asarray(c.dict_values, dtype=object)[c.values[:n]]
                    if c.encoded else c.values[:n])
            if nulls:
                arr = np.empty(n, dtype=object)
                arr[:] = vals
                arr[c.nulls[:n]] = None
                columns[name] = arr
            else:
                columns[name] = vals.copy()
        builder = SegmentBuilder(self.schema, self.table_config)
        return builder.build(columns, out_dir, segment_name or self.name)


def _categorical(codes: np.ndarray, values: List[str]) -> Categorical:
    """The rows' ids over the dictionary values they use (a dictionary
    may hold values of rows past ``codes``), for the builder, which then
    writes what it writes from the same rows as strings."""
    used = np.bincount(codes, minlength=len(values)) > 0
    if used.all():
        return Categorical(codes.copy(), values[: len(used)])
    remap = (np.cumsum(used) - 1).astype(np.int32)
    return Categorical(remap[codes],
                       [v for v, u in zip(values, used) if u])


class _ViewColumnMeta:
    """Planner/host-path column metadata for a consuming snapshot: no
    dictionary, no min/max (no constant folding against moving data)."""

    def __init__(self, spec: FieldSpec, any_nulls: bool):
        self.name = spec.name
        self.data_type = spec.data_type
        self.field_type = spec.field_type.value
        self.encoding = "RAW"
        self.cardinality = 0
        self.is_sorted = False
        self.min = None
        self.max = None
        self.has_nulls = any_nulls
        self.partitions = None
        self.single_value = spec.single_value
        self.max_values = None

    @property
    def has_dict(self) -> bool:
        return False


class MutableSegmentView:
    """Immutable row-range view over a consuming segment; implements the
    host-path segment protocol (raw_values/null_mask/columns/schema).
    is_mutable routes the planner straight to the host path. A
    dictionary-encoded column decodes once a view, on its first read."""

    is_mutable = True

    def __init__(self, parent: MutableSegment, n: int,
                 cols: Dict[str, Tuple[Any, ...]],
                 valid: Optional[np.ndarray] = None):
        self.parent = parent
        self.name = parent.name
        self.schema = parent.schema
        self.n_docs = n
        self._cols = cols
        self._decoded: Dict[str, np.ndarray] = {}
        # expose upsert validDocIds only when some doc is invalidated (the
        # all-true case keeps the common path mask-free)
        self.valid_docs = None
        if valid is not None and not valid[:n].all():
            self.valid_docs = valid[:n]
        self.columns: Dict[str, _ViewColumnMeta] = {
            f.name: _ViewColumnMeta(f, cols[f.name][4])
            for f in parent.schema.fields}

    def raw_values(self, col: str) -> np.ndarray:
        vals, dict_values, card, _nulls, _any = self._cols[col]
        if not self.parent._cols[col].encoded:
            return vals[: self.n_docs]
        out = self._decoded.get(col)
        if out is None:
            out = np.asarray(dict_values[:card], dtype=object)[
                vals[: self.n_docs]]
            self._decoded[col] = out
        return out

    def null_mask(self, col: str) -> Optional[np.ndarray]:
        _vals, _dv, _card, nulls, any_nulls = self._cols[col]
        if not any_nulls:
            return None
        return nulls[: self.n_docs]

    def dictionary(self, col: str) -> Optional[Dictionary]:
        return None
