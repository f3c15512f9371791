"""Sorted dictionaries: value <-> dict-id maps.

Reference parity: pinot-segment-local/.../segment/index/readers/
{OnHeapStringDictionary, IntDictionary, ...}. Pinot dictionaries are sorted,
which is what makes range predicates resolvable to contiguous id ranges
(RangeIndex-free range filtering) and dictionary-based MIN/MAX fast paths
possible (AggregationPlanNode.java:98-112). We keep exactly that invariant:
ids are ranks in sorted order.

The dictionary lives host-side (numpy); only int ids ship to the TPU.
String group-by results resolve ids back to strings at broker reduce —
mirroring Pinot's dict-id execution end-to-end.
"""
from __future__ import annotations

import bisect
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..spi.schema import DataType


class Dictionary:
    """Immutable sorted dictionary for one column."""

    def __init__(self, values: Union[np.ndarray, List[str]], data_type: DataType):
        self.data_type = data_type
        if data_type == DataType.STRING or not isinstance(values, np.ndarray):
            self._values: Any = list(values)
            self._is_string = True
        else:
            self._values = values
            self._is_string = False

    def __len__(self) -> int:
        return len(self._values)

    @property
    def cardinality(self) -> int:
        return len(self._values)

    @property
    def values(self) -> Any:
        return self._values

    def value(self, dict_id: int) -> Any:
        return self._values[dict_id]

    def values_for(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized id -> value (used at broker reduce for group keys)."""
        if self._is_string:
            arr = np.asarray(self._values, dtype=object)
            return arr[ids]
        return np.asarray(self._values)[ids]

    # -- lookups -----------------------------------------------------------
    def index_of(self, value: Any) -> int:
        """Exact lookup; -1 when absent (BaseImmutableDictionary semantics:
        insertionIndex < 0 encodes absence)."""
        i = self.insertion_index(value)
        if i < len(self._values) and self._eq(self._values[i], value):
            return i
        return -1

    def indexes_of(self, values: List[Any]) -> np.ndarray:
        """``index_of`` over many values: one searchsorted for a numeric
        dictionary of numeric keys (an IN list of thousands of literals),
        the per-value lookup otherwise."""
        keys = np.asarray(values)
        if self._is_string or keys.dtype.kind not in "iuf":
            return np.asarray([self.index_of(v) for v in values],
                              dtype=np.int64)
        i = np.searchsorted(self._values, keys, side="left")
        hit = i < len(self._values)
        hit[hit] = self._values[i[hit]] == keys[hit]
        return np.where(hit, i, -1)

    def insertion_index(self, value: Any) -> int:
        """Leftmost index where value would insert (np.searchsorted 'left')."""
        if self._is_string:
            return bisect.bisect_left(self._values, str(value))
        return int(np.searchsorted(self._values, value, side="left"))

    def _eq(self, a: Any, b: Any) -> bool:
        if self._is_string:
            return a == str(b)
        return bool(a == b)

    def id_range(self, lo: Any, hi: Any, incl_lo: bool, incl_hi: bool
                 ) -> Tuple[int, int]:
        """Map a value range to an inclusive id range [lo_id, hi_id].

        Returns (1, 0) (empty) when no ids fall in range. Open bounds use
        None for +-infinity.
        """
        n = len(self._values)
        if lo is None:
            lo_id = 0
        else:
            i = self.insertion_index(lo)
            if incl_lo:
                lo_id = i
            else:
                # first id strictly greater than lo
                lo_id = i + 1 if i < n and self._eq(self._values[i], lo) else i
        if hi is None:
            hi_id = n - 1
        else:
            i = self.insertion_index(hi)
            if incl_hi:
                hi_id = i if i < n and self._eq(self._values[i], hi) else i - 1
            else:
                hi_id = i - 1
        if lo_id > hi_id:
            return (1, 0)
        return (lo_id, hi_id)

    @property
    def min_value(self) -> Any:
        return self._values[0] if len(self._values) else None

    @property
    def max_value(self) -> Any:
        return self._values[-1] if len(self._values) else None

    # -- encode ------------------------------------------------------------
    @classmethod
    def build(cls, raw: np.ndarray, data_type: DataType
              ) -> Tuple["Dictionary", np.ndarray]:
        """Build sorted dictionary and return (dictionary, dict_ids)."""
        if data_type == DataType.STRING:
            svals = np.asarray([str(v) for v in raw], dtype=object)
            uniq, inv = np.unique(svals, return_inverse=True)
            return cls(list(uniq), data_type), inv.astype(np.int32)
        uniq, inv = np.unique(raw, return_inverse=True)
        return cls(uniq, data_type), inv.astype(np.int32)


def min_id_dtype(cardinality: int) -> np.dtype:
    """Smallest unsigned int dtype that stores ids < cardinality (the
    TPU-native analog of Pinot's ceil(log2(card))-bit packing in
    FixedBitSVForwardIndexReaderV2 — byte-aligned widths load zero-copy
    via memmap and upcast to int32 on device)."""
    if cardinality <= 1 << 8:
        return np.dtype(np.uint8)
    if cardinality <= 1 << 16:
        return np.dtype(np.uint16)
    return np.dtype(np.int32)
