"""Segment builder: two-pass stats -> encode -> write.

Reference parity: pinot-segment-local/.../segment/creator/impl/
SegmentIndexCreationDriverImpl.java:117 (init: stats pass) and :246 (build:
dictionary + per-column index creation, seal, v3 single-dir layout). The
TPU-native format drops bit-packing in favor of byte-aligned minimal int
widths (uint8/uint16/int32 dict ids) that memmap zero-copy and upcast on
device; raw numeric columns store their native fixed width.

On-disk layout (segment dir):
    metadata.json             — docs, per-column stats/encoding
    <col>.fwd.bin             — forward index, little-endian fixed width
    <col>.dict.bin            — numeric dictionary (sorted values)
    <col>.dict.json           — string dictionary (sorted values)
    <col>.null.bin            — packed null bitmap (np.packbits), if any nulls
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Union

import numpy as np

from ..spi.config import TableConfig
from ..spi.schema import DataType, FieldType, Schema
from .dictionary import Dictionary, min_id_dtype

FORMAT_VERSION = "v1"
METADATA_FILE = "metadata.json"


def _fwd_path(d: str, col: str) -> str:
    return os.path.join(d, f"{col}.fwd.bin")


def _dict_bin_path(d: str, col: str) -> str:
    return os.path.join(d, f"{col}.dict.bin")


def _dict_json_path(d: str, col: str) -> str:
    return os.path.join(d, f"{col}.dict.json")


def _null_path(d: str, col: str) -> str:
    return os.path.join(d, f"{col}.null.bin")


class Categorical:
    """Pre-encoded dictionary column input: `codes` index into `values`.

    Bulk-ingest fast path for low-cardinality string dimensions (the
    reference's dictionary-encoded ingest always materializes per-row
    objects; at 100M+ rows the Python str-per-row loop dominates build
    time). Values need not be sorted — codes are remapped to sorted
    dictionary ids at build, preserving the sorted-id invariant that
    range predicates and dict MIN/MAX fast paths rely on."""

    def __init__(self, codes: np.ndarray, values: Sequence[str]):
        self.codes = np.asarray(codes)
        self.values = [str(v) for v in values]
        if len(set(self.values)) != len(self.values):
            raise ValueError("Categorical values must be unique")

    def __len__(self) -> int:
        return len(self.codes)


class SegmentBuilder:
    """Builds one immutable segment directory from rows or columns."""

    def __init__(self, schema: Schema, table_config: Optional[TableConfig] = None):
        self.schema = schema
        self.table_config = table_config or TableConfig(schema.name)

    # -- input normalization ----------------------------------------------
    def _to_columns(self, data: Union[Sequence[Mapping[str, Any]],
                                      Mapping[str, Any]]
                    ) -> Dict[str, np.ndarray]:
        """Accept list-of-row-dicts or dict-of-columns; apply null defaults;
        return typed numpy columns plus null masks (attached as attr)."""
        cols: Dict[str, np.ndarray] = {}
        nulls: Dict[str, np.ndarray] = {}
        if isinstance(data, Mapping):
            n = None
            for f in self.schema.fields:
                if f.name not in data:
                    raise ValueError(f"missing column {f.name!r}")
                raw = data[f.name]
                if isinstance(raw, Categorical):
                    if n is None:
                        n = len(raw)
                    elif len(raw) != n:
                        raise ValueError(
                            f"column {f.name!r} length {len(raw)} != {n}")
                    cols[f.name] = raw  # type: ignore[assignment]
                    nulls[f.name] = np.zeros(len(raw), dtype=bool)
                    continue
                if not f.single_value:
                    # ragged MV rows refuse np.asarray; keep object cells
                    arr = np.empty(len(raw), dtype=object)
                    for j, r in enumerate(raw):
                        arr[j] = r
                else:
                    arr = np.asarray(raw)
                if n is None:
                    n = len(arr)
                elif len(arr) != n:
                    raise ValueError(f"column {f.name!r} length {len(arr)} != {n}")
                cols[f.name], nulls[f.name] = self._coerce(f, arr)
        else:
            rows = list(data)
            n = len(rows)
            for f in self.schema.fields:
                raw_list = [r.get(f.name) for r in rows]
                cols[f.name], nulls[f.name] = self._coerce(
                    f, np.asarray(raw_list, dtype=object))
        self._nulls = nulls
        return cols

    def _coerce(self, f, arr: np.ndarray):
        null_mask = np.zeros(len(arr), dtype=bool)
        if not f.single_value:
            # multi-value column: rows are sequences (ragged); None -> []
            # (reference: FixedBitMVForwardIndexReader stores offset+values;
            # the TPU-native layout is a padded (n, maxValues) id matrix)
            out = np.empty(len(arr), dtype=object)
            cast = (str if f.data_type == DataType.STRING
                    else f.data_type.np_dtype.type)
            for i, row in enumerate(arr):
                if row is None:
                    null_mask[i] = True
                    out[i] = []
                else:
                    out[i] = [cast(v) for v in row]
            return out, null_mask
        if f.name in self.table_config.indexing.vector_index_columns:
            # vector column: rows are fixed-dim float sequences; stored only
            # through the vector index (index/vector.py), queried only via
            # VECTOR_SIMILARITY
            out = np.empty(len(arr), dtype=object)
            out[:] = [np.asarray(v, dtype=np.float32) for v in arr]
            return out, null_mask
        if arr.dtype == object:
            null_mask = np.array([v is None for v in arr], dtype=bool)
            if null_mask.any():
                arr = arr.copy()
                arr[null_mask] = f.null_value()
        if f.data_type == DataType.STRING or not f.data_type.is_numeric:
            out = np.asarray([str(v) for v in arr], dtype=object)
        else:
            if f.data_type == DataType.BOOLEAN and arr.dtype == object:
                arr = np.asarray(
                    [1 if v in (True, 1, "true", "True") else 0 for v in arr])
            out = arr.astype(f.data_type.np_dtype)
        return out, null_mask

    # -- encoding decision -------------------------------------------------
    def _use_dictionary(self, f, cardinality: int) -> bool:
        idx = self.table_config.indexing
        if f.name in idx.no_dictionary_columns:
            return False
        if f.name in idx.dictionary_columns:
            return True
        if not f.data_type.is_numeric:
            return True  # strings always dict-encoded
        if f.field_type == FieldType.METRIC:
            return False  # raw metrics aggregate without an id->value gather
        return cardinality <= idx.dict_cardinality_threshold

    # -- build -------------------------------------------------------------
    def build(self, data: Union[Sequence[Mapping[str, Any]], Mapping[str, Any]],
              out_dir: str, segment_name: Optional[str] = None,
              shared_dicts: Optional[Dict[str, Dictionary]] = None
              ) -> str:
        """Build a segment; returns the segment directory path.

        shared_dicts: table-level dictionaries (TPU-native extension: when a
        whole table is built at once, all its segments share one dictionary
        per column so group-by partials combine on-device via psum without
        per-segment id remapping — see parallel/distributed.py).
        """
        cols = self._to_columns(data)
        n_docs = len(next(iter(cols.values()))) if cols else 0
        segment_name = segment_name or f"{self.schema.name}_{int(time.time()*1e3)}"
        seg_dir = os.path.join(out_dir, segment_name)
        os.makedirs(seg_dir, exist_ok=True)

        meta: Dict[str, Any] = {
            "formatVersion": FORMAT_VERSION,
            "segmentName": segment_name,
            "tableName": self.schema.name,
            "totalDocs": n_docs,
            "creationTimeMs": int(time.time() * 1e3),
            "columns": {},
            "schema": self.schema.to_dict(),
        }
        if self.table_config.partition_column:
            meta["partitionColumn"] = self.table_config.partition_column

        idx_cfg = self.table_config.indexing
        for f in self.schema.fields:
            arr = cols[f.name]
            if f.name in idx_cfg.vector_index_columns:
                from .. import index as index_pkg
                vcfg = idx_cfg.vector_index_columns[f.name]
                cmeta = {
                    "dataType": f.data_type.value,
                    "fieldType": f.field_type.value,
                    "encoding": "VECTOR",
                    "fwdDtype": "float32",
                    "cardinality": 0,
                }
                extra = index_pkg.build_indexes_for_column(
                    f.name, ["vector"], seg_dir, values=arr, ids=None,
                    cardinality=0, configs={"vector": vcfg})
                cmeta["indexes"] = extra
                meta["columns"][f.name] = cmeta
                continue
            cmeta = self._build_column(
                f, arr, seg_dir,
                shared_dict=(shared_dicts or {}).get(f.name))
            null_mask = self._nulls.get(f.name)
            if null_mask is not None and null_mask.any():
                np.packbits(null_mask).tofile(_null_path(seg_dir, f.name))
                cmeta["hasNulls"] = True
                cmeta["nullCount"] = int(null_mask.sum())
            meta["columns"][f.name] = cmeta

        if self.table_config.partition_column:
            pc = self.table_config.partition_column
            pmeta = meta["columns"][pc]
            # stable partition function (PartitionFunction SPI): modulo for
            # ints, murmur2 for strings — the broker pruner recomputes
            # partitions of query literals, so builtin hash() (per-process
            # salted) can never be used here
            from ..spi.partition import partition_ids
            pids = partition_ids(cols[pc],
                                 self.table_config.num_partitions)
            pmeta["partitions"] = sorted(set(pids))
            meta["numPartitions"] = self.table_config.num_partitions

        with open(os.path.join(seg_dir, METADATA_FILE), "w") as fh:
            json.dump(meta, fh, indent=1, default=_json_default)
        if self.table_config.segments.format_version == "v3":
            from . import segdir
            segdir.convert_to_v3(seg_dir)
        return seg_dir

    def _build_mv_column(self, f, arr: np.ndarray, seg_dir: str,
                         shared_dict: Optional[Dictionary] = None
                         ) -> Dict[str, Any]:
        """Multi-value column: padded (n, maxValues) dict-id matrix, pad
        id -1 (signed min-width storage). -1 is inert under any-over-axis
        predicates and MvReduce aggregations without needing the
        cardinality at eval time."""
        n = len(arr)
        flat = [v for row in arr for v in row]
        if f.data_type == DataType.STRING:
            flat_arr = np.asarray(flat, dtype=object)
        else:
            flat_arr = np.asarray(flat, dtype=f.data_type.np_dtype) \
                if flat else np.asarray([], dtype=f.data_type.np_dtype)
        if shared_dict is not None:
            dictionary = shared_dict
            flat_ids = self._encode_with(shared_dict, flat_arr, f.data_type)
        else:
            dictionary, flat_ids = Dictionary.build(flat_arr, f.data_type)
        max_values = max((len(row) for row in arr), default=1) or 1
        card = dictionary.cardinality
        dt = next(d for d in (np.int8, np.int16, np.int32)
                  if card <= np.iinfo(d).max)
        mat = np.full((n, max_values), -1, dtype=dt)
        pos = 0
        for i, row in enumerate(arr):
            k = len(row)
            if k:
                mat[i, :k] = flat_ids[pos:pos + k]
                pos += k
        mat.tofile(_fwd_path(seg_dir, f.name))
        cmeta: Dict[str, Any] = {
            "dataType": f.data_type.value,
            "fieldType": f.field_type.value,
            "encoding": "DICT",
            "singleValue": False,
            "maxValues": int(max_values),
            "fwdDtype": dt().dtype.name,
            "cardinality": card,
            "isSorted": False,
        }
        if f.data_type == DataType.STRING:
            with open(_dict_json_path(seg_dir, f.name), "w") as fh:
                json.dump(list(dictionary.values), fh)
            cmeta["dictFormat"] = "json"
        else:
            vals = np.asarray(dictionary.values, dtype=f.data_type.np_dtype)
            vals.tofile(_dict_bin_path(seg_dir, f.name))
            cmeta["dictFormat"] = "bin"
            cmeta["dictDtype"] = f.data_type.np_dtype.name
        if card:
            cmeta["min"] = _json_scalar(dictionary.min_value)
            cmeta["max"] = _json_scalar(dictionary.max_value)
        return cmeta

    def _build_column(self, f, arr: np.ndarray, seg_dir: str,
                      shared_dict: Optional[Dictionary] = None) -> Dict[str, Any]:
        if not f.single_value:
            return self._build_mv_column(f, arr, seg_dir, shared_dict)
        n = len(arr)
        cmeta: Dict[str, Any] = {
            "dataType": f.data_type.value,
            "fieldType": f.field_type.value,
        }
        if isinstance(arr, Categorical):
            order = np.argsort(np.asarray(arr.values, dtype=object))
            remap = np.empty(len(arr.values), dtype=np.int32)
            remap[order] = np.arange(len(arr.values), dtype=np.int32)
            dictionary = Dictionary(
                [arr.values[i] for i in order], DataType.STRING)
            ids = remap[arr.codes]
            cardinality = dictionary.cardinality
            use_dict = True
        elif shared_dict is not None:
            dictionary = shared_dict
            ids = self._encode_with(shared_dict, arr, f.data_type)
            cardinality = shared_dict.cardinality
            use_dict = True
        else:
            if f.data_type == DataType.STRING or not f.data_type.is_numeric:
                cardinality = len(set(str(v) for v in arr)) if n else 0
            else:
                cardinality = int(len(np.unique(arr))) if n else 0
            use_dict = self._use_dictionary(f, cardinality)
            dictionary, ids = (Dictionary.build(arr, f.data_type)
                               if use_dict else (None, None))
            if dictionary is not None:
                cardinality = dictionary.cardinality

        cmeta["cardinality"] = cardinality
        is_sorted = bool(n == 0 or (
            use_dict and bool(np.all(ids[1:] >= ids[:-1]))) or (
            not use_dict and f.data_type.is_numeric
            and bool(np.all(arr[1:] >= arr[:-1]))))
        cmeta["isSorted"] = is_sorted

        idx_cfg = self.table_config.indexing
        if use_dict:
            assert dictionary is not None and ids is not None
            cmeta["encoding"] = "DICT"
            if idx_cfg.bit_packed_ids and cardinality > 1:
                raise NotImplementedError(
                    "the BITPACK forward index is not yet ported")
            id_dtype = min_id_dtype(cardinality)
            ids.astype(id_dtype).tofile(_fwd_path(seg_dir, f.name))
            cmeta["fwdDtype"] = id_dtype.name
            if f.data_type == DataType.STRING or not f.data_type.is_numeric:
                with open(_dict_json_path(seg_dir, f.name), "w") as fh:
                    json.dump(list(dictionary.values), fh)
                cmeta["dictFormat"] = "json"
            else:
                vals = np.asarray(dictionary.values, dtype=f.data_type.np_dtype)
                vals.tofile(_dict_bin_path(seg_dir, f.name))
                cmeta["dictFormat"] = "bin"
                cmeta["dictDtype"] = f.data_type.np_dtype.name
            cmeta["min"] = _json_scalar(dictionary.min_value)
            cmeta["max"] = _json_scalar(dictionary.max_value)
        else:
            cmeta["encoding"] = "RAW"
            cmeta["fwdDtype"] = arr.dtype.name
            if idx_cfg.compression:
                raise NotImplementedError(
                    "the COMPRESSED forward index is not yet ported")
            arr.tofile(_fwd_path(seg_dir, f.name))
            if n:
                cmeta["min"] = _json_scalar(arr.min())
                cmeta["max"] = _json_scalar(arr.max())

        kinds = self.table_config.indexing.indexes_for(f.name)
        if kinds:
            from .. import index as index_pkg
            if "inverted" in kinds and not use_dict:
                raise ValueError(f"inverted index needs a dictionary "
                                 f"column: {f.name!r}")
            if isinstance(arr, Categorical):  # indexes need materialized rows
                arr = np.asarray(arr.values, dtype=object)[arr.codes]
            # per-kind build options from the table config (geo resolution)
            icfgs = {"geo": self.table_config.indexing
                     .geo_index_columns.get(f.name) or {}}
            cmeta["indexes"] = index_pkg.build_indexes_for_column(
                f.name, kinds, seg_dir, values=arr,
                ids=ids if use_dict else None,
                cardinality=cardinality, configs=icfgs)
        return cmeta

    @staticmethod
    def _encode_with(dictionary: Dictionary, arr: np.ndarray,
                     data_type: DataType) -> np.ndarray:
        if data_type == DataType.STRING or not data_type.is_numeric:
            lookup = {v: i for i, v in enumerate(dictionary.values)}
            return np.asarray([lookup[str(v)] for v in arr], dtype=np.int32)
        vals = np.asarray(dictionary.values)
        ids = np.searchsorted(vals, arr)
        if not np.all(vals[ids] == arr):
            raise ValueError("value missing from shared dictionary")
        return ids.astype(np.int32)


def build_table_dictionaries(schema: Schema, table_config: TableConfig,
                             column_chunks: Iterable[Mapping[str, np.ndarray]]
                             ) -> Dict[str, Dictionary]:
    """Union per-column values across all chunks into table-level sorted
    dictionaries (for the shared-dict multi-segment build path)."""
    builder = SegmentBuilder(schema, table_config)
    accum: Dict[str, List[np.ndarray]] = {f.name: [] for f in schema.fields}
    chunks = list(column_chunks)
    for chunk in chunks:
        cols = builder._to_columns(chunk)
        for name, arr in cols.items():
            accum[name].append(arr)
    dicts: Dict[str, Dictionary] = {}
    for f in schema.fields:
        if not f.single_value:
            # MV columns: union over the flattened values
            flat = [v for a in accum[f.name] for row in a for v in row]
            allv = (np.asarray(flat, dtype=object)
                    if f.data_type == DataType.STRING
                    else np.asarray(flat, dtype=f.data_type.np_dtype))
            dicts[f.name], _ = Dictionary.build(allv, f.data_type)
            continue
        allv = np.concatenate([np.asarray(a, dtype=object)
                               if f.data_type == DataType.STRING else a
                               for a in accum[f.name]])
        card_est = len(np.unique(allv.astype(str))) if allv.dtype == object \
            else len(np.unique(allv))
        if builder._use_dictionary(f, card_est):
            dicts[f.name], _ = Dictionary.build(allv, f.data_type)
    return dicts


def _json_scalar(v: Any) -> Any:
    if isinstance(v, np.generic):
        return v.item()
    return v


def _json_default(v: Any) -> Any:
    if isinstance(v, np.generic):
        return v.item()
    raise TypeError(f"not JSON serializable: {type(v)}")
