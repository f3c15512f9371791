"""Record transformer pipeline (pre-indexing row transforms).

Port of ``pinot_tpu/ingestion/transformers.py``, line for line: the
expressions and filters go through the port's ``query/sql`` and
``engine/host_eval`` over a ``multistage/relation.Relation``.

Reference parity: pinot-segment-local/.../recordtransformer/ —
CompositeTransformer chaining ComplexTypeTransformer (nested-object
flattening), ExpressionTransformer (derived columns),
FilterTransformer (row drops), DataTypeTransformer (schema-conforming
type coercion), and SanitizationTransformer (string cleanup) in the
same order the reference applies them. Expression/filter evaluation is
vectorized: the row batch becomes a columnar Relation and runs through
the same host evaluators the query engine uses — no per-row expression
interpretation.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence

import numpy as np

from ..query.sql import SqlError, parse_sql
from ..spi.schema import DataType, Schema

Rows = List[Dict[str, Any]]


def _parse_expr(text: str):
    """Parse a bare expression/predicate using the SELECT grammar."""
    stmt = parse_sql(f"SELECT 1 FROM t WHERE {text}")
    return stmt.where


def _rows_to_relation(rows: Rows):
    from ..multistage.relation import Relation
    cols: Dict[str, np.ndarray] = {}
    nulls: Dict[str, np.ndarray] = {}
    names = []
    seen = set()
    for r in rows:
        for k in r:
            if k not in seen:
                seen.add(k)
                names.append(k)
    for name in names:
        vals = [r.get(name) for r in rows]
        nm = np.array([v is None for v in vals], dtype=bool)
        if nm.any():
            nulls[name] = nm
        arr = np.array(vals, dtype=object)
        # numeric columns get real dtypes so arithmetic works
        if not nm.all():
            sample = next(v for v in vals if v is not None)
            if isinstance(sample, bool):
                pass
            elif isinstance(sample, int) and all(
                    v is None or isinstance(v, int) for v in vals):
                arr = np.array([0 if v is None else v for v in vals],
                               dtype=np.int64)
            elif isinstance(sample, (int, float)) and all(
                    v is None or isinstance(v, (int, float))
                    for v in vals):
                arr = np.array([np.nan if v is None else v for v in vals],
                               dtype=np.float64)
        cols[name] = arr
    return Relation(cols, nulls, "batch")


class RecordTransformer:
    def transform(self, rows: Rows) -> Rows:
        raise NotImplementedError


class ComplexTypeTransformer(RecordTransformer):
    """Flatten nested dicts into dotted columns; JSON-stringify residual
    collections (maps/lists) so they land in JSON/STRING columns."""

    def __init__(self, delimiter: str = "."):
        self.delimiter = delimiter

    def _flatten(self, prefix: str, value: Any, out: Dict[str, Any]) -> None:
        if isinstance(value, dict):
            for k, v in value.items():
                self._flatten(f"{prefix}{self.delimiter}{k}" if prefix
                              else str(k), v, out)
        else:
            out[prefix] = value

    def transform(self, rows: Rows) -> Rows:
        out: Rows = []
        for r in rows:
            flat: Dict[str, Any] = {}
            self._flatten("", r, flat)
            out.append(flat)
        return out


class ExpressionTransformer(RecordTransformer):
    """Derived columns: columnName <- transformFunction(expression over
    source columns), evaluated vectorized over the batch."""

    def __init__(self, transforms: Sequence[Dict[str, str]]):
        # [{"columnName": ..., "transformFunction": "..."}]
        self._specs = [(t["columnName"],
                        _parse_expr(t["transformFunction"]))
                       for t in transforms]

    def transform(self, rows: Rows) -> Rows:
        if not rows or not self._specs:
            return rows
        from ..engine import host_eval
        from ..query.sql import collect_identifiers
        rel = _rows_to_relation(rows)
        for name, expr in self._specs:
            try:
                vals = np.broadcast_to(
                    np.asarray(host_eval.eval_value(expr, rel)),
                    (len(rows),)).tolist()
            except (KeyError, SqlError, TypeError, ValueError):
                # e.g. a batch where no row carries the source column:
                # the derived column is null, not a dead consumer thread
                vals = [None] * len(rows)
            # null inputs yield null outputs (the placeholder 0/NaN the
            # relation builder substitutes must never escape as data)
            null_in = None
            for ref in collect_identifiers(expr):
                nm = rel.null_mask(ref)
                if nm is not None:
                    null_in = nm if null_in is None else (null_in | nm)
            for i, r in enumerate(rows):
                r[name] = None if (null_in is not None and null_in[i]) \
                    else vals[i]
        return rows


class FilterTransformer(RecordTransformer):
    """Drop rows matching filterFunction (FilterTransformer.java: the
    filter marks rows to SKIP)."""

    def __init__(self, filter_function: str):
        self._pred = _parse_expr(filter_function)

    def drop_mask(self, rows: Rows) -> np.ndarray:
        """True where the row matches the filter (to be dropped) —
        realtime uses this to invalidate instead of removing, keeping
        stream-offset == doc-id accounting exact."""
        if not rows:
            return np.zeros(0, dtype=bool)
        from ..engine import host_eval
        rel = _rows_to_relation(rows)
        return host_eval.eval_filter(self._pred, rel)

    def transform(self, rows: Rows) -> Rows:
        drop = self.drop_mask(rows)
        return [r for r, d in zip(rows, drop) if not d]


class DataTypeTransformer(RecordTransformer):
    """Coerce values to the schema's declared types; unknown columns are
    dropped (SchemaConformingTransformer + DataTypeTransformer)."""

    def __init__(self, schema: Schema):
        self.schema = schema

    @staticmethod
    def _coerce(dt: DataType, v: Any) -> Any:
        if v is None:
            return None
        if dt in (DataType.INT, DataType.LONG):
            return int(v)
        if dt in (DataType.FLOAT, DataType.DOUBLE):
            return float(v)
        if dt == DataType.BOOLEAN:
            if isinstance(v, str):
                return v.strip().lower() in ("1", "true", "yes")
            return bool(v)
        if dt == DataType.STRING:
            return v if isinstance(v, str) else str(v)
        if dt == DataType.JSON:
            return v if isinstance(v, str) else json.dumps(v)
        return v

    def transform(self, rows: Rows) -> Rows:
        fields = {f.name: f.data_type for f in self.schema.fields}
        out: Rows = []
        for r in rows:
            out.append({name: self._coerce(dt, r.get(name))
                        for name, dt in fields.items()})
        return out


class SanitizationTransformer(RecordTransformer):
    """String cleanup: strip NUL characters, enforce max length
    (SanitizationTransformer.java)."""

    def __init__(self, max_length: int = 512):
        self.max_length = max_length

    def transform(self, rows: Rows) -> Rows:
        for r in rows:
            for k, v in r.items():
                if isinstance(v, str):
                    v = v.replace("\x00", "")
                    if len(v) > self.max_length:
                        v = v[: self.max_length]
                    r[k] = v
        return rows


class CompositeTransformer(RecordTransformer):
    """The standard pipeline, in the reference's order: complex-type
    flatten -> expression transforms -> filter -> schema-conforming type
    coercion -> sanitization."""

    def __init__(self, transformers: Sequence[RecordTransformer]):
        self.transformers = list(transformers)

    @classmethod
    def from_table_config(cls, table_config, schema: Schema
                          ) -> "CompositeTransformer":
        ing = getattr(table_config, "ingestion", None)
        chain: List[RecordTransformer] = [ComplexTypeTransformer()]
        if ing is not None:
            if getattr(ing, "transforms", None):
                chain.append(ExpressionTransformer(ing.transforms))
            if getattr(ing, "filter_function", None):
                chain.append(FilterTransformer(ing.filter_function))
        chain.append(DataTypeTransformer(schema))
        chain.append(SanitizationTransformer())
        return cls(chain)

    def transform(self, rows: Rows) -> Rows:
        for t in self.transformers:
            rows = t.transform(rows)
            if not rows:
                break
        return rows
