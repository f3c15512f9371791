"""Config recommender: rule-based indexing/partitioning advice.

Reference parity: pinot-controller/.../recommender/ (8.7k LoC of
rule-driven config generation from a schema + query workload sketch).
The device engine changes which rules matter — full-scan masks are
the fast path, so inverted indexes only pay on the host path and bloom
filters mostly serve segment pruning — and the rules below encode THIS
engine's cost model, not the reference's:

- dictionary: numeric dims stay dict-encoded unless near-unique
  (sorted-dict id ranges replace the range index on the device path);
- bloom: high-selectivity EQ columns used in filters -> segment pruning;
- partitioning: the most frequent EQ filter column with enough
  cardinality -> broker partition pruning;
- sorted column: the dominant range-filtered column;
- tiers: time-column presence suggests age-based tiering.

Input workload: [(sql, weight)] pairs; output: a TableConfig plus
human-readable reasons (the RecommenderDriver's response analog).

Port of ``pinot_tpu/tools/recommender.py``, with the same rules and
output. The cost model is the port's too: its device path on the card
scans full masks and groups by dictionary ids as the reference's does.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..query.sql import (Between, BoolAnd, BoolNot, BoolOr, Comparison,
                         Identifier, InList, Like, Literal, ast_children,
                         parse_sql)
from ..spi.config import TableConfig
from ..spi.schema import Schema


@dataclass
class Recommendation:
    table_config: TableConfig
    reasons: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"tableConfig": self.table_config.to_dict(),
                "reasons": self.reasons}


def _filter_stats(filters: List[Tuple[Any, float]]):
    eq = Counter()     # col -> weighted EQ/IN uses
    rng = Counter()    # col -> weighted range uses
    txt = Counter()    # col -> LIKE / text uses

    def walk(e, w):
        if isinstance(e, (BoolAnd, BoolOr)):
            for c in e.children:
                walk(c, w)
        elif isinstance(e, BoolNot):
            walk(e.child, w)
        elif isinstance(e, Comparison) and isinstance(e.lhs, Identifier) \
                and isinstance(e.rhs, Literal):
            # != matches nearly everything — it is not pruning evidence
            if e.op == "==":
                eq[e.lhs.name] += w
            elif e.op != "!=":
                rng[e.lhs.name] += w
        elif isinstance(e, InList) and isinstance(e.expr, Identifier) \
                and not e.negated:
            eq[e.expr.name] += w
        elif isinstance(e, Between) and isinstance(e.expr, Identifier):
            rng[e.expr.name] += w
        elif isinstance(e, Like) and isinstance(e.expr, Identifier):
            txt[e.expr.name] += w
        else:
            for c in ast_children(e):
                walk(c, w)

    for f, w in filters:
        if f is not None:
            walk(f, w)
    return eq, rng, txt


def recommend(schema: Schema, workload: List[Tuple[str, float]],
              cardinalities: Optional[Dict[str, int]] = None,
              n_rows: Optional[int] = None) -> Recommendation:
    """-> Recommendation for `schema` given a weighted query workload.

    cardinalities: column -> estimated distinct count (from a sample or
    existing segments); n_rows: estimated rows per segment."""
    cards = cardinalities or {}
    n_rows = n_rows or 1_000_000
    cfg = TableConfig(schema.name)
    reasons: List[str] = []

    filters = []
    group_cols = Counter()
    def collect(stmt, w):
        from ..query.sql import DdlStmt, SetOpStmt
        if isinstance(stmt, DdlStmt):
            return                 # DDL carries no scan shape
        if isinstance(stmt, SetOpStmt):
            collect(stmt.left, w)  # each branch scans: both contribute
            collect(stmt.right, w)
            return
        filters.append((stmt.where, w))
        for g in stmt.group_by or []:
            if isinstance(g, Identifier):
                group_cols[g.name] += w

    for sql, w in workload:
        collect(parse_sql(sql), w)
    eq, rng, txt = _filter_stats(filters)

    dim_names = {f.name for f in schema.fields
                 if f.field_type.value == "DIMENSION"}

    # bloom filters: EQ-filtered dims with high cardinality — the broker/
    # server pruners skip whole segments on absent values
    for col, _w in eq.most_common():
        if col in dim_names and cards.get(col, 0) >= 1000:
            cfg.indexing.bloom_filter_columns.append(col)
            reasons.append(
                f"bloom({col}): frequent EQ filter, card~{cards[col]} — "
                "segment pruning on absent values")

    # partition column: the heaviest EQ filter with spread-out values
    for col, _w in eq.most_common():
        if col in dim_names and cards.get(col, 0) >= 16:
            cfg.partition_column = col
            cfg.num_partitions = min(
                16, max(2, cards.get(col, 16) // 8))
            reasons.append(
                f"partition({col}, {cfg.num_partitions}): dominant EQ "
                "filter — broker prunes non-matching partitions")
            break

    # sorted column: the heaviest range filter (sorted runs make the
    # range mask trivially cheap and help time pruning)
    if rng:
        col = rng.most_common(1)[0][0]
        cfg.indexing.sorted_column = col
        reasons.append(f"sorted({col}): dominant range filter")

    # text index for LIKE-heavy string dims
    for col, _w in txt.most_common():
        spec = next((f for f in schema.fields if f.name == col), None)
        if spec is not None and not spec.data_type.is_numeric:
            cfg.indexing.text_index_columns.append(col)
            reasons.append(f"text({col}): LIKE/TEXT_MATCH workload")

    # near-unique dims: dictionary costs memory and buys nothing
    for f in schema.fields:
        c = cards.get(f.name)
        if f.name in dim_names and c is not None and c > 0.8 * n_rows:
            cfg.indexing.no_dictionary_columns.append(f.name)
            reasons.append(
                f"noDictionary({f.name}): near-unique "
                f"(card~{c} of {n_rows} rows)")

    # high-traffic group keys should stay dictionary-encoded even past
    # the cardinality threshold (the device group-by runs on dict ids)
    for col, _w in group_cols.most_common():
        c = cards.get(col)
        if c is not None and c > cfg.indexing.dict_cardinality_threshold \
                and col not in cfg.indexing.no_dictionary_columns:
            cfg.indexing.dictionary_columns.append(col)
            reasons.append(
                f"dictionary({col}): group-by key past the cardinality "
                "threshold — device group-by needs dict ids")

    dt = next((f for f in schema.fields
               if f.field_type.value == "DATE_TIME"), None)
    if dt is not None:
        cfg.time_column = dt.name
        reasons.append(f"timeColumn({dt.name}): time pruning + hybrid "
                       "boundary + age-based tiering candidate")
    return Recommendation(cfg, reasons)
