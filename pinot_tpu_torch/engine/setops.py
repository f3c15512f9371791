"""Set-operation combine: UNION / INTERSECT / EXCEPT [ALL].

Port of ``pinot_tpu/engine/setops.py``, copied line for line. Reference
system: pinot-query-runtime/.../runtime/operator/set/
{UnionOperator,IntersectOperator,MinusOperator}.java — the v2 engine's
set operators over transferable blocks. Here both sides are fully
reduced ResultTables (each side ran the normal scatter-gather/reduce
path), so the combine is a counter-based multiset merge on the broker:
UNION dedupes, INTERSECT keeps min multiplicity, EXCEPT subtracts, ALL
variants keep multiplicities. Column count must match; names come from
the left side, as in the reference.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, List, Optional, Tuple

from ..query.sql import Identifier, Literal, SqlError
from .reduce import ResultTable, _OrderKey


def _key(row: tuple) -> tuple:
    # np scalars and python scalars of equal value must collide
    out = []
    for v in row:
        if hasattr(v, "item"):
            v = v.item()
        out.append(v)
    return tuple(out)


def combine_setop(op: str, all_: bool, left: ResultTable,
                  right: ResultTable) -> ResultTable:
    if len(left.columns) != len(right.columns):
        raise SqlError(
            f"set operation arms have {len(left.columns)} vs "
            f"{len(right.columns)} columns")
    lrows = [tuple(r) for r in left.rows]
    rrows = [tuple(r) for r in right.rows]
    if op == "union":
        if all_:
            rows = lrows + rrows
        else:
            seen = set()
            rows = []
            for r in lrows + rrows:
                k = _key(r)
                if k not in seen:
                    seen.add(k)
                    rows.append(r)
    elif op == "intersect":
        rc = Counter(_key(r) for r in rrows)
        rows = []
        if all_:
            for r in lrows:
                k = _key(r)
                if rc.get(k, 0) > 0:
                    rc[k] -= 1
                    rows.append(r)
        else:
            emitted = set()
            for r in lrows:
                k = _key(r)
                if k in rc and k not in emitted:
                    emitted.add(k)
                    rows.append(r)
    elif op == "except":
        rc = Counter(_key(r) for r in rrows)
        rows = []
        if all_:
            for r in lrows:
                k = _key(r)
                if rc.get(k, 0) > 0:
                    rc[k] -= 1
                else:
                    rows.append(r)
        else:
            rset = set(rc)
            emitted = set()
            for r in lrows:
                k = _key(r)
                if k not in rset and k not in emitted:
                    emitted.add(k)
                    rows.append(r)
    else:
        raise SqlError(f"unknown set operation {op!r}")
    out = ResultTable(list(left.columns), rows)
    out.num_segments = left.num_segments + right.num_segments
    out.num_docs_scanned = left.num_docs_scanned + right.num_docs_scanned
    return out


def order_limit_rows(result: ResultTable, order_by, limit: Optional[int],
                     offset: int) -> ResultTable:
    """Compound-level ORDER BY (output columns by name or 1-based
    position) + LIMIT/OFFSET."""
    rows = result.rows
    if order_by:
        idxs: List[Tuple[int, bool]] = []
        for o in order_by:
            if isinstance(o.expr, Identifier):
                name = o.expr.name
                if name not in result.columns:
                    raise SqlError(
                        f"ORDER BY column {name!r} not in output "
                        f"{result.columns}")
                idxs.append((result.columns.index(name), o.ascending))
            elif isinstance(o.expr, Literal) and \
                    isinstance(o.expr.value, int):
                pos = o.expr.value
                if not 1 <= pos <= len(result.columns):
                    raise SqlError(f"ORDER BY position {pos} out of range")
                idxs.append((pos - 1, o.ascending))
            else:
                raise SqlError(
                    "compound ORDER BY supports output columns and "
                    "1-based positions")
        rows = sorted(rows, key=lambda r: tuple(
            _OrderKey(r[i], asc) for i, asc in idxs))
    if offset:
        rows = rows[offset:]
    if limit is not None:
        rows = rows[:limit]
    result.rows = rows
    return result
