"""Vectorized hash equi-join over relations.

Port of ``pinot_tpu/multistage/join.py`` (host numpy, no device code).

Reference parity: pinot-query-runtime/.../runtime/operator/
HashJoinOperator.java (build hash table on the right, probe with the left,
INNER/LEFT semantics). Numpy formulation: factorize composite keys over
both sides, sort the build side once, then searchsorted ranges give every
probe row its match span — repeat/expand instead of a per-row hash loop.

SQL NULL contract: a NULL join key matches nothing (null-masked build rows
are excluded from the hash table; null-masked probe rows get zero matches —
and under LEFT they null-extend). Unmatched LEFT rows take each right
column's default null value with the null mask set (Pinot's
null-handling-disabled representation).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .relation import Relation


def _composite_codes(left_cols: List[np.ndarray],
                     right_cols: List[np.ndarray]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Factorize multi-column keys jointly so equal values share codes."""
    nl = len(left_cols[0]) if left_cols else 0
    code_l = np.zeros(nl, dtype=np.int64)
    code_r = np.zeros(len(right_cols[0]) if right_cols else 0,
                      dtype=np.int64)
    for lv, rv in zip(left_cols, right_cols):
        if lv.dtype == object or rv.dtype == object or \
                lv.dtype.kind in "US" or rv.dtype.kind in "US":
            lv = np.asarray(lv, dtype=object).astype(str)
            rv = np.asarray(rv, dtype=object).astype(str)
        both = np.concatenate([lv, rv])
        uniq, inv = np.unique(both, return_inverse=True)
        code_l = code_l * len(uniq) + inv[: len(lv)]
        code_r = code_r * len(uniq) + inv[len(lv):]
    return code_l, code_r


def _key_nulls(rel: Relation, keys: List[str]) -> Optional[np.ndarray]:
    out = None
    for k in keys:
        nm = rel.null_mask(k)
        if nm is not None:
            out = nm.copy() if out is None else (out | nm)
    return out


def null_extend(left: Relation, right: Relation) -> Relation:
    """left rows x all right columns as NULL (LEFT JOIN no-match shape)."""
    n = left.n_rows
    data: Dict[str, np.ndarray] = {k: v for k, v in left.data.items()}
    nulls: Dict[str, np.ndarray] = {k: v for k, v in left.nulls.items()}
    for k, v in right.data.items():
        if v.dtype == object or v.dtype.kind in "US":
            col = np.full(n, "null", dtype=object)
        else:
            col = np.zeros(n, dtype=v.dtype)
        data[k] = col
        nulls[k] = np.ones(n, dtype=bool)
    return Relation(data, nulls, left.name)


def hash_join(left: Relation, right: Relation,
              left_keys: List[str], right_keys: List[str],
              how: str = "inner", return_idx: bool = False):
    """-> Relation, or (Relation, l_idx, r_idx, matched) when return_idx.

    l_idx/r_idx map each output row to its source rows; matched is False
    on LEFT-join null-extended rows. RIGHT is LEFT with the sides
    swapped (column set identical); FULL is LEFT plus null-extended
    unmatched build rows (HashJoinOperator.java:60-76 coverage).
    return_idx is only meaningful for INNER/LEFT (FULL's appended rows
    have no probe index; the executor's unified non-equi path uses
    INNER + explicit null-extension for the outer types).
    """
    if how == "right":
        if return_idx:
            raise ValueError("return_idx unsupported for RIGHT joins")
        return hash_join(right, left, right_keys, left_keys, "left")
    if how == "full" and return_idx:
        raise ValueError("return_idx unsupported for FULL joins")
    if how not in ("inner", "left", "full"):
        raise ValueError(f"unsupported join type {how!r}")
    code_l, code_r = _composite_codes(
        [left.raw_values(k) for k in left_keys],
        [right.raw_values(k) for k in right_keys])

    # NULL keys never participate in matching
    lnull = _key_nulls(left, left_keys)
    rnull = _key_nulls(right, right_keys)
    if rnull is not None and rnull.any():
        valid_r = np.nonzero(~rnull)[0]
        code_r_valid = code_r[valid_r]
    else:
        valid_r = np.arange(len(code_r))
        code_r_valid = code_r

    order_valid = np.argsort(code_r_valid, kind="stable")
    order = valid_r[order_valid]          # original right indices, sorted
    sorted_r = code_r_valid[order_valid]
    lo = np.searchsorted(sorted_r, code_l, side="left")
    hi = np.searchsorted(sorted_r, code_l, side="right")
    counts = hi - lo
    if lnull is not None:
        counts = np.where(lnull, 0, counts)

    if how in ("left", "full"):
        out_counts = np.maximum(counts, 1)  # unmatched keep one null row
    else:
        out_counts = counts

    total = int(out_counts.sum())
    l_idx = np.repeat(np.arange(len(code_l)), out_counts)
    starts = np.concatenate([[0], np.cumsum(out_counts)[:-1]])
    within = np.arange(total) - np.repeat(starts, out_counts)
    r_pos = np.repeat(lo, out_counts) + within
    matched = np.repeat(counts > 0, out_counts)
    r_pos = np.where(matched & (len(order) > 0),
                     np.minimum(r_pos, max(len(order) - 1, 0)), 0)
    r_idx = order[r_pos] if len(order) else np.zeros(total, dtype=np.int64)

    rel = materialize_join(left, right, l_idx, r_idx, matched, how)
    if how == "full":
        # append right rows no probe row matched, left columns null
        hit = np.zeros(right.n_rows, dtype=bool)
        if matched.any():
            hit[r_idx[matched]] = True
        un = np.nonzero(~hit)[0]
        if len(un):
            rel = Relation.concat([rel, null_extend(right.take(un), left)])
    if return_idx:
        return rel, l_idx, r_idx, matched
    return rel


def materialize_join(left: Relation, right: Relation, l_idx: np.ndarray,
                     r_idx: np.ndarray, matched: np.ndarray,
                     how: str) -> Relation:
    """Gather output columns for resolved join pairs (shared by the
    numpy hash join above and the device join in device_join.py)."""
    total = len(l_idx)
    data: Dict[str, np.ndarray] = {}
    nulls: Dict[str, np.ndarray] = {}
    for k, v in left.data.items():
        data[k] = v[l_idx]
        if k in left.nulls:
            nulls[k] = left.nulls[k][l_idx]
    for k, v in right.data.items():
        col = v[r_idx] if len(v) else np.zeros(total, dtype=v.dtype)
        nm = right.nulls.get(k)
        nm = nm[r_idx] if nm is not None else None
        if how in ("left", "full"):
            unmatched = ~matched
            if unmatched.any():
                col = col.copy()
                col[unmatched] = _default_for(col.dtype)
                nm = (np.zeros(total, dtype=bool) if nm is None
                      else nm) | unmatched
        if nm is not None and nm.any():
            nulls[k] = nm
        data[k] = col
    return Relation(data, nulls, f"{left.name}*{right.name}")


def cross_join(left: Relation, right: Relation,
               max_rows: Optional[int] = None) -> Relation:
    """Cartesian product (CROSS JOIN). Bounded by max_rows (default from
    PINOT_MAX_ROWS_IN_JOIN, 25M) — the reference guards the same blowup
    with the maxRowsInJoin hint (HashJoinOperator join-row limits)."""
    import os

    cap = max_rows if max_rows is not None else int(
        os.environ.get("PINOT_MAX_ROWS_IN_JOIN", 25_000_000))
    total = left.n_rows * right.n_rows
    if total > cap:
        from ..query.sql import SqlError
        raise SqlError(
            f"CROSS JOIN would produce {total} rows (cap {cap}; raise "
            "PINOT_MAX_ROWS_IN_JOIN to override)")
    l_idx = np.repeat(np.arange(left.n_rows), right.n_rows)
    r_idx = np.tile(np.arange(right.n_rows), left.n_rows)
    matched = np.ones(total, dtype=bool)
    return materialize_join(left, right, l_idx, r_idx, matched, "inner")


def _default_for(dtype) -> object:
    if dtype == object or dtype.kind in "US":
        return "null"
    if dtype.kind == "f":
        return 0.0
    return 0
