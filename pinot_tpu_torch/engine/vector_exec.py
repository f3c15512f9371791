"""Vector search execution plane: the VECTOR_SIMILARITY query family.

Port of ``pinot_tpu/engine/vector_exec.py``. The engine half of
``VECTOR_SIMILARITY(col, ARRAY[...], k[, nprobe])``, between the SQL
surface (query/sql.py parses the ARRAY literal, query/planner.py validates
every call before any execution) and the index (index/vector.py: the flat
scan and the IVF page layout, searched by the CUDA kernels of
ops/vecsearch.py). Everything here is host orchestration.

- **One search per (query, segment, call shape).** The filter predicate,
  the ORDER BY score key and a select-list score reuse one memoized search
  per query, keyed by (query id, reader token, query vector, k, nprobe).
- **Micro-batching.** Concurrent queries against the same (reader, k,
  nprobe) meet in a ``MicroBatchQueue`` admission window
  (engine/scheduler.py): the leader stacks the query vectors and makes one
  launch (``VectorIndexReader.search_batch``, whose per-query result is the
  same bits at any batch size); followers receive their row. A lone query
  (fewer than two registered with the accountant) and a disabled batcher
  search solo, the reason counted (``vector_solo_*``); the batcher follows
  ``PINOT_MICROBATCH`` (engine/ragged.default_enabled) and reads
  ``PINOT_VECTOR_WINDOW_MS`` and ``PINOT_VECTOR_MAX_BATCH``.
- **Segments merge as ordered selections.** Per-segment top-k partials
  carry their host-recomputed score as the ORDER BY key, so the ordinary
  selection reduce merges them.
- **Tier integration.** Every search touches the owning segment's tier
  hook first; a demotion drops the reader's device tensors and the search
  uploads them again, with the same answer.

Structured user errors (``SqlError``, never a host-path demotion): missing
index, non-numeric or empty ARRAY, dim mismatch, k <= 0, nprobe <= 0,
malformed arguments. Under a trace each (query, segment) search is one
``vector_search`` span, annotated batched or solo as the reference's.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Any, List, Optional, Tuple

import numpy as np

from ..query.sql import FuncCall, Identifier, Literal, SqlError
from ..utils import phases as ph
from ..utils.metrics import global_metrics
from ..utils.spans import annotate, span

FUNC_NAME = "vector_similarity"
DEFAULT_K = 10
DEFAULT_WINDOW_MS = 2.0
DEFAULT_MAX_BATCH = 16
_MEMO_CAP = 256


# ---------------------------------------------------------------------------
# SQL-surface validation (the structured 400s)
# ---------------------------------------------------------------------------

def is_vector_call(e: Any) -> bool:
    return isinstance(e, FuncCall) and e.name == FUNC_NAME


def parse_call(e: FuncCall) -> Tuple[str, Tuple[float, ...], int,
                                     Optional[int]]:
    """-> (col, query vector, k, nprobe|None); raises SqlError on every
    malformed shape (user errors — never host-fallback candidates)."""
    if not 2 <= len(e.args) <= 4:
        raise SqlError("VECTOR_SIMILARITY takes (col, ARRAY[...], "
                       "topK[, nprobe])")
    if not isinstance(e.args[0], Identifier):
        raise SqlError("VECTOR_SIMILARITY needs a column as its first "
                       "argument")
    col = e.args[0].name
    if not isinstance(e.args[1], Literal) \
            or not isinstance(e.args[1].value, (tuple, list)):
        raise SqlError("VECTOR_SIMILARITY query must be an ARRAY[...] "
                       "literal")
    qv = tuple(e.args[1].value)
    if not qv or not all(
            isinstance(v, (int, float)) and not isinstance(v, bool)
            for v in qv):
        raise SqlError("VECTOR_SIMILARITY query must be a non-empty "
                       "numeric ARRAY[...]")
    k = DEFAULT_K
    if len(e.args) > 2:
        k = _int_arg(e.args[2], "topK")
    nprobe = None
    if len(e.args) > 3:
        nprobe = _int_arg(e.args[3], "nprobe")
    return col, tuple(float(v) for v in qv), k, nprobe


def _int_arg(a: Any, what: str) -> int:
    if not isinstance(a, Literal) \
            or not isinstance(a.value, (int, float)) \
            or isinstance(a.value, bool) or int(a.value) != a.value \
            or int(a.value) <= 0:
        raise SqlError(f"VECTOR_SIMILARITY {what} must be a positive "
                       "integer")
    return int(a.value)


def reader_for(seg, col: str):
    """The segment's vector index reader, owner-attached (tier/devmem
    identity); SqlError when the column/index is missing."""
    meta = seg.columns.get(col)
    if meta is None:
        raise SqlError(f"unknown column {col!r}")
    reader = seg.index_reader(col, "vector")
    if reader is None:
        raise SqlError(f"VECTOR_SIMILARITY requires a vector index on "
                       f"{col!r} (tableConfig indexing."
                       "vectorIndexColumns)")
    return reader


def validate_call(seg, e: FuncCall):
    """Fail-fast plan-time validation (query/planner.py runs this over
    the filter, select list and ORDER BY): every structured 400 fires
    BEFORE any execution work, on the kernel and host paths alike.
    Returns (col, query vector, k, nprobe, reader) so execution-path
    callers consume ONE parse + reader lookup."""
    col, qv, k, nprobe = parse_call(e)
    reader = reader_for(seg, col)
    if len(qv) != reader.dim:
        raise SqlError(f"VECTOR_SIMILARITY dim mismatch: query has "
                       f"{len(qv)} components, index on {col!r} has "
                       f"{reader.dim}")
    return col, qv, k, nprobe, reader


# ---------------------------------------------------------------------------
# per-query search memo
# ---------------------------------------------------------------------------

_MEMO_LOCK = threading.Lock()
_MEMO: "OrderedDict[Tuple, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()


def _memo_get(key: Tuple):
    with _MEMO_LOCK:
        got = _MEMO.get(key)
        if got is not None:
            _MEMO.move_to_end(key)
        return got


def _memo_put(key: Tuple, val) -> None:
    with _MEMO_LOCK:
        _MEMO[key] = val
        while len(_MEMO) > _MEMO_CAP:
            _MEMO.popitem(last=False)


def clear_memo() -> None:
    with _MEMO_LOCK:
        _MEMO.clear()


# ---------------------------------------------------------------------------
# the admission window (round-13 leader/follower idiom)
# ---------------------------------------------------------------------------

class _VSub:
    __slots__ = ("q", "future")

    def __init__(self, q: Tuple[float, ...]):
        self.q = q
        self.future: "Future[Any]" = Future()


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class VectorBatcher:
    """Fuses concurrent same-shape vector searches into one device
    launch (module docstring). Results are exactly equal to solo (the
    kernels' per-query arithmetic does not depend on the batch), so the
    batcher is a throughput policy only, never a semantics knob."""

    def __init__(self, window_ms: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 enabled: Optional[bool] = None):
        from ..engine.scheduler import MicroBatchQueue
        from .ragged import default_enabled
        self.window_ms = window_ms if window_ms is not None else \
            _env_float("PINOT_VECTOR_WINDOW_MS", DEFAULT_WINDOW_MS)
        self.max_batch = int(max_batch if max_batch is not None else
                             _env_float("PINOT_VECTOR_MAX_BATCH",
                                        DEFAULT_MAX_BATCH))
        self.enabled = default_enabled() if enabled is None \
            else bool(enabled)
        self.queue = MicroBatchQueue()

    def configure(self, enabled: Optional[bool] = None,
                  window_ms: Optional[float] = None,
                  max_batch: Optional[int] = None) -> "VectorBatcher":
        if enabled is not None:
            self.enabled = bool(enabled)
        if window_ms is not None:
            self.window_ms = float(window_ms)
        if max_batch is not None:
            self.max_batch = int(max_batch)
        return self

    @staticmethod
    def _solo(reader, q, k, nprobe, reason: str):
        global_metrics.count(f"vector_solo_{reason}")
        annotate(batched=False, solo_reason=reason)
        scores, docs = reader.search_batch((q,), k, nprobe)
        return scores[0], docs[0]

    def search(self, reader, q: Tuple[float, ...], k: int,
               nprobe: Optional[int]):
        """One query's (scores, docs) for one segment, fused with
        concurrent peers when the admission window catches any."""
        from .accounting import global_accountant
        if not self.enabled:
            return self._solo(reader, q, k, nprobe, "disabled")
        # a lone query never waits the window (round-13 discipline)
        if len(global_accountant.running()) < 2:
            return self._solo(reader, q, k, nprobe, "no_peers")
        # reader.token, never id(): a GC'd reader's reused address must
        # not alias another reader's compatibility bucket
        key = (reader.token, int(k), reader.effective_nprobe(nprobe))
        sub = _VSub(q)
        t0 = time.perf_counter()
        batch = self.queue.offer(key, sub, self.window_ms / 1e3,
                                 self.max_batch)
        if batch is None:
            return self._follow(reader, sub, k, nprobe)
        if len(batch) == 1:
            annotate(queue_wait_ms=round(
                (time.perf_counter() - t0) * 1e3, 3))
            return self._solo(reader, q, k, nprobe, "window_expired")
        return self._lead(reader, batch, sub, k, nprobe)

    @staticmethod
    def _follow_timeout() -> float:
        """Generous enough for a leader paying a first kernel build, but
        reserving half the query's remaining deadline for the solo
        fallback, so a stalled leader cannot turn a servable query into a
        deadline kill."""
        from .accounting import global_accountant
        timeout = 60.0
        qid = global_accountant.current_query_id()
        usage = global_accountant.usage(qid) if qid else None
        if usage is not None and usage.deadline is not None:
            rem = usage.deadline - time.perf_counter()
            timeout = max(min(rem * 0.5, 60.0), 0.05)
        return timeout

    def _follow(self, reader, sub: _VSub, k, nprobe):
        try:
            result = sub.future.result(timeout=self._follow_timeout())
        except _FutTimeout:
            result = None
            reason = "timeout"
        except Exception:
            result = None
            reason = "leader_error"
        else:
            reason = "leader_error"
        if result is None:
            return self._solo(reader, sub.q, k, nprobe, reason)
        row, batch_size = result
        annotate(batched=True, batch_size=batch_size)
        return row

    def _lead(self, reader, batch: List[_VSub], own: _VSub, k, nprobe):
        try:
            scores, docs = reader.search_batch(
                [s.q for s in batch], k, nprobe)
        except BaseException as e:  # noqa: BLE001 — followers must not hang
            for s in batch:
                if s is not own and not s.future.done():
                    s.future.set_result(None)
            global_metrics.count("vector_fused_errors")
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            return self._solo(reader, own.q, k, nprobe, "leader_error")
        n = len(batch)
        global_metrics.count("vector_batched_dispatches")
        global_metrics.count("vector_batched_queries", n)
        mine = None
        for i, s in enumerate(batch):
            if s is own:
                mine = (scores[i], docs[i])
            else:
                s.future.set_result(((scores[i], docs[i]), n))
        annotate(batched=True, batch_size=n, leader=True)
        return mine


global_vector_batcher = VectorBatcher()


# ---------------------------------------------------------------------------
# engine entry points
# ---------------------------------------------------------------------------

def segment_search(seg, e: FuncCall) -> Tuple[np.ndarray, np.ndarray]:
    """One (scores, docs) top-k search for one (query, segment, call) —
    memoized so the filter mask and the score key share one launch."""
    col, qv, k, nprobe, reader = validate_call(seg, e)
    from .accounting import global_accountant
    qid = global_accountant.current_query_id()
    # reader.token (process-unique, never reused) keys the memo: an
    # id() key could serve a dropped segment's top-k to a new reader
    # allocated at the same address
    key = (qid, reader.token, qv, k, nprobe)
    got = _memo_get(key)
    if got is not None:
        return got
    owner = reader.owner()
    if owner is not None:
        # tier chaos hook (tier.evict may force-demote mid-query; the
        # search below transparently re-uploads, byte-identically)
        from .tier import global_tier
        global_tier.on_access(owner)
    with span(ph.VECTOR_SEARCH, segment=getattr(seg, "name", ""),
              col=col, k=k):
        global_metrics.count("vector_searches")
        scores, docs = global_vector_batcher.search(reader, qv, k,
                                                    nprobe)
    _memo_put(key, (scores, docs))
    return scores, docs


def filter_mask(seg, e: FuncCall) -> np.ndarray:
    """The VECTOR_SIMILARITY filter predicate: top-k doc mask for one
    segment (VectorSimilarityFilterOperator analog, IVF-backed)."""
    _scores, docs = segment_search(seg, e)
    mask = np.zeros(seg.n_docs, dtype=bool)
    hits = docs[docs >= 0]
    mask[hits] = True
    return mask


def order_scores(seg, e: FuncCall, sel: Optional[np.ndarray] = None
                 ) -> np.ndarray:
    """VECTOR_SIMILARITY as a VALUE (ORDER BY key / select-list score):
    the exact host-side similarity of each (selected) doc to the query
    vector. Host-computed from the stored matrix, so the merge keys are
    the same whatever the batching; with the matching WHERE conjunct the
    candidate selection already ran on the device through the filter's
    memoized search and ``sel`` holds at most k rows per segment. Without
    that filter (ORDER BY only) this scores every selected doc on the
    host, as the reference does."""
    _col, qv, _k, _nprobe, reader = validate_call(seg, e)
    return reader.host_scores(qv, sel)


def vector_calls(*exprs: Any) -> List[FuncCall]:
    """Every VECTOR_SIMILARITY call in the given expression trees (the
    planner's fail-fast validation walk)."""
    from ..query.sql import ast_children
    out: List[FuncCall] = []

    def walk(e: Any) -> None:
        if is_vector_call(e):
            out.append(e)
        for c in ast_children(e):
            walk(c)

    for e in exprs:
        if e is not None:
            walk(e)
    return out

