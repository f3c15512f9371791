"""Broker: SQL in, ResultTable out — parse, plan per segment, execute,
reduce.

Port of the single-stage query path of ``pinot_tpu/broker/broker.py``
(``Broker.query`` -> ``_execute_ctx``, and ``connect``), over the tables
registered with the broker, all on the broker's ``device``; the segments
run through the shared plan-then-batch loop of ``engine/serving.py``.

Every query registers with the accountant (engine/accounting.py) for its
execution, under ``OPTION(queryId=...)`` or a fresh id, with the deadline
``OPTION(timeoutMs=...)`` (default ``DEFAULT_TIMEOUT_MS``) counted from
the end of planning; a deadline kill at a sample point, or a deadline
passed by the time execution returns, raises ``QueryTimeoutError``. The
registrations are what the cross-query micro-batcher (engine/ragged.py)
counts as peers; ``micro_batch`` and ``micro_batch_window_ms`` configure
that process-wide batcher.

Joins, window functions, set operations, CTEs, views, subqueries,
EXPLAIN, hybrid tables, quotas, workload admission and tracing are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional, Union

import torch

from ..device import resolve_device
from ..engine.accounting import QueryKilledError, global_accountant
from ..engine.ragged import global_batcher
from ..engine.reduce import ResultTable, reduce_partials
from ..engine.serving import execute_planned, plan_segments
from ..query.context import build_query_context
from ..query.sql import (Exists, InSubquery, ScalarSubquery, SelectStmt,
                         SqlError, WindowFunc, ast_children, parse_sql)
from ..server.data_manager import TableDataManager
from ..utils.metrics import global_metrics

DEFAULT_TIMEOUT_MS = 10_000


class QueryTimeoutError(SqlError):
    pass


def _unported_feature(stmt: Any) -> str:
    """Name of the first feature of ``stmt`` the port cannot run, or ''."""
    if not isinstance(stmt, SelectStmt):
        return type(stmt).__name__
    if stmt.explain or stmt.analyze:
        return "EXPLAIN"
    if stmt.joins:
        return "JOIN"
    if stmt.ctes:
        return "WITH"
    found: List[str] = []

    def walk(e: Any) -> None:
        if isinstance(e, WindowFunc):
            found.append("window functions")
        elif isinstance(e, (InSubquery, Exists, ScalarSubquery)):
            found.append("subqueries")
        for c in ast_children(e):
            walk(c)

    for e in [i.expr for i in stmt.select] + [o.expr for o in
                                              stmt.order_by] \
            + [stmt.where, stmt.having]:
        if e is not None:
            walk(e)
    return found[0] if found else ""


class Broker:
    def __init__(self, device: Union[str, torch.device, None] = None,
                 micro_batch: Optional[bool] = None,
                 micro_batch_window_ms: Optional[float] = None):
        self.device = resolve_device(device)
        self._tables: Dict[str, TableDataManager] = {}
        # the batcher is process-global (fusion happens below the broker):
        # the flags configure it; None leaves the PINOT_MICROBATCH default
        if micro_batch is not None or micro_batch_window_ms is not None:
            global_batcher.configure(enabled=micro_batch,
                                     window_ms=micro_batch_window_ms)

    # -- table registry ----------------------------------------------------
    def register_table(self, dm: TableDataManager) -> None:
        if dm.device != self.device:
            raise ValueError(f"table {dm.table_name!r} is on {dm.device}, "
                             f"the broker on {self.device}")
        self._tables[dm.table_name] = dm

    def table(self, name: str) -> TableDataManager:
        if name not in self._tables:
            raise SqlError(f"table {name!r} not found; "
                           f"have {list(self._tables)}")
        return self._tables[name]

    # -- query path --------------------------------------------------------
    def query(self, sql: str) -> ResultTable:
        t0 = time.perf_counter()
        stmt = parse_sql(sql)
        feature = _unported_feature(stmt)
        if feature:
            raise NotImplementedError(
                f"{feature} is not yet ported to pinot_tpu_torch")
        # OPTION(queryId=...) names the accountant registration; two
        # concurrent queries sharing a name share their accounting
        query_id = str(stmt.options.get("queryId")
                       or uuid.uuid4().hex[:12])[:64]
        timeout_ms = int(stmt.options.get("timeoutMs", DEFAULT_TIMEOUT_MS))
        deadline = t0 + timeout_ms / 1e3
        ctx = build_query_context(stmt)
        global_accountant.register(query_id, deadline=deadline)
        try:
            return self._execute_ctx(ctx, t0, deadline, query_id)
        finally:
            global_accountant.unregister(query_id)

    def _execute_ctx(self, ctx, t0: float, deadline: float,
                     query_id: str) -> ResultTable:
        segments = self.table(ctx.table).acquire_segments()
        ex = plan_segments(ctx, segments)
        # the budget covers execution and reduce, not planning
        deadline += time.perf_counter() - t0
        global_accountant.set_deadline(query_id, deadline)
        try:
            partials = execute_planned(ex)
        except QueryKilledError as e:
            if e.is_deadline:
                global_metrics.count("broker_query_timeouts")
                raise QueryTimeoutError(str(e)) from None
            raise
        if time.perf_counter() > deadline:
            global_metrics.count("broker_query_timeouts")
            raise QueryTimeoutError(
                f"query timed out (>{int((deadline - t0) * 1e3)}ms)")
        result = reduce_partials(ctx, partials)
        result.num_segments = len(segments)
        result.num_segments_pruned = ex.pruned
        result.num_docs_scanned = ex.docs_scanned
        result.time_ms = (time.perf_counter() - t0) * 1e3
        return result


class Connection:
    """Client-facing handle (pinot-clients java-client analog)."""

    def __init__(self, broker: Broker):
        self.broker = broker

    def execute(self, sql: str) -> ResultTable:
        return self.broker.query(sql)

    __call__ = execute


def connect(broker: Broker) -> Connection:
    return Connection(broker)
