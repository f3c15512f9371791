"""Broker: SQL in, ResultTable out — parse, rewrite, plan per segment,
execute, reduce.

Port of ``pinot_tpu/broker/broker.py`` over the tables registered with the
broker, all on the broker's ``device``; the segments run through the
shared plan-then-batch loop of ``engine/serving.py``. The statement
surface is the reference's, in its order: ``query`` (the reference's
``_query``: parse; CREATE/DROP VIEW) -> ``_execute_stmt``, which refuses
what the port lacks (below), expands views into CTEs,
materializes CTEs as scoped single-segment tables, combines set-operation
branches (``engine/setops.py``), resolves IN / scalar / EXISTS subqueries
(an equality-correlated EXISTS becomes a semi-join through an IN list),
splits a hybrid logical table at its time boundary (``routing.py``),
charges the table's QPS quota (``quota.py``) and then runs a single-stage
statement here or a JOIN / window statement in the multi-stage engine
(``multistage/executor``). EXPLAIN renders the plan without a scan.

Every leaf statement registers with the accountant (engine/accounting.py)
for its execution, under ``OPTION(queryId=...)`` or a fresh id, with the
deadline ``OPTION(timeoutMs=...)`` (default ``DEFAULT_TIMEOUT_MS``); a
single-stage statement counts it from the end of planning. A deadline
kill at a sample point, or a deadline passed by the time execution
returns, raises ``QueryTimeoutError``. The registrations are what the
cross-query micro-batcher (engine/ragged.py) counts as peers;
``micro_batch`` and ``micro_batch_window_ms`` configure that process-wide
batcher.

Tracing, as the reference's: ``OPTION(trace=true)`` returns the flat
phase envelope (``utils/trace.Tracing``) in ``result.trace``; EXPLAIN
ANALYZE executes the statement under the span tracer (``utils/spans``)
and renders the tree (``query/explain.finalize_analyze``, with the
``broker_overhead`` child so the root's children sum to its wall time);
``traceRatio`` (constructor, ``PINOT_TRACE_RATIO`` or
``OPTION(traceRatio=...)``) samples queries deterministically by query
id into a span tree, counted in ``sampled_traces``. A star-tree rollup
answers a matching aggregation on both halves of a hybrid table too.

Overload admission, as the reference's (``broker/workload.py``): each
user query is admitted once (``OPTION(queryId=...)`` names it) before
any planning, under the tenant of its left-most table (``TableConfig.
tenant``); a plan-only EXPLAIN is never admitted. A shed raises
``OverloadShedError`` (a ``SqlError`` carrying ``retryAfterMs``); rung 3
clamps the query's ``timeoutMs`` (``clamp_brownout``), and rung 1 and up
skip ``traceRatio`` sampling. The accountant's registration carries the
tenant, tier and SQL text.

Traces persist as validated ``query_trace`` records of ``utils/ledger``
at ``OPTION(ledgerPath=...)``, ``Broker(trace_ledger_path=...)`` or
``PINOT_TPU_LEDGER_PATH``. What differs from the reference: the port
writes a ledger only at a path its caller gives, so
``OPTION(ledgerTrace=true)`` with none of the three raises ``SqlError``
where the reference writes ``PERF_LEDGER.jsonl`` in the working
directory; the trace names the torch device type as its backend;
mesh-resident tables are not ported.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..engine.accounting import QueryKilledError, global_accountant
from ..engine.ragged import global_batcher
from ..engine.reduce import DEFAULT_LIMIT, ResultTable, reduce_partials
from ..engine.serving import execute_planned, plan_segments
from ..engine.setops import combine_setop, order_limit_rows
from ..multistage import execute_multistage, explain_multistage, \
    is_multistage
from ..query.context import build_query_context
from ..query.explain import explain_rows, finalize_analyze
from ..query.planner import _truthy
from ..query.sql import (BoolAnd, Comparison, CteDef, DdlStmt, Exists,
                         Identifier, InList, InSubquery, IsNull, Literal,
                         ScalarSubquery, SelectItem, SelectStmt, SetOpStmt,
                         SqlError, ast_children, collect_identifiers,
                         map_expr, parse_sql)
from ..segment import SegmentBuilder
from ..server.data_manager import TableDataManager
from ..spi import DataType, FieldSpec, FieldType, Schema, TableConfig
from ..utils import ledger as uledger
from ..utils import phases as ph
from ..utils.metrics import global_metrics
from ..utils.spans import sample_decision, span, span_tracer
from ..utils.trace import Tracing
from .quota import QueryQuotaManager
from .routing import resolve_time_column, split_hybrid, time_boundary
from .workload import (clamp_brownout, global_workload, leaf_table,
                       parse_retry_attempt)

DEFAULT_TIMEOUT_MS = 10_000
DEFAULT_TRACE_RATIO = 0.0
_LEDGER_PATH_MISSING = (
    "OPTION(ledgerTrace=true) needs a ledger path: OPTION(ledgerPath=...), "
    "Broker(trace_ledger_path=...) or PINOT_TPU_LEDGER_PATH")


def ratio_value(raw: Any, what: str = "traceRatio") -> float:
    """A sampling ratio in [0, 1] or a 400-class SqlError (shared by the
    per-query option and the broker default, so a bad PINOT_TRACE_RATIO
    fails at broker start, not per query)."""
    try:
        v = float(raw)
    except (TypeError, ValueError):
        raise SqlError(f"invalid {what} value {raw!r}; "
                       "expected a fraction in [0, 1]") from None
    if not 0.0 <= v <= 1.0:
        raise SqlError(f"invalid {what} value {raw!r}; "
                       "expected a fraction in [0, 1]")
    return v


def parse_trace_ratio(options: Dict[str, Any], default: float) -> float:
    """OPTION(traceRatio=...) validated before dispatch; the broker
    default when absent."""
    raw = options.get("traceRatio")
    return default if raw is None else ratio_value(raw)


def default_trace_ratio(override: Optional[float] = None) -> float:
    """The broker's default ratio: the constructor's, then
    PINOT_TRACE_RATIO, then off."""
    if override is not None:
        return ratio_value(override)
    env_ratio = os.environ.get("PINOT_TRACE_RATIO")
    if env_ratio is not None:
        return ratio_value(env_ratio)
    return DEFAULT_TRACE_RATIO


def _cte_table(name: str, columns: List[str], rows: List[tuple],
               tmpdirs: List[str], device: torch.device
               ) -> TableDataManager:
    """Materialize a CTE result as a single-segment table on ``device``.
    Types are inferred per column (all-int -> LONG, numeric -> DOUBLE,
    else STRING); an empty result registers a segment-less manager."""
    dm = TableDataManager(name, device=device)
    if not rows:
        return dm
    cols: Dict[str, Any] = {}
    fields: List[FieldSpec] = []
    for j, cname in enumerate(columns):
        vals = [r[j] for r in rows]
        if any(v is None for v in vals):
            raise SqlError(f"CTE {name!r} column {cname!r} produced NULL "
                           "values; filter them in the CTE query")
        if all(isinstance(v, (int, np.integer))
               and not isinstance(v, (bool, np.bool_)) for v in vals):
            cols[cname] = np.asarray(vals, dtype=np.int64)
            dt = DataType.LONG
        elif all(isinstance(v, (int, float, np.integer, np.floating))
                 and not isinstance(v, (bool, np.bool_)) for v in vals):
            cols[cname] = np.asarray(vals, dtype=np.float64)
            dt = DataType.DOUBLE
        else:
            cols[cname] = np.asarray([str(v) for v in vals])
            dt = DataType.STRING
        fields.append(FieldSpec(cname, dt, FieldType.DIMENSION))
    out = tempfile.mkdtemp(prefix="ptpu_cte_")
    tmpdirs.append(out)
    seg_dir = SegmentBuilder(Schema(name, fields),
                             TableConfig(name)).build(cols, out, "cte_0")
    dm.add_segment_dir(seg_dir)
    return dm


class QueryTimeoutError(SqlError):
    pass


class Broker:
    def __init__(self, device: Union[str, torch.device, None] = None,
                 micro_batch: Optional[bool] = None,
                 micro_batch_window_ms: Optional[float] = None,
                 trace_ratio: Optional[float] = None,
                 trace_ledger_path: Optional[str] = None):
        self.device = resolve_device(device)
        self._trace_ledger_path = trace_ledger_path
        self._tables: Dict[str, TableDataManager] = {}
        # the batcher is process-global (fusion happens below the broker):
        # the flags configure it; None leaves the PINOT_MICROBATCH default
        if micro_batch is not None or micro_batch_window_ms is not None:
            global_batcher.configure(enabled=micro_batch,
                                     window_ms=micro_batch_window_ms)
        # name -> view body statement (CREATE VIEW ... AS <select>);
        # expanded into CTEs at reference time (_expand_views)
        self._views: Dict[str, Any] = {}
        self.quota = QueryQuotaManager()
        # overload protection (broker/workload.py): per-tenant budgets
        # and the degradation ladder, process-global like the accountant
        self.workload = global_workload
        # traceRatio sampling: constructor, then PINOT_TRACE_RATIO, then
        # off; OPTION(traceRatio=...) overrides it per query
        self._trace_ratio = default_trace_ratio(trace_ratio)

    # -- table registry ----------------------------------------------------
    def register_table(self, dm: TableDataManager) -> None:
        if dm.device != self.device:
            raise ValueError(f"table {dm.table_name!r} is on {dm.device}, "
                             f"the broker on {self.device}")
        self._tables[dm.table_name] = dm
        cfg = dm.table_config
        if cfg is not None and getattr(cfg, "quota_qps", None):
            self.quota.set_quota(dm.table_name, cfg.quota_qps)
        if cfg is not None:
            # the workload tenant from the TableConfig; tables without
            # one charge the default tenant
            self.workload.set_table_tenant(dm.table_name,
                                           getattr(cfg, "tenant", None))

    def table(self, name: str) -> TableDataManager:
        if name not in self._tables:
            raise SqlError(f"table {name!r} not found; "
                           f"have {list(self._tables)}")
        return self._tables[name]

    @property
    def table_names(self) -> List[str]:
        return list(self._tables)

    # -- query path --------------------------------------------------------
    def query(self, sql: str) -> ResultTable:
        global_metrics.count("broker_queries")
        with global_metrics.timer("broker_query"):
            try:
                return self._query(sql)
            except SqlError:
                global_metrics.count("broker_query_exceptions")
                raise

    def _query(self, sql: str) -> ResultTable:
        t0 = time.perf_counter()
        stmt = parse_sql(sql)
        if isinstance(stmt, DdlStmt):
            return self._execute_ddl(stmt, t0)
        stmt._raw_sql = sql
        opts = getattr(stmt, "options", {}) or {}
        # OPTION(queryId=...) lets replicas and retries of one logical
        # query agree on the sampling and shed decisions
        qid = str(opts.get("queryId") or _new_query_id())[:64]
        # overload admission, once per user query (nested CTE, subquery
        # and set-operation statements run under this ticket); a
        # plan-only EXPLAIN is never admitted, EXPLAIN ANALYZE is. A shed
        # raises OverloadShedError here, before any planning
        ticket = None
        if not getattr(stmt, "explain", False) or \
                getattr(stmt, "analyze", False):
            ticket = self.workload.admit(
                qid, leaf_table(stmt),
                retry_attempt=parse_retry_attempt(opts))
            if ticket.brownout:
                # rung 3: clamp to the floor deadline, partial results
                clamp_brownout(stmt.options, DEFAULT_TIMEOUT_MS)
        try:
            # traceRatio sampling: plan-only EXPLAIN and EXPLAIN ANALYZE
            # never sample, nor does a query admitted at rung 1 or up;
            # the decision is deterministic in the query id
            # (utils/spans.sample_decision) and costs nothing unsampled
            if not getattr(stmt, "analyze", False) and \
                    not getattr(stmt, "explain", False) and \
                    not (ticket is not None and ticket.degraded):
                ratio = parse_trace_ratio(opts, self._trace_ratio)
                if ratio > 0 and sample_decision(qid, ratio):
                    return self._execute_sampled(stmt, sql, t0, qid)
            return self._execute_stmt(stmt, t0)
        finally:
            self.workload.release(ticket)

    def _execute_sampled(self, stmt, sql: str, t0: float,
                         qid: str) -> ResultTable:
        """A traceRatio-sampled query: executed under the span tracer (the
        EXPLAIN ANALYZE machinery, minus the rendered rows). Subqueries,
        CTEs and set-operation branches recurse through _execute_stmt, so
        the whole statement lands in ONE tree."""
        root = span_tracer.start(ph.QUERY,
                                 table=getattr(stmt, "table", None),
                                 query_id=qid, sampled=True)
        try:
            try:
                result = self._execute_stmt(stmt, t0)
            finally:
                root = span_tracer.stop() or root
        except SqlError as e:
            # a failed sampled query still lands its (partial) tree
            root.annotate(error=str(e)[:200])
            self._append_trace(root, stmt, sql, qid)
            raise
        root.annotate(rows=len(result.rows))
        self._append_trace(root, stmt, sql, qid)
        return result

    def _ledger_path(self, stmt) -> Optional[str]:
        """The caller's ledger path: the query's ``ledgerPath``, then the
        broker's ``trace_ledger_path``, then ``PINOT_TPU_LEDGER_PATH``."""
        return (getattr(stmt, "options", {}).get("ledgerPath")
                or self._trace_ledger_path
                or os.environ.get("PINOT_TPU_LEDGER_PATH"))

    def _append_trace(self, root, stmt, sql: str, qid: str) -> None:
        """Count a sampled trace and, when a ledger path is configured,
        append it as a validated ``query_trace`` record; no path means
        counted, not persisted, as in the reference."""
        global_metrics.count("sampled_traces")
        path = self._ledger_path(stmt)
        if not path:
            return
        try:
            uledger.append_record(uledger.trace_record(
                root, sql, backend=self.device.type, qid=qid,
                sampled=True), path)
        except OSError:
            # observability must never fail the data path
            global_metrics.count("query_trace_write_errors")

    # -- views (QueryEnvironment view catalog analog) ----------------------
    def _execute_ddl(self, stmt: DdlStmt, t0: float) -> ResultTable:
        if stmt.kind == "create_view":
            if stmt.name in self._tables or self._is_hybrid(stmt.name):
                raise SqlError(
                    f"cannot create view {stmt.name!r}: a table with "
                    "that name exists")
            if stmt.name in self._views and not stmt.or_replace:
                raise SqlError(
                    f"view {stmt.name!r} already exists; use CREATE OR "
                    "REPLACE VIEW")
            self._views[stmt.name] = stmt.stmt
            status = "CREATED"
        else:
            if stmt.name not in self._views:
                if stmt.if_exists:
                    status = "NOT_FOUND"
                else:
                    raise SqlError(f"view {stmt.name!r} not found; "
                                   f"have {sorted(self._views)}")
            else:
                del self._views[stmt.name]
                status = "DROPPED"
        result = ResultTable(["view", "status"], [(stmt.name, status)])
        result.time_ms = (time.perf_counter() - t0) * 1e3
        return result

    @property
    def view_names(self) -> List[str]:
        return sorted(self._views)

    def _referenced_tables(self, stmt, out: set) -> None:
        """Every table name a statement tree references (main, joins,
        set-op branches, subqueries, CTE bodies)."""
        if isinstance(stmt, SetOpStmt):
            self._referenced_tables(stmt.left, out)
            self._referenced_tables(stmt.right, out)
            return
        out.add(stmt.table)
        for j in stmt.joins:
            out.add(j.table.name)
        for cte in getattr(stmt, "ctes", []) or []:
            self._referenced_tables(cte.stmt, out)

        def walk_expr(e):
            if isinstance(e, (InSubquery, Exists, ScalarSubquery)):
                self._referenced_tables(e.stmt, out)
            for c in ast_children(e):
                walk_expr(c)

        for e in (stmt.where, stmt.having):
            if e is not None:
                walk_expr(e)

    def _expand_views(self, stmt):
        """Prepend referenced views (transitively, dependencies first) as
        CTEs — the CTE machinery then materializes and scopes them. Names
        already registered as tables (including a scoped CTE broker's)
        or defined as explicit CTEs are never expanded."""
        if not self._views or isinstance(stmt, DdlStmt):
            return stmt
        defined = {c.name for c in getattr(stmt, "ctes", []) or []}
        order: List[str] = []

        def visit(name: str, stack: tuple) -> None:
            if name in defined or name in self._tables or name in order \
                    or name not in self._views:
                return
            if name in stack:
                raise SqlError(
                    "view cycle: " + " -> ".join(stack + (name,)))
            refs: set = set()
            self._referenced_tables(self._views[name], refs)
            for r in sorted(refs):
                visit(r, stack + (name,))
            order.append(name)

        refs: set = set()
        self._referenced_tables(stmt, refs)
        for r in sorted(refs):
            visit(r, ())
        if not order:
            return stmt
        new_ctes = [CteDef(n, None, copy.deepcopy(self._views[n]))
                    for n in order]
        stmt.ctes = new_ctes + (stmt.ctes or [])
        return stmt

    def _is_hybrid(self, table: str) -> bool:
        return table not in self._tables and \
            f"{table}_OFFLINE" in self._tables and \
            f"{table}_REALTIME" in self._tables

    def _execute_stmt(self, stmt, t0: float) -> ResultTable:
        if getattr(stmt, "analyze", False):
            return self._execute_analyze(stmt, t0)
        stmt = self._expand_views(stmt)
        if getattr(stmt, "ctes", None):
            return self._execute_with_ctes(stmt, t0)
        if isinstance(stmt, SetOpStmt):
            return self._execute_setop(stmt, t0)
        stmt = self._resolve_subqueries(stmt)
        # OPTION(queryId=...) names the accountant registration; two
        # concurrent queries sharing a name share their accounting
        query_id = str(stmt.options.get("queryId")
                       or _new_query_id())[:64]
        timeout_ms = int(stmt.options.get("timeoutMs", DEFAULT_TIMEOUT_MS))
        deadline = t0 + timeout_ms / 1e3
        # the tenant rides the accountant's registration: the tier-aware
        # kill order and the post-paid budgets (observe at unregister)
        # read it there
        tenant, tier = self.workload.resolve(stmt.table)
        raw_sql = getattr(stmt, "_raw_sql", None)
        if self._is_hybrid(stmt.table):
            if is_multistage(stmt):
                raise SqlError("joins/window functions over hybrid "
                               "tables are not supported yet; query the "
                               "_OFFLINE/_REALTIME tables directly")
            global_accountant.register(query_id, deadline=deadline,
                                       tenant=tenant, tier=tier,
                                       sql=raw_sql)
            try:
                return self._execute_hybrid(stmt, t0)
            finally:
                global_accountant.unregister(query_id)
        self.quota.check(stmt.table)
        if is_multistage(stmt):
            # the v2 engine, registered with the accountant like any query
            if stmt.explain:
                return explain_multistage(self, stmt)
            global_accountant.register(query_id, deadline=deadline,
                                       tenant=tenant, tier=tier,
                                       sql=raw_sql)
            try:
                return execute_multistage(self, stmt)
            finally:
                global_accountant.unregister(query_id)
        ctx = build_query_context(stmt)
        trace_on = _truthy(ctx.options.get("trace"))
        scope = Tracing.register(query_id, trace_on)
        global_accountant.register(query_id, deadline=deadline,
                                   tenant=tenant, tier=tier,
                                   sql=raw_sql)
        try:
            result = self._execute_ctx(ctx, stmt, t0, deadline, query_id)
        finally:
            global_accountant.unregister(query_id)
            Tracing.unregister()
        if trace_on:
            result.trace = scope.to_dict()
        return result

    # -- EXPLAIN ANALYZE ---------------------------------------------------
    def _execute_analyze(self, stmt, t0: float) -> ResultTable:
        """Execute the statement for real under the span tracer and
        return the rendered span tree: per-phase wall ms (planning /
        device execute / transfer / reduce), the cost-model strategy
        trace, and estimated vs measured selectivity.
        The device work inside each span is fenced (spans.device_fence),
        so its time is the card's, not the launch's."""
        ledger_path = None
        if _truthy(stmt.options.get("ledgerTrace")):
            ledger_path = self._ledger_path(stmt)
            if not ledger_path:
                raise SqlError(_LEDGER_PATH_MISSING)
        stmt.analyze = False  # the re-entrant call executes normally
        root = span_tracer.start(ph.QUERY,
                                 table=getattr(stmt, "table", None))
        try:
            inner = self._execute_stmt(stmt, t0)
        finally:
            root = span_tracer.stop() or root
        root.annotate(
            rows=len(inner.rows),
            num_segments=inner.num_segments,
            num_docs_scanned=inner.num_docs_scanned)
        # the broker_overhead child (context build, quota, accountant
        # registration) makes the root's children sum to its wall time
        cols, rows, trace = finalize_analyze(root)
        result = ResultTable(cols, rows,
                             num_segments=inner.num_segments,
                             num_docs_scanned=inner.num_docs_scanned)
        result.trace = trace
        if ledger_path:
            uledger.append_record(uledger.trace_record(
                root, getattr(stmt, "_raw_sql", str(stmt.table)),
                backend=self.device.type), ledger_path)
        result.time_ms = (time.perf_counter() - t0) * 1e3
        return result

    # -- hybrid offline+realtime tables (TimeBoundaryManager analog) -------
    def _execute_hybrid(self, stmt: SelectStmt, t0: float) -> ResultTable:
        """Logical table = T_OFFLINE + T_REALTIME: the offline side answers
        time <= boundary, the realtime side time > boundary, partials merge
        in one reduce (BaseBrokerRequestHandler hybrid scatter)."""
        logical = stmt.table
        off_dm = self.table(f"{logical}_OFFLINE")

        cfg = off_dm.table_config
        time_col = resolve_time_column(
            {"timeColumn": getattr(cfg, "time_column", None)}
            if cfg is not None else None, off_dm.schema)
        if time_col is None:
            raise SqlError(
                f"hybrid table {logical!r} needs a timeColumn in its "
                f"config or a DATE_TIME schema field")

        boundary = time_boundary(
            {seg.name: {"columns": {time_col: {
                "max": getattr(seg.columns.get(time_col), "max", None)}}}
             for seg in off_dm.acquire_segments()}, time_col)
        if boundary is None:
            raise SqlError(
                f"hybrid table {logical!r}: no offline segments, or "
                f"offline segments lack {time_col!r} metadata for the "
                f"time boundary")

        off_stmt, rt_stmt = split_hybrid(stmt, time_col, boundary)
        if stmt.explain:
            # _execute_stmt charges the quota for the explain itself
            return self._execute_stmt(off_stmt, t0)
        self.quota.check(f"{logical}_OFFLINE")
        partials: List[Any] = []
        n_segments = pruned = docs = 0
        try:
            for part_stmt in (off_stmt, rt_stmt):
                ctx_p = build_query_context(part_stmt)
                segments = self.table(ctx_p.table).acquire_segments()
                ex = plan_segments(ctx_p, segments)
                partials.extend(execute_planned(ex))
                n_segments += len(segments)
                pruned += ex.pruned
                docs += ex.docs_scanned
        except QueryKilledError as e:
            if e.is_deadline:
                global_metrics.count("broker_query_timeouts")
                raise QueryTimeoutError(str(e)) from None
            raise
        result = reduce_partials(build_query_context(off_stmt), partials)
        result.num_segments = n_segments
        result.num_segments_pruned = pruned
        result.num_docs_scanned = docs
        result.time_ms = (time.perf_counter() - t0) * 1e3
        return result

    # -- set operations (v2 set operators; combine at the broker) ----------
    _BRANCH_LIMIT = 1 << 31  # branches run unlimited; compound LIMIT caps

    def _execute_setop(self, stmt: SetOpStmt, t0: float) -> ResultTable:
        if stmt.explain:
            return self._explain_setop(stmt)
        left = self._run_branch(stmt.left, stmt.options)
        right = self._run_branch(stmt.right, stmt.options)
        result = combine_setop(stmt.op, stmt.all, left, right)
        limit = stmt.limit if stmt.limit is not None else DEFAULT_LIMIT
        result = order_limit_rows(result, stmt.order_by, limit, stmt.offset)
        result.time_ms = (time.perf_counter() - t0) * 1e3
        return result

    def _run_branch(self, stmt, options: Optional[dict] = None
                    ) -> ResultTable:
        if isinstance(stmt, SetOpStmt):
            left = self._run_branch(stmt.left, options)
            right = self._run_branch(stmt.right, options)
            return combine_setop(stmt.op, stmt.all, left, right)
        if options:
            # compound-level OPTION(...) applies to every branch
            # (branch-specific keys win)
            stmt.options = {**options, **stmt.options}
        if stmt.limit is None:
            stmt.limit = self._BRANCH_LIMIT
        return self._execute_stmt(stmt, time.perf_counter())

    def _explain_setop(self, stmt: SetOpStmt) -> ResultTable:
        rows: List[tuple] = []

        def emit(node, parent: int) -> None:
            rid = len(rows)
            if isinstance(node, SetOpStmt):
                tag = node.op.upper() + ("_ALL" if node.all else "")
                rows.append((f"SET_OP({tag})", rid, parent))
                emit(node.left, rid)
                emit(node.right, rid)
            else:
                rows.append((f"SELECT({node.table})", rid, parent))

        rows.append(("BROKER_REDUCE", 0, -1))
        emit(stmt, 0)
        return ResultTable(["Operator", "Operator_Id", "Parent_Id"], rows)

    # -- WITH / common table expressions -----------------------------------
    def _execute_with_ctes(self, stmt, t0: float) -> ResultTable:
        """Materialize each CTE (in order — later CTEs may reference
        earlier ones) into a segment on the broker's device, registered
        under a SCOPED broker copy, then run the main statement against
        it. The scope shadows real tables for this query only; when it is
        torn down each CTE segment leaves the device (and the device-
        memory registry) and its directory is removed. Reference:
        pinot-query-planner/.../QueryEnvironment.java:126 (Calcite CTE
        planning); materialization makes the CTE result a real segment
        every engine path (joins, windows, group-by kernels) handles."""
        scoped = copy.copy(self)
        scoped._tables = dict(self._tables)
        tmpdirs: List[str] = []
        ctes: List[TableDataManager] = []

        def register(name: str, columns: List[str], rows: List[tuple]):
            dm = _cte_table(name, columns, rows, tmpdirs, self.device)
            ctes.append(dm)
            scoped._tables[name] = dm

        try:
            cap = int(stmt.options.get("cteLimit", 1_000_000))
            for cte in stmt.ctes:
                if stmt.explain and not stmt.joins:
                    # EXPLAIN must not execute CTE/view bodies (same
                    # contract as _resolve_subqueries): register a
                    # zero-row placeholder carrying the output columns
                    # so the outer plan still builds. SELECT * bodies
                    # have no static column list, and the multistage
                    # join path needs real (typed) segments —
                    # materialize those the normal way.
                    names = self._static_output_columns(cte.stmt)
                    if names is not None:
                        if cte.columns and \
                                len(cte.columns) != len(names):
                            raise SqlError(
                                f"CTE {cte.name!r} declares "
                                f"{len(cte.columns)} columns but its "
                                f"query produces {len(names)}")
                        register(cte.name, list(cte.columns or names), [])
                        continue
                # keep the body's OWN ctes (a view defined with a WITH
                # clause): the recursive _execute_stmt materializes them
                # in a further scope; replace() still copies the node so
                # option/limit mutations never touch the stored body
                sub = dataclasses.replace(cte.stmt)
                if "timeoutMs" in stmt.options:
                    sub.options.setdefault("timeoutMs",
                                           stmt.options["timeoutMs"])
                # a CTE materializes its FULL result (no engine default
                # LIMIT 10), bounded by the cteLimit resource guard the
                # same way IN-subqueries are: an explicit LIMIT within
                # the cap is honored, anything else gets the cap+1
                # probe + error so the guard stays enforceable
                user_limit = sub.limit
                honored = user_limit is not None and user_limit <= cap
                if not honored:
                    sub.limit = cap + 1
                res = scoped._execute_stmt(sub, time.perf_counter())
                if not honored and len(res.rows) > cap:
                    over = (f" (its LIMIT {user_limit} exceeds the cap "
                            "and was not applied)"
                            if user_limit is not None else "")
                    raise SqlError(
                        f"CTE {cte.name!r} produced more than {cap} "
                        f"rows{over}; add a LIMIT <= {cap} or raise "
                        "OPTION(cteLimit=...)")
                names = cte.columns or res.columns
                if len(names) != len(res.columns):
                    raise SqlError(
                        f"CTE {cte.name!r} declares {len(cte.columns)} "
                        f"columns but its query produces "
                        f"{len(res.columns)}")
                register(cte.name, list(names), res.rows)
            inner = dataclasses.replace(stmt, ctes=[])
            return scoped._execute_stmt(inner, t0)
        finally:
            # each CTE segment leaves the device (columns, stacked copies,
            # cubes) and the devmem registry before its directory goes
            for dm in ctes:
                for seg in dm.acquire_segments():
                    dm.remove_segment(seg.name)
            for d in tmpdirs:
                shutil.rmtree(d, ignore_errors=True)

    @staticmethod
    def _static_output_columns(stmt) -> Optional[List[str]]:
        """Output column names of a statement WITHOUT executing it, or
        None when they aren't statically known (SELECT *)."""
        if isinstance(stmt, SetOpStmt):
            return Broker._static_output_columns(stmt.left)
        try:
            labels = build_query_context(stmt).labels
        except SqlError:
            return None
        if any(lb == "*" for lb in labels):
            return None
        return list(labels)

    # -- subqueries (IN_SUBQUERY / scalar / EXISTS rewrite at the broker) --
    _TRUE = Comparison("==", Literal(1), Literal(1))
    _FALSE = Comparison("==", Literal(1), Literal(0))

    def _decorrelate_exists(self, e: Exists, stmt: SelectStmt):
        """Rewrite EXISTS to something the existing machinery executes.

        Uncorrelated: the subquery runs once with LIMIT 1 and folds to a
        constant predicate. Equality-correlated (the decorrelatable
        class Calcite's SubQueryRemoveRule handles as a semi-join):
        exactly one top-level AND-ed `inner.col = outer.col` conjunct —
        rewritten to `outer.col IN (SELECT inner.col FROM ... WHERE
        <remaining conjuncts>)`, which the IN-subquery (IdSet) path then
        materializes. Returns the replacement predicate node, or raises
        SqlError for correlation shapes outside that class."""
        sub = e.stmt
        # standard SQL scoping: an alias REPLACES the table name as the
        # qualifier (so a self-table subquery with an alias still sees
        # the outer name as a correlation, not as itself)
        outer_labels = {(stmt.table_alias or stmt.table).lower()}
        inner_labels = {(sub.table_alias or sub.table).lower()}

        def cols_of(table: str) -> set:
            # tolerant: hybrid logical names (ev -> ev_OFFLINE/_REALTIME)
            # aren't in _tables; qualified correlation still classifies
            # by label, and a misjudged bare identifier surfaces as an
            # unknown-column error at execution, never a wrong result
            try:
                schema = self.table(table).schema
            except SqlError:
                return set()
            return {f.name for f in schema.fields} if schema else set()

        outer_cols = cols_of(stmt.table)
        inner_cols = cols_of(sub.table)

        def side(ident: str):
            """'inner' | 'outer' for an identifier in the subquery."""
            if "." in ident:
                qual, col = ident.split(".", 1)
                if qual.lower() in inner_labels:
                    return "inner", col
                if qual.lower() in outer_labels:
                    return "outer", col
                raise SqlError(
                    f"unknown qualifier {qual!r} in EXISTS subquery "
                    f"(tables in scope: {sorted(inner_labels)} inner, "
                    f"{sorted(outer_labels)} outer)")
            if ident in inner_cols:
                return "inner", ident
            if ident in outer_cols:
                return "outer", ident
            return "inner", ident   # let execution raise unknown-column

        conjuncts = (list(sub.where.children)
                     if isinstance(sub.where, BoolAnd)
                     else [sub.where] if sub.where is not None else [])
        corr, local = [], []
        for c in conjuncts:
            sides = {side(i)[0] for i in collect_identifiers(c)}
            (corr if "outer" in sides else local).append(c)
        if not corr:
            probe = dataclasses.replace(
                sub, limit=1, ctes=[],
                options={**stmt.options, **sub.options})
            res = self._execute_stmt(probe, time.perf_counter())
            return self._TRUE if res.rows else self._FALSE

        if len(corr) != 1 or sub.joins or sub.group_by or sub.having:
            raise SqlError(
                "correlated EXISTS is supported with exactly one "
                "top-level `inner.col = outer.col` equality and no "
                "joins/GROUP BY/HAVING in the subquery; rewrite the "
                "query as an explicit JOIN instead")
        c = corr[0]
        if not (isinstance(c, Comparison) and c.op == "=="
                and isinstance(c.lhs, Identifier)
                and isinstance(c.rhs, Identifier)):
            raise SqlError(
                "correlated EXISTS predicate must be a plain equality "
                f"between one inner and one outer column, got "
                f"{type(c).__name__}")
        s1, col1 = side(c.lhs.name)
        s2, col2 = side(c.rhs.name)
        if {s1, s2} != {"inner", "outer"}:
            raise SqlError(
                "correlated EXISTS equality must reference exactly one "
                "inner and one outer column")
        inner_col = col1 if s1 == "inner" else col2
        outer_col = col2 if s1 == "inner" else col1

        def strip(expr):
            def unqualify(x):
                if isinstance(x, Identifier) and "." in x.name:
                    qual, col = x.name.split(".", 1)
                    if qual.lower() in inner_labels:
                        return Identifier(col)
                return x
            return map_expr(expr, unqualify)

        remaining = [strip(x) for x in local]
        # inner NULLs can never witness the equality; filtering them keeps
        # the materialized IN list clean for the NOT EXISTS (BoolNot) form
        remaining.append(IsNull(Identifier(inner_col), negated=True))
        where = remaining[0] if len(remaining) == 1 \
            else BoolAnd(tuple(remaining))
        sub2 = dataclasses.replace(
            sub, select=[SelectItem(Identifier(inner_col))],
            distinct=True, where=where, limit=None, order_by=[],
            table_alias=None,
            options={**stmt.options, **sub.options})
        return InSubquery(Identifier(outer_col), sub2, negated=False)

    def _resolve_subqueries(self, stmt: SelectStmt) -> SelectStmt:
        if not any(_has_subquery(e) for e in (stmt.where, stmt.having)
                   if e is not None):
            return stmt     # nothing to rewrite: keep the parsed trees
        if stmt.explain:
            # EXPLAIN must not execute the subquery scan; substitute
            # placeholder shapes so the plan still builds
            def placeholder(e):
                if isinstance(e, InSubquery):
                    return InList(e.expr, (Literal(0),), e.negated)
                if isinstance(e, ScalarSubquery):
                    return Literal(0)
                if isinstance(e, Exists):
                    return self._TRUE
                return e
            if stmt.where is not None:
                stmt.where = map_expr(stmt.where, placeholder)
            if stmt.having is not None:
                stmt.having = map_expr(stmt.having, placeholder)
            return stmt

        def rw(e):
            if isinstance(e, Exists):
                # decorrelate/fold, then resolve the InSubquery it may
                # produce through the same materialization below
                return rw(self._decorrelate_exists(e, stmt))
            if isinstance(e, InSubquery):
                # bounded materialization: the broker fetches cap+1 rows
                # and ERRORS past the cap instead of silently truncating
                # to a wrong answer
                cap = int(stmt.options.get("inSubqueryLimit", 100_000))
                sub = e.stmt
                # an explicit user LIMIT within the cap is honored as-is;
                # anything else — no LIMIT, or a LIMIT above the cap —
                # keeps the cap+1 probe + error so the resource guard
                # stays enforceable
                user_limit = sub.limit
                honored = user_limit is not None and user_limit <= cap
                if not honored:
                    sub.limit = cap + 1
                res = self._execute_stmt(sub, time.perf_counter())
                if len(res.columns) != 1:
                    raise SqlError(
                        f"IN subquery must select exactly 1 column, "
                        f"got {len(res.columns)}")
                if not honored and len(res.rows) > cap:
                    over = (f" (its LIMIT {user_limit} exceeds the cap "
                            "and was not applied)"
                            if user_limit is not None else "")
                    raise SqlError(
                        f"IN subquery produced more than {cap} rows"
                        f"{over}; add a LIMIT <= {cap}, narrow it, or "
                        "raise OPTION(inSubqueryLimit=...)")
                vals = tuple(Literal(r[0].item() if hasattr(r[0], "item")
                                     else r[0]) for r in res.rows)
                return InList(e.expr, vals, e.negated)
            if isinstance(e, ScalarSubquery):
                res = self._execute_stmt(e.stmt, time.perf_counter())
                if len(res.rows) != 1 or len(res.rows[0]) != 1:
                    raise SqlError(
                        f"scalar subquery must return 1 row x 1 column, "
                        f"got {len(res.rows)} rows")
                v = res.rows[0][0]
                return Literal(v.item() if hasattr(v, "item") else v)
            return e

        if stmt.where is not None:
            stmt.where = map_expr(stmt.where, rw)
        if stmt.having is not None:
            stmt.having = map_expr(stmt.having, rw)
        return stmt

    def _execute_ctx(self, ctx, stmt, t0: float, deadline: float,
                     query_id: str) -> ResultTable:
        dm = self.table(ctx.table)
        segments = dm.acquire_segments()
        # mesh-resident table: one dispatch over the mesh and the
        # collectives' combine replace the per-segment scatter-gather
        dist = getattr(dm, "distributed", None)
        if dist is not None and ctx.is_aggregation and not stmt.explain:
            with Tracing.phase(ph.DISTRIBUTED_EXECUTE), \
                    span(ph.DISTRIBUTED_EXECUTE):
                partial = dist.try_execute(ctx)
            if partial is not None:
                result = reduce_partials(ctx, [partial])
                result.num_segments = len(dist.segments)
                result.num_docs_scanned = sum(s.n_docs
                                              for s in dist.segments)
                result.time_ms = (time.perf_counter() - t0) * 1e3
                return result
        if stmt.explain:
            # a rollup that would answer a segment is counted, never run
            ex = plan_segments(ctx, segments, explain=True)
            cols, rows = explain_rows(ctx, ex.real_plans,
                                      ex.rollup_segments)
            return ResultTable(cols, rows, num_segments=len(segments))
        ex = plan_segments(ctx, segments)
        # the budget covers execution and reduce, not planning
        deadline += time.perf_counter() - t0
        global_accountant.set_deadline(query_id, deadline)
        Tracing.count("numSegmentsQueried", len(segments))
        Tracing.count("numSegmentsPruned", ex.pruned)
        Tracing.count("numDocsScanned", ex.docs_scanned)
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
        with Tracing.phase(ph.REDUCE), span(ph.REDUCE,
                                          partials=len(partials)):
            result = reduce_partials(ctx, partials)
        result.num_segments = len(segments)
        result.num_segments_pruned = ex.pruned
        result.num_docs_scanned = ex.docs_scanned
        result.time_ms = (time.perf_counter() - t0) * 1e3
        return result


def _new_query_id() -> str:
    """12 random hex digits (the reference's uuid4().hex[:12], the same
    randomness without building a UUID)."""
    return os.urandom(6).hex()


def _has_subquery(e: Any) -> bool:
    """Whether an expression holds an IN / scalar / EXISTS subquery (the
    nodes _resolve_subqueries rewrites; ast_children reaches every node
    map_expr rebuilds)."""
    if isinstance(e, (InSubquery, Exists, ScalarSubquery)):
        return True
    return any(_has_subquery(c) for c in ast_children(e))


class Connection:
    """Client-facing handle (pinot-clients java-client analog)."""

    def __init__(self, broker: Broker):
        self.broker = broker

    def execute(self, sql: str) -> ResultTable:
        return self.broker.query(sql)

    __call__ = execute


def connect(broker: Broker) -> Connection:
    return Connection(broker)
