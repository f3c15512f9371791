"""Logical query context: classified, validated query — table-level,
segment-independent.

Reference parity: pinot-core/.../query/request/context/QueryContext (built
by BrokerRequestToQueryContextConverter): holds select expressions,
aggregations, group-by expressions, filter, having, order-by, limit. The
planner (planner.py) lowers this to per-segment kernel plans.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .sql import (Between, BinaryOp, BoolAnd, BoolNot, BoolOr, CaseWhen,
                  Cast, Comparison, FuncCall, Identifier, InList, IsNull,
                  Like, Literal, OrderItem, SelectStmt, SqlError, Star,
                  ast_children, collect_identifiers)

from ..ops.aggregations import AGG_NAME_TO_KIND as AGG_FUNCS  # noqa: F401
from ..ops.aggregations import is_agg_name, resolve_call


@dataclass(frozen=True)
class AggExpr:
    kind: str          # count | sum | ... (ops/aggregations.py registry)
    arg: Any           # value expression AST (None for COUNT(*))
    label: str
    arg2: Any = None   # second value expression (covar, *withtime)
    params: Tuple[Any, ...] = ()  # literal params (percentile p, ...)

    def key(self) -> str:
        return self.label


@dataclass
class GapfillSpec:
    """Broker-reduce time-bucket gapfill (reference: pinot-core/.../query/reduce/GapfillProcessor.java:50).
    Extracted from GAPFILL(timeExpr, start, end, interval,
    FILL(col, 'FILL_PREVIOUS_VALUE'|'FILL_DEFAULT_VALUE')...,
    TIMESERIESON(col, ...)) in the select list."""
    time_label: str
    start: int
    end: int
    interval: int
    fills: Dict[str, str]              # env label -> previous | default
    series_labels: List[str]


@dataclass
class QueryContext:
    table: str
    select_items: List[Any]            # AggExpr | expr AST (group key / selection)
    labels: List[str]                  # output column names in select order
    aggregations: List[AggExpr]
    group_by: List[Any]
    filter: Optional[Any]
    having: Optional[Any]
    order_by: List[OrderItem]
    limit: Optional[int]
    offset: int
    options: dict = field(default_factory=dict)
    gapfill: Optional[GapfillSpec] = None

    @property
    def is_aggregation(self) -> bool:
        return len(self.aggregations) > 0

    @property
    def is_group_by(self) -> bool:
        return len(self.group_by) > 0


def _expr_label(e: Any) -> str:
    if isinstance(e, Identifier):
        return e.name
    if isinstance(e, Literal):
        return repr(e.value)
    if isinstance(e, Star):
        return "*"
    if isinstance(e, FuncCall):
        inner = ",".join(_expr_label(a) for a in e.args)
        d = "distinct " if e.distinct else ""
        return f"{e.name}({d}{inner})"
    if isinstance(e, BinaryOp):
        return f"({_expr_label(e.lhs)}{e.op}{_expr_label(e.rhs)})"
    if isinstance(e, Comparison):
        return f"({_expr_label(e.lhs)}{e.op}{_expr_label(e.rhs)})"
    if isinstance(e, CaseWhen):
        parts = " ".join(f"when {_expr_label(c)} then {_expr_label(v)}"
                         for c, v in e.whens)
        tail = f" else {_expr_label(e.else_)}" if e.else_ is not None else ""
        return f"case {parts}{tail} end"
    if isinstance(e, Cast):
        return f"cast({_expr_label(e.expr)} as {e.type_name})"
    return str(e)


def _find_aggs(e: Any, out: List[FuncCall]) -> None:
    if isinstance(e, FuncCall):
        if is_agg_name(e.name) or (e.name == "count" and e.distinct):
            out.append(e)
            return
    for a in ast_children(e):
        _find_aggs(a, out)


def _extract_gapfill(stmt: SelectStmt
                     ) -> Tuple[SelectStmt, Optional[GapfillSpec]]:
    """Pull a GAPFILL(...) wrapper off the select list, leaving the bare
    time expression in its place (planning stays unchanged; the fill
    happens at broker reduce — GapfillProcessor analog)."""
    from .sql import SelectItem
    if not any(isinstance(item.expr, FuncCall) and item.expr.name == "gapfill"
               for item in stmt.select):
        return stmt, None
    spec: Optional[GapfillSpec] = None
    alias_map = {item.alias: _expr_label(item.expr)
                 for item in stmt.select
                 if item.alias and not isinstance(item.expr, Star)}

    def _target_label(e: Any) -> str:
        if isinstance(e, Identifier) and e.name in alias_map:
            return alias_map[e.name]
        return _expr_label(e)

    new_select: List[SelectItem] = []
    for item in stmt.select:
        e = item.expr
        if not (isinstance(e, FuncCall) and e.name == "gapfill"):
            new_select.append(item)
            continue
        if spec is not None:
            raise SqlError("multiple GAPFILL expressions")
        args = e.args
        if len(args) < 4:
            raise SqlError(
                "GAPFILL needs (timeExpr, start, end, interval"
                "[, FILL(col, mode)..., TIMESERIESON(col, ...)])")
        nums = []
        for a, what in zip(args[1:4], ("start", "end", "interval")):
            if not isinstance(a, Literal) or isinstance(a.value, str):
                raise SqlError(f"GAPFILL {what} must be a numeric literal")
            nums.append(int(a.value))
        start, end, interval = nums
        if interval <= 0 or end <= start:
            raise SqlError("GAPFILL needs end > start and interval > 0")
        fills: Dict[str, str] = {}
        series: List[str] = []
        for a in args[4:]:
            if isinstance(a, FuncCall) and a.name == "fill":
                if len(a.args) != 2 or not isinstance(a.args[1], Literal):
                    raise SqlError("FILL needs (column, 'mode')")
                mode = str(a.args[1].value).upper()
                if mode not in ("FILL_PREVIOUS_VALUE",
                                "FILL_DEFAULT_VALUE"):
                    raise SqlError(f"unknown FILL mode {a.args[1].value!r}")
                fills[_target_label(a.args[0])] = \
                    "previous" if mode == "FILL_PREVIOUS_VALUE" \
                    else "default"
            elif isinstance(a, FuncCall) and a.name == "timeserieson":
                if not a.args:
                    raise SqlError("TIMESERIESON needs >= 1 column")
                series = [_target_label(x) for x in a.args]
            else:
                raise SqlError(
                    "GAPFILL extras must be FILL(...) or TIMESERIESON(...)")
        time_expr = args[0]
        spec = GapfillSpec(_expr_label(time_expr), start, end, interval,
                           fills, series)
        new_select.append(SelectItem(time_expr, item.alias))
    if spec is None:
        return stmt, None
    import dataclasses as _dc
    return _dc.replace(stmt, select=new_select), spec


def build_query_context(stmt: SelectStmt) -> QueryContext:
    stmt, gapfill_spec = _extract_gapfill(stmt)
    aggregations: List[AggExpr] = []
    select_items: List[Any] = []
    labels: List[str] = []

    def register_agg(fc: FuncCall) -> AggExpr:
        args = fc.args
        if fc.name == "count" and not fc.distinct and \
                (not args or isinstance(args[0], Star)):
            resolved = ("count", None, None, ())
        else:
            resolved = resolve_call(fc.name, args, fc.distinct)
            if resolved is None:
                raise SqlError(f"unknown aggregation {fc.name!r}")
        kind, arg, arg2, params = resolved
        agg = AggExpr(kind, arg, _expr_label(fc), arg2, params)
        for existing in aggregations:
            if existing == agg:
                return existing
        aggregations.append(agg)
        return agg

    def _resolve_ordinal(e: Any, grouping: bool = False) -> Any:
        """GROUP BY 2 / ORDER BY 2 name the 2nd select item (Calcite
        ordinal scope resolution; SqlToRelConverter)."""
        if isinstance(e, Literal) and isinstance(e.value, int) \
                and not isinstance(e.value, bool) \
                and 1 <= e.value <= len(stmt.select) \
                and not isinstance(stmt.select[e.value - 1].expr, Star):
            target = stmt.select[e.value - 1].expr
            if grouping:
                found: List[FuncCall] = []
                _find_aggs(target, found)
                if found:
                    raise SqlError("aggregate functions are not allowed in "
                                   f"GROUP BY (ordinal {e.value})")
            return target
        return e

    group_by = [_resolve_ordinal(g, grouping=True) for g in stmt.group_by]
    group_labels = {_expr_label(g) for g in group_by}
    order_exprs = [_resolve_ordinal(o.expr) for o in stmt.order_by]
    if any(n is not o for n, o in zip(group_by, stmt.group_by)) or any(
            n is not o.expr for n, o in zip(order_exprs, stmt.order_by)):
        import dataclasses as _dc
        stmt = _dc.replace(stmt, order_by=[
            OrderItem(e, o.ascending)
            for e, o in zip(order_exprs, stmt.order_by)], group_by=group_by)

    for item in stmt.select:
        e = item.expr
        if isinstance(e, Star):
            if stmt.distinct:
                raise SqlError("SELECT DISTINCT * not supported")
            select_items.append(Star())
            labels.append("*")
            continue
        found: List[FuncCall] = []
        _find_aggs(e, found)
        if found:
            if isinstance(e, FuncCall) and e in found:
                agg = register_agg(e)
                select_items.append(agg)
                labels.append(item.alias or agg.label)
            else:
                # post-aggregation expression (PostAggregationHandler
                # analog): register inner aggs, evaluate the expression
                # over finalized values at reduce
                for fc in found:
                    register_agg(fc)
                select_items.append(e)
                labels.append(item.alias or _expr_label(e))
        else:
            select_items.append(e)
            labels.append(item.alias or _expr_label(e))
            if group_by and _expr_label(e) not in group_labels \
                    and not _keys_only(e, group_by):
                # expressions over group keys compute at reduce; anything
                # referencing non-grouped columns is a user error
                raise SqlError(
                    f"non-aggregate select column "
                    f"{_expr_label(e)!r} must appear in GROUP BY")

    # register aggs appearing only in HAVING / ORDER BY so partials exist
    for extra in ([stmt.having] if stmt.having else []) + \
                 [o.expr for o in stmt.order_by]:
        found = []
        _find_aggs(extra, found)
        for fc in found:
            register_agg(fc)

    if aggregations:
        bad = [i for i in select_items
               if not isinstance(i, AggExpr) and not _is_group_key(i, group_by)
               and not _find_aggs_present(i)
               and not _keys_only(i, group_by)]
        if bad:
            raise SqlError(f"selection columns mixed with aggregations: {bad}")

    if stmt.distinct:
        # SELECT DISTINCT a, b == group-by on the select expressions with a
        # hidden aggregation (DistinctOperator analog: the group-by engine
        # IS the distinct engine; dictionary path stays device-resident)
        if aggregations:
            raise SqlError("SELECT DISTINCT with aggregations not supported")
        group_by = list(select_items)
    if group_by and not aggregations:
        # plain GROUP BY / DISTINCT: synthesize a hidden COUNT(*) so every
        # execution path (kernel, host, fast) has a mergeable state; reduce
        # projects only select_items so it never surfaces
        aggregations.append(AggExpr("count", None, "count(*)"))

    # Pinot applies the default LIMIT 10 at compile time
    # (CalciteSqlParser DEFAULT_SELECTION_LIMIT analog); doing the same here
    # bounds per-segment selection materialization, not just the reduce.
    limit = stmt.limit
    if limit is None and not (aggregations and not group_by):
        limit = 10

    # ORDER BY may reference a select alias (Calcite scope resolution);
    # substitute the aliased expression so evaluators see real columns
    alias_exprs = {item.alias: item.expr for item in stmt.select
                   if item.alias and not isinstance(item.expr, Star)}
    order_by = [
        OrderItem(alias_exprs[o.expr.name], o.ascending)
        if isinstance(o.expr, Identifier) and o.expr.name in alias_exprs
        else o for o in stmt.order_by]

    if gapfill_spec is not None and not group_by:
        raise SqlError("GAPFILL requires a GROUP BY over the time bucket")
    return QueryContext(
        table=stmt.table,
        select_items=select_items,
        labels=labels,
        aggregations=aggregations,
        group_by=group_by,
        filter=stmt.where,
        having=stmt.having,
        order_by=order_by,
        limit=limit,
        offset=stmt.offset,
        options=stmt.options,
        gapfill=gapfill_spec,
    )


def _is_group_key(e: Any, group_by: List[Any]) -> bool:
    lbl = _expr_label(e)
    return any(_expr_label(g) == lbl for g in group_by)


def _find_aggs_present(e: Any) -> bool:
    found: List[FuncCall] = []
    _find_aggs(e, found)
    return bool(found)


def _keys_only(e: Any, group_by: List[Any]) -> bool:
    """Expression derivable from the group keys (computable at reduce).

    An expression is covered when it IS a group key (label match), is a
    literal, or every sub-expression is covered. A bare column that is not
    itself a key is NOT covered even if some key mentions it — reduce only
    has key values in scope (SELECT val ... GROUP BY ABS(val) must fail
    here with a clear error, not at reduce)."""
    if not group_by:
        return False
    group_labels = {_expr_label(g) for g in group_by}

    def covered(x: Any) -> bool:
        if _expr_label(x) in group_labels:
            return True
        if isinstance(x, Literal):
            return True
        if isinstance(x, Identifier):
            return False
        kids = ast_children(x)
        return bool(kids) and all(covered(c) for c in kids)

    return covered(e)
