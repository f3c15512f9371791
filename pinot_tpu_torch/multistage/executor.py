"""Multi-stage query execution: leaf scans -> shuffles -> joins -> agg.

Port of ``pinot_tpu/multistage/executor.py`` (``MultiStageExecutor``,
``execute_multistage``) on the broker's device, or over the shards of
its default mesh (``parallel/mesh.py``): leaf scans read the segments'
host copies, joins run on the device (``device_join``, K16, with its mesh
broadcast and hash-shuffle variants) or numpy, the window stage's scans
on the device (``window``, K17), and a co-located plan may run whole as
one device program (``fused``, K19).
EXPLAIN (``explain_multistage``) describes the stage topology without a
scan, with the reference's operator names. The span instrumentation is
not ported.

Reference parity: the v2 engine pipeline — QueryEnvironment.planQuery
(pinot-query-planner/.../QueryEnvironment.java:126, Calcite fragmentation),
QueryRunner.processQuery (pinot-query-runtime/.../QueryRunner.java:155),
LeafStageTransferableBlockOperator.java:78 (leaf stages compile to the
single-stage engine and stream blocks up), HashJoinOperator, and the
exchange layer (exchange.py). Planning here is rule-based rather than
Calcite: filter conjuncts push down to leaf scans when join semantics
allow, ON clauses split into equi-key shuffles + post-join filters, and
the final relation reuses the vectorized host evaluators + broker reduce.

Stage topology per query:
    stage 2..N+1: leaf scan per table (filter pushdown, column pruning)
    stage 1: hash/broadcast-exchange joins, post-join filter, aggregation
    stage 0: reduce (engine/reduce.py)
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..engine import host_eval
from ..engine.executor import AggPartial, GroupByPartial, SelectionPartial
from ..engine.reduce import ResultTable, reduce_partials
from ..query.context import build_query_context
from ..query.sql import (BoolAnd, Comparison, Identifier, InList, Literal,
                         SelectStmt, SqlError, Star, TableRef)
from ..utils import phases as ph
from ..utils.spans import span
from . import device_join
from .device_join import try_device_join
from .exchange import HashExchange, MailboxService
from .join import cross_join, hash_join, null_extend
from .relation import Relation

BROADCAST_THRESHOLD = 50_000   # right side smaller -> broadcast join
SHUFFLE_PARTITIONS = 4         # hash-exchange fan-out for large joins


def is_multistage(stmt: SelectStmt) -> bool:
    from .window import has_window
    return bool(stmt.joins) or has_window(stmt)


# ---------------------------------------------------------------------------
# expression utilities
# ---------------------------------------------------------------------------

def _map_identifiers(e: Any, fn) -> Any:
    from ..query.sql import map_expr
    return map_expr(e, lambda n: fn(n) if isinstance(n, Identifier) else n)


def _refs(e: Any) -> Set[str]:
    out: Set[str] = set()
    _map_identifiers(e, lambda i: (out.add(i.name), i)[1])
    return out


def _conjuncts(e: Any) -> List[Any]:
    if e is None:
        return []
    if isinstance(e, BoolAnd):
        out: List[Any] = []
        for c in e.children:
            out.extend(_conjuncts(c))
        return out
    return [e]


def _and(parts: List[Any]) -> Optional[Any]:
    if not parts:
        return None
    if len(parts) == 1:
        return parts[0]
    return BoolAnd(tuple(parts))


# ---------------------------------------------------------------------------
# the stage planner/executor
# ---------------------------------------------------------------------------

class MultiStageExecutor:
    def __init__(self, broker, stmt: SelectStmt):
        self.broker = broker
        self.stmt = stmt
        self.tables: List[TableRef] = [TableRef(stmt.table, stmt.table_alias)]
        self.join_types: Dict[str, str] = {self.tables[0].label: "base"}
        for j in stmt.joins:
            self.tables.append(j.table)
            self.join_types[j.table.label] = j.join_type
        if len({t.label for t in self.tables}) != len(self.tables):
            raise SqlError("duplicate table alias in join")
        self.schemas: Dict[str, Any] = {
            t.label: self._table_schema(t.name) for t in self.tables}
        self.mailboxes = MailboxService()
        self.join_backends: List[str] = []  # one entry per executed join
        self.dynamic_filters: List[str] = []  # semi-join pushdowns applied
        self.plane = "mailbox"              # 'fused' once a whole-plan
        self.plane_trace: Dict[str, Any] = {}  # program served the joins

    def _table_schema(self, name: str):
        dm = self.broker.table(name)
        segs = dm.acquire_segments()
        if hasattr(dm, "schema") and dm.schema is not None:
            return dm.schema
        if not segs:
            raise SqlError(f"table {name!r} has no segments")
        return segs[0].schema

    # -- column ownership --------------------------------------------------
    def owner_of(self, ref: str) -> Tuple[str, str]:
        """'alias.col' or bare 'col' -> (table_label, column)."""
        if "." in ref:
            label, col = ref.split(".", 1)
            if label in self.schemas and self.schemas[label].has_column(col):
                return label, col
        owners = [t.label for t in self.tables
                  if self.schemas[t.label].has_column(ref)]
        if len(owners) == 1:
            return owners[0], ref
        if not owners:
            raise SqlError(f"unknown column {ref!r} across "
                           f"{[t.label for t in self.tables]}")
        raise SqlError(f"ambiguous column {ref!r}: in {owners}")

    # -- planning ----------------------------------------------------------
    def _collect_needed(self) -> Dict[str, Set[str]]:
        needed: Dict[str, Set[str]] = {t.label: set() for t in self.tables}
        exprs: List[Any] = [i.expr for i in self.stmt.select]
        exprs += self.stmt.group_by
        exprs += [o.expr for o in self.stmt.order_by]
        if self.stmt.where is not None:
            exprs.append(self.stmt.where)
        if self.stmt.having is not None:
            exprs.append(self.stmt.having)
        for j in self.stmt.joins:
            exprs.append(j.on)
        star = any(isinstance(i.expr, Star) for i in self.stmt.select)
        if star:
            for t in self.tables:
                needed[t.label].update(self.schemas[t.label].column_names)
        aliases = {i.alias for i in self.stmt.select if i.alias}
        for e in exprs:
            for r in _refs(e):
                try:
                    label, col = self.owner_of(r)
                except SqlError:
                    if r in aliases:  # ORDER BY / HAVING select-alias ref
                        continue
                    raise
                needed[label].add(col)
        for t in self.tables:
            if not needed[t.label]:
                # a relation with zero columns has zero rows — COUNT(*)
                # over a CROSS JOIN still needs each side's row count, so
                # carry one (arbitrary) column per unreferenced table
                cols = self.schemas[t.label].column_names
                if cols:
                    needed[t.label].add(cols[0])
        return needed

    def _null_extended_labels(self) -> Set[str]:
        """Tables whose rows can be null-extended by some outer join: a
        LEFT join null-extends its right table, a RIGHT join the whole
        accumulated left side, FULL both. (Outer joins are reorder
        barriers, so textual order is execution order here.)"""
        out: Set[str] = set()
        seen = {self.tables[0].label}
        for j in self.stmt.joins:
            if j.join_type in ("left", "full"):
                out.add(j.table.label)
            if j.join_type in ("right", "full"):
                out |= seen
            seen.add(j.table.label)
        return out

    def _pushable(self, label: str) -> bool:
        # a WHERE conjunct pushes into a leaf scan only when that table's
        # rows are never null-extended downstream — pushing below the
        # null-extending side would resurrect rows the post-join filter
        # must drop (LEFT's right side) or drop preserved rows. Preserved
        # sides (base/inner with no RIGHT/FULL above them, the right side
        # of a RIGHT join) stay pushable.
        if label in self._null_extended_labels():
            return False
        return self.join_types[label] in ("base", "inner", "right")

    def _split_where(self) -> Tuple[Dict[str, List[Any]], List[Any]]:
        pushed: Dict[str, List[Any]] = {t.label: [] for t in self.tables}
        post: List[Any] = []
        for conj in _conjuncts(self.stmt.where):
            owners = {self.owner_of(r)[0] for r in _refs(conj)}
            if len(owners) == 1:
                label = owners.pop()
                if self._pushable(label):
                    pushed[label].append(conj)
                    continue
            post.append(conj)
        return pushed, post

    # -- leaf stage (LeafStageTransferableBlockOperator analog) ------------
    def leaf_scan(self, tref: TableRef, cols: Sequence[str],
                  pred: Optional[Any]) -> Relation:
        label = tref.label
        # strip qualifiers so the single-table evaluators see bare names
        bare = _map_identifiers(pred, lambda i: Identifier(
            self.owner_of(i.name)[1])) if pred is not None else None
        dm = self.broker.table(tref.name)
        blocks: List[Relation] = []
        cols = sorted(cols)
        na = host_eval.null_aware(self.stmt)
        for seg in dm.acquire_segments():
            if na:
                mask, _ = host_eval.eval_filter_3vl(bare, seg)
            else:
                mask = host_eval.eval_filter(bare, seg)
            idx = np.nonzero(mask)[0]
            data: Dict[str, np.ndarray] = {}
            nulls: Dict[str, np.ndarray] = {}
            for c in cols:
                data[f"{label}.{c}"] = np.asarray(seg.raw_values(c))[idx]
                nm = seg.null_mask(c)
                if nm is not None:
                    nulls[f"{label}.{c}"] = nm[idx]
            blocks.append(Relation(data, nulls, label))
        if not blocks:
            return Relation({f"{label}.{c}": np.empty(0, dtype=object)
                             for c in cols}, name=label)
        return Relation.concat(blocks)

    # -- cost-based planning (Calcite CBO analog; multistage/costs.py) -----
    def plan_join_order(self, pushed: Dict[str, List[Any]]
                        ) -> Tuple[List[Any], List[Dict]]:
        """Reorder consecutive INNER joins greedily by estimated
        intermediate cardinality; LEFT joins are barriers. Returns the
        execution order plus the estimate trace."""
        from .costs import TableStats, order_inner_joins, scan_cardinality
        stats = {t.label: TableStats.from_segments(
            self.broker.table(t.name).acquire_segments())
            for t in self.tables}
        table_rows = {lbl: scan_cardinality(stats[lbl],
                                            _and(pushed.get(lbl, [])))
                      for lbl in stats}
        self._table_row_est = table_rows

        def equi_ok(j, joined: Set[str]) -> bool:
            labels = set()
            for r in _refs(j.on):
                try:
                    labels.add(self.owner_of(r)[0])
                except SqlError:
                    return False
            if not labels <= (joined | {j.table.label}):
                return False
            equi, _ = self._split_on(j.on, joined, j.table.label)
            return bool(equi)

        def key_ndv(j, joined: Set[str]):
            equi, _ = self._split_on(j.on, joined, j.table.label)
            if len(equi) != 1:
                return None, None
            (lref, rref) = equi[0]
            ll, lc = lref.split(".", 1)
            rl, rc = rref.split(".", 1)
            return stats[ll].ndv(lc), stats[rl].ndv(rc)

        return order_inner_joins(self.stmt.joins, self.tables[0].label,
                                 table_rows, key_ndv, equi_ok)

    # -- fused-vs-mailbox plane (whole-plan mesh compilation) --------------
    def _choose_plane(self, needed: Dict[str, Set[str]],
                      pushed: Dict[str, List[Any]]) -> Tuple[str, Dict]:
        """costs.choose_multistage_plane over the scan estimate, with
        the OPTION(multistageFused=true/false) override."""
        from .costs import (TableStats, _fused_min_rows,
                            choose_multistage_plane, scan_cardinality)
        opt = self.stmt.options.get("multistageFused")
        force = None
        if opt is not None:
            force = "fused" if str(opt).strip().lower() in (
                "1", "true", "yes") else "mailbox"
        base = self.tables[0]
        stats = TableStats.from_segments(
            self.broker.table(base.name).acquire_segments())
        est = scan_cardinality(stats, _and(pushed.get(base.label, [])))
        width = sum(len(cols) for cols in needed.values())
        if force is None and est < _fused_min_rows():
            # the common small query routes mailbox without asking for a
            # device count it won't use
            return choose_multistage_plane(0, est, width, None, None)
        from ..parallel.mesh import default_mesh

        # the shards of the broker's mesh (jax.device_count() in the
        # reference)
        return choose_multistage_plane(default_mesh(self.broker.device).size,
                                       est, width, None, force)

    # -- joins -------------------------------------------------------------
    def _split_on(self, on: Any, left_labels: Set[str], right_label: str
                  ) -> Tuple[List[Tuple[str, str]], List[Any]]:
        """ON conjuncts -> (equi key pairs [(left_ref, right_ref)], rest)."""
        equi: List[Tuple[str, str]] = []
        rest: List[Any] = []
        for conj in _conjuncts(on):
            if isinstance(conj, Comparison) and conj.op == "==" and \
                    isinstance(conj.lhs, Identifier) and \
                    isinstance(conj.rhs, Identifier):
                lo, lc = self.owner_of(conj.lhs.name)
                ro, rc = self.owner_of(conj.rhs.name)
                if lo in left_labels and ro == right_label:
                    equi.append((f"{lo}.{lc}", f"{ro}.{rc}"))
                    continue
                if ro in left_labels and lo == right_label:
                    equi.append((f"{ro}.{rc}", f"{lo}.{lc}"))
                    continue
            rest.append(conj)
        return equi, rest

    # dynamic filter (the reference's pipeline-breaker / dynamic
    # broadcast: runtime/plan/pipeline/, PinotJoinToDynamicBroadcastRule
    # analog): when the already-materialized side of a join is small,
    # its distinct join keys push a semi-join IN filter into the other
    # leaf's SCAN, so the probe side never materializes rows that
    # cannot match. Safe for INNER and LEFT joins (the filtered side is
    # not preserved there); RIGHT/FULL preserve the scanned side.
    DYNAMIC_FILTER_MAX_BUILD = 50_000
    DYNAMIC_FILTER_MAX_KEYS = 10_000

    def _dynamic_filter(self, j, equi, current: Relation):
        if j.join_type not in ("inner", "left") or len(equi) != 1:
            return None
        if not 0 < current.n_rows <= self.DYNAMIC_FILTER_MAX_BUILD:
            return None
        lref, rref = equi[0]
        vals = [v for v in dict.fromkeys(current.raw_values(lref).tolist())
                if v is not None and v == v]    # drop null keys (no match)
        if not 0 < len(vals) <= self.DYNAMIC_FILTER_MAX_KEYS:
            return None
        self.dynamic_filters.append(f"{rref} IN <{len(vals)} keys>")
        return InList(Identifier(rref),
                      tuple(Literal(v) for v in vals), False)

    def _join(self, left: Relation, right: Relation,
              lkeys: List[str], rkeys: List[str], how: str,
              query_id: str, stage: int) -> Relation:
        if how == "inner" and left.n_rows < right.n_rows:
            # cost-based build-side choice: hash_join builds its table on
            # the second relation, so put the SMALLER side there (Calcite
            # swaps join inputs the same way; outer joins pin their sides)
            left, right = right, left
            lkeys, rkeys = rkeys, lkeys
        if right.n_rows <= BROADCAST_THRESHOLD or how != "inner":
            # broadcast join (small build side / preserved-row semantics):
            # device sort+searchsorted probe when the shape fits the
            # dense formulation, numpy otherwise (device_join.py)
            rel, backend = try_device_join(left, right, lkeys, rkeys,
                                           how, BROADCAST_THRESHOLD,
                                           self.broker.device)
            if rel is None:
                device_join.bump("numpy_joins")
                self.join_backends.append(f"numpy({backend})")
                return hash_join(left, right, lkeys, rkeys, how)
            self.join_backends.append(backend)
            return rel
        # big build side: the device hash-shuffle across the mesh's
        # shards runs first (None on one shard); the mailbox HashExchange
        # is the host fallback
        rel = device_join.try_mesh_shuffle_join(left, right, lkeys, rkeys,
                                                self.broker.device)
        if rel is not None:
            self.join_backends.append("mesh_shuffle")
            return rel
        device_join.bump("numpy_joins")
        self.join_backends.append("numpy_shuffle")
        # the mailbox exchange is span-visible: a sampled or analyzed
        # multistage query attributes its shuffle time
        with span(ph.EXCHANGE, partitions=SHUFFLE_PARTITIONS,
                  rows=left.n_rows + right.n_rows):
            lex = HashExchange(self.mailboxes, query_id, stage,
                               SHUFFLE_PARTITIONS, lkeys)
            rex = HashExchange(self.mailboxes, query_id, stage + 1000,
                               SHUFFLE_PARTITIONS, rkeys)
            lex.send(left)
            lex.close()
            rex.send(right)
            rex.close()
        parts: List[Relation] = []
        for w in range(SHUFFLE_PARTITIONS):
            lparts = self.mailboxes.mailbox(query_id, stage, w).drain()
            rparts = self.mailboxes.mailbox(query_id, stage + 1000, w).drain()
            if not lparts or not rparts:
                continue
            parts.append(hash_join(Relation.concat(lparts),
                                   Relation.concat(rparts),
                                   lkeys, rkeys, how))
        if not parts:
            return hash_join(left.take(np.empty(0, dtype=np.int64)),
                             right.take(np.empty(0, dtype=np.int64)),
                             lkeys, rkeys, how)
        return Relation.concat(parts)

    def _join_step(self, j, si: int, needed, pushed,
                   joined_labels: Set[str], current: Relation,
                   query_id: str) -> Relation:
        """One join of the stage loop: scan the right leaf (with any
        dynamic semi-join filter) and join it into ``current``."""
        label = j.table.label
        equi, rest = self._split_on(j.on, joined_labels, label)
        dyn = self._dynamic_filter(j, equi, current)
        with span(ph.LEAF_SCAN, table=label) as sp:
            right = self.leaf_scan(
                j.table, needed[label],
                _and(pushed[label] + ([dyn] if dyn is not None else [])))
            if sp is not None:
                sp.annotate(rows=right.n_rows,
                            dynamic_filter=dyn is not None or None)
        if j.join_type == "cross" or not equi:
            if j.join_type != "cross":
                raise SqlError(
                    f"join with {label!r} has no equi condition; "
                    "use CROSS JOIN for a cartesian product")
            # parser guarantees CROSS has no ON, so rest is empty
            self.join_backends.append("numpy(cross)")
            device_join.bump("numpy_joins")
            return cross_join(current, right)
        lkeys = [p[0] for p in equi]
        rkeys = [p[1] for p in equi]
        if j.join_type in ("left", "right", "full") and rest:
            # OUTER JOIN with non-equi ON conjuncts: pairs failing
            # the conjunct are NON-matches — preserved-side rows
            # null-extend, never drop (HashJoinOperator join-clause
            # semantics; a post-join filter would wrongly drop them)
            device_join.bump("numpy_joins")
            self.join_backends.append(f"numpy(non_equi_{j.join_type})")
            inner, l_idx, r_idx, _m = hash_join(
                current, right, lkeys, rkeys, "inner",
                return_idx=True)
            m = np.ones(inner.n_rows, dtype=bool)
            for conj in rest:
                m &= host_eval.eval_filter(conj, inner)
            keep = np.nonzero(m)[0]
            parts = [inner.take(keep)]
            if j.join_type in ("left", "full"):
                un_l = np.setdiff1d(np.arange(current.n_rows),
                                    np.unique(l_idx[keep]))
                parts.append(null_extend(current.take(un_l), right))
            if j.join_type in ("right", "full"):
                un_r = np.setdiff1d(np.arange(right.n_rows),
                                    np.unique(r_idx[keep]))
                parts.append(null_extend(right.take(un_r), current))
            return Relation.concat(parts)
        current = self._join(current, right, lkeys, rkeys,
                             j.join_type, query_id, si + 2)
        for conj in rest:
            m = host_eval.eval_filter(conj, current)
            current = current.take(np.nonzero(m)[0])
        return current

    # -- top level ---------------------------------------------------------
    def execute(self) -> ResultTable:
        t0 = time.perf_counter()
        stmt = self.stmt
        query_id = f"q{id(stmt):x}{int(t0 * 1e6) & 0xffffff:x}"
        needed = self._collect_needed()
        pushed, post_where = self._split_where()

        base = self.tables[0]
        # stats collection only pays off when an order choice exists
        ordered_joins = stmt.joins if len(stmt.joins) < 2 \
            else self.plan_join_order(pushed)[0]

        # whole-plan compilation: when the cost plane picks it, the
        # entire join pipeline runs as ONE device program
        # (multistage/fused.py) and the mailbox never opens; any
        # ineligibility returns None and the classic per-join path below
        # serves the query — results byte-identical
        current: Optional[Relation] = None
        if ordered_joins:
            plane, self.plane_trace = self._choose_plane(needed, pushed)
            if plane == "fused":
                from .fused import execute_fused
                current = execute_fused(self, ordered_joins, needed,
                                        pushed, BROADCAST_THRESHOLD)
                if current is not None:
                    self.plane = "fused"
                    self.join_backends = ["fused"] * len(ordered_joins)

        if current is None:
            # leaf, join, window and final stages are span-visible, as the
            # single-stage engine's phases are
            with span(ph.LEAF_SCAN, table=base.label) as sp:
                current = self.leaf_scan(base, needed[base.label],
                                         _and(pushed[base.label]))
                if sp is not None:
                    sp.annotate(rows=current.n_rows)
            joined_labels = {base.label}
            for si, j in enumerate(ordered_joins):
                label = j.table.label
                with span(ph.JOIN_STAGE, table=label,
                          how=j.join_type) as jsp:
                    current = self._join_step(j, si, needed, pushed,
                                              joined_labels, current,
                                              query_id)
                    if jsp is not None:
                        jsp.annotate(rows=current.n_rows,
                                     backend=(self.join_backends[-1]
                                              if self.join_backends
                                              else None))
                joined_labels.add(label)

        for conj in post_where:
            if host_eval.null_aware(stmt):
                m, _ = host_eval.eval_filter_3vl(conj, current)
            else:
                m = host_eval.eval_filter(conj, current)
            current = current.take(np.nonzero(m)[0])

        self.mailboxes.release(query_id)

        # window stage (WindowAggregateOperator analog): compute each
        # window call as a column, then the final stage sees plain refs
        from .window import compute_window, find_windows, rewrite_windows
        wfs = find_windows(stmt)
        if wfs:
            if stmt.group_by:
                raise SqlError("window functions cannot be combined with "
                               "GROUP BY in one stage yet")
            with span(ph.WINDOW_STAGE, funcs=len(wfs),
                      rows=current.n_rows):
                names = {wf: f"__w{i}" for i, wf in enumerate(wfs)}
                current = current.with_columns(
                    {names[wf]: compute_window(current, wf,
                                               self.broker.device)
                     for wf in wfs})
                stmt = rewrite_windows(stmt, names)

        # final stage: aggregation / selection over the joined relation
        ctx = build_query_context(stmt)
        with span(ph.FINAL_STAGE, rows=current.n_rows):
            mask = np.ones(current.n_rows, dtype=bool)
            if ctx.is_group_by:
                partial: Any = GroupByPartial(
                    host_eval.host_group_by(ctx, current, mask))
            elif ctx.is_aggregation:
                partial = AggPartial(
                    host_eval.host_aggregate(ctx, current, mask))
            else:
                labels, rows, okeys = host_eval.host_selection(
                    ctx, current, mask)
                partial = SelectionPartial(labels, rows, okeys)
            result = reduce_partials(ctx, [partial])
        result.num_docs_scanned = current.n_rows
        result.time_ms = (time.perf_counter() - t0) * 1e3
        return result


def execute_multistage(broker, stmt: SelectStmt) -> ResultTable:
    return MultiStageExecutor(broker, stmt).execute()


def explain_multistage(broker, stmt: SelectStmt) -> ResultTable:
    """EXPLAIN for join queries: describe the stage topology without
    executing any scan (QueryEnvironment.explainQuery analog)."""
    ex = MultiStageExecutor(broker, stmt)
    needed = ex._collect_needed()
    pushed, post = ex._split_where()
    rows: List[tuple] = []
    rid = 0

    def emit(op: str, parent: int) -> int:
        nonlocal rid
        rows.append((op, rid, parent))
        rid += 1
        return rid - 1

    from .window import find_windows, rewrite_windows
    wfs = find_windows(stmt)
    if wfs:
        stmt = rewrite_windows(stmt, {w: f"__w{i}"
                                      for i, w in enumerate(wfs)})
    ctx = build_query_context(stmt)
    root = emit("BROKER_REDUCE", -1)
    if wfs:
        root = emit(f"WINDOW(funcs:{len(wfs)})", root)
    if ctx.is_group_by:
        final = emit(f"AGGREGATE_GROUP_BY(keys:{len(ctx.group_by)},"
                     f"aggs:{len(ctx.aggregations)})", root)
    elif ctx.is_aggregation:
        final = emit(f"AGGREGATE(aggs:{len(ctx.aggregations)})", root)
    else:
        final = emit("SELECT", root)
    if post:
        final = emit(f"FILTER(post_join_conjuncts:{len(post)})", final)
    parent = final
    ordered, trace = ex.plan_join_order(pushed)
    base_est = ex._table_row_est[ex.tables[0].label]
    if stmt.joins:
        # plane prediction mirrors _choose_plane minus the device count
        # (EXPLAIN never initializes a backend — predict_backend rule)
        from .costs import choose_multistage_plane
        opt = stmt.options.get("multistageFused")
        force = None if opt is None else (
            "fused" if str(opt).strip().lower() in ("1", "true", "yes")
            else "mailbox")
        width = sum(len(cols) for cols in needed.values())
        plane, _ = choose_multistage_plane(0, base_est, width, None,
                                           force)
        if plane == "fused":
            parent = emit(f"FUSED_MESH_PLAN(stages:{len(ordered)},"
                          f"est_rows:{round(base_est)})", parent)
    # probe-side estimate entering join i = output estimate of join i-1
    probe_ests = [base_est] + [s["estRows"] for s in trace[:-1]]
    for j, step, probe_est in zip(reversed(ordered), reversed(trace),
                                  reversed(probe_ests)):
        label = j.table.label
        equi, rest = ex._split_on(
            j.on, {t.label for t in ex.tables if t.label != label}, label)
        dyn = False
        if j.join_type == "cross":
            parent = emit(f"CROSS_JOIN(est_rows:{step['estRows']})",
                          parent)
        else:
            backend = device_join.predict_backend(
                probe_est, step["rightRows"], j.join_type,
                BROADCAST_THRESHOLD)
            # dynamic semi-join filter prediction (the runtime decides
            # on ACTUAL materialized rows; the estimate mirrors
            # _dynamic_filter's gates so EXPLAIN shows the plan intent)
            dyn = (j.join_type in ("inner", "left") and len(equi) == 1
                   and 0 < probe_est
                   <= MultiStageExecutor.DYNAMIC_FILTER_MAX_BUILD)
            parent = emit(
                f"HASH_JOIN({j.join_type.upper()},keys:{len(equi)},"
                f"non_equi:{len(rest)},est_rows:{step['estRows']},"
                f"backend:{backend})", parent)
        emit(f"LEAF_SCAN({label},cols:{len(needed[label])},"
             f"pushed_filters:{len(pushed[label])},"
             + (f"dynamic_filter:{equi[0][1]}," if j.join_type != "cross"
                and dyn else "")
             + f"est_rows:{round(ex._table_row_est[label])})", parent)
    base = ex.tables[0].label
    emit(f"LEAF_SCAN({base},cols:{len(needed[base])},"
         f"pushed_filters:{len(pushed[base])},"
         f"est_rows:{round(ex._table_row_est[base])})", parent)
    return ResultTable(["Operator", "Operator_Id", "Parent_Id"], rows)
