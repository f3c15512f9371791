"""Whole-program concurrency verifier: CC201–CC205 over the port's
threaded planes.

The port is deeply threaded — the micro-batcher's leader/follower
fusion, the broker node's scatter-gather pools with hedging, the
realtime ``_consume_loop`` threads and seal/commit, the controller's
reconcile loop, the forensics rollup, the device tier and the kernels'
lazy builds under locks. This pass makes thread-safety a tier-1 gate:
AST-based, stable rule ids, a ratchet baseline at
``pinot_tpu_torch/analysis/concur_baseline.json``, and whole-program:
guard maps, call graphs and the lock-order graph are built across
every module of ``pinot_tpu_torch/`` before any rule fires.

Rules:

- **CC201 mixed-guard** — per class, infer each attribute's guard from
  the locks held at its mutation sites (``with self._lock:`` blocks,
  ``# holds-lock:`` methods). An attribute mutated BOTH under its
  inferred guard and outside it races: the unguarded sites are flagged.
  ``__init__`` is exempt (construction precedes sharing).
- **CC202 blocking-under-lock** — no HTTP call (``http_json`` /
  ``http_raw`` / ``urlopen`` / ``requests.*``), ``time.sleep``,
  ``Future.result``, zero-arg ``.join()``, subprocess, ``os.fsync`` /
  ``os.replace``, or device sync while a lock is held — directly or
  transitively through calls the resolver can follow. The device syncs
  are torch's: ``torch.cuda.synchronize()`` and ``Event`` /
  ``Stream.synchronize()`` and ``.cpu()`` anywhere (only tensors,
  events and streams have them), and ``.item()`` / ``.tolist()`` /
  ``.numpy()`` / ``np.asarray`` in the device hot packages (numpy
  shares those names, and over host data under a registry lock they
  are routine). A flaky controller RPC under a table-wide seal lock
  stalls every partition: this is the permanent rule against it.
- **CC203 lock-order-cycle** — the inter-class lock acquisition graph
  (nested ``with``-lock scopes plus calls made under a held lock,
  resolved through same-class methods, same-module functions,
  module-level singletons like ``global_metrics``, and corpus-unique
  method names) must be acyclic. A cycle is a potential deadlock; a
  self-edge on a non-reentrant ``Lock`` reached through an exact
  (same-class) call chain is a guaranteed one.
- **CC204 thread-local-escape** — the thread-local span tracer
  (``utils.spans``: ``span``, ``annotate``, ``add_event``,
  ``tracing_active``, ``device_fence``, ``span_tracer.*``), the
  ``Tracing`` request scope (``utils.trace``) and the accountant's
  thread→query attribution (``engine.accounting``:
  ``current_query_id``) may not be captured into closures handed to
  executors/threads (``pool.submit``, ``threading.Thread(target=...)``,
  ``.map``): on the foreign thread they silently no-op or attribute to
  the wrong query. The explicit handoff APIs —
  ``span_tracer.start()/stop()``, ``Tracing.register()``,
  ``accountant.attach_thread()`` / explicit ``Span(...)`` construction
  — are exempt: a closure that performs its own handoff first owns its
  context.
- **CC205 check-then-act** — ``if key not in d: d[key] = ...`` (and
  membership / ``.get()`` / ``is None`` / truthiness checks whose body
  mutates the same attribute) on an attribute whose inferred guard is
  not held at the site. ``dict.setdefault`` is GIL-atomic and not
  flagged.

Annotations (trailing comments):

- ``# guarded-by: <lock>`` on a ``self.X = ...`` line pins X's guard
  explicitly (inference escape hatch — e.g. an attribute only ever
  mutated via exec'd plumbing the AST can't see). ``# guarded-by:
  none`` exempts the attribute from CC201/CC205 (single-thread or
  GIL-atomic by design).
- ``# holds-lock: <lock>`` on a ``def`` line declares a
  caller-holds-lock method: its body is analyzed as if ``self.<lock>``
  were held (utils/heat.SegmentHeat._entry is the canonical site). On
  a module-level function it names a module-level lock
  (native._build runs only under native._lock).

Suppression: append ``# concur: ok <rule>`` (comma-separated rules or
``all``) to the offending line. Grandfathered-but-benign findings live
in the ratchet baseline: new findings above a ``file::scope::rule``
count fail ``pinot_tpu_torch.tools.check_static``, and counts that
DROP fail too until the baseline is ratcheted down with
``--update-baseline``.

Known approximations (documented, deliberate): the resolver never
follows inheritance or duck-typed callables (``job.fn()``); ``with
other._lock:`` over a non-``self`` receiver is ignored; two INSTANCES
of one class count as one lock node (a self-edge between instances
reads as a self-deadlock — annotate or suppress); same-named classes
in different modules are kept distinct (guard maps, lock nodes and
self-call resolution are all module-qualified) but the corpus-unique
METHOD-name fallback for attribute calls is global — an ambiguous name
is simply not resolved; ``.wait()`` is never a CC202 blocker because
``Condition.wait`` under its own lock is the correct idiom and the AST
cannot tell conditions from events.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .astutil import (PACKAGE, CallResolver, Finding, compare_baseline,
                      counts_of, iter_py_files, line_comments,
                      load_baseline, module_qual, suppress_regex)
from .astutil import call_parts as _call_parts
from .astutil import self_attr as _self_attr

__all__ = [
    "CONCUR_RULES", "Program", "analyze_tree", "analyze_source",
    "compare_baseline", "counts_of", "load_baseline", "write_baseline",
]

CONCUR_RULES = {
    "CC201": "mixed-guard: attribute mutated both under and outside "
             "its inferred lock",
    "CC202": "blocking call while holding a lock",
    "CC203": "lock-order cycle (potential deadlock)",
    "CC204": "thread-local state captured into a cross-thread closure",
    "CC205": "check-then-act on a guarded attribute without its lock",
    # never baselined (write_baseline drops it): a module that stops
    # parsing must fail the gate no matter what was grandfathered
    "parse-error": "module failed to parse",
}

_SUPPRESS_RE = suppress_regex("concur")
_GUARDED_RE = re.compile(r"guarded-by:\s*([\w]+)")
_HOLDS_RE = re.compile(r"holds-lock:\s*([\w,\s]+)")

# -- CC202 matchers ---------------------------------------------------------
_BLOCK_DOTTED = {
    ("time", "sleep"): "time.sleep",
    ("os", "system"): "os.system",
    ("os", "popen"): "os.popen",
    ("os", "fsync"): "os.fsync",
    ("os", "replace"): "os.replace",
    ("subprocess", "run"): "subprocess.run",
    ("subprocess", "call"): "subprocess.call",
    ("subprocess", "check_call"): "subprocess.check_call",
    ("subprocess", "check_output"): "subprocess.check_output",
    ("subprocess", "Popen"): "subprocess.Popen",
    ("socket", "create_connection"): "socket.create_connection",
    ("requests", "get"): "requests.get",
    ("requests", "post"): "requests.post",
    ("requests", "put"): "requests.put",
    ("requests", "delete"): "requests.delete",
    ("requests", "request"): "requests.request",
}
# bare or attribute-tail call names that block wherever they resolve
_BLOCK_NAMES = {
    "http_json": "http_json (HTTP RPC)",
    "http_raw": "http_raw (HTTP RPC)",
    "urlopen": "urlopen (HTTP)",
    "fsync": "os.fsync",
}
_NUMPY_NAMES = ("np", "numpy", "_np")
# torch device syncs that block wherever they run: only tensors have
# .cpu(), only CUDA events and streams (and torch.cuda) .synchronize()
_SYNC_ANYWHERE = {"cpu": ".cpu() device-to-host copy",
                  "synchronize": ".synchronize() device sync"}
# syncs numpy shares the names of: CC202 blockers only in the device hot
# packages (np.asarray over host data under a registry lock is routine)
_SYNC_HOT = {"item": ".item() device sync",
             "tolist": ".tolist() device-to-host copy",
             "numpy": ".numpy() device-to-host copy"}
_HOT_PACKAGES = ("ops", "engine", "multistage")

_MUTATING_METHODS = {"append", "extend", "add", "update", "setdefault",
                     "pop", "popitem", "clear", "remove", "discard",
                     "insert", "move_to_end"}

# -- CC204 vocabulary -------------------------------------------------------
# module-level conveniences of utils.spans — thread-local reads
_TL_BARE_CALLS = {"span", "annotate", "add_event", "tracing_active",
                  "device_fence"}
# receiver -> (thread-local methods are everything EXCEPT the handoffs)
_TL_RECEIVERS = {
    "span_tracer": {"start", "stop"},       # handoff: root your own tree
    "Tracing": {"register", "unregister"},  # handoff: own request scope
}
_TL_ATTR_CALLS = {"current_query_id"}       # accountant thread->query read
_HANDOFF_CALLS = {"start", "register", "attach_thread"}


# ---------------------------------------------------------------------------
# per-module model
# ---------------------------------------------------------------------------

@dataclass
class _ClassInfo:
    name: str
    module: "_ModuleInfo"
    node: ast.ClassDef
    # lock attribute -> kind ("Lock" | "RLock"); Condition aliases are
    # resolved into this map (the condition attr maps to its lock's id)
    locks: Dict[str, str] = field(default_factory=dict)
    aliases: Dict[str, str] = field(default_factory=dict)  # cond -> lock
    guard_ann: Dict[str, Optional[str]] = field(default_factory=dict)
    methods: Dict[str, ast.AST] = field(default_factory=dict)
    odict_attrs: Set[str] = field(default_factory=set)

    def lock_id(self, attr: str) -> Optional[str]:
        attr = self.aliases.get(attr, attr)
        if attr in self.locks:
            return f"{self.module.qual}.{self.name}.{attr}"
        return None


@dataclass
class _ModuleInfo:
    path: str                      # repo-relative, posix
    tree: ast.AST
    lines: List[str]
    suppress: Dict[int, Set[str]]
    classes: Dict[str, _ClassInfo] = field(default_factory=dict)
    mod_locks: Dict[str, str] = field(default_factory=dict)  # name->kind
    functions: Dict[str, ast.AST] = field(default_factory=dict)
    singletons: Dict[str, str] = field(default_factory=dict)  # name->cls
    # module-level mutable containers (dict/list/set/OrderedDict/...):
    # shared state for the CC201/CC205 module-global guard machinery
    mut_globals: Set[str] = field(default_factory=set)
    odict_globals: Set[str] = field(default_factory=set)

    @property
    def stem(self) -> str:
        return os.path.splitext(os.path.basename(self.path))[0]

    @property
    def qual(self) -> str:
        """Collision-free module qualifier ("engine.batch",
        "native.__init__"): bare stems repeat across packages
        (batch.py, __init__.py), and two same-named locks must not
        merge into one graph node."""
        return module_qual(self.path)

    def mod_lock_id(self, name: str) -> Optional[str]:
        if name in self.mod_locks:
            return f"{self.qual}.{name}"
        return None


@dataclass
class _FnInfo:
    """One analyzed function/method: its concurrency events."""
    fid: str                       # path::qualname
    qualname: str
    path: str
    module: _ModuleInfo
    cls: Optional[_ClassInfo]
    node: ast.AST
    holds: FrozenSet[str] = frozenset()
    # events: (data..., line, held-lockids)
    mutations: List[Tuple[str, int, FrozenSet[str], bool]] = \
        field(default_factory=list)
    # locked reads only (an unlocked dirty read is routine; a read
    # under a DIFFERENT lock than the mutation guard is the CC201
    # mixed-guard hazard). All event tuples end with ``nested``: the
    # event sits inside a nested def/lambda, which runs later on
    # whatever thread calls it — caller-holds inference never applies.
    reads: List[Tuple[str, int, FrozenSet[str], bool]] = \
        field(default_factory=list)
    acquires: List[Tuple[str, int, FrozenSet[str], bool]] = \
        field(default_factory=list)
    calls: List[Tuple[str, Optional[str], str, int, FrozenSet[str],
                      bool]] = \
        field(default_factory=list)   # (kind, base, name, line, held)
    blocks: List[Tuple[str, int, FrozenSet[str], bool]] = \
        field(default_factory=list)
    cta: List[Tuple[str, int, FrozenSet[str], bool]] = \
        field(default_factory=list)
    # same events over module-level globals ("<stem>:NAME" ids)
    g_mutations: List[Tuple[str, int, FrozenSet[str], bool]] = \
        field(default_factory=list)
    g_reads: List[Tuple[str, int, FrozenSet[str], bool]] = \
        field(default_factory=list)
    g_cta: List[Tuple[str, int, FrozenSet[str], bool]] = \
        field(default_factory=list)
    # non-GIL-atomic OrderedDict LRU ops (move_to_end/popitem):
    # (display name, is-global, line, held, nested)
    lru_ops: List[Tuple[str, bool, int, FrozenSet[str], bool]] = \
        field(default_factory=list)
    escapes: List[Tuple[int, str]] = field(default_factory=list)
    # summaries (filled by fixpoint)
    locks_any: Set[str] = field(default_factory=set)
    blocking_reason: Optional[str] = None
    # locks SOMETIMES held when this function runs (union over call
    # sites): guard *evidence* — a mutation inside a helper that one
    # caller locks is lock-guarded state, even when another caller
    # (the defect) doesn't lock
    holds_union: FrozenSet[str] = frozenset()


def _is_lock_ctor(value: ast.AST) -> Optional[str]:
    """'Lock' | 'RLock' | 'Condition' when value constructs one."""
    if isinstance(value, ast.Call):
        _b, a = _call_parts(value.func)
        if a in ("Lock", "RLock", "Condition"):
            return a
    return None


_CONTAINER_CTORS = {"dict", "list", "set", "OrderedDict",
                    "defaultdict", "deque", "Counter"}


def _container_ctor(value: ast.AST) -> Optional[str]:
    """Ctor name when ``value`` builds a mutable container (literal or
    dict()/OrderedDict()/... call), else None."""
    if isinstance(value, (ast.Dict, ast.List, ast.Set)):
        return "dict" if isinstance(value, ast.Dict) else "list"
    if isinstance(value, ast.Call):
        _b, name = _call_parts(value.func)
        if name in _CONTAINER_CTORS:
            return name
    return None


_line_comments = line_comments


# ---------------------------------------------------------------------------
# the event walker
# ---------------------------------------------------------------------------

class _FnWalker:
    """Walks one function body tracking the set of held locks, emitting
    mutation / acquire / call / blocking / check-then-act events and the
    CC204 closure-escape findings."""

    def __init__(self, prog: "Program", info: _FnInfo):
        self.prog = prog
        self.info = info
        self.mod = info.module
        self.cls = info.cls
        self.hot = info.path.startswith(
            tuple(f"{PACKAGE}/{p}/" for p in _HOT_PACKAGES))
        # nested defs/lambdas by name (for CC204 submit-target lookup)
        self.nested: Dict[str, ast.AST] = {}

    # -- lock recognition --------------------------------------------------
    def _with_lock_id(self, ctx: ast.AST) -> Optional[str]:
        a = _self_attr(ctx)
        if a is None and isinstance(ctx, ast.Call):
            a = _self_attr(ctx.func)          # with self._lock() style
        if a is not None and self.cls is not None:
            return self.cls.lock_id(a)
        if isinstance(ctx, ast.Name):
            return self.mod.mod_lock_id(ctx.id)
        return None

    # -- walk --------------------------------------------------------------
    def walk(self) -> None:
        body = getattr(self.info.node, "body", [])
        for stmt in body:
            self._scan(stmt, self.info.holds, nested=False)
        self._scan_escapes(self.info.node)

    def _scan(self, node: ast.AST, held: FrozenSet[str],
              nested: bool) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            # items acquire LEFT TO RIGHT: `with a, b:` holds a while
            # acquiring b, exactly like the nested spelling — the held
            # set accumulates per item so the a->b lock-order edge (and
            # blocking in later context expressions) is recorded
            inner = held
            for item in node.items:
                self._scan(item.context_expr, inner, nested)
                lid = self._with_lock_id(item.context_expr)
                if lid is not None:
                    self.info.acquires.append(
                        (lid, node.lineno, inner, nested))
                    inner = inner.union((lid,))
            for stmt in node.body:
                self._scan(stmt, inner, nested)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.nested[node.name] = node
            # a nested def runs later, on whatever thread calls it: its
            # body is analyzed lock-free (CC201 sites in it are real —
            # the closure does not inherit the enclosing critical
            # section's exclusion)
            for stmt in node.body:
                self._scan(stmt, frozenset(), True)
            return
        if isinstance(node, ast.Lambda):
            self._scan(node.body, frozenset(), True)
            return
        if isinstance(node, ast.If):
            self._check_then_act(node, held, nested)
            for child in ast.iter_child_nodes(node):
                self._scan(child, held, nested)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                self._mutation_target(t, node.lineno, held, nested)
            for child in ast.iter_child_nodes(node):
                self._scan(child, held, nested)
            return
        if isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    a = _self_attr(t.value)
                    if a is not None:
                        self.info.mutations.append(
                            (a, node.lineno, held, nested))
                    elif isinstance(t.value, ast.Name) and \
                            t.value.id in self.mod.mut_globals:
                        self.info.g_mutations.append(
                            (t.value.id, node.lineno, held, nested))
            for child in ast.iter_child_nodes(node):
                self._scan(child, held, nested)
            return
        if isinstance(node, ast.Call):
            self._call(node, held, nested)
            for child in ast.iter_child_nodes(node):
                self._scan(child, held, nested)
            return
        if isinstance(node, ast.Attribute) and \
                isinstance(node.ctx, ast.Load) and held:
            a = _self_attr(node)
            if a is not None and (self.cls is None
                                  or self.cls.lock_id(a) is None):
                self.info.reads.append((a, node.lineno, held, nested))
        if isinstance(node, ast.Name) and \
                isinstance(node.ctx, ast.Load) and held and \
                node.id in self.mod.mut_globals:
            self.info.g_reads.append(
                (node.id, node.lineno, held, nested))
        for child in ast.iter_child_nodes(node):
            self._scan(child, held, nested)

    def _mutation_target(self, t: ast.AST, line: int,
                         held: FrozenSet[str], nested: bool) -> None:
        a = _self_attr(t)
        if a is None and isinstance(t, ast.Subscript):
            a = _self_attr(t.value)
            if a is None and isinstance(t.value, ast.Name) and \
                    t.value.id in self.mod.mut_globals:
                self.info.g_mutations.append(
                    (t.value.id, line, held, nested))
        if a is None and isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._mutation_target(el, line, held, nested)
            return
        if a is not None:
            self.info.mutations.append((a, line, held, nested))

    # -- calls: mutations via methods, blocking, resolution hints ----------
    def _call(self, node: ast.Call, held: FrozenSet[str],
              nested: bool) -> None:
        func = node.func
        base, name = _call_parts(func)
        # self.attr.append(...) / GLOBAL.append(...) style mutations
        if isinstance(func, ast.Attribute) and \
                func.attr in _MUTATING_METHODS:
            a = _self_attr(func.value)
            if a is not None:
                self.info.mutations.append(
                    (a, node.lineno, held, nested))
                if func.attr in ("move_to_end", "popitem") and \
                        self.cls is not None and \
                        a in self.cls.odict_attrs:
                    self.info.lru_ops.append(
                        (f"self.{a}", False, node.lineno, held,
                         nested))
            elif isinstance(func.value, ast.Name) and \
                    func.value.id in self.mod.mut_globals:
                g = func.value.id
                self.info.g_mutations.append(
                    (g, node.lineno, held, nested))
                if func.attr in ("move_to_end", "popitem") and \
                        g in self.mod.odict_globals:
                    self.info.lru_ops.append(
                        (g, True, node.lineno, held, nested))
        # direct blocking matches
        reason = self._blocking_reason(node, base, name)
        if reason is not None:
            self.info.blocks.append((reason, node.lineno, held, nested))
        # resolution hints for the call graph
        if name is not None:
            if isinstance(func, ast.Attribute):
                if base == "self":
                    self.info.calls.append(
                        ("self", None, name, node.lineno, held, nested))
                elif base is not None:
                    self.info.calls.append(
                        ("attr", base, name, node.lineno, held, nested))
            else:
                self.info.calls.append(
                    ("bare", None, name, node.lineno, held, nested))

    def _blocking_reason(self, node: ast.Call, base: Optional[str],
                         name: Optional[str]) -> Optional[str]:
        if base is not None and (base, name) in _BLOCK_DOTTED:
            return _BLOCK_DOTTED[(base, name)]
        if name in _BLOCK_NAMES:
            return _BLOCK_NAMES[name]
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "result":
                return "Future.result() wait"
            if attr == "join" and not node.args and not node.keywords:
                return ".join() thread wait"
            if attr == "synchronize":
                return _SYNC_ANYWHERE[attr]
            if attr == "cpu" and not node.args:
                return _SYNC_ANYWHERE[attr]
            if attr in _SYNC_HOT and not node.args and self.hot:
                return _SYNC_HOT[attr]
            if attr in ("asarray", "array") and base in _NUMPY_NAMES \
                    and self.hot:
                return f"{base}.{attr}() device transfer"
        return None

    # -- CC205 -------------------------------------------------------------
    def _state_name(self, node: ast.AST) -> Optional[Tuple[str, bool]]:
        """(name, is_global) when ``node`` denotes shared state: a
        self attribute or a module-level mutable container."""
        a = _self_attr(node)
        if a is not None:
            return a, False
        if isinstance(node, ast.Name) and \
                node.id in self.mod.mut_globals:
            return node.id, True
        return None

    def _test_reads(self, test: ast.AST) -> Set[Tuple[str, bool]]:
        """Shared-state names (self attributes / module globals) the
        if-test examines in a check-then-act-prone way (membership,
        .get, is-None, truthiness)."""
        reads: Set[Tuple[str, bool]] = set()

        def note(node: ast.AST) -> None:
            s = self._state_name(node)
            if s is not None:
                reads.add(s)

        for n in ast.walk(test):
            if isinstance(n, ast.Compare):
                if any(isinstance(op, (ast.In, ast.NotIn))
                       for op in n.ops):
                    for e in n.comparators:
                        note(e)
                if any(isinstance(op, (ast.Is, ast.IsNot))
                       for op in n.ops):
                    note(n.left)
                    if isinstance(n.left, ast.Subscript):
                        note(n.left.value)
            elif isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr == "get":
                note(n.func.value)
            elif isinstance(n, ast.UnaryOp) and \
                    isinstance(n.op, ast.Not):
                note(n.operand)
        note(test)
        return reads

    def _check_then_act(self, node: ast.If, held: FrozenSet[str],
                        nested: bool) -> None:
        reads = self._test_reads(node.test)
        if not reads:
            return
        muts: Set[Tuple[str, bool]] = set()

        def note(t: ast.AST) -> None:
            s = self._state_name(t)
            if s is None and isinstance(t, ast.Subscript):
                s = self._state_name(t.value)
            if s is not None:
                muts.add(s)

        def scan(n: ast.AST) -> None:
            # prune nested defs/lambdas: their mutations run later, on
            # another thread, usually under their own locking — they
            # are not part of THIS check-then-act window (ast.walk
            # cannot prune, so recurse manually)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return
            if isinstance(n, (ast.Assign, ast.AugAssign)):
                tgts = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in tgts:
                    note(t)
            elif isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr in (_MUTATING_METHODS -
                                    {"setdefault"}):
                note(n.func.value)
            for child in ast.iter_child_nodes(n):
                scan(child)

        for stmt in node.body:
            scan(stmt)
        for name, is_glob in sorted(reads & muts):
            if is_glob:
                self.info.g_cta.append(
                    (name, node.lineno, held, nested))
            else:
                self.info.cta.append((name, node.lineno, held, nested))

    # -- CC204 -------------------------------------------------------------
    def _scan_escapes(self, fn: ast.AST) -> None:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            target = self._submit_target(node)
            if target is None:
                continue
            tl = self._thread_local_uses(target)
            if tl:
                self.info.escapes.append((node.lineno, tl[0]))

    def _submit_target(self, node: ast.Call) -> Optional[ast.AST]:
        base, name = _call_parts(node.func)
        cand: Optional[ast.AST] = None
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("submit", "map", "apply_async") \
                and node.args:
            cand = node.args[0]
        elif name == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    cand = kw.value
        if cand is None:
            return None
        if isinstance(cand, ast.Call):   # functools.partial(f, ...)
            _b, n2 = _call_parts(cand.func)
            if n2 == "partial" and cand.args:
                cand = cand.args[0]
        if isinstance(cand, ast.Lambda):
            return cand
        if isinstance(cand, ast.Name) and cand.id in self.nested:
            return self.nested[cand.id]
        return None

    def _thread_local_uses(self, target: ast.AST) -> List[str]:
        uses: List[str] = []
        handed_off = False
        for n in ast.walk(target):
            if not isinstance(n, ast.Call):
                continue
            base, name = _call_parts(n.func)
            # handoff must be the real API: span_tracer.start(),
            # Tracing.register(), or any-receiver attach_thread() — a
            # bare call to some unrelated start()/register() helper is
            # no handoff and must not silence the rule
            if (base == "span_tracer" and name == "start") or \
                    (base == "Tracing" and name == "register") or \
                    name == "attach_thread":
                handed_off = True
            if base is None and name in _TL_BARE_CALLS:
                uses.append(f"{name}()")
            elif base in _TL_RECEIVERS and \
                    name not in _TL_RECEIVERS[base]:
                uses.append(f"{base}.{name}()")
            elif name in _TL_ATTR_CALLS:
                uses.append(f"{name}()")
        return [] if handed_off else uses


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

class Program:
    """Whole-program analysis context: feed modules with
    ``add_source``/``add_tree``, then ``analyze()`` -> (findings,
    suppressed). Findings carry ``file::scope::rule`` keys for the
    ratchet baseline."""

    def __init__(self):
        self.modules: Dict[str, _ModuleInfo] = {}
        self.findings: List[Finding] = []
        self.suppressed: List[Finding] = []

    # -- loading -----------------------------------------------------------
    def add_source(self, src: str, path: str) -> None:
        path = path.replace(os.sep, "/")
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            self.findings.append(Finding(
                "parse-error", path, e.lineno or 0, "<module>",
                f"unparseable: {e.msg}"))
            return
        suppress = {
            i: {r.strip() for r in spec.split(",") if r.strip()}
            for i, spec in _line_comments(src, _SUPPRESS_RE).items()}
        mod = _ModuleInfo(path, tree, src.splitlines(), suppress)
        guarded = _line_comments(src, _GUARDED_RE)
        holds = _line_comments(src, _HOLDS_RE)
        mod._holds = holds  # type: ignore[attr-defined]
        mod._guard_ann = {}  # type: ignore[attr-defined]
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self._load_class(mod, node, guarded)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                mod.functions[node.name] = node
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                if node.value is None:
                    continue
                kind = _is_lock_ctor(node.value)
                ctor = _container_ctor(node.value)
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if not isinstance(t, ast.Name):
                        continue
                    if kind in ("Lock", "RLock"):
                        mod.mod_locks[t.id] = kind
                        continue
                    if ctor is not None:
                        mod.mut_globals.add(t.id)
                        if ctor == "OrderedDict":
                            mod.odict_globals.add(t.id)
                        ann = guarded.get(node.lineno)
                        if ann is not None:
                            mod._guard_ann[t.id] = \
                                None if ann == "none" else ann
                    if isinstance(node.value, ast.Call):
                        _b, c2 = _call_parts(node.value.func)
                        if c2 and c2[:1].isupper():
                            mod.singletons[t.id] = c2
        self.modules[path] = mod

    def _load_class(self, mod: _ModuleInfo, node: ast.ClassDef,
                    guarded: Dict[int, str]) -> None:
        ci = _ClassInfo(node.name, mod, node)
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ci.methods[stmt.name] = stmt
            elif isinstance(stmt, ast.Assign):
                kind = _is_lock_ctor(stmt.value)
                if kind in ("Lock", "RLock"):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            ci.locks[t.id] = kind
        # locks assigned in methods (the normal __init__ pattern)
        for m in ci.methods.values():
            for n in ast.walk(m):
                if not isinstance(n, (ast.Assign, ast.AnnAssign)) or \
                        n.value is None:
                    continue
                n_targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                if _container_ctor(n.value) == "OrderedDict":
                    for t in n_targets:
                        a = _self_attr(t)
                        if a is not None:
                            ci.odict_attrs.add(a)
                kind = _is_lock_ctor(n.value)
                if kind is None:
                    continue
                for t in n_targets:
                    a = _self_attr(t)
                    if a is None:
                        continue
                    if kind in ("Lock", "RLock"):
                        ci.locks[a] = kind
                    elif kind == "Condition":
                        # Condition(self._lock) aliases the lock;
                        # Condition() owns a private one
                        arg = n.value.args[0] if n.value.args else None
                        inner = _self_attr(arg) if arg is not None \
                            else None
                        if inner is not None:
                            ci.aliases[a] = inner
                        else:
                            ci.locks[a] = "Lock"
        # guarded-by annotations: pin the attr(s) assigned on that line
        for line, lock in guarded.items():
            target = self._attr_on_line(node, line)
            if target is not None:
                ci.guard_ann[target] = None if lock == "none" else lock
        mod.classes[node.name] = ci

    @staticmethod
    def _attr_on_line(cls_node: ast.ClassDef,
                      line: int) -> Optional[str]:
        for n in ast.walk(cls_node):
            if isinstance(n, (ast.Assign, ast.AugAssign)) and \
                    n.lineno == line:
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    a = _self_attr(t)
                    if a is None and isinstance(t, ast.Subscript):
                        a = _self_attr(t.value)
                    if a is not None:
                        return a
        return None

    def add_tree(self, root: str, package: str = PACKAGE) -> None:
        for full, rel in iter_py_files(root, package):
            with open(full, "r", encoding="utf-8") as fh:
                self.add_source(fh.read(), rel)

    # -- analysis ----------------------------------------------------------
    def analyze(self) -> Tuple[List[Finding], List[Finding]]:
        fns = self._walk_all()
        self._build_indexes(fns)
        self._infer_caller_holds(fns)
        self._fixpoint(fns)
        self._mod_guards: Dict[str, Dict[str, Set[str]]] = {}
        for fi in fns:
            for name, _line, held, nested in fi.g_mutations:
                evidence = held if nested else held | fi.holds_union
                if evidence:
                    self._mod_guards.setdefault(
                        fi.path, {}).setdefault(
                            name, set()).update(evidence)
        for path, mod in self.modules.items():
            for name, lock in getattr(mod, "_guard_ann", {}).items():
                d = self._mod_guards.setdefault(path, {})
                d[name] = set() if lock is None \
                    else {f"{mod.qual}.{lock}"}
        for fi in fns:
            self._rule_cc201_cc205(fi)
            self._rule_globals(fi)
            self._rule_cc202(fi)
            self._rule_cc204(fi)
        self._rule_cc203(fns)
        order = {r: i for i, r in enumerate(CONCUR_RULES)}
        self.findings.sort(
            key=lambda f: (f.path, f.line, order.get(f.rule, 99)))
        return self.findings, self.suppressed

    def _walk_all(self) -> List[_FnInfo]:
        fns: List[_FnInfo] = []
        for mod in self.modules.values():
            holds_ann = getattr(mod, "_holds", {})
            for ci in mod.classes.values():
                for name, m in ci.methods.items():
                    holds: Set[str] = set()
                    spec = holds_ann.get(m.lineno)
                    if spec:
                        for tok in spec.split(","):
                            lid = ci.lock_id(tok.strip())
                            if lid:
                                holds.add(lid)
                    fi = _FnInfo(
                        f"{mod.path}::{ci.name}.{name}",
                        f"{ci.name}.{name}", mod.path, mod, ci, m,
                        frozenset(holds))
                    _FnWalker(self, fi).walk()
                    fns.append(fi)
            for name, f in mod.functions.items():
                # a module function may declare a module-level lock its
                # every caller holds (``# holds-lock: _lock`` on the def)
                holds = set()
                spec = holds_ann.get(f.lineno)
                if spec:
                    for tok in spec.split(","):
                        lid = mod.mod_lock_id(tok.strip())
                        if lid:
                            holds.add(lid)
                fi = _FnInfo(f"{mod.path}::{name}", name, mod.path,
                             mod, None, f, frozenset(holds))
                _FnWalker(self, fi).walk()
                fns.append(fi)
        return fns

    def _build_indexes(self, fns: List[_FnInfo]) -> None:
        self._by_fid = {fi.fid: fi for fi in fns}
        # the shared corpus-wide resolver (analysis/astutil.py): exact
        # for self-calls and same-module bare calls, singleton- and
        # unique-METHOD-name-based for attribute calls
        self._resolver = CallResolver()
        for path, m in self.modules.items():
            self._resolver.add_module(path, m.functions.keys(),
                                      m.classes.keys(), m.singletons)
        for fi in fns:
            if fi.cls is not None:
                self._resolver.add_function(
                    fi.fid, fi.path, fi.cls.name,
                    fi.qualname.split(".", 1)[1])
        self._resolver.finalize()

    def _resolve(self, fi: _FnInfo, kind: str, base: Optional[str],
                 name: str) -> Optional[_FnInfo]:
        """Resolve one call event to an analyzed function, or None
        (approximation documented in the module docstring)."""
        fid = self._resolver.resolve(
            fi.path, fi.cls.name if fi.cls is not None else None,
            kind, base, name)
        return self._by_fid.get(fid) if fid else None

    def _infer_caller_holds(self, fns: List[_FnInfo]) -> None:
        """Caller-holds-lock inference: a PRIVATE method (``_name``,
        not dunder) whose every resolved same-class call site holds
        lock L is analyzed as holding L — the ``_run_locked`` /
        ``_purge_locked`` idiom, without demanding an annotation at
        each site. Monotone (held sets only grow from the annotation
        floor), so the fixpoint converges. Public methods are API
        surface callable from anywhere and never inferred."""
        inferred: Dict[str, Set[str]] = {
            fi.fid: set(fi.holds) for fi in fns}
        union_h: Dict[str, Set[str]] = {
            fi.fid: set(fi.holds) for fi in fns}
        # callee fid -> [(caller fid, held-at-site, nested-site)]. A
        # call from a nested closure stays IN the site list: the
        # closure may run later on any thread, so it voids the
        # always-held intersection (held is empty there) instead of
        # being ignored — skipping it would wrongly infer "always
        # locked" from the remaining locked sites.
        sites: Dict[str, List[Tuple[str, FrozenSet[str], bool]]] = {}
        for fi in fns:
            for kind, base, name, _line, held, nested in fi.calls:
                if kind != "self":
                    continue
                callee = self._resolve(fi, kind, base, name)
                if callee is None:
                    continue
                mname = callee.qualname.rsplit(".", 1)[-1]
                if not mname.startswith("_") or mname.startswith("__"):
                    continue
                sites.setdefault(callee.fid, []).append(
                    (fi.fid, held, nested))
        # monotone (sets only grow), so this terminates; iterate to
        # the true fixpoint — a hard round cap would silently
        # under-propagate on deep private-helper chains
        while True:
            changed = False
            for fid, callers in sites.items():
                cand: Optional[Set[str]] = None
                some: Set[str] = set()
                for caller_fid, held, nested_site in callers:
                    eff = set(held) if nested_site \
                        else set(held) | inferred[caller_fid]
                    cand = eff if cand is None else cand & eff
                    some |= set(held) if nested_site \
                        else set(held) | union_h[caller_fid]
                new = inferred[fid] | (cand or set())
                if new != inferred[fid]:
                    inferred[fid] = new
                    changed = True
                new_u = union_h[fid] | some
                if new_u != union_h[fid]:
                    union_h[fid] = new_u
                    changed = True
            if not changed:
                break
        for fi in fns:
            fi.holds_union = frozenset(union_h[fi.fid]
                                       | inferred[fi.fid])
            extra = frozenset(inferred[fi.fid])
            if not extra:
                continue
            fi.holds = extra
            fi.mutations = [(a, l, h if n else h | extra, n)
                            for a, l, h, n in fi.mutations]
            fi.reads = [(a, l, h if n else h | extra, n)
                        for a, l, h, n in fi.reads]
            fi.cta = [(a, l, h if n else h | extra, n)
                      for a, l, h, n in fi.cta]
            fi.g_mutations = [(a, l, h if n else h | extra, n)
                              for a, l, h, n in fi.g_mutations]
            fi.g_reads = [(a, l, h if n else h | extra, n)
                          for a, l, h, n in fi.g_reads]
            fi.g_cta = [(a, l, h if n else h | extra, n)
                        for a, l, h, n in fi.g_cta]
            fi.lru_ops = [(a, g, l, h if n else h | extra, n)
                          for a, g, l, h, n in fi.lru_ops]
            fi.blocks = [(r, l, h if n else h | extra, n)
                         for r, l, h, n in fi.blocks]
            fi.acquires = [(a, l, h if n else h | extra, n)
                           for a, l, h, n in fi.acquires]
            fi.calls = [(k, b, n, l, h if nst else h | extra, nst)
                        for k, b, n, l, h, nst in fi.calls]

    def _fixpoint(self, fns: List[_FnInfo]) -> None:
        """Propagate 'acquires locks' and 'blocks' through the resolved
        call graph to a fixpoint (cycles converge: the sets only
        grow)."""
        for fi in fns:
            fi.locks_any = {lid for lid, _l, _h, _n in fi.acquires}
            if fi.blocks:
                fi.blocking_reason = fi.blocks[0][0]  # incl. nested:
                # a fn whose closure blocks still dispatches that work
        # monotone like the caller-holds inference: locks_any only
        # grows and blocking_reason is set at most once per fn
        changed = True
        while changed:
            changed = False
            for fi in fns:
                for kind, base, name, _line, _held, _n in fi.calls:
                    callee = self._resolve(fi, kind, base, name)
                    if callee is None:
                        continue
                    new = callee.locks_any - fi.locks_any
                    if new:
                        fi.locks_any |= new
                        changed = True
                    if fi.blocking_reason is None and \
                            callee.blocking_reason is not None:
                        fi.blocking_reason = (
                            f"{callee.qualname}() -> "
                            f"{callee.blocking_reason}")
                        changed = True

    # -- emission ----------------------------------------------------------
    def _emit(self, rule: str, path: str, line: int, scope: str,
              message: str) -> None:
        mod = self.modules.get(path)
        sup = mod.suppress.get(line, set()) if mod else set()
        f = Finding(rule, path, line, scope, message)
        if rule in sup or "all" in sup:
            self.suppressed.append(f)
        else:
            self.findings.append(f)

    # -- CC201 + CC205 -----------------------------------------------------
    def _class_guards(self, ci: _ClassInfo,
                      fns_by_cls: Dict[str, List[_FnInfo]]
                      ) -> Dict[str, Set[str]]:
        guards: Dict[str, Set[str]] = {}
        for fi in fns_by_cls.get((ci.module.path, ci.name), []):
            if fi.qualname.endswith(".__init__"):
                continue
            for attr, _line, held, nested in fi.mutations:
                evidence = held if nested else held | fi.holds_union
                if evidence and ci.lock_id(attr) is None:
                    guards.setdefault(attr, set()).update(evidence)
        for attr, lock in ci.guard_ann.items():
            if lock is None:
                guards.pop(attr, None)
                guards[attr] = set()      # annotated unguarded: exempt
            else:
                lid = ci.lock_id(lock) or \
                    f"{ci.module.qual}.{ci.name}.{lock}"
                guards[attr] = {lid}
        return guards

    def _rule_cc201_cc205(self, fi: _FnInfo) -> None:
        if fi.cls is None:
            return
        ci = fi.cls
        if not hasattr(self, "_guard_cache"):
            self._guard_cache: Dict[int, Dict[str, Set[str]]] = {}
            # keyed by (module path, class name): bare class names
            # repeat across modules (_Conn, Pred, S) and an unrelated
            # namesake's locked mutations must not poison this class's
            # guard inference
            self._fns_by_cls: Dict[Tuple[str, str],
                                   List[_FnInfo]] = {}
            for other in self._by_fid.values():
                if other.cls is not None:
                    self._fns_by_cls.setdefault(
                        (other.path, other.cls.name), []).append(other)
        guards = self._guard_cache.get(id(ci))
        if guards is None:
            guards = self._class_guards(ci, self._fns_by_cls)
            self._guard_cache[id(ci)] = guards
        if fi.qualname.endswith(".__init__"):
            return
        for attr, line, held, _nested in fi.mutations:
            g = guards.get(attr)
            if not g:
                continue
            if held & g:
                continue
            locks = "/".join(sorted(g))
            self._emit(
                "CC201", fi.path, line, fi.qualname,
                f"self.{attr} is guarded by {locks} at other mutation "
                f"sites but mutated here without it")
        mut_sites = {(a, l) for a, l, _h, _n in fi.mutations}
        seen_reads: Set[Tuple[str, int]] = set()
        for attr, line, held, _nested in fi.reads:
            g = guards.get(attr)
            if not g or held & g or (attr, line) in mut_sites \
                    or (attr, line) in seen_reads:
                continue
            seen_reads.add((attr, line))
            locks = "/".join(sorted(g))
            other = "/".join(sorted(held))
            self._emit(
                "CC201", fi.path, line, fi.qualname,
                f"self.{attr} read under {other} but mutated under "
                f"{locks} elsewhere: two locks guard the same state, "
                f"so neither excludes the other")
        for attr, line, held, _nested in fi.cta:
            g = guards.get(attr)
            if not g:
                continue
            if held & g:
                continue
            locks = "/".join(sorted(g))
            self._emit(
                "CC205", fi.path, line, fi.qualname,
                f"check-then-act on self.{attr} without {locks}: the "
                f"check and the mutation are not atomic")
        for disp, is_glob, line, held, _nested in fi.lru_ops:
            if is_glob or held:
                continue
            if guards.get(disp[5:]):
                continue   # guarded elsewhere: the mixed-guard rule owns it
            self._emit(
                "CC201", fi.path, line, fi.qualname,
                f"{disp}.move_to_end/popitem is a multi-step "
                f"linked-list relink (not GIL-atomic) and no lock "
                f"guards it: concurrent LRU traffic corrupts the "
                f"OrderedDict")

    # -- CC201/CC205 over module-level globals -----------------------------
    def _rule_globals(self, fi: _FnInfo) -> None:
        guards = self._mod_guards.get(fi.path, {})
        qual = fi.module.qual
        for name, line, held, _nested in fi.g_mutations:
            g = guards.get(name)
            if not g or held & g:
                continue
            locks = "/".join(sorted(g))
            self._emit(
                "CC201", fi.path, line, fi.qualname,
                f"{name} is guarded by {locks} at other mutation "
                f"sites but mutated here without it")
        mut_sites = {(n, l) for n, l, _h, _ns in fi.g_mutations}
        seen: Set[Tuple[str, int]] = set()
        for name, line, held, _nested in fi.g_reads:
            g = guards.get(name)
            if not g or held & g or (name, line) in mut_sites \
                    or (name, line) in seen:
                continue
            seen.add((name, line))
            locks = "/".join(sorted(g))
            other = "/".join(sorted(held))
            self._emit(
                "CC201", fi.path, line, fi.qualname,
                f"{name} read under {other} but mutated under {locks} "
                f"elsewhere: two locks guard the same state, so "
                f"neither excludes the other")
        for name, line, held, _nested in fi.g_cta:
            g = guards.get(name)
            if not g or held & g:
                continue
            locks = "/".join(sorted(g))
            self._emit(
                "CC205", fi.path, line, fi.qualname,
                f"check-then-act on {name} without {locks}: the check "
                f"and the mutation are not atomic")
        for disp, is_glob, line, held, _nested in fi.lru_ops:
            if not is_glob or held:
                continue
            if guards.get(disp):
                continue   # guarded elsewhere: the mixed-guard rule owns it
            self._emit(
                "CC201", fi.path, line, fi.qualname,
                f"{qual}.{disp}.move_to_end/popitem is a multi-step "
                f"linked-list relink (not GIL-atomic) and no lock "
                f"guards it: concurrent LRU traffic corrupts the "
                f"OrderedDict")

    # -- CC202 -------------------------------------------------------------
    def _rule_cc202(self, fi: _FnInfo) -> None:
        for reason, line, held, _nested in fi.blocks:
            if not held:
                continue
            locks = "/".join(sorted(held))
            self._emit(
                "CC202", fi.path, line, fi.qualname,
                f"{reason} while holding {locks}: every thread "
                f"contending on the lock stalls behind it")
        for kind, base, name, line, held, _nested in fi.calls:
            if not held:
                continue
            callee = self._resolve(fi, kind, base, name)
            if callee is None or callee.blocking_reason is None:
                continue
            # a direct match on the same line already reported it
            if any(line == bl and held == bh
                   for _r, bl, bh, _bn in fi.blocks):
                continue
            locks = "/".join(sorted(held))
            self._emit(
                "CC202", fi.path, line, fi.qualname,
                f"{callee.qualname}() blocks "
                f"({callee.blocking_reason}) and is called holding "
                f"{locks}")

    # -- CC203 -------------------------------------------------------------
    def _rule_cc203(self, fns: List[_FnInfo]) -> None:
        # edges: lock A held -> lock B acquired (directly or via a
        # resolved call that acquires B somewhere inside)
        edges: Dict[str, Dict[str, Tuple[str, int, str]]] = {}

        def add_edge(a: str, b: str, path: str, line: int,
                     scope: str) -> None:
            edges.setdefault(a, {})
            if b not in edges[a]:
                edges[a][b] = (path, line, scope)

        lock_kinds: Dict[str, str] = {}
        for mod in self.modules.values():
            for ci in mod.classes.values():
                for attr, kind in ci.locks.items():
                    lock_kinds[f"{mod.qual}.{ci.name}.{attr}"] = kind
            for name, kind in mod.mod_locks.items():
                lock_kinds[f"{mod.qual}.{name}"] = kind

        for fi in fns:
            for lid, line, held, _nested in fi.acquires:
                for a in held:
                    if a != lid:
                        add_edge(a, lid, fi.path, line, fi.qualname)
                    elif lock_kinds.get(lid) == "Lock":
                        self._emit(
                            "CC203", fi.path, line, fi.qualname,
                            f"{lid} re-acquired while already held: "
                            f"non-reentrant Lock self-deadlock")
            for kind, base, name, line, held, _nested in fi.calls:
                if not held:
                    continue
                callee = self._resolve(fi, kind, base, name)
                if callee is None:
                    continue
                for a in held:
                    for b in callee.locks_any:
                        if a == b:
                            # a self-edge through a call chain is a
                            # guaranteed deadlock only for exact
                            # same-class resolution on a plain Lock
                            if kind == "self" and \
                                    lock_kinds.get(a) == "Lock":
                                self._emit(
                                    "CC203", fi.path, line,
                                    fi.qualname,
                                    f"{callee.qualname}() re-acquires "
                                    f"{a} already held here: "
                                    f"non-reentrant Lock "
                                    f"self-deadlock")
                            continue
                        add_edge(a, b, fi.path, line,
                                 f"{fi.qualname}->{callee.qualname}")

        # cycle detection over the edge graph (iterative DFS)
        seen_cycles: Set[FrozenSet[str]] = set()
        for start in sorted(edges):
            stack = [(start, [start])]
            while stack:
                node, trail = stack.pop()
                for nxt in sorted(edges.get(node, {})):
                    if nxt == start and len(trail) > 1:
                        cyc = frozenset(trail)
                        if cyc in seen_cycles:
                            continue
                        seen_cycles.add(cyc)
                        sites = []
                        ring = trail + [start]
                        for i in range(len(ring) - 1):
                            p, l, s = edges[ring[i]][ring[i + 1]]
                            sites.append((p, l, s))
                        path, line, scope = min(sites)
                        order = " -> ".join(ring)
                        self._emit(
                            "CC203", path, line, scope,
                            f"lock-order cycle {order}: threads "
                            f"taking these locks in different orders "
                            f"can deadlock")
                    elif nxt not in trail and len(trail) < 6:
                        stack.append((nxt, trail + [nxt]))

    # -- CC204 -------------------------------------------------------------
    def _rule_cc204(self, fi: _FnInfo) -> None:
        for line, api in fi.escapes:
            self._emit(
                "CC204", fi.path, line, fi.qualname,
                f"closure submitted to another thread reads "
                f"thread-local state via {api}; on the pool thread it "
                f"silently no-ops or attributes to the wrong query — "
                f"hand off explicitly (span_tracer.start/stop, "
                f"Tracing.register, attach_thread, or build Span "
                f"objects)")


# ---------------------------------------------------------------------------
# conveniences + baseline
# ---------------------------------------------------------------------------

def analyze_source(src: str, path: str
                   ) -> Tuple[List[Finding], List[Finding]]:
    """Single-module analysis (tests). Whole-program resolution still
    runs — over a corpus of one module."""
    prog = Program()
    prog.add_source(src, path)
    return prog.analyze()


def analyze_tree(root: str, package: str = PACKAGE
                 ) -> Tuple[List[Finding], List[Finding]]:
    prog = Program()
    prog.add_tree(root, package)
    return prog.analyze()


def write_baseline(findings, path: str) -> None:
    from .astutil import write_baseline as _wb
    _wb(findings, path, comment=(
        "concur ratchet baseline — grandfathered CC findings per "
        "file::scope::rule, each a CC202 the JAX package grandfathers "
        "at the same site. controller.py: the property store is "
        "persisted by an atomic os.replace under Controller._lock, so "
        "the in-memory state and its file change together (every "
        "mutation that bumps the version persists). rollup.py: "
        "ForensicsRollupTask._run_lock serializes whole rollup passes, "
        "which are peer HTTP pulls and a cursor file write; the served "
        "snapshot takes only _lock. realtime/manager.py: the seal and "
        "commit protocol writes the partition state file under "
        "_seal_lock (and _view_lock on adoption) so a crash never sees "
        "a sealed segment without its offsets. realtime/wirestream.py: "
        "_PartitionLog.append fsyncs under the partition lock so an "
        "acknowledged append is durable in offset order. Regenerate "
        "with `python -m pinot_tpu_torch.tools.check_static "
        "--concur-only --update-baseline`; new findings above these "
        "counts fail check_static, and counts that drop must be "
        "ratcheted down here."))
