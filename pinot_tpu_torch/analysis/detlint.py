"""Whole-program determinism & replay-safety verifier: DT301–DT305
over the port's chaos/SLO/alert/shed/rebalance/autopsy planes.

Same-seed fault streams, the deterministic shed plan, byte-
deterministic SLO burn/alert streams, the closed-loop rebalance plan
and the incident autopsy's verdicts all rest on one invariant: decision
and output paths are pure in (seed, qid, site-key, record timestamps),
never in wall clock, ambient RNG, or iteration order. This pass makes
the invariant a tier-1 gate (AST, stable rule ids, ratchet baseline at
``pinot_tpu_torch/analysis/detlint_baseline.json``), *whole-program*:
the shared call resolver (analysis/astutil.py) propagates plane
membership forward from a registry of deterministic entry points, so a
wall-clock read three helpers deep under ``shed_decision`` is flagged
at its site.

The entry-point registry (``ROOTS``) names the decision/output
functions of ``pinot_tpu_torch/`` whose transitive callees form the
deterministic plane: the fault plane's ``FaultPlan.decide``/
``fault_fires``/``corrupt_bytes``, the SLO plane's window/burn
evaluation and status emission, the alert latches and fire path, the
overload ladder (``shed_decision``/``retry_after_ms``/
``OverloadGovernor.rung_for``), span sampling, ledger record building,
the rebalance planner and the autopsy planes. A function may also
self-declare with ``# detlint: entrypoint`` on its ``def`` line
(synthetic corpora in tests; future planes).

Rules:

- **DT301 wall-clock** — ``time.time``/``monotonic``/``perf_counter``/
  ``datetime.now`` reachable from a deterministic entry point without
  an injectable escape hatch. The escape-hatch idiom is recognized
  structurally: a clock read is EXEMPT when it is the ``is None``
  fallback of a None-default parameter (``t = now if now is not None
  else time.monotonic()``, ``if now is None: now = time.time()``,
  ``now or time.monotonic()`` — including one-step-derived locals like
  ``t = now if ... else event_time(rec)`` followed by ``if t is
  None:``). A clock read with no such hatch bakes wall time into a
  replayable decision.
- **DT302 ambient-randomness** — ``random.*`` module draws, global
  ``np.random.*`` (a seeded ``default_rng(seed)`` is exempt),
  ``uuid4``/``uuid1``, ``os.urandom``, ``secrets.*``, builtin
  ``hash()`` (PYTHONHASHSEED-dependent for str/bytes), and torch's
  global-generator draws — ``torch.rand``/``randn``/``randint``/
  ``randperm``/``normal``/``bernoulli``/``multinomial`` without
  ``generator=``, ``torch.manual_seed`` and ``torch.seed`` — inside
  the plane. A draw from an explicitly seeded ``torch.Generator``
  passed as ``generator=`` is exempt.
  Deterministic draws go through hashlib over (seed, site, key) — the
  ``faults._unit`` / ``workload._unit`` idiom.
- **DT303 unordered-serialization** — iteration over a ``set``
  literal/comprehension/``set()`` call, or an unsorted
  ``os.listdir``/``glob.glob``, feeding a loop, ``join``, ``list`` or
  ``tuple`` inside the plane: iteration order leaks into output
  contracts (ledger records, digests, alert streams). Wrap in
  ``sorted(...)``.
- **DT304 query-time-environ** — ``os.environ``/``os.getenv`` read
  inside the plane instead of the startup-parsed-once idiom (the
  ``PINOT_DRIFT_RATIO`` drift-throttle precedent: env reads on the hot
  path also cost a dict probe per decision).
- **DT305 completion-order-float** — a float accumulated over
  ``as_completed(...)``/``imap_unordered(...)`` results (``total +=
  f.result()`` in the loop, or ``sum()`` over such a generator):
  thread-completion order re-associates floating-point addition, so
  two runs of the same work disagree in the last ulp. Checked
  corpus-wide (integer counters like ``done += 1`` are exempt).

Suppression: append ``# detlint: ok <rule>`` (comma-separated rules or
``all``) to the offending line. True-but-benign sites are
grandfathered in the ratchet baseline: new findings above a
``file::scope::rule`` count fail ``pinot_tpu_torch.tools.
check_static``, and counts that DROP fail too until the baseline is
ratcheted down with ``--update-baseline``.

Known approximations (deliberate): the resolver follows self-calls,
same-module bare calls, imported names/modules/classes, corpus-unique
singletons and corpus-unique method names — never inheritance or
duck-typed callables; escape-hatch analysis is structural (an ``is
None`` guard on ANY None-default parameter exempts the governed
branch); DT303 only sees syntactic set expressions and unsorted
listdir/glob at the iteration site (no type inference).
"""
from __future__ import annotations

import ast
import os
import re
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .astutil import (PACKAGE, CallResolver, Finding, call_parts,
                      compare_baseline, counts_of, dotted_name,
                      iter_py_files, line_comments, load_baseline,
                      module_qual, parse_suppressions)

__all__ = [
    "DETLINT_RULES", "ROOTS", "EXTRA_FILES", "Program",
    "analyze_tree", "analyze_source", "compare_baseline", "counts_of",
    "load_baseline", "write_baseline",
]

DETLINT_RULES = {
    "DT301": "wall-clock read in a deterministic plane without an "
             "injectable escape hatch",
    "DT302": "ambient randomness in a deterministic plane",
    "DT303": "unordered-collection iteration serialized in a "
             "deterministic plane",
    "DT304": "query-time os.environ read in a deterministic plane",
    "DT305": "float accumulation in thread-completion order",
    # never baselined (write_baseline drops it): a module that stops
    # parsing must fail the gate no matter what was grandfathered
    "parse-error": "module failed to parse",
}

# The deterministic-plane entry registry: (repo-relative path,
# qualname). tests/test_torch_static_analysis.py asserts every entry
# still resolves to a real function, so a rename cannot silently disarm
# the pass. Taint propagates transitively to everything these call.
ROOTS: Tuple[Tuple[str, str], ...] = (
    # chaos plane: same-seed fault streams
    ("pinot_tpu_torch/utils/faults.py", "FaultPlan.decide"),
    ("pinot_tpu_torch/utils/faults.py", "fault_fires"),
    ("pinot_tpu_torch/utils/faults.py", "corrupt_bytes"),
    # SLO plane: window/burn evaluation + status emission
    ("pinot_tpu_torch/utils/slo.py", "burn_rate"),
    ("pinot_tpu_torch/utils/slo.py", "evaluate_objective"),
    ("pinot_tpu_torch/utils/slo.py", "classify_query"),
    ("pinot_tpu_torch/utils/slo.py", "event_time"),
    ("pinot_tpu_torch/utils/slo.py", "plan_alert_stream"),
    ("pinot_tpu_torch/utils/slo.py", "normalize_alerts"),
    ("pinot_tpu_torch/utils/slo.py", "SloPlane.observe_query"),
    ("pinot_tpu_torch/utils/slo.py", "SloPlane.observe_freshness"),
    ("pinot_tpu_torch/utils/slo.py", "SloPlane._evaluate"),
    ("pinot_tpu_torch/utils/slo.py", "SloPlane.status_block"),
    ("pinot_tpu_torch/utils/slo.py", "SloPlane.emit_status"),
    # alert latches + the fire path (deterministic in the event stream)
    ("pinot_tpu_torch/utils/alerts.py", "RateWindowRule.note"),
    ("pinot_tpu_torch/utils/alerts.py", "LevelRule.check"),
    ("pinot_tpu_torch/utils/alerts.py", "AlertManager.fire"),
    # overload ladder: the deterministic shed plane
    ("pinot_tpu_torch/broker/workload.py", "shed_decision"),
    ("pinot_tpu_torch/broker/workload.py", "retry_after_ms"),
    ("pinot_tpu_torch/broker/workload.py", "tier_shed_rank"),
    ("pinot_tpu_torch/broker/workload.py", "OverloadGovernor.rung_for"),
    # span sampling: pure in (query_id, ratio)
    ("pinot_tpu_torch/utils/spans.py", "sample_decision"),
    # ledger record building (the output contract)
    ("pinot_tpu_torch/utils/ledger.py", "make_record"),
    # closed-loop rebalance planning plane: the move plan
    # plus its freeze/burn/affinity/budget predicates — execution-side
    # impurity stays in ClosedLoopRebalanceTask, outside the registry
    ("pinot_tpu_torch/cluster/rebalancer.py", "plan_moves"),
    ("pinot_tpu_torch/cluster/rebalancer.py", "incident_frozen"),
    ("pinot_tpu_torch/cluster/rebalancer.py", "burning_tables"),
    ("pinot_tpu_torch/cluster/rebalancer.py", "receiver_affinity"),
    ("pinot_tpu_torch/cluster/rebalancer.py", "churn_capped"),
    # incident autopsy plane: corpus loading, the window
    # assembler, every cause scorer and both verdict planners — the
    # byte-replayable attribution surface. Ledger/ring
    # impurity stays in AutopsyPlane, outside the registry.
    ("pinot_tpu_torch/cluster/autopsy.py", "load_corpus"),
    ("pinot_tpu_torch/cluster/autopsy.py", "assemble_window"),
    ("pinot_tpu_torch/cluster/autopsy.py", "score_compile_storm"),
    ("pinot_tpu_torch/cluster/autopsy.py", "score_tier_thrash"),
    ("pinot_tpu_torch/cluster/autopsy.py", "score_overload_shed"),
    ("pinot_tpu_torch/cluster/autopsy.py", "score_rebalance_churn"),
    ("pinot_tpu_torch/cluster/autopsy.py", "score_chaos_faults"),
    ("pinot_tpu_torch/cluster/autopsy.py", "score_straggler"),
    ("pinot_tpu_torch/cluster/autopsy.py", "score_drift_recompile"),
    ("pinot_tpu_torch/cluster/autopsy.py", "score_ingest_stall"),
    ("pinot_tpu_torch/cluster/autopsy.py", "plan_autopsy"),
    ("pinot_tpu_torch/cluster/autopsy.py", "whydown"),
)

# files outside the package walk that the registry names: none, every
# root of the port lives in the package
EXTRA_FILES: Tuple[str, ...] = ()

_ENTRY_RE = re.compile(r"detlint:\s*(entrypoint)")

# -- DT301 matchers ---------------------------------------------------------
_CLOCK_DOTTED = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.thread_time",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow", "datetime.date.today", "date.today",
}
# wall-clock only when called with NO args (with an arg they are pure
# epoch->struct_time conversions)
_CLOCK_NOARG = {"time.gmtime", "time.localtime"}

# -- DT302 matchers ---------------------------------------------------------
# seeded constructors: deterministic, never ambient
_RNG_SEEDED_CTORS = {"Random", "default_rng", "RandomState", "seed"}
_RNG_MODULES = ("random.", "np.random.", "numpy.random.", "secrets.")
_RNG_BARE = {"uuid4", "uuid1", "urandom", "getrandbits", "token_hex",
             "token_bytes"}
_RNG_DOTTED = {"uuid.uuid4", "uuid.uuid1", "os.urandom"}
# torch's global-generator draws: ambient unless given generator=
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial"}
# reseeding (or reading a fresh seed of) the global generator
_TORCH_SEEDS = {"manual_seed", "seed"}

# -- DT303 matchers ---------------------------------------------------------
_FS_UNORDERED = {"os.listdir", "glob.glob", "glob.iglob"}
_SERIALIZERS = {"list", "tuple"}   # list(set(...)), tuple(set(...))

# -- DT305 matchers ---------------------------------------------------------
_UNORDERED_POOLS_BARE = {"as_completed"}
_UNORDERED_POOLS_ATTR = {"as_completed", "imap_unordered"}


def _is_set_expr(node: ast.AST) -> Optional[str]:
    """Display name when ``node`` is a syntactic unordered collection."""
    if isinstance(node, ast.Set):
        return "set literal"
    if isinstance(node, ast.SetComp):
        return "set comprehension"
    if isinstance(node, ast.Call):
        _b, name = call_parts(node.func)
        if name in ("set", "frozenset"):
            return f"{name}()"
    return None


def _has_pool_iter(node: ast.AST) -> Optional[str]:
    """Display name when the subtree iterates an unordered pool."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            base, name = call_parts(n.func)
            if base is None and name in _UNORDERED_POOLS_BARE:
                return f"{name}()"
            if isinstance(n.func, ast.Attribute) and \
                    n.func.attr in _UNORDERED_POOLS_ATTR:
                return f".{n.func.attr}()"
    return None


def _int_constant(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, int) and \
            not isinstance(node.value, bool)
    if isinstance(node, ast.UnaryOp):
        return _int_constant(node.operand)
    return False


# ---------------------------------------------------------------------------
# per-module / per-function model
# ---------------------------------------------------------------------------

@dataclass
class _ModuleInfo:
    path: str                      # repo-relative, posix
    tree: ast.AST
    suppress: Dict[int, Set[str]]
    entry_lines: Set[int]          # detlint: entrypoint comment lines
    classes: Dict[str, ast.ClassDef] = field(default_factory=dict)
    functions: Dict[str, ast.AST] = field(default_factory=dict)
    singletons: Dict[str, str] = field(default_factory=dict)
    import_mods: Dict[str, str] = field(default_factory=dict)
    import_syms: Dict[str, Tuple[str, str]] = field(default_factory=dict)

    @property
    def qual(self) -> str:
        return module_qual(self.path)


@dataclass
class _FnInfo:
    fid: str
    qualname: str
    path: str
    module: _ModuleInfo
    cls_name: Optional[str]
    node: ast.AST
    is_entry: bool = False
    # (display, line, escaped)
    clocks: List[Tuple[str, int, bool]] = field(default_factory=list)
    rngs: List[Tuple[str, int]] = field(default_factory=list)
    unordered: List[Tuple[str, int]] = field(default_factory=list)
    envs: List[Tuple[str, int]] = field(default_factory=list)
    facc: List[Tuple[str, int]] = field(default_factory=list)
    calls: List[Tuple[str, Optional[str], str, int]] = \
        field(default_factory=list)   # (kind, base, name, line)


# ---------------------------------------------------------------------------
# the event walker
# ---------------------------------------------------------------------------

class _FnWalker:
    """Walks one function body collecting determinism events, tracking
    the escape-hatch context for clock reads (module docstring)."""

    def __init__(self, info: _FnInfo):
        self.info = info
        self.guards = self._guard_names(info.node)

    # -- escape-hatch analysis ---------------------------------------------
    @staticmethod
    def _none_default_params(fn: ast.AST) -> Set[str]:
        names: Set[str] = set()
        args = fn.args
        pos = list(getattr(args, "posonlyargs", [])) + list(args.args)
        for a, d in zip(pos[len(pos) - len(args.defaults):],
                        args.defaults):
            if isinstance(d, ast.Constant) and d.value is None:
                names.add(a.arg)
        for a, d in zip(args.kwonlyargs, args.kw_defaults):
            if d is not None and isinstance(d, ast.Constant) \
                    and d.value is None:
                names.add(a.arg)
        return names

    def _guard_names(self, fn: ast.AST) -> Set[str]:
        """None-default parameters (of the function and its nested
        defs) plus locals derived from them: the names whose ``is
        None`` fallback branch is the injectable-clock idiom."""
        names: Set[str] = set()
        for n in ast.walk(fn):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                names |= self._none_default_params(n)
        # derived locals to a fixpoint: t = now if ... else event_time()
        changed = True
        while changed:
            changed = False
            for n in ast.walk(fn):
                if not isinstance(n, ast.Assign) or n.value is None:
                    continue
                refs = {x.id for x in ast.walk(n.value)
                        if isinstance(x, ast.Name)}
                if not (refs & names):
                    continue
                for t in n.targets:
                    if isinstance(t, ast.Name) and t.id not in names:
                        names.add(t.id)
                        changed = True
        return names

    def _test_guards(self, test: ast.AST) -> bool:
        """True when the test contains ``<guard> is None`` /
        ``is not None`` — the governed branches are the escape
        hatch."""
        for n in ast.walk(test):
            if isinstance(n, ast.Compare) and \
                    any(isinstance(op, (ast.Is, ast.IsNot))
                        for op in n.ops):
                sides = [n.left] + list(n.comparators)
                names = {s.id for s in sides if isinstance(s, ast.Name)}
                has_none = any(isinstance(s, ast.Constant)
                               and s.value is None for s in sides)
                if has_none and (names & self.guards):
                    return True
        return False

    @staticmethod
    def _refs_guard(node: ast.AST, guards: Set[str]) -> bool:
        return any(isinstance(x, ast.Name) and x.id in guards
                   for x in ast.walk(node))

    # -- walk --------------------------------------------------------------
    def walk(self) -> None:
        for stmt in getattr(self.info.node, "body", []):
            self._scan(stmt, esc=False, in_sorted=False)

    def _scan(self, node: ast.AST, esc: bool, in_sorted: bool) -> None:
        if isinstance(node, ast.If) and self._test_guards(node.test):
            self._scan(node.test, esc, in_sorted)
            for child in node.body + node.orelse:
                self._scan(child, True, in_sorted)
            return
        if isinstance(node, ast.IfExp) and self._test_guards(node.test):
            self._scan(node.test, esc, in_sorted)
            self._scan(node.body, True, in_sorted)
            self._scan(node.orelse, True, in_sorted)
            return
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.Or) \
                and node.values:
            # ``now or time.monotonic()``: the fallback operands are
            # governed by the guard's truthiness
            first_guards = self._refs_guard(node.values[0], self.guards)
            self._scan(node.values[0], esc, in_sorted)
            for v in node.values[1:]:
                self._scan(v, esc or first_guards, in_sorted)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._for_loop(node, esc, in_sorted)
            for child in ast.iter_child_nodes(node):
                self._scan(child, esc, in_sorted)
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            for gen in node.generators:
                disp = _is_set_expr(gen.iter)
                if disp is not None and not in_sorted:
                    self.info.unordered.append(
                        (f"comprehension over {disp}",
                         node.lineno))
        if isinstance(node, ast.Call):
            self._call(node, esc, in_sorted)
            _b, name = call_parts(node.func)
            arg_sorted = in_sorted or name == "sorted"
            for child in ast.iter_child_nodes(node):
                self._scan(child, esc, arg_sorted)
            return
        if isinstance(node, ast.Attribute):
            dotted = dotted_name(node)
            if dotted == "os.environ":
                self.info.envs.append(("os.environ", node.lineno))
        for child in ast.iter_child_nodes(node):
            self._scan(child, esc, in_sorted)

    def _for_loop(self, node: ast.AST, esc: bool,
                  in_sorted: bool) -> None:
        disp = _is_set_expr(node.iter)
        if disp is not None and not in_sorted:
            self.info.unordered.append(
                (f"iteration over {disp}", node.lineno))
        # DT305: float accumulation over unordered pool completion
        pool = _has_pool_iter(node.iter)
        if pool is not None:
            for n in ast.walk(node):
                if isinstance(n, ast.AugAssign) and \
                        isinstance(n.op, ast.Add) and \
                        not _int_constant(n.value):
                    self.info.facc.append(
                        (f"+= over {pool} results", n.lineno))

    def _call(self, node: ast.Call, esc: bool, in_sorted: bool) -> None:
        base, name = call_parts(node.func)
        dotted = dotted_name(node.func)
        # DT301 clocks
        if dotted in _CLOCK_DOTTED or \
                (dotted in _CLOCK_NOARG and not node.args):
            self.info.clocks.append((f"{dotted}()", node.lineno, esc))
        # DT302 ambient randomness
        rng = self._rng_display(node, base, name, dotted)
        if rng is not None:
            self.info.rngs.append((rng, node.lineno))
        # DT303 unsorted filesystem enumeration
        if dotted in _FS_UNORDERED and not in_sorted:
            self.info.unordered.append((f"unsorted {dotted}()",
                                        node.lineno))
        # DT303 set serialized through join/list/tuple
        ser = None
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "join" and node.args:
            ser = ("join", node.args[0])
        elif base is None and name in _SERIALIZERS and node.args:
            ser = (name, node.args[0])
        if ser is not None and not in_sorted:
            disp = _is_set_expr(ser[1])
            if disp is not None:
                self.info.unordered.append(
                    (f"{ser[0]}() over {disp}", node.lineno))
        # DT304 env reads via os.getenv (os.environ handled on the
        # Attribute node so subscripts and .get both count)
        if dotted == "os.getenv":
            self.info.envs.append(("os.getenv()", node.lineno))
        # DT305 sum() over an unordered-pool generator
        if base is None and name == "sum" and node.args:
            pool = _has_pool_iter(node.args[0])
            if pool is not None:
                self.info.facc.append(
                    (f"sum() over {pool} results", node.lineno))
        # resolution hints for the call graph (concur's vocabulary)
        if name is not None:
            if isinstance(node.func, ast.Attribute):
                if base == "self":
                    self.info.calls.append(
                        ("self", None, name, node.lineno))
                elif base is not None:
                    self.info.calls.append(
                        ("attr", base, name, node.lineno))
            else:
                self.info.calls.append(
                    ("bare", None, name, node.lineno))

    @staticmethod
    def _rng_display(node: ast.Call, base: Optional[str],
                     name: Optional[str],
                     dotted: Optional[str]) -> Optional[str]:
        if base == "torch" and (name in _TORCH_SEEDS or (
                name in _TORCH_DRAWS and not any(
                    kw.arg == "generator" and not (
                        isinstance(kw.value, ast.Constant)
                        and kw.value.value is None)
                    for kw in node.keywords))):
            return f"{dotted}() on the global torch generator"
        if dotted is None:
            return None
        if dotted in _RNG_DOTTED:
            return f"{dotted}()"
        if base is None and name in _RNG_BARE:
            return f"{name}()"
        if base is None and name == "hash" and node.args:
            return "builtin hash() (PYTHONHASHSEED-dependent)"
        for prefix in _RNG_MODULES:
            if dotted.startswith(prefix):
                tail = dotted[len(prefix):]
                if tail in _RNG_SEEDED_CTORS and node.args:
                    return None   # seeded: deterministic by contract
                return f"{dotted}()"
        return None


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

class Program:
    """Whole-program analysis context: feed modules with
    ``add_source``/``add_tree``, then ``analyze()`` -> (findings,
    suppressed). ``extra_roots`` extends the registry (tests)."""

    def __init__(self, extra_roots: Tuple[Tuple[str, str], ...] = ()):
        self.modules: Dict[str, _ModuleInfo] = {}
        self.findings: List[Finding] = []
        self.suppressed: List[Finding] = []
        self.extra_roots = tuple(extra_roots)
        # registry entries that resolved / didn't (corpus test surface)
        self.roots_matched: List[Tuple[str, str]] = []
        self.roots_missing: List[Tuple[str, str]] = []

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
        mod = _ModuleInfo(
            path, tree, parse_suppressions(src, "detlint"),
            set(line_comments(src, _ENTRY_RE)))
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                mod.classes[node.name] = node
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                mod.functions[node.name] = node
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                _b, ctor = call_parts(node.value.func)
                if ctor and ctor[:1].isupper():
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            mod.singletons[t.id] = ctor
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname is None:
                        continue   # "import x.y" binds only "x"
                    q = a.name
                    if q.startswith(PACKAGE + "."):
                        q = q[len(PACKAGE) + 1:]
                    elif q == PACKAGE:
                        continue
                    mod.import_mods[a.asname] = q
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    parts = module_qual(path).split(".")[:-1]
                    if node.level > 1:
                        parts = parts[:len(parts) - (node.level - 1)]
                    if node.module:
                        parts = parts + node.module.split(".")
                    base = ".".join(parts)
                else:
                    base = node.module or ""
                    if base.startswith(PACKAGE + "."):
                        base = base[len(PACKAGE) + 1:]
                    elif base == PACKAGE:
                        base = ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    mod.import_syms[a.asname or a.name] = (base, a.name)
        self.modules[path] = mod

    def add_tree(self, root: str, package: str = PACKAGE,
                 extra_files: Tuple[str, ...] = EXTRA_FILES) -> None:
        for full, rel in iter_py_files(root, package, extra_files):
            with open(full, "r", encoding="utf-8") as fh:
                self.add_source(fh.read(), rel)

    # -- analysis ----------------------------------------------------------
    def analyze(self) -> Tuple[List[Finding], List[Finding]]:
        fns = self._walk_all()
        self._build_indexes(fns)
        det = self._reach(fns)
        for fi in fns:
            plane = det.get(fi.fid)
            if plane is not None:
                self._rules_in_plane(fi, plane)
            for disp, line in fi.facc:
                self._emit(
                    "DT305", fi.path, line, fi.qualname,
                    f"{disp}: thread-completion order re-associates "
                    f"the floating-point sum, so same-input runs "
                    f"disagree in the last ulp — accumulate in "
                    f"submission order (iterate the futures list, "
                    f"not as_completed)")
        order = {r: i for i, r in enumerate(DETLINT_RULES)}
        self.findings.sort(
            key=lambda f: (f.path, f.line, order.get(f.rule, 99)))
        return self.findings, self.suppressed

    def _walk_all(self) -> List[_FnInfo]:
        fns: List[_FnInfo] = []

        def load(mod: _ModuleInfo, qualname: str,
                 cls_name: Optional[str], node: ast.AST) -> None:
            fi = _FnInfo(f"{mod.path}::{qualname}", qualname, mod.path,
                         mod, cls_name, node,
                         is_entry=node.lineno in mod.entry_lines)
            _FnWalker(fi).walk()
            fns.append(fi)

        for mod in self.modules.values():
            for cname, cnode in mod.classes.items():
                for stmt in cnode.body:
                    if isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        load(mod, f"{cname}.{stmt.name}", cname, stmt)
            for name, fnode in mod.functions.items():
                load(mod, name, None, fnode)
        return fns

    def _build_indexes(self, fns: List[_FnInfo]) -> None:
        self._by_fid = {fi.fid: fi for fi in fns}
        self._qual_path = {m.qual: p for p, m in self.modules.items()}
        self._resolver = CallResolver()
        for path, m in self.modules.items():
            self._resolver.add_module(path, m.functions.keys(),
                                      m.classes.keys(), m.singletons)
        for fi in fns:
            if fi.cls_name is not None:
                self._resolver.add_function(
                    fi.fid, fi.path, fi.cls_name,
                    fi.qualname.split(".", 1)[1])
        self._resolver.finalize()

    # -- resolution: shared resolver + import-alias follow-through ---------
    def _sym_target(self, mod: _ModuleInfo, alias: str
                    ) -> Optional[Tuple[str, str, Optional[str]]]:
        """-> ("mod", path, None) | ("sym", path, name) | None for an
        imported alias in ``mod``."""
        q = mod.import_mods.get(alias)
        if q is not None:
            p = self._qual_path.get(q)
            return ("mod", p, None) if p else None
        t = mod.import_syms.get(alias)
        if t is None:
            return None
        base, name = t
        p = self._qual_path.get(f"{base}.{name}" if base else name)
        if p is not None:
            return ("mod", p, None)   # "from . import ledger" style
        p = self._qual_path.get(base)
        if p is not None:
            return ("sym", p, name)
        return None

    def _resolve(self, fi: _FnInfo, kind: str, base: Optional[str],
                 name: str) -> Optional[str]:
        fid = self._resolver.resolve(fi.path, fi.cls_name, kind,
                                     base, name)
        if fid is not None:
            return fid
        mod = fi.module
        if kind == "bare":
            t = self._sym_target(mod, name)
            if t is not None and t[0] == "sym":
                _k, p, sym = t
                if sym in self.modules[p].functions:
                    return f"{p}::{sym}"
            return None
        if kind == "attr" and base is not None:
            # Cls.method(...) on a locally-defined or imported class
            cls_path = cls_name = None
            if base in mod.classes:
                cls_path, cls_name = fi.path, base
            else:
                t = self._sym_target(mod, base)
                if t is not None and t[0] == "sym" and \
                        t[2] in self.modules[t[1]].classes:
                    cls_path, cls_name = t[1], t[2]
                elif t is not None and t[0] == "mod":
                    if name in self.modules[t[1]].functions:
                        return f"{t[1]}::{name}"
            if cls_path is not None:
                return self._resolver.class_method(cls_path, cls_name,
                                                   name)
        return None

    # -- forward reachability from the registry ----------------------------
    def _reach(self, fns: List[_FnInfo]
               ) -> Dict[str, Tuple[str, Optional[str]]]:
        """fid -> (root display, immediate caller qualname or None)."""
        self.roots_matched, self.roots_missing = [], []
        det: Dict[str, Tuple[str, Optional[str]]] = {}
        queue: deque = deque()

        def seed(fid: str, display: str) -> None:
            if fid not in det:
                det[fid] = (display, None)
                queue.append(fid)

        for path, qualname in tuple(ROOTS) + self.extra_roots:
            fid = f"{path}::{qualname}"
            if fid in self._by_fid:
                self.roots_matched.append((path, qualname))
                seed(fid, f"{module_qual(path)}.{qualname}")
            elif path in self.modules:
                # the module is in the corpus but the function is gone:
                # the registry entry is stale (corpus test asserts
                # roots_missing == [])
                self.roots_missing.append((path, qualname))
        for fi in fns:
            if fi.is_entry:
                seed(fi.fid, f"{fi.module.qual}.{fi.qualname}")
        while queue:
            fid = queue.popleft()
            fi = self._by_fid[fid]
            root, _via = det[fid]
            for kind, base, name, _line in fi.calls:
                callee = self._resolve(fi, kind, base, name)
                if callee is not None and callee not in det and \
                        callee in self._by_fid:
                    det[callee] = (root, fi.qualname)
                    queue.append(callee)
        return det

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

    def _rules_in_plane(self, fi: _FnInfo,
                        plane: Tuple[str, Optional[str]]) -> None:
        root, via = plane
        where = f"entry point {root}" + \
            (f" via {via}" if via and via != fi.qualname else "")
        for disp, line, escaped in fi.clocks:
            if escaped:
                continue
            self._emit(
                "DT301", fi.path, line, fi.qualname,
                f"{disp} read on a deterministic-plane path "
                f"({where}) with no injectable now=/ts= escape "
                f"hatch: wall clock leaks into replayable decisions")
        for disp, line in fi.rngs:
            self._emit(
                "DT302", fi.path, line, fi.qualname,
                f"{disp}: ambient randomness on a deterministic-plane "
                f"path ({where}); draw deterministically from hashlib "
                f"over (seed, site, key) instead")
        for disp, line in fi.unordered:
            self._emit(
                "DT303", fi.path, line, fi.qualname,
                f"{disp} on a deterministic-plane path ({where}): "
                f"iteration order leaks into the output contract — "
                f"wrap in sorted(...)")
        for disp, line in fi.envs:
            self._emit(
                "DT304", fi.path, line, fi.qualname,
                f"{disp} read at query time on a deterministic-plane "
                f"path ({where}); parse once at startup (the "
                f"PINOT_DRIFT_RATIO precedent)")


# ---------------------------------------------------------------------------
# conveniences + baseline
# ---------------------------------------------------------------------------

def analyze_source(src: str, path: str,
                   extra_roots: Tuple[Tuple[str, str], ...] = ()
                   ) -> Tuple[List[Finding], List[Finding]]:
    """Single-module analysis (tests). Whole-program resolution still
    runs — over a corpus of one module."""
    prog = Program(extra_roots=extra_roots)
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
        "detlint ratchet baseline — grandfathered DT findings per "
        "file::scope::rule, each a vetted true-but-benign site. "
        "make_record::DT301: the time.gmtime() ts default is the "
        "documented live-mode fallback; deterministic emitters inject "
        "ts= through **fields (plan_alert_stream pins ts_fn), an "
        "escape hatch the structural is-None analysis cannot see "
        "through kwargs. Regenerate with `python -m pinot_tpu_torch."
        "tools.check_static --detlint-only --update-baseline`; new "
        "findings above these "
        "counts fail check_static, and counts that drop must be "
        "ratcheted down here."))
