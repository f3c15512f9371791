"""Shared AST plumbing for the port's static-analysis passes.

concur and detlint share one copy of the machinery: the ``Finding``
record + ratchet-baseline helpers, ``# <tool>: ok <rule>`` suppression
parsing, call-name decomposition, the package-tree module walk
(``pinot_tpu_torch/`` by default) and the corpus-wide call resolver.

The call-resolution contract (concur's, unchanged):

- a ``self.m()`` call resolves EXACTLY within its own (module, class);
- a bare ``f()`` call resolves EXACTLY to a same-module top-level
  function;
- an ``obj.m()`` attribute call resolves through the module-level
  singleton map (``global_metrics = MetricsRegistry()`` style) when the
  singleton name is corpus-unique and its class lives in exactly one
  module, else through the corpus-unique METHOD-name fallback — an
  ambiguous name is simply not resolved (approximation documented in
  concur's module docstring).

Function ids ("fids") are ``path::qualname`` — ``path`` repo-relative
posix, ``qualname`` either ``fn`` (module function) or ``Cls.method``.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple


# the package the passes walk and strip from module qualifiers
PACKAGE = "pinot_tpu_torch"


# ---------------------------------------------------------------------------
# findings + ratchet baseline
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Finding:
    rule: str
    path: str       # repo-relative, posix separators
    line: int
    scope: str      # enclosing qualname, e.g. "KernelPlanCache.entry"
    message: str

    @property
    def key(self) -> str:
        """Baseline key: line numbers drift, (file, scope, rule) don't."""
        return f"{self.path}::{self.scope}::{self.rule}"

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.scope}: "
                f"{self.message}")


def counts_of(findings: Sequence[Finding]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        out[f.key] = out.get(f.key, 0) + 1
    return out


def load_baseline(path: str) -> Dict[str, int]:
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return dict(data.get("counts", {}))


def write_baseline(findings: Sequence[Finding], path: str,
                   comment: Optional[str] = None) -> None:
    # parse-error can never be grandfathered: a module that stops
    # parsing must fail the gate even right after --update-baseline
    findings = [f for f in findings if f.rule != "parse-error"]
    data = {
        "comment": comment or (
            "ratchet baseline — grandfathered findings per "
            "file::scope::rule. Regenerate with "
            "`python -m pinot_tpu_torch.tools.check_static "
            "--update-baseline`; "
            "new findings above these counts fail check_static, "
            "and counts that drop must be ratcheted down here."),
        "version": 1,
        "counts": dict(sorted(counts_of(findings).items())),
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=1, sort_keys=False)
        fh.write("\n")


def compare_baseline(findings: Sequence[Finding], baseline: Dict[str, int]
                     ) -> Tuple[List[Finding], List[Tuple[str, int, int]]]:
    """-> (new_findings, stale_entries).

    new_findings: findings in keys whose count exceeds the baseline
    (the whole key's findings are reported so the offender is visible).
    stale_entries: (key, baseline_count, actual_count) where the actual
    count dropped below the baseline — ratchet the baseline down.
    """
    actual = counts_of(findings)
    new: List[Finding] = []
    for key, n in sorted(actual.items()):
        allowed = baseline.get(key, 0)
        if n > allowed:
            new.extend(sorted((f for f in findings if f.key == key),
                              key=lambda f: f.line))
    stale = [(key, allowed, actual.get(key, 0))
             for key, allowed in sorted(baseline.items())
             if actual.get(key, 0) < allowed]
    return new, stale


# ---------------------------------------------------------------------------
# comments: suppressions + annotations
# ---------------------------------------------------------------------------

def suppress_regex(tool: str) -> re.Pattern:
    """The ``# <tool>: ok <rules>`` suppression-comment pattern."""
    return re.compile(rf"{tool}:\s*ok\s+([\w,\- ]+)")


def parse_suppressions(src: str, tool: str) -> Dict[int, Set[str]]:
    """line -> set of suppressed rule names (or {"all"})."""
    out: Dict[int, Set[str]] = {}
    rx = suppress_regex(tool)
    for i, line in enumerate(src.splitlines(), start=1):
        m = rx.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",")
                      if r.strip()}
    return out


def line_comments(src: str, regex: re.Pattern) -> Dict[int, str]:
    """line -> first capture group of ``regex`` on that line."""
    out: Dict[int, str] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = regex.search(line)
        if m:
            out[i] = m.group(1)
    return out


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------

def call_parts(func: ast.AST) -> Tuple[Optional[str], Optional[str]]:
    """('np', 'asarray') for np.asarray(...); (None, 'int') for
    int(...); (None, None) for anything deeper."""
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        return func.value.id, func.attr
    if isinstance(func, ast.Name):
        return None, func.id
    return None, None


def self_attr(node: ast.AST) -> Optional[str]:
    """'x' for a ``self.x`` attribute node, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def dotted_name(node: ast.AST) -> Optional[str]:
    """'os.environ' for the nested attribute chain, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


# ---------------------------------------------------------------------------
# tree walking
# ---------------------------------------------------------------------------

def iter_py_files(root: str, package: str = PACKAGE,
                  extra_files: Iterable[str] = ()
                  ) -> Iterator[Tuple[str, str]]:
    """Yield (absolute, repo-relative-posix) for every analyzable .py
    under <root>/<package> (sorted, __pycache__ and *_pb2.py skipped),
    then each existing ``extra_files`` repo-relative path."""
    pkg_dir = os.path.join(root, package)
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py") or fn.endswith("_pb2.py"):
                continue
            full = os.path.join(dirpath, fn)
            yield full, os.path.relpath(full, root).replace(os.sep, "/")
    for rel in extra_files:
        full = os.path.join(root, rel.replace("/", os.sep))
        if os.path.exists(full):
            yield full, rel.replace(os.sep, "/")


def module_qual(path: str) -> str:
    """Collision-free module qualifier ("engine.batch",
    "native.__init__"): bare stems repeat across packages (batch.py,
    __init__.py), and two same-named entities must not merge into one
    graph node."""
    q = path
    if q.startswith(PACKAGE + "/"):
        q = q[len(PACKAGE) + 1:]
    return os.path.splitext(q)[0].replace("/", ".")


# ---------------------------------------------------------------------------
# the corpus-wide call resolver
# ---------------------------------------------------------------------------

class CallResolver:
    """Whole-program call resolution over fids (module docstring).

    Feed with ``add_module`` (once per module) + ``add_function`` (once
    per class METHOD — bare module functions resolve through the
    module's function-name set and the ``path::name`` fid convention),
    then ``finalize()``, then ``resolve()``.
    """

    def __init__(self):
        self._mod_fns: Dict[str, Set[str]] = {}
        self._cls_paths: Dict[str, List[str]] = {}
        self._class_names: Set[str] = set()
        self._by_method: Dict[str, List[str]] = {}
        self._class_fid: Dict[Tuple[str, str, str], str] = {}
        self._raw_singletons: List[Tuple[str, str]] = []
        self._singleton_cls: Dict[str, str] = {}

    def add_module(self, path: str, function_names: Iterable[str],
                   class_names: Iterable[str],
                   singletons: Dict[str, str]) -> None:
        self._mod_fns[path] = set(function_names)
        for c in class_names:
            self._class_names.add(c)
            self._cls_paths.setdefault(c, []).append(path)
        for name, ctor in singletons.items():
            self._raw_singletons.append((name, ctor))

    def add_function(self, fid: str, path: str, cls_name: str,
                     method_name: str) -> None:
        self._by_method.setdefault(method_name, []).append(fid)
        self._class_fid[(path, cls_name, method_name)] = fid

    def finalize(self) -> None:
        # module-level singleton name -> class, corpus-wide and unique:
        # two same-named singletons of different classes are ambiguous
        # and dropped (refusing beats misresolving)
        dropped: Set[str] = set()
        for name, ctor in self._raw_singletons:
            if ctor not in self._class_names:
                continue
            if name in self._singleton_cls and \
                    self._singleton_cls[name] != ctor:
                dropped.add(name)
            self._singleton_cls[name] = ctor
        for name in dropped:
            self._singleton_cls.pop(name, None)

    def class_method(self, path: str, cls_name: str,
                     method_name: str) -> Optional[str]:
        """fid of an exactly-located class method, or None — for
        callers that resolved (path, class) themselves (detlint's
        imported-class follow-through)."""
        return self._class_fid.get((path, cls_name, method_name))

    def resolve(self, path: str, cls_name: Optional[str], kind: str,
                base: Optional[str], name: str) -> Optional[str]:
        """Resolve one call event to a callee fid, or None. ``kind``
        is "self" | "bare" | "attr" (concur's event vocabulary)."""
        if kind == "self" and cls_name is not None:
            return self._class_fid.get((path, cls_name, name))
        if kind == "bare":
            if name in self._mod_fns.get(path, ()):
                return f"{path}::{name}"
            return None
        if kind == "attr" and base is not None:
            cls = self._singleton_cls.get(base)
            if cls is not None:
                paths = self._cls_paths.get(cls, [])
                if len(paths) != 1:
                    return None   # ambiguous class name: refuse
                return self._class_fid.get((paths[0], cls, name))
            fids = self._by_method.get(name, [])
            if len(fids) == 1:
                return fids[0]
        return None
