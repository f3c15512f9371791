"""Static analysis gate over the port: concurrency verifier +
determinism verifier + plan-IR verifier.

Runs the three passes of pinot_tpu_torch/analysis and exits non-zero
on anything new:

1. **Concurrency verifier** (analysis/concur.py, rules CC201-CC205:
   mixed-guard, blocking-under-lock (torch device syncs included),
   lock-order cycles, thread-local escape, check-then-act) over the
   whole ``pinot_tpu_torch/`` tree, ratcheted against
   ``pinot_tpu_torch/analysis/concur_baseline.json``: new findings
   above a ``file::scope::rule`` count fail; counts that DROP also fail
   until the baseline is ratcheted down (run with
   ``--update-baseline`` after fixing sites).
2. **Determinism verifier** (analysis/detlint.py, rules DT301-DT305:
   wall-clock, ambient RNG (torch's global generator included),
   unordered serialization, query-time environ, completion-order float
   accumulation) — whole-program: taint propagates from the
   deterministic-plane entry registry through the package's call
   graph, ratcheted against
   ``pinot_tpu_torch/analysis/detlint_baseline.json``.
3. **Plan verifier** (analysis/plan_verify.py) over every plan the
   port's planner produces for the SSB query set (tools/ssb.py), the
   NYC-taxi set (tools/taxi.py) and ``--fuzz N`` seeded
   fuzzer-generated queries (tools/fuzzer.py) — at CI scale, plan-only:
   the segments load into host memory and no kernel runs, so the gate
   needs no card. Any error diagnostic fails.

``--changed`` is the fast pre-commit mode: the two lint passes still
analyze the whole program (detlint's reachability needs the full call
graph) but findings and baselines are restricted to git-changed .py
files, and the plan verifier is skipped.

Prints one summary JSON line last; ``--json`` instead prints exactly
one machine-readable JSON document (per-rule finding counts, file/line
per finding, suppressed/baselined split per pass).

    python -m pinot_tpu_torch.tools.check_static [--concur-only |
        --detlint-only | --verify-only] [--changed] [--update-baseline]
        [--fuzz N] [--json]
"""
from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

from ..analysis import concur, detlint
from ..analysis.astutil import PACKAGE, compare_baseline, load_baseline

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG_DIR)
CONCUR_BASELINE = os.path.join(PKG_DIR, "analysis", "concur_baseline.json")
DETLINT_BASELINE = os.path.join(PKG_DIR, "analysis",
                                "detlint_baseline.json")
FUZZ_SEED = 20260804
OPTION = " OPTION(timeoutMs=600000)"

EXIT_CODES = """\
exit codes:
  0  clean: no findings beyond the committed ratchet baselines, no
     stale baseline counts, no plan diagnostics or coverage failures
  1  gate failure: new concur/detlint findings above a baseline count,
     a baseline count that no longer matches (ratchet it down), a plan
     verifier diagnostic, or lost corpus coverage
  2  usage error (bad arguments)

The two ratchet baselines (pinot_tpu_torch/analysis/concur_baseline.json,
pinot_tpu_torch/analysis/detlint_baseline.json) grandfather
true-but-benign findings per file::scope::rule; regenerate with
--update-baseline (combine with --concur-only / --detlint-only to
re-ratchet one of them)."""


def _changed_files() -> List[str]:
    """Repo-relative .py files of the package changed vs HEAD (staged +
    unstaged + untracked) — the --changed reporting scope."""
    paths: List[str] = []
    for cmd in (["git", "-C", REPO, "diff", "--name-only", "HEAD"],
                ["git", "-C", REPO, "ls-files", "--others",
                 "--exclude-standard"]):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 check=True).stdout
        except (OSError, subprocess.SubprocessError):
            continue
        paths.extend(p.strip() for p in out.splitlines() if p.strip())
    return sorted({p for p in paths
                   if p.endswith(".py") and p.startswith(PACKAGE + "/")})


def _ratchet_pass(findings, suppressed, baseline_path: str, update: bool,
                  label: str, write_baseline,
                  paths: Optional[List[str]] = None) -> Dict:
    """Shared concur/detlint ratchet flow -> summary dict (+ the
    machine-readable details for --json). ``paths`` (the --changed
    scope) restricts findings AND baseline keys to those files."""
    if update:
        write_baseline(findings, baseline_path)
    baseline = load_baseline(baseline_path)
    if paths is not None:
        scope = set(paths)
        findings = [f for f in findings if f.path in scope]
        suppressed = [f for f in suppressed if f.path in scope]
        baseline = {k: v for k, v in baseline.items()
                    if k.split("::", 1)[0] in scope}
    new, stale = compare_baseline(findings, baseline)
    for f in new:
        print(f"NEW [{label}] {f}")
    for key, allowed, actual in stale:
        print(f"STALE [{label}] {key}: baseline {allowed}, found "
              f"{actual} — ratchet down with --update-baseline")
    rules: Dict[str, int] = {}
    for f in findings:
        rules[f.rule] = rules.get(f.rule, 0) + 1
    out = {"findings": len(findings), "new": len(new),
           "stale": len(stale), "suppressed": len(suppressed),
           "baselined": len(findings) - len(new), "rules": rules}
    if update:
        out["updated"] = True
    out["_details"] = {
        "findings": [{"rule": f.rule, "file": f.path, "line": f.line,
                      "scope": f.scope, "message": f.message,
                      "baselined": f not in new}
                     for f in findings],
        "suppressed": [{"rule": f.rule, "file": f.path, "line": f.line,
                        "scope": f.scope} for f in suppressed],
        "stale": [{"key": k, "baseline": a, "found": n}
                  for k, a, n in stale],
    }
    return out


def run_concur(update_baseline: bool = False, paths=None) -> Dict:
    findings, suppressed = concur.analyze_tree(REPO)
    return _ratchet_pass(findings, suppressed, CONCUR_BASELINE,
                         update_baseline, "concur",
                         concur.write_baseline, paths)


def run_detlint(update_baseline: bool = False, paths=None) -> Dict:
    findings, suppressed = detlint.analyze_tree(REPO)
    return _ratchet_pass(findings, suppressed, DETLINT_BASELINE,
                         update_baseline, "detlint",
                         detlint.write_baseline, paths)


def _verify_corpus(label: str, segment, sqls, counts: Dict,
                   diags: list) -> None:
    from ..analysis.plan_verify import verify_compiled_plan
    from ..query.context import build_query_context
    from ..query.planner import PlanError, SegmentPlanner
    from ..query.sql import SqlError, parse_sql

    for sql in sqls:
        counts["queries"] += 1
        try:
            ctx = build_query_context(parse_sql(sql))
            plan = SegmentPlanner(ctx, segment).plan()
        except (PlanError, SqlError) as e:
            # multi-table / window shapes that never reach the segment
            # planner — not this gate's surface, but printed so a
            # planner regression demoting whole corpora is visible
            counts["skipped"] += 1
            print(f"SKIP [{label}] {type(e).__name__}: {e}\n"
                  f"  query: {sql}")
            continue
        counts["plans"] += 1
        if plan.kind in ("kernel", "kselect"):
            counts["device_plans"] = counts.get("device_plans", 0) + 1
            counts[plan.kind] = counts.get(plan.kind, 0) + 1
        for d in verify_compiled_plan(plan):
            diags.append((label, sql, d))


def run_verify(fuzz_n: int) -> Dict:
    from ..segment.immutable import ImmutableSegment
    from . import ssb, taxi
    from .fuzzer import QueryGenerator, build_fuzz_segment, render_sql

    corpora: Dict[str, Dict] = {}
    diags: list = []
    with tempfile.TemporaryDirectory() as tmp:
        seg = ImmutableSegment.load(
            ssb.build_segment_dir(1 << 12, os.path.join(tmp, "ssb")),
            "cpu")
        corpora["ssb"] = {"queries": 0, "plans": 0, "skipped": 0}
        _verify_corpus(
            "ssb", seg,
            [ssb.spec_to_sql(p, v, g) + OPTION
             for _q, p, v, g in ssb.QUERIES],
            corpora["ssb"], diags)

        seg_t = ImmutableSegment.load(
            taxi.build_segment_dir(1 << 12, os.path.join(tmp, "taxi")),
            "cpu")
        corpora["taxi"] = {"queries": 0, "plans": 0, "skipped": 0}
        _verify_corpus(
            "taxi", seg_t,
            [taxi.sql(k, w) + OPTION for _q, k, w in taxi.QUERIES],
            corpora["taxi"], diags)

        seg_f = build_fuzz_segment(2000, tmp, device="cpu")
        gen = QueryGenerator(FUZZ_SEED, with_exists=False)
        corpora["fuzz"] = {"queries": 0, "plans": 0, "skipped": 0}
        _verify_corpus(
            "fuzz", seg_f,
            [render_sql(gen.generate()) for _ in range(fuzz_n)],
            corpora["fuzz"], diags)

    warns = [(lb, s, d) for lb, s, d in diags if d.severity != "error"]
    diags = [(lb, s, d) for lb, s, d in diags if d.severity == "error"]
    for label, sql, d in diags:
        print(f"DIAG [{label}] {d}\n  query: {sql}")
    for label, sql, d in warns:
        print(f"WARN [{label}] {d}\n  query: {sql}")
    detail = {
        "diagnostics": [{"corpus": lb, "rule": d.rule, "path": d.path,
                         "message": d.message, "query": s}
                        for lb, s, d in diags],
        "warnings": [{"corpus": lb, "rule": d.rule, "path": d.path,
                      "message": d.message, "query": s}
                     for lb, s, d in warns],
    }

    # anti-vacuous-pass floors: zero diagnostics only counts if the
    # verifier actually saw the plans it claims to cover. Every SSB and
    # taxi query must reach a device (kernel/kselect) plan, and the
    # fuzzer corpus must surface a healthy device-plan share.
    coverage: List[str] = []
    for label in ("ssb", "taxi"):
        c = corpora[label]
        if c["skipped"] or c.get("device_plans", 0) != c["queries"]:
            coverage.append(
                f"{label}: {c.get('device_plans', 0)}/{c['queries']} "
                f"device plans ({c['skipped']} skipped) — the corpus "
                "regressed off the kernel path, verifier coverage lost")
    if corpora["fuzz"]["queries"] and \
            corpora["fuzz"].get("device_plans", 0) < max(
                corpora["fuzz"]["queries"] // 10, 1):
        coverage.append(
            f"fuzz: only {corpora['fuzz'].get('device_plans', 0)} of "
            f"{corpora['fuzz']['queries']} queries reached a device "
            "plan — generator or planner drift gutted coverage")
    for msg in coverage:
        print(f"COVERAGE {msg}")
    detail["coverage"] = coverage

    out: Dict = {"queries": 0, "plans": 0, "skipped": 0,
                 "device_plans": 0}
    for c in corpora.values():
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    out["diagnostics"] = len(diags)
    out["warnings"] = len(warns)
    out["coverage_failures"] = len(coverage)
    out["_details"] = detail
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pinot_tpu_torch.tools.check_static",
        description=__doc__,
        epilog=EXIT_CODES,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--concur-only", action="store_true",
                      help="run only the concurrency verifier pass")
    only.add_argument("--detlint-only", action="store_true",
                      help="run only the determinism verifier pass")
    only.add_argument("--verify-only", action="store_true",
                      help="run only the plan-IR verifier pass")
    ap.add_argument("--changed", action="store_true",
                    help="fast pre-commit mode: restrict concur/detlint "
                         "findings and baselines to git-changed .py "
                         "files of the package (analysis still covers "
                         "the whole program) and skip the plan verifier")
    ap.add_argument("--update-baseline", action="store_true",
                    help="re-ratchet the baseline(s) of the passes "
                         "being run (concur/detlint), then re-compare; "
                         "parse errors stay red")
    ap.add_argument("--fuzz", type=int, default=150, metavar="N",
                    help="fuzzer queries for the plan verifier "
                         "(default 150)")
    ap.add_argument("--json", action="store_true",
                    help="print exactly one machine-readable JSON "
                         "document (per-rule counts, file/line per "
                         "finding, suppressed/baselined split) "
                         "instead of the line-oriented report")
    args = ap.parse_args(argv)
    if args.changed and args.verify_only:
        ap.error("--changed skips the plan verifier; it cannot be "
                 "combined with --verify-only")
    if args.changed and args.update_baseline:
        ap.error("--update-baseline needs the full-corpus view; it "
                 "cannot be combined with --changed")

    changed = _changed_files() if args.changed else None

    # --json buffers the human chatter so stdout is ONE JSON document
    out_buf = None
    real_stdout = sys.stdout
    if args.json:
        out_buf = io.StringIO()
        sys.stdout = out_buf

    lint_passes = (
        ("concur", args.concur_only, run_concur),
        ("detlint", args.detlint_only, run_detlint),
    )
    any_only = args.concur_only or args.detlint_only or args.verify_only
    summary: Dict = {}
    rc = 0
    try:
        if changed is not None:
            summary["changed"] = changed
        for sec, only_flag, runner in lint_passes:
            if (any_only and not only_flag) or \
                    (changed is not None and not changed):
                continue
            summary[sec] = runner(args.update_baseline, changed)
            if summary[sec]["new"] or summary[sec]["stale"]:
                rc = 1
        if (not any_only or args.verify_only) and changed is None:
            summary["verify"] = run_verify(args.fuzz)
            if summary["verify"]["diagnostics"] or \
                    summary["verify"]["coverage_failures"]:
                rc = 1
    finally:
        if out_buf is not None:
            sys.stdout = real_stdout
    summary["ok"] = rc == 0
    if args.json:
        # the per-finding records land under "detail": a failing run
        # must be actionable from the JSON alone, since the line report
        # was swallowed by the buffer
        for sec in ("concur", "detlint", "verify"):
            if sec in summary and "_details" in summary[sec]:
                summary[sec]["detail"] = summary[sec].pop("_details")
        print(json.dumps(summary, indent=1))
    else:
        for sec in ("concur", "detlint", "verify"):
            summary.get(sec, {}).pop("_details", None)
        print(json.dumps(summary))
    return rc


if __name__ == "__main__":
    sys.exit(main())
