"""SLO report + error-budget gate over ``query_stats`` /
``slo_status`` / ``alert`` / ``incident`` ledger records.

The port's copy of the root ``tools/slo_report.py``, over
``pinot_tpu_torch/utils/slo.py``: same subcommands, flags, output and
exit codes. The SLO plane burns per-table/tenant error budgets over
paired fast/slow windows and fires latched burn-rate alerts, capturing
an incident bundle on each fire. This tool replays any ledger corpus
through the SAME pure evaluator (``plan_alert_stream`` — deterministic:
the same corpus yields the same verdict byte-for-byte) and gates it. It
reads ledgers only and touches no device.

    python -m pinot_tpu_torch.tools.slo_report report [ledger ...] \
        [--latency-bar-ms MS] [--availability-objective F] [--autopsy]
    python -m pinot_tpu_torch.tools.slo_report gate   [ledger ...] \
        [--latency-bar-ms MS] [--availability-objective F] \
        [--objective F] [--burn-threshold X] [--min-events N]

``report`` prints the per-objective burn table (fast/slow burn, budget
remaining, event/bad counts) for every table in the corpus plus the
recorded slo_status/alert/incident counts, one summary JSON line last.

``gate``: any objective whose slow-window burn reaches the threshold —
i.e. the corpus itself would have paged — fails with exit 1 and
``GATE FAIL:`` lines. ``--min-events`` (default 1) guards the
structurally vacuous green: a corpus with no ``query_stats`` records
means the forensics plane is broken, not that the SLOs are healthy.

``report --autopsy`` joins each captured incident to its
``rca_verdict`` record (``cluster/autopsy.py``) — one command answers
"what burned and why": the verdict's top cause, an explicit
``inconclusive``, or ``pending`` when attribution hasn't landed yet.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from ..utils.slo import (
    DEFAULT_BURN_THRESHOLD, DEFAULT_FAST_WINDOW_S,
    DEFAULT_OBJECTIVE, DEFAULT_SLOW_WINDOW_S, plan_alert_stream)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GATE_KINDS = ("query_stats", "slo_status", "alert", "incident")


def load_records(paths: List[str],
                 kinds: tuple = GATE_KINDS) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for path in paths:
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("kind") in kinds:
                    out.append(rec)
    return out


def autopsy_join(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The --autopsy section rows (pure, ledger order): each captured
    incident joined to its ``rca_verdict`` by ``incident_ref`` —
    verdicts keyed last-wins, the incident discipline's (proc, seq)
    identity making re-runs supersede. ``verdict`` is the top cause, an
    explicit ``inconclusive``, or ``pending`` when attribution hasn't
    landed (recorder hook unwired / still in flight)."""
    verdicts: Dict[str, Dict[str, Any]] = {}
    for r in records:
        if r.get("kind") == "rca_verdict" and r.get("incident_ref"):
            verdicts[str(r["incident_ref"])] = r
    rows: List[Dict[str, Any]] = []
    for r in records:
        if r.get("kind") != "incident":
            continue
        iid = str(r.get("incident_id") or "")
        v = verdicts.get(iid)
        if v is None:
            status = "pending"
        elif v.get("inconclusive"):
            status = "inconclusive"
        else:
            status = str(v.get("top_cause") or "")
        top = (v.get("causes") or [{}])[0] if v else {}
        rows.append({"incident_id": iid,
                     "alert": str(r.get("alert") or ""),
                     "severity": r.get("severity"),
                     "verdict": status,
                     "score": top.get("score"),
                     "detail": top.get("detail")})
    return rows


def build_objectives(records: List[Dict[str, Any]],
                     latency_bar_ms: Optional[float],
                     availability_objective: Optional[float],
                     objective: float,
                     fast_s: float, slow_s: float,
                     burn_threshold: float) -> List[Dict[str, Any]]:
    """One declared objective per table discovered in the corpus (pure,
    sorted — the determinism contract): a latency objective when a bar
    is configured, an availability objective when a target is. Tenant
    scopes come free — plan_alert_stream scopes on both."""
    tables = sorted({str(r["table"]) for r in records
                     if r.get("kind") == "query_stats"
                     and r.get("table")})
    objs: List[Dict[str, Any]] = []
    for t in tables:
        if latency_bar_ms is not None:
            objs.append({"scope": t, "kind": "latency",
                         "bar_ms": latency_bar_ms,
                         "objective": objective,
                         "fast_s": fast_s, "slow_s": slow_s,
                         "burn_threshold": burn_threshold})
        if availability_objective is not None:
            objs.append({"scope": t, "kind": "availability",
                         "objective": availability_objective,
                         "fast_s": fast_s, "slow_s": slow_s,
                         "burn_threshold": burn_threshold})
    return objs


def summarize(records: List[Dict[str, Any]],
              objectives: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Pure records -> report dict (the oracle tests pin this): the
    replayed burn table over the query_stats corpus + the counts of
    what the live plane actually recorded. Dedupes query_stats by
    (proc-less) identity is NOT needed — the stats corpus is per-query
    and a fleet ledger stamps ``node`` without duplicating lines."""
    stats = [r for r in records if r.get("kind") == "query_stats"]
    plan = (plan_alert_stream(stats, objectives) if objectives
            else {"alerts": [], "status": []})
    recorded = {k: sum(1 for r in records if r.get("kind") == k)
                for k in ("slo_status", "alert", "incident")}
    worst = max((row["burn_slow"] for row in plan["status"]),
                default=0.0)
    return {"queries": len(stats),
            "objectives": len(objectives),
            "alerts_planned": len(plan["alerts"]),
            "status": plan["status"],
            "worst_burn_slow": worst,
            "recorded": recorded}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["report", "gate"])
    ap.add_argument("ledgers", nargs="*",
                    help="ledger path(s); default: the repo "
                         "PERF_LEDGER.jsonl")
    ap.add_argument("--latency-bar-ms", type=float, default=None,
                    help="latency SLO bar in ms (omit: no latency "
                         "objective)")
    ap.add_argument("--availability-objective", type=float, default=None,
                    help="availability good-fraction target, e.g. 0.999 "
                         "(omit: no availability objective)")
    ap.add_argument("--objective", type=float, default=DEFAULT_OBJECTIVE,
                    help="latency good-fraction target "
                         "(default %(default)s — p99 <= bar)")
    ap.add_argument("--burn-threshold", type=float,
                    default=DEFAULT_BURN_THRESHOLD,
                    help="burn-rate alert threshold "
                         "(default %(default)sx)")
    ap.add_argument("--fast-s", type=float, default=DEFAULT_FAST_WINDOW_S)
    ap.add_argument("--slow-s", type=float, default=DEFAULT_SLOW_WINDOW_S)
    ap.add_argument("--min-events", type=int, default=1,
                    help="gate: minimum query_stats records for a "
                         "non-vacuous pass (default %(default)s)")
    ap.add_argument("--autopsy", action="store_true",
                    help="report: join each captured incident to its "
                         "rca_verdict (top cause / inconclusive / "
                         "pending)")
    args = ap.parse_intermixed_args(argv)

    ledgers = args.ledgers or [os.path.join(REPO, "PERF_LEDGER.jsonl")]
    kinds = GATE_KINDS + ("rca_verdict",) if args.autopsy else GATE_KINDS
    records = load_records(ledgers, kinds=kinds)
    objectives = build_objectives(
        records, args.latency_bar_ms, args.availability_objective,
        args.objective, args.fast_s, args.slow_s, args.burn_threshold)
    rep = summarize(records, objectives)

    if args.mode == "report":
        print(f"slo: {rep['queries']} queries, "
              f"{rep['objectives']} objective(s), "
              f"{rep['alerts_planned']} alert(s) would fire, "
              f"recorded {rep['recorded']}")
        for row in rep["status"]:
            print(f"  {row['scope']}/{row['kind']}: "
                  f"burn {row['burn_fast']}x/{row['burn_slow']}x "
                  f"budget {row['budget_remaining'] * 100:.1f}% "
                  f"({row['bad']}/{row['events']} bad)")
        extra: Dict[str, Any] = {}
        if args.autopsy:
            rows = autopsy_join(records)
            print(f"autopsy: {len(rows)} incident(s)")
            for row in rows:
                score = "" if row["score"] is None \
                    else f" ({row['score']})"
                print(f"  {row['incident_id']} [{row['alert']}/"
                      f"{row['severity']}]: {row['verdict']}{score}")
                if row["detail"]:
                    print(f"    {row['detail']}")
            extra["autopsy"] = {
                "incidents": len(rows),
                "attributed": sum(
                    1 for r in rows
                    if r["verdict"] not in ("pending", "inconclusive")),
                "inconclusive": sum(1 for r in rows
                                    if r["verdict"] == "inconclusive"),
                "pending": sum(1 for r in rows
                               if r["verdict"] == "pending")}
        print(json.dumps({"mode": "report", "ok": True,
                          **{k: rep[k] for k in
                             ("queries", "objectives", "alerts_planned",
                              "worst_burn_slow", "recorded")},
                          **extra}))
        return 0

    failures: List[str] = []
    if rep["queries"] < args.min_events:
        failures.append(
            f"vacuous: only {rep['queries']} query_stats record(s) "
            f"(< {args.min_events}) — forensics plane or corpus broken")
    for row in rep["status"]:
        if row["events"] and row["burn_slow"] >= args.burn_threshold:
            failures.append(
                f"{row['scope']}/{row['kind']} burned "
                f"{row['burn_slow']}x >= {args.burn_threshold}x "
                f"({row['bad']}/{row['events']} bad, budget "
                f"{row['budget_remaining'] * 100:.1f}% left)")
    for f in failures:
        print(f"GATE FAIL: {f}", file=sys.stderr)
    print(json.dumps({"mode": "gate", "ok": not failures,
                      "queries": rep["queries"],
                      "objectives": rep["objectives"],
                      "alerts_planned": rep["alerts_planned"],
                      "worst_burn_slow": rep["worst_burn_slow"],
                      "burn_threshold": args.burn_threshold,
                      "recorded": rep["recorded"],
                      "failures": failures}))
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
