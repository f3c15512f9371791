"""Freshness regression gate: ``ingest_bench`` ledger records diffed
against a checked-in baseline — the ingest plane's ratchet, built the
way ``span_diff`` ratchets query phases.

The port's copy of the root ``tools/freshness_gate.py``, over
``pinot_tpu_torch.engine.loadgen``: same subcommands, flags, output and
exit codes; its baseline is the port's own
``pinot_tpu_torch/tools/freshness_baseline.json``, captured on the card.

- ``capture``  runs the deterministic gate corpus — a drain-mode
  loadgen run (2 tables x 2 partitions, mem transport, seeded rows,
  concurrent query mix, no chaos) on ``--device`` — ``--iters`` times,
  appending one validated ``ingest_bench`` record per iteration;
- ``update``   aggregates records into the baseline: per scenario, the
  median run wall and the median of each gated metric (freshness
  p50/p99, commit p50/p99);
- ``check``    re-aggregates a candidate ledger and FAILS (exit 1) when
  a gated metric's speed-calibrated value exceeds ``--bar`` x baseline.

Speed calibration: freshness scales with machine speed, so raw ms would
flag a loaded box. ``check`` computes one calibration factor — the
median of cand_wall/base_wall over common scenarios (the corpus is
drain-mode, so its wall IS a machine-speed probe), clamped to [0.2, 5]
— and divides every candidate metric by it. A uniformly slower machine
moves wall and freshness together and cancels; a freshness-only
regression moves the metric without the wall and trips. A calibration
pinned at the clamp bounds means the environments are not comparable:
the check reports an explicit skip (ok, ``calibration_saturated``),
never a phantom regression. Per-metric noise floors (MIN_MS) keep
sub-floor-vs-sub-floor jitter from tripping while still catching a
tiny metric regressing to something large (the span_diff floor rule).

Environment pinning reuses span_diff's header verbatim: ``update``
stamps the torch device, the card's name and power limit and the torch
version, and ``check`` exits 3 when the ``--device`` it is given (and on
CUDA the card) differs.

    python -m pinot_tpu_torch.tools.freshness_gate capture --out F.jsonl \
        [--iters 3] [--device cuda|cpu]
    python -m pinot_tpu_torch.tools.freshness_gate update  F.jsonl
    python -m pinot_tpu_torch.tools.freshness_gate check   F.jsonl [--bar 1.8]

``--device`` defaults to ``cuda``; without a card every mode refuses
(exit 2) unless ``--device cpu`` is given. Exit 0 green / 1 regression
/ 2 usage / 3 environment mismatch; one summary JSON line last.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
from typing import Any, Dict, List, Optional

from ..device import tool_device
from . import span_diff

REPO = span_diff.REPO
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "freshness_baseline.json")
DEFAULT_BAR = 1.8          # < 2.0 so a 2x single-metric regression fails
DEFAULT_LAST = 5           # newest records per scenario (append-only
#                            ledgers must not out-vote a fresh regression)
EXIT_ENV_MISMATCH = 3

# gated metrics with per-metric noise floors (ms): freshness on the mem
# transport is sub-ms, so its floor sits well below it; commit latency
# includes a segment build and lives in the tens of ms
MIN_MS = {
    "freshness_p50_ms": 0.05,
    "freshness_p99_ms": 0.10,
    "commit_p50_ms": 1.0,
    "commit_p99_ms": 2.0,
}

GATE_SCENARIO = "gate_corpus"
GATE_SEED = 20260805
GATE_ROWS = 1200           # per partition; drain mode — wall is the
#                            machine-speed probe the calibration uses


def corpus_config(ledger_path: str, rows: int = GATE_ROWS,
                  seed: int = GATE_SEED):
    """The deterministic gate corpus (shared by capture and the tests
    so the checked-in baseline and the gate measure the same run shape;
    the JAX tool's config). Mem transport: the gate ratchets ENGINE
    freshness, not protocol-fake socket throughput."""
    from ..engine.loadgen import LoadgenConfig, TableLoadSpec
    return LoadgenConfig(
        tables=[
            TableLoadSpec("fg_append", partitions=2, threshold=96),
            TableLoadSpec("fg_upsert", partitions=2, upsert=True,
                          protocol=True, threshold=96),
        ],
        seed=seed, rows_per_partition=rows, query_concurrency=2,
        scenario=GATE_SCENARIO, ledger_path=ledger_path)


def capture(out_path: str, iters: int = 3, rows: int = GATE_ROWS,
            device: Any = "cuda") -> int:
    """Run the corpus on ``device`` ``iters`` times (fresh data dir each
    — a reused checkpoint would make later iterations consume nothing),
    appending one ingest_bench record per run. Returns records
    appended."""
    from ..engine.loadgen import run_load
    n = 0
    for i in range(iters):
        tmp = tempfile.mkdtemp(prefix="ptpu_fgate_")
        try:
            summary = run_load(tmp, corpus_config(out_path, rows=rows),
                               device=device)
            if not summary.get("ok"):
                raise RuntimeError(
                    f"gate corpus run {i} failed: "
                    f"{summary.get('error', 'oracle mismatch')}")
            n += 1
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return n


# ---------------------------------------------------------------------------
# aggregation + diff
# ---------------------------------------------------------------------------

def load_bench_records(paths: List[str]) -> List[Dict[str, Any]]:
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
                if isinstance(rec, dict) \
                        and rec.get("kind") == "ingest_bench" \
                        and rec.get("ok") and rec.get("scenario"):
                    out.append(rec)
    return out


def aggregate(records: List[Dict[str, Any]],
              last: Optional[int] = DEFAULT_LAST) -> Dict[str, Any]:
    """records -> {scenario: {n, wall_s, metrics: {name: ms}}} with
    per-scenario medians over the NEWEST ``last`` records."""
    by_s: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        by_s.setdefault(str(rec["scenario"]), []).append(rec)
    if last is not None and last > 0:
        by_s = {k: v[-last:] for k, v in by_s.items()}
    out: Dict[str, Any] = {}
    for s, recs in sorted(by_s.items()):
        walls = [float(r.get("duration_s", 0.0)) for r in recs
                 if float(r.get("duration_s", 0.0)) > 0]
        if not walls:
            continue
        metrics: Dict[str, float] = {}
        for m in MIN_MS:
            vals = [float(r[m]) for r in recs
                    if isinstance(r.get(m), (int, float))]
            if vals:
                metrics[m] = round(statistics.median(vals), 3)
        out[s] = {"n": len(recs),
                  "wall_s": round(statistics.median(walls), 4),
                  "metrics": metrics}
    return out


def speed_calibration(baseline: Dict[str, Any],
                      candidate: Dict[str, Any]) -> float:
    ratios = [candidate[k]["wall_s"] / baseline[k]["wall_s"]
              for k in set(baseline) & set(candidate)
              if baseline[k]["wall_s"] > 0]
    if not ratios:
        return 1.0
    return min(max(statistics.median(ratios), 0.2), 5.0)


def diff_scenarios(baseline: Dict[str, Any], candidate: Dict[str, Any],
                   bar: float) -> Dict[str, Any]:
    cal = speed_calibration(baseline, candidate)
    regressions: List[Dict[str, Any]] = []
    checked = 0
    for s, cand in candidate.items():
        base = baseline.get(s)
        if base is None:
            continue
        for m, c_ms in cand["metrics"].items():
            b_ms = base["metrics"].get(m)
            if b_ms is None:
                continue
            floor = MIN_MS[m]
            adj = c_ms / cal
            if adj < floor:
                continue               # noise floor: candidate tiny
            eff_base = max(b_ms, floor)  # tiny baselines floored, not
            checked += 1                 # exempted (span_diff rule)
            if adj > bar * eff_base:
                regressions.append({
                    "scenario": s, "metric": m,
                    "base_ms": b_ms, "cand_ms": c_ms,
                    "calibrated_ms": round(adj, 3),
                    "ratio": round(adj / eff_base, 3),
                })
    return {
        "calibration": round(cal, 4),
        "calibration_saturated": cal in (0.2, 5.0),
        "checked_metrics": checked,
        "regressions": regressions,
        "new_scenarios": sorted(set(candidate) - set(baseline)),
        "missing_scenarios": sorted(set(baseline) - set(candidate)),
    }


# ---------------------------------------------------------------------------
# baseline io + CLI
# ---------------------------------------------------------------------------

def load_baseline(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


def write_baseline(path: str, scenarios: Dict[str, Any],
                   env: Dict[str, Any]) -> None:
    with open(path, "w") as fh:
        json.dump({"v": 1, "bar": DEFAULT_BAR, "min_ms": MIN_MS,
                   "env": env,
                   "scenarios": scenarios}, fh, indent=1, sort_keys=True)
        fh.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["check", "update", "capture"])
    ap.add_argument("ledgers", nargs="*",
                    help="ingest_bench ledger path(s); default: the "
                         "repo PERF_LEDGER.jsonl")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--bar", type=float, default=DEFAULT_BAR)
    ap.add_argument("--last", type=int, default=DEFAULT_LAST)
    ap.add_argument("--out", default=None,
                    help="capture mode: the ledger to append to")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--rows", type=int, default=GATE_ROWS)
    ap.add_argument("--device", default="cuda",
                    help="the device the corpus runs on (capture) and "
                         "the environment checked against the "
                         "baseline's (default %(default)s)")
    args = ap.parse_intermixed_args(argv)
    device = tool_device(args.device)
    if device is None:
        return 2

    if args.mode == "capture":
        if not args.out:
            print("capture requires --out", file=sys.stderr)
            return 2
        n = capture(args.out, iters=args.iters, rows=args.rows,
                    device=device)
        print(json.dumps({"mode": "capture", "out": args.out,
                          "records": n, "ok": True}))
        return 0

    ledgers = args.ledgers or [os.path.join(REPO, "PERF_LEDGER.jsonl")]
    records = load_bench_records(ledgers)

    if args.mode == "update":
        scenarios = aggregate(records, last=args.last or None)
        env = span_diff.capture_env(device)
        rec_backends = {r.get("backend") for r in records} - {None}
        if rec_backends and rec_backends != {env["backend"]}:
            print(f"refusing to update: records captured on backend(s) "
                  f"{sorted(rec_backends)} but the current environment "
                  f"is {env['backend']!r} — re-run capture+update in "
                  f"one environment", file=sys.stderr)
            return 2
        write_baseline(args.baseline, scenarios, env)
        print(json.dumps({"mode": "update", "baseline": args.baseline,
                          "records": len(records), "env": env,
                          "scenarios": len(scenarios), "ok": True}))
        return 0

    if not os.path.exists(args.baseline):
        print(json.dumps({"mode": "check", "ok": True,
                          "skipped": f"no baseline at {args.baseline}"}))
        return 0
    data = load_baseline(args.baseline)
    mismatch = span_diff.env_mismatch(data.get("env"), device)
    if mismatch:
        print("ENVIRONMENT MISMATCH vs baseline "
              f"{os.path.basename(args.baseline)}: "
              + "; ".join(f"{k}: baseline={b!r} current={c!r}"
                          for k, (b, c) in sorted(mismatch.items()))
              + " — re-capture in this environment (capture + update)",
              file=sys.stderr)
        print(json.dumps({"mode": "check", "ok": False,
                          "env_mismatch": mismatch}))
        return EXIT_ENV_MISMATCH

    scenarios = aggregate(records, last=args.last or None)
    res = diff_scenarios(data.get("scenarios", {}), scenarios, args.bar)
    if res["calibration_saturated"]:
        # >5x-off wall: this machine/config is not comparable to the
        # baseline capture — an explicit skip, never a phantom red
        print(json.dumps({"mode": "check", "ok": True,
                          "skipped": "speed calibration saturated "
                                     f"({res['calibration']}) — "
                                     "re-capture the baseline here",
                          **res}))
        return 0
    for r in res["regressions"]:
        print(f"FRESHNESS REGRESSION {r['scenario']} {r['metric']}: "
              f"ms {r['base_ms']} -> {r['cand_ms']} "
              f"(calibrated {r['calibrated_ms']}, "
              f"{r['ratio']}x > bar {args.bar})")
    ok = not res["regressions"]
    print(json.dumps({"mode": "check", "bar": args.bar,
                      "records": len(records),
                      "scenarios_checked": len(
                          set(scenarios) & set(data.get("scenarios", {}))),
                      **res, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
