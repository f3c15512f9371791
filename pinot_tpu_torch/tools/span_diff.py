"""Span-diff regression gate: per-phase timings from ``query_trace``
ledger records, diffed against a checked-in per-query-shape baseline.

The port's copy of the root ``tools/span_diff.py``, over
``pinot_tpu_torch``: same subcommands, flags, output and exit codes; its
baseline is the port's own ``pinot_tpu_torch/tools/span_baseline.json``,
captured on the card.

- ``capture``  runs a small deterministic query corpus (in-process
  broker on ``--device``, seeded 2-segment table, traceRatio=1.0) and
  appends one validated ``query_trace`` record per query iteration to a
  ledger;
- ``update``   aggregates records into the baseline: per query shape
  (normalized-SQL hash), the median wall ms and per root-phase median
  ms;
- ``check``    re-aggregates a candidate ledger and FAILS (exit 1) when
  a phase's speed-calibrated ms exceeds ``--bar`` x its baseline ms.

Speed calibration: raw ms would flag a uniformly loaded/slower machine
as a regression, so check first computes one per-run calibration factor
— the median of cand_wall/base_wall over the common shapes, clamped to
[0.2, 5] — and divides every candidate phase by it. A global speed
shift moves every wall equally and cancels; a single phase regressing
2x in one shape barely moves the cross-shape median, so it trips the
bar. (A regression hitting the dominant phase of EVERY shape at once
would be absorbed into the calibration.) Candidate phases below
``--min-ms`` are skipped and sub-ms baselines are floored at
``--min-ms`` (sub-ms-vs-sub-ms jitter cannot trip the bar, but a tiny
phase regressing to something large still does), and medians over the
capture iterations absorb per-run jitter. Edit the corpus or materially
change an engine phase's cost profile and re-capture with ``update`` —
on the device the baseline names.

    python -m pinot_tpu_torch.tools.span_diff capture --out T.jsonl \
        [--iters 5] [--device cuda|cpu]
    python -m pinot_tpu_torch.tools.span_diff update  T.jsonl
    python -m pinot_tpu_torch.tools.span_diff check   T.jsonl [--bar 1.7]
    python -m pinot_tpu_torch.tools.span_diff check --fleet fleet.jsonl

Environment pinning: ``update`` stamps the capture environment into the
baseline header — the torch device type (``backend``), the card's name
and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them, and the torch version — and
``check`` FAILS LOUDLY (exit 3) when the current environment (the
``--device`` it is given, and on CUDA the card) differs: a CPU candidate
against a card baseline exits 3, never 1. The JAX tool stamps
``JAX_PLATFORMS``/x64/backend instead.

Fleet mode: ``check --fleet`` groups a fleet ledger's ``query_trace``
records by their ``node`` provenance stamp (``cluster/rollup.py``) and
runs the diff PER NODE, each with its own speed calibration — a
heterogeneous fleet must not false-trip the ratchet, while a single
node's single phase regressing still does.

``--device`` defaults to ``cuda``; without a card every mode refuses
(exit 2) unless ``--device cpu`` is given. Exit 0 when no phase
regresses; one summary JSON line last.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Any, Dict, List, Optional, Tuple

from ..device import tool_device
from ..utils.shapehash import shape_key

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "span_baseline.json")
DEFAULT_BAR = 1.7          # < 2.0 so a 2x single-phase slowdown fails
DEFAULT_MIN_MS = 1.0       # sub-ms phases are timing noise, not signal
# the explicit self-time filler (query/explain.finalize_analyze) and the
# sampled-root gap are residuals, not phases a kernel change regresses
EXCLUDE_PHASES = {"broker_overhead"}
EXIT_ENV_MISMATCH = 3      # distinct from a phase regression (exit 1)


def card_line() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    for the first card, or None where it does not answer."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0].strip() if out else None


def capture_env(device: Any = "cuda") -> Dict[str, Any]:
    """The calibration-relevant environment of a run on ``device``,
    recorded into the baseline header by ``update`` and enforced by
    ``check``: the torch device type (``backend``, what the port's
    records stamp), the card's name and power limit (``nvidia-smi``; the
    card's name from torch where it does not answer), the torch
    version."""
    import torch

    dev = torch.device(device)
    env: Dict[str, Any] = {"backend": dev.type, "card": None,
                           "power_limit": None,
                           "torch": torch.__version__}
    if dev.type == "cuda":
        line = card_line()
        if line and "," in line:
            name, limit = line.rsplit(",", 1)
            env["card"], env["power_limit"] = name.strip(), limit.strip()
        else:
            env["card"] = torch.cuda.get_device_name(dev)
    return env


def env_mismatch(baseline_env: Optional[Dict[str, Any]],
                 device: Any = "cuda") -> Optional[Dict[str, Any]]:
    """None when a run on ``device`` matches the baseline header (or
    the header predates env pinning); otherwise {field: [baseline,
    current]}. The device type is compared first, then the card's name:
    a baseline from one card is not a bar for another."""
    if not baseline_env:
        return None
    cur = capture_env(device)
    for k in ("backend", "card"):
        if baseline_env.get(k) != cur.get(k):
            return {k: [baseline_env.get(k), cur.get(k)]}
    return None


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def load_trace_records(paths: List[str]) -> List[Dict[str, Any]]:
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
                if isinstance(rec, dict) and \
                        rec.get("kind") == "query_trace" and \
                        rec.get("root") and rec.get("sql"):
                    out.append(rec)
    return out


def phase_times(root: Dict[str, Any]) -> Tuple[float, Dict[str, float]]:
    """-> (wall_ms, {phase: ms}) over the root's DIRECT children,
    summed by name (the utils/phases.py vocabulary level — coarse and
    rename-stable; kernel-internal spans stay out of the gate)."""
    wall = float(root.get("ms", 0.0))
    phases: Dict[str, float] = {}
    for c in root.get("children") or []:
        name = c.get("name", "?")
        if name in EXCLUDE_PHASES:
            continue
        phases[name] = phases.get(name, 0.0) + float(c.get("ms", 0.0))
    return wall, phases


DEFAULT_LAST = 5           # = capture --iters: one capture run's worth


def aggregate(records: List[Dict[str, Any]],
              last: Optional[int] = DEFAULT_LAST) -> Dict[str, Any]:
    """records -> {shape: {sql, n, wall_ms, phases: {name: {ms}}}}
    with per-shape medians over the NEWEST ``last`` records of that
    shape (ledgers are append-only, so file order is chronological —
    without the cutoff a fresh regression's handful of slow records
    would be out-voted by the shape's accumulated history and the
    median would stay green)."""
    by_shape: Dict[str, List[Dict[str, Any]]] = {}
    sqls: Dict[str, str] = {}
    for rec in records:
        k = shape_key(rec["sql"])
        by_shape.setdefault(k, []).append(rec)
        sqls.setdefault(k, rec["sql"][:160])
    if last is not None and last > 0:
        by_shape = {k: recs[-last:] for k, recs in by_shape.items()}
    out: Dict[str, Any] = {}
    for k, recs in sorted(by_shape.items()):
        walls: List[float] = []
        per_phase: Dict[str, List[float]] = {}
        for rec in recs:
            wall, phases = phase_times(rec["root"])
            if wall <= 0:
                continue
            walls.append(wall)
            for name, ms in phases.items():
                per_phase.setdefault(name, []).append(ms)
        if not walls:
            continue
        out[k] = {
            "sql": sqls[k],
            "n": len(walls),
            "wall_ms": round(statistics.median(walls), 3),
            "phases": {
                name: {"ms": round(statistics.median(vals), 3)}
                for name, vals in sorted(per_phase.items())},
        }
    return out


# ---------------------------------------------------------------------------
# diff
# ---------------------------------------------------------------------------

def speed_calibration(baseline: Dict[str, Any],
                      candidate: Dict[str, Any]) -> float:
    """Per-run machine-speed factor: median cand_wall/base_wall over
    the common shapes, clamped — a uniformly slower/faster environment
    scales every wall and cancels out of the per-phase comparison,
    while a one-shape one-phase regression barely moves the median."""
    ratios = [candidate[k]["wall_ms"] / baseline[k]["wall_ms"]
              for k in set(baseline) & set(candidate)
              if baseline[k]["wall_ms"] > 0]
    if not ratios:
        return 1.0
    return min(max(statistics.median(ratios), 0.2), 5.0)


def diff_shapes(baseline: Dict[str, Any], candidate: Dict[str, Any],
                bar: float, min_ms: float) -> Dict[str, Any]:
    cal = speed_calibration(baseline, candidate)
    regressions: List[Dict[str, Any]] = []
    checked = 0
    for k, cand in candidate.items():
        base = baseline.get(k)
        if base is None:
            continue
        for name, c in cand["phases"].items():
            b = base["phases"].get(name)
            if b is None:
                continue
            adj = c["ms"] / cal
            if adj < min_ms:
                continue  # noise floor: the candidate itself is sub-ms
            # a sub-ms BASELINE must not exempt the phase forever (a
            # 0.4ms planning phase regressing to 8ms is real): floor the
            # baseline at min_ms instead, so large regressions of tiny
            # phases trip while sub-ms-vs-sub-ms jitter cannot
            eff_base = max(b["ms"], min_ms)
            checked += 1
            if adj > bar * eff_base:
                regressions.append({
                    "shape": k, "sql": cand.get("sql", "")[:80],
                    "phase": name,
                    "base_ms": b["ms"], "cand_ms": c["ms"],
                    "calibrated_ms": round(adj, 3),
                    "ratio": round(adj / eff_base, 3),
                })
    return {
        "calibration": round(cal, 4),
        "checked_phases": checked,
        "regressions": regressions,
        "new_shapes": sorted(set(candidate) - set(baseline)),
        "missing_shapes": sorted(set(baseline) - set(candidate)),
    }


# ---------------------------------------------------------------------------
# capture: deterministic corpus -> query_trace ledger
# ---------------------------------------------------------------------------

# the capture corpus: small, deterministic, and shaped to hit the
# distinct engine paths (compact group-by, dense group-by, scalar agg,
# device selection). The SQL text IS the shape key — edit a query and
# the baseline must be re-captured (`update`). The same corpus as the
# JAX tool's, so the two baselines key the same shapes.
CORPUS_SQL = [
    ("groupby_highcard",
     "SELECT hk, SUM(v), COUNT(*) FROM span_corpus WHERE f <= 60 "
     "GROUP BY hk ORDER BY hk LIMIT 500"),
    ("groupby_topn",
     "SELECT hk, SUM(v) FROM span_corpus GROUP BY hk "
     "ORDER BY SUM(v) DESC LIMIT 20"),
    ("groupby_multi_agg",
     "SELECT lk, SUM(v), MIN(v), MAX(v) FROM span_corpus "
     "GROUP BY lk ORDER BY lk LIMIT 50"),
    ("scalar_agg",
     "SELECT COUNT(*), SUM(v), AVG(v) FROM span_corpus WHERE f > 20"),
    ("selection",
     "SELECT lk, f, v FROM span_corpus ORDER BY v DESC LIMIT 25"),
]


def build_corpus_broker(tmpdir: str, rows: int = 8192,
                        trace_path: Optional[str] = None,
                        device: Any = "cuda"):
    """Seeded 2-segment table behind an in-process broker on ``device``
    with traceRatio=1.0 — shared by `capture` and the tests so the
    checked-in baseline and the gate measure the same corpus (the JAX
    tool's rows from the same seed)."""
    import numpy as np

    from ..broker import Broker
    from ..segment import SegmentBuilder
    from ..server import TableDataManager
    from ..spi import (DataType, FieldSpec, FieldType, Schema,
                       TableConfig)

    rng = np.random.default_rng(20260804)
    schema = Schema("span_corpus", [
        FieldSpec("hk", DataType.INT, FieldType.DIMENSION),
        FieldSpec("lk", DataType.STRING, FieldType.DIMENSION),
        FieldSpec("f", DataType.INT, FieldType.DIMENSION),
        FieldSpec("v", DataType.INT, FieldType.METRIC),
    ])
    builder = SegmentBuilder(schema, TableConfig("span_corpus"))
    dm = TableDataManager("span_corpus", device=device)
    half = rows // 2
    for i in range(2):
        cols = {
            "hk": rng.integers(0, 400, half).astype(np.int32),
            "lk": rng.choice(["a", "b", "c", "d", "e"], half),
            "f": rng.integers(0, 100, half).astype(np.int32),
            "v": rng.integers(0, 1000, half).astype(np.int32),
        }
        dm.add_segment_dir(builder.build(
            cols, os.path.join(tmpdir, "span_corpus"), f"sc_{i}"))
    broker = Broker(device=device, trace_ratio=1.0,
                    trace_ledger_path=trace_path)
    broker.register_table(dm)
    return broker


def capture(out_path: str, iters: int = 5, rows: int = 8192,
            tmpdir: Optional[str] = None, device: Any = "cuda") -> int:
    """Run the corpus on ``device`` ``iters`` times (after one untraced
    warmup pass that pays the first-use costs: kernel builds, plan
    caches) appending one query_trace record per query x iteration to
    ``out_path``. Returns the record count."""
    import shutil
    import tempfile

    from .traffic_replay import retire_segments

    own_tmp = tmpdir is None
    tmpdir = tmpdir or tempfile.mkdtemp(prefix="ptpu_span_corpus_")
    broker = None
    try:
        broker = build_corpus_broker(tmpdir, rows, trace_path=out_path,
                                     device=device)
        n = 0
        for _qid, sql in CORPUS_SQL:   # warmup, untraced
            broker.query(sql + " OPTION(traceRatio=0)")
        for _ in range(iters):
            for _qid, sql in CORPUS_SQL:
                broker.query(sql)
                n += 1
        return n
    finally:
        if broker is not None:
            retire_segments(broker)      # the corpus ends with the run
        if own_tmp:
            shutil.rmtree(tmpdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def load_baseline(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        data = json.load(fh)
    return data.get("shapes", {})


def load_baseline_env(path: str) -> Optional[Dict[str, Any]]:
    with open(path) as fh:
        data = json.load(fh)
    return data.get("env")


def write_baseline(path: str, shapes: Dict[str, Any],
                   env: Dict[str, Any]) -> None:
    with open(path, "w") as fh:
        json.dump({"v": 1, "bar": DEFAULT_BAR, "min_ms": DEFAULT_MIN_MS,
                   "env": env,
                   "shapes": shapes}, fh, indent=1, sort_keys=True)
        fh.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["check", "update", "capture"])
    ap.add_argument("ledgers", nargs="*",
                    help="trace ledger path(s); default: the repo "
                         "PERF_LEDGER.jsonl")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--bar", type=float, default=DEFAULT_BAR,
                    help="fail when a phase's self-vs-rest ratio "
                         "exceeds bar x baseline (default %(default)s)")
    ap.add_argument("--min-ms", type=float, default=DEFAULT_MIN_MS)
    ap.add_argument("--last", type=int, default=DEFAULT_LAST,
                    help="aggregate only the newest N records per shape"
                         " (0 = all; default %(default)s)")
    ap.add_argument("--out", default=None,
                    help="capture mode: the trace ledger to append to")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rows", type=int, default=8192)
    ap.add_argument("--fleet", action="store_true",
                    help="check mode: group records by their `node` "
                         "provenance stamp (fleet ledger) and diff "
                         "each node with its own speed calibration")
    ap.add_argument("--device", default="cuda",
                    help="the device the corpus runs on (capture) and "
                         "the environment checked against the "
                         "baseline's (default %(default)s)")
    # intermixed: `check --fleet <ledger>` must parse (plain parse_args
    # cannot interleave an nargs="*" positional with flags)
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
    records = load_trace_records(ledgers)

    if args.mode == "update":
        shapes = aggregate(records, last=args.last or None)
        env = capture_env(device)
        rec_backends = {r.get("backend") for r in records} - {None}
        if rec_backends and rec_backends != {env["backend"]}:
            # the header must describe the RECORDS' environment; mixed
            # or foreign-backend records would stamp a lie into the
            # ratchet and re-introduce exactly the silent drift noise
            # the pin exists to stop
            print(f"refusing to update: records captured on backend(s) "
                  f"{sorted(rec_backends)} but the current environment "
                  f"is {env['backend']!r} — re-run capture+update in "
                  f"one environment", file=sys.stderr)
            return 2
        write_baseline(args.baseline, shapes, env)
        print(json.dumps({"mode": "update", "baseline": args.baseline,
                          "records": len(records), "env": env,
                          "shapes": len(shapes), "ok": True}))
        return 0

    if not os.path.exists(args.baseline):
        print(json.dumps({"mode": "check", "ok": True,
                          "skipped": f"no baseline at {args.baseline}"}))
        return 0
    baseline = load_baseline(args.baseline)
    mismatch = env_mismatch(load_baseline_env(args.baseline), device)
    if mismatch:
        # fail LOUDLY instead of silently miscalibrating: a card-captured
        # baseline checked on the CPU (or on another card) makes every
        # per-phase ratio meaningless. Distinct exit code so callers can
        # surface the skip without reading it as a phase regression.
        print("ENVIRONMENT MISMATCH vs baseline "
              f"{os.path.basename(args.baseline)}: "
              + "; ".join(f"{k}: baseline={b!r} current={c!r}"
                          for k, (b, c) in sorted(mismatch.items()))
              + " — re-capture the baseline in this environment "
                "(capture + update), or run check in the baseline's",
              file=sys.stderr)
        print(json.dumps({"mode": "check", "ok": False,
                          "env_mismatch": mismatch}))
        return EXIT_ENV_MISMATCH

    if args.fleet:
        return _check_fleet(records, baseline, args)

    shapes = aggregate(records, last=args.last or None)
    res = diff_shapes(baseline, shapes, args.bar, args.min_ms)
    for r in res["regressions"]:
        print(f"REGRESSION {r['shape']} phase={r['phase']}: "
              f"ms {r['base_ms']} -> {r['cand_ms']} "
              f"(calibrated {r['calibrated_ms']}, "
              f"{r['ratio']}x > bar {args.bar})  [{r['sql']}]")
    ok = not res["regressions"]
    print(json.dumps({"mode": "check", "bar": args.bar,
                      "records": len(records),
                      "shapes_checked": len(
                          set(shapes) & set(baseline)),
                      **res, "ok": ok}))
    return 0 if ok else 1


def _check_fleet(records: List[Dict[str, Any]],
                 baseline: Dict[str, Any], args) -> int:
    """check --fleet: per-node aggregation + per-node speed calibration
    (cluster/rollup.py stamps `node` onto every pulled record), so a
    heterogeneous fleet never false-trips the ratchet while one node's
    one-phase regression still does."""
    by_node: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        by_node.setdefault(str(rec.get("node") or "<local>"),
                           []).append(rec)
    nodes: Dict[str, Any] = {}
    regressions: List[Dict[str, Any]] = []
    for node, recs in sorted(by_node.items()):
        shapes = aggregate(recs, last=args.last or None)
        res = diff_shapes(baseline, shapes, args.bar, args.min_ms)
        for r in res["regressions"]:
            r = dict(r, node=node)
            regressions.append(r)
            print(f"REGRESSION node={node} {r['shape']} "
                  f"phase={r['phase']}: ms {r['base_ms']} -> "
                  f"{r['cand_ms']} (calibrated {r['calibrated_ms']}, "
                  f"{r['ratio']}x > bar {args.bar})  [{r['sql']}]")
        nodes[node] = {"records": len(recs),
                       "calibration": res["calibration"],
                       "checked_phases": res["checked_phases"],
                       "regressions": len(res["regressions"])}
    ok = not regressions
    print(json.dumps({"mode": "check", "fleet": True, "bar": args.bar,
                      "records": len(records), "nodes": nodes,
                      "regressions": regressions, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
