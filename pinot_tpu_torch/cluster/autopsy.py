"""Incident autopsy plane: deterministic cross-plane root-cause
attribution with a replay-gated verdict.

The measurement planes — spans, compile forensics,
devmem/tier telemetry, the SLO burn plane, the incident flight
recorder, the closed-loop rebalancer — but nothing *explains* burn: an
operator staring at an open incident still has to eyeball eight debug
surfaces to learn whether the cause was a compile storm, tier thrash,
overload shedding, rebalance churn, an armed fault stream, or a
straggler node. This module turns the recorded evidence into an
attributed verdict:

- ``load_corpus`` reads a node (or fleet) ledger and stamps every
  record with its 1-based line number — the ``seq`` half of the
  ``(node, proc, seq)`` evidence pointers every verdict carries, the
  exact sequence discipline ``forensics.read_ledger_since`` resolves
  (torn tails excluded, so a pointer always lands on a complete line).
- ``assemble_window`` splits the corpus into a baseline and an
  incident window on the injectable event-time clock
  (``utils/slo.event_time`` — ``arrival_ms + wall_ms``, never wall
  clock), computes the excess latency over the baseline p50, and
  gathers the cross-plane events (compile/rebalance/alert/slo/
  incident/ingest/trace) that land after the baseline by ledger
  order — append order IS time order, so no timestamp parsing.
- eight pure scorers — one per cause family in the fixed ``CAUSES``
  taxonomy — each return matched-evidence refs plus an
  excess-attribution fraction ("post-warmup compile_ms accounts for
  0.62 of excess p99"). Tier/devmem/overload evidence comes from the
  incident bundles' surface blocks; compile-time attribution is split
  by the compile_event trigger taxonomy so an eviction-rebuild storm
  attributes to tier thrash, a drift retrace to drift, and only the
  rest to a plain compile storm; straggler skew is discounted by
  in-window compile time so a one-sided warmup never masquerades as a
  partitioned node.
- ``plan_autopsy`` ranks the taxonomy and emits the verdict dict — an
  explicit ``inconclusive`` verdict when no cause clears ``MIN_SCORE``
  (never a confabulated top cause). Every scorer and the assembler is
  pure, so the same corpus yields byte-identical verdicts
  (``json.dumps(..., sort_keys=True)``).
- ``whydown`` is the per-query lane (EXPLAIN ANALYZE
  ``OPTION(whydown=true)`` / ``GET /debug/autopsy?qid=``): the
  cross-plane events whose ledger positions overlap the query's own
  wall window, annotated onto its trace.
- ``AutopsyPlane`` is the live wrapper: it runs ``plan_autopsy`` over
  the node ledger, lands the verdict as a validated ``rca_verdict``
  record in the same ledger, keeps a bounded ring for
  ``GET /debug/autopsy``, and attaches the verdict ref back onto the
  originating incident's ring entry. Wired as the
  ``IncidentRecorder.post_hook`` it runs automatically on incident
  fire — on the recorder's background thread, fenced, never on the
  query path.

Port of ``pinot_tpu/cluster/autopsy.py``, with the same taxonomy,
scorers and verdict bytes. The port writes no ``compile_event`` records,
so on a corpus of its own ``compile_storm`` and ``drift_recompile``
score 0; on a corpus the JAX package wrote the verdict is the
reference's.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..utils import ledger as uledger
from ..utils.metrics import global_metrics
from ..utils.slo import DEFAULT_BURN_THRESHOLD, event_time, \
    global_incidents
from .forensics import PROC_TOKEN

# the fixed cause taxonomy — scorer order IS this order, ranking is
# (-score, cause) so ties break alphabetically, never by code motion
CAUSES = ("compile_storm", "tier_thrash", "overload_shed",
          "rebalance_churn", "chaos_faults", "straggler",
          "drift_recompile", "ingest_stall")

DEFAULT_WINDOW_S = 60.0       # incident window when none is given
MIN_SCORE = 0.15              # below this the verdict is inconclusive
EVIDENCE_CAP = 12             # refs per cause (bounded records)
STRAGGLER_MIN_RATIO = 2.0     # slowest server vs median, per trace
STRAGGLER_MIN_SKEW_MS = 20.0  # absolute per-trace skew floor (noise)
REBALANCE_SATURATION = 6.0    # move-phase events for full confidence
AUTOPSY_RING_CAPACITY = 32

# compile_event trigger split: eviction rebuilds attribute to tier
# thrash, drift retraces to drift — only the rest is a compile storm
_TIER_TRIGGERS = ("lru_evict_rebuild",)
_DRIFT_TRIGGERS = ("drift_requantize", "retrace")

# the cross-plane event kinds the window assembler / whydown gather
_CROSS_KINDS = ("alert", "compile_event", "incident", "ingest_stats",
                "rebalance_event", "replay_bench", "slo_status")


# ---------------------------------------------------------------------------
# corpus loading + evidence pointers
# ---------------------------------------------------------------------------

def load_corpus(path: Optional[str]) -> List[Dict[str, Any]]:
    """Read a ledger file into seq-stamped records: each record gains
    ``_seq`` = its 1-based line number, the pointer
    ``forensics.read_ledger_since(path, seq - 1)`` resolves. The same
    torn-tail discipline as the rollup puller: a final line without a
    newline is an append in flight and is excluded, so an evidence
    pointer never names a half-written record. Unparseable lines
    advance the sequence but ship nothing."""
    records: List[Dict[str, Any]] = []
    if not path or not os.path.exists(path):
        return records
    with open(path) as fh:
        for i, line in enumerate(fh):
            if not line.endswith("\n"):
                break   # torn tail: not yet addressable
            text = line.strip()
            if not text:
                continue
            try:
                rec = json.loads(text)
            except ValueError:
                continue
            if isinstance(rec, dict):
                rec["_seq"] = i + 1
                records.append(rec)
    return records


def _stamped(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Hand-built corpora (tests) arrive without ``_seq``; stamp by
    list position so evidence pointers stay meaningful either way."""
    out: List[Dict[str, Any]] = []
    for i, rec in enumerate(records):
        if "_seq" not in rec:
            rec = dict(rec)
            rec["_seq"] = i + 1
        out.append(rec)
    return out


def _ref(rec: Dict[str, Any]) -> List[Any]:
    """One evidence pointer: [node, proc, seq] — node is the fleet
    provenance stamp (empty on a node-local ledger), proc the writer's
    process token (empty for kinds that don't carry one), seq the
    ledger line number from ``load_corpus``."""
    return [str(rec.get("node") or ""), str(rec.get("proc") or ""),
            int(rec.get("_seq") or 0)]


def _median(vals: List[float]) -> float:
    """Median of a SORTED list (0.0 when empty) — pure, no numpy."""
    if not vals:
        return 0.0
    n = len(vals)
    m = n // 2
    if n % 2:
        return float(vals[m])
    return (float(vals[m - 1]) + float(vals[m])) / 2.0


# ---------------------------------------------------------------------------
# window assembly
# ---------------------------------------------------------------------------

def assemble_window(records: List[Dict[str, Any]],
                    window: Optional[Tuple[float, Optional[float]]] = None
                    ) -> Dict[str, Any]:
    """Split a seq-stamped corpus into baseline + incident window.

    ``query_stats`` records are windowed on the injectable event-time
    clock (``arrival_ms + wall_ms``): baseline = completions before
    ``t0``, window = completions in ``[t0, t1]`` (``t1=None`` =
    unbounded). The cross-plane kinds carry no event time, so they
    window by LEDGER ORDER: everything after the last baseline stats
    line is in-window (append order is time order) — which also keeps
    a window query's compile events in-window even though they land in
    the ledger before the query's own stats record. Without an
    explicit window the last ``DEFAULT_WINDOW_S`` seconds of event
    time form the window (the incident auto-run default).

    Excess = sum of each non-shed window query's latency above the
    baseline p50 — the denominator every time-attribution fraction
    divides by."""
    stats = [r for r in records if r.get("kind") == "query_stats"]
    times = [event_time(r) for r in stats]
    known = [t for t in times if t is not None]
    if window is not None:
        t0, t1 = window
    else:
        t1 = max(known) if known else 0.0
        t0 = t1 - DEFAULT_WINDOW_S
    win_stats: List[Dict[str, Any]] = []
    base_stats: List[Dict[str, Any]] = []
    for rec, t in zip(stats, times):
        if t is None:
            continue
        if t < t0:
            base_stats.append(rec)
        elif t1 is None or t <= t1:
            win_stats.append(rec)
    cut_seq = 0
    for rec in base_stats:
        cut_seq = max(cut_seq, int(rec["_seq"]))
    events: Dict[str, List[Dict[str, Any]]] = {
        k: [] for k in _CROSS_KINDS + ("query_trace",)}
    pre: Dict[str, List[Dict[str, Any]]] = {"incident": [],
                                            "ingest_stats": []}
    for rec in records:
        kind = rec.get("kind")
        if kind in events and int(rec["_seq"]) > cut_seq:
            events[kind].append(rec)
        elif kind in pre and int(rec["_seq"]) <= cut_seq:
            pre[kind].append(rec)
    base_wall = sorted(float(r.get("wall_ms") or 0.0)
                       for r in base_stats if not r.get("shed"))
    p50 = _median(base_wall)
    excess = 0.0
    for rec in win_stats:
        if rec.get("shed"):
            continue
        excess += max(0.0, float(rec.get("wall_ms") or 0.0) - p50)
    return {"t0": t0, "t1": t1, "stats": win_stats,
            "baseline": base_stats, "cut_seq": cut_seq,
            "baseline_p50_ms": round(p50, 3),
            "excess_ms": round(excess, 3),
            "events": events, "pre": pre}


# ---------------------------------------------------------------------------
# shared scorer helpers
# ---------------------------------------------------------------------------

def _compile_split(win: Dict[str, Any]
                   ) -> Dict[str, List[Dict[str, Any]]]:
    """Window compile events partitioned by trigger family (module
    docstring): eviction rebuilds -> tier, drift retraces -> drift,
    everything else -> storm."""
    out: Dict[str, List[Dict[str, Any]]] = {"storm": [], "tier": [],
                                            "drift": []}
    for rec in win["events"]["compile_event"]:
        trig = str(rec.get("trigger") or "")
        if trig in _TIER_TRIGGERS:
            out["tier"].append(rec)
        elif trig in _DRIFT_TRIGGERS:
            out["drift"].append(rec)
        else:
            out["storm"].append(rec)
    return out


def _compile_ms(recs: List[Dict[str, Any]]) -> float:
    """Total staging time (lower + compile) over compile events."""
    total = 0.0
    for rec in recs:
        total += float(rec.get("lower_ms") or 0.0) \
            + float(rec.get("compile_ms") or 0.0)
    return total


def _excess_fraction(total_ms: float, excess_ms: float) -> float:
    """total_ms as a fraction of the window's excess, in [0, 1]."""
    if excess_ms <= 0.0 or total_ms <= 0.0:
        return 0.0
    return min(1.0, total_ms / excess_ms)


def _latest_tier_block(recs: List[Dict[str, Any]]
                       ) -> Optional[Tuple[Dict[str, Any],
                                           Dict[str, Any]]]:
    """Last incident bundle carrying a tier surface -> (record, tier
    block); the tier/devmem evidence source the bundle contributes."""
    found = None
    for rec in recs:
        surf = rec.get("surfaces")
        if isinstance(surf, dict) and isinstance(surf.get("tier"),
                                                 dict):
            found = (rec, surf["tier"])
    return found


def _cause(name: str, score: float, evidence: List[Dict[str, Any]],
           detail: str) -> Dict[str, Any]:
    """One ranked-cause row: score rounded for byte-stable verdicts,
    evidence capped and rendered as [node, proc, seq] pointers."""
    return {"cause": name, "score": round(score, 4),
            "evidence": [_ref(r) for r in evidence[:EVIDENCE_CAP]],
            "detail": detail}


# ---------------------------------------------------------------------------
# the cause scorers (one per taxonomy family, all pure)
# ---------------------------------------------------------------------------

def score_compile_storm(win: Dict[str, Any]) -> Dict[str, Any]:
    """Post-warmup compile time (non-eviction, non-drift triggers) as
    a fraction of the window's excess latency."""
    evs = _compile_split(win)["storm"]
    total = _compile_ms(evs)
    score = _excess_fraction(total, win["excess_ms"])
    pool = evs + [a for a in win["events"]["alert"]
                  if "compile" in str(a.get("alert") or "")]
    return _cause(
        "compile_storm", score, pool,
        f"post-warmup compile {total:.0f} ms over {len(evs)} event(s) "
        f"~ {score:.2f} of {win['excess_ms']:.0f} ms excess")


def score_tier_thrash(win: Dict[str, Any]) -> Dict[str, Any]:
    """Demote/re-promote churn under an armed HBM budget: the demotion
    delta between the last pre-window and last in-window incident
    bundles' tier surfaces, normalized per window query, combined with
    eviction-rebuild compile time as an excess fraction."""
    post = _latest_tier_block(win["events"]["incident"])
    pre = _latest_tier_block(win["pre"]["incident"])
    evict = _compile_split(win)["tier"]
    evict_frac = _excess_fraction(_compile_ms(evict),
                                  win["excess_ms"])
    churn = 0
    evidence = list(evict)
    if post is not None and post[1].get("armed"):
        base = int(pre[1].get("demotions") or 0) \
            if pre is not None else 0
        churn = max(0, int(post[1].get("demotions") or 0) - base)
        evidence = [post[0]] + evidence
    served = [r for r in win["stats"] if not r.get("shed")]
    churn_score = min(1.0, churn / max(1.0, float(len(served)))) \
        if churn else 0.0
    score = max(churn_score, evict_frac)
    return _cause(
        "tier_thrash", score, evidence,
        f"{churn} demotions over {len(served)} window queries; "
        f"evict-rebuild compile {_compile_ms(evict):.0f} ms")


def score_overload_shed(win: Dict[str, Any]) -> Dict[str, Any]:
    """Shed fraction of the window's queries (availability signal —
    a shed is a denied answer, not a latency sample)."""
    stats = win["stats"]
    shed = [r for r in stats if r.get("shed")]
    score = len(shed) / float(len(stats)) if stats else 0.0
    pool = shed + [a for a in win["events"]["alert"]
                   if "overload" in str(a.get("alert") or "")
                   or "shed" in str(a.get("alert") or "")]
    return _cause(
        "overload_shed", score, pool,
        f"{len(shed)}/{len(stats)} window queries shed")


def score_rebalance_churn(win: Dict[str, Any]) -> Dict[str, Any]:
    """Executed rebalance move phases inside the window (prewarm/flip/
    drain/abort) against the saturation constant."""
    moves = [r for r in win["events"]["rebalance_event"]
             if str(r.get("phase") or "") in ("prewarm", "flip",
                                              "drain", "abort")]
    score = min(1.0, len(moves) / REBALANCE_SATURATION)
    phases: Dict[str, int] = {}
    for rec in moves:
        p = str(rec.get("phase"))
        phases[p] = phases.get(p, 0) + 1
    desc = ", ".join(f"{k}={phases[k]}" for k in sorted(phases)) \
        or "none"
    return _cause(
        "rebalance_churn", score, moves,
        f"{len(moves)} move phase(s) in window ({desc})")


def _max_faults(recs: List[Dict[str, Any]]) -> int:
    m = 0
    for rec in recs:
        m = max(m, int(rec.get("faults_fired") or 0))
    return m


def score_chaos_faults(win: Dict[str, Any]) -> Dict[str, Any]:
    """Armed fault-plane activity: the faults_fired delta carried by
    ingest_stats (a process-wide cumulative counter — deltaed against
    the pre-window records) plus chaos-armed replay_bench records."""
    ing = [r for r in win["events"]["ingest_stats"]
           if int(r.get("faults_fired") or 0) > 0]
    delta = max(0, _max_faults(win["events"]["ingest_stats"])
                - _max_faults(win["pre"]["ingest_stats"]))
    rb = [r for r in win["events"]["replay_bench"]
          if int(r.get("faults_fired") or 0) > 0]
    total = delta
    for rec in rb:
        total += int(rec.get("faults_fired") or 0)
    n = max(1, len(win["stats"]))
    score = min(1.0, total / float(n)) if total else 0.0
    return _cause(
        "chaos_faults", score, ing + rb,
        f"{total} fault firing(s) across {n} window queries")


def _server_spans(node: Dict[str, Any],
                  out: Dict[str, float]) -> None:
    """Accumulate per-server scatter-call time over one span tree
    (the broker-side span includes network + server wait, so a
    delayed server shows up here)."""
    attrs = node.get("attrs") or {}
    srv = attrs.get("server")
    if srv and node.get("name") == "scatter_call":
        key = str(srv)
        out[key] = out.get(key, 0.0) + float(node.get("ms") or 0.0)
    for child in node.get("children") or ():
        _server_spans(child, out)


def score_straggler(win: Dict[str, Any]) -> Dict[str, Any]:
    """Per-server skew from the window's span trees: for each traced
    query the slowest server's scatter time above the median of the
    REMAINING servers, counted only when the skew is both relative
    (>= 2x that median) and absolute (>= 20 ms) — then discounted by the window's
    total compile time, so a one-sided warmup never reads as a
    partitioned node. The remaining skew is taken as a fraction of
    excess; hedges/failovers/partials ride along as supporting
    evidence."""
    excess = win["excess_ms"]
    qids = {str(r.get("qid")) for r in win["stats"]}
    total_skew = 0.0
    hits: Dict[str, int] = {}
    traces: List[Dict[str, Any]] = []
    for tr in win["events"]["query_trace"]:
        if qids and str(tr.get("qid")) not in qids:
            continue
        root = tr.get("root")
        if not isinstance(root, dict):
            continue
        per: Dict[str, float] = {}
        _server_spans(root, per)
        if len(per) < 2:
            continue
        top_ms, top_srv = max(
            (ms, srv) for srv, ms in sorted(per.items()))
        # skew vs the median of the OTHER servers: with the top server
        # included a 2-server cluster could never satisfy the 2x ratio
        # (median = mean of the pair)
        med = _median(sorted(ms for srv, ms in per.items()
                             if srv != top_srv))
        skew = top_ms - med
        if top_ms < STRAGGLER_MIN_RATIO * max(med, 1e-9) \
                or skew < STRAGGLER_MIN_SKEW_MS:
            continue
        total_skew += skew
        hits[top_srv] = hits.get(top_srv, 0) + 1
        traces.append(tr)
    adj = max(0.0, total_skew
              - _compile_ms(win["events"]["compile_event"]))
    score = _excess_fraction(adj, excess)
    worst = ""
    if hits:
        worst = max((c, s) for s, c in sorted(hits.items()))[1]
    support = [r for r in win["stats"]
               if r.get("hedges") or r.get("failovers")
               or r.get("partial")]
    return _cause(
        "straggler", score, traces + support,
        f"server {worst or '<none>'} slowest in "
        f"{hits.get(worst, 0)}/{len(win['events']['query_trace'])} "
        f"trace(s); unexplained skew {adj:.0f} ms "
        f"~ {score:.2f} of excess")


def score_drift_recompile(win: Dict[str, Any]) -> Dict[str, Any]:
    """Drift-triggered recompilation (retrace / drift_requantize) as a
    fraction of the window's excess latency."""
    evs = _compile_split(win)["drift"]
    total = _compile_ms(evs)
    score = _excess_fraction(total, win["excess_ms"])
    return _cause(
        "drift_recompile", score, evs,
        f"drift/retrace compile {total:.0f} ms over {len(evs)} "
        f"event(s) ~ {score:.2f} of excess")


def score_ingest_stall(win: Dict[str, Any]) -> Dict[str, Any]:
    """Freshness-objective burn inside the window: a stale gauge is
    full-confidence, otherwise burn_slow against the objective's own
    threshold; ingest_stats records over the freshness bar ride along
    as evidence."""
    rows = [r for r in win["events"]["slo_status"]
            if str(r.get("slo_kind") or "") == "freshness"]
    score = 0.0
    evidence: List[Dict[str, Any]] = []
    bars: List[float] = []
    for rec in rows:
        if rec.get("stale"):
            s = 1.0
        else:
            thr = float(rec.get("threshold")
                        or DEFAULT_BURN_THRESHOLD)
            s = min(1.0, float(rec.get("burn_slow") or 0.0)
                    / max(thr, 1e-9))
        if s > 0.0:
            evidence.append(rec)
        score = max(score, s)
        if rec.get("bar_ms") is not None:
            bars.append(float(rec["bar_ms"]))
    if bars:
        bar = min(bars)
        evidence += [r for r in win["events"]["ingest_stats"]
                     if float(r.get("freshness_ms") or 0.0) > bar]
    return _cause(
        "ingest_stall", score, evidence,
        f"{len(rows)} freshness status row(s) in window, "
        f"peak confidence {score:.2f}")


# scorer order mirrors CAUSES — the taxonomy is ranked, never pruned
SCORERS = (score_compile_storm, score_tier_thrash,
           score_overload_shed, score_rebalance_churn,
           score_chaos_faults, score_straggler,
           score_drift_recompile, score_ingest_stall)


# ---------------------------------------------------------------------------
# the verdict planner (pure — the byte-replayable surface)
# ---------------------------------------------------------------------------

def plan_autopsy(records: List[Dict[str, Any]],
                 window: Optional[Tuple[float, Optional[float]]] = None,
                 incident: Optional[Dict[str, Any]] = None,
                 proc: str = "plan") -> Dict[str, Any]:
    """Rank the full cause taxonomy over a recorded corpus -> the
    verdict dict (the ``rca_verdict`` payload minus envelope/seq).
    Pure in (records, window, incident, proc): the same corpus yields
    byte-identical verdicts under ``json.dumps(..., sort_keys=True)``
    — the traffic_replay gate's comparison object. ``inconclusive`` is
    an explicit non-answer: when no cause clears ``MIN_SCORE`` the top
    cause is left empty rather than confabulated."""
    recs = _stamped(records)
    win = assemble_window(recs, window=window)
    causes = [fn(win) for fn in SCORERS]
    causes.sort(key=lambda c: (-c["score"], c["cause"]))
    top = causes[0] if causes else None
    inconclusive = top is None or top["score"] < MIN_SCORE
    total_refs = 0
    for c in causes:
        total_refs += len(c["evidence"])
    return {
        "incident_ref": str((incident or {}).get("incident_id")
                            or ""),
        "window": {"t0": round(float(win["t0"]), 6),
                   "t1": (None if win["t1"] is None
                          else round(float(win["t1"]), 6)),
                   "stats": len(win["stats"]),
                   "baseline": len(win["baseline"]),
                   "baseline_p50_ms": win["baseline_p50_ms"],
                   "excess_ms": win["excess_ms"]},
        "causes": causes,
        "top_cause": "" if inconclusive else top["cause"],
        "inconclusive": inconclusive,
        "evidence_total": total_refs,
        "proc": proc,
    }


def _event_summary(rec: Dict[str, Any]) -> Dict[str, Any]:
    """One whydown row: the pointer plus the kind's headline fields."""
    out: Dict[str, Any] = {"kind": rec.get("kind"), "ref": _ref(rec)}
    for key in ("site", "trigger", "compile_ms", "phase", "segment",
                "donor", "receiver", "alert", "severity", "scope",
                "slo_kind", "burn_slow", "incident_id", "table",
                "freshness_ms", "faults_fired"):
        if key in rec:
            out[key] = rec[key]
    return out


def whydown(records: List[Dict[str, Any]],
            qid: Optional[str] = None,
            window: Optional[Tuple[float, float]] = None
            ) -> Dict[str, Any]:
    """The per-query autopsy lane: the cross-plane events overlapping
    one query's wall window. The target window comes from the query's
    own stats record (``arrival_ms``..``arrival_ms + wall_ms``) or an
    explicit ``window`` in event-time seconds; overlap for the
    timeless cross-plane kinds is by ledger position — every event
    between the first and last overlapping query's ledger lines.
    Pure, same determinism contract as ``plan_autopsy``."""
    recs = _stamped(records)
    stats = [r for r in recs if r.get("kind") == "query_stats"]
    target = None
    if qid is not None:
        for rec in stats:
            if str(rec.get("qid")) == str(qid):
                target = rec   # last record wins (retries share qids)
    if window is not None:
        a0, a1 = float(window[0]), float(window[1])
    elif target is not None and target.get("arrival_ms") is not None:
        a = float(target["arrival_ms"])
        a0 = a / 1e3
        a1 = (a + float(target.get("wall_ms") or 0.0)) / 1e3
    else:
        return {"qid": "" if qid is None else str(qid),
                "found": False, "window": None, "queries": 0,
                "events": []}
    touched: List[Dict[str, Any]] = []
    for rec in stats:
        t_a = rec.get("arrival_ms")
        if t_a is None:
            continue
        s0 = float(t_a) / 1e3
        s1 = (float(t_a) + float(rec.get("wall_ms") or 0.0)) / 1e3
        if s1 >= a0 and s0 <= a1:
            touched.append(rec)
    if not touched:
        return {"qid": "" if qid is None else str(qid),
                "found": target is not None,
                "window": [round(a0, 6), round(a1, 6)],
                "queries": 0, "events": []}
    lo = min(int(r["_seq"]) for r in touched)
    hi = max(int(r["_seq"]) for r in touched)
    events = [_event_summary(r) for r in recs
              if r.get("kind") in _CROSS_KINDS
              and lo <= int(r["_seq"]) <= hi]
    return {"qid": "" if qid is None else str(qid),
            "found": target is not None,
            "window": [round(a0, 6), round(a1, 6)],
            "queries": len(touched), "events": events}


# ---------------------------------------------------------------------------
# the live plane (ring + ledger sink + incident hook)
# ---------------------------------------------------------------------------

class AutopsyPlane:
    """Live wrapper over ``plan_autopsy``: loads the configured
    ledger, lands the verdict as a validated ``rca_verdict`` record in
    the SAME ledger, keeps a bounded ring for ``GET /debug/autopsy``
    and attaches the verdict ref onto the originating incident's ring
    entry. ``on_incident`` is the ``IncidentRecorder.post_hook``
    target — it runs on the recorder's background capture thread,
    fully fenced, so attribution never sits on the query path."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=AUTOPSY_RING_CAPACITY)
        self._seq = 0
        self.path: Optional[str] = None  # guarded-by: none — config
        self.computed = 0
        self.errors = 0

    def run(self, incident: Optional[Dict[str, Any]] = None,
            ledger_path: Optional[str] = None,
            window: Optional[Tuple[float, Optional[float]]] = None,
            ts: Optional[str] = None) -> Dict[str, Any]:
        """One attribution pass: corpus -> verdict -> ledger + ring.
        ``ledger_path`` overrides the evidence source (the controller
        runs over the fleet ledger); the verdict record always lands
        in ``self.path`` when configured. ``ts`` is the injectable
        ledger timestamp (deterministic emitters)."""
        path = ledger_path or self.path
        records = load_corpus(path)
        verdict = plan_autopsy(records, window=window,
                               incident=incident, proc=PROC_TOKEN)
        with self._lock:
            self._seq += 1
            seq = self._seq
        fields = dict(verdict)
        fields["seq"] = seq
        if path:
            fields["ledger"] = path
        if ts is not None:
            fields["ts"] = ts
        rec = uledger.make_record("rca_verdict", **fields)
        if self.path:
            try:
                uledger.append_record(rec, self.path)
            except OSError:
                # observability must never fail the data path (the
                # forensics write policy)
                global_metrics.count("rca_verdict_write_errors")
        with self._lock:
            self._ring.append(rec)
            self.computed += 1
        global_metrics.count("autopsies_computed")
        if incident is not None:
            global_incidents.attach_verdict(
                str(incident.get("incident_id") or ""),
                {"proc": rec["proc"], "seq": seq,
                 "top_cause": rec["top_cause"],
                 "inconclusive": rec["inconclusive"]})
        return rec

    def on_incident(self, incident_rec: Dict[str, Any]) -> None:
        """The post-snapshot hook (IncidentRecorder.post_hook): runs
        attribution for a freshly captured incident — background
        thread, fenced, never raises into the recorder."""
        try:
            self.run(incident=incident_rec)
        except Exception:
            with self._lock:
                self.errors += 1
            global_metrics.count("autopsy_errors")

    # -- serving (GET /debug/autopsy) --------------------------------------
    def snapshot(self, limit: Optional[int] = None) -> Dict[str, Any]:
        with self._lock:
            verdicts = list(self._ring)[::-1]
        count = len(verdicts)   # ring size, not the limited slice
        if limit is not None:
            verdicts = verdicts[:max(limit, 0)]
        return {"count": count, "computed": self.computed,
                "errors": self.errors, "ledger": self.path,
                "verdicts": verdicts}

    def reset(self) -> None:
        """Test isolation: clear the ring/counters; the seq counter
        survives — (proc, seq) is a verdict's identity (the incident
        discipline)."""
        with self._lock:
            self._ring.clear()
            self.computed = 0
            self.errors = 0


global_autopsy = AutopsyPlane()
