"""Unified perf ledger: ONE versioned JSONL schema for every writer.

Port of ``pinot_tpu/utils/ledger.py`` with the same schema, so a record
the port writes passes either package's ``validate_record``. The port
writes a ledger only at a path its caller passes. ``trace_record`` names
the torch device type as the backend. Every line is a **v2 record**:
common envelope
``{"v": 2, "ts": ..., "kind": ...}`` plus a per-kind field contract
below. tools/check_ledger.py validates the whole file (tier-1 runs it);
lines WITHOUT a ``v`` field are grandfathered pre-v2 history and only
parse-checked.

Kinds:
- ``bench_capture``    — bench.py / bench_vector.py / bench_taxi.py
  headline summaries (metric, value, vs_baseline, per-query detail).
- ``phase_profile``    — tools/profile_compact.py (ops/phase_profile.py)
  kernel phase decompositions (mask/fuse/compact/sort/aggregate/
  transfer) with the cost-model trace.
- ``query_trace``      — utils/spans.py span trees (EXPLAIN ANALYZE /
  OPTION(ledgerTrace=true)); the span fields are designed to be diffed
  across CPU-smoke and TPU hardware rounds.
- ``metrics_snapshot`` — utils/metrics_sinks.LedgerSink periodic
  global_metrics snapshots.
- ``query_stats``      — cluster/forensics.py per-query scatter-gather
  health (wall ms, partialResult, exceptions[] codes, hedge/failover
  counts, servers queried/responded), one record per cluster query when
  the broker has a stats ledger configured — chaos soaks trend these.
- ``ingest_stats``     — realtime/manager.py write_ingest_stats()
  freshness ledger (rows/sec, end-to-end freshness ms, commit retries,
  rebalance/replay/orphan recovery counts, faults fired) — the ingest
  plane's first-class counterpart to query latency.
- ``ingest_bench``     — bench_ingest.py / pinot_tpu/engine/loadgen.py
  sustained ingest-while-query harness headlines (rows/s per partition,
  freshness p50/p99, commit latency, query p50/p99 under ingest
  pressure, chaos seed, batched flag) — tools/freshness_gate.py
  ratchets these against tools/freshness_baseline.json.
- ``replay_bench``     — tools/traffic_replay.py closed-loop overload
  replay gate headlines (goodput at N x recorded load, shed counts by
  tenant/rung, per-tier p50/p99, shed-stream determinism, recovery
  back to the pre-spike baseline) — chaos_smoke --overload and the
  bench_common.finish() overload gate consume these.
- ``vector_bench``     — bench_vector.py ``--ivf`` vector-search
  headlines (rows/dim/k/nprobe, recall@10 vs the exact numpy oracle,
  IVF vs exact-scan QPS, latency percentiles, batched-equality and
  zero-retrace flags, vector-pool reconciliation) — the recall/QPS
  curves that sit beside the SSB numbers (ROADMAP direction 5).
- ``fleet_rollup``     — cluster/rollup.py ForensicsRollupTask: the
  controller's cluster-wide aggregation over the per-node ledgers it
  pulls (per-table fleet stats, hot-segment heat ranking, per-node
  drift/batching/device-memory blocks), one record per rollup pass in
  the controller-side fleet ledger.
- ``compile_event``    — utils/compileplane.py: one record per XLA
  compile anywhere in the engine (plan cache, ragged fused kernels,
  vector search, multistage join/window, batched dispatch) with the
  explicit ``lower_ms``/``compile_ms`` staging split, the normalized
  plan-shape hash (utils/shapehash — joins query_trace records), the
  cache-key fingerprint, executable memory bytes / FLOP estimate
  (None where the backend doesn't report them) and the trigger
  taxonomy {cold, warmup, overflow_retry, drift_requantize,
  lru_evict_rebuild, retrace} — the warmup-debt ledger
  tools/warmup_report.py renders and the fleet rollup ranks.
- ``alert``            — utils/alerts.py AlertManager firings: the
  compile-storm detector (rate-windowed post-warmup compiles/min
  crossing the watermark, utils/compileplane.py) and the SLO plane's
  burn-rate alerts (utils/slo.py — ``rate_per_min`` carries the burn
  rate, ``window_s`` the slow window, ``extra`` the objective scope/
  kind/windows). One generic kind; one latch implementation.
- ``slo_status``       — utils/slo.py per-objective status emissions
  (on alert fire/clear transitions + explicit snapshots): burn rates
  over the paired fast/slow windows, error-budget remaining over the
  slow window, event/bad counts — the per-node stream
  cluster/rollup.py aggregates into the ``fleet_rollup.slo`` block
  and tools/slo_report.py gates on.
- ``incident``         — utils/slo.py incident flight recorder: on an
  alert fire, ONE bounded bundle of the node's debug surfaces
  (slow-query ring tail, governor rung + shed counters, tier
  occupancy, devmem pools, compile block, active SLO burn table)
  keyed by the firing alert — served at GET /debug/incidents and
  rendered in the webapp.
- ``rebalance_event``  — cluster/rebalancer.py closed-loop rebalance
  audit stream: one record per move phase (plan / freeze / prewarm /
  flip / drain / abort / resume) carrying the move's table/segment,
  donor/receiver instance ids, byte size, the planner's reason string
  and ``planned`` (False for freeze passes and other non-move
  bookkeeping). Mirrored into the controller's bounded ring at
  GET /debug/rebalance and the webapp Fleet "moves" panel.
- ``rca_verdict``      — cluster/autopsy.py incident autopsy plane:
  one deterministic root-cause attribution over an incident window —
  the FULL ranked cause taxonomy (compile storm, tier thrash,
  overload shed, rebalance churn, chaos faults, straggler, drift
  recompile, ingest stall), each cause carrying matched-evidence
  ``[node, proc, seq]`` ledger pointers and an excess-attribution
  fraction, plus an explicit ``inconclusive`` flag when no cause
  clears the confidence floor. Attached to the firing incident's
  ring entry, served at GET /debug/autopsy, replay-gated by
  tools/traffic_replay.py --autopsy.

Fleet provenance: the controller's rollup puller stamps every record it
ships into the fleet ledger with ``node`` (the source instance id) so
tools (span_diff --fleet) can calibrate per node; ``node`` is part of
the envelope — any kind may carry it.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 2

# per-kind field contract: required/optional TOP-LEVEL fields. The
# validator fails unknown fields (a typo'd field name must never
# silently fork the schema) and missing required ones.
KINDS: Dict[str, Dict[str, set]] = {
    "bench_capture": {
        # concurrency/qps*/p50_ms/p99_ms/fused_ratio/solo_latency_ratio:
        # the concurrent-QPS mode (bench.py --concurrency N) —
        # queries/sec through the broker with cross-query micro-batching
        # fused vs the serial per-query dispatch path, so throughput
        # trends in this ledger the way latency always has
        "required": {"metric", "backend", "ok", "value"},
        "optional": {"unit", "vs_baseline", "n_rows", "queries", "qid",
                     "tpu_outage", "last_tpu_capture", "error", "errors",
                     "partial", "delta_vs_last", "n_vectors", "dim",
                     "extra", "concurrency", "qps", "qps_serial",
                     "qps_ratio", "p50_ms", "p99_ms", "fused_ratio",
                     "solo_latency_ratio"},
    },
    "phase_profile": {
        "required": {"metric", "backend", "qid", "strategy"},
        "optional": {"n_rows", "space", "n_cols", "est_selectivity",
                     "cost_trace", "needs_sort", "scatter_core",
                     "slots_cap", "cap_rows", "matched",
                     "measured_selectivity", "n_valid_rows", "overflow",
                     "inflation", "t_mask_ms", "t_fuse_ms",
                     "t_compact_ms", "t_sort_ms", "t_aggregate_ms",
                     "t_kernel_ms", "t_transfer_ms"},
    },
    "query_trace": {
        # ``sampled``: the record came from traceRatio production
        # sampling (broker/forensics record_trace) rather than an
        # explicit EXPLAIN ANALYZE / ledgerTrace run; ``qid`` cross-links
        # it to the query_stats record of the same query
        "required": {"backend", "sql", "root"},
        "optional": {"metric", "qid", "counters", "n_rows", "sampled"},
    },
    "metrics_snapshot": {
        "required": {"counters"},
        "optional": {"gauges", "timers", "backend"},
    },
    "query_stats": {
        # ``traced``: a span tree exists for this query (EXPLAIN ANALYZE
        # or traceRatio sampling) — the query_trace record in the same
        # ledger carries the same qid, so forensics tooling can join
        # stats<->trace. ``serde_ms``/``net_ms``: the net gap
        # split into frame encode+decode time vs true network time,
        # summed over the query's scatter calls.
        "required": {"qid", "table", "wall_ms", "partial",
                     "servers_queried", "servers_responded",
                     "exception_codes"},
        # ``batched``/``batch_size``: cross-query micro-batching
        # — fused ragged dispatches this query's server executions rode
        # and the largest batch any of them shared.
        # Overload plane (broker/workload.py): ``tenant``/
        # ``tier`` = workload attribution; ``rung`` = the degradation
        # rung the query was ADMITTED at (absent at rung 0); ``shed``/
        # ``shed_rung``/``retry_after_ms`` = a load-shed query's
        # structured 429 parameters; ``arrival_ms`` = ms since the
        # broker's forensics epoch — the inter-arrival deltas
        # tools/traffic_replay.py replays at multiples.
        # ``tier_affinity_hits``: placement-affinity routing (HBM tier,
        # engine/tier.py) — segments this query dispatched to a replica
        # already holding them hot/cube-resident (avoided uploads).
        "optional": {"sql", "rows", "segments_queried",
                     "segments_pruned", "hedges", "failovers", "slow",
                     "error", "backend", "traced", "serde_ms", "net_ms",
                     "batched", "batch_size", "tenant", "tier", "rung",
                     "shed", "shed_rung", "retry_after_ms",
                     "arrival_ms", "tier_affinity_hits"},
    },
    "ingest_stats": {
        # the freshness ledger (realtime/manager.write_ingest_stats):
        # rows/sec, end-to-end freshness ms (fetch-start -> queryable
        # EWMA), commit retries and faults fired — chaos soaks trend
        # these the way query_stats trends the scatter plane.
        # faults_fired is the installed plan's PROCESS-WIDE total (no
        # per-table attribution); chaos runs override it per run.
        # commit_ms: seal->checkpoint latency EWMA;
        # freshness_p50_ms/p99_ms: per-table percentiles over a
        # sustained run's freshness samples (engine/loadgen writers) —
        # the fleet rollup trends them per table when present
        "required": {"table", "rows", "rows_per_s", "freshness_ms",
                     "commits", "commit_retries", "faults_fired"},
        "optional": {"commit_failures", "rebalance_resets",
                     "stream_retries", "upsert_replays",
                     "orphans_cleaned", "handoff_retries", "segments",
                     "consuming_docs", "partitions", "restarts", "seed",
                     "backend", "extra", "commit_ms",
                     "freshness_p50_ms", "freshness_p99_ms"},
    },
    "ingest_bench": {
        # one sustained ingest-while-query harness run (bench_ingest.py
        # / pinot_tpu/engine/loadgen.py): multi-partition ingest through
        # the wire-protocol consumers concurrent with a broker query
        # mix, chaos-armed — the freshness-vs-throughput headline the
        # way bench_capture is the latency headline. ``scenario`` keys
        # the freshness-gate ratchet (tools/freshness_gate.py) the way
        # normalized SQL keys span_diff; ``duration_s`` is the run wall
        # the gate's speed calibration divides by; ``batched`` records
        # whether the micro-batcher was armed; ``seed`` is the chaos /
        # row-generation seed; ``oracle_ok`` = final queryable state
        # byte-identical to the fault-free oracle
        "required": {"backend", "ok", "scenario", "seed", "tables",
                     "partitions", "rows", "rows_per_s", "duration_s",
                     "freshness_p50_ms", "freshness_p99_ms",
                     "queries_concurrent", "batched"},
        "optional": {"rows_per_s_per_partition", "commit_p50_ms",
                     "commit_p99_ms", "commits", "queries",
                     "query_p50_ms", "query_p99_ms", "query_errors",
                     "faults_fired", "restarts", "chaos", "oracle_ok",
                     "per_table", "freshness_gate", "error", "extra"},
    },
    "replay_bench": {
        # one closed-loop traffic-replay run (tools/traffic_replay.py):
        # query_stats records replayed at ``multiple``x their recorded
        # inter-arrival spacing against a live cluster, chaos armable —
        # the "what happens at 4x capacity" headline. ``offered`` =
        # scheduled queries (retries included), ``completed`` = answers,
        # ``shed`` = structured 429s; ``goodput_qps`` = completed/s
        # during the spike window. ``tiers`` = per-tier p50/p99 +
        # shed/error counts; ``protected_sheds`` MUST be 0 for a green
        # gate. ``deterministic`` = the live shed stream matched the
        # pure precomputed decision stream (and two same-seed plans
        # matched each other). ``recovered``/``recovery`` = post-spike
        # latency back inside the pre-spike noise floor (no metastable
        # state).
        "required": {"backend", "ok", "scenario", "seed", "multiple",
                     "offered", "completed", "shed", "goodput_qps",
                     "duration_s"},
        "optional": {"mode", "queries_recorded", "shed_by_tenant",
                     "shed_by_rung", "shed_by_reason", "tiers",
                     "protected_sheds", "protected_p99_ms",
                     "protected_bar_ms", "deterministic", "retries",
                     "retries_suppressed", "recovered", "recovery",
                     "pre_p50_ms", "post_p50_ms", "spike_errors",
                     "chaos", "faults_fired", "query_errors",
                     "structured_429", "error", "extra"},
    },
    "multistage_bench": {
        # one bench.py --multistage capture: the join+window+set-op SSB
        # mix through BOTH planes. ``qps_fused`` runs whole-plan mesh
        # compilation (multistage/fused.py), ``qps_mailbox`` the same
        # statements forced OPTION(multistageFused=false) with device
        # joins disabled — the honest host-exchange plane; ``speedup``
        # = qps_fused / qps_mailbox. ``digests_ok`` = every query's
        # sorted-row digest byte-identical across planes (hard gate);
        # ``retraces`` = post-warmup retraces during the MEASURED
        # phase (max of plan-cache misses and RetraceDetector, must be
        # 0); ``p50_ms/p99_ms`` are fused-plane latencies.
        "required": {"backend", "ok", "queries", "qps_fused",
                     "qps_mailbox", "speedup", "p50_ms", "p99_ms",
                     "digests_ok", "retraces"},
        "optional": {"rows", "devices", "rounds", "per_query",
                     "fused_plans", "fused_fallbacks", "error",
                     "extra"},
    },
    "vector_bench": {
        # one bench_vector.py --ivf capture: ``recall_at_10`` is mean
        # |ivf top-10 ∩ exact top-10| / 10 over the query draw at the
        # DEFAULT nprobe; ``qps_ratio`` = qps_ivf / qps_exact (the
        # same-data exact full-matrix device scan); ``p50_ms/p99_ms``
        # are solo IVF search latencies; ``batched_equal`` = fused
        # concurrent results byte-identical to solo; ``retraces`` =
        # vector-kernel compiles observed during the MEASURED phase
        # (must be 0 post-warmup); ``unaccounted_bytes`` = vector-pool
        # tracked-minus-actual after the eviction churn (must be 0).
        "required": {"backend", "ok", "rows", "dim", "metric", "k",
                     "nprobe", "n_lists", "recall_at_10", "qps_ivf",
                     "qps_exact", "qps_ratio", "p50_ms", "p99_ms"},
        "optional": {"seed", "queries", "page_size", "batch",
                     "qps_batched", "batched_equal", "retraces",
                     "unaccounted_bytes", "nprobe_sweep", "error",
                     "extra"},
    },
    "fleet_rollup": {
        # one controller rollup pass (cluster/rollup.py): pull health
        # (every live node attempted; dead/partitioned nodes skipped
        # and counted, never wedging the pull), per-table fleet stats
        # aggregated from the pulled query_stats/ingest_stats corpus,
        # the hot-segment heat ranking, per-node drift/batching/memory
        # blocks and the unique-process fleet totals (in-process
        # clusters share one metrics registry per process — summing
        # per NODE would multiply-count, so totals dedupe by the
        # nodes' process tokens)
        "required": {"nodes_polled", "nodes_skipped", "records_pulled",
                     "tables"},
        # ``plan_shapes``: the fleet's hottest plan shapes ranked by
        # warmup cost (freq x median compile_ms over the pulled
        # compile_event corpus, (proc, seq)-deduped) — verbatim the
        # prefetch list ROADMAP direction 3's executable plane consumes
        # ``slo``: the worst-replica fleet SLO view —
        # per-(scope, kind) max burn / min budget remaining across
        # proc-deduped node blocks + the open incident count
        # ``autopsy``: the newest rca_verdict briefs in the pulled
        # corpus, (proc, seq)-deduped
        "optional": {"skipped_nodes", "invalid_records", "heat",
                     "slow_queries", "nodes", "fleet", "ingest",
                     "backend", "cursors", "fleet_records",
                     "window_clipped", "plan_shapes", "slo",
                     "autopsy"},
    },
    "compile_event": {
        # one XLA compile (utils/compileplane.StagedFn): ``plan_shape``
        # is utils/shapehash.shape_key of the owning query's SQL (None
        # when the compile happened outside a query context);
        # ``key_fp`` fingerprints the engine cache key; ``memory_bytes``
        # / ``flops`` are the executable's memory_analysis() /
        # cost_analysis() where the backend reports them — None, never
        # fabricated; (``proc``, ``seq``) uniquely identify the event
        # for fleet dedup.
        "required": {"site", "trigger", "plan_shape", "key_fp",
                     "backend", "lower_ms", "compile_ms", "donated",
                     "proc", "seq"},
        "optional": {"sql", "qid", "memory_bytes", "flops", "extra"},
    },
    "alert": {
        # a first-class operational alert (compile storms today):
        # deterministic, rate-windowed, mirrored into the alert ring
        # both consoles render.
        "required": {"alert", "severity", "rate_per_min", "watermark",
                     "window_s", "proc"},
        "optional": {"detail", "triggers", "backend", "seq", "extra"},
    },
    "slo_status": {
        # one objective's burn status (utils/slo.py): ``scope`` is the
        # table name or ``tenant:<name>``; ``slo_kind`` in {latency,
        # availability, freshness} (the envelope ``kind`` is already
        # ``slo_status``); ``objective`` the good-event fraction
        # target; burn rates are bad_fraction/error_budget over the
        # paired windows (``fast_window_s`` / ``window_s`` slow);
        # ``budget_remaining`` = 1 - burn_slow clamped to [0, 1] — the
        # slow-window budget fraction left. Emitted on alert fire/clear
        # transitions and explicit snapshots, NEVER per query — the hot
        # path only appends to an in-memory deque.
        "required": {"scope", "slo_kind", "objective", "burn_fast",
                     "burn_slow", "budget_remaining", "window_s",
                     "proc"},
        "optional": {"bar_ms", "fast_window_s", "threshold", "events",
                     "bad", "alerting", "stale", "severity", "backend",
                     "extra"},
    },
    "incident": {
        # one incident flight-recorder bundle (utils/slo.py): captured
        # on an alert fire, ``surfaces`` is the BOUNDED dict of debug
        # snapshots (slow_queries tail, governor, tier, devmem,
        # compile, slo burn table — each size-capped, each optional:
        # a broken surface is recorded as its error string, never a
        # lost bundle); (``proc``, ``seq``) is the incident identity
        # for fleet dedup, ``alert`` the firing alert's name.
        # ``rca``: the autopsy verdict ref the recorder stamps onto
        # the ring entry post-attribution, so a re-validated ring snapshot stays
        # contract-clean.
        "required": {"incident_id", "alert", "severity", "proc",
                     "surfaces"},
        "optional": {"detail", "scope", "slo", "seq", "backend",
                     "rca", "extra"},
    },
    "rebalance_event": {
        # one closed-loop rebalance phase (cluster/rebalancer.py —
        # the writer-side contract): ``phase`` in {plan, freeze,
        # prewarm, flip, drain, abort, resume}; ``donor``/``receiver``
        # are instance ids (empty for pass-level bookkeeping like
        # freeze); ``bytes`` the segment's on-disk size charged
        # against the churn budget; ``reason`` the planner's burn
        # rationale (or the abort/resume cause); ``planned`` False for
        # records that are not an executed planned move phase.
        "required": {"table", "segment", "donor", "receiver", "phase",
                     "reason", "bytes", "planned"},
        "optional": {"version", "seed", "backend", "proc", "seq",
                     "extra"},
    },
    "rca_verdict": {
        # one incident autopsy (cluster/autopsy.py): ``incident_ref``
        # the incident_id the verdict attaches to ("" for on-demand
        # runs); ``window`` the assembled incident window (t0/t1 on
        # the broker's event-time clock + stats/baseline counts,
        # baseline p50 and the excess the fractions divide by);
        # ``causes`` the FULL ranked taxonomy — every family scored,
        # each row {cause, score, evidence: [[node, proc, seq]...],
        # detail}; ``top_cause`` empty iff ``inconclusive`` (an
        # explicit non-answer, never a confabulated cause);
        # (``proc``, ``seq``) identify the verdict for fleet dedup
        # and the incident-ring rca ref.
        "required": {"incident_ref", "window", "causes", "top_cause",
                     "inconclusive", "proc"},
        "optional": {"seq", "ledger", "evidence_total", "backend",
                     "detail", "extra"},
    },
}

# ``node`` is fleet provenance (stamped by the controller's rollup
# puller on records it ships into the fleet ledger) — envelope-level so
# every kind may carry it without forking each contract
_ENVELOPE = {"v", "ts", "kind", "node"}

# The , generalized: a payload field named like an
# envelope/identity key silently overwrites the envelope on
# ``rec.update(fields)`` (the ``kind`` collision renamed an slo_status
# record mid-write and turned a shed into a 500 — hence ``slo_kind``).
# make_record rejects any **fields name below unless the kind's
# contract explicitly declares it (``proc``/``seq`` for the
# operational kinds); ``ts`` stays injectable for deterministic
# emitters but must already be a formatted string.
_RESERVED = ("kind", "node", "proc", "seq", "ts")


def make_record(kind: str, /, **fields: Any) -> Dict[str, Any]:
    """Build + validate one v2 record. Raises ValueError on a schema
    violation so a writer can never append an invalid line.

    ``kind`` is positional-only: a stray ``kind`` in an expanded
    ``**fields`` dict lands in ``fields`` and gets the reserved-key
    rejection below, not a cryptic TypeError."""
    contract = KINDS.get(kind) or {"required": set(), "optional": set()}
    declared = contract["required"] | contract["optional"]
    shadows = [k for k in _RESERVED
               if k in fields and k != "ts" and k not in declared]
    if shadows:
        raise ValueError(
            f"invalid ledger record ({kind}): field(s) {shadows} would "
            f"shadow reserved envelope keys {sorted(_RESERVED)} — "
            f"rename the payload field (the kind/slo_kind precedent)")
    ts = fields.pop("ts", None)
    if ts is not None and not isinstance(ts, str):
        raise ValueError(
            f"invalid ledger record ({kind}): injected ts must be a "
            f"formatted string, got {type(ts).__name__}")
    rec: Dict[str, Any] = {
        "v": SCHEMA_VERSION,
        # the live-mode wall-clock default; deterministic emitters
        # inject ts= (detlint DT301 baseline documents this hatch)
        "ts": ts or time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "kind": kind,
    }
    rec.update(fields)
    errs = validate_record(rec)
    if errs:
        raise ValueError(f"invalid ledger record ({kind}): "
                         + "; ".join(errs))
    return rec


def validate_record(rec: Any) -> List[str]:
    """-> list of violations (empty = valid). Records without ``v`` are
    grandfathered pre-v2 history: only the dict shape is checked."""
    if not isinstance(rec, dict):
        return ["record is not a JSON object"]
    if "v" not in rec:
        return []  # legacy line: parse-checked only
    errs: List[str] = []
    if rec["v"] != SCHEMA_VERSION:
        errs.append(f"unknown schema version {rec['v']!r}")
        return errs
    kind = rec.get("kind")
    if kind not in KINDS:
        errs.append(f"unknown kind {kind!r} (have {sorted(KINDS)})")
        return errs
    if not isinstance(rec.get("ts"), str):
        errs.append("missing/invalid ts")
    contract = KINDS[kind]
    fields = set(rec) - _ENVELOPE
    missing = contract["required"] - fields
    unknown = fields - contract["required"] - contract["optional"]
    if missing:
        errs.append(f"missing required fields {sorted(missing)}")
    if unknown:
        errs.append(f"unknown fields {sorted(unknown)}")
    return errs


def append_record(rec: Dict[str, Any], path: str) -> None:
    """Validated append (one JSON line). The validation here is the
    writer-side enforcement of the check_ledger.py contract."""
    errs = validate_record(rec)
    if errs:
        raise ValueError("refusing to append invalid ledger record: "
                         + "; ".join(errs))
    with open(path, "a") as fh:
        fh.write(json.dumps(rec) + "\n")


def validate_file(path: str) -> Dict[str, Any]:
    """Validate every line of a ledger file.

    -> {"lines": N, "v2": N, "legacy": N, "kinds": {kind: N},
        "errors": [(lineno, msg)...]}
    """
    out: Dict[str, Any] = {"lines": 0, "v2": 0, "legacy": 0,
                           "kinds": {}, "errors": []}
    if not os.path.exists(path):
        return out
    with open(path) as fh:
        for i, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            out["lines"] += 1
            try:
                rec = json.loads(line)
            except ValueError as e:
                out["errors"].append((i, f"unparseable JSON: {e}"))
                continue
            errs = validate_record(rec)
            if errs:
                out["errors"].append((i, "; ".join(errs)))
            elif isinstance(rec, dict) and "v" in rec:
                out["v2"] += 1
                k = rec["kind"]
                out["kinds"][k] = out["kinds"].get(k, 0) + 1
            else:
                out["legacy"] += 1
    return out


def trace_record(root: Any, sql: str, backend: Optional[str] = None,
                 counters: Optional[Dict[str, int]] = None,
                 **fields: Any) -> Dict[str, Any]:
    """A ``query_trace`` record from a utils/spans.Span tree."""
    if backend is None:
        # the torch device type the port serves from (the reference
        # names its JAX backend here)
        import torch

        backend = "cuda" if torch.cuda.is_available() else "cpu"
    root_d = root.to_dict() if hasattr(root, "to_dict") else root
    rec: Dict[str, Any] = {"backend": backend, "sql": sql, "root": root_d}
    if counters:
        rec["counters"] = counters
    rec.update(fields)
    return make_record("query_trace", **rec)
