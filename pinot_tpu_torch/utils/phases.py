"""One shared vocabulary for phase and span names.

Port of ``pinot_tpu/utils/phases.py`` (every name kept, the cluster and
networked-dispatch names included, so a span tree of either package reads
against the same set). utils/trace.py (``Tracing.phase`` — flat wall-ms
per phase in the response envelope when ``OPTION(trace=true)``) and
utils/spans.py (the span TREE that EXPLAIN ANALYZE renders) time the same
code regions; every instrumentation site imports its name from here, so
the envelope and the analyze rows agree about what "planning" means.

``SPAN_NAMES`` holds every name a span tree of the port may carry: the
reference's set plus ``VECTOR_SEARCH`` and the kernel-level names
(``segment_kernel``, ``device_execute``, ...) of ``KERNEL_SPAN_NAMES``,
which the reference leaves to their emit sites.
"""
from __future__ import annotations

# broker/engine phases (Tracing.phase AND span names — must stay one set)
QUERY = "query"
PLANNING = "planning"
EXECUTION = "execution"
REDUCE = "reduce"
DISTRIBUTED_EXECUTE = "distributed_execute"
BROKER_OVERHEAD = "broker_overhead"

# cluster plane span names (span-tree only: the flat envelope has no
# cross-process children to hang them on)
SCATTER = "scatter"
SCATTER_CALL = "scatter_call"
SERVER_QUERY = "server_query"

# multistage plane (round 12): stage spans inside the QUERY tree so
# EXPLAIN ANALYZE and sampled traces cover shuffle-join/window/set-op
# queries, plus the networked dispatch plane's per-submission spans
# (multistage/dispatch.py — the scatter_call/server_query analogs)
LEAF_SCAN = "leaf_scan"
JOIN_STAGE = "join_stage"
EXCHANGE = "exchange"
WINDOW_STAGE = "window_stage"
FINAL_STAGE = "final_stage"
STAGE = "stage"                    # remote /stage worker-rooted tree
STAGE_CALL = "stage_call"          # driver-side per-submission attempt
STAGE_DISPATCH = "stage_dispatch"  # driver-side fan-out parent

# whole-plan mesh compilation (round 16): when every stage worker
# shares one mesh, the join pipeline compiles into ONE shard_map
# program (multistage/fused.py) and the mailbox spans above disappear —
# fused_plan is their replacement parent (leaf scans, the staged
# compile/execute, and the canonical-order gather are its children) and
# collective_exchange attributes each in-program stage boundary
# (hash -> all_to_all, broadcast -> replication) so EXPLAIN ANALYZE and
# the span-diff gate keep per-stage self-times when the plan fuses
FUSED_PLAN = "fused_plan"
COLLECTIVE_EXCHANGE = "collective_exchange"

# cross-query micro-batching (PR 8): every query that passes through the
# ragged admission queue wraps its wait + fused dispatch in ONE
# ragged_dispatch span on its own thread (queue_wait_ms annotated), so
# per-query wall attribution survives the fusion; the leader's span
# additionally parents the cube_build/fused_execute children.
RAGGED_DISPATCH = "ragged_dispatch"
CUBE_BUILD = "cube_build"
FUSED_EXECUTE = "fused_execute"

# vector search subsystem (engine/vector_exec.py): one span per
# (query, segment) device search — batched or solo annotated on it
VECTOR_SEARCH = "vector_search"

# names Tracing.phase may emit into the flat trace envelope
TRACED_PHASES = frozenset(
    {PLANNING, EXECUTION, REDUCE, DISTRIBUTED_EXECUTE})

# kernel-level span names, owned by their emit sites (engine/executor.py,
# engine/batch.py, parallel/distributed.py, query/planner.py,
# ops/phase_profile.py)
KERNEL_SPAN_NAMES = frozenset(
    {"plan_segment", "segment_host", "segment_kernel", "segment_kselect",
     "extract_partial", "device_execute", "device_transfer",
     "overflow_retry", "group_overflow_retry", "vmap_dispatch",
     "segmented_compact_dispatch", "mesh_dispatch", "phase_profile",
     "phase_mask", "phase_fuse", "phase_compact", "phase_sort",
     "phase_aggregate", "phase_transfer"})

# every name a span tree of the port may carry: the reference's set
# (which leaves the kernel-level names to their emit sites) plus
# KERNEL_SPAN_NAMES, so one membership test covers a whole tree
SPAN_NAMES = TRACED_PHASES | frozenset(
    {QUERY, BROKER_OVERHEAD, SCATTER, SCATTER_CALL, SERVER_QUERY,
     LEAF_SCAN, JOIN_STAGE, EXCHANGE, WINDOW_STAGE, FINAL_STAGE,
     FUSED_PLAN, COLLECTIVE_EXCHANGE,
     STAGE, STAGE_CALL, STAGE_DISPATCH,
     RAGGED_DISPATCH, CUBE_BUILD, FUSED_EXECUTE,
     VECTOR_SEARCH}) | KERNEL_SPAN_NAMES
