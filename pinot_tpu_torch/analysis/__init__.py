"""Static analysis over the port's contract surfaces.

Three passes, one goal: hazards that would race, drift or corrupt
results at RUN time fail loudly at PLAN / LINT time, before a card is
ever attached.

- plan_verify: abstract shape/dtype inference over the ops/ir.py kernel
  plan tree — index bounds, plan-cache hashability, lossless carrier
  narrowing, SUM accumulator width, compaction-capacity invariants,
  strategy gates. tools/check_static.py runs it over the query corpora;
  the planner does not run it per query (the fused whole-plan IR is
  checked fail-fast in multistage/fused.py).
- concur: whole-program concurrency verifier (CC201–CC205) — lock
  guard-map inference (incl. caller-holds-lock), blocking calls and
  torch device syncs under held locks, lock-order cycles over the
  resolved call graph, thread-local state escaping into pool closures,
  check-then-act. Ratcheted at analysis/concur_baseline.json.
- detlint: whole-program determinism & replay-safety verifier
  (DT301–DT305) — wall-clock reads without an injectable escape hatch,
  ambient randomness (torch's global generator included),
  unordered-collection serialization, query-time os.environ reads, and
  completion-order float accumulation, taint propagated from the
  deterministic-plane entry registry through the shared call resolver
  (astutil.py). Ratcheted at analysis/detlint_baseline.json.

Shared plumbing (Finding, ratchet baselines, suppression comments, the
corpus-wide call resolver) lives in astutil.py.

``python -m pinot_tpu_torch.tools.check_static`` runs all three (the
two lint passes over ``pinot_tpu_torch/``, the plan verifier over
every plan the port's planner produces for the SSB + taxi + fuzzer
query corpus).
"""
from .plan_verify import (Diagnostic, PlanVerificationError,  # noqa: F401
                          RULES, check_compiled_plan, format_diagnostics,
                          verify_compiled_plan, verify_kernel_plan)
from .astutil import (Finding, compare_baseline,  # noqa: F401
                      load_baseline, write_baseline)
from .concur import (CONCUR_RULES, Program,  # noqa: F401
                     analyze_source, analyze_tree)
from .detlint import DETLINT_RULES, ROOTS  # noqa: F401
