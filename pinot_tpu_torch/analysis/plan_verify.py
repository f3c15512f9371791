"""Plan-IR static verifier: the fused-plan rules.

Port of the PV2xx family of ``pinot_tpu/analysis/plan_verify.py``
(``verify_fused_plan``, ``check_fused_plan``); the kernel-plan rules
(PV1xx) are not ported. The fused program runs one plan SHAPE over
runtime arrays, so a bad static in the plan corrupts results instead of
failing once at plan time; these rules re-derive each invariant from the
plan tree and report structured diagnostics:

    PV201  fused exchange partition-spec/key-dtype inconsistency
    PV202  fused per-shard shape instability across a collective
    PV203  fused-stage accumulator width overflow

``check_fused_plan`` runs fail-fast in multistage/fused.py before the
whole-plan program runs (PINOT_PLAN_VERIFY=0 disables).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

from ..ops import ir
from ..query.sql import SqlError

RULES = {
    "PV201": "fused exchange partition-spec/key-dtype inconsistency",
    "PV202": "fused per-shard shape instability across a collective",
    "PV203": "fused-stage accumulator width overflow",
}


@dataclass(frozen=True)
class Diagnostic:
    rule: str       # PVxxx
    path: str       # location in the plan tree, e.g. "fused.stages[1].max_dup"
    message: str
    fix: str = ""   # suggested fix
    # "error" diagnostics fail the plan fail-fast; "warn" is advisory
    severity: str = "error"

    def __str__(self) -> str:
        s = f"{self.rule} at {self.path}: {self.message}"
        if self.severity != "error":
            s = f"[{self.severity}] " + s
        return s + (f" (fix: {self.fix})" if self.fix else "")


class PlanVerificationError(SqlError):
    """A planned program violates a static invariant: a bug that must
    surface, not a fallback."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = diagnostics
        super().__init__("plan verification failed:\n"
                         + format_diagnostics(diagnostics))


def format_diagnostics(diags: Sequence[Diagnostic]) -> str:
    return "\n".join(f"  {d}" for d in diags)


class _Ctx:
    """Diagnostic sink."""

    def __init__(self):
        self.out: List[Diagnostic] = []

    def diag(self, rule: str, path: str, message: str, fix: str = "",
             severity: str = "error") -> None:
        self.out.append(Diagnostic(rule, path, message, fix, severity))


def verify_fused_plan(fp: "ir.FusedPlan") -> List[Diagnostic]:
    """PV2xx rules over a fused whole-plan IR (ops/ir.FusedPlan).

    The fused program is ONE device program over every stage, so one bad
    static — an exchange partitioned differently from the plan, a key
    dtype the int32 program cannot carry, a stage whose per-shard shape
    drifts across an exchange, a canonical-position domain past the
    accumulator — corrupts every query sharing the shape.
    Rules:

        PV201  exchange partition-spec/key-dtype consistency: every
               exchange runs over the plan's one mesh (partitions
               equal across stages and to the plan), key dtype is the
               int32 the collectives are lowered for, hash exchanges
               carry a pow2 bucket cap, key slots name joined tables
        PV202  per-shard shape stability across collective boundaries:
               base_rows divides over the mesh; a hash exchange's
               received shape (partitions * cap) must cover the shard
               it was fed (rows are dropped silently otherwise);
               max_dup/build_rows are pow2 statics within the dense
               candidate bound
        PV203  accumulator widths: pos_bound (base_rows * prod
               max_dup) must fit the int32 accumulator — the canonical
               row order cannot be restored past it
    """
    c = _Ctx()
    n_stages = len(fp.stages)
    if fp.partitions < 1:
        c.diag("PV201", "fused.partitions",
               f"mesh partition count {fp.partitions} < 1")
    if fp.acc_dtype != "int32":
        c.diag("PV201", "fused.acc_dtype",
               f"accumulator dtype {fp.acc_dtype!r} is not the int32 "
               "the collective lowering carries")
    if fp.base_rows < 1 or fp.base_rows % max(fp.partitions, 1):
        c.diag("PV202", "fused.base_rows",
               f"probe seed of {fp.base_rows} rows does not shard "
               f"evenly over {fp.partitions} devices")
    shard_rows = fp.base_rows // max(fp.partitions, 1)
    pos_bound = fp.base_rows
    for i, st in enumerate(fp.stages):
        path = f"fused.stages[{i}]"
        ex = st.exchange
        if ex.kind not in ("hash", "broadcast"):
            c.diag("PV201", path + ".exchange.kind",
                   f"unknown exchange kind {ex.kind!r}")
        if ex.partitions != fp.partitions:
            c.diag("PV201", path + ".exchange.partitions",
                   f"exchange partitioned over {ex.partitions} devices "
                   f"but the fused mesh has {fp.partitions}",
                   fix="every stage of one fused program shares one "
                       "mesh; replan or route mailbox")
        if ex.key_dtype != "int32":
            c.diag("PV201", path + ".exchange.key_dtype",
                   f"key dtype {ex.key_dtype!r}; the collectives are "
                   "lowered for int32 codes")
        if not ex.key_slots:
            c.diag("PV201", path + ".exchange.key_slots",
                   "exchange carries no key columns")
        for s, owner in enumerate(ex.key_slots):
            if not 0 <= owner <= i:
                c.diag("PV201", path + f".exchange.key_slots[{s}]",
                       f"key slot gathers from table ordinal {owner}, "
                       f"not joined before stage {i}")
        if st.how not in ("inner", "left"):
            c.diag("PV201", path + ".how",
                   f"fused lowering has no {st.how!r} join body")
        if st.max_dup < 1 or st.max_dup & (st.max_dup - 1):
            c.diag("PV202", path + ".max_dup",
                   f"max_dup {st.max_dup} is not a pow2 static")
        if st.build_rows < 1 or st.build_rows & (st.build_rows - 1):
            c.diag("PV202", path + ".build_rows",
                   f"padded build side {st.build_rows} is not pow2 "
                   "(the padded shape is the compile signature)")
        if ex.kind == "hash":
            if ex.cap < 1 or ex.cap & (ex.cap - 1):
                c.diag("PV201", path + ".exchange.cap",
                       f"hash-exchange bucket cap {ex.cap} is not a "
                       "pow2 static")
            elif ex.partitions * ex.cap < shard_rows:
                c.diag("PV202", path + ".exchange.cap",
                       f"received shape {ex.partitions}x{ex.cap} cannot "
                       f"cover the {shard_rows}-row shard it is fed — "
                       "a full bucket would drop live rows silently",
                       fix="raise the bucket cap (slack) or fall back "
                           "to the mailbox plane")
            # post-exchange, every device probes its received buckets
            shard_rows = ex.partitions * ex.cap
        elif ex.cap:
            c.diag("PV201", path + ".exchange.cap",
                   "broadcast exchanges have no bucket; cap must be 0")
        shard_rows *= st.max_dup
        pos_bound *= st.max_dup
    if fp.pos_bound != pos_bound and not any(
            d.rule == "PV202" for d in c.out):
        c.diag("PV202", "fused.pos_bound",
               f"declared pos_bound {fp.pos_bound} != base_rows * "
               f"prod(max_dup) = {pos_bound}")
    if pos_bound > 2**31 - 1 or fp.pos_bound > 2**31 - 1:
        c.diag("PV203", "fused.pos_bound",
               f"canonical-position domain {max(pos_bound, fp.pos_bound)}"
               " overflows the int32 accumulator — order restoration "
               "would alias rows",
               fix="route the plan to the mailbox plane (the fused "
                   "planner's eligibility gate should have)")
    if fp.n_tables != n_stages + 1:
        c.diag("PV202", "fused.n_tables",
               f"{fp.n_tables} tables with {n_stages} join stages "
               "(want n_stages + 1)")
    return c.out


def check_fused_plan(fp: Any) -> None:
    """Fail-fast hook (multistage/fused.py): raise on any ERROR
    diagnostic before the whole-plan program runs. PINOT_PLAN_VERIFY=0
    disables."""
    if not verification_enabled():
        return
    errors = [d for d in verify_fused_plan(fp) if d.severity == "error"]
    if errors:
        raise PlanVerificationError(errors)


def verification_enabled() -> bool:
    return os.environ.get("PINOT_PLAN_VERIFY", "1") != "0"
