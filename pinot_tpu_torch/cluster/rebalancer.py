"""Closed-loop rebalancer: SLO-burn-driven self-healing
placement with incident freeze, churn budgets and crash-safe cutover.

The reference's TableRebalancer (mirrored statically as
``Controller.rebalance()``) moves segments when an operator asks. This
task closes the loop instead: every pass it reads the
fleet rollup's ``slo``/``heat``/``plan_shapes`` blocks (cluster/
rollup.py), computes a **pure move plan** and executes it as crash-safe
three-phase cutovers:

1. **Plan** — ``plan_moves(rollup, assignment, ...)`` is a
   deterministic function of its inputs: tables whose slow-window burn crosses the
   threshold donate their hottest segments from the worst-burn /
   most-loaded holder to the receiver with the best tier-residency
   affinity (heartbeats), capped under a bytes+moves churn
   budget per pass; the plan is EMPTY while any incident is open
   (flight recorder) — never churn placement mid-incident.
2. **Pre-warm** — the receiver is appended to the segment's holders
   (over-replication; ``_reconcile_locked`` keeps both replicas while
   both are live), its next assignment poll downloads + loads the
   segment, and the pass waits for the segment to show in the
   receiver's residency heartbeat (the segment is on the receiver's
   card once its server has loaded it). A stall
   past the deadline (``cutover.stall``) aborts: receiver removed,
   journal cleared, donor keeps serving.
3. **Flip + drain** — donor removed from holders under the
   controller's state machinery (brokers converge via the
   assignment-version epoch on heartbeat responses), then the donor's
   copy drains through the tier's WARM demotion path
   (``TierManager.drain`` — device residents drop, padded host arrays
   stay, no cold re-pad; in-flight queries finish on references they
   already hold).

Crash safety follows the rollup-cursor discipline: a single-move
journal (``rebalance_journal.json``, tmp+rename) records the move
before each irreversible phase. A controller crash / leader failover
mid-move (``rebalance.crash`` fires in the cutover window, before the
flip journal commit) leaves the journal behind; the next pass — same
controller or the new leader over the shared data dir — resumes the
journaled move idempotently (holder append and donor removal are both
idempotent; exactly one final assignment, never a double-assign) or
rolls it back if the receiver never warmed. Torn journal tmp files are
dropped on load (``_clean_orphans``).

Every phase appends a validated ``rebalance_event`` v2 ledger record
(utils/ledger.py — the writer-side contract lives here) to the fleet
ledger and mirrors it into a bounded ring served at controller
``GET /debug/rebalance`` and the webapp Fleet "moves" panel.

Port of ``pinot_tpu/cluster/rebalancer.py``: the same plan, cutover,
journal and ``rebalance_event`` records, so either package's controller
resumes the other's half-done move from ``rebalance_journal.json``. One
kept divergence: the prewarm event's reason is the move's own reason,
because the port has no compile plane to name plan shapes for (the
reference appends ``;stage_shapes=N`` while its compile plane stages).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils import ledger as uledger
from ..utils.faults import FaultInjected, fault_fires, fault_point
from ..utils.metrics import global_metrics

# churn budget defaults: at most this many moves / journalled bytes per
# pass — rebalance heals placement, it must never become the load
DEFAULT_BURN_THRESHOLD = 1.0   # slow-window burn >= 1.0: budget exhausting
DEFAULT_MOVES_PER_PASS = 2
DEFAULT_BYTES_PER_PASS = 256 << 20
PREWARM_TIMEOUT_S = 15.0
PREWARM_POLL_S = 0.05
RING_CAP = 256
# passes a completed move's segment sits out of planning: the slow burn
# window (minutes) outlives a cutover (seconds), so a fresh-enough-looking
# rollup would otherwise nominate the segment straight back (ping-pong)
RECENT_COOLDOWN_PASSES = 5

# receiver affinity from tier residency heartbeats: a copy already on
# device beats a warm copy beats nothing (placement signal)
_AFFINITY = {"hot": 3, "cube": 2, "warm": 1}


class RebalanceCrash(FaultInjected):
    """Injected controller death inside the cutover window (the
    ``rebalance.crash`` point): raised between receiver pre-warm and
    the flip journal commit — recovery must resume from the journal."""


# -- the pure planning plane ----------------------------------------------

def incident_frozen(rollup: Optional[Dict[str, Any]]) -> bool:
    """Freeze predicate: any open incident in the fleet SLO block means
    the pass plans ZERO moves — placement churn during an incident
    destroys the evidence the flight recorder just captured."""
    slo = (rollup or {}).get("slo") or {}
    return int(slo.get("open_incidents", 0) or 0) > 0


def burning_tables(rollup: Optional[Dict[str, Any]],
                   threshold: float = DEFAULT_BURN_THRESHOLD
                   ) -> List[Tuple[str, float]]:
    """(table, worst slow-window burn) for table-scoped objectives at or
    over the threshold, worst first (scope is the deterministic
    tiebreak). Tenant-scoped objectives don't nominate tables — a
    tenant burn names no segments to move."""
    slo = (rollup or {}).get("slo") or {}
    worst: Dict[str, float] = {}
    for o in slo.get("objectives") or []:
        scope = str(o.get("scope") or "")
        if not scope or scope.startswith("tenant:"):
            continue
        burn = float(o.get("burn_slow", 0.0) or 0.0)
        if burn >= threshold and burn > worst.get(scope, 0.0):
            worst[scope] = burn
    return sorted(worst.items(), key=lambda e: (-e[1], e[0]))


def receiver_affinity(instances: Dict[str, Any], table: str,
                      segment: str, instance_id: str) -> int:
    """Residency-affinity score for placing (table, segment) on the
    instance, from its heartbeat residency block."""
    inst = instances.get(instance_id) or {}
    res = ((inst.get("residency") or {}).get(table)) or {}
    return _AFFINITY.get(res.get(segment), 0)


def churn_capped(moves: List[Dict[str, Any]],
                 budget: Optional[Dict[str, Any]] = None
                 ) -> List[Dict[str, Any]]:
    """Budget predicate: the longest rank-order prefix within the
    bytes+moves churn budget. The first move always fits — a segment
    larger than the byte budget must still be movable, just alone."""
    budget = budget or {}
    max_moves = int(budget.get("moves", DEFAULT_MOVES_PER_PASS))
    max_bytes = int(budget.get("bytes", DEFAULT_BYTES_PER_PASS))
    out: List[Dict[str, Any]] = []
    total = 0
    for m in moves:
        if len(out) >= max_moves:
            break
        b = int(m.get("bytes", 0))
        if out and total + b > max_bytes:
            break
        out.append(m)
        total += b
    return out


def plan_moves(rollup: Optional[Dict[str, Any]],
               assignment: Dict[str, Dict[str, List[str]]],
               now: Optional[float] = None,
               budget: Optional[Dict[str, Any]] = None,
               instances: Optional[Dict[str, Any]] = None,
               sizes: Optional[Dict[str, int]] = None,
               recent: Optional[frozenset] = None,
               threshold: float = DEFAULT_BURN_THRESHOLD
               ) -> List[Dict[str, Any]]:
    """The pure move plan: a deterministic function of the fleet rollup
    (slo burn + heat + per-node briefs), the assignment table, the
    instance registry snapshot (role + residency) and the segment size
    map. No wall clock (``now`` is an injected input, reserved for
    age-based policies), no ambient randomness, no IO — execution-side
    impurity (journal, HTTP, sleeps) lives in ClosedLoopRebalanceTask.

    Per burning table (worst burn first), hottest segments first (fleet
    heat rank, name tiebreak): donate from the worst-burn then
    most-loaded holder, receive on the non-holder with the best
    residency affinity, then least load, then least burn, then id.
    ``recent`` (``table/segment`` keys moved within the cooldown —
    execution state, fed in as data) is the anti-flap guard: a burn
    window outlives a cutover, so without it the next pass would read
    the same stale burn and plan the segment straight back. Returns
    ``[]`` while any incident is open; the ranked list is capped by
    ``churn_capped``.
    """
    del now  # deterministic planners take time as data; none needed yet
    if rollup is None or incident_frozen(rollup):
        return []
    assignment = assignment or {}
    instances = instances or {}
    sizes = sizes or {}
    recent = recent or frozenset()
    servers = sorted(i for i in instances
                     if (instances[i] or {}).get("role") == "server")
    if len(servers) < 2:
        return []
    # current per-server replica load: donor/receiver tiebreaks, updated
    # as the plan allocates so one pass spreads rather than piles on
    load: Dict[str, int] = {s: 0 for s in servers}
    for table in sorted(assignment):
        for seg in sorted(assignment[table]):
            for h in assignment[table][seg]:
                if h in load:
                    load[h] += 1
    node_burn: Dict[str, float] = {}
    for n in sorted((rollup.get("nodes") or {})):
        brief = ((rollup["nodes"][n] or {}).get("slo")) or {}
        node_burn[n] = float(brief.get("worst_burn_slow", 0.0) or 0.0)
    heat_rank = {(r.get("table"), r.get("segment")): i
                 for i, r in enumerate(rollup.get("heat") or [])}
    moves: List[Dict[str, Any]] = []
    for table, burn in burning_tables(rollup, threshold):
        segs = assignment.get(table) or {}
        hot_first = sorted(
            segs, key=lambda s: (heat_rank.get((table, s),
                                               len(heat_rank)), s))
        for seg in hot_first:
            if f"{table}/{seg}" in recent:
                continue
            holders = [h for h in segs.get(seg) or [] if h in load]
            if not holders:
                continue
            receivers = [s for s in servers if s not in holders]
            if not receivers:
                continue
            donor = sorted(
                holders,
                key=lambda h: (-node_burn.get(h, 0.0),
                               -load.get(h, 0), h))[0]
            receiver = sorted(
                receivers,
                key=lambda s: (-receiver_affinity(instances, table,
                                                  seg, s),
                               load.get(s, 0),
                               node_burn.get(s, 0.0), s))[0]
            load[donor] -= 1
            load[receiver] += 1
            moves.append({
                "table": table, "segment": seg,
                "donor": donor, "receiver": receiver,
                "bytes": int(sizes.get(f"{table}/{seg}", 0)),
                "reason": f"burn_slow={burn:.3f}",
            })
    return churn_capped(moves, budget)


# -- execution plane -------------------------------------------------------

def _dir_bytes(path: Optional[str]) -> int:
    """On-disk size of a local segment dir (0 for URIs/missing): the
    churn-budget charge. Deterministically ordered walk — sizes feed
    the pure plan as data."""
    if not path or "://" in path or not os.path.isdir(path):
        return 0
    total = 0
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for f in sorted(files):
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


class ClosedLoopRebalanceTask:
    """The leader-gated periodic pass (module docstring). ``run()`` is
    also the manual-trigger body (POST /periodictask/run/
    ClosedLoopRebalance) and the chaos gates' direct entry."""

    NAME = "ClosedLoopRebalance"

    def __init__(self, controller,
                 journal_path: Optional[str] = None,
                 burn_threshold: float = DEFAULT_BURN_THRESHOLD,
                 budget_moves: int = DEFAULT_MOVES_PER_PASS,
                 budget_bytes: int = DEFAULT_BYTES_PER_PASS,
                 prewarm_timeout: float = PREWARM_TIMEOUT_S):
        self.controller = controller
        self.journal_path = journal_path or os.path.join(
            controller.data_dir, "rebalance_journal.json")
        self.burn_threshold = burn_threshold
        self.budget_moves = budget_moves
        self.budget_bytes = budget_bytes
        self.prewarm_timeout = prewarm_timeout
        # _run_lock serializes whole passes (periodic fire vs manual
        # trigger vs direct run()); _lock guards the served ring/
        # counters so GET /debug/rebalance never reads mid-mutation.
        # Blocking under _run_lock is BY DESIGN (the rollup-task
        # pattern): a pass IS journal writes, controller flips and
        # pre-warm waits, and nothing latency-sensitive ever contends
        # on it — snapshot()/the REST surface take only _lock. The
        # CC202 suppressions below all carry this rationale.
        self._run_lock = threading.Lock()
        self._lock = threading.Lock()
        self._ring: List[Dict[str, Any]] = []  # guarded-by: _lock
        self.passes = 0             # guarded-by: _lock
        self.moves_executed = 0     # guarded-by: _lock
        self.moves_aborted = 0      # guarded-by: _lock
        self.moves_resumed = 0      # guarded-by: _lock
        self.frozen_passes = 0      # guarded-by: _lock
        self.last_plan: List[Dict[str, Any]] = []  # guarded-by: _lock
        # anti-flap cooldown: "table/segment" -> pass number the key
        # expires at; fed to plan_moves as a frozenset (pure input)
        self._recent: Dict[str, int] = {}  # guarded-by: _lock
        self._clean_orphans()

    # -- journal (rollup-cursor discipline: tmp+rename, torn tmp dropped) --
    def _journal(self, state: Dict[str, Any]) -> None:
        tmp = self.journal_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(state, fh)
        os.replace(tmp, self.journal_path)  # concur: ok CC202

    def _unjournal(self) -> None:
        try:
            os.unlink(self.journal_path)
        except OSError:
            pass

    def _load_journal(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self.journal_path) as fh:
                state = json.load(fh)
        except (OSError, ValueError):
            return None
        return state if isinstance(state, dict) and \
            isinstance(state.get("move"), dict) else None

    def _clean_orphans(self) -> None:
        """A crash mid-journal-write leaves ``.tmp`` behind; the rename
        never landed, so the committed journal (if any) is the truth —
        drop the orphan."""
        tmp = self.journal_path + ".tmp"
        try:
            os.unlink(tmp)
        except OSError:
            pass

    # -- audit stream ------------------------------------------------------
    def _event(self, phase: str, move: Dict[str, Any],
               reason: Optional[str] = None, planned: bool = True
               ) -> Dict[str, Any]:
        rec = uledger.make_record(
            "rebalance_event",
            table=str(move.get("table", "*")),
            segment=str(move.get("segment", "*")),
            donor=str(move.get("donor", "")),
            receiver=str(move.get("receiver", "")),
            phase=phase,
            reason=reason if reason is not None
            else str(move.get("reason", "")),
            bytes=int(move.get("bytes", 0)),
            planned=bool(planned))
        try:
            uledger.append_record(rec,
                                  self.controller.rollup.ledger_path)
        except OSError:
            pass  # ledger dir gone mid-teardown: the ring still serves
        with self._lock:
            self._ring.append(rec)
            if len(self._ring) > RING_CAP:
                del self._ring[: len(self._ring) - RING_CAP]
        global_metrics.count("rebalance_events")
        global_metrics.count(f"rebalance_{phase}")
        return rec

    # -- plan inputs (execution-side snapshot, fed to the pure plan) -------
    def _plan_inputs(self) -> Dict[str, Any]:
        c = self.controller
        now = time.monotonic()
        with c._lock:
            assignment = json.loads(json.dumps(c._state["assignment"]))
            locations = {
                t: {s: (e or {}).get("location")
                    for s, e in segs.items()}
                for t, segs in c._state["segments"].items()}
            instances = {
                i["id"]: {"role": i.get("role"),
                          "residency": i.get("residency")}
                for i in c._instances.values()
                if now - i["lastHeartbeat"] <= c.heartbeat_timeout}
        sizes: Dict[str, int] = {}
        for t in sorted(locations):
            for s in sorted(locations[t]):
                sizes[f"{t}/{s}"] = _dir_bytes(locations[t][s])
        return {"assignment": assignment, "instances": instances,
                "sizes": sizes}

    def _budget(self) -> Dict[str, int]:
        return {"moves": self.budget_moves, "bytes": self.budget_bytes}

    # -- the pass ----------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        with self._run_lock:
            return self._run_locked()  # concur: ok CC202

    def _run_locked(self) -> Dict[str, Any]:
        self._clean_orphans()
        rollup = (self.controller.rollup.snapshot() or {}).get("rollup")
        # a journaled move from a crashed pass / failed-over leader
        # finishes FIRST, even under freeze: abandoning a half-flipped
        # move is worse than finishing it — crash safety beats policy
        resumed = self._recover()  # concur: ok CC202
        if rollup is not None and incident_frozen(rollup):
            with self._lock:
                self.frozen_passes += 1
                self.passes += 1
                self.last_plan = []
            self._event("freeze", {}, reason="incident_open",
                        planned=False)
            return {"planned": 0, "executed": 0, "aborted": 0,
                    "resumed": resumed, "frozen": True}
        if resumed:
            # a resumed move came from an OLDER pass's plan and just
            # changed placement; this pass's rollup predates it, so any
            # fresh plan would be stale-on-arrival (and can nominate the
            # just-moved segment back). Plan on the next pass instead.
            with self._lock:
                self.passes += 1
                self.last_plan = []
            return {"planned": 0, "executed": 0, "aborted": 0,
                    "resumed": resumed, "frozen": False}
        inputs = self._plan_inputs()
        with self._lock:
            recent = frozenset(k for k, exp in self._recent.items()
                               if exp > self.passes)
        moves = plan_moves(rollup, inputs["assignment"],
                           budget=self._budget(),
                           instances=inputs["instances"],
                           sizes=inputs["sizes"],
                           recent=recent,
                           threshold=self.burn_threshold)
        with self._lock:
            self.last_plan = [dict(m) for m in moves]
        executed = aborted = 0
        for m in moves:
            self._event("plan", m)
            if self._execute_move(m) == "done":  # concur: ok CC202
                executed += 1
            else:
                aborted += 1
        with self._lock:
            self.passes += 1
        return {"planned": len(moves), "executed": executed,
                "aborted": aborted, "resumed": resumed, "frozen": False}

    def _recover(self) -> int:
        st = self._load_journal()
        if st is None:
            return 0
        move = st["move"]
        phase = str(st.get("phase", "prewarm"))
        self._event("resume", move, reason=f"journal:{phase}")
        with self._lock:
            self.moves_resumed += 1
        self._execute_move(move, resume_phase=phase)  # concur: ok CC202
        return 1

    # -- the three-phase cutover -------------------------------------------
    def _execute_move(self, move: Dict[str, Any],
                      resume_phase: Optional[str] = None) -> str:
        site = f"rebalance/{move['table']}/{move['segment']}"
        if resume_phase is None:
            self._journal({"move": move,  # concur: ok CC202
                           "phase": "prewarm"})
            self._event("prewarm", move,
                        reason=self._prewarm_reason(move))
        if resume_phase != "flip":
            # phase 1: over-replicate onto the receiver (idempotent —
            # a resumed prewarm re-appends and re-waits)
            self._add_holder(move)  # concur: ok CC202
            stalled = False
            try:
                fault_point("cutover.stall", site)
            except OSError:
                stalled = True
            if stalled or not self._wait_prewarm(move):  # concur: ok CC202
                # abort: the donor never stopped serving; roll the
                # receiver back out and clear the journal
                self._remove_holder(move,  # concur: ok CC202
                                    move["receiver"])
                self._unjournal()
                self._event("abort", move, reason="prewarm_timeout")
                with self._lock:
                    self.moves_aborted += 1
                return "aborted"
            # the cutover window: a controller death here (before the
            # flip journal commit) must resume from the prewarm journal
            if fault_fires("rebalance.crash", site):
                raise RebalanceCrash(
                    f"injected fault rebalance.crash ({site})")
            self._journal({"move": move,  # concur: ok CC202
                           "phase": "flip"})
        # phase 2: flip — remove the donor under the controller's state
        # machinery; brokers converge on the heartbeat epoch
        self._event("flip", move)
        self._remove_holder(move, move["donor"])  # concur: ok CC202
        # phase 3: drain the donor's copy via WARM demotion (no cold
        # re-pad; in-flight queries finish on refs they already hold)
        self._event("drain", move)
        from ..engine.tier import global_tier
        global_tier.drain(move["segment"], reason="rebalance",
                          table=move["table"])
        self._unjournal()
        with self._lock:
            self.moves_executed += 1
            self._recent[f"{move['table']}/{move['segment']}"] = \
                self.passes + RECENT_COOLDOWN_PASSES
        return "done"

    def _prewarm_reason(self, move: Dict[str, Any]) -> str:
        """The prewarm record's reason: the move's own. The reference
        names the table's top plan shapes here while its compile plane
        stages; the port runs eagerly and has none to name."""
        return str(move.get("reason", ""))

    def _add_holder(self, move: Dict[str, Any]) -> None:
        c = self.controller
        with c._lock:
            holders = c._state["assignment"].setdefault(
                move["table"], {}).setdefault(move["segment"], [])
            if move["receiver"] not in holders:
                holders.append(move["receiver"])
                c._bump()  # concur: ok CC202

    def _remove_holder(self, move: Dict[str, Any],
                       instance_id: str) -> None:
        c = self.controller
        with c._lock:
            holders = c._state["assignment"].get(
                move["table"], {}).get(move["segment"])
            # never strand a segment at zero holders: the donor only
            # leaves once another replica is in the holder list
            if holders and instance_id in holders and len(holders) > 1:
                holders.remove(instance_id)
                c._bump()  # concur: ok CC202

    def _wait_prewarm(self, move: Dict[str, Any]) -> bool:
        """Block until the receiver's residency heartbeat shows the
        segment loaded (any tier — presence means the download+load
        completed), or the deadline passes."""
        c = self.controller
        deadline = time.monotonic() + self.prewarm_timeout
        while time.monotonic() < deadline:
            with c._lock:
                inst = c._instances.get(move["receiver"]) or {}
                res = ((inst.get("residency") or {})
                       .get(move["table"])) or {}
            if move["segment"] in res:
                return True
            time.sleep(PREWARM_POLL_S)  # concur: ok CC202
        return False

    # -- serving (GET /debug/rebalance, webapp Fleet moves panel) ----------
    def snapshot(self, limit: int = RING_CAP) -> Dict[str, Any]:
        pending = self._load_journal()  # file IO outside _lock
        with self._lock:
            ring = [dict(r) for r in self._ring[-max(limit, 0):]]
            return {"passes": self.passes,
                    "executed": self.moves_executed,
                    "aborted": self.moves_aborted,
                    "resumed": self.moves_resumed,
                    "frozen_passes": self.frozen_passes,
                    "burn_threshold": self.burn_threshold,
                    "budget": {"moves": self.budget_moves,
                               "bytes": self.budget_bytes},
                    "pending": pending,
                    "cooldown": sorted(
                        k for k, exp in self._recent.items()
                        if exp > self.passes),
                    "last_plan": [dict(m) for m in self.last_plan],
                    "count": len(ring), "moves": ring}
