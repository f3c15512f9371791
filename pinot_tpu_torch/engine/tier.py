"""Device-tiered segment store: hot / warm / cold under ONE device budget.

Port of ``pinot_tpu/engine/tier.py``. Without it every device cache of the
port (the segment columns of ``segment/immutable`` and the stacked copies
of ``engine/batch``) grows without bound, and a table larger than the card
ends in a CUDA out-of-memory error.

- **hot**: a segment's padded columns resident on the device (the
  uid-keyed ``ImmutableSegment._device`` cache);
- **warm**: the padded host arrays kept after a demotion, ready to upload
  again without re-reading and re-padding the memmap;
- **cold**: memmap on disk only (the state every segment loads in).

Admission is driven by use: any ``device_col`` upload promotes the
segment hot and charges the shared budget. The budget is ONE number,
``PINOT_HBM_BUDGET_BYTES`` (also the resident-vs-streamed router knob of
engine/pipeline.py) or ``configure(budget_bytes=...)``, summed across
every devmem pool (utils/devmem.POOLS). An over-budget admission demotes
the **coldest** hot segments first, ranked by ``utils/heat.SegmentHeat``'s
time-decayed scores with the uid as the deterministic tiebreak: the same
heat sequence always gives the same promote/demote decisions
(``decisions`` is the replayable log). Demoting a segment drops its device
columns AND every stacked copy that contains it, so the accounting
reconciles exactly across demotions. A query touching a demoted segment
re-promotes through the normal ``device_col`` path, with the same rows
whatever the tier placement (same arrays, same kernels).

Enforcement is edge-triggered and slightly soft: the budget is checked at
every admission with the admitting working set protected (demoting the
segment a query is mid-upload on would thrash), so one admission whose
group IS the whole hot set can overshoot until the next admission. The
default budget is unbounded (env var absent), and warm host copies are
only kept while a budget is armed.

``on_access`` is a hook on every column read and group dispatch: the
fault plane's ``tier.evict`` point (``utils/faults``, site key the
segment's name) fires there and demotes the segment mid-query with
reason ``"fault"``; the query re-promotes it through ``device_col`` and
gives the same rows. One ``is None`` check when no plan is installed.

Counters and gauges: ``tier_promotions`` / ``tier_demotions`` and the
occupancy gauges (``tier_hot_bytes`` etc.) in ``utils/metrics``.
"""
from __future__ import annotations

import os
import threading
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Set, Tuple

from ..utils import faults
from ..utils.devmem import POOLS, global_device_memory, nbytes_of
from ..utils.heat import global_segment_heat
from ..utils.metrics import global_metrics

TIER_HOT, TIER_WARM, TIER_COLD = "hot", "warm", "cold"
MAX_DECISIONS = 4096
_UNSET = object()


def env_budget_bytes() -> Optional[int]:
    """The tier budget from PINOT_HBM_BUDGET_BYTES, only when set (None =
    unbounded; engine/pipeline.py's group router has its own default for
    the resident-vs-streamed decision)."""
    raw = os.environ.get("PINOT_HBM_BUDGET_BYTES")
    if not raw:
        return None
    try:
        return max(int(raw), 1)
    except ValueError:
        return None


def env_warm_budget_bytes() -> Optional[int]:
    """Optional host-side warm-tier bound (PINOT_WARM_BUDGET_BYTES): over
    it, the coldest warm segments drop to cold (memmap only)."""
    raw = os.environ.get("PINOT_WARM_BUDGET_BYTES")
    if not raw:
        return None
    try:
        return max(int(raw), 1)
    except ValueError:
        return None


class TierManager:
    """The hot/warm/cold segment state machine (module docstring).

    Thread discipline: ``_lock`` is a LEAF lock. It guards only the
    registry, state and log, and is NEVER held while calling into a
    segment's demotion path (which takes the segment's ``_res_lock`` and
    the stack cache's lock); victims are chosen under the lock, demoted
    outside it. A re-admission between the two is benign: the state heals
    at the next transition and the data path re-promotes either way."""

    def __init__(self, devmem=None, heat=None,
                 budget_bytes: Optional[int] = None,
                 warm_budget_bytes: Optional[int] = None):
        self._devmem = devmem if devmem is not None else \
            global_device_memory
        self._heat = heat if heat is not None else global_segment_heat
        self._lock = threading.Lock()
        self._refs: Dict[int, Any] = {}            # uid -> weakref
        self._state: Dict[int, str] = {}           # uid -> tier
        self._names: Dict[int, str] = {}           # uid -> segment name
        self._warm_bytes: Dict[int, int] = {}      # uid -> host bytes
        # uids of collected segments, appended by the weakref callbacks
        # WITHOUT the lock (GC can run a callback on a thread already
        # holding _lock) and drained by _reap_locked
        self._dead: List[int] = []
        self._budget = budget_bytes                # None -> env
        self._warm_budget = warm_budget_bytes      # None -> env
        # thread-local pin set: the segments of the group THIS thread is
        # running (engine/batch, engine/executor) are never demotion
        # victims, or an admission mid-stack would evict its own working
        # set
        self._pins = threading.local()
        self.promotions = 0
        self.demotions = 0
        # replayable decision log: (action, segment, from, to, reason)
        self.decisions: List[Tuple[str, str, str, str, str]] = []

    # -- configuration -----------------------------------------------------
    @property
    def budget_bytes(self) -> Optional[int]:
        return self._budget if self._budget is not None \
            else env_budget_bytes()

    @property
    def warm_budget_bytes(self) -> Optional[int]:
        return self._warm_budget if self._warm_budget is not None \
            else env_warm_budget_bytes()

    @property
    def armed(self) -> bool:
        """True when a device budget is in force (warm host copies are
        only stashed while armed)."""
        return self.budget_bytes is not None

    def configure(self, budget_bytes: Any = _UNSET,
                  warm_budget_bytes: Any = _UNSET) -> None:
        """Set or clear the budgets from code (None reverts to the env)."""
        if budget_bytes is not _UNSET:
            self._budget = budget_bytes
        if warm_budget_bytes is not _UNSET:
            self._warm_budget = warm_budget_bytes
        self.enforce()

    # -- bookkeeping ---------------------------------------------------------
    def _reap_locked(self) -> None:  # holds-lock: _lock
        while self._dead:
            uid = self._dead.pop()
            self._refs.pop(uid, None)
            self._state.pop(uid, None)
            self._names.pop(uid, None)
            self._warm_bytes.pop(uid, None)

    def _register_locked(self, segment) -> None:  # holds-lock: _lock
        self._reap_locked()
        uid = segment.uid
        if uid not in self._refs:
            # the callback appends without the lock: list.append is atomic
            # under the GIL, and taking _lock there could self-deadlock
            self._refs[uid] = weakref.ref(
                segment, lambda _r, u=uid: self._dead.append(u))  # concur: ok CC201
            self._names[uid] = segment.name
            self._state[uid] = TIER_COLD

    def _log_locked(self, action: str, name: str, frm: str, to: str,
                    reason: str) -> None:  # holds-lock: _lock
        self.decisions.append((action, name, frm, to, reason))
        if len(self.decisions) > MAX_DECISIONS:
            del self.decisions[: MAX_DECISIONS // 2]

    def note_warm(self, uid: int, delta: int) -> None:
        """Warm host-array accounting (segment/immutable stashes and drops
        padded host copies through here)."""
        with self._lock:
            n = self._warm_bytes.get(uid, 0) + int(delta)
            if n > 0:
                self._warm_bytes[uid] = n
            else:
                self._warm_bytes.pop(uid, None)

    def _hbm_bytes(self) -> int:
        """Live device bytes across ALL accounted pools: the one number
        the shared budget compares against."""
        return sum(self._devmem.pool_bytes(p) for p in POOLS)

    # -- transitions ---------------------------------------------------------
    def admitted(self, segment) -> None:
        """A device-cache insert landed for ``segment`` (the ONE admission
        edge: segment/immutable._cache_device). Registers the segment,
        counts the cold/warm -> hot promotion, then enforces the shared
        budget with this segment protected."""
        uid = segment.uid
        promoted = False
        with self._lock:
            self._register_locked(segment)
            prev = self._state.get(uid, TIER_COLD)
            if prev != TIER_HOT:
                self._state[uid] = TIER_HOT
                self.promotions += 1
                self._log_locked("promote", segment.name, prev, TIER_HOT,
                                 "access")
                promoted = True
        if promoted:
            global_metrics.count("tier_promotions")
        self.enforce(protect={uid})

    def on_access(self, segment) -> None:
        """Hook on every column read (segment/immutable.device_col) and
        group dispatch (engine/batch): under a fault plan the
        ``tier.evict`` point forces a demotion mid-query (the query then
        re-promotes and must give the same rows)."""
        if faults.fault_fires("tier.evict", key=segment.name):
            self.demote(segment, TIER_WARM, reason="fault")

    def demote(self, segment, to: str = TIER_WARM,
               reason: str = "") -> bool:
        """Device -> host: drop the segment's device residents (and every
        stacked copy containing it); the padded host arrays stay warm
        unless ``to=TIER_COLD`` (host -> disk, memmap only). True when a
        transition happened."""
        uid = segment.uid
        drop_warm = to == TIER_COLD
        with self._lock:
            self._register_locked(segment)
            prev = self._state.get(uid, TIER_COLD)
            if prev == TIER_COLD or (prev == TIER_WARM and not drop_warm):
                return False
            self._state[uid] = to
            self.demotions += 1
            self._log_locked("demote", segment.name, prev, to,
                             reason or "explicit")
        # the demotion body runs OUTSIDE _lock (it takes the segment's and
        # the stack cache's locks; _lock stays a leaf)
        segment.demote_device(drop_warm=drop_warm)
        global_metrics.count("tier_demotions")
        self._export()
        return True

    def drain(self, name: str, reason: str = "drain",
              table: Optional[str] = None) -> int:
        """Rebalance drain entry point (cluster/rebalancer.py): warm-demote
        every live HOT copy of the named segment. Its device residents
        drop (the segment-column pool and every stacked copy holding it),
        the padded host arrays stay warm, so a copy touched again needs
        no cold re-pad, and in-flight queries finish on the tensors they
        already hold. In-process replicas register distinct segment
        objects under one name and a drain demotes them all (a receiver
        that just pre-warmed re-promotes from its warm arrays on first
        touch; rows are unaffected). Segment names recur across tables
        too, so ``table`` limits the drain to copies whose schema carries
        that table. Returns the demotions performed."""
        with self._lock:
            self._reap_locked()
            uids = sorted(uid for uid, n in self._names.items()
                          if n == name
                          and self._state.get(uid) == TIER_HOT)
            segs = []
            for uid in uids:
                ref = self._refs.get(uid)
                seg = ref() if ref is not None else None
                if seg is None:
                    continue
                if table is not None and \
                        getattr(getattr(seg, "schema", None),
                                "name", None) != table:
                    continue
                segs.append(seg)
        n = 0
        for seg in segs:  # demote takes _lock itself (leaf): call outside
            if self.demote(seg, TIER_WARM, reason=reason):
                n += 1
        return n

    def on_evicted(self, segment) -> None:
        """ImmutableSegment.evict_device (unload): the segment left the
        hierarchy; mark it cold without counting a demotion (an unload is
        not a budget decision)."""
        with self._lock:
            if segment.uid in self._state:
                self._state[segment.uid] = TIER_COLD
            self._warm_bytes.pop(segment.uid, None)
        self._export()

    # -- budget enforcement --------------------------------------------------
    @contextmanager
    def pinned(self, uids):
        """Pin a working set for the enclosed dispatch on THIS thread:
        pinned segments are never budget-demotion victims. Pins nest; a
        demotion forced through ``on_access`` ignores them on purpose."""
        prev = getattr(self._pins, "uids", frozenset())
        self._pins.uids = prev | set(uids)
        try:
            yield
        finally:
            self._pins.uids = prev

    def enforce(self, protect: Optional[Set[int]] = None) -> int:
        """Demote coldest-first until the device is back under budget; the
        ``protect`` uids plus this thread's pinned working set are never
        victims. Returns the number of demotions."""
        budget = self.budget_bytes
        n = 0
        if budget is not None:
            protect = (protect or frozenset()) \
                | getattr(self._pins, "uids", frozenset())
            total = self._hbm_bytes()
            if total > budget:
                scores = self._heat.scores()
                for _score, _uid, seg in self._victims(scores, TIER_HOT,
                                                       protect):
                    if total <= budget:
                        break
                    if self.demote(seg, TIER_WARM, reason="budget"):
                        n += 1
                        total = self._hbm_bytes()
        n += self._enforce_warm()
        if n:
            self._export()
        return n

    def _victims(self, scores: Dict[Any, float], state: str,
                 protect: Set[int]) -> List[Tuple[float, int, Any]]:
        """Live candidate segments in ``state``, coldest-first with the
        uid as the deterministic tiebreak."""
        with self._lock:
            cands = sorted(
                (scores.get(uid, 0.0), uid)
                for uid, st in self._state.items()
                if st == state and uid not in protect and uid in self._refs)
        out = []
        for score, uid in cands:
            with self._lock:
                ref = self._refs.get(uid)
            seg = ref() if ref is not None else None
            if seg is not None:
                out.append((score, uid, seg))
        return out

    def _enforce_warm(self) -> int:
        budget = self.warm_budget_bytes
        if budget is None:
            return 0
        with self._lock:
            total = sum(self._warm_bytes.values())
        if total <= budget:
            return 0
        n = 0
        scores = self._heat.scores()
        for _score, _uid, seg in self._victims(scores, TIER_WARM,
                                               frozenset()):
            if total <= budget:
                break
            if self.demote(seg, TIER_COLD, reason="warm_budget"):
                n += 1
            with self._lock:
                total = sum(self._warm_bytes.values())
        # HOT segments stash warm copies too (for their eventual
        # demotion): when warm victims alone cannot reach the budget, trim
        # the coldest hot segments' stashes WITHOUT touching their device
        # residents (the next demotion re-pads from the memmap instead)
        if total > budget:
            for _score, _uid, seg in self._victims(scores, TIER_HOT,
                                                   frozenset()):
                if total <= budget:
                    break
                drop = getattr(seg, "drop_warm", None)
                if drop is not None and drop():
                    # logged only when a stash dropped: the log stays a
                    # faithful replay, not a visit trace
                    self._log_warm_trim(seg)
                with self._lock:
                    total = sum(self._warm_bytes.values())
        return n

    def _log_warm_trim(self, segment) -> None:
        with self._lock:
            self._log_locked("trim_warm", segment.name, TIER_HOT, TIER_HOT,
                             "warm_budget")

    # -- serving -------------------------------------------------------------
    def occupancy(self) -> Dict[str, Any]:
        """{tier: {segments, bytes}}. Hot bytes are the segment-column
        pool (stacked copies are charged to their own pool); warm bytes
        are the stashed host arrays."""
        with self._lock:
            counts = {TIER_HOT: 0, TIER_WARM: 0, TIER_COLD: 0}
            for st in self._state.values():
                counts[st] = counts.get(st, 0) + 1
            warm_b = sum(self._warm_bytes.values())
        return {
            "hot": {"segments": counts[TIER_HOT],
                    "bytes": self._devmem.pool_bytes("segment_cols")},
            "warm": {"segments": counts[TIER_WARM], "bytes": warm_b},
            "cold": {"segments": counts[TIER_COLD]},
        }

    def snapshot(self) -> Dict[str, Any]:
        budget = self.budget_bytes
        out = {
            "armed": budget is not None,
            "budget_bytes": budget or 0,
            "hbm_used_bytes": self._hbm_bytes(),
            "promotions": self.promotions,
            "demotions": self.demotions,
            **self.occupancy(),
        }
        self._export(out)
        return out

    def _export(self, snap: Optional[Dict[str, Any]] = None) -> None:
        """Mirror occupancy into global_metrics gauges."""
        s = snap if snap is not None else {
            "budget_bytes": self.budget_bytes or 0,
            "hbm_used_bytes": self._hbm_bytes(),
            **self.occupancy()}
        global_metrics.gauge("tier_budget_bytes", s["budget_bytes"])
        global_metrics.gauge("tier_hbm_used_bytes", s["hbm_used_bytes"])
        for t in (TIER_HOT, TIER_WARM):
            global_metrics.gauge(f"tier_{t}_bytes", s[t]["bytes"])
            global_metrics.gauge(f"tier_{t}_segments", s[t]["segments"])
        global_metrics.gauge("tier_cold_segments", s["cold"]["segments"])

    def clear(self) -> None:
        """Forget every registration, counter and budget (the segments'
        own caches are untouched)."""
        with self._lock:
            self._refs.clear()
            self._state.clear()
            self._names.clear()
            self._warm_bytes.clear()
            del self._dead[:]
            self.promotions = 0
            self.demotions = 0
            self.decisions = []
        self._budget = None
        self._warm_budget = None


def segment_tier(segment) -> str:
    """Observed tier of one segment object: hot = device residents, warm
    = stashed padded host arrays, else cold."""
    if getattr(segment, "_device", None):
        return TIER_HOT
    if getattr(segment, "_warm", None):
        return TIER_WARM
    return TIER_COLD


def tier_health(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """Live occupancy plus the affinity-routing hit ratio derived from a
    metrics snapshot's counters."""
    c = snapshot.get("counters", {})
    hits = c.get("tier_affinity_hits", 0)
    misses = c.get("tier_affinity_misses", 0)
    out = dict(global_tier.snapshot())
    out["affinity_hits"] = hits
    out["affinity_misses"] = misses
    out["affinity_hit_ratio"] = round(hits / (hits + misses), 4) \
        if hits + misses else None
    return out


def reconcile_devmem(segments) -> Dict[str, Dict[str, int]]:
    """Tracked-vs-actual bytes of the port's six pools: the check that
    no promote/demote/evict path leaks accounting. ``segments`` is the
    live segment set whose device caches (and their loaded rollups') back
    the segment_cols pool; the actual bytes are read from
    ``ImmutableSegment._device``, every live
    vector index reader (index/vector.live_readers),
    ``engine/batch._STACK_CACHE``, the cube cache's per-segment and
    stacked entries (ops/plan_cache.global_cube_cache) and every live
    mesh-resident table's stacks (parallel/distributed.live_tables).
    Verification only, never on a serving path."""
    from ..index import vector as vix
    from ..ops.plan_cache import global_cube_cache
    from ..parallel import distributed
    from . import batch
    actual = {
        "mesh_stack": sum(t.device_bytes()
                          for t in distributed.live_tables()),
        "segment_cols": sum(int(t.nbytes) for s in segments
                            for r in [s, *s.rollup_segments()]
                            for t in list(r._device.values())),
        "vector": sum(r.device_bytes() for r in vix.live_readers()),
        "stack_cache": sum(nbytes_of(v)
                           for v in list(batch._STACK_CACHE.values())),
        "cube_cache": sum(
            nbytes_of(v) for v in list(global_cube_cache._entries.values())),
        "cube_stacked": sum(
            nbytes_of(v) for v in list(global_cube_cache._stacked.values())),
    }
    snap = global_device_memory.snapshot()
    return {p: {"tracked": snap.get(p, {}).get("bytes", 0),
                "actual": actual[p]} for p in POOLS}


global_tier = TierManager()
