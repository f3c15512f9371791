"""Sketch, funnel, and collection aggregations (toward the reference's
91 aggregation classes).

Reference parity (pinot-core .../query/aggregation/function/):
- DistinctCountThetaSketchAggregationFunction.java — here a KMV
  (k-minimum-values) sketch: the same theta-sketch estimator family
  (exact below nominalEntries, (k-1)/theta beyond), mergeable by
  keep-k-smallest union. The datasketches wire format is not
  reproduced; serialization is this module's canonical form.
- DistinctCountCPCSketchAggregationFunction.java /
  DistinctCountULLAggregationFunction.java — estimate-equivalent
  HLL-register sketches keyed by lgK/p. True CPC compression is a wire
  concern; the merge/estimate contract (mergeable registers, ~1/sqrt(2^lgK)
  error) is what query semantics observe.
- DistinctCountRaw*AggregationFunction.java / PercentileRaw*.java —
  RAW forms return the serialized sketch instead of the estimate
  (base64(zlib(json(state))), versioned; the reference returns
  datasketches base64 — format documented as this framework's own).
- funnel/FunnelCountAggregationFunction.java — per-step correlated
  distinct sets, finalized by progressive intersection.
- funnel/window/Funnel{MaxStep,MatchStep,CompleteCount}.java — sliding
  window over (timestamp, step) events with
  STRICT_DEDUPLICATION/STRICT_ORDER/STRICT_INCREASE/KEEP_ALL modes,
  reproduced step-for-step from the reference algorithm.
- Distinct{Sum,Avg}AggregationFunction.java, array/ArrayAgg*.java,
  array/ListAggFunction.java, HistogramAggregationFunction.java,
  FrequentLongsSketchAggregationFunction.java (Misra-Gries summary),
  IdSetAggregationFunction.java.
"""
from __future__ import annotations

import base64
import json
import zlib
from collections import deque
from typing import Any, List

import numpy as np

from .aggregations import (AggImpl, HllAgg, HostSel, PercentileSketchAgg,
                           _f64, _hash64, _per_group_apply,
                           _per_group_apply_multi, _py)

THETA_DEFAULT_NOMINAL = 4096
CPC_DEFAULT_LGK = 12
ULL_DEFAULT_P = 12
FREQUENT_DEFAULT_MAP_SIZE = 256
_RAW_VERSION = 1
_TWO64 = float(2 ** 64)


# ---------------------------------------------------------------------------
# distinct-count sketches
# ---------------------------------------------------------------------------

class ThetaSketchAgg(AggImpl):
    """KMV theta sketch: state = sorted list of the k smallest distinct
    64-bit hashes. Exact while |state| < k; beyond, the k-th smallest
    hash IS theta and the estimate is (k-1) / (theta / 2^64)."""

    numeric_input = False

    @property
    def k(self) -> int:
        return int(self.agg.params[0]) if self.agg.params \
            else THETA_DEFAULT_NOMINAL

    def empty(self):
        return []

    def _sketch(self, v: np.ndarray) -> List[int]:
        if v.size == 0:
            return []
        h = np.unique(_hash64(v))          # sorted ascending
        return h[: self.k].tolist()

    def state(self, h: HostSel):
        return self._sketch(h.ev(self.agg.arg))

    def group_states(self, h: HostSel):
        v = h.ev(self.agg.arg)
        return _per_group_apply(v, h.inv, h.n_groups, self._sketch)

    def merge(self, a, b):
        if not a:
            return b
        if not b:
            return a
        u = np.union1d(np.asarray(a, dtype=np.uint64),
                       np.asarray(b, dtype=np.uint64))
        return u[: self.k].tolist()

    def finalize(self, s):
        n = len(s)
        if n < self.k:
            return n
        theta = float(s[-1]) / _TWO64
        return int(round((self.k - 1) / theta))


class CpcSketchAgg(HllAgg):
    """CPC analog: HLL registers at lgK (params[0], default 12).
    Estimate-equivalent to the reference's CPC for query semantics."""

    @property
    def log2m(self) -> int:
        return int(self.agg.params[0]) if self.agg.params \
            else CPC_DEFAULT_LGK


class UllSketchAgg(HllAgg):
    """ULL analog: HLL registers at precision p (params[0], default 12)."""

    @property
    def log2m(self) -> int:
        return int(self.agg.params[0]) if self.agg.params \
            else ULL_DEFAULT_P


# ---------------------------------------------------------------------------
# RAW forms — serialized sketch instead of the estimate
# ---------------------------------------------------------------------------

def serialize_sketch(kind: str, state: Any) -> str:
    """Canonical raw-sketch wire form: base64(zlib(json)). Versioned so
    a future layout change stays decodable."""
    payload = json.dumps({"v": _RAW_VERSION, "kind": kind, "state": state},
                         separators=(",", ":"), default=_py)
    return base64.b64encode(zlib.compress(payload.encode())).decode()


def deserialize_sketch(raw: str) -> Any:
    doc = json.loads(zlib.decompress(base64.b64decode(raw)).decode())
    if doc.get("v") != _RAW_VERSION:
        raise ValueError(f"unknown raw sketch version {doc.get('v')!r}")
    return doc["state"]


class RawAgg(AggImpl):
    """Wraps a sketch impl; finalize returns the serialized sketch."""

    def __init__(self, agg: Any, inner: AggImpl):
        super().__init__(agg)
        self.inner = inner
        self.numeric_input = inner.numeric_input

    def empty(self):
        return self.inner.empty()

    def state(self, h: HostSel):
        return self.inner.state(h)

    def group_states(self, h: HostSel):
        return self.inner.group_states(h)

    def merge(self, a, b):
        return self.inner.merge(a, b)

    def finalize(self, s):
        return serialize_sketch(self.agg.kind, s)


# ---------------------------------------------------------------------------
# funnel family
# ---------------------------------------------------------------------------

class FunnelCountAgg(AggImpl):
    """FUNNELCOUNT(STEPS(c1, ..), CORRELATEBY(col)): agg.arg is the
    correlation expression, agg.arg2 the tuple of step predicates.
    State = per-step sets of correlated values; finalize intersects
    progressively (SetMergeStrategy.extractFinalResult)."""

    numeric_input = False

    @property
    def n_steps(self) -> int:
        return len(self.agg.arg2)

    def empty(self):
        return [set() for _ in range(self.n_steps)]

    def _build(self, corr: np.ndarray, masks: List[np.ndarray]):
        return [set(np.unique(corr[m]).tolist()) if m.any() else set()
                for m in masks]

    def state(self, h: HostSel):
        corr = h.ev(self.agg.arg)
        masks = [np.asarray(h.ev_bool(s), dtype=bool)
                 for s in self.agg.arg2]
        return self._build(corr, masks)

    def group_states(self, h: HostSel):
        corr = h.ev(self.agg.arg)
        masks = [np.asarray(h.ev_bool(s), dtype=bool)
                 for s in self.agg.arg2]
        return _per_group_apply_multi(
            [corr] + masks, h.inv, h.n_groups,
            lambda c, *ms: self._build(c, list(ms)))

    def merge(self, a, b):
        return [sa | sb for sa, sb in zip(a, b)]

    def finalize(self, s):
        out = [len(s[0])]
        cur = s[0]
        for i in range(1, self.n_steps):
            cur = s[i] & cur
            out.append(len(cur))
        return tuple(out)


class _ModeFlags:
    def __init__(self, modes):
        ms = {str(m).upper() for m in modes}
        self.dedup = "STRICT_DEDUPLICATION" in ms
        self.order = "STRICT_ORDER" in ms
        self.increase = "STRICT_INCREASE" in ms


class FunnelWindowAgg(AggImpl):
    """Base for FUNNELMAXSTEP / FUNNELMATCHSTEP / FUNNELCOMPLETECOUNT:
    (timestampExpression, windowSize, numSteps, stepExpr..., [modes]).
    agg.arg = timestamp AST, agg.arg2 = tuple of step predicates,
    params = (window_size, n_steps, *modes). State = list of
    [timestamp, step] events sorted by (timestamp, step) — the
    reference's PriorityQueue<FunnelStepEvent> ordering."""

    numeric_input = False

    @property
    def window(self) -> int:
        return int(self.agg.params[0])

    @property
    def n_steps(self) -> int:
        return int(self.agg.params[1])

    @property
    def modes(self) -> _ModeFlags:
        return _ModeFlags(self.agg.params[2:])

    def empty(self):
        return []

    def _events(self, ts: np.ndarray, masks: List[np.ndarray]):
        # first matching step per row (the reference breaks on first j)
        step = np.full(ts.shape, -1, dtype=np.int64)
        for j in range(len(masks) - 1, -1, -1):
            step = np.where(masks[j], j, step)
        sel = step >= 0
        ev = sorted(zip(ts[sel].tolist(), step[sel].tolist()))
        return [[int(t), int(s)] for t, s in ev]

    def state(self, h: HostSel):
        ts = np.asarray(h.ev(self.agg.arg), dtype=np.int64)
        masks = [np.asarray(h.ev_bool(s), dtype=bool)
                 for s in self.agg.arg2]
        return self._events(ts, masks)

    def group_states(self, h: HostSel):
        ts = np.asarray(h.ev(self.agg.arg), dtype=np.int64)
        masks = [np.asarray(h.ev_bool(s), dtype=bool)
                 for s in self.agg.arg2]
        return _per_group_apply_multi(
            [ts] + masks, h.inv, h.n_groups,
            lambda t, *ms: self._events(t, list(ms)))

    def merge(self, a, b):
        return sorted([list(e) for e in a] + [list(e) for e in b])

    # -- the reference's sliding-window machinery --------------------------
    def _fill_window(self, events: List, pos: int,
                     window: deque) -> int:
        """FunnelBaseAggregationFunction.fillWindow: ensure the window
        starts at a step-0 event, then pull every event inside
        [start, start+windowSize). Returns the new consume position."""
        while window and window[0][1] != 0:
            window.popleft()
        if not window:
            while pos < len(events) and events[pos][1] != 0:
                pos += 1
            if pos >= len(events):
                return pos
            window.append(events[pos])
            pos += 1
        end = window[0][0] + self.window
        while pos < len(events) and events[pos][0] < end:
            window.append(events[pos])
            pos += 1
        return pos

    def _process_window(self, window: deque) -> int:
        """FunnelMaxStepAggregationFunction.processWindow."""
        modes = self.modes
        max_step = 0
        prev_ts = -1
        for t, step in window:
            if modes.dedup and step == max_step - 1:
                return max_step
            if modes.order and step != max_step:
                return max_step
            if modes.increase and prev_ts == t:
                continue
            if max_step == step:
                max_step += 1
                prev_ts = t
            if max_step == self.n_steps:
                break
        return max_step

    def _max_step(self, events: List) -> int:
        final = 0
        window: deque = deque()
        pos = 0
        while pos < len(events) or window:
            pos = self._fill_window(events, pos, window)
            if not window:
                break
            final = max(final, self._process_window(window))
            if final == self.n_steps:
                break
            if window:
                window.popleft()
        return final


class FunnelMaxStepAgg(FunnelWindowAgg):
    def finalize(self, s):
        return self._max_step(s or [])


class FunnelMatchStepAgg(FunnelWindowAgg):
    def finalize(self, s):
        reached = self._max_step(s or [])
        return tuple(1 if i < reached else 0
                     for i in range(self.n_steps))


class FunnelCompleteCountAgg(FunnelWindowAgg):
    def finalize(self, s):
        """FunnelCompleteCountAggregationFunction.extractFinalResult:
        count completed funnel rounds; strict modes RESET the round."""
        events = s or []
        modes = self.modes
        total = 0
        window: deque = deque()
        pos = 0
        while pos < len(events) or window:
            pos = self._fill_window(events, pos, window)
            if not window:
                break
            window_start = window[0][0]
            max_step = 0
            prev_ts = -1
            for t, step in window:
                if modes.dedup and step == max_step - 1:
                    max_step = 0
                if modes.order and step != max_step:
                    max_step = 0
                if modes.increase and prev_ts == t:
                    continue
                prev_ts = t
                if max_step == step:
                    max_step += 1
                if max_step == self.n_steps:
                    total += 1
                    max_step = 0
                    window_start = t
            if window:
                window.popleft()
            while window and window[0][0] < window_start:
                window.popleft()
        return total


# ---------------------------------------------------------------------------
# distinct-input scalar aggregations + collections
# ---------------------------------------------------------------------------

class DistinctSumAgg(AggImpl):
    """DISTINCTSUM / DISTINCTAVG: state = set of distinct values."""

    def __init__(self, agg: Any, avg: bool):
        super().__init__(agg)
        self.avg = avg

    def empty(self):
        return set()

    def _vals(self, v: np.ndarray) -> set:
        return set(np.unique(v).tolist())

    def state(self, h: HostSel):
        return self._vals(h.ev(self.agg.arg))

    def group_states(self, h: HostSel):
        return _per_group_apply(h.ev(self.agg.arg), h.inv, h.n_groups,
                                self._vals)

    def merge(self, a, b):
        return a | b

    def finalize(self, s):
        if not s:
            return None if self.avg else 0
        t = sum(s)
        return t / len(s) if self.avg else _py(np.asarray(t)[()])


class ArrayAggAgg(AggImpl):
    """ARRAYAGG(col[, distinct]) / LISTAGG(col, sep): collected values.
    Cross-segment ordering is merge order (the reference makes the same
    non-guarantee)."""

    numeric_input = False

    def __init__(self, agg: Any, listagg: bool = False):
        super().__init__(agg)
        self.listagg = listagg

    @property
    def distinct(self) -> bool:
        # LISTAGG's params[0] is the separator, never a distinct flag
        return bool(not self.listagg and self.agg.params
                    and self.agg.params[-1] == "distinct")

    @property
    def sep(self) -> str:
        return str(self.agg.params[0]) if self.listagg else ","

    def empty(self):
        return []

    def _collect(self, v: np.ndarray) -> List:
        if self.distinct:
            return [_py(x) for x in np.unique(v)]
        return [_py(x) for x in v]

    def state(self, h: HostSel):
        return self._collect(h.ev(self.agg.arg))

    def group_states(self, h: HostSel):
        return _per_group_apply(h.ev(self.agg.arg), h.inv, h.n_groups,
                                self._collect)

    def merge(self, a, b):
        out = a + b
        if self.distinct:
            seen = set()
            out = [x for x in out if not (x in seen or seen.add(x))]
        return out

    def finalize(self, s):
        if self.listagg:
            return self.sep.join(str(x) for x in s)
        return tuple(s)


class HistogramAgg(AggImpl):
    """HISTOGRAM(col, lower, upper, numBins): equal-width bin counts
    (values outside [lower, upper) are dropped, like the reference)."""

    def empty(self):
        return [0] * int(self.agg.params[2])

    def _counts(self, v: np.ndarray) -> List[int]:
        lo, hi, bins = (float(self.agg.params[0]),
                        float(self.agg.params[1]),
                        int(self.agg.params[2]))
        v = _f64(v)
        v = v[(v >= lo) & (v < hi)]
        if v.size == 0:
            return [0] * bins
        idx = np.floor((v - lo) / (hi - lo) * bins).astype(np.int64)
        return np.bincount(np.clip(idx, 0, bins - 1),
                           minlength=bins).tolist()

    def state(self, h: HostSel):
        return self._counts(h.ev(self.agg.arg))

    def group_states(self, h: HostSel):
        return _per_group_apply(_f64(h.ev(self.agg.arg)), h.inv,
                                h.n_groups, self._counts)

    def merge(self, a, b):
        return [x + y for x, y in zip(a, b)]

    def finalize(self, s):
        return tuple(int(x) for x in s)


class FrequentItemsAgg(AggImpl):
    """FREQUENTLONGSSKETCH / FREQUENTSTRINGSSKETCH: Misra-Gries summary
    capped at maxMapSize (params[0]). Finalize returns the summary as a
    JSON object {value: estimated_count} sorted by count descending —
    the reference returns a datasketches base64 blob; this framework
    surfaces the decoded summary directly (documented deviation)."""

    numeric_input = False

    @property
    def cap(self) -> int:
        return int(self.agg.params[0]) if self.agg.params \
            else FREQUENT_DEFAULT_MAP_SIZE

    def empty(self):
        return {}

    def _prune(self, counts: dict) -> dict:
        if len(counts) <= self.cap:
            return counts
        # Misra-Gries decrement: subtract the (cap+1)-th largest count
        vals = sorted(counts.values(), reverse=True)
        dec = vals[self.cap]
        return {k: c - dec for k, c in counts.items() if c > dec}

    def state(self, h: HostSel):
        u, c = np.unique(h.ev(self.agg.arg), return_counts=True)
        return self._prune({_py(k): int(n) for k, n in zip(u, c)})

    def group_states(self, h: HostSel):
        def one(v):
            u, c = np.unique(v, return_counts=True)
            return self._prune({_py(k): int(n) for k, n in zip(u, c)})
        return _per_group_apply(h.ev(self.agg.arg), h.inv, h.n_groups, one)

    def merge(self, a, b):
        out = dict(a)
        for k, c in b.items():
            out[k] = out.get(k, 0) + c
        return self._prune(out)

    def finalize(self, s):
        items = sorted(s.items(), key=lambda kv: (-kv[1], str(kv[0])))
        return json.dumps({str(k): int(c) for k, c in items})


class TupleSketchAgg(AggImpl):
    """Integer tuple sketch (Sum/AvgValueIntegerTupleSketch analog):
    KMV over hashed keys, each retained entry carrying the SUM of its
    key's values. State = {"t": theta_hash | None, "e": [[hash, sum]]}
    with every retained hash STRICTLY below theta (exclusive sampling
    bound; None = 1.0, the exact regime below k entries). Merge takes
    theta = min of the sides and discards entries past it — an entry
    one side dropped can never survive with a partial sum — then
    re-caps at k. 'sum' finalizes sum_retained / theta (unbiased,
    exact below k); 'avg' is sum/count over retained entries (unbiased
    without scaling)."""

    numeric_input = False   # keys hash; values validated separately

    def __init__(self, agg: Any, mode: str):
        super().__init__(agg)
        self.mode = mode

    @property
    def k(self) -> int:
        return int(self.agg.params[0]) if self.agg.params \
            else THETA_DEFAULT_NOMINAL

    def empty(self):
        return {"t": None, "e": []}

    def _cap(self, entries, theta):
        """Keep the k smallest-hash entries; theta tightens to the
        (k+1)-th smallest so retained hashes stay strictly below it."""
        entries.sort(key=lambda e: e[0])
        if len(entries) > self.k:
            theta_h = entries[self.k][0]
            if theta is None or theta_h < theta:
                theta = theta_h
            entries = [e for e in entries if e[0] < theta][: self.k]
        return {"t": theta, "e": entries}

    def _from_pair(self, keys, vals):
        if len(keys) == 0:
            return {"t": None, "e": []}
        hs = _hash64(np.asarray(keys))
        uniq, inv = np.unique(hs, return_inverse=True)
        sums = np.bincount(inv, weights=np.asarray(vals, np.float64),
                           minlength=len(uniq))
        return self._cap([[int(u), float(s)]
                          for u, s in zip(uniq, sums)], None)

    def _numeric_values(self, h: HostSel) -> np.ndarray:
        """The value argument must be numeric (the key may be anything);
        numeric_input=False skips _typed_ev for the key, so enforce the
        value contract here with a typed SqlError instead of letting
        np.asarray raise a raw numpy ValueError on string columns."""
        vals = np.asarray(h.ev(self.agg.arg2))
        if vals.dtype.kind in "USO" and vals.size:
            from ..query.sql import SqlError
            raise SqlError(
                f"{self.agg.kind.upper()} requires a numeric value "
                f"expression; {self.agg.arg2!r} is a string expression")
        return vals.astype(np.float64)

    def state(self, h: HostSel):
        return self._from_pair(h.ev(self.agg.arg), self._numeric_values(h))

    def group_states(self, h: HostSel):
        keys = h.ev(self.agg.arg)
        vals = self._numeric_values(h)
        return _per_group_apply_multi([keys, vals], h.inv, h.n_groups,
                                      self._from_pair)

    def merge(self, a, b):
        thetas = [t for t in (a.get("t"), b.get("t")) if t is not None]
        theta = min(thetas) if thetas else None
        acc: dict = {}
        for h_, s in list(a["e"]) + list(b["e"]):
            if theta is not None and h_ >= theta:
                continue   # past the tighter side's sampling bound
            acc[h_] = acc.get(h_, 0.0) + s
        return self._cap([[h_, v] for h_, v in acc.items()], theta)

    def finalize(self, s):
        entries = s["e"]
        if not entries:
            return None if self.mode == "avg" else 0.0
        total = sum(v for _h, v in entries)
        if self.mode == "avg":
            return total / len(entries)
        frac = 1.0 if s["t"] is None else float(s["t"]) / _TWO64
        return total / frac


class StUnionAgg(AggImpl):
    """ST_UNION over POINT geometries: the distinct-point union as a
    MULTIPOINT (StUnionAggregationFunction's behavior for point data —
    the overwhelmingly common case; polygon union raises a clear
    not-supported error rather than a wrong answer)."""

    numeric_input = False

    def empty(self):
        return set()

    def _pts(self, v: np.ndarray) -> set:
        from ..geo.geometry import parse_wkb, parse_wkt
        out = set()
        for g in v:
            geom = parse_wkb(g) if isinstance(g, (bytes, bytearray)) \
                else parse_wkt(str(g))
            if geom.kind != "point":
                raise ValueError(
                    "ST_UNION supports POINT geometries only")
            out.add((geom.lng, geom.lat))
        return out

    def state(self, h: HostSel):
        return self._pts(h.ev(self.agg.arg))

    def group_states(self, h: HostSel):
        return _per_group_apply(h.ev(self.agg.arg), h.inv, h.n_groups,
                                self._pts)

    def merge(self, a, b):
        return a | b

    def finalize(self, s):
        from ..geo.geometry import _fmt
        if not s:
            return "MULTIPOINT EMPTY"
        pts = ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in sorted(s))
        return f"MULTIPOINT ({pts})"


class MvWrapAgg(AggImpl):
    """MV variant of any single-input registry impl: per-row value
    lists flatten into one value stream (each value counts once, the
    reference's *MVAggregationFunction contract — e.g.
    DistinctCountHLLMVAggregationFunction, PercentileEstMV...). Group
    context repeats the row's group index per value."""

    def __init__(self, agg: Any, inner: AggImpl):
        super().__init__(agg)
        self.inner = inner
        self.numeric_input = False   # rows are object arrays of lists

    def _flatten(self, rows) -> np.ndarray:
        if len(rows) and not isinstance(rows[0], (list, tuple,
                                                  np.ndarray)):
            # a single-value column here would silently iterate
            # characters (strings) or crash (numerics)
            from ..query.sql import SqlError
            raise SqlError(
                f"{self.agg.kind.upper()} requires a multi-value "
                f"column; {self.agg.arg!r} is single-value")
        flat = [v for r in rows for v in r]
        if not flat:
            return np.array([], dtype=np.float64)
        if any(isinstance(v, str) for v in flat):
            arr = np.asarray(flat, dtype=object)
        else:
            arr = np.asarray(flat)
        if self.inner.numeric_input and arr.dtype.kind in "USO" \
                and arr.size:
            # re-apply the inner impl's input contract on the flattened
            # stream (the outer object-array eval bypassed _typed_ev)
            from ..query.sql import SqlError
            raise SqlError(
                f"{self.agg.kind.upper()} requires numeric input; "
                f"{self.agg.arg!r} is a string expression")
        return arr

    def empty(self):
        return self.inner.empty()

    def state(self, h: HostSel):
        flat = self._flatten(h.ev(self.agg.arg))
        h2 = HostSel(lambda _ast: flat, len(flat))
        return self.inner.state(h2)

    def group_states(self, h: HostSel):
        rows = h.ev(self.agg.arg)
        lens = np.asarray([len(r) for r in rows], dtype=np.int64)
        flat = self._flatten(rows)
        inv2 = np.repeat(h.inv, lens) if len(rows) else \
            np.array([], dtype=np.int64)
        h2 = HostSel(lambda _ast: flat, len(flat), inv2, h.n_groups)
        return self.inner.group_states(h2)

    def merge(self, a, b):
        return self.inner.merge(a, b)

    def finalize(self, s):
        return self.inner.finalize(s)


class IdSetAgg(AggImpl):
    """IDSET(col): serialized set of distinct ids
    (IdSetAggregationFunction; pairs with the IN_ID_SET filter)."""

    numeric_input = False

    def empty(self):
        return set()

    def state(self, h: HostSel):
        return set(np.unique(h.ev(self.agg.arg)).tolist())

    def group_states(self, h: HostSel):
        return _per_group_apply(h.ev(self.agg.arg), h.inv, h.n_groups,
                                lambda v: set(np.unique(v).tolist()))

    def merge(self, a, b):
        return a | b

    def finalize(self, s):
        return serialize_sketch("idset", sorted(_py(x) for x in s))
