"""Span tracer: one tree of timed, annotated spans per query.

Port of ``pinot_tpu/utils/spans.py``: the same ``Span``/``SpanTracer``
API, the same span names (``utils/phases.py``) and ``sample_decision``.
Reference parity: Pinot's per-request ``Tracing``/``ServerQueryPhase``
timers (pinot-spi trace SPI), generalized to attribute query time as
plan -> phase -> device execute -> transfer.

Unlike utils/trace.py (flat phase wall-ms for the response envelope),
spans form a TREE: each span has a name, wall-ms duration, free-form
attributes, and children. The planner annotates the plan span with its
cost-model decision trace; the plan cache annotates hit/miss; the
executor fences device execution against the host transfer
(``device_fence``) and records estimated vs measured selectivity; the
batch paths record per-dispatch fan-out and the compaction capacity
they ran with.

Zero cost when inactive: ``span()`` returns one shared null context
unless a root was started on this thread (the reference builds a
generator context manager per call), so the instrumentation lives on hot
paths (per-segment launches) permanently. EXPLAIN ANALYZE (query/explain.py)
renders the tree.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, List, Optional


class Span:
    """One timed node: name, wall duration, attributes, children."""

    __slots__ = ("name", "attrs", "children", "_t0", "duration_ms")

    def __init__(self, name: str, **attrs: Any):
        self.name = name
        self.attrs: Dict[str, Any] = dict(attrs)
        self.children: List["Span"] = []
        self._t0 = time.perf_counter()
        self.duration_ms = 0.0

    def finish(self) -> "Span":
        self.duration_ms = (time.perf_counter() - self._t0) * 1e3
        return self

    def annotate(self, **kv: Any) -> None:
        self.attrs.update(kv)

    def child(self, name: str) -> Optional["Span"]:
        """First child with this name (depth 1), or None."""
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find(self, name: str) -> List["Span"]:
        """All descendants (including self) with this name, pre-order."""
        out = [self] if self.name == name else []
        for c in self.children:
            out.extend(c.find(name))
        return out

    def children_ms(self) -> float:
        return sum(c.duration_ms for c in self.children)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "ms": round(self.duration_ms, 3),
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Span":
        """Rebuild a tree serialized by to_dict() — the cluster broker
        stitches each server's remote-rooted tree (shipped in the
        response envelope) back under the scatter call span that
        dispatched it. Durations are trusted as measured by the remote
        process; only the gap to the enclosing call span (network +
        serde) is attributed broker-side."""
        s = cls(d.get("name", "?"), **dict(d.get("attrs") or {}))
        s.duration_ms = float(d.get("ms", 0.0))
        s.children = [cls.from_dict(c) for c in d.get("children") or []]
        return s


_INACTIVE = nullcontext()       # stateless: one instance serves every call


class SpanTracer:
    """Thread-local span stack. start()/stop() bracket one traced query;
    span()/annotate() are permanent no-ops outside that bracket."""

    def __init__(self):
        self._local = threading.local()

    # -- lifecycle ---------------------------------------------------------
    def start(self, name: str, **attrs: Any) -> Span:
        root = Span(name, **attrs)
        self._local.stack = [root]
        return root

    def stop(self) -> Optional[Span]:
        stack = getattr(self._local, "stack", None)
        self._local.stack = None
        if not stack:
            return None
        root = stack[0]
        # close anything left open (an exception mid-query must still
        # yield a renderable tree)
        for s in reversed(stack):
            if s.duration_ms == 0.0:
                s.finish()
        return root

    def active(self) -> bool:
        return bool(getattr(self._local, "stack", None))

    def current(self) -> Optional[Span]:
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    # -- recording ---------------------------------------------------------
    def span(self, name: str, **attrs: Any):
        """A context manager timing ``name`` as a child of the current
        span; inactive, one shared null context (yields None): no
        generator and no Span are made."""
        stack = getattr(self._local, "stack", None)
        if not stack:
            return _INACTIVE
        return self._record(stack, name, attrs)

    @contextmanager
    def _record(self, stack: List[Span], name: str, attrs: Dict[str, Any]):
        s = Span(name, **attrs)
        stack[-1].children.append(s)
        stack.append(s)
        try:
            yield s
        finally:
            s.finish()
            if stack and stack[-1] is s:
                stack.pop()

    def annotate(self, **kv: Any) -> None:
        cur = self.current()
        if cur is not None:
            cur.annotate(**kv)

    def add_event(self, name: str, duration_ms: float,
                  **attrs: Any) -> None:
        """Attach a pre-measured child span (a re-measured kernel phase
        from ops/phase_profile.py) under the current span."""
        cur = self.current()
        if cur is not None:
            s = Span(name, **attrs)
            s.duration_ms = float(duration_ms)
            cur.children.append(s)


span_tracer = SpanTracer()


def sample_decision(query_id: str, ratio: float) -> bool:
    """traceRatio production-sampling decision, deterministic in the
    query id: md5(queryId) maps to a uniform fraction in [0, 1) and the
    query is sampled when that fraction is below ``ratio``. Pure in the
    qid so broker replicas and retried dispatches of the SAME query
    agree on the decision without coordination (the round-10
    traceContext then carries the flag to every server the scatter
    touches). ratio<=0 never samples, ratio>=1 always samples."""
    if ratio <= 0.0:
        return False
    if ratio >= 1.0:
        return True
    import hashlib

    h = int(hashlib.md5(str(query_id).encode()).hexdigest()[:8], 16)
    return (h / float(1 << 32)) < ratio


# module-level conveniences (the form hot paths import)
def span(name: str, **attrs: Any):
    return span_tracer.span(name, **attrs)


def annotate(**kv: Any) -> None:
    span_tracer.annotate(**kv)


def add_event(name: str, duration_ms: float, **attrs: Any) -> None:
    span_tracer.add_event(name, duration_ms, **attrs)


def tracing_active() -> bool:
    return span_tracer.active()


def device_fence(out: Any) -> None:
    """Wait for the card to finish ``out`` (a tensor, or a dict, list or
    tuple of them) so a span's wall time covers the device work it
    launched — only when a trace is being taken: the untraced path keeps
    its launches asynchronous. The fence synchronizes the current stream
    of the device the first CUDA tensor lives on; CPU tensors are done
    when they return."""
    if span_tracer.active():
        dev = _cuda_device(out)
        if dev is not None:
            import torch

            torch.cuda.current_stream(dev).synchronize()


def _cuda_device(out: Any):
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for o in out:
            dev = _cuda_device(o)
            if dev is not None:
                return dev
        return None
    dev = getattr(out, "device", None)
    return dev if getattr(dev, "type", None) == "cuda" else None
