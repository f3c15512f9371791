"""Generic alerting plane: named rules, one latch/window implementation.

Port of ``pinot_tpu/utils/alerts.py``: the latch and window machinery
the SLO plane (utils/slo.py) uses for burn-rate alerting, one
implementation for every rule:

- ``RateWindowRule`` — the compile-storm shape: a deque of
  ``(timestamp, tag)`` events inside a sliding window; when the
  in-window count crosses the watermark the rule fires ONCE (latched)
  and re-arms only when the rate drains back below the watermark.
  ``CompileLog._note_storm`` delegates here verbatim — same alert
  ledger kind, same one-alert-per-crossing semantics.
- ``LevelRule`` — the burn-rate shape: a continuous level checked
  against a threshold with **hysteresis**: fire once when the level
  reaches the threshold, re-arm (reporting a ``"clear"`` transition)
  only when it falls below ``threshold * hysteresis`` — a level
  hovering at the watermark cannot flap.
- ``AlertManager`` — the rule registry + the bounded alert ring +
  the validated ``alert`` ledger-record fire path (append errors are
  counted, never raised: observability must never fail the data path).

Determinism: rules never read the wall clock — every ``note``/``check``
takes the caller's timestamp/level, so the same event stream yields the
same alert stream (the replayability discipline; the SLO
plane's windows are driven entirely by record timestamps).
"""
from __future__ import annotations

import os
import threading
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .metrics import global_metrics

ALERT_RING_CAPACITY = 64

# process identity for fleet dedup (the compileplane/forensics idiom):
# alert records carry the FIRING plane's token when one is passed;
# this is the default for planes without their own
PROC_TOKEN = f"{os.getpid()}-{uuid.uuid4().hex[:6]}"


class RateWindowRule:
    """Events-per-window watermark with a fire-once latch (the
    compile-storm semantics, extracted): one alert per crossing,
    re-armed when the in-window rate drains below the watermark."""

    def __init__(self, name: str, watermark: float, window_s: float,
                 severity: str = "warn"):
        self.name = name
        self.watermark = watermark  # guarded-by: none — config-time
        self.window_s = window_s    # guarded-by: none — config-time
        self.severity = severity    # guarded-by: none — config-time
        self._lock = threading.Lock()
        self._events: deque = deque()
        self._latched = False

    def note(self, now: float, tag: Optional[str] = None,
             count: bool = True,
             watermark: Optional[float] = None) -> tuple:
        """Observe the stream at ``now``: append an event when
        ``count`` (non-counting calls still prune + evaluate, so the
        rate decays and the latch re-arms on quiet streams — the
        CompileLog contract for non-storm triggers).

        -> ``(fire, rate)``: ``fire`` is ``None`` or the crossing
        context ``{"rate", "watermark", "tags"}``."""
        wm = self.watermark if watermark is None else watermark
        fire = None
        with self._lock:
            if count:
                self._events.append((now, tag))
            while self._events and now - self._events[0][0] \
                    > self.window_s:
                self._events.popleft()
            rate = len(self._events)
            if rate >= wm and not self._latched:
                self._latched = True
                tags: Dict[str, int] = {}
                for _t, tg in self._events:
                    tags[tg] = tags.get(tg, 0) + 1
                fire = {"rate": rate, "watermark": wm, "tags": tags}
            elif rate < wm:
                self._latched = False
        return fire, rate

    @property
    def latched(self) -> bool:
        with self._lock:
            return self._latched

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._latched = False


class LevelRule:
    """Threshold-with-hysteresis over a continuous level (burn rates):
    fire once at ``level >= threshold``; clear (re-arm) only below
    ``threshold * hysteresis`` so a level hovering at the watermark
    cannot flap the alert."""

    def __init__(self, name: str, threshold: float,
                 severity: str = "warn", hysteresis: float = 1.0):
        self.name = name
        self.threshold = threshold    # guarded-by: none — config-time
        self.severity = severity      # guarded-by: none — config-time
        self.hysteresis = min(max(hysteresis, 0.0), 1.0)
        self._lock = threading.Lock()
        self._latched = False

    def check(self, level: float) -> Optional[str]:
        """-> ``"fire"`` on the arming crossing, ``"clear"`` on the
        re-arm transition, ``None`` otherwise (deterministic in the
        level stream)."""
        with self._lock:
            if level >= self.threshold and not self._latched:
                self._latched = True
                return "fire"
            if self._latched and level < self.threshold * self.hysteresis:
                self._latched = False
                return "clear"
            return None

    @property
    def latched(self) -> bool:
        with self._lock:
            return self._latched

    def reset(self) -> None:
        with self._lock:
            self._latched = False


class AlertManager:
    """Named rules + the bounded alert ring + the validated ``alert``
    ledger fire path (module docstring)."""

    def __init__(self, proc_token: Optional[str] = None):
        self._lock = threading.Lock()
        self._rules: Dict[str, Any] = {}
        self._ring: deque = deque(maxlen=ALERT_RING_CAPACITY)
        self.proc = proc_token or PROC_TOKEN
        self.alerts_fired = 0

    # -- rule registry -----------------------------------------------------
    def rate_rule(self, name: str, watermark: float, window_s: float,
                  severity: str = "warn") -> RateWindowRule:
        with self._lock:
            rule = self._rules.get(name)
            if rule is None:
                rule = RateWindowRule(name, watermark, window_s,
                                      severity)
                self._rules[name] = rule
            return rule

    def level_rule(self, name: str, threshold: float,
                   severity: str = "warn",
                   hysteresis: float = 1.0) -> LevelRule:
        with self._lock:
            rule = self._rules.get(name)
            if rule is None:
                rule = LevelRule(name, threshold, severity, hysteresis)
                self._rules[name] = rule
            return rule

    def rule(self, name: str) -> Optional[Any]:
        with self._lock:
            return self._rules.get(name)

    # -- firing ------------------------------------------------------------
    def fire(self, alert: str, severity: str, rate_per_min: float,
             watermark: float, window_s: float,
             detail: Optional[str] = None,
             triggers: Optional[Dict[str, int]] = None,
             extra: Optional[Dict[str, Any]] = None,
             path: Optional[str] = None,
             proc: Optional[str] = None,
             seq: Optional[int] = None,
             ts: Optional[str] = None,
             counter: Optional[str] = "alerts_fired",
             backend: Optional[str] = None,
             on_fire: Optional[Callable[[Dict[str, Any]], None]] = None
             ) -> Dict[str, Any]:
        """Build ONE validated ``alert`` ledger record, append it to
        ``path`` when given (append failures counted, never raised),
        admit it to the ring and bump ``counter``. ``ts``/``proc`` are
        injectable so a pure replay plan can produce a byte-stable
        stream; ``on_fire`` is the incident flight-recorder hook —
        called after the record is ringed, exceptions swallowed (an
        alert must fire even when its recorder is broken)."""
        from . import ledger as uledger

        fields: Dict[str, Any] = {
            "alert": alert, "severity": severity,
            "rate_per_min": rate_per_min, "watermark": watermark,
            "window_s": window_s, "proc": proc or self.proc,
        }
        if detail is not None:
            fields["detail"] = detail
        if triggers is not None:
            fields["triggers"] = triggers
        if extra is not None:
            fields["extra"] = extra
        if seq is not None:
            fields["seq"] = seq
        if ts is not None:
            fields["ts"] = ts
        if backend is not None:
            fields["backend"] = backend
        rec = uledger.make_record("alert", **fields)
        if path:
            try:
                uledger.append_record(rec, path)
            except OSError:
                # observability must never fail the data path
                global_metrics.count("alert_write_errors")
        with self._lock:
            self._ring.append(rec)
            self.alerts_fired += 1
        if counter:
            # counter=None is the silent-evaluator mode (replay plans
            # must not bump live telemetry)
            global_metrics.count(counter)
        if on_fire is not None:
            try:
                on_fire(rec)
            except Exception:
                global_metrics.count("incident_capture_errors")
        return rec

    # -- serving -----------------------------------------------------------
    def alerts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def reset(self) -> None:
        """Clear the ring and every rule's latch/window (tests, chaos
        gate phase boundaries); registered rules survive."""
        with self._lock:
            self._ring.clear()
            self.alerts_fired = 0
            rules = list(self._rules.values())
        for r in rules:
            r.reset()


global_alerts = AlertManager()
