"""Resource leak guard: weakref ledger over long-lived native resources.

Reference parity: the reference leans on explicit acquire/release
refcounting (SegmentDataManager.acquireSegment/releaseSegment) plus test
harness leak detectors that fail a run when a resource outlives its
owner. The TPU-native engine replaces refcounting with immutable
snapshot semantics (server/data_manager.py swaps dicts; the GC frees
segments when the last query drops them), so the leak guard watches the
GC instead: every tracked resource registers a weakref here, and
``assert_no_leaks`` (the test-harness hook) fails when resources that
should be dead are still reachable after a full collection.

Tracked today: loaded ImmutableSegments (host mmaps + device caches),
segdir packed-file mmaps, multistage mailboxes.

Port of ``pinot_tpu/utils/leak.py``, unchanged, registered where the
reference registers: ``segment/immutable.ImmutableSegment`` ("segment"),
``segment/segdir._load_map`` ("segdir_mmap") and
``multistage/exchange.ReceivingMailbox`` ("mailbox").
"""
from __future__ import annotations

import gc
import threading
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List

_LOCK = threading.Lock()
_LIVE: Dict[int, tuple] = {}   # id -> (kind, name, weakref)
_next = [0]


def track(obj: Any, kind: str, name: str = "") -> None:
    """Register a resource; the entry disappears when the object dies."""
    with _LOCK:
        key = _next[0]
        _next[0] += 1

    def _drop(_ref, _key=key):
        with _LOCK:
            _LIVE.pop(_key, None)

    try:
        ref = weakref.ref(obj, _drop)
    except TypeError:       # not weakref-able: do not guess, do not track
        return
    with _LOCK:
        _LIVE[key] = (kind, name, ref)


def live(kind: str = None) -> List[tuple]:
    """(kind, name) for every still-alive tracked resource."""
    return [(k, n) for _key, (k, n) in _live_entries(kind)]


def _live_entries(kind: str = None) -> List[tuple]:
    gc.collect()
    with _LOCK:
        entries = list(_LIVE.items())
    return [(key, (k, n)) for key, (k, n, r) in entries
            if r() is not None and (kind is None or k == kind)]


@contextmanager
def leak_check(kind: str = None):
    """Fail if resources tracked during the block survive it.

    Test-harness use (the reference's leak-detector listener analog):

        with leak_check("segment"):
            seg = ImmutableSegment.load(d)
            ... query ...
            del seg
    """
    # diff ledger KEYS (unique per track call): an identically-named
    # pre-existing resource must not mask a leaked newcomer
    before = {key for key, _ in _live_entries(kind)}
    yield
    leaked = [e for key, e in _live_entries(kind) if key not in before]
    if leaked:
        raise AssertionError(f"leaked resources: {leaked}")
