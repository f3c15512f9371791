"""Segment completion protocol: controller-arbitrated realtime commit.

Reference parity: pinot-common/.../protocols/SegmentCompletionProtocol.java
:77-122 (message types HOLD / CATCHUP / COMMIT / COMMIT_CONTINUE /
COMMIT_SUCCESS / FAILED, split-commit) + pinot-controller/.../realtime/
SegmentCompletionManager.java (the FSM electing exactly one committer per
consuming segment among its replicas).

Flow per (table, segment):
    replicas hit their row/time threshold -> POST segmentConsumed(offset)
    controller HOLDs until every expected replica reported or the
    decision window elapses, then elects the largest offset:
        winner   -> COMMIT  (commit at target offset)
        laggards -> CATCHUP (consume to target, report again, then HOLD)
    winner: segmentCommitStart -> build + upload to deep store ->
            segmentCommitEnd(downloadURI) -> controller registers the
            segment (atomic version bump) -> COMMIT_SUCCESS
    other replicas' next segmentConsumed -> COMMITTED + downloadURI
    (they discard their consuming state and download — peer/deep-store
    download path).

Port of ``pinot_tpu/cluster/completion.py``: the same FSM, responses and
wire bodies, so a port replica commits through either package's
controller and the other way round. The FSM reads its clock through
``clock`` (``time.monotonic`` unless the caller injects one), so a test
drives the decision window, the commit timeout and the TTL purge without
sleeping.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

HOLD = "HOLD"
CATCHUP = "CATCHUP"
COMMIT = "COMMIT"
COMMIT_CONTINUE = "COMMIT_CONTINUE"
COMMIT_SUCCESS = "COMMIT_SUCCESS"
COMMITTED = "COMMITTED"
FAILED = "FAILED"


class SegmentCompletionManager:
    def __init__(self, expected_replicas: Callable[[str], int],
                 decision_window_s: float = 0.5,
                 commit_timeout_s: float = 30.0,
                 committed_ttl_s: float = 300.0,
                 registered_segment: Optional[
                     Callable[[str, str], Optional[Dict[str, Any]]]] = None,
                 clock: Callable[[], float] = time.monotonic):
        """expected_replicas: table -> how many replicas consume each
        segment (the controller's replication for the table).
        committed_ttl_s bounds FSM memory: COMMITTED entries are purged
        after laggards have had that long to fetch the downloadURI (they
        fall back to the controller's segment registry afterwards).
        clock: the monotonic seconds every window and timeout reads."""
        self._expected = expected_replicas
        self.clock = clock
        self.decision_window_s = decision_window_s
        self.commit_timeout_s = commit_timeout_s
        self.committed_ttl_s = committed_ttl_s
        # fallback registry lookup: (table, segment) -> {"downloadURI",
        # "offset"} | None. The FSM is memory-only; after a controller
        # restart or a TTL purge a laggard's report must NOT re-elect a
        # committer for a segment the cluster already registered — that
        # would overwrite the canonical artifact with a divergent one.
        self._registered = registered_segment
        self._lock = threading.Lock()
        self._fsm: Dict[Tuple[str, str], Dict[str, Any]] = {}

    def _purge_locked(self) -> None:
        # _locked suffix contract: every caller already holds self._lock
        now = self.clock()
        dead = [k for k, e in self._fsm.items()
                if e["state"] == "COMMITTED" and e.get("commit_ts")
                and now - e["commit_ts"] > self.committed_ttl_s]
        for k in dead:
            del self._fsm[k]

    def drop_table(self, table: str) -> None:
        with self._lock:
            for k in [k for k in self._fsm if k[0] == table]:
                del self._fsm[k]

    def _entry(self, table: str, segment: str) -> Dict[str, Any]:
        # called only from the FSM transitions, which hold self._lock
        key = (table, segment)
        if key not in self._fsm:
            self._fsm[key] = {
                "state": "HOLDING", "offsets": {},
                "first_ts": self.clock(),
                "winner": None, "target": None,
                "download_uri": None, "commit_ts": None}
        return self._fsm[key]

    def segment_consumed(self, table: str, segment: str, server: str,
                         offset: int) -> Dict[str, Any]:
        with self._lock:
            self._purge_locked()
            if (table, segment) not in self._fsm and \
                    self._registered is not None:
                reg = self._registered(table, segment)
                if reg is not None:
                    return {"status": COMMITTED,
                            "downloadURI": reg.get("downloadURI"),
                            "offset": reg.get("offset")}
            e = self._entry(table, segment)
            if e["state"] == "COMMITTED":
                return {"status": COMMITTED,
                        "downloadURI": e["download_uri"],
                        "offset": e["target"]}
            if e["state"] == "COMMITTING":
                if server == e["winner"]:
                    # winner re-reporting (e.g. after restart): carry on
                    return {"status": COMMIT, "offset": e["target"]}
                # a committer died? allow takeover after timeout
                if self.clock() - (e["commit_ts"] or 0) \
                        > self.commit_timeout_s:
                    e["offsets"][server] = offset
                    return self._elect(table, e, server, takeover=True)
                return {"status": HOLD}
            e["offsets"][server] = max(offset,
                                       e["offsets"].get(server, offset))
            expected = max(self._expected(table), 1)
            window_over = (self.clock() - e["first_ts"]
                           >= self.decision_window_s)
            if len(e["offsets"]) >= expected or window_over:
                return self._elect(table, e, server)
            return {"status": HOLD}

    def _elect(self, table: str, e: Dict[str, Any], server: str,
               takeover: bool = False) -> Dict[str, Any]:
        """Pick the committer: the largest reported offset (ties: first
        reporter). Laggards catch up to the target; the winner commits."""
        if e["target"] is None or takeover:
            cands = dict(e["offsets"])
            if takeover and len(cands) > 1:
                cands.pop(e["winner"], None)  # the stalled committer
            winner = max(cands, key=lambda s: (cands[s],))
            e["winner"] = winner
            e["target"] = max(e["target"] or 0, cands[winner])
            if takeover:
                e["state"] = "HOLDING"
        if server == e["winner"] and \
                e["offsets"].get(server, -1) >= e["target"]:
            # the winner may have consumed past the elected target while
            # holding; commit everything it has so the artifact's end
            # offset and the adopters' resume offset agree (no duplicate
            # re-consumption on the laggards)
            e["target"] = e["offsets"][server]
            e["state"] = "COMMITTING"
            e["commit_ts"] = self.clock()
            return {"status": COMMIT, "offset": e["target"]}
        if e["offsets"].get(server, -1) < e["target"]:
            return {"status": CATCHUP, "offset": e["target"]}
        return {"status": HOLD}

    def segment_commit_start(self, table: str, segment: str, server: str
                             ) -> Dict[str, Any]:
        with self._lock:
            e = self._fsm.get((table, segment))
            if e is None or e["state"] != "COMMITTING" or \
                    e["winner"] != server:
                return {"status": FAILED}
            e["commit_ts"] = self.clock()
            return {"status": COMMIT_CONTINUE}

    def segment_commit_end(self, table: str, segment: str, server: str,
                           download_uri: str,
                           register: Callable[[], None]) -> Dict[str, Any]:
        """register() runs under the FSM lock — the segment-metadata write
        and the COMMITTED flip are atomic with respect to replica polls."""
        with self._lock:
            e = self._fsm.get((table, segment))
            if e is None or e["state"] != "COMMITTING" or \
                    e["winner"] != server:
                return {"status": FAILED}
            register()
            e["state"] = "COMMITTED"
            e["download_uri"] = download_uri
            e["commit_ts"] = self.clock()  # TTL purge baseline
            return {"status": COMMIT_SUCCESS}

    def status(self, table: str, segment: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            e = self._fsm.get((table, segment))
            return dict(e) if e else None


def _commit_fault(server_id: str, op: str, segment: str) -> None:
    """Named ingest fault hook (``commit.http_error``): the commit RPC
    fails mid-protocol before reaching the controller. One hook per
    protocol boundary so a seeded plan can kill exactly the
    segmentConsumed / commitStart / commitEnd leg it targets (the
    generic rpc.* trio in http_util still applies underneath). Shared
    by BOTH clients — HTTP and protocol-local chaos plans must see
    identical boundaries and site keys."""
    from ..utils import faults
    if faults.active():
        faults.fault_point("commit.http_error",
                           f"{server_id}/{op}/{segment}")


class CompletionClient:
    """Server-side protocol client: reports thresholds and runs the
    split-commit against the controller REST API (the server half of
    SegmentCompletionProtocol — ServerSegmentCompletionProtocolHandler
    analog)."""

    def __init__(self, controller_url: str, server_id: str,
                 deepstore_uri: str):
        self.controller_url = controller_url
        self.server_id = server_id
        self.deepstore_uri = deepstore_uri

    def _commit_fault(self, op: str, segment: str) -> None:
        _commit_fault(self.server_id, op, segment)

    def segment_consumed(self, table: str, segment: str, offset: int
                         ) -> Dict[str, Any]:
        from .http_util import http_json
        self._commit_fault("segmentConsumed", segment)
        return http_json("POST", f"{self.controller_url}/segmentConsumed",
                         {"table": table, "segment": segment,
                          "server": self.server_id, "offset": offset})

    def split_commit(self, table: str, segment: str, seg_dir: str,
                     metadata: Optional[Dict[str, Any]] = None) -> bool:
        """commitStart -> upload to deep store -> commitEnd. Returns True
        on COMMIT_SUCCESS."""
        from .deepstore import upload_segment
        from .http_util import http_json
        self._commit_fault("segmentCommitStart", segment)
        start = http_json("POST",
                          f"{self.controller_url}/segmentCommitStart",
                          {"table": table, "segment": segment,
                           "server": self.server_id})
        if start.get("status") != COMMIT_CONTINUE:
            return False
        uri = upload_segment(seg_dir,
                             self.deepstore_uri.rstrip("/") + "/" + table)
        self._commit_fault("segmentCommitEnd", segment)
        end = http_json("POST", f"{self.controller_url}/segmentCommitEnd",
                        {"table": table, "segment": segment,
                         "server": self.server_id, "downloadURI": uri,
                         "metadata": metadata})
        return end.get("status") == COMMIT_SUCCESS


class LocalCompletionClient:
    """In-process CompletionClient: the same two-call surface the
    realtime manager speaks (segment_consumed / split_commit), driving a
    SegmentCompletionManager directly instead of the controller REST
    API. Commits upload through the real deep-store pack/upload path and
    register into a shared ``registry`` dict (the controller's
    segment-metadata analog) that doubles as the FSM's
    ``registered_segment`` fallback — so peer replicas and restarted
    processes resolve COMMITTED downloads exactly like the HTTP flow.

    Exists for the ingest-vs-oracle fuzzer and standalone protocol
    soaks: every protocol boundary still passes the
    ``commit.http_error`` fault hook, and downloads still pass
    ``handoff.stall`` (deepstore), so chaos plans behave identically to
    the clustered path without HTTP servers in the loop."""

    def __init__(self, completion: SegmentCompletionManager,
                 server_id: str, deepstore_uri: str,
                 registry: Optional[Dict[Tuple[str, str],
                                         Dict[str, Any]]] = None):
        self.completion = completion
        self.server_id = server_id
        self.deepstore_uri = deepstore_uri
        self.registry = registry if registry is not None else {}

    def _commit_fault(self, op: str, segment: str) -> None:
        _commit_fault(self.server_id, op, segment)

    def segment_consumed(self, table: str, segment: str, offset: int
                         ) -> Dict[str, Any]:
        self._commit_fault("segmentConsumed", segment)
        return self.completion.segment_consumed(table, segment,
                                                self.server_id, offset)

    def split_commit(self, table: str, segment: str, seg_dir: str,
                     metadata: Optional[Dict[str, Any]] = None) -> bool:
        from .deepstore import upload_segment
        self._commit_fault("segmentCommitStart", segment)
        start = self.completion.segment_commit_start(table, segment,
                                                     self.server_id)
        if start.get("status") != COMMIT_CONTINUE:
            return False
        uri = upload_segment(seg_dir,
                             self.deepstore_uri.rstrip("/") + "/" + table)
        self._commit_fault("segmentCommitEnd", segment)

        def register() -> None:
            # runs under the FSM lock, like the controller's add_segment
            self.registry[(table, segment)] = {
                "downloadURI": uri,
                "offset": (metadata or {}).get("endOffset")}

        end = self.completion.segment_commit_end(table, segment,
                                                 self.server_id, uri,
                                                 register=register)
        return end.get("status") == COMMIT_SUCCESS
