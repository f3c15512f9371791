"""Ingest-vs-oracle chaos fuzzing harness (the realtime counterpart of
tools/fuzzer.py's query fuzzer).

Drives seeded random row sequences + a seeded ingest fault plan
(utils/faults.py: stream.error / stream.rebalance / commit.crash /
commit.http_error / handoff.stall / upsert.compact_crash) through the
full realtime plane — consume -> index -> seal -> (split-)commit ->
resume — answering every injected process death (IngestCrash) with a
restart from the durable checkpoint, exactly like a supervisor would.
The final queryable state (committed segments + consuming tail, through
the real Broker query path) is then diffed byte-exact against a
fault-free python/numpy oracle: exactly-once across crash/restart for
append tables, latest-wins preserved for upsert tables.

Protocol mode swaps the standalone local seal for the controller
completion FSM via cluster/completion.LocalCompletionClient (same RPC
boundaries, same deep-store pack/upload/download path, no HTTP servers)
so commit.http_error and handoff.stall fire on the real code paths.

Port of ``pinot_tpu/tools/ingest_fuzz.py``: the same rows, plan and
oracle for a seed, so a run fires the reference's faults and ends in its
rows. Sealed segments load on ``device`` (default ``"cuda"``, raising
without it) and ``queryable_rows`` answers through ``Broker(device)``.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..realtime import InMemoryStream, RealtimeTableDataManager, \
    StreamConfig
from ..spi import DataType, FieldSpec, FieldType, Schema
from ..upsert import UpsertConfig
from ..utils import faults

TABLE = "rt_events"
N_PKS = 13          # small PK space: plenty of upsert collisions
MAX_RESTARTS = 200  # crash/restart budget before declaring non-recovery


def fuzz_schema() -> Schema:
    return Schema(TABLE, [
        FieldSpec("pk", DataType.INT),
        FieldSpec("ts", DataType.INT, FieldType.METRIC),
        FieldSpec("val", DataType.INT, FieldType.METRIC),
    ])


def gen_rows(seed: int, n: int) -> List[Dict[str, int]]:
    """Seeded row sequence: colliding PKs and an out-of-order, tie-heavy
    comparison column (ts) so upsert latest-wins is genuinely exercised
    — a later arrival with an equal ts must win (newer-or-equal rule)."""
    rng = np.random.default_rng(seed)
    pks = rng.integers(0, N_PKS, n)
    ts = rng.integers(0, max(2, n // 3), n)
    vals = rng.integers(0, 1000, n)
    return [{"pk": int(pks[i]), "ts": int(ts[i]), "val": int(vals[i])}
            for i in range(n)]


def ingest_plan(seed: int, protocol: bool = False) -> str:
    """A seeded plan arming every ingest fault point. `times` budgets
    (per site key — utils/faults.py purity contract) bound the number of
    injected crashes so every run terminates."""
    specs = [
        "stream.error: p=0.08",
        "stream.rebalance: p=0.04",
        "commit.crash: p=0.3, times=1",
        "upsert.compact_crash: p=0.1, times=2",
    ]
    if protocol:
        specs += ["commit.http_error: p=0.2, times=2",
                  "handoff.stall: p=0.5, times=1, delay_ms=2"]
    return f"seed={seed}; " + "; ".join(specs)


def oracle_rows(rows: List[Mapping[str, int]], upsert: bool
                ) -> List[Tuple[int, int, int]]:
    """The fault-free oracle: append keeps everything exactly once;
    upsert keeps, per PK, the newest-or-equal comparison value with
    later stream arrival breaking ties (upsert/metadata.py rule)."""
    if not upsert:
        return [(r["pk"], r["ts"], r["val"]) for r in rows]
    live: Dict[int, Tuple[int, int, int]] = {}
    for r in rows:
        cur = live.get(r["pk"])
        if cur is None or r["ts"] >= cur[1]:
            live[r["pk"]] = (r["pk"], r["ts"], r["val"])
    return list(live.values())


def digest(rows) -> List[Tuple[int, ...]]:
    """Comparable row multiset (all-int schema: exact, no float fuzz)."""
    return sorted(tuple(int(v) for v in r) for r in rows)


def queryable_rows(manager: RealtimeTableDataManager,
                   device: Union[str, torch.device, None] = None
                   ) -> List[Tuple[int, int, int]]:
    """The final queryable state through the REAL query path (committed
    immutables + consuming snapshots, upsert validDocIds applied), by a
    Broker on ``device`` (default: the manager's)."""
    from ..broker import Broker
    b = Broker(device=manager.device if device is None else device)
    b.register_table(manager)
    res = b.query(f"SELECT pk, ts, val FROM {TABLE} LIMIT 1000000")
    return [tuple(int(v) for v in r) for r in res.rows]


class IngestRun:
    """One chaos-hardened ingest run: a manager over a pre-filled
    in-memory stream, restarted from its checkpoint on every injected
    crash. The stream, data_dir, and (in protocol mode) the completion
    FSM + registry survive 'process death' — only the manager dies."""

    def __init__(self, data_dir: str, rows: List[Mapping[str, int]],
                 upsert: bool = False, protocol: bool = False,
                 threshold: int = 32, server_id: str = "fuzz_server",
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        self.data_dir = data_dir
        self.rows = rows
        self.upsert = upsert
        self.protocol = protocol
        self.threshold = threshold
        self.server_id = server_id
        self.restarts = 0
        self.stream = InMemoryStream(1)
        self.stream.produce_many(rows)
        self.completion = None
        self.registry: Dict[Tuple[str, str], Dict[str, Any]] = {}
        if protocol:
            from ..cluster.completion import SegmentCompletionManager
            self.completion = SegmentCompletionManager(
                lambda t: 1, decision_window_s=0.0,
                registered_segment=lambda t, s: self.registry.get((t, s)))
        self.manager = self._start_manager()

    def _start_manager(self) -> RealtimeTableDataManager:
        while True:
            try:
                return self._make_manager()
            except faults.IngestCrash:
                self._crashed()  # crash inside the restart replay itself

    def _make_manager(self) -> RealtimeTableDataManager:
        cfg = StreamConfig(
            TABLE, num_partitions=1,
            flush_threshold_rows=self.threshold,
            consumer_factory=self.stream,
            fetch_backoff_s=0.001)
        cc = None
        if self.protocol:
            from ..cluster.completion import LocalCompletionClient
            cc = LocalCompletionClient(
                self.completion, self.server_id,
                f"file://{self.data_dir}/deepstore", self.registry)
        ucfg = UpsertConfig(["pk"], comparison_column="ts") \
            if self.upsert else None
        m = RealtimeTableDataManager(
            TABLE, fuzz_schema(), cfg,
            os.path.join(self.data_dir, "server"),
            upsert_config=ucfg, completion_client=cc, device=self.device)
        m.report_interval_s = 0.0
        return m

    def _crashed(self) -> None:
        self.restarts += 1
        if self.restarts > MAX_RESTARTS:
            raise RuntimeError(
                f"ingest did not recover within {MAX_RESTARTS} restarts")

    def drive(self) -> RealtimeTableDataManager:
        """Consume until the stream is drained (and, in protocol mode,
        pending commits settled), restarting on every injected crash.
        Returns the surviving manager."""
        transient = 0
        while True:
            m = self.manager
            try:
                m.consume_once(0)
                if self.protocol:
                    m._maybe_seal(0)  # HOLD/CATCHUP/COMMIT re-entry
                drained = m._stream_offset(
                    0, m._mutables[0].n_docs) >= len(self.rows)
                if drained and (not self.protocol
                                or not self._commit_pending(m)):
                    return m
            except faults.IngestCrash:
                self._crashed()
                self.manager = self._start_manager()
            except Exception:
                # a read failure past the bounded retries: the supervisor
                # loop (like _consume_loop) just polls again
                transient += 1
                if transient > MAX_RESTARTS:
                    raise

    def _commit_pending(self, m: RealtimeTableDataManager) -> bool:
        """Protocol mode: a consuming tail at/over the threshold still
        owes the controller a commit (or an adoption) — keep polling."""
        return m._mutables[0].n_docs >= self.threshold


def run_one(data_dir: str, seed: int, n_rows: int, upsert: bool,
            protocol: bool = False,
            device: Union[str, torch.device, None] = None
            ) -> Tuple[RealtimeTableDataManager, "faults.FaultPlan", int]:
    """Install the seeded plan, drive one full chaos run on ``device``,
    clear the plan. Returns (manager, fired plan, restarts)."""
    dev = resolve_device(device)
    plan = faults.install(ingest_plan(seed, protocol))
    try:
        run = IngestRun(data_dir, gen_rows(seed, n_rows), upsert=upsert,
                        protocol=protocol, device=dev)
        m = run.drive()
    finally:
        faults.clear()
    return m, plan, run.restarts
