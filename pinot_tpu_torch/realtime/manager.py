"""Realtime table data manager: consume -> index -> seal -> commit -> resume.

Port of ``pinot_tpu/realtime/manager.py`` on the port's
``TableDataManager`` and its ``device`` (CUDA unless the caller passes
``device="cpu"``). The consuming segments stay on the host and their
snapshots are answered by the host path; a sealed segment is loaded with
``ImmutableSegment.load(dir, self.device)`` and answered by the kernels.
A fetched batch is indexed column by column
(``MutableSegment.index_batch``) on every table but a partial-upsert
one, whose rows merge with the live row of their key before they are
indexed; the upsert and dedup metadata run row by row, in stream order.
Rows that dedup or the ingestion filter drop are written invalid before
the batch is published; a full-upsert batch is published one row at a
time, each row's metadata before the next row shows, so a reader never
sees more than one superseded row beside its successor.
The seal's swap is atomic for readers: ``acquire_segments`` never sees a
sealed segment beside the consuming snapshot it came from, nor
misses both.
``write_ingest_stats`` appends a validated ``ingest_stats`` record of
``utils/ledger`` at the caller's path. With a ``completion_client``
(``cluster/completion``'s ``CompletionClient`` or
``LocalCompletionClient``) a threshold is reported to the controller and
the segment completion protocol decides: the elected replica builds the
segment, split-commits it to the deep store and then swaps it in; the
others download the committed artifact, load it with
``ImmutableSegment.load(dir, self.device)`` and resume after its end
offset. The ``commit.http_error`` point sits at every protocol boundary
of the client and ``handoff.stall`` on the artifact's download
(``cluster/deepstore.download_segment``).

Reference parity: pinot-core/.../data/manager/realtime/
RealtimeSegmentDataManager.java:121 (the 1863-line consumption state
machine: consumeLoop at :420, threshold state transitions :733-813) plus
the durable-state half of the SegmentCompletionProtocol
(pinot-common/.../protocols/SegmentCompletionProtocol.java:77-122): each
partition's committed segments and next stream offset are checkpointed
atomically, so a restarted server resumes exactly where the last COMMIT
left off — rows land in committed segments exactly once (the consuming
tail is re-consumed from the checkpoint, the at-least-once half Pinot
also has before a commit).

Single-process scope for this layer: the controller-arbitrated multi-
replica commit election lives with the cluster roles; the state machine
and durable checkpoint format here are the same ones that protocol
drives.

Lifecycle per partition (CONSUMING segment):
    state.json holds {partition: {seq, next_offset, segments: [...]}}
    loop: fetch(next_offset) -> MutableSegment.index each row
          row/time threshold reached -> seal:
              MutableSegment.seal -> immutable dir (start/end offsets in
              metadata) -> load + atomic swap into the table -> write
              state.json (tmp+rename) -> fresh MutableSegment at the
              committed offset
    restart: load committed segment dirs from state, resume consuming at
             next_offset.

Chaos hardening (utils/faults.py ingest family): consumer reads run
under bounded retry-with-backoff (``stream.error``), an injected
rebalance (``stream.rebalance``) snaps the partition back to its
checkpoint exactly like a restart, ``commit.crash`` /
``upsert.compact_crash`` raise IngestCrash (abandon + restart — the
orphan-artifact cleanup at construction makes the restart
idempotent), and completion-protocol RPC failures (``commit.http_error``)
re-enter the HOLD/CATCHUP loop on the next poll. Every recovery event
lands in the per-table ingest stats (``ingest_stats``) and the
``ingest_*`` global_metrics counters.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..segment.immutable import ImmutableSegment
from ..segment.mutable import MutableSegment
from ..server.data_manager import TableDataManager
from ..spi.config import TableConfig
from ..spi.schema import Schema
from ..utils import faults
from ..utils.metrics import global_metrics
from .stream import MessageBatch, OffsetOutOfRange, StreamConfig

STATE_FILE = "state.json"
FETCH_BATCH = 10_000

# gauge name -> id(manager) of the last writer: several managers of the
# SAME table in one process (replicas) last-writer-wins the shared
# per-table freshness gauge, so stop() must only remove it when this
# manager was the latest writer — never a live replica's reading.
# Module-global state needs a MODULE lock (concur CC201/CC205): each
# replica's _stats_lock is a different object, so it excludes nothing
# across replicas, and stop()'s owner check-then-act raced a live
# replica's write — the stopping manager could still delete the gauge
# the live one had just refreshed.
_FRESHNESS_OWNERS: Dict[str, int] = {}
_FRESHNESS_LOCK = threading.Lock()


class RealtimeTableDataManager(TableDataManager):
    def __init__(self, table_name: str, schema: Schema,
                 stream_config: StreamConfig, data_dir: str,
                 table_config: Optional[TableConfig] = None,
                 poll_interval: float = 0.02,
                 upsert_config=None, dedup_config=None,
                 completion_client=None,
                 device: Union[str, torch.device, None] = None):
        super().__init__(table_name, device,
                         table_config or TableConfig(table_name))
        self.schema = schema
        self.stream_config = stream_config
        self.data_dir = data_dir
        self.poll_interval = poll_interval
        # controller-arbitrated commit (cluster.completion.CompletionClient);
        # None = standalone mode, seal locally without arbitration
        self.completion_client = completion_client
        self._last_report: Dict[int, float] = {}
        self.report_interval_s = 0.05
        os.makedirs(data_dir, exist_ok=True)
        # held across a seal's swap (sealed segment in, consuming segment
        # out) and across acquire_segments' read of both
        self._view_lock = threading.Lock()

        self._mutables: Dict[int, MutableSegment] = {}
        self._mutable_age: Dict[int, float] = {}
        # non-dense stream offsets (Kinesis sequence numbers have gaps):
        # per partition, the stream offset of EVERY row in the consuming
        # mutable (MessageBatch.row_offsets), so the offset after any
        # sealed row count resolves exactly — even when a concurrent
        # external seal captures a row count mid-batch. In-memory only:
        # a restart falls back to the committed checkpoint, which
        # re-consumes the tail exactly like the dense path. Dense streams
        # (kafka/wirestream/file) publish no row_offsets and keep the
        # checkpoint+rows arithmetic unchanged.
        self._row_offsets: Dict[int, List[int]] = {}
        self._state: Dict[str, Dict[str, Any]] = self._load_state()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._seal_lock = threading.Lock()

        # ingest stats (freshness ledger writer side + ingest_* counters)
        self._stats_lock = threading.Lock()
        self._stats: Dict[str, int] = {
            "rows": 0, "commits": 0, "commit_retries": 0,
            "commit_failures": 0, "rebalance_resets": 0,
            "stream_retries": 0, "upsert_replays": 0,
            "orphans_cleaned": 0, "handoff_retries": 0}
        self._ingest_t0: Optional[float] = None
        self._freshness_ms: Optional[float] = None
        # commit latency (seal -> durable checkpoint, split-commit RPC
        # included on the protocol path): EWMA for the ledger +
        # a bounded raw history for percentile-grade consumers
        # (engine/loadgen). Both guarded by _stats_lock.
        self._commit_ewma: Optional[float] = None
        self._commit_ms_hist: List[float] = []
        self._clean_orphans()

        # upsert/dedup metadata, per partition (PKs are partition-local,
        # same contract as the reference's partition managers)
        self._upsert: Dict[int, Any] = {}
        self._dedup: Dict[int, Any] = {}
        if upsert_config is not None and dedup_config is not None:
            raise ValueError("a table is upsert or dedup, not both")
        self.upsert_config = upsert_config
        self.dedup_config = dedup_config

        # pre-indexing row pipeline (CompositeTransformer before
        # MutableSegmentImpl.index, as in RealtimeSegmentDataManager).
        # Split at the filter stage so the filter sees the same rows it
        # would in batch ingestion (raw source columns, pre-coercion);
        # filtered rows are indexed then invalidated so stream-offset ==
        # doc-id accounting stays exact.
        from ..ingestion.transformers import (CompositeTransformer,
                                              FilterTransformer)
        self._pre_transformer = None
        self._row_filter: Optional[FilterTransformer] = None
        self._post_transformer = None
        if getattr(self.table_config, "ingestion", None):
            chain = CompositeTransformer.from_table_config(
                self.table_config, schema).transformers
            fidx = next((i for i, t in enumerate(chain)
                         if isinstance(t, FilterTransformer)), None)
            if fidx is None:
                self._pre_transformer = CompositeTransformer(chain)
            else:
                self._pre_transformer = CompositeTransformer(chain[:fidx])
                self._row_filter = chain[fidx]
                self._post_transformer = CompositeTransformer(
                    chain[fidx + 1:])

        factory = stream_config.make_consumer_factory()
        n_parts = factory.num_partitions()
        if upsert_config is not None:
            from ..upsert import PartitionUpsertMetadataManager
            for p in range(n_parts):
                self._upsert[p] = PartitionUpsertMetadataManager(
                    upsert_config, site_key=f"{table_name}/{p}")
        if dedup_config is not None:
            from ..upsert import PartitionDedupMetadataManager
            for p in range(n_parts):
                self._dedup[p] = PartitionDedupMetadataManager(dedup_config)

        # restart path: re-register committed segments from the checkpoint,
        # replaying PK metadata in commit order for upsert/dedup tables
        for pkey, pstate in self._state.items():
            p = int(pkey)
            for seg_name in pstate["segments"]:
                seg_dir = os.path.join(self.data_dir, seg_name)
                if not os.path.isdir(seg_dir):
                    continue
                seg = ImmutableSegment.load(seg_dir, self.device)
                self.add_segment(seg)
                self._replay_metadata(p, seg)

        for p in range(n_parts):
            self._partition_state(p)
            self._new_mutable(p)

    def _count_stat(self, name: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[name] += n
        global_metrics.count("ingest_" + name, n)

    def _note_commit_ms(self, ms: float) -> None:
        """One committed segment's seal->checkpoint latency."""
        with self._stats_lock:
            e = self._commit_ewma
            self._commit_ewma = ms if e is None else 0.8 * e + 0.2 * ms
            self._commit_ms_hist.append(ms)
            if len(self._commit_ms_hist) > 4096:
                del self._commit_ms_hist[:2048]

    def commit_latencies(self) -> List[float]:
        """Raw per-commit latencies (ms, bounded history) — the
        percentile inputs engine/loadgen aggregates into the
        ``ingest_bench`` ledger record."""
        with self._stats_lock:
            return list(self._commit_ms_hist)

    def _clean_orphans(self) -> None:
        """Idempotent-restart hygiene: a crash between the segment build
        and the checkpoint ``os.replace`` (the commit.crash window)
        leaves a built artifact directory the durable state never
        adopted. Remove it — its rows re-consume from the checkpoint,
        and the next seal reuses the same directory name — plus any torn
        ``state.json.tmp`` whose rename never happened."""
        import shutil
        committed = {s for pstate in self._state.values()
                     for s in pstate["segments"]}
        prefix = f"{self.table_name}__"
        for entry in sorted(os.listdir(self.data_dir)):
            path = os.path.join(self.data_dir, entry)
            if entry.startswith(prefix) and entry not in committed \
                    and os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
                self._count_stat("orphans_cleaned")
        tmp = self._state_path() + ".tmp"
        if os.path.exists(tmp):
            os.remove(tmp)

    def _replay_metadata(self, p: int, seg: ImmutableSegment) -> None:
        if p in self._upsert:
            self._count_stat("upsert_replays")
            cfg = self.upsert_config
            pks = self._segment_pks(seg, cfg.pk_columns)
            if cfg.comparison_column is not None:
                cmps = list(np.asarray(
                    seg.raw_values(cfg.comparison_column)))
            else:
                start = seg.metadata.get("startOffset", 0)
                cmps = list(range(start, start + seg.n_docs))
            # the old mask stays visible until replay_segment publishes the
            # rebuilt one — clearing first would transiently expose
            # superseded rows to concurrent queries
            self._upsert[p].replay_segment(seg, pks, cmps)
            seg.persist_valid_docs()
        elif p in self._dedup:
            pks = self._segment_pks(seg, self.dedup_config.pk_columns)
            self._dedup[p].replay_segment(seg, pks)

    @staticmethod
    def _segment_pks(seg: ImmutableSegment, pk_cols) -> List[tuple]:
        arrays = [np.asarray(seg.raw_values(c)) for c in pk_cols]
        return list(zip(*[a.tolist() for a in arrays]))

    # -- durable state (segment ZK metadata analog) ------------------------
    def _state_path(self) -> str:
        return os.path.join(self.data_dir, STATE_FILE)

    def _load_state(self) -> Dict[str, Dict[str, Any]]:
        path = self._state_path()
        if os.path.exists(path):
            with open(path) as fh:
                return json.load(fh)
        return {}

    def _write_state(self) -> None:
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._state, fh, indent=1)
        os.replace(tmp, self._state_path())  # atomic commit point

    def _partition_state(self, p: int) -> Dict[str, Any]:
        # single-writer per partition key: only p's consume thread (or
        # the seal/rebalance paths, which hold _seal_lock AND quiesce
        # the partition first) touches str(p)'s entry, and dict element
        # stores are GIL-atomic — no lock needed on the per-row path
        key = str(p)
        if key not in self._state:  # concur: ok CC205
            st = {"seq": 0, "next_offset": 0, "segments": []}
            self._state[key] = st  # concur: ok CC201
        return self._state[key]

    # -- consuming segment lifecycle ---------------------------------------
    def _segment_name(self, p: int, seq: int) -> str:
        # <table>__<partition>__<seq> (LLCSegmentName analog)
        return f"{self.table_name}__{p}__{seq}"

    def _new_mutable(self, p: int) -> MutableSegment:
        st = self._partition_state(p)
        m = MutableSegment(self.schema,
                           self._segment_name(p, st["seq"]),
                           self.table_config)
        m.start_offset = st["next_offset"]
        # same single-writer-per-partition rule as _partition_state
        self._mutables[p] = m  # concur: ok CC201
        self._mutable_age[p] = time.monotonic()  # concur: ok CC201
        self._row_offsets[p] = []  # concur: ok CC201
        return m

    def _stream_offset(self, p: int, rows: int) -> int:
        """Stream offset after `rows` rows of the consuming mutable: the
        recorded per-row offset when the stream publishes them (gapped
        Kinesis sequence numbers), else the dense checkpoint+rows
        arithmetic (kafka-style contiguous offsets)."""
        offs = self._row_offsets.get(p)
        if offs and 0 < rows <= len(offs):
            return offs[rows - 1] + 1
        return self._partition_state(p)["next_offset"] + rows

    def consume_once(self, p: int, consumer=None) -> int:
        """Drain currently-available messages for one partition; returns
        rows indexed. Deterministic entry point (tests + the thread loop)."""
        own = consumer is None
        if own:
            consumer = self.stream_config.consumer_factory.create_consumer(p)
        try:
            total = 0
            snapped_back = False
            while True:
                if faults.active() and faults.fault_fires(
                        "stream.rebalance", f"{self.table_name}/{p}"):
                    self._rebalance_reset(p)
                m = self._mutables[p]
                # never overshoot the seal threshold inside one batch
                room = max(1, self.stream_config.flush_threshold_rows
                           - m.n_docs)
                offset = self._stream_offset(p, m.n_docs)
                t_fetch = time.monotonic()
                try:
                    batch: MessageBatch = self._fetch_with_retry(
                        consumer, offset, min(FETCH_BATCH, room))
                except OffsetOutOfRange:
                    # a REAL offset snap-back (log truncation, expired
                    # iterator): same recovery as the injected
                    # stream.rebalance — resume from the checkpoint. One
                    # reset per drain; if the checkpoint offset is gone
                    # too, propagate to the consume loop's poll backoff
                    if snapped_back:
                        raise
                    snapped_back = True
                    self._rebalance_reset(p)
                    continue
                if not batch.rows:
                    break
                self._index_rows(p, m, batch.rows, offset)
                if batch.row_offsets is not None:
                    offs = self._row_offsets[p]
                    if len(offs) + len(batch.row_offsets) == m.n_docs:
                        offs.extend(batch.row_offsets)
                    else:
                        # a stream that mixes offset-bearing and dense
                        # batches can't be tracked per-row; drop to the
                        # dense arithmetic (empty list stays empty);
                        # single-writer per partition key (see
                        # _partition_state)
                        self._row_offsets[p] = []  # concur: ok CC201
                total += len(batch.rows)
                self._note_batch(len(batch.rows), t_fetch)
                self._maybe_seal(p)
            return total
        finally:
            if own:
                consumer.close()

    def _retry_bounded(self, call: Callable[[], Any], stat: str) -> Any:
        """Bounded retry-with-backoff (StreamConfig.fetch_retries /
        fetch_backoff_s — one tuning pair for the whole ingest plane):
        a transient failure (injected or real) must neither kill the
        consumer thread nor skip work. Each retry bumps ``stat``;
        exhaustion re-raises and the caller falls back to its
        poll-again path. IngestCrash is never retried — it IS the
        process dying."""
        cfg = self.stream_config
        for attempt in range(cfg.fetch_retries + 1):
            try:
                return call()
            except faults.IngestCrash:
                raise
            except OffsetOutOfRange:
                raise  # the offset is gone: retrying can never succeed
            except Exception:
                if attempt == cfg.fetch_retries:
                    raise
                self._count_stat(stat)
                time.sleep(cfg.fetch_backoff_s * (2 ** attempt))
        raise AssertionError("unreachable")

    def _fetch_with_retry(self, consumer, offset: int, limit: int
                          ) -> MessageBatch:
        """One consumer read under bounded retry: the checkpoint
        guarantees an exact re-read after exhaustion."""
        return self._retry_bounded(
            lambda: consumer.fetch(offset, limit), "stream_retries")

    def _note_batch(self, rows: int, t_fetch: float) -> None:
        """Freshness accounting per indexed batch: fetch-start ->
        queryable latency EWMA (rows are queryable the moment they are
        indexed — snapshot views include them) + the rows/sec inputs."""
        self._count_stat("rows", rows)
        lat_ms = (time.monotonic() - t_fetch) * 1e3
        with self._stats_lock:
            if self._ingest_t0 is None:
                self._ingest_t0 = t_fetch
            f = self._freshness_ms
            self._freshness_ms = lat_ms if f is None \
                else 0.8 * f + 0.2 * lat_ms
            # per-table gauge: two TABLES in one process must not
            # last-writer-wins each other's freshness on the consoles
            # (replicas of the same table still share one gauge —
            # _FRESHNESS_OWNERS guards removal, not the readings)
            gname = "ingest_freshness_ms_" + self.table_name
            with _FRESHNESS_LOCK:
                # gauge write + ownership record are atomic vs stop():
                # a stopping replica either sees this manager as owner
                # (and this gauge survives via its next write) or
                # removes strictly older state
                global_metrics.gauge(gname,
                                     round(self._freshness_ms, 3))
                _FRESHNESS_OWNERS[gname] = id(self)

    def _rebalance_reset(self, p: int) -> None:
        """Partition offsets snapped back (consumer-group rebalance /
        OffsetOutOfRange): drop the consuming mutable and resume from
        the durable checkpoint — the restart path minus the process
        death. Upsert/dedup PK state polluted by the discarded rows is
        rebuilt from committed segments only (phantom-duplicate
        rule)."""
        with self._seal_lock:
            discarded = self._mutables[p].n_docs
            self._new_mutable(p)
            self._rebuild_partition_metadata(p)
        if discarded:
            # the discarded consuming rows re-consume from the
            # checkpoint and would be counted again: back them out so
            # rows / rows_per_s mean DELIVERED rows — the freshness
            # ledger must not overstate throughput exactly on the chaos
            # runs it exists to measure
            self._count_stat("rows", -discarded)
        self._count_stat("rebalance_resets")

    def _index_rows(self, p: int, m: MutableSegment, rows, offset: int
                    ) -> None:
        """Index a batch, maintaining upsert/dedup metadata per row.

        Dedup'd rows are still indexed, but invalid — the stream offset
        accounting stays row = doc (the reference instead skips indexing;
        masks make skipping unnecessary here and keep offsets trivially
        exact)."""
        drop = None
        if self._pre_transformer is not None:
            try:
                rows = self._pre_transformer.transform(
                    [dict(r) for r in rows])
                if self._row_filter is not None:
                    drop = self._row_filter.drop_mask(rows)
                if self._post_transformer is not None:
                    rows = self._post_transformer.transform(rows)
            except Exception:
                # a poison batch must not kill the consumer thread
                # (realtimeRowsWithErrors in the reference): index
                # schema-shaped placeholders and invalidate them so
                # offset == doc accounting still holds
                from ..utils.metrics import global_metrics
                global_metrics.count("realtime_rows_with_errors",
                                    len(rows))
                rows = [{f.name: None for f in self.schema.fields}
                        for _ in rows]
                drop = np.ones(len(rows), dtype=bool)
        upsert = self._upsert.get(p)
        dedup = self._dedup.get(p)
        if upsert is not None and upsert.merger is not None:
            for i, row in enumerate(rows):
                if drop is not None and drop[i]:
                    m.invalidate_doc(m.index(row))  # ingestion-filtered
                    continue
                # partial mode merges with the current live row BEFORE
                # indexing, so the indexed row is already the merged one
                row = upsert.prepare_row(row)
                doc = m.index(row)
                upsert.add_row(m, doc, row, offset + i)
            upsert.evict_expired()  # metadata TTL housekeeping per batch
            return
        # every other table indexes the batch column by column. The rows
        # it drops (ingestion-filtered, dedup'd) are written invalid
        # before the batch is published, so no reader ever sees them; a
        # full-upsert table publishes row by row, each row's metadata
        # running before the next row shows, in the reference's order
        rows = list(rows)
        keep = None if drop is None else ~np.asarray(drop, dtype=bool)
        each = None
        if dedup is not None:
            dup = np.fromiter(
                ((keep is None or bool(keep[i])) and dedup.should_drop(row)
                 for i, row in enumerate(rows)), dtype=bool, count=len(rows))
            keep = ~dup if keep is None else keep & ~dup
        elif upsert is not None:
            def each(doc: int, k: int) -> None:
                if keep is None or keep[k]:
                    upsert.add_row(m, doc, rows[k], offset + k)
        m.index_batch(rows, keep, each)
        if upsert is not None:
            upsert.evict_expired()  # metadata TTL housekeeping per batch

    def _maybe_seal(self, p: int) -> None:
        m = self._mutables[p]
        cfg = self.stream_config
        age = time.monotonic() - self._mutable_age[p]
        if not (m.n_docs >= cfg.flush_threshold_rows or (
                m.n_docs > 0 and age >= cfg.flush_threshold_seconds)):
            return
        if self.completion_client is None:
            self.seal_partition(p)
        else:
            self._protocol_seal(p)

    def _protocol_seal(self, p: int) -> None:
        """Controller-arbitrated commit (SegmentCompletionProtocol client
        side): report the threshold, then act on the controller's verdict
        — COMMIT: build + split-commit; CATCHUP: keep consuming; HOLD:
        wait; COMMITTED: another replica won, download its artifact and
        resume from its end offset."""
        now = time.monotonic()
        if now - self._last_report.get(p, 0.0) < self.report_interval_s:
            return
        self._last_report[p] = now
        cc = self.completion_client
        m = self._mutables[p]
        name = m.name
        offset = self._stream_offset(p, m.n_docs)
        try:
            resp = self._completion_rpc(
                lambda: cc.segment_consumed(self.table_name, name,
                                            offset))
        except faults.IngestCrash:
            raise
        except Exception:
            return  # controller unreachable past the bounded retries:
            # report again next poll (HOLD/CATCHUP re-entry); a network
            # blip must never kill the consumer thread
        status = resp.get("status")
        if status == "COMMIT":
            # build-then-commit-then-adopt: local durable state advances
            # ONLY after the controller acknowledged the split commit —
            # a failed commit leaves the mutable live for retry/takeover
            t_commit = time.monotonic()
            with self._seal_lock:
                built = self._build_artifact(p)
            if built is None:
                return
            mm, seg, sealed = built
            ok = False
            try:
                from ..cluster.deepstore import pruning_metadata
                # the RPC (and its retry-backoff ladder) runs OUTSIDE
                # the table-wide seal lock: a flaky controller must not
                # stall other partitions' seal/adopt. Partition p's
                # state can't move underneath us — only p's own
                # consumer thread seals/adopts/resets p
                ok = self._completion_rpc(
                    lambda: cc.split_commit(self.table_name, name,
                                            seg.dir,
                                            pruning_metadata(seg.dir)))
            except faults.IngestCrash:
                raise
            except Exception:
                ok = False
            if ok:
                with self._seal_lock:
                    self._commit_local(p, mm, seg, sealed)
                self._note_commit_ms(
                    (time.monotonic() - t_commit) * 1e3)
            else:
                # the mutable stays live: the next poll re-reports,
                # the controller re-elects/continues, and the build
                # runs again (split-commit re-entry)
                self._count_stat("commit_failures")
                import shutil
                shutil.rmtree(seg.dir, ignore_errors=True)
        elif status == "COMMITTED":
            uri = resp.get("downloadURI")
            if uri is None:
                return  # nothing to adopt from; report again next poll
            off = resp.get("offset")
            try:
                # off may be None (registry fallback without offsets) —
                # _adopt_committed then derives it from the artifact's own
                # endOffset metadata, so the replica never stalls forever
                self._adopt_committed(
                    p, name, uri, None if off is None else int(off))
            except faults.IngestCrash:
                raise
            except Exception:
                # deep store stalled/corrupt (handoff.stall) or
                # unreachable: retry on the next poll
                self._count_stat("handoff_retries")
        # CATCHUP / HOLD: keep consuming / report again next poll

    def _completion_rpc(self, call: Callable[[], Any]) -> Any:
        """A completion-protocol RPC (injected commit.http_error or a
        real controller blip) under bounded retry; exhaustion falls back
        to report-again-next-poll at the caller."""
        return self._retry_bounded(call, "commit_retries")

    def _adopt_committed(self, p: int, name: str, download_uri: str,
                         end_offset: Optional[int]) -> None:
        """A peer replica committed this segment: drop the local consuming
        state, download the canonical artifact, resume after it (the
        non-winner CONSUMING->ONLINE transition with deep-store
        download)."""
        from ..cluster.deepstore import download_segment
        with self._seal_lock:
            if name in self._partition_state(p)["segments"]:
                return
        # the download (and any handoff stall, injected or real) runs
        # OUTSIDE the table-wide seal lock — same rule as the
        # split-commit RPC: one wedged deep store must not freeze other
        # partitions' seal/adopt. Only p's own consumer thread adopts p,
        # so p's state can't move underneath us
        seg_dir = download_segment(download_uri, self.data_dir)
        seg = ImmutableSegment.load(seg_dir, self.device)
        recount = 0
        with self._seal_lock:
            st = self._partition_state(p)
            if name in st["segments"]:
                return
            if end_offset is None:
                end_offset = seg.metadata.get(
                    "endOffset", st["next_offset"] + seg.n_docs)
            # the consuming tail past the adopted artifact's end will be
            # fetched (and counted) again: back it out below so
            # rows/rows_per_s keep meaning DELIVERED rows (approximate
            # under gapped kinesis sequence numbers, exact for dense)
            m = self._mutables[p]
            recount = max(0, self._stream_offset(p, m.n_docs)
                          - int(end_offset))
            with self._view_lock:  # the same atomic swap as a seal
                self.add_segment(seg)
                st["next_offset"] = end_offset
                st["seq"] += 1
                st["segments"].append(name)
                self._write_state()
                self._new_mutable(p)
            # the discarded mutable polluted the upsert/dedup metadata
            # with rows past end_offset that will be re-consumed; rebuild
            # the partition's PK state from committed segments only, or
            # re-consumed rows would be dropped as phantom duplicates
            self._rebuild_partition_metadata(p)
        if recount:
            self._count_stat("rows", -recount)

    def _rebuild_partition_metadata(self, p: int) -> None:
        if p in self._upsert:
            from ..upsert import PartitionUpsertMetadataManager
            self._upsert[p] = PartitionUpsertMetadataManager(
                self.upsert_config, site_key=f"{self.table_name}/{p}")
        elif p in self._dedup:
            from ..upsert import PartitionDedupMetadataManager
            self._dedup[p] = PartitionDedupMetadataManager(
                self.dedup_config)
        else:
            return
        st = self._partition_state(p)
        by_name = {s.name: s for s in super().acquire_segments()}
        for seg_name in st["segments"]:
            seg = by_name.get(seg_name)
            if seg is not None:
                self._replay_metadata(p, seg)

    def _build_artifact(self, p: int):
        """Build the immutable artifact from the consuming segment WITHOUT
        touching durable state — the commit decision may still fail (split
        commit), and the mutable must stay live until it succeeds.
        Returns (mutable, segment, sealed_docs) or None when empty."""
        m = self._mutables[p]
        if m.n_docs == 0:
            return None
        st = self._partition_state(p)
        seg_dir = m.seal(self.data_dir)
        sealed = m.sealed_docs  # NOT m.n_docs: rows indexed during the
        # build are absent from the artifact and must be re-consumed
        # record offsets in segment metadata for lineage/debug
        meta_path = os.path.join(seg_dir, "metadata.json")
        with open(meta_path) as fh:
            meta = json.load(fh)
        meta["startOffset"] = st["next_offset"]
        meta["endOffset"] = self._stream_offset(p, sealed)
        meta["partition"] = p
        with open(meta_path, "w") as fh:
            json.dump(meta, fh, indent=1)

        seg = ImmutableSegment.load(seg_dir, self.device)
        # upsert/dedup: carry the consuming segment's validDocIds into
        # the committed artifact and repoint PK locations at it
        valid = m.valid_mask(sealed)
        if not valid.all():
            seg.set_valid_docs(valid.copy())
            seg.persist_valid_docs()
        return m, seg, sealed

    def _commit_local(self, p: int, m, seg: ImmutableSegment,
                      sealed: int) -> None:
        """Second half of the seal: swap + checkpoint + fresh mutable."""
        if faults.active() and faults.fault_fires("commit.crash", m.name):
            # the commit.crash window: artifact built (and, on the
            # protocol path, split-committed) but the checkpoint
            # os.replace never ran — restart must re-consume the tail
            # exactly once (orphan cleanup + checkpoint replay)
            raise faults.IngestCrash(
                f"injected commit.crash before checkpoint ({m.name})")
        st = self._partition_state(p)
        if p in self._upsert:
            self._upsert[p].remap_segment(m, seg, sealed)
        with self._view_lock:  # atomic swap: queries see it immediately
            self.add_segment(seg)
            st["next_offset"] = self._stream_offset(p, sealed)
            st["seq"] += 1
            st["segments"].append(m.name)
            self._write_state()
            self._new_mutable(p)
        self._count_stat("commits")

    def seal_partition(self, p: int) -> Optional[ImmutableSegment]:
        """CONSUMING -> ONLINE: build, swap, checkpoint (standalone
        mode — no controller arbitration)."""
        t_commit = time.monotonic()
        with self._seal_lock:
            built = self._build_artifact(p)
            if built is None:
                return None
            m, seg, sealed = built
            self._commit_local(p, m, seg, sealed)
        self._note_commit_ms((time.monotonic() - t_commit) * 1e3)
        return seg

    # -- background consumption (PartitionConsumer.run analog) -------------
    def start(self) -> None:
        factory = self.stream_config.consumer_factory
        for p in range(factory.num_partitions()):
            t = threading.Thread(target=self._consume_loop, args=(p,),
                                 name=f"consumer-{self.table_name}-{p}",
                                 daemon=True)
            self._threads.append(t)
            t.start()

    def _consume_loop(self, p: int) -> None:
        consumer = self.stream_config.consumer_factory.create_consumer(p)
        try:
            while not self._stop.is_set():
                try:
                    n = self.consume_once(p, consumer)
                    self._maybe_seal(p)
                except faults.IngestCrash:
                    raise  # simulated process death: the loop dies too
                except Exception:
                    # transient trouble past the bounded retries: back
                    # off one poll interval, keep the consumer alive
                    global_metrics.count("ingest_consume_errors")
                    n = 0
                if n == 0:
                    self._stop.wait(self.poll_interval)
        finally:
            consumer.close()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        self._threads.clear()
        # drop this table's freshness gauge: ingest_health rolls up the
        # WORST table, and a dead table's last EWMA would pin it
        # forever. Owner-guarded: a stopped replica must not delete a
        # live replica's reading
        gname = "ingest_freshness_ms_" + self.table_name
        with _FRESHNESS_LOCK:
            if _FRESHNESS_OWNERS.get(gname) == id(self):
                global_metrics.remove_gauge(gname)
                _FRESHNESS_OWNERS.pop(gname, None)

    # -- query integration --------------------------------------------------
    def acquire_segments(self):
        """Committed immutables + consuming snapshots (hybrid view), read
        under the seal's swap lock."""
        with self._view_lock:
            segs = list(super().acquire_segments())
            views = [m.snapshot() for m in list(self._mutables.values())]
        return segs + [v for v in views if v.n_docs > 0]

    @property
    def consuming_docs(self) -> int:
        return sum(m.n_docs for m in self._mutables.values())

    # -- freshness ledger ---------------------------------------------------
    def ingest_stats(self) -> Dict[str, Any]:
        """The freshness ledger's writer-side view: rows/sec since the
        first consume, end-to-end freshness (fetch-start -> queryable
        EWMA, ms), commit/retry/recovery counters, and the faults fired
        by the installed plan (0 when none). ``faults_fired`` is the
        plan's PROCESS-WIDE total — a fault plan has no per-table
        attribution, so multi-table processes see the same number in
        every table's record; single-table chaos runs that need the
        per-run count pass it explicitly (tools/chaos_smoke.py)."""
        with self._stats_lock:
            stats = dict(self._stats)
            t0 = self._ingest_t0
            fresh = self._freshness_ms
            commit = self._commit_ewma
        elapsed = (time.monotonic() - t0) if t0 is not None else 0.0
        plan = faults.current_plan()
        # every counter in _stats ships under its own name; a new stat
        # must only be added to the _stats initializer + the ledger
        # contract (writer-side validation catches a missed contract)
        return {
            "table": self.table_name,
            **stats,
            "rows_per_s": round(stats["rows"] / elapsed, 3)
            if elapsed > 0 else 0.0,
            "freshness_ms": round(fresh, 3) if fresh is not None else None,
            "commit_ms": round(commit, 3) if commit is not None else None,
            "segments": self.num_segments,
            "consuming_docs": self.consuming_docs,
            "partitions": len(self._mutables),
            "faults_fired": len(plan.fired) if plan is not None else 0,
        }

    def write_ingest_stats(self, path: str, **extra: Any
                           ) -> Dict[str, Any]:
        """Append one validated ``ingest_stats`` v2 record (the
        freshness ledger, ``utils/ledger``'s field contract) at ``path``."""
        from ..utils import ledger as uledger
        rec = uledger.make_record("ingest_stats",
                                  **{**self.ingest_stats(), **extra})
        uledger.append_record(rec, path)
        return rec
