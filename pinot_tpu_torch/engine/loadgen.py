"""Sustained multi-partition ingest-while-query load generation.

The closed-loop harness that measures freshness under sustained
multi-partition pressure WHILE a concurrent query mix runs, chaos armed:

- **producers** push seeded row sequences into real wire-protocol
  stream backends (the kafka / kinesis / pulsar protocol fakes, the
  wirestream TCP broker, or the in-memory fake) at a target per-
  partition rate (or flat-out in drain mode);
- **consumers** drive ``RealtimeTableDataManager`` partitions exactly
  like its own ``_consume_loop`` — but under loadgen supervision, so an
  injected ``IngestCrash`` (commit.crash / upsert.compact_crash) kills
  the whole manager like a real process death and the supervisor
  restarts it from the durable checkpoint, counting restarts;
- **query workers** run a seeded mix through the real Broker path
  concurrently with ingest, each query NAMED (``OPTION(queryId=...)``)
  so the per-query fault streams of utils/faults.py are reproducible
  and the run composes with micro-batching armed;
- a **sampler** trends each table's ``ingest_stats()`` (fetch->
  queryable freshness EWMA) into p50/p99 series, and per-commit
  latencies aggregate from ``manager.commit_latencies()``;
- the run ends **drained**: producers done, every partition's
  delivered-rows counter caught up, pending protocol commits settled —
  then the final queryable state (through the Broker) is diffed
  byte-exact against the fault-free oracle
  (tools/ingest_fuzz.oracle_rows per partition).

The summary dict is shaped for the validated ``ingest_bench`` ledger
kind (utils/ledger.py); ``write_ingest_bench`` appends it, and each
table also lands an ``ingest_stats`` record carrying its freshness
percentiles so the fleet rollup trends them per table.

Port of ``pinot_tpu/engine/loadgen.py``: the same rows, query mix and
fault streams for a seed, and the same final rows. The broker and every
manager's sealed segments live on ``device`` (default ``"cuda"``,
raising without it), and the summary's ``backend`` is that device's
torch type (``"cuda"`` or ``"cpu"``).
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..realtime import InMemoryStream, RealtimeTableDataManager, \
    StreamConfig
from ..spi import DataType, FieldSpec, FieldType, Schema
from ..upsert import UpsertConfig
from ..utils import faults
# the fleet-shared percentile definition: ingest-bench freshness trend
# lines must stay comparable with the rollup's per-table aggregation
from ..utils.stats import pctl

BACKENDS = ("mem", "wire", "kafka", "kinesis", "pulsar")

# the query mix (formatted per table): integral-SUM group-bys that are
# micro-batch fusable, a scalar aggregation, and a MIN/MAX shape that
# always dispatches solo — so a concurrent run exercises fused AND solo
# paths against moving realtime snapshots
QUERY_MIX = (
    "SELECT COUNT(*), SUM(val) FROM {t}",
    "SELECT pk, COUNT(*), SUM(val) FROM {t} GROUP BY pk "
    "ORDER BY pk LIMIT 64",
    "SELECT pk, SUM(ts) FROM {t} WHERE val < 500 GROUP BY pk "
    "ORDER BY pk LIMIT 64",
    "SELECT MIN(val), MAX(ts) FROM {t}",
)

N_PKS = 13          # colliding PKs (the ingest_fuzz upsert regime)
MAX_RESTARTS = 200  # crash/restart budget before declaring non-recovery


def loadgen_schema(table: str) -> Schema:
    """The pk/ts/val shape shared with tools/ingest_fuzz so its oracle
    (append exactly-once / upsert latest-wins) applies verbatim."""
    return Schema(table, [
        FieldSpec("pk", DataType.INT),
        FieldSpec("ts", DataType.INT, FieldType.METRIC),
        FieldSpec("val", DataType.INT, FieldType.METRIC),
    ])


def gen_partition_rows(seed: int, table_idx: int, partition: int,
                       n: int) -> List[Dict[str, int]]:
    """Seeded per-partition row sequence: colliding PKs + tie-heavy
    out-of-order ts (upsert latest-wins genuinely exercised). Pure in
    (seed, table_idx, partition, n) — same-seed runs produce identical
    streams, which is what makes the final oracle diff byte-exact."""
    rng = np.random.default_rng([seed, table_idx, partition])
    pks = rng.integers(0, N_PKS, n)
    ts = rng.integers(0, max(2, n // 3), n)
    vals = rng.integers(0, 1000, n)
    # host-only numpy scalars (seeded producer data, never on device)
    return [{"pk": int(pks[i]), "ts": int(ts[i]), "val": int(vals[i])}
            for i in range(n)]


@dataclass
class TableLoadSpec:
    """One ingest table in the run."""
    name: str
    partitions: int = 2
    upsert: bool = False
    protocol: bool = False      # controller-arbitrated split commits
    threshold: int = 64         # flush_threshold_rows
    backend: str = "mem"        # mem | wire | kafka | kinesis | pulsar


# ---------------------------------------------------------------------------
# stream backends: one uniform (factory, produce, close) per protocol
# ---------------------------------------------------------------------------

class _Backend:
    """A live stream transport: SPI consumer factory + a producer
    callable ``produce(partition, rows)`` + teardown."""

    def __init__(self, factory, produce: Callable[[int, List[dict]], None],
                 close: Callable[[], None]):
        self.factory = factory
        self.produce = produce
        self.close = close


class _PerPartition:
    """Lazily one protocol client per partition (creation guarded; use
    is single-threaded per partition by construction)."""

    def __init__(self, make: Callable[[int], Any]):
        self._make = make
        self._lock = threading.Lock()
        self._by_p: Dict[int, Any] = {}

    def get(self, p: int) -> Any:
        with self._lock:
            c = self._by_p.get(p)
        if c is None:
            # construct OUTSIDE the lock (opens a connection); a lost
            # duplicate is just closed by the setdefault loser's GC
            c = self._make(p)
            with self._lock:
                c = self._by_p.setdefault(p, c)
        return c

    def close_all(self) -> None:
        with self._lock:
            clients = list(self._by_p.values())
            self._by_p.clear()
        for c in clients:
            try:
                c.close()
            except Exception:
                pass


def _kinesis_shard_keys(n_shards: int) -> List[str]:
    """One partition key per target shard (the fake routes by
    md5(key) % shards, like the real service's hash-key ranges)."""
    keys: List[Optional[str]] = [None] * n_shards
    i = 0
    while any(k is None for k in keys):
        k = f"pk{i}"
        shard = int(hashlib.md5(k.encode()).hexdigest(), 16) % n_shards
        if keys[shard] is None:
            keys[shard] = k
        i += 1
    return [k for k in keys if k is not None]


def make_backend(spec: TableLoadSpec, data_dir: str) -> _Backend:
    """Spin up the protocol fake for one table and return the uniform
    produce/consume endpoints. All fakes are in-process but speak their
    REAL wire protocol (TCP for kafka/pulsar/wirestream, SigV4 HTTP for
    kinesis), so the rate harness exercises the same consumer code
    paths production would."""
    if spec.backend == "mem":
        stream = InMemoryStream(spec.partitions, name=spec.name)

        def produce_mem(p: int, rows: List[dict]) -> None:
            for r in rows:
                stream.produce(r, p)
        return _Backend(stream, produce_mem, lambda: None)

    # the protocol clients below are single-connection and NOT
    # thread-safe; each partition has exactly one producer thread, so
    # every partition gets its own client (created lazily on the
    # producing thread)
    if spec.backend == "wire":
        from ..realtime.wirestream import (WireBroker, WireProducer,
                                           WireStream)
        broker = WireBroker(num_partitions=spec.partitions,
                            log_dir=os.path.join(data_dir, "wal"))
        prods = _PerPartition(
            lambda p: WireProducer("127.0.0.1", broker.port))

        def produce_wire(p: int, rows: List[dict]) -> None:
            prods.get(p).produce_many(rows, p)

        def close_wire() -> None:
            prods.close_all()
            broker.stop()
        return _Backend(WireStream("127.0.0.1", port=broker.port),
                        produce_wire, close_wire)

    if spec.backend == "kafka":
        from ..realtime.kafka import (FakeKafkaBroker, KafkaProducer,
                                      KafkaStream)
        broker = FakeKafkaBroker({spec.name: spec.partitions})
        prods = _PerPartition(
            lambda p: KafkaProducer("127.0.0.1", broker.port))

        def produce_kafka(p: int, rows: List[dict]) -> None:
            prods.get(p).produce_many(spec.name, p, rows)

        def close_kafka() -> None:
            prods.close_all()
            broker.stop()
        return _Backend(KafkaStream(spec.name, port=broker.port),
                        produce_kafka, close_kafka)

    if spec.backend == "kinesis":
        from ..realtime.kinesis import (FakeKinesisServer, KinesisClient,
                                        KinesisStream)
        srv = FakeKinesisServer({spec.name: spec.partitions},
                                access_key="AK", secret_key="SK")
        prods = _PerPartition(
            lambda p: KinesisClient(srv.endpoint_url, "AK", "SK"))
        shard_keys = _kinesis_shard_keys(spec.partitions)

        def produce_kinesis(p: int, rows: List[dict]) -> None:
            client = prods.get(p)
            for r in rows:
                client.put_record(spec.name, json.dumps(r).encode(),
                                  shard_keys[p])
        return _Backend(
            KinesisStream(spec.name, srv.endpoint_url,
                          access_key="AK", secret_key="SK"),
            produce_kinesis, srv.stop)

    if spec.backend == "pulsar":
        from ..realtime.pulsar import (FakePulsarBroker, PulsarProducer,
                                       PulsarStream)
        topics = [f"{spec.name}-partition-{p}"
                  for p in range(spec.partitions)]
        broker = FakePulsarBroker(topics)
        prods = _PerPartition(
            lambda p: PulsarProducer("127.0.0.1", broker.port))

        def produce_pulsar(p: int, rows: List[dict]) -> None:
            prods.get(p).send_many(f"{spec.name}-partition-{p}", rows)
        return _Backend(
            PulsarStream(spec.name, port=broker.port,
                         partitions=spec.partitions),
            produce_pulsar, broker.stop)

    raise ValueError(f"unknown backend {spec.backend!r}; "
                     f"have {list(BACKENDS)}")


# ---------------------------------------------------------------------------
# per-table runtime: manager generations + crash/restart supervision
# ---------------------------------------------------------------------------

class _TableRun:
    """One table's live state. The manager is the 'process': an
    injected IngestCrash abandons it wholesale and a fresh one restarts
    from the durable checkpoint (orphan cleanup + metadata replay), the
    supervision contract tools/ingest_fuzz.IngestRun pins for one
    partition — here generation-numbered so every partition's consumer
    thread migrates to the restarted manager."""

    def __init__(self, idx: int, spec: TableLoadSpec, data_dir: str,
                 register: Callable[[RealtimeTableDataManager], None],
                 fetch_backoff_s: float = 0.002,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        self.idx = idx
        self.spec = spec
        self.data_dir = data_dir
        self.backend = make_backend(spec, data_dir)
        self._register = register
        self.fetch_backoff_s = fetch_backoff_s
        self.lock = threading.Lock()
        self._quiesce = threading.Condition(self.lock)
        self.active = 0        # consumer threads inside manager work
        self.generation = 0
        self.restarting = False
        self.restarts = 0
        self.produced: List[int] = [0] * spec.partitions
        self.producers_done = 0
        self.commit_ms: List[float] = []      # drained from dead managers
        self.freshness_samples: List[float] = []
        self.completion = None
        self.registry: Dict[Tuple[str, str], Dict[str, Any]] = {}
        if spec.protocol:
            from ..cluster.completion import SegmentCompletionManager
            self.completion = SegmentCompletionManager(
                lambda t: 1, decision_window_s=0.0,
                registered_segment=lambda t, s: self.registry.get((t, s)))
        self.manager = self._make_manager()
        self._register(self.manager)

    def _make_manager(self) -> RealtimeTableDataManager:
        spec = self.spec
        cfg = StreamConfig(
            spec.name, num_partitions=spec.partitions,
            flush_threshold_rows=spec.threshold,
            consumer_factory=self.backend.factory,
            fetch_backoff_s=self.fetch_backoff_s)
        cc = None
        if spec.protocol:
            from ..cluster.completion import LocalCompletionClient
            cc = LocalCompletionClient(
                self.completion, f"lg_{spec.name}",
                f"file://{self.data_dir}/deepstore", self.registry)
        ucfg = UpsertConfig(["pk"], comparison_column="ts") \
            if spec.upsert else None
        m = RealtimeTableDataManager(
            spec.name, loadgen_schema(spec.name), cfg,
            os.path.join(self.data_dir, "server"),
            upsert_config=ucfg, completion_client=cc, device=self.device)
        m.report_interval_s = 0.0
        return m

    def current(self) -> Tuple[int, RealtimeTableDataManager]:
        """A consistent (generation, manager) pair. Waits out an
        in-flight restart: between the generation bump and the manager
        swap the pair would read (new generation, OLD manager) — a
        consumer holding that ticket would keep consuming into the
        abandoned manager forever (its rows invisible to queries, the
        real tail never drained)."""
        with self.lock:
            while self.restarting:
                self._quiesce.wait(0.25)
            return self.generation, self.manager

    def current_generation(self) -> int:
        with self.lock:
            return self.generation

    def enter(self, gen: int) -> bool:
        """Begin one unit of manager work on generation ``gen``.
        False = the generation moved (a crash/restart happened, or one
        is in flight): the caller must re-fetch the current manager."""
        with self.lock:
            if self.restarting or self.generation != gen:
                return False
            self.active += 1
            return True

    def exit(self) -> None:
        with self.lock:
            self.active -= 1
            self._quiesce.notify_all()

    def crash(self, gen: int) -> None:
        """IngestCrash observed on generation ``gen``: simulate the
        process death — abandon the manager, restart from the durable
        checkpoint. A real kill -9 stops every partition's consumer at
        once, so the restart QUIESCES first: the generation bump stops
        new enter()s, then the rebuild waits until every peer thread
        has left the old manager (seals in flight included) — without
        the barrier, the new manager's orphan cleanup races a zombie
        seal and deletes the segment it is writing. The rebuild
        (checkpoint read + metadata replay, disk-only) then serializes
        the whole table under the run lock — that IS the restart."""
        with self.lock:
            if self.generation != gen:
                return              # a peer thread already restarted
            self.generation += 1
            self.restarts += 1
            self.restarting = True
            try:
                # bounded quiesce: peers are in consume/seal work units
                # that finish in at most a few fetch-retry backoffs
                deadline = time.monotonic() + 30.0
                while self.active > 0 and time.monotonic() < deadline:
                    self._quiesce.wait(0.25)
                old = self.manager
                self.commit_ms.extend(old.commit_latencies())
                _release_device(old)
                while True:
                    try:
                        self.manager = self._make_manager()
                        break
                    except faults.IngestCrash:
                        # crash inside the restart replay itself
                        self.restarts += 1
                        if self.restarts > MAX_RESTARTS:
                            raise RuntimeError(
                                f"{self.spec.name}: no recovery within "
                                f"{MAX_RESTARTS} restarts")
                self._register(self.manager)
            finally:
                # always released — current() waiters must not hang on
                # a blown restart budget
                self.restarting = False
                self._quiesce.notify_all()

    def note_produced(self, p: int, n: int) -> None:
        with self.lock:
            self.produced[p] += n

    def total_produced(self) -> int:
        with self.lock:
            return sum(self.produced)

    def producer_done(self) -> None:
        with self.lock:
            self.producers_done += 1

    def drained(self) -> bool:
        """All producers finished AND every produced row is queryable
        (committed segments + consuming snapshots — durable state, so
        the check survives crash/restart where the per-manager ``rows``
        counter resets) AND no partition still owes the completion
        protocol a commit. Exactly-once delivery means the doc total
        converges to the produced total from below."""
        with self.lock:
            if self.producers_done < self.spec.partitions:
                return False
            total = sum(self.produced)
            m = self.manager
        docs = sum(s.n_docs for s in m.acquire_segments())
        if docs < total:
            return False
        if self.spec.protocol:
            for mut in list(m._mutables.values()):
                if mut.n_docs >= self.spec.threshold:
                    return False    # commit owed: keep polling
        return True

    def sample_freshness(self) -> None:
        f = self.current()[1].ingest_stats()["freshness_ms"]
        if f is not None:
            with self.lock:
                self.freshness_samples.append(float(f))

    def raw_series(self) -> Tuple[List[float], List[float]]:
        """(freshness samples, per-commit latencies) — the manager's
        history is read before taking the run lock (commit_latencies
        takes the manager's own stats lock; no nesting)."""
        _gen, m = self.current()
        mlat = m.commit_latencies()
        with self.lock:
            return (list(self.freshness_samples),
                    self.commit_ms + mlat)

    def final_stats(self) -> Dict[str, Any]:
        _gen, m = self.current()
        fresh, commits = self.raw_series()
        fresh = sorted(fresh)
        commits = sorted(commits)
        with self.lock:
            restarts = self.restarts
        st = m.ingest_stats()
        st.update(
            restarts=restarts,
            freshness_p50_ms=round(pctl(fresh, 0.5), 3),
            freshness_p99_ms=round(pctl(fresh, 0.99), 3),
            commit_p50_ms=round(pctl(commits, 0.5), 3),
            commit_p99_ms=round(pctl(commits, 0.99), 3))
        return st

    def oracle_digest(self, seed: int,
                      rows_per_partition: int) -> List[Tuple[int, ...]]:
        from ..tools.ingest_fuzz import digest, oracle_rows
        expected: List[Tuple[int, int, int]] = []
        for p in range(self.spec.partitions):
            expected.extend(oracle_rows(
                gen_partition_rows(seed, self.idx, p, rows_per_partition),
                self.spec.upsert))
        return digest(expected)

    def close(self) -> None:
        m = self.current()[1]
        try:
            m.stop(timeout=1.0)
        finally:
            _release_device(m)
            self.backend.close()


def _release_device(manager: RealtimeTableDataManager) -> None:
    """A dead or closed manager is a process that ended: its sealed
    segments release their device residency now (queries still on them
    finish on their own uploads, ImmutableSegment.retire)."""
    for seg in manager.acquire_segments():
        if not getattr(seg, "is_mutable", False):
            seg.retire()


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

@dataclass
class LoadgenConfig:
    tables: List[TableLoadSpec] = field(default_factory=lambda: [
        TableLoadSpec("lg_append", partitions=2),
        TableLoadSpec("lg_upsert", partitions=2, upsert=True,
                      protocol=True),
    ])
    seed: int = 0
    rows_per_partition: int = 400
    rate_rows_s: Optional[float] = None   # per partition; None = flat out
    query_concurrency: int = 2
    query_timeout_ms: int = 300_000
    # per-worker think time between queries: sustained pressure, not a
    # saturation attack — flat-out workers starve the consumer threads
    # of CPU and a chaos tail (rebalance resets re-consuming a starved
    # tail) can livelock against the wall cap. 0 = flat out.
    query_think_s: float = 0.01
    sample_interval_s: float = 0.02
    poll_interval_s: float = 0.005
    max_wall_s: float = 120.0             # hard cap (chaos stall guard)
    scenario: str = "loadgen"
    fault_plan: Optional[str] = None      # PINOT_FAULTS grammar; armed
    # around the whole run (producers+consumers+queries) when set
    ledger_path: Optional[str] = None     # when set, run_load appends
    # ONE validated ingest_bench record + one ingest_stats per table


class IngestLoadGen:
    """One closed-loop ingest-while-query run (module docstring), its
    broker and sealed segments on ``device``."""

    def __init__(self, data_dir: str, config: LoadgenConfig,
                 device: Union[str, torch.device, None] = None):
        from ..broker import Broker
        self.cfg = config
        self.data_dir = data_dir
        self.broker = Broker(device=device)
        os.makedirs(data_dir, exist_ok=True)
        self.tables = [
            _TableRun(i, spec, os.path.join(data_dir, spec.name),
                      self.broker.register_table,
                      device=self.broker.device)
            for i, spec in enumerate(config.tables)]
        self._stop = threading.Event()       # consumers + sampler
        self._qstop = threading.Event()      # query workers
        self._qlock = threading.Lock()
        self._q_lat: List[float] = []
        self._q_errors = 0
        self._fatal: List[str] = []

    # -- producer ----------------------------------------------------------
    def _produce_loop(self, table: _TableRun, p: int) -> None:
        cfg = self.cfg
        rows = gen_partition_rows(cfg.seed, table.idx, p,
                                  cfg.rows_per_partition)
        chunk = 64
        t0 = time.monotonic()
        sent = 0
        try:
            while sent < len(rows) and not self._stop.is_set():
                if cfg.rate_rows_s is not None:
                    # pace against the wall-clock schedule, never ahead
                    due = int((time.monotonic() - t0) * cfg.rate_rows_s)
                    if due <= sent:
                        time.sleep(min(chunk / cfg.rate_rows_s, 0.02))
                        continue
                    batch = rows[sent:min(sent + min(due - sent, chunk),
                                          len(rows))]
                else:
                    batch = rows[sent:sent + chunk]
                for attempt in range(3):
                    try:
                        table.backend.produce(p, batch)
                        break
                    except Exception:
                        # transport hiccup on a fake's TCP path: bounded
                        # retry — a re-produce would double rows, so give
                        # up loudly past the budget
                        if attempt == 2:
                            raise
                        time.sleep(0.05)
                sent += len(batch)
                table.note_produced(p, len(batch))
        except Exception as e:  # noqa: BLE001 — surfaced in the summary
            with self._qlock:
                self._fatal.append(
                    f"producer {table.spec.name}/{p}: "
                    f"{type(e).__name__}: {e}")
        finally:
            table.producer_done()

    # -- consumer (supervised _consume_loop analog) ------------------------
    def _consume_loop(self, table: _TableRun, p: int) -> None:
        poll = self.cfg.poll_interval_s
        while not self._stop.is_set():
            gen, m = table.current()
            try:
                consumer = \
                    m.stream_config.consumer_factory.create_consumer(p)
            except Exception:
                if self._stop.wait(poll):
                    return
                continue
            try:
                while not self._stop.is_set():
                    if not table.enter(gen):
                        break       # generation moved: re-fetch manager
                    crashed = False
                    try:
                        n = m.consume_once(p, consumer)
                        m._maybe_seal(p)
                    except faults.IngestCrash:
                        crashed = True
                    except Exception:
                        # transient trouble past the bounded retries:
                        # back off one poll, keep the consumer alive
                        n = 0
                    finally:
                        # leave the work unit BEFORE restarting: the
                        # quiesce barrier counts this thread out
                        table.exit()
                    if crashed:
                        try:
                            table.crash(gen)
                        except Exception as e:  # restart budget blown
                            with self._qlock:
                                self._fatal.append(
                                    f"{table.spec.name}: "
                                    f"{type(e).__name__}: {e}")
                            return
                        break  # re-enter on the new generation
                    if n == 0 and self._stop.wait(poll):
                        break
            finally:
                try:
                    consumer.close()
                except Exception:
                    pass

    # -- query mix ---------------------------------------------------------
    def _query_loop(self, w: int) -> None:
        cfg = self.cfg
        rng = np.random.default_rng([cfg.seed, 7700 + w])
        i = 0
        while not self._qstop.is_set():
            # the seeded query mix picker
            spec = cfg.tables[int(rng.integers(len(cfg.tables)))]
            tmpl = QUERY_MIX[int(rng.integers(len(QUERY_MIX)))]
            # deterministic names: the per-query fault streams
            # (utils/faults.py) reproduce across same-seed runs
            sql = (tmpl.format(t=spec.name)
                   + f" OPTION(timeoutMs={cfg.query_timeout_ms},"
                     f"queryId=lg_w{w}_q{i})")
            t0 = time.perf_counter()
            try:
                self.broker.query(sql)
                ms = (time.perf_counter() - t0) * 1e3
                with self._qlock:
                    self._q_lat.append(ms)
            except Exception:
                # chaos may legitimately kill queries (oom_kill,
                # deadline); counted, never fatal to the harness
                with self._qlock:
                    self._q_errors += 1
            i += 1
            if cfg.query_think_s > 0 \
                    and self._qstop.wait(cfg.query_think_s):
                return

    # -- sampler -----------------------------------------------------------
    def _sample_loop(self) -> None:
        while not self._stop.wait(self.cfg.sample_interval_s):
            for table in self.tables:
                table.sample_freshness()

    # -- the run -----------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        plan = faults.install(cfg.fault_plan) if cfg.fault_plan else None
        t0 = time.monotonic()
        threads: List[threading.Thread] = []
        try:
            for table in self.tables:
                for p in range(table.spec.partitions):
                    threads.append(threading.Thread(
                        target=self._produce_loop, args=(table, p),
                        name=f"lg-prod-{table.spec.name}-{p}",
                        daemon=True))
                    threads.append(threading.Thread(
                        target=self._consume_loop, args=(table, p),
                        name=f"lg-cons-{table.spec.name}-{p}",
                        daemon=True))
            sampler = threading.Thread(target=self._sample_loop,
                                       name="lg-sampler", daemon=True)
            workers = [threading.Thread(target=self._query_loop,
                                        args=(w,), name=f"lg-query-{w}",
                                        daemon=True)
                       for w in range(cfg.query_concurrency)]
            for t in threads + [sampler] + workers:
                t.start()
            deadline = t0 + cfg.max_wall_s
            while time.monotonic() < deadline:
                with self._qlock:
                    fatal = bool(self._fatal)
                if fatal:
                    break
                if all(t.drained() for t in self.tables):
                    break
                time.sleep(cfg.poll_interval_s)
            wall = time.monotonic() - t0
            # stop EVERYTHING at the drain mark — a consumer left
            # running while query workers drain can eat an injected
            # rebalance that discards the consuming tail after the
            # drained check, and nothing would re-consume it
            self._qstop.set()
            self._stop.set()
            for wkr in workers:
                # bounded by the run's own budget, NOT the query
                # timeout: a chaos-wedged query must not extend the
                # max_wall_s cap by minutes (the worker is a daemon —
                # a straggler past this is abandoned, its latency
                # sample lost, and the summary proceeds)
                wkr.join(timeout=30.0)
            for t in threads + [sampler]:
                t.join(timeout=30.0)
        finally:
            self._qstop.set()
            self._stop.set()
            fired = len(plan.fired) if plan is not None else 0
            if plan is not None:
                faults.clear()
        # fault-free settle: chaos ended with the run — re-consume any
        # tail a last-instant rebalance/crash discarded and finish
        # pending protocol commits, so the oracle diff always measures
        # a DRAINED state (consumer threads are joined: the
        # single-writer-per-partition rule holds for these calls)
        drained = self._settle(time.monotonic() + 30.0)
        return self._summary(wall, drained, fired,
                             chaos=plan is not None)

    def _settle(self, deadline: float) -> bool:
        # one consumer per (table, partition) for the whole settle loop
        # — consume_once's own-consumer path would pay a fresh
        # transport connection (TCP / SigV4 handshake) per iteration
        consumers: Dict[Tuple[int, int], Any] = {}
        try:
            while True:
                if all(t.drained() for t in self.tables):
                    return True
                if time.monotonic() >= deadline:
                    return False
                for table in self.tables:
                    _gen, m = table.current()
                    factory = m.stream_config.consumer_factory
                    for p in range(table.spec.partitions):
                        try:
                            c = consumers.get((table.idx, p))
                            if c is None:
                                c = factory.create_consumer(p)
                                consumers[(table.idx, p)] = c
                            m.consume_once(p, c)
                            m._maybe_seal(p)
                        except Exception:
                            # bounded by the deadline, not per-call; a
                            # broken consumer is rebuilt next pass
                            consumers.pop((table.idx, p), None)
                time.sleep(0.002)
        finally:
            for c in consumers.values():
                try:
                    c.close()
                except Exception:
                    pass

    def _summary(self, wall: float, drained: bool, fired: int,
                 chaos: bool) -> Dict[str, Any]:
        cfg = self.cfg
        per_table: Dict[str, Any] = {}
        oracle_ok = drained
        for table in self.tables:
            st = table.final_stats()
            if drained:
                from ..tools.ingest_fuzz import digest
                got = digest(self._queryable_rows(table.spec.name))
                exact = got == table.oracle_digest(
                    cfg.seed, cfg.rows_per_partition)
                st["oracle_ok"] = exact
                oracle_ok = oracle_ok and exact
            per_table[table.spec.name] = st
        with self._qlock:
            lat = sorted(self._q_lat)
            q_errors = self._q_errors
            fatal = list(self._fatal)
        # rows = PRODUCED rows (exact by construction; the per-manager
        # ingest_stats counter resets on a crash/restart, so per_table
        # "rows" means rows-since-last-restart on chaos runs)
        rows = sum(t.total_produced() for t in self.tables)
        partitions = sum(t.spec.partitions for t in self.tables)
        series = [t.raw_series() for t in self.tables]
        fresh_all = sorted(f for fr, _c in series for f in fr)
        commits_all = sorted(c for _f, cm in series for c in cm)
        from .ragged import global_batcher
        out: Dict[str, Any] = {
            "backend": self.broker.device.type,
            "scenario": cfg.scenario,
            "seed": cfg.seed,
            "tables": len(self.tables),
            "partitions": partitions,
            "rows": rows,
            "duration_s": round(wall, 3),
            "rows_per_s": round(rows / wall, 3) if wall > 0 else 0.0,
            "rows_per_s_per_partition": round(
                rows / wall / max(partitions, 1), 3) if wall > 0 else 0.0,
            "freshness_p50_ms": round(pctl(fresh_all, 0.5), 3),
            "freshness_p99_ms": round(pctl(fresh_all, 0.99), 3),
            "commit_p50_ms": round(pctl(commits_all, 0.5), 3),
            "commit_p99_ms": round(pctl(commits_all, 0.99), 3),
            "commits": sum(st["commits"] for st in per_table.values()),
            "queries": len(lat),
            "queries_concurrent": cfg.query_concurrency,
            "query_p50_ms": round(pctl(lat, 0.5), 3),
            "query_p99_ms": round(pctl(lat, 0.99), 3),
            "query_errors": q_errors,
            "batched": bool(global_batcher.enabled),
            "restarts": sum(t.restarts for t in self.tables),
            "chaos": chaos,
            "faults_fired": fired,
            "oracle_ok": bool(oracle_ok),
            "per_table": per_table,
            "ok": bool(oracle_ok and drained and not fatal),
        }
        if not drained:
            out["error"] = (fatal[0] if fatal else
                            f"not drained within {cfg.max_wall_s}s")
        elif fatal:
            out["error"] = fatal[0]
        return out

    def _queryable_rows(self, table: str) -> List[Tuple[int, ...]]:
        res = self.broker.query(
            f"SELECT pk, ts, val FROM {table} LIMIT 10000000 "
            f"OPTION(timeoutMs={self.cfg.query_timeout_ms},"
            f"queryId=lg_oracle_{table})")
        return [tuple(int(v) for v in r) for r in res.rows]

    def close(self) -> None:
        self._qstop.set()
        self._stop.set()
        for table in self.tables:
            table.close()


def run_load(data_dir: str, config: LoadgenConfig,
             device: Union[str, torch.device, None] = None
             ) -> Dict[str, Any]:
    """Build, run, tear down on ``device``: the one-call entry point.
    With ``config.ledger_path`` set, the summary lands as one validated
    ``ingest_bench`` record plus one per-table ``ingest_stats`` record
    (freshness percentiles included) before teardown."""
    lg = IngestLoadGen(data_dir, config, device=device)
    try:
        summary = lg.run()
        if config.ledger_path:
            write_ingest_bench(summary, config.ledger_path)
            summary["table_stats_written"] = write_table_stats(
                summary, lg.tables, config.ledger_path, config.seed)
        return summary
    finally:
        lg.close()


def write_ingest_bench(summary: Dict[str, Any], path: str,
                       **extra: Any) -> Dict[str, Any]:
    """Append the run summary as ONE validated ``ingest_bench`` record
    (writer-side contract enforcement, like every other kind)."""
    from ..utils import ledger as uledger
    contract = uledger.KINDS["ingest_bench"]
    allowed = contract["required"] | contract["optional"]
    fields = {k: v for k, v in summary.items() if k in allowed}
    fields.update(extra)
    rec = uledger.make_record("ingest_bench", **fields)
    uledger.append_record(rec, path)
    return rec


def write_table_stats(lg_summary: Dict[str, Any], tables: List[_TableRun],
                      path: str, seed: int) -> int:
    """One validated per-table ``ingest_stats`` record each, carrying
    the run's freshness percentiles — the rows the fleet rollup trends
    per table."""
    n = 0
    for table in tables:
        st = lg_summary["per_table"][table.spec.name]
        table.current()[1].write_ingest_stats(
            path, seed=seed, restarts=st.get("restarts", 0),
            freshness_p50_ms=st.get("freshness_p50_ms"),
            freshness_p99_ms=st.get("freshness_p99_ms"))
        n += 1
    return n
