"""Stream ingestion SPI: partitioned consumption with integer offsets.

Port of ``pinot_tpu/realtime/stream.py``. ``InMemoryStream.produce_many``
appends each partition's rows under one hold of its lock instead of one
hold a row; the offsets each row gets are the same.

Reference parity: pinot-spi/.../spi/stream/{StreamConsumerFactory.java,
PartitionGroupConsumer.java, MessageBatch.java, StreamPartitionMsgOffset
.java, StreamConfig.java} (33 files). The TPU-native SPI keeps the same
shape at Python scale: a factory creates per-partition consumers; a
consumer fetches MessageBatch(rows, next_offset) from a start offset;
offsets are opaque-but-ordered ints persisted in the segment checkpoint
state (the ZK segment-metadata analog, manager.py).

InMemoryStream is the FakeStreamConsumerFactory analog (pinot-core test
fixture pattern, SURVEY.md section 4.6) and doubles as the bridge for any
in-process producer. Kafka/Kinesis-shaped plugins implement the same two
classes against their client libraries.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence


class OffsetOutOfRange(Exception):
    """A consumer's start offset no longer exists on the stream (log
    truncation/retention, shard reshard, consumer-group rebalance):
    retrying the same fetch can never succeed. Consumers raise this (or
    a subclass) instead of their generic transport error so the realtime
    manager can snap the partition back to its durable checkpoint
    (manager._rebalance_reset) rather than retry forever."""


def consume_faults(key: str) -> None:
    """The one named ingest-read fault hook (``stream.error``): every
    consumer's fetch() passes through here before touching its
    transport, so a seeded plan can fail kafka/kinesis/pulsar/in-memory
    reads identically. Zero-cost ``is None`` check when no plan is
    installed (utils/faults.py contract)."""
    from ..utils import faults
    if faults.active():
        faults.fault_point("stream.error", key)


@dataclass
class StreamConfig:
    topic: str
    num_partitions: int = 1
    # segment sealing thresholds (realtime.segment.flush.threshold.* analog)
    flush_threshold_rows: int = 100_000
    flush_threshold_seconds: float = 3600.0
    # bounded retry-with-backoff around consumer reads (the manager's
    # recovery muscle for stream.error-class transport failures)
    fetch_retries: int = 3
    fetch_backoff_s: float = 0.02
    consumer_factory: Optional["StreamConsumerFactory"] = None
    # config-named factory (stream.<type>.consumer.factory.class.name
    # analog): resolved via the plugin loader (spi/plugin.py) when no
    # factory instance was injected; args pass to its constructor
    consumer_factory_class: Optional[str] = None
    consumer_factory_args: Dict[str, Any] = field(default_factory=dict)

    def make_consumer_factory(self) -> "StreamConsumerFactory":
        if self.consumer_factory is not None:
            return self.consumer_factory
        if self.consumer_factory_class is None:
            raise ValueError("StreamConfig needs consumer_factory or "
                             "consumer_factory_class")
        from ..spi.plugin import create_instance
        self.consumer_factory = create_instance(
            self.consumer_factory_class, **self.consumer_factory_args)
        return self.consumer_factory


@dataclass
class MessageBatch:
    rows: List[Mapping[str, Any]]
    next_offset: int
    # per-row stream offsets for NON-DENSE streams (Kinesis sequence
    # numbers have gaps): row_offsets[i] is the offset of rows[i], and
    # the offset "after" it is row_offsets[i] + 1. None = dense stream
    # (offset arithmetic is checkpoint + row count).
    row_offsets: Optional[List[int]] = None

    @property
    def message_count(self) -> int:
        return len(self.rows)


class PartitionGroupConsumer:
    """One partition's consumer (PartitionGroupConsumer.java)."""

    def fetch(self, start_offset: int, max_messages: int) -> MessageBatch:
        raise NotImplementedError

    def latest_offset(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


class StreamConsumerFactory:
    """Creates per-partition consumers (StreamConsumerFactory.java)."""

    def num_partitions(self) -> int:
        raise NotImplementedError

    def create_consumer(self, partition: int) -> PartitionGroupConsumer:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# in-memory stream (FakeStream analog + in-process producer bridge)
# ---------------------------------------------------------------------------

class _Partition:
    def __init__(self):
        self.rows: List[Mapping[str, Any]] = []
        self.lock = threading.Lock()


class InMemoryStream(StreamConsumerFactory):
    def __init__(self, num_partitions: int = 1,
                 partitioner: Optional[Callable[[Mapping[str, Any]], int]]
                 = None, name: str = "mem"):
        """``name`` scopes the stream.error fault site key
        (``<name>/<partition>``) — give distinct streams distinct names
        when several consume concurrently in one process, or they share
        one per-key decision stream (faults.py purity contract)."""
        self._partitions = [_Partition() for _ in range(num_partitions)]
        self._partitioner = partitioner
        self.name = name

    def num_partitions(self) -> int:
        return len(self._partitions)

    def produce(self, row: Mapping[str, Any],
                partition: Optional[int] = None) -> int:
        if partition is None:
            if self._partitioner is not None:
                partition = self._partitioner(row) % len(self._partitions)
            else:
                partition = 0
        p = self._partitions[partition]
        with p.lock:
            p.rows.append(dict(row))
            return len(p.rows) - 1

    def produce_many(self, rows: Sequence[Mapping[str, Any]],
                     partition: Optional[int] = None) -> None:
        n = len(self._partitions)
        by_part: Dict[int, List[Mapping[str, Any]]] = {}
        for r in rows:
            if partition is not None:
                p = partition
            elif self._partitioner is not None:
                p = self._partitioner(r) % n
            else:
                p = 0
            by_part.setdefault(p, []).append(dict(r))
        for p, part_rows in by_part.items():
            part = self._partitions[p]
            with part.lock:
                part.rows.extend(part_rows)

    def create_consumer(self, partition: int) -> "_InMemoryConsumer":
        return _InMemoryConsumer(self._partitions[partition], partition,
                                 self.name)


class _InMemoryConsumer(PartitionGroupConsumer):
    def __init__(self, partition: _Partition, index: int = 0,
                 name: str = "mem"):
        self._p = partition
        self._key = f"{name}/{index}"

    def fetch(self, start_offset: int, max_messages: int) -> MessageBatch:
        consume_faults(self._key)
        with self._p.lock:
            rows = self._p.rows[start_offset: start_offset + max_messages]
            return MessageBatch(list(rows), start_offset + len(rows))

    def latest_offset(self) -> int:
        with self._p.lock:
            return len(self._p.rows)
