"""File-backed durable stream: the Kafka-shaped plugin for the stream SPI.

Port of ``pinot_tpu/realtime/filestream.py``, line for line: the log
format is shared, so either package's producer feeds either consumer.

Reference parity: pinot-plugins/pinot-stream-ingestion/pinot-kafka-2.0/
(KafkaConsumerFactory / KafkaPartitionLevelConsumer) against the SPI in
pinot-spi/.../spi/stream/StreamConsumerFactory.java. Kafka's essentials —
a durable partitioned append-only log, independent producer processes,
monotonically increasing per-partition offsets, restart-resume from a
committed offset — are modeled on the filesystem:

    <log_dir>/stream.json          {"numPartitions": N}
    <log_dir>/partition_<k>.log    one JSON object per line (the
                                   StreamDataDecoder analog is json.loads)

Offsets are ROW indexes (Kafka-like logical offsets, and what the
checkpoint accounting in realtime/manager.py expects). Consumers keep a
row->byte cursor so sequential fetches never rescan; a consumer created
at a non-zero offset (restart-resume) scans forward once. A partially
written trailing line (producer mid-append) is never consumed.

Producers may live in OTHER processes — each append is a single
write+flush of one line, and POSIX O_APPEND keeps concurrent producers'
lines intact.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Mapping, Optional

from .stream import MessageBatch, PartitionGroupConsumer, \
    StreamConsumerFactory, consume_faults

META_FILE = "stream.json"


def _log_path(log_dir: str, partition: int) -> str:
    return os.path.join(log_dir, f"partition_{partition}.log")


class FileLogProducer:
    """Appends JSON-line rows to partition logs (KafkaProducer analog;
    safe to run from any process)."""

    def __init__(self, log_dir: str, num_partitions: int = 1,
                 partitioner: Optional[Callable[[Mapping[str, Any]], int]]
                 = None):
        self.log_dir = log_dir
        self.num_partitions = num_partitions
        self._partitioner = partitioner
        os.makedirs(log_dir, exist_ok=True)
        meta = os.path.join(log_dir, META_FILE)
        if os.path.exists(meta):
            # the stream's partition count is fixed at creation (Kafka
            # topics don't silently change width either): adopt it so a
            # second producer process can't write to partitions no
            # consumer will ever read
            with open(meta) as fh:
                self.num_partitions = int(json.load(fh)["numPartitions"])
        else:
            tmp = meta + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"numPartitions": num_partitions}, fh)
            os.replace(tmp, meta)
        self._files = [open(_log_path(log_dir, p), "ab")
                       for p in range(self.num_partitions)]

    def produce(self, row: Mapping[str, Any],
                partition: Optional[int] = None) -> None:
        if partition is None:
            partition = (self._partitioner(row) % self.num_partitions
                         if self._partitioner else 0)
        line = json.dumps(row, separators=(",", ":")).encode() + b"\n"
        f = self._files[partition]
        f.write(line)
        f.flush()

    def produce_many(self, rows, partition: Optional[int] = None) -> None:
        for r in rows:
            self.produce(r, partition)

    def close(self) -> None:
        for f in self._files:
            f.close()


class FileLogStream(StreamConsumerFactory):
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        with open(os.path.join(log_dir, META_FILE)) as fh:
            self._num_partitions = int(json.load(fh)["numPartitions"])

    def num_partitions(self) -> int:
        return self._num_partitions

    def create_consumer(self, partition: int) -> "FileLogConsumer":
        return FileLogConsumer(_log_path(self.log_dir, partition))


class FileLogConsumer(PartitionGroupConsumer):
    def __init__(self, path: str):
        self._path = path
        self._row = 0      # cursor: next row index ...
        self._byte = 0     # ... starts at this byte

    def _seek_to(self, fh, start_offset: int) -> None:
        if start_offset == self._row:
            fh.seek(self._byte)
            return
        # non-sequential start (restart-resume): scan forward once
        fh.seek(0)
        row = 0
        pos = 0
        while row < start_offset:
            line = fh.readline()
            if not line or not line.endswith(b"\n"):
                # fewer complete rows than requested: EOF fetch. readline
                # consumed the partial fragment — the cursor must point at
                # its START so the line is re-read once it completes
                fh.seek(pos)
                break
            row += 1
            pos = fh.tell()
        self._row, self._byte = row, pos

    def fetch(self, start_offset: int, max_messages: int) -> MessageBatch:
        consume_faults(f"file/{os.path.basename(self._path)}")
        if not os.path.exists(self._path):
            return MessageBatch([], start_offset)
        rows = []
        with open(self._path, "rb") as fh:
            self._seek_to(fh, start_offset)
            if self._row < start_offset:  # log shorter than start
                return MessageBatch([], start_offset)
            while len(rows) < max_messages:
                pos = fh.tell()
                line = fh.readline()
                if not line or not line.endswith(b"\n"):
                    fh.seek(pos)  # partial trailing line: not ours yet
                    break
                rows.append(json.loads(line))
            self._row += len(rows)
            self._byte = fh.tell()
        return MessageBatch(rows, start_offset + len(rows))

    def latest_offset(self) -> int:
        if not os.path.exists(self._path):
            return 0
        with open(self._path, "rb") as fh:
            return sum(1 for line in fh if line.endswith(b"\n"))
