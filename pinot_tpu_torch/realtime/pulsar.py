"""Pulsar binary-protocol stream plugin: a real-protocol reader client +
an in-process fake broker speaking the same bytes.

Reference analog: pinot-plugins/pinot-stream-ingestion/pinot-pulsar/
.../PulsarPartitionLevelConsumer.java (the pulsar-client library is
replaced by a from-scratch client for the public Pulsar binary
protocol). Like the Kafka plugin (realtime/kafka.py), the client and
the FakePulsarBroker share only the wire contract, never code.

Implemented from the public protocol spec (PulsarApi.proto + the
binary-protocol docs), all from scratch:

- protobuf wire codec: varint, length-delimited submessages — enough to
  encode/decode the BaseCommand envelope and the sub-commands below
- simple command frame: [totalSize][commandSize][BaseCommand]
- payload command frame: [totalSize][commandSize][BaseCommand]
  [0x0e01 magic][CRC32C over metadata+payload][metadataSize]
  [MessageMetadata][payload] — checksum verified on every frame
- commands: CONNECT/CONNECTED, PRODUCER/PRODUCER_SUCCESS,
  SEND/SEND_RECEIPT, SUBSCRIBE (Reader-style: Exclusive,
  initial position), FLOW (permit-based delivery), MESSAGE,
  SEEK/SUCCESS, CLOSE_CONSUMER, PING/PONG, ERROR

Offsets (MessageId): Pulsar ids are (ledgerId, entryId) pairs — NOT
dense integers. The SPI offset packs them as (ledgerId << 20) | entryId
(a real BookKeeper ledger holds < 2^20 entries under default rollover)
and the consumer publishes per-row offsets (MessageBatch.row_offsets)
exactly like the Kinesis plugin, so the realtime manager's checkpoints
commit real ids. The fake broker rolls ledgers every few entries so
nothing can quietly assume one ledger or dense entry ids.

Port of ``pinot_tpu/realtime/pulsar.py``: the same frames, message ids
and packed offsets, so either package's broker serves either package's
clients. Where the port differs, the bytes do not: CRC32C is the port's
native one (``kafka.crc32c``); both ends parse frames out of one receive
buffer by offset instead of re-slicing it per frame; a reader decodes a
fetch's JSON payloads in one call when no ``value_decoder`` is given;
``PulsarProducer.send_many`` writes its SEND frames in windows of
``SEND_WINDOW`` and then reads their receipts (the frames and receipts
are the ones one-at-a-time sends exchange, in the same order).
"""
from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

from .kafka import crc32c
from .stream import MessageBatch, PartitionGroupConsumer, \
    StreamConsumerFactory, consume_faults, decode_json_values

# BaseCommand.Type values (PulsarApi.proto enum)
CONNECT, CONNECTED = 2, 3
SUBSCRIBE, PRODUCER, SEND, SEND_RECEIPT = 4, 5, 6, 7
MESSAGE, FLOW = 9, 11
SUCCESS, ERROR = 13, 14
CLOSE_PRODUCER, CLOSE_CONSUMER, PRODUCER_SUCCESS = 15, 16, 17
PING, PONG = 18, 19
SEEK = 28
GET_LAST_MESSAGE_ID, GET_LAST_MESSAGE_ID_RESPONSE = 29, 30

_MAGIC = 0x0E01
_ENTRY_BITS = 20          # SPI offset = ledgerId << 20 | entryId
_MAX_FRAME = 16 << 20


class PulsarError(Exception):
    """Protocol-level error (broker ERROR command or malformed bytes)."""


# ---------------------------------------------------------------------------
# minimal protobuf wire codec
# ---------------------------------------------------------------------------

def _pb_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_field(num: int, v: int) -> bytes:
    return _pb_varint(num << 3) + _pb_varint(v)


def _pb_bytes(num: int, data: bytes) -> bytes:
    return _pb_varint((num << 3) | 2) + _pb_varint(len(data)) + data


def _pb_str(num: int, s: str) -> bytes:
    return _pb_bytes(num, s.encode())


def pb_decode(data: bytes) -> Dict[int, List[Any]]:
    """field number -> list of values (ints for varint fields, bytes for
    length-delimited). Unknown wire types are skipped structurally."""
    out: Dict[int, List[Any]] = {}
    pos = 0

    def varint() -> int:
        nonlocal pos
        shift = v = 0
        while True:
            if pos >= len(data):
                raise PulsarError("truncated protobuf")
            b = data[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    while pos < len(data):
        tag = varint()
        num, wt = tag >> 3, tag & 7
        if wt == 0:
            val: Any = varint()
        elif wt == 2:
            n = varint()
            if pos + n > len(data):
                raise PulsarError("truncated protobuf")
            val = data[pos:pos + n]
            pos += n
        elif wt == 5:
            if pos + 4 > len(data):
                raise PulsarError("truncated protobuf")
            val = struct.unpack_from("<I", data, pos)[0]
            pos += 4
        elif wt == 1:
            if pos + 8 > len(data):
                raise PulsarError("truncated protobuf")
            val = struct.unpack_from("<Q", data, pos)[0]
            pos += 8
        else:
            raise PulsarError(f"unsupported wire type {wt}")
        out.setdefault(num, []).append(val)
    return out


def _one(fields: Dict[int, List[Any]], num: int, default=None):
    vals = fields.get(num)
    return vals[0] if vals else default


# message ids
def _encode_message_id(ledger: int, entry: int) -> bytes:
    return _pb_field(1, ledger) + _pb_field(2, entry)


def _decode_message_id(data: bytes) -> Tuple[int, int]:
    f = pb_decode(data)
    return _one(f, 1, 0), _one(f, 2, 0)


def pack_offset(ledger: int, entry: int) -> int:
    return (ledger << _ENTRY_BITS) | entry


def unpack_offset(offset: int) -> Tuple[int, int]:
    return offset >> _ENTRY_BITS, offset & ((1 << _ENTRY_BITS) - 1)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def encode_frame(cmd: bytes, metadata: Optional[bytes] = None,
                 payload: bytes = b"") -> bytes:
    if metadata is None:
        body = struct.pack(">I", len(cmd)) + cmd
        return struct.pack(">I", len(body)) + body
    blob = struct.pack(">I", len(metadata)) + metadata + payload
    crc = crc32c(blob)
    body = (struct.pack(">I", len(cmd)) + cmd
            + struct.pack(">HI", _MAGIC, crc) + blob)
    return struct.pack(">I", len(body)) + body


def decode_frame(body: bytes) -> Tuple[Dict[int, List[Any]],
                                       Optional[bytes], bytes]:
    """-> (BaseCommand fields, metadata bytes or None, payload)."""
    (cmd_size,) = struct.unpack_from(">I", body, 0)
    cmd = pb_decode(body[4:4 + cmd_size])
    rest = body[4 + cmd_size:]
    if not rest:
        return cmd, None, b""
    magic, crc = struct.unpack_from(">HI", rest, 0)
    if magic != _MAGIC:
        raise PulsarError(f"bad payload magic {magic:#x}")
    blob = rest[6:]
    if crc32c(blob) != crc:
        raise PulsarError("CRC32C mismatch on payload frame")
    (md_size,) = struct.unpack_from(">I", blob, 0)
    metadata = blob[4:4 + md_size]
    return cmd, metadata, blob[4 + md_size:]


class _Conn:
    """One connection: CONNECT handshake + framed send/recv."""

    def __init__(self, host: str, port: int, timeout: float):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)
        self._buf = bytearray()
        self._pos = 0
        connect = _pb_field(1, CONNECT) + _pb_bytes(
            3, _pb_str(1, "pinot-tpu") + _pb_field(4, 21))
        self.send(encode_frame(connect))
        cmd, _m, _p = self.recv()
        if _one(cmd, 1) != CONNECTED:
            raise PulsarError(f"expected CONNECTED, got {_one(cmd, 1)}")

    def send(self, frame: bytes) -> None:
        self.sock.sendall(frame)

    def recv(self) -> Tuple[Dict[int, List[Any]], Optional[bytes], bytes]:
        while True:
            buf, pos = self._buf, self._pos
            if len(buf) - pos >= 4:
                (total,) = struct.unpack_from(">I", buf, pos)
                if total > _MAX_FRAME:
                    raise PulsarError(f"frame too large: {total}")
                if len(buf) - pos >= 4 + total:
                    body = bytes(buf[pos + 4:pos + 4 + total])
                    self._pos = pos + 4 + total
                    cmd, md, pl = decode_frame(body)
                    t = _one(cmd, 1)
                    if t == PING:       # keepalive: answer and continue
                        self.send(encode_frame(_pb_field(1, PONG)))
                        continue
                    if t == ERROR:
                        err = pb_decode(_one(cmd, 16, b""))
                        msg = _one(err, 3, b"")
                        raise PulsarError(
                            msg.decode() if isinstance(msg, bytes)
                            else str(msg))
                    return cmd, md, pl
            if pos:
                del buf[:pos]           # drop the parsed frames once
                self._pos = 0
            chunk = self.sock.recv(1 << 20)
            if not chunk:
                raise PulsarError("connection closed")
            buf += chunk

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# sub-command field numbers (PulsarApi.proto):
# BaseCommand: each command type has its own submessage field — the ones
# used here: connect=3, subscribe=5, producer=7, send=8, send_receipt=9,
# message=11, flow=13, success=15, error=16, close_consumer=19,
# producer_success=20, seek=30


class PulsarStream(StreamConsumerFactory):
    """StreamConsumerFactory over partitioned Pulsar topics: partition i
    is topic '<topic>-partition-<i>' (the Pulsar partitioned-topic
    naming), one reader connection each."""

    def __init__(self, topic: str, host: str = "127.0.0.1",
                 port: int = 6650, partitions: Optional[int] = None,
                 timeout: float = 10.0, value_decoder=None):
        self.topic = topic
        self.host = host
        self.port = port
        self._partitions = partitions
        self.timeout = timeout
        self.value_decoder = value_decoder

    def num_partitions(self) -> int:
        if self._partitions is not None:
            return self._partitions
        raise PulsarError("partitions must be configured (the trimmed "
                          "client implements no LOOKUP/metadata round)")

    def create_consumer(self, partition: int) -> "PulsarReaderConsumer":
        return PulsarReaderConsumer(
            f"{self.topic}-partition-{partition}", self.host, self.port,
            self.timeout, self.value_decoder)


class PulsarReaderConsumer(PartitionGroupConsumer):
    """Reader-style consumer: SUBSCRIBE (Exclusive, earliest), SEEK to
    the fetch offset, FLOW permits, collect MESSAGE frames. Each fetch
    seeks explicitly, so the SPI's stateless fetch(start_offset)
    contract holds across restarts and redeliveries."""

    _next_consumer = [0]

    def __init__(self, topic: str, host: str, port: int, timeout: float,
                 value_decoder=None):
        self.topic = topic
        self._decoder = value_decoder
        self._conn = _Conn(host, port, timeout)
        PulsarReaderConsumer._next_consumer[0] += 1
        self.consumer_id = PulsarReaderConsumer._next_consumer[0]
        self._req = 0
        sub = (_pb_str(1, topic) + _pb_str(2, "pinot-tpu-reader")
               + _pb_field(3, 0)            # subType Exclusive
               + _pb_field(4, self.consumer_id)
               + _pb_field(5, self._next_req())
               + _pb_field(13, 1))          # initialPosition Earliest
        self._conn.send(encode_frame(_pb_field(1, SUBSCRIBE)
                                     + _pb_bytes(5, sub)))
        cmd, _m, _p = self._conn.recv()
        if _one(cmd, 1) != SUCCESS:
            raise PulsarError(f"subscribe failed: type {_one(cmd, 1)}")

    def _next_req(self) -> int:
        self._req += 1
        return self._req

    def fetch(self, start_offset: int, max_messages: int) -> MessageBatch:
        consume_faults(f"pulsar/{self.topic}")
        ledger, entry = unpack_offset(start_offset)
        seek = (_pb_field(1, self.consumer_id)
                + _pb_field(2, self._next_req())
                + _pb_bytes(3, _encode_message_id(ledger, entry)))
        self._conn.send(encode_frame(_pb_field(1, SEEK)
                                     + _pb_bytes(30, seek)))
        cmd, _m, _p = self._conn.recv()
        if _one(cmd, 1) != SUCCESS:
            raise PulsarError(f"seek failed: type {_one(cmd, 1)}")
        flow = (_pb_field(1, self.consumer_id)
                + _pb_field(2, max_messages))
        self._conn.send(encode_frame(_pb_field(1, FLOW)
                                     + _pb_bytes(13, flow)))

        values: List[bytes] = []
        row_offsets: List[int] = []
        next_offset = start_offset
        delivered = 0               # every MESSAGE consumes one permit,
        while delivered < max_messages:   # even ones we skip — counting
            cmd, _md, payload = self._conn.recv()   # rows would hang on
            t = _one(cmd, 1)                        # skipped deliveries
            if t != MESSAGE:
                raise PulsarError(f"unexpected command {t} mid-delivery")
            msg = pb_decode(_one(cmd, 11, b""))
            ledger, entry = _decode_message_id(_one(msg, 2, b""))
            if payload == b"":      # end-of-available marker (see fake)
                break
            delivered += 1
            if _one(msg, 1) != self.consumer_id:
                continue            # stale delivery for an old consumer
            off = pack_offset(ledger, entry)
            if off < start_offset:
                continue            # pre-seek redelivery
            values.append(payload)
            row_offsets.append(off)
            next_offset = off + 1
        if self._decoder is None:
            rows: List[Mapping[str, Any]] = decode_json_values(values)
        else:
            rows = [self._decoder(v) for v in values]
        return MessageBatch(rows, next_offset, row_offsets)

    def latest_offset(self) -> int:
        """GET_LAST_MESSAGE_ID — the protocol's metadata round for the
        topic end (no payload transfer, unlike a scan-to-end)."""
        req = (_pb_field(1, self.consumer_id)
               + _pb_field(2, self._next_req()))
        self._conn.send(encode_frame(_pb_field(1, GET_LAST_MESSAGE_ID)
                                     + _pb_bytes(32, req)))
        cmd, _m, _p = self._conn.recv()
        if _one(cmd, 1) != GET_LAST_MESSAGE_ID_RESPONSE:
            raise PulsarError(
                f"expected last-message-id response, got {_one(cmd, 1)}")
        resp = pb_decode(_one(cmd, 33, b""))
        ledger, entry = _decode_message_id(_one(resp, 1, b""))
        # a real broker signals an empty topic with entryId = -1
        # (varint-encoded as 2^64-1); (ledger 0, entry 0) is a REAL
        # first message, not a sentinel
        if entry >= 1 << 63 or ledger >= 1 << 63:
            return 0
        return pack_offset(ledger, entry) + 1

    def close(self) -> None:
        close = (_pb_field(1, self.consumer_id)
                 + _pb_field(2, self._next_req()))
        try:
            self._conn.send(encode_frame(_pb_field(1, CLOSE_CONSUMER)
                                         + _pb_bytes(19, close)))
        except OSError:
            pass
        self._conn.close()


class PulsarProducer:
    """Test-side producer speaking PRODUCER/SEND with payload frames."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self._conn = _Conn(host, port, timeout)
        self._producer_ids: Dict[str, int] = {}
        self._next_pid = 0
        self._req = 0
        self._seq = 0

    def _ensure_producer(self, topic: str) -> int:
        if topic in self._producer_ids:
            return self._producer_ids[topic]
        self._next_pid += 1
        pid = self._next_pid
        self._req += 1
        prod = (_pb_str(1, topic) + _pb_field(2, pid)
                + _pb_field(3, self._req))
        self._conn.send(encode_frame(_pb_field(1, PRODUCER)
                                     + _pb_bytes(7, prod)))
        cmd, _m, _p = self._conn.recv()
        if _one(cmd, 1) != PRODUCER_SUCCESS:
            raise PulsarError(f"producer failed: type {_one(cmd, 1)}")
        self._producer_ids[topic] = pid
        return pid

    SEND_WINDOW = 256      # SEND frames written before their receipts

    def _send_frame(self, pid: int, row: Mapping[str, Any]) -> bytes:
        self._seq += 1
        send = _pb_field(1, pid) + _pb_field(2, self._seq)
        metadata = (_pb_str(1, f"producer-{pid}")
                    + _pb_field(2, self._seq)
                    + _pb_field(3, 0))      # publish_time
        payload = json.dumps(row).encode()
        return encode_frame(
            _pb_field(1, SEND) + _pb_bytes(8, send), metadata, payload)

    def _receipt(self) -> int:
        cmd, _m, _p = self._conn.recv()
        if _one(cmd, 1) != SEND_RECEIPT:
            raise PulsarError(f"expected SEND_RECEIPT, got {_one(cmd, 1)}")
        receipt = pb_decode(_one(cmd, 9, b""))
        ledger, entry = _decode_message_id(_one(receipt, 3, b""))
        return pack_offset(ledger, entry)

    def send(self, topic: str, row: Mapping[str, Any]) -> int:
        """-> packed (ledgerId, entryId) offset from the SEND_RECEIPT."""
        pid = self._ensure_producer(topic)
        self._conn.send(self._send_frame(pid, row))
        return self._receipt()

    def send_many(self, topic: str, rows: List[Mapping[str, Any]]
                  ) -> List[int]:
        pid = self._ensure_producer(topic)
        out: List[int] = []
        for lo in range(0, len(rows), self.SEND_WINDOW):
            window = rows[lo:lo + self.SEND_WINDOW]
            self._conn.send(b"".join(self._send_frame(pid, r)
                                     for r in window))
            out.extend(self._receipt() for _ in window)
        return out

    def close(self) -> None:
        self._conn.close()


# ---------------------------------------------------------------------------
# fake Pulsar broker (embedded test fixture)
# ---------------------------------------------------------------------------

class FakePulsarBroker:
    """In-process TCP broker speaking the protocol subset above. Topics
    hold (ledgerId, entryId, payload) entries; LEDGERS ROLL every
    `ledger_entries` messages (entry ids restart at 0), so consumers
    can't assume one ledger or dense packed offsets. Delivery follows
    the real model: SEEK positions the cursor, FLOW grants permits,
    MESSAGE frames stream until permits or data run out; an empty-
    payload MESSAGE marks end-of-available (the test fixture's stand-in
    for a delivery pause)."""

    def __init__(self, topics: List[str], port: int = 0,
                 ledger_entries: int = 5):
        self.topics: Dict[str, List[Tuple[int, int, bytes]]] = {
            t: [] for t in topics}
        self.ledger_entries = ledger_entries
        self._next_ledger = 11
        self._lock = threading.Lock()
        broker = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                buf = bytearray()
                cursors: Dict[int, Tuple[str, int]] = {}  # cid -> (topic, pos_offset)
                producers: Dict[int, str] = {}
                sock = self.request
                try:
                    while True:
                        pos = 0
                        out = []
                        while len(buf) - pos >= 4:
                            (total,) = struct.unpack_from(">I", buf, pos)
                            if len(buf) - pos < 4 + total:
                                break
                            body = bytes(buf[pos + 4:pos + 4 + total])
                            pos += 4 + total
                            out += broker._handle(body, cursors, producers)
                        if out:
                            sock.sendall(b"".join(out))
                        del buf[:pos]
                        chunk = sock.recv(1 << 20)
                        if not chunk:
                            return
                        buf += chunk
                except (ConnectionError, OSError, PulsarError):
                    return

        class Srv(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Srv(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    # -- log --------------------------------------------------------------

    def append(self, topic: str, rows: List[Mapping[str, Any]]
               ) -> List[int]:
        """Direct append for fixtures; returns packed offsets."""
        out = []
        with self._lock:
            for r in rows:
                out.append(self._append_locked(
                    topic, json.dumps(r).encode()))
        return out

    def _append_locked(self, topic: str, payload: bytes) -> int:
        log = self.topics[topic]
        if not log or log[-1][1] + 1 >= self.ledger_entries:
            ledger = self._next_ledger
            self._next_ledger += 2      # gaps between ledger ids too
            entry = 0
        else:
            ledger, entry = log[-1][0], log[-1][1] + 1
        log.append((ledger, entry, payload))
        return pack_offset(ledger, entry)

    # -- protocol ----------------------------------------------------------

    def _handle(self, body: bytes, cursors, producers) -> List[bytes]:
        cmd, metadata, payload = decode_frame(body)
        t = _one(cmd, 1)
        if t == CONNECT:
            return [encode_frame(_pb_field(1, CONNECTED)
                                 + _pb_bytes(4, _pb_field(4, 21)))]
        if t == PRODUCER:
            p = pb_decode(_one(cmd, 7, b""))
            topic = _one(p, 1, b"").decode()
            pid = _one(p, 2, 0)
            if topic not in self.topics:
                return [self._error(f"no topic {topic!r}")]
            producers[pid] = topic
            ps = _pb_field(1, _one(p, 3, 0)) + _pb_str(2, f"p-{pid}")
            return [encode_frame(_pb_field(1, PRODUCER_SUCCESS)
                                 + _pb_bytes(20, ps))]
        if t == SEND:
            s = pb_decode(_one(cmd, 8, b""))
            pid = _one(s, 1, 0)
            topic = producers.get(pid)
            if topic is None:
                return [self._error(f"unknown producer {pid}")]
            with self._lock:
                off = self._append_locked(topic, payload)
            ledger, entry = unpack_offset(off)
            receipt = (_pb_field(1, pid) + _pb_field(2, _one(s, 2, 0))
                       + _pb_bytes(3, _encode_message_id(ledger, entry)))
            return [encode_frame(_pb_field(1, SEND_RECEIPT)
                                 + _pb_bytes(9, receipt))]
        if t == SUBSCRIBE:
            s = pb_decode(_one(cmd, 5, b""))
            topic = _one(s, 1, b"").decode()
            cid = _one(s, 4, 0)
            if topic not in self.topics:
                return [self._error(f"no topic {topic!r}")]
            cursors[cid] = (topic, 0)
            return [encode_frame(
                _pb_field(1, SUCCESS)
                + _pb_bytes(15, _pb_field(1, _one(s, 5, 0))))]
        if t == SEEK:
            s = pb_decode(_one(cmd, 30, b""))
            cid = _one(s, 1, 0)
            if cid not in cursors:
                return [self._error(f"unknown consumer {cid}")]
            ledger, entry = _decode_message_id(_one(s, 3, b""))
            cursors[cid] = (cursors[cid][0], pack_offset(ledger, entry))
            return [encode_frame(
                _pb_field(1, SUCCESS)
                + _pb_bytes(15, _pb_field(1, _one(s, 2, 0))))]
        if t == FLOW:
            f = pb_decode(_one(cmd, 13, b""))
            cid = _one(f, 1, 0)
            permits = _one(f, 2, 0)
            if cid not in cursors:
                return [self._error(f"unknown consumer {cid}")]
            topic, pos = cursors[cid]
            frames = []
            with self._lock:
                entries = [e for e in self.topics[topic]
                           if pack_offset(e[0], e[1]) >= pos][:permits]
            for ledger, entry, pl in entries:
                mid = _encode_message_id(ledger, entry)
                msg = _pb_field(1, cid) + _pb_bytes(2, mid)
                md = _pb_str(1, "p") + _pb_field(2, 1) + _pb_field(3, 0)
                frames.append(encode_frame(
                    _pb_field(1, MESSAGE) + _pb_bytes(11, msg), md, pl))
            if entries:
                last = pack_offset(entries[-1][0], entries[-1][1]) + 1
                cursors[cid] = (topic, last)
            if len(entries) < permits:
                # end-of-available marker (empty payload MESSAGE)
                mid = _encode_message_id(0, 0)
                msg = _pb_field(1, cid) + _pb_bytes(2, mid)
                frames.append(encode_frame(
                    _pb_field(1, MESSAGE) + _pb_bytes(11, msg),
                    _pb_str(1, "p") + _pb_field(2, 1) + _pb_field(3, 0),
                    b""))
            return frames
        if t == GET_LAST_MESSAGE_ID:
            g = pb_decode(_one(cmd, 32, b""))
            cid = _one(g, 1, 0)
            if cid not in cursors:
                return [self._error(f"unknown consumer {cid}")]
            topic = cursors[cid][0]
            neg1 = (1 << 64) - 1          # varint encoding of int64 -1
            with self._lock:
                log = self.topics[topic]
                last = (log[-1][0], log[-1][1]) if log else (neg1, neg1)
            resp = (_pb_bytes(1, _encode_message_id(*last))
                    + _pb_field(2, _one(g, 2, 0)))
            return [encode_frame(
                _pb_field(1, GET_LAST_MESSAGE_ID_RESPONSE)
                + _pb_bytes(33, resp))]
        if t == CLOSE_CONSUMER:
            c = pb_decode(_one(cmd, 19, b""))
            cursors.pop(_one(c, 1, 0), None)
            return [encode_frame(
                _pb_field(1, SUCCESS)
                + _pb_bytes(15, _pb_field(1, _one(c, 2, 0))))]
        return [self._error(f"unsupported command type {t}")]

    @staticmethod
    def _error(msg: str) -> bytes:
        err = _pb_field(1, 0) + _pb_field(2, 0) + _pb_str(3, msg)
        return encode_frame(_pb_field(1, ERROR) + _pb_bytes(16, err))

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
