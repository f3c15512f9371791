"""Kinesis wire-protocol stream plugin: a real-API consumer client + an
in-process fake Kinesis endpoint speaking the same JSON.

Reference analog: pinot-plugins/pinot-stream-ingestion/pinot-kinesis/
.../KinesisConsumer.java:45 (consumer), KinesisConsumerFactory,
KinesisStreamMetadataProvider (shards), KinesisPartitionGroupOffset
(sequence-number offsets). The AWS SDK v2 client is replaced by a
from-scratch client for the public Kinesis Data Streams API: JSON over
HTTP with `X-Amz-Target: Kinesis_20131202.<Op>` +
`Content-Type: application/x-amz-json-1.1`, signed with AWS SigV4
(service "kinesis" — the same signer as fs/s3.py).

Operations: ListShards, GetShardIterator, GetRecords, PutRecord
(producer for tests). Record Data is base64; messages are JSON rows
(the decoder contract shared with the Kafka/wirestream plugins).

Offset mapping (KinesisPartitionGroupOffset analog): Kinesis sequence
numbers are decimal strings of unbounded integers, NOT dense. The SPI's
integer offset is defined as `last consumed sequence number + 1`; a
fetch at offset 0 uses a TRIM_HORIZON iterator, any other offset uses
AFTER_SEQUENCE_NUMBER(offset - 1). The fake server assigns sequence
numbers with gaps so nothing can quietly assume density. Shards map to
SPI partitions by sorted ShardId.

Port of ``pinot_tpu/realtime/kinesis.py``: the same requests, signatures
(``fs/s3.sigv4_headers``), sequence numbers and offsets, so either
package's endpoint serves either package's clients. A shard consumer
decodes a fetch's JSON records in one call when no ``value_decoder`` is
given (``stream.decode_json_values``); the rows are the reference's.
"""
from __future__ import annotations

import base64
import datetime
import hashlib
import json
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

from ..fs.rest import RestClient
from ..fs.s3 import sigv4_headers
from .stream import MessageBatch, OffsetOutOfRange, \
    PartitionGroupConsumer, StreamConsumerFactory, consume_faults, \
    decode_json_values

_TARGET_PREFIX = "Kinesis_20131202."
_CT = "application/x-amz-json-1.1"


class KinesisError(Exception):
    def __init__(self, status: int, type_: str, message: str):
        super().__init__(f"Kinesis {status} {type_}: {message}")
        self.status = status
        self.type = type_


class KinesisOffsetOutOfRange(KinesisError, OffsetOutOfRange):
    """The shard position can't be resumed: the sequence number aged out
    past retention (InvalidArgumentException) or the shard is gone after
    a reshard (ResourceNotFoundException). Subclasses the stream SPI's
    OffsetOutOfRange so the realtime manager snaps the partition back to
    its checkpoint instead of retrying an iterator mint that can never
    succeed."""


# GetShardIterator error types that mean "this position is gone", not
# "try again" — the snap-back classification above
_GONE_TYPES = ("InvalidArgumentException", "ResourceNotFoundException")


class KinesisClient:
    """Minimal Kinesis Data Streams API client with SigV4."""

    def __init__(self, endpoint_url: str, access_key: str = "",
                 secret_key: str = "", region: str = "us-east-1",
                 timeout: float = 10.0, max_retries: int = 3,
                 backoff: float = 0.2):
        # retries live HERE (per-attempt re-signing keeps x-amz-date
        # fresh); the transport itself never retries
        self.rest = RestClient(endpoint_url, timeout=timeout,
                               max_retries=0)
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.max_retries = max_retries
        self.backoff = backoff

    def call(self, op: str, payload: Dict[str, Any],
             retriable: bool = True) -> Dict[str, Any]:
        body = json.dumps(payload).encode()
        host = self.rest.host if self.rest.port in (80, 443) \
            else f"{self.rest.host}:{self.rest.port}"
        attempts = self.max_retries if retriable else 0
        for attempt in range(attempts + 1):
            amz_date = datetime.datetime.now(datetime.timezone.utc)\
                .strftime("%Y%m%dT%H%M%SZ")
            hdrs = sigv4_headers(
                "POST", host, "/", {},
                {"content-type": _CT,
                 "x-amz-target": _TARGET_PREFIX + op},
                hashlib.sha256(body).hexdigest(), self.access_key,
                self.secret_key, self.region, amz_date,
                service="kinesis")
            try:
                st, _h, resp = self.rest.request(
                    "POST", "/", headers=hdrs, body=body)
            except (ConnectionError, OSError) as e:
                if attempt == attempts:
                    raise
                time.sleep(self.backoff * (2 ** attempt))
                continue
            if st >= 500 and attempt < attempts:
                time.sleep(self.backoff * (2 ** attempt))
                continue
            if st != 200:
                try:
                    err = json.loads(resp.decode())
                    t = (err.get("__type") or "Unknown").split("#")[-1]
                    msg = err.get("message") or err.get("Message") or ""
                except ValueError:
                    t, msg = "Unknown", resp.decode(errors="replace")
                raise KinesisError(st, t, msg)
            return json.loads(resp.decode())
        raise AssertionError("unreachable")

    # -- operations -------------------------------------------------------

    def list_shards(self, stream: str) -> List[dict]:
        shards: List[dict] = []
        token: Optional[str] = None
        while True:
            payload: Dict[str, Any] = {"NextToken": token} if token \
                else {"StreamName": stream}
            res = self.call("ListShards", payload)
            shards.extend(res.get("Shards", []))
            token = res.get("NextToken")
            if not token:
                return shards

    def get_shard_iterator(self, stream: str, shard_id: str,
                           iterator_type: str,
                           sequence_number: Optional[str] = None) -> str:
        payload: Dict[str, Any] = {"StreamName": stream,
                                   "ShardId": shard_id,
                                   "ShardIteratorType": iterator_type}
        if sequence_number is not None:
            payload["StartingSequenceNumber"] = sequence_number
        return self.call("GetShardIterator", payload)["ShardIterator"]

    def get_records(self, iterator: str, limit: int) -> dict:
        return self.call("GetRecords",
                         {"ShardIterator": iterator, "Limit": limit})

    def put_record(self, stream: str, data: bytes,
                   partition_key: str) -> Tuple[str, str]:
        res = self.call("PutRecord", {
            "StreamName": stream,
            "Data": base64.b64encode(data).decode(),
            "PartitionKey": partition_key}, retriable=False)
        return res["ShardId"], res["SequenceNumber"]


class KinesisStream(StreamConsumerFactory):
    """StreamConsumerFactory over Kinesis (KinesisConsumerFactory
    analog). Shards (sorted by ShardId) are the SPI partitions."""

    def __init__(self, stream: str, endpoint_url: str,
                 access_key: str = "", secret_key: str = "",
                 region: str = "us-east-1", value_decoder=None,
                 **client_kw):
        self.stream = stream
        self.client = KinesisClient(endpoint_url, access_key, secret_key,
                                    region, **client_kw)
        self.value_decoder = value_decoder
        self._shard_cache: Optional[List[str]] = None

    def _shard_ids(self, refresh: bool = False) -> List[str]:
        """Sorted shard ids, cached after the first ListShards (the
        reference's metadata-provider caching) — steady-state consumption
        performs zero ListShards calls. refresh_shards() re-lists after
        a reshard."""
        if self._shard_cache is None or refresh:
            self._shard_cache = sorted(
                s["ShardId"] for s in self.client.list_shards(self.stream))
        return self._shard_cache

    def refresh_shards(self) -> List[str]:
        return self._shard_ids(refresh=True)

    def num_partitions(self) -> int:
        return len(self._shard_ids())

    def create_consumer(self, partition: int) -> "KinesisShardConsumer":
        shard_ids = self._shard_ids()
        if partition >= len(shard_ids):
            raise KinesisError(
                404, "ResourceNotFoundException",
                f"partition {partition} but only {len(shard_ids)} shards")
        return KinesisShardConsumer(self.client, self.stream,
                                    shard_ids[partition],
                                    self.value_decoder)


class KinesisShardConsumer(PartitionGroupConsumer):
    """One shard's consumer (KinesisConsumer.java:45 analog).

    Caches the NextShardIterator between contiguous fetches so steady
    consumption costs one GetRecords per batch, not an extra
    GetShardIterator (the reference caches the same way)."""

    def __init__(self, client: KinesisClient, stream: str, shard_id: str,
                 value_decoder=None):
        self.client = client
        self.stream = stream
        self.shard_id = shard_id
        self._decoder = value_decoder
        self._cached: Optional[Tuple[int, str]] = None  # (offset, iter)

    def _iterator_for(self, start_offset: int) -> str:
        if self._cached is not None and self._cached[0] == start_offset:
            return self._cached[1]
        if start_offset <= 0:
            return self.client.get_shard_iterator(
                self.stream, self.shard_id, "TRIM_HORIZON")
        try:
            return self.client.get_shard_iterator(
                self.stream, self.shard_id, "AFTER_SEQUENCE_NUMBER",
                str(start_offset - 1))
        except KinesisError as e:
            if e.type in _GONE_TYPES:
                raise KinesisOffsetOutOfRange(
                    e.status, e.type,
                    f"cannot resume {self.stream}/{self.shard_id} at "
                    f"{start_offset}: {e}") from e
            raise

    def fetch(self, start_offset: int, max_messages: int) -> MessageBatch:
        consume_faults(f"kinesis/{self.stream}/{self.shard_id}")
        it = self._iterator_for(start_offset)
        try:
            res = self.client.get_records(it, max_messages)
        except KinesisError as e:
            # a cached iterator can expire (5-minute service TTL);
            # re-mint once from the sequence number and retry — without
            # this, a quiet partition wedges permanently on one token
            self._cached = None
            if e.type != "ExpiredIteratorException":
                raise
            res = self.client.get_records(
                self._iterator_for(start_offset), max_messages)
        values: List[bytes] = []
        row_offsets: List[int] = []
        next_offset = start_offset
        for rec in res.get("Records", []):
            values.append(base64.b64decode(rec["Data"]))
            row_offsets.append(int(rec["SequenceNumber"]))
            next_offset = row_offsets[-1] + 1
        if self._decoder is None:
            rows: List[Mapping[str, Any]] = decode_json_values(values)
        else:
            rows = [self._decoder(v) for v in values]
        nxt = res.get("NextShardIterator")
        self._cached = (next_offset, nxt) if nxt else None
        # publish per-row sequence numbers: they are NOT dense, and the
        # realtime manager needs the exact offset after any row count
        return MessageBatch(rows, next_offset, row_offsets)

    def latest_offset(self) -> int:
        """Kinesis has no 'latest sequence' API; walk forward from
        TRIM_HORIZON (test/diagnostic use only — the realtime manager
        checkpoints consumed offsets, never this)."""
        off = 0
        while True:
            batch = self.fetch(off, 10_000)
            if not batch.rows:
                return off
            off = batch.next_offset

    def close(self) -> None:
        self._cached = None


# ---------------------------------------------------------------------------
# fake Kinesis endpoint (embedded test fixture, localstack-of-the-suite)
# ---------------------------------------------------------------------------

class FakeKinesisServer:
    """In-process Kinesis API endpoint. Sequence numbers increase with
    GAPS (step 3) so clients can't assume density; iterators are opaque
    one-shot tokens renewed by every GetRecords, like the real service.
    Verifies SigV4 when credentials are configured. `inject_failures(n)`
    makes the next n requests 500 (retry-path testing)."""

    def __init__(self, streams: Dict[str, int], port: int = 0,
                 access_key: Optional[str] = None, secret_key: str = ""):
        import http.server

        self.access_key = access_key
        self.secret_key = secret_key
        # stream -> [shard records]; record = (seq:int, pkey, data bytes)
        self.shards: Dict[str, List[List[Tuple[int, str, bytes]]]] = {
            s: [[] for _ in range(n)] for s, n in streams.items()}
        self.next_seq = 7                      # arbitrary non-zero start
        self.iterators: Dict[str, Tuple[str, int, int]] = {}
        self.next_iter = 0
        self.fail_next = 0
        self._lock = threading.Lock()
        stub = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, status: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", _CT)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self) -> None:
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n)
                with stub._lock:
                    if stub.fail_next > 0:
                        stub.fail_next -= 1
                        return self._reply(500, {
                            "__type": "InternalFailure",
                            "message": "injected"})
                if not stub._auth_ok(self.headers):
                    return self._reply(403, {
                        "__type": "IncompleteSignatureException",
                        "message": "bad signature"})
                op = (self.headers.get("X-Amz-Target") or "")\
                    .split(".")[-1]
                try:
                    payload = json.loads(body.decode() or "{}")
                    st, out = stub._dispatch(op, payload)
                except KeyError as e:
                    st, out = 400, {"__type": "ValidationException",
                                    "message": f"missing {e}"}
                self._reply(st, out)

        class _Srv(http.server.ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Srv(("127.0.0.1", port), _Handler)
        self.port = self._server.server_address[1]
        self.endpoint_url = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    # -- handler core -----------------------------------------------------

    def _auth_ok(self, headers) -> bool:
        if self.access_key is None:
            return True
        auth = headers.get("Authorization") or ""
        return (auth.startswith("AWS4-HMAC-SHA256")
                and f"Credential={self.access_key}/" in auth
                and "Signature=" in auth)

    def _shard_list(self, stream: str) -> List[List]:
        if stream not in self.shards:
            raise _NotFound(f"stream {stream!r} not found")
        return self.shards[stream]

    def _dispatch(self, op: str, p: dict) -> Tuple[int, dict]:
        try:
            with self._lock:
                if op == "ListShards":
                    stream = p.get("StreamName") or p["NextToken"]
                    shards = self._shard_list(stream)
                    return 200, {"Shards": [
                        {"ShardId": f"shardId-{i:012d}",
                         "SequenceNumberRange": {
                             "StartingSequenceNumber":
                                 str(recs[0][0]) if recs else "0"}}
                        for i, recs in enumerate(shards)]}
                if op == "GetShardIterator":
                    stream = p["StreamName"]
                    sid = p["ShardId"]
                    idx = int(sid.rsplit("-", 1)[-1])
                    shards = self._shard_list(stream)
                    if idx >= len(shards):
                        raise _NotFound(f"no shard {sid}")
                    t = p["ShardIteratorType"]
                    if t == "TRIM_HORIZON":
                        pos = 0
                    elif t == "LATEST":
                        pos = 1 << 62
                    elif t == "AFTER_SEQUENCE_NUMBER":
                        pos = int(p["StartingSequenceNumber"]) + 1
                    elif t == "AT_SEQUENCE_NUMBER":
                        pos = int(p["StartingSequenceNumber"])
                    else:
                        return 400, {"__type": "ValidationException",
                                     "message": f"bad type {t}"}
                    return 200, {"ShardIterator":
                                 self._mint(stream, idx, pos)}
                if op == "GetRecords":
                    it = p["ShardIterator"]
                    tok = self.iterators.pop(it, None)
                    if tok is None:
                        return 400, {"__type": "ExpiredIteratorException",
                                     "message": "unknown iterator"}
                    stream, idx, pos = tok
                    recs = self.shards[stream][idx]
                    limit = int(p.get("Limit", 10_000))
                    out = [r for r in recs if r[0] >= pos][:limit]
                    new_pos = out[-1][0] + 1 if out else pos
                    return 200, {
                        "Records": [{
                            "SequenceNumber": str(seq),
                            "PartitionKey": pk,
                            "ApproximateArrivalTimestamp": 0,
                            "Data": base64.b64encode(data).decode()}
                            for seq, pk, data in out],
                        "NextShardIterator":
                            self._mint(stream, idx, new_pos),
                        "MillisBehindLatest": 0}
                if op == "PutRecord":
                    stream = p["StreamName"]
                    shards = self._shard_list(stream)
                    pk = p["PartitionKey"]
                    data = base64.b64decode(p["Data"])
                    idx = int(hashlib.md5(pk.encode()).hexdigest(),
                              16) % len(shards)
                    seq = self.next_seq
                    self.next_seq += 3       # gaps: density is a lie
                    shards[idx].append((seq, pk, data))
                    return 200, {"ShardId": f"shardId-{idx:012d}",
                                 "SequenceNumber": str(seq)}
            return 400, {"__type": "UnknownOperationException",
                         "message": op}
        except _NotFound as e:
            return 400, {"__type": "ResourceNotFoundException",
                         "message": str(e)}

    def _mint(self, stream: str, idx: int, pos: int) -> str:
        # called only from the API dispatch, which already holds _lock
        self.next_iter += 1
        it = f"it-{self.next_iter}"
        self.iterators[it] = (stream, idx, pos)
        return it

    # -- test hooks -------------------------------------------------------

    def put(self, stream: str, shard: int,
            rows: List[Mapping[str, Any]]) -> None:
        """Direct append for fixtures (bypasses the API, keeps gaps)."""
        with self._lock:
            for r in rows:
                seq = self.next_seq
                self.next_seq += 3
                self.shards[stream][shard].append(
                    (seq, "fixture", json.dumps(r).encode()))

    def inject_failures(self, n: int) -> None:
        with self._lock:
            self.fail_next = n

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class _NotFound(Exception):
    pass
