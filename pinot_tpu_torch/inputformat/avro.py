"""Avro from scratch: binary codec, object-container files, and the
Confluent schema-registry wire format.

Port of ``pinot_tpu/inputformat/avro.py``, unchanged, so a container file
or a Confluent frame written by either package is byte-equal and reads
in both. Reference parity: pinot-plugins/pinot-input-format/pinot-avro
(-base) (container-file ingestion) and pinot-confluent-avro/
.../KafkaConfluentSchemaRegistryAvroMessageDecoder.java:53. No
fastavro or confluent library is needed: the Avro binary encoding and
the Confluent framing are small, stable public specs, implemented here
directly:

- binary codec: zigzag-varint int/long, IEEE float/double (LE),
  length-prefixed bytes/string, enum index, fixed, union branch index,
  records in field order, block-encoded arrays/maps (negative block
  counts carry a byte size to skip);
- object container files: 'Obj\\x01' magic, metadata map with
  avro.schema / avro.codec (null + deflate via zlib), 16-byte sync
  marker, counted blocks;
- Confluent wire format: magic 0x00 | 4-byte big-endian schema id |
  Avro binary body; schemas fetched from a registry REST endpoint
  (GET /schemas/ids/{id}) and cached per id. SchemaRegistryStub is the
  in-process registry for tests (POST /subjects/{s}/versions assigns
  ids like the real service). ``ConfluentAvroDecoder`` is callable, so
  it is a ``KafkaStream(value_decoder=...)``.

logicalType handling: decimal (bytes- OR fixed-backed) decodes to
decimal.Decimal (unscaled big-endian two's complement / 10^scale) and
Decimal values re-encode symmetrically; date / time-* / timestamp-* /
uuid deliberately pass through as their underlying int/long/string —
the ingestion pipeline consumes epoch numbers natively (dateTime field
specs), so no datetime objects are fabricated.
"""
from __future__ import annotations

import io
import json
import struct
import threading
import urllib.request
import zlib
from typing import Any, Dict, List, Optional, Tuple


class AvroError(ValueError):
    pass


# ---------------------------------------------------------------------------
# binary codec
# ---------------------------------------------------------------------------

def _zigzag_encode(n: int) -> bytes:
    u = (n << 1) ^ (n >> 63)
    u &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag_decode(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise AvroError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return (result >> 1) ^ -(result & 1), pos
        shift += 7
        if shift > 63:
            raise AvroError("varint too long")


_PRIMITIVES = {"null", "boolean", "int", "long", "float", "double",
               "bytes", "string"}


def _is_decimal_schema(s: Any) -> bool:
    return isinstance(s, dict) and s.get("logicalType") == "decimal" \
        and s.get("type") in ("bytes", "fixed")


def _decimal_from_bytes(raw: bytes, s: Dict[str, Any]):
    import decimal
    unscaled = int.from_bytes(raw, "big", signed=True)
    return decimal.Decimal(unscaled).scaleb(-int(s.get("scale", 0)))


def _decimal_to_bytes(v, s: Dict[str, Any]) -> bytes:
    import decimal
    if isinstance(v, float):
        # floats normalize through their shortest repr: 1.23 means the
        # written "1.23" (fits scale 2), not its binary expansion
        # 1.2299999999999999822... (which would reject every non-dyadic)
        v = decimal.Decimal(str(v))
    scaled = decimal.Decimal(v).scaleb(int(s.get("scale", 0)))
    unscaled = int(scaled)
    if unscaled != scaled:
        # reference Avro writers reject scale mismatches; silently
        # rounding would corrupt (monetary) values on ingest
        raise AvroError(
            f"decimal {v} does not fit scale {s.get('scale', 0)}")
    if s.get("type") == "fixed":
        try:
            return unscaled.to_bytes(s["size"], "big", signed=True)
        except OverflowError:
            raise AvroError(
                f"decimal {v} overflows fixed size {s['size']}") from None
    n = max((unscaled.bit_length() + 8) // 8, 1)   # minimal two's compl.
    return unscaled.to_bytes(n, "big", signed=True)


def _type_name(schema: Any) -> str:
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    return schema["type"]


class AvroCodec:
    """Encoder/decoder for one schema (JSON string or parsed)."""

    def __init__(self, schema: Any):
        if isinstance(schema, str) and schema not in _PRIMITIVES:
            schema = json.loads(schema)
        self.schema = schema
        self._named: Dict[str, Any] = {}
        self._index_names(schema)

    def _index_names(self, s: Any, enclosing_ns: str = "") -> None:
        """Register named types under BOTH the short name and the
        namespaced fullname (Java-written schemas reference reused
        types by fullname; child types inherit the enclosing namespace
        per the spec)."""
        if isinstance(s, dict):
            ns = s.get("namespace", enclosing_ns)
            if s.get("name") and s.get("type") in ("record", "enum",
                                                   "fixed"):
                self._named[s["name"]] = s
                if ns:
                    self._named[f"{ns}.{s['name']}"] = s
            for f in s.get("fields", []):
                self._index_names(f["type"], ns)
            for k in ("items", "values"):
                if k in s:
                    self._index_names(s[k], ns)
        elif isinstance(s, list):
            for b in s:
                self._index_names(b, enclosing_ns)

    def _resolve(self, s: Any) -> Any:
        if isinstance(s, str) and s in self._named:
            return self._named[s]
        return s

    # -- decode -----------------------------------------------------------
    def decode(self, buf: bytes, pos: int = 0) -> Tuple[Any, int]:
        return self._dec(self.schema, buf, pos)

    def _dec(self, s: Any, buf: bytes, pos: int) -> Tuple[Any, int]:
        s = self._resolve(s)
        t = _type_name(s)
        if t == "null":
            return None, pos
        if t == "boolean":
            if pos >= len(buf):
                raise AvroError("truncated boolean")
            return buf[pos] != 0, pos + 1
        if t in ("int", "long"):
            return _zigzag_decode(buf, pos)
        if t == "float":
            if pos + 4 > len(buf):
                raise AvroError("truncated float")
            return struct.unpack("<f", buf[pos:pos + 4])[0], pos + 4
        if t == "double":
            if pos + 8 > len(buf):
                raise AvroError("truncated double")
            return struct.unpack("<d", buf[pos:pos + 8])[0], pos + 8
        if t in ("bytes", "string"):
            n, pos = _zigzag_decode(buf, pos)
            raw = buf[pos:pos + n]
            if len(raw) != n:
                raise AvroError("truncated bytes/string")
            if t == "bytes" and isinstance(s, dict) \
                    and s.get("logicalType") == "decimal":
                return _decimal_from_bytes(raw, s), pos + n
            return (raw.decode() if t == "string" else raw), pos + n
        if t == "fixed":
            n = s["size"]
            raw = buf[pos:pos + n]
            if len(raw) != n:
                raise AvroError("truncated fixed")
            if s.get("logicalType") == "decimal":
                return _decimal_from_bytes(raw, s), pos + n
            return raw, pos + n
        if t == "enum":
            i, pos = _zigzag_decode(buf, pos)
            try:
                return s["symbols"][i], pos
            except IndexError:
                raise AvroError(f"enum index {i} out of range")
        if t == "union":
            i, pos = _zigzag_decode(buf, pos)
            if not 0 <= i < len(s):
                raise AvroError(f"union branch {i} out of range")
            return self._dec(s[i], buf, pos)
        if t == "record":
            out = {}
            for f in s["fields"]:
                out[f["name"]], pos = self._dec(f["type"], buf, pos)
            return out, pos
        if t == "array":
            out_l: List[Any] = []
            while True:
                cnt, pos = _zigzag_decode(buf, pos)
                if cnt == 0:
                    return out_l, pos
                if cnt < 0:
                    cnt = -cnt
                    _size, pos = _zigzag_decode(buf, pos)
                for _ in range(cnt):
                    v, pos = self._dec(s["items"], buf, pos)
                    out_l.append(v)
        if t == "map":
            out_m: Dict[str, Any] = {}
            while True:
                cnt, pos = _zigzag_decode(buf, pos)
                if cnt == 0:
                    return out_m, pos
                if cnt < 0:
                    cnt = -cnt
                    _size, pos = _zigzag_decode(buf, pos)
                for _ in range(cnt):
                    k, pos = self._dec("string", buf, pos)
                    out_m[k], pos = self._dec(s["values"], buf, pos)
        raise AvroError(f"unsupported schema type {t!r}")

    # -- encode -----------------------------------------------------------
    def encode(self, value: Any) -> bytes:
        out = bytearray()
        self._enc(self.schema, value, out)
        return bytes(out)

    def _enc(self, s: Any, v: Any, out: bytearray) -> None:
        s = self._resolve(s)
        t = _type_name(s)
        if t == "null":
            return
        if t == "boolean":
            out.append(1 if v else 0)
        elif t == "int":
            # encoder-level int32 bound (not just union matching): an
            # out-of-range value must raise, never emit an invalid varint
            if not -(1 << 31) <= int(v) < (1 << 31):
                raise AvroError(f"value {v!r} out of int32 range")
            out += _zigzag_encode(int(v))
        elif t == "long":
            out += _zigzag_encode(int(v))
        elif t == "float":
            out += struct.pack("<f", float(v))
        elif t == "double":
            out += struct.pack("<d", float(v))
        elif t == "string":
            b = str(v).encode()
            out += _zigzag_encode(len(b)) + b
        elif t == "bytes":
            if _is_decimal_schema(s) and not isinstance(v, (bytes,
                                                            bytearray)):
                v = _decimal_to_bytes(v, s)    # round-trippable decimals
            out += _zigzag_encode(len(v)) + bytes(v)
        elif t == "fixed":
            if _is_decimal_schema(s) and not isinstance(v, (bytes,
                                                            bytearray)):
                v = _decimal_to_bytes(v, s)
            if len(v) != s["size"]:
                raise AvroError("fixed size mismatch")
            out += bytes(v)
        elif t == "enum":
            out += _zigzag_encode(s["symbols"].index(v))
        elif t == "union":
            for i, branch in enumerate(s):
                if self._matches(branch, v):
                    out += _zigzag_encode(i)
                    self._enc(branch, v, out)
                    return
            raise AvroError(f"no union branch for {v!r}")
        elif t == "record":
            for f in s["fields"]:
                self._enc(f["type"], v[f["name"]], out)
        elif t == "array":
            if v:
                out += _zigzag_encode(len(v))
                for item in v:
                    self._enc(s["items"], item, out)
            out += _zigzag_encode(0)
        elif t == "map":
            if v:
                out += _zigzag_encode(len(v))
                for k, mv in v.items():
                    self._enc("string", k, out)
                    self._enc(s["values"], mv, out)
            out += _zigzag_encode(0)
        else:
            raise AvroError(f"unsupported schema type {t!r}")

    def _matches(self, s: Any, v: Any) -> bool:
        t = _type_name(self._resolve(s))
        if t == "null":
            return v is None
        if v is None:
            return False
        if t == "boolean":
            return isinstance(v, bool)
        if t == "int":
            # int32-bounded: a 2^40 value must NOT be written into an
            # int branch (conformant readers would overflow/reject)
            return isinstance(v, int) and not isinstance(v, bool) \
                and -(1 << 31) <= v < (1 << 31)
        if t == "long":
            return isinstance(v, int) and not isinstance(v, bool)
        if t in ("float", "double"):
            # int promotes to float/double (every standard Avro writer
            # accepts it; earlier int/long branches win on order)
            return isinstance(v, (int, float)) and not isinstance(v, bool)
        if t == "string":
            return isinstance(v, str)
        if t in ("bytes", "fixed"):
            if _is_decimal_schema(self._resolve(s)):
                import decimal
                return isinstance(v, (bytes, bytearray, decimal.Decimal))
            return isinstance(v, (bytes, bytearray))
        if t == "record":
            return isinstance(v, dict)
        if t == "array":
            return isinstance(v, list)
        if t == "map":
            return isinstance(v, dict)
        if t == "enum":
            return isinstance(v, str)
        return False


# ---------------------------------------------------------------------------
# object container files
# ---------------------------------------------------------------------------

_MAGIC = b"Obj\x01"
_META_SCHEMA = {"type": "map", "values": "bytes"}


def read_container(path: str) -> List[Dict[str, Any]]:
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != _MAGIC:
        raise AvroError(f"{path!r} is not an Avro container file")
    meta_codec = AvroCodec(_META_SCHEMA)
    meta, pos = meta_codec.decode(data, 4)   # str keys, bytes values
    raw_schema = meta["avro.schema"]
    schema = json.loads(raw_schema.decode()
                        if isinstance(raw_schema, bytes) else raw_schema)
    codec_name = meta.get("avro.codec", b"null")
    if isinstance(codec_name, bytes):
        codec_name = codec_name.decode()
    if codec_name not in ("null", "deflate"):
        raise AvroError(f"unsupported container codec {codec_name!r}")
    sync = data[pos:pos + 16]
    pos += 16
    codec = AvroCodec(schema)
    rows: List[Dict[str, Any]] = []
    while pos < len(data):
        count, pos = _zigzag_decode(data, pos)
        size, pos = _zigzag_decode(data, pos)
        block = data[pos:pos + size]
        pos += size
        if data[pos:pos + 16] != sync:
            raise AvroError("container sync marker mismatch")
        pos += 16
        if codec_name == "deflate":
            block = zlib.decompress(block, -15)
        bp = 0
        for _ in range(count):
            row, bp = codec.decode(block, bp)
            rows.append(row)
    return rows


def write_container(path: str, schema: Any,
                    rows: List[Dict[str, Any]],
                    codec_name: str = "null") -> None:
    codec = AvroCodec(schema)
    meta_codec = AvroCodec(_META_SCHEMA)
    sync = b"\x13" * 16
    body = b"".join(codec.encode(r) for r in rows)
    if codec_name == "deflate":
        c = zlib.compressobj(9, zlib.DEFLATED, -15)
        body = c.compress(body) + c.flush()
    with open(path, "wb") as fh:
        fh.write(_MAGIC)
        fh.write(meta_codec.encode({
            "avro.schema": json.dumps(
                schema if not isinstance(schema, str) else
                json.loads(schema)).encode(),
            "avro.codec": codec_name.encode()}))
        fh.write(sync)
        fh.write(_zigzag_encode(len(rows)) + _zigzag_encode(len(body)))
        fh.write(body)
        fh.write(sync)


# ---------------------------------------------------------------------------
# Confluent schema-registry wire format
# ---------------------------------------------------------------------------

class ConfluentAvroDecoder:
    """KafkaConfluentSchemaRegistryAvroMessageDecoder.java:53 analog:
    decode `0x00 | schema_id:i32be | avro binary` messages, fetching and
    caching writer schemas from the registry REST API. Callable, so it
    plugs straight into stream consumers as the value decoder."""

    def __init__(self, registry_url: str, timeout: float = 10.0):
        self.registry_url = registry_url.rstrip("/")
        self.timeout = timeout
        self._codecs: Dict[int, AvroCodec] = {}
        self._lock = threading.Lock()

    def _codec(self, schema_id: int) -> AvroCodec:
        with self._lock:
            codec = self._codecs.get(schema_id)
        if codec is not None:
            return codec
        with urllib.request.urlopen(
                f"{self.registry_url}/schemas/ids/{schema_id}",
                timeout=self.timeout) as resp:
            payload = json.loads(resp.read())
        codec = AvroCodec(payload["schema"])
        with self._lock:
            self._codecs[schema_id] = codec
        return codec

    def __call__(self, message: bytes) -> Dict[str, Any]:
        if not message or message[0] != 0:
            raise AvroError(
                "not a Confluent-framed message (magic byte != 0)")
        if len(message) < 5:
            raise AvroError("truncated Confluent frame header")
        (schema_id,) = struct.unpack(">i", message[1:5])
        value, _pos = self._codec(schema_id).decode(message, 5)
        return value


def confluent_encode(schema_id: int, codec: AvroCodec,
                     value: Dict[str, Any]) -> bytes:
    return b"\x00" + struct.pack(">i", schema_id) + codec.encode(value)


class SchemaRegistryStub:
    """In-process schema registry speaking the two endpoints the decoder
    and producers need: POST /subjects/{s}/versions (register, returns
    {'id': n}) and GET /schemas/ids/{n} (returns {'schema': json})."""

    def __init__(self, port: int = 0):
        import http.server

        stub = self
        self.schemas: Dict[int, str] = {}
        self._next = 0
        self._lock = threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, status: int, obj: Any) -> None:
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type",
                                 "application/vnd.schemaregistry.v1+json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                parts = self.path.strip("/").split("/")
                if len(parts) == 3 and parts[:2] == ["schemas", "ids"]:
                    sid = int(parts[2])
                    schema = stub.schemas.get(sid)
                    if schema is None:
                        return self._send(404, {
                            "error_code": 40403,
                            "message": "Schema not found"})
                    return self._send(200, {"schema": schema})
                self._send(404, {"error_code": 404, "message": "nope"})

            def do_POST(self) -> None:
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n)) if n else {}
                parts = self.path.strip("/").split("/")
                if len(parts) == 3 and parts[0] == "subjects" \
                        and parts[2] == "versions":
                    sid = stub.register(body["schema"])
                    return self._send(200, {"id": sid})
                self._send(404, {"error_code": 404, "message": "nope"})

        import http.server as hs
        self._server = hs.ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def register(self, schema: str) -> int:
        with self._lock:
            for sid, s in self.schemas.items():
                if s == schema:
                    return sid
            self._next += 1
            self.schemas[self._next] = schema
            return self._next

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
