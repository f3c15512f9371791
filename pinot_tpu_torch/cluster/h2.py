"""Cleartext HTTP/2 with HPACK, and gRPC's framing over it, on the
standard library: the transport of the gRPC data plane (grpc_plane.py).

- Frames (RFC 9113 §4, §6): the connection preface, DATA, HEADERS,
  CONTINUATION, SETTINGS (acknowledged; unknown settings ignored),
  WINDOW_UPDATE, PING (acknowledged at once), RST_STREAM and GOAWAY.
  Padding and PRIORITY fields are accepted on read; PRIORITY frames are
  ignored. DATA is split at the peer's MAX_FRAME_SIZE.
- HPACK (RFC 7541): the static table, the dynamic table with eviction
  and size updates, prefix integers, string literals with Huffman
  decoding (the canonical code of Appendix B, built from its 257 code
  lengths). The encoder sends every field as a literal without indexing
  and without Huffman coding, which any decoder accepts.
- Flow control (RFC 9113 §5.2), both ways, at connection and stream
  level. A writer waits while the peer's window is exhausted; one reader
  thread per connection handles WINDOW_UPDATE, SETTINGS and PING while
  writers wait; every frame goes to the socket under one write lock. A
  reader credits the window as it takes bytes out of a stream, so a
  message larger than the window still arrives.
- gRPC ("gRPC over HTTP2", the gRPC project's protocol document):
  requests are POSTs to ``/<service>/<method>`` with ``content-type:
  application/grpc``, ``te: trailers`` and ``grpc-timeout``; each
  message has a 1-byte compressed flag (identity only) and a 4-byte
  big-endian length; a response is HEADERS, DATA, then trailers with
  ``grpc-status`` and a percent-encoded ``grpc-message``, or one
  trailers-only HEADERS for an error before any message.

``Server`` runs handlers on a pool of worker threads (8, as the
reference's ``grpc.server(ThreadPoolExecutor(max_workers=8))``);
``Channel`` is one client connection. Both give what a ``grpcio`` peer
gives for an unknown method (UNIMPLEMENTED), a handler exception
(UNKNOWN), a message over the 4 MiB receive limit (RESOURCE_EXHAUSTED,
on either side) and a client timeout (DEADLINE_EXCEEDED, the stream
cancelled with RST_STREAM CANCEL). The client raises ``RpcError``,
which carries the status name and details. No TLS, compression,
keepalive or reflection: the reference's plane uses none of them.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
import urllib.parse
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    NamedTuple, Optional, Tuple)

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types (RFC 9113 §6)
(DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING,
 GOAWAY, WINDOW_UPDATE, CONTINUATION) = range(10)
# flags
END_STREAM = ACK = 0x1
END_HEADERS = 0x4
PADDED = 0x8
PRIORITY_FLAG = 0x20
# settings (RFC 9113 §6.5.2)
(HEADER_TABLE_SIZE, ENABLE_PUSH, MAX_CONCURRENT_STREAMS,
 INITIAL_WINDOW_SIZE, MAX_FRAME_SIZE, MAX_HEADER_LIST_SIZE) = range(1, 7)
# error codes (RFC 9113 §7)
NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR = 0, 1, 2, 3
FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL, COMPRESSION_ERROR = 6, 7, 8, 9

DEFAULT_WINDOW = 65535          # RFC 9113 defaults
DEFAULT_FRAME = 16384
MAX_WINDOW = (1 << 31) - 1
GRPC_WINDOW = 4 << 20           # what this transport advertises unless told
GRPC_FRAME = 4 << 20
MAX_MESSAGE = 4 << 20           # gRPC's default receive limit, both sides

STATUS = ("OK", "CANCELLED", "UNKNOWN", "INVALID_ARGUMENT",
          "DEADLINE_EXCEEDED", "NOT_FOUND", "ALREADY_EXISTS",
          "PERMISSION_DENIED", "RESOURCE_EXHAUSTED", "FAILED_PRECONDITION",
          "ABORTED", "OUT_OF_RANGE", "UNIMPLEMENTED", "INTERNAL",
          "UNAVAILABLE", "DATA_LOSS", "UNAUTHENTICATED")
STATUS_CODE = {name: i for i, name in enumerate(STATUS)}


class H2Error(Exception):
    """A connection error: the connection is closed with GOAWAY(code)."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class HpackError(H2Error):
    def __init__(self, message: str):
        super().__init__(COMPRESSION_ERROR, message)


class RpcError(Exception):
    """A call that ended with a status other than OK: ``code`` is the
    status name (``"UNIMPLEMENTED"``, ...), ``details`` its message."""

    def __init__(self, code: str, details: str):
        super().__init__(f"{code}: {details}")
        self.code = code
        self.details = details


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def pack_frame(ftype: int, flags: int, stream_id: int,
               payload: bytes = b"") -> bytes:
    n = len(payload)
    return struct.pack(">BHBBI", n >> 16, n & 0xFFFF, ftype, flags,
                       stream_id & 0x7FFFFFFF) + bytes(payload)


def unpack_header(head: bytes) -> Tuple[int, int, int, int]:
    """-> (length, type, flags, stream id) of a 9-byte frame header."""
    hi, lo, ftype, flags, sid = struct.unpack(">BHBBI", head)
    return hi << 16 | lo, ftype, flags, sid & 0x7FFFFFFF


def strip_padding(flags: int, payload: bytes) -> bytes:
    """The payload of a DATA or HEADERS frame without its padding."""
    if not flags & PADDED:
        return payload
    if not payload or payload[0] >= len(payload):
        raise H2Error(PROTOCOL_ERROR, "padding exceeds the frame")
    return payload[1:len(payload) - payload[0]]


def header_fragment(flags: int, payload: bytes) -> bytes:
    """A HEADERS frame's block fragment: padding and the PRIORITY
    fields (exclusive bit, dependency, weight) dropped."""
    frag = strip_padding(flags, payload)
    if flags & PRIORITY_FLAG:
        if len(frag) < 5:
            raise H2Error(FRAME_SIZE_ERROR, "short PRIORITY fields")
        frag = frag[5:]
    return frag


def pack_settings(settings: Dict[int, int]) -> bytes:
    return b"".join(struct.pack(">HI", k, v) for k, v in settings.items())


# ---------------------------------------------------------------------------
# HPACK (RFC 7541)
# ---------------------------------------------------------------------------

STATIC_TABLE: Tuple[Tuple[bytes, bytes], ...] = tuple(
    (n.encode(), v.encode()) for n, v in (
        (":authority", ""), (":method", "GET"), (":method", "POST"),
        (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
        (":scheme", "https"), (":status", "200"), (":status", "204"),
        (":status", "206"), (":status", "304"), (":status", "400"),
        (":status", "404"), (":status", "500"), ("accept-charset", ""),
        ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
        ("accept-ranges", ""), ("accept", ""),
        ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
        ("authorization", ""), ("cache-control", ""),
        ("content-disposition", ""), ("content-encoding", ""),
        ("content-language", ""), ("content-length", ""),
        ("content-location", ""), ("content-range", ""),
        ("content-type", ""), ("cookie", ""), ("date", ""), ("etag", ""),
        ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
        ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""),
        ("if-range", ""), ("if-unmodified-since", ""),
        ("last-modified", ""), ("link", ""), ("location", ""),
        ("max-forwards", ""), ("proxy-authenticate", ""),
        ("proxy-authorization", ""), ("range", ""), ("referer", ""),
        ("refresh", ""), ("retry-after", ""), ("server", ""),
        ("set-cookie", ""), ("strict-transport-security", ""),
        ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
        ("via", ""), ("www-authenticate", "")))

# Appendix B's code length of each symbol 0..255 and EOS (256); the code
# is canonical: codes are assigned in order of length, then of symbol
_HUFFMAN_LENGTHS = (
    [13, 23] + [28] * 7 + [24, 30, 28, 28, 30] + [28] * 8 + [30] + [28] * 9
    # 32 ' ' .. 63 '?'
    + [6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,
       5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10]
    # 64 '@' .. 95 '_'
    + [13, 6] + [7] * 22 + [8, 7, 8, 13, 19, 13, 14, 6]
    # 96 '`' .. 127
    + [15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,
       6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28]
    # 128 .. 255
    + [20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
       24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,
       22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,
       21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,
       26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,
       19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,
       20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,
       26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26]
    + [30])                                               # EOS
EOS = 256


def _canonical(lengths) -> List[Tuple[int, int]]:
    """(code, length) of each symbol of a canonical prefix code."""
    codes: List[Tuple[int, int]] = [(0, 0)] * len(lengths)
    code, prev = 0, 0
    for length, sym in sorted((n, s) for s, n in enumerate(lengths)):
        code <<= length - prev
        codes[sym] = (code, length)
        code += 1
        prev = length
    return codes


HUFFMAN_CODES = _canonical(_HUFFMAN_LENGTHS)
# length -> (first code of that length, index of its first symbol)
_BY_LENGTH: Dict[int, Tuple[int, int, int]] = {}
_SYMBOLS = [s for _n, s in sorted((n, s) for s, n in
                                  enumerate(_HUFFMAN_LENGTHS))]
for _i, _s in enumerate(_SYMBOLS):
    _c, _n = HUFFMAN_CODES[_s]
    _first, _start, _count = _BY_LENGTH.get(_n, (_c, _i, 0))
    _BY_LENGTH[_n] = (_first, _start, _count + 1)
del _i, _s, _c, _n, _first, _start, _count


def huffman_encode(data: bytes) -> bytes:
    acc = nbits = 0
    for b in data:
        code, length = HUFFMAN_CODES[b]
        acc = acc << length | code
        nbits += length
    pad = -nbits % 8               # padded with the EOS code's leading 1s
    acc = acc << pad | ((1 << pad) - 1)
    return acc.to_bytes((nbits + pad) // 8, "big")


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    code = length = 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = code << 1 | (byte >> shift) & 1
            length += 1
            entry = _BY_LENGTH.get(length)
            if entry is None or not 0 <= code - entry[0] < entry[2]:
                if length > 30:
                    raise HpackError("invalid Huffman code")
                continue
            sym = _SYMBOLS[entry[1] + code - entry[0]]
            if sym == EOS:
                raise HpackError("EOS symbol in a Huffman string")
            out.append(sym)
            code = length = 0
    # at most 7 bits of padding, all ones (the EOS code's prefix)
    if length > 7 or code != (1 << length) - 1:
        raise HpackError("invalid Huffman padding")
    return bytes(out)


def encode_int(value: int, prefix: int, first: int = 0) -> bytes:
    """RFC 7541 §5.1: ``value`` in an N-bit prefix; ``first`` holds the
    octet's high bits."""
    limit = (1 << prefix) - 1
    if value < limit:
        return bytes([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 0x80:
        out.append(value & 0x7F | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data: bytes, pos: int, prefix: int) -> Tuple[int, int]:
    """-> (value, position after it)."""
    if pos >= len(data):
        raise HpackError("truncated integer")
    limit = (1 << prefix) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 56:
            raise HpackError("integer overflow")


def encode_str(s: bytes) -> bytes:
    """A string literal without Huffman coding (§5.2, H = 0)."""
    return encode_int(len(s), 7) + s


def decode_str(data: bytes, pos: int) -> Tuple[bytes, int]:
    huffman = pos < len(data) and data[pos] & 0x80
    n, pos = decode_int(data, pos, 7)
    if pos + n > len(data):
        raise HpackError("truncated string")
    raw = bytes(data[pos:pos + n])
    return (huffman_decode(raw) if huffman else raw), pos + n


def encode_headers(headers: Iterable[Tuple[str, str]]) -> bytes:
    """Literals without indexing with a new name (§6.2.2), no Huffman."""
    out = bytearray()
    for name, value in headers:
        out += b"\x00" + encode_str(name.encode("latin-1")) \
            + encode_str(value.encode("latin-1"))
    return bytes(out)


class HpackDecoder:
    """One connection's decoding context: the dynamic table (newest
    first) bounded by ``max_size``, which a size update may lower to any
    size up to ``limit`` (the SETTINGS_HEADER_TABLE_SIZE advertised)."""

    def __init__(self, limit: int = 4096):
        self.limit = limit
        self.max_size = limit
        self.table: deque = deque()
        self.size = 0

    def _evict(self) -> None:
        while self.size > self.max_size:
            name, value = self.table.pop()
            self.size -= len(name) + len(value) + 32

    def _add(self, name: bytes, value: bytes) -> None:
        self.table.appendleft((name, value))
        self.size += len(name) + len(value) + 32
        self._evict()

    def _entry(self, index: int) -> Tuple[bytes, bytes]:
        if 1 <= index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        k = index - len(STATIC_TABLE) - 1
        if index == 0 or k >= len(self.table):
            raise HpackError(f"header index {index} out of range")
        return self.table[k]

    def decode(self, block: bytes) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(block):
            b = block[pos]
            if b & 0x80:                               # indexed field
                index, pos = decode_int(block, pos, 7)
                name, value = self._entry(index)
            elif b & 0xE0 == 0x20:                     # table size update
                size, pos = decode_int(block, pos, 5)
                if size > self.limit:
                    raise HpackError(f"table size {size} over {self.limit}")
                self.max_size = size
                self._evict()
                continue
            else:
                # literal: with incremental indexing (01), never indexed
                # (0001) or without indexing (0000)
                indexing = b & 0xC0 == 0x40
                index, pos = decode_int(block, pos, 6 if indexing else 4)
                if index:
                    name = self._entry(index)[0]
                else:
                    name, pos = decode_str(block, pos)
                value, pos = decode_str(block, pos)
                if indexing:
                    self._add(name, value)
            out.append((name.decode("latin-1"), value.decode("latin-1")))
        return out


# ---------------------------------------------------------------------------
# connections and streams
# ---------------------------------------------------------------------------

class _Gone(Exception):
    """The stream was reset, closed by the peer, or its connection lost."""


class _Stream:
    def __init__(self, sid: int, send_window: int):
        self.id = sid
        self.send_window = send_window
        self.inbox = bytearray()       # DATA received, not yet taken
        self.headers: Optional[List[Tuple[str, str]]] = None
        self.trailers: Optional[List[Tuple[str, str]]] = None
        self.remote_closed = False     # END_STREAM received
        self.reset: Optional[int] = None   # RST_STREAM code, or -1: lost
        self.pending = 0               # bytes taken, not yet credited


class Connection:
    """One HTTP/2 connection over a connected socket. ``window`` and
    ``max_frame`` are what this end advertises (its receive window per
    stream and for the connection, and the largest frame it reads).
    A server connection calls ``on_stream(conn, stream)`` on its reader
    thread when a client opens a stream."""

    def __init__(self, sock: socket.socket, client: bool,
                 window: int = GRPC_WINDOW, max_frame: int = GRPC_FRAME,
                 on_stream: Optional[Callable[["Connection", _Stream],
                                              None]] = None,
                 on_close: Optional[Callable[["Connection"], None]] = None):
        if not DEFAULT_FRAME <= max_frame <= (1 << 24) - 1 or \
                not 0 < window <= MAX_WINDOW:
            raise ValueError(f"window {window}, frame {max_frame}")
        self.sock = sock
        self.client = client
        self.window = window
        self.max_frame = max_frame
        self.on_stream = on_stream
        self.on_close = on_close
        self.cond = threading.Condition()
        self.wlock = threading.Lock()
        self.streams: Dict[int, _Stream] = {}
        self.peer_window = DEFAULT_WINDOW   # the peer's INITIAL_WINDOW_SIZE
        self.peer_frame = DEFAULT_FRAME
        self.send_window = DEFAULT_WINDOW   # the connection's, to the peer
        self.conn_pending = 0               # bytes taken, not yet credited
        self.decoder = HpackDecoder()
        self.next_id = 1
        self.last_peer_stream = 0
        self.lost: Optional[str] = None     # why the connection ended
        self._rfile = sock.makefile("rb")
        self.thread = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"h2-{'client' if client else 'server'}-reader")

    def start(self) -> "Connection":
        settings = {INITIAL_WINDOW_SIZE: self.window,
                    MAX_FRAME_SIZE: self.max_frame}
        if self.client:
            settings = {ENABLE_PUSH: 0, **settings}
        out = (PREFACE if self.client else b"") + pack_frame(
            SETTINGS, 0, 0, pack_settings(settings))
        if self.window > DEFAULT_WINDOW:
            out += pack_frame(WINDOW_UPDATE, 0, 0, struct.pack(
                ">I", self.window - DEFAULT_WINDOW))
        with self.wlock:                 # the preface goes out first
            self.sock.sendall(out)
        self.thread.start()
        return self

    # -- writing ------------------------------------------------------------
    def send_frame(self, ftype: int, flags: int, sid: int,
                   payload: bytes = b"") -> None:
        n = len(payload)
        head = struct.pack(">BHBBI", n >> 16, n & 0xFFFF, ftype, flags, sid)
        with self.wlock:
            if len(payload) <= 65536:
                self.sock.sendall(head + bytes(payload))
            else:
                self.sock.sendall(head)
                self.sock.sendall(payload)

    def _header_frames(self, sid: int, headers, end_stream: bool) -> bytes:
        block = encode_headers(headers)
        step = self.peer_frame
        parts = [block[i:i + step] for i in range(0, len(block), step)] \
            or [b""]
        out = bytearray()
        for k, part in enumerate(parts):
            flags = END_HEADERS if k == len(parts) - 1 else 0
            if k == 0:
                out += pack_frame(HEADERS, flags | (END_STREAM if end_stream
                                                    else 0), sid, part)
            else:
                out += pack_frame(CONTINUATION, flags, sid, part)
        return bytes(out)

    def send_headers(self, st: _Stream, headers, end_stream: bool = False
                     ) -> None:
        frames = self._header_frames(st.id, headers, end_stream)
        with self.wlock:
            self.sock.sendall(frames)

    def open_stream(self, headers) -> _Stream:
        """A new client stream; its HEADERS go out under the write lock
        with the id, so ids reach the peer in increasing order."""
        with self.wlock:
            with self.cond:
                if self.lost:
                    raise _Gone(self.lost)
                sid = self.next_id
                self.next_id += 2
                st = _Stream(sid, self.peer_window)
                self.streams[sid] = st
            self.sock.sendall(self._header_frames(sid, headers, False))
        return st

    def _stopped(self, st: _Stream) -> bool:
        # a client stops sending once the server has ended the stream
        return st.reset is not None or (self.client and st.remote_closed)

    def send_data(self, st: _Stream, data: bytes, end_stream: bool,
                  deadline: Optional[float] = None) -> None:
        """``data`` as DATA frames, each within the peer's frame size and
        both windows; waits for WINDOW_UPDATEs. Raises ``_Gone`` when the
        stream ends under it and TimeoutError past ``deadline``."""
        view = memoryview(data)
        off = 0
        while True:
            with self.cond:
                while True:
                    if self._stopped(st) or self.lost:
                        raise _Gone(self.lost or f"stream {st.id} ended")
                    n = min(len(view) - off, st.send_window,
                            self.send_window, self.peer_frame)
                    if n > 0 or off == len(view):
                        break
                    if not self.cond.wait(_remaining(deadline)):
                        if _expired(deadline):
                            raise TimeoutError
                n = max(n, 0)
                st.send_window -= n
                self.send_window -= n
            last = off + n == len(view)
            self.send_frame(DATA, END_STREAM if last and end_stream else 0,
                            st.id, view[off:off + n])
            off += n
            if last:
                return

    def send_message(self, st: _Stream, msg: bytes,
                     deadline: Optional[float] = None) -> None:
        self.send_data(st, struct.pack(">BI", 0, len(msg)) + msg, False,
                       deadline)

    def reset_stream(self, st: _Stream, code: int) -> None:
        with self.cond:
            if st.reset is None:
                st.reset = code
        try:
            self.send_frame(RST_STREAM, 0, st.id, struct.pack(">I", code))
        except OSError:
            pass

    def release(self, st: _Stream) -> None:
        """Forget a finished stream; DATA that still arrives for it is
        credited to the connection at once."""
        with self.cond:
            self.streams.pop(st.id, None)
            due = self._due(len(st.inbox))
            st.inbox.clear()
        self._window_update([(0, due)] if due else [])

    # -- reading --------------------------------------------------------------
    def _due(self, n: int) -> int:
        """Under ``cond``: n more bytes of the connection's window were
        consumed; the WINDOW_UPDATE now due (none below half the window)."""
        self.conn_pending += n
        if self.conn_pending < self.window // 2:
            return 0
        due, self.conn_pending = self.conn_pending, 0
        return due

    def _take(self, st: _Stream, n: int) -> List[Tuple[int, int]]:
        """Under ``cond``: n bytes left ``st``'s inbox; the credits due."""
        st.pending += n
        updates = []
        if st.pending >= self.window // 2 and not st.remote_closed:
            updates.append((st.id, st.pending))
            st.pending = 0
        due = self._due(n)
        if due:
            updates.append((0, due))
        return updates

    def _window_update(self, updates) -> None:
        if not updates:
            return
        try:
            with self.wlock:
                self.sock.sendall(b"".join(
                    pack_frame(WINDOW_UPDATE, 0, sid, struct.pack(">I", inc))
                    for sid, inc in updates))
        except OSError:
            pass

    def _wait_inbox(self, st: _Stream, n: int,
                    deadline: Optional[float]) -> bool:
        """Under ``cond``: wait until ``st`` holds n bytes; False when the
        stream ended first (END_STREAM), ``_Gone`` when it was reset."""
        while len(st.inbox) < n:
            if st.remote_closed:
                return False
            if st.reset is not None:
                raise _Gone(self.lost or f"stream reset ({st.reset})")
            if not self.cond.wait(_remaining(deadline)) and \
                    _expired(deadline):
                raise TimeoutError
        return True

    def recv_message(self, st: _Stream, limit: int,
                     deadline: Optional[float] = None) -> Optional[bytes]:
        """The next gRPC message of ``st``, or None at END_STREAM. Raises
        ``_TooLarge`` for a message over ``limit``, ``_Gone`` and
        TimeoutError as ``send_data`` does."""
        with self.cond:
            if not self._wait_inbox(st, 5, deadline):
                if st.inbox:
                    raise _Gone("stream ended inside a message prefix")
                return None
            flag, n = struct.unpack_from(">BI", st.inbox)
            if n > limit:
                raise _TooLarge(n, limit)
            if flag:
                raise _Gone("a compressed message without grpc-encoding")
            del st.inbox[:5]
            updates = self._take(st, 5)
        self._window_update(updates)
        msg = bytearray()
        while len(msg) < n:
            with self.cond:
                if not self._wait_inbox(st, 1, deadline):
                    raise _Gone("stream ended inside a message")
                k = min(len(st.inbox), n - len(msg))
                msg += st.inbox[:k]
                del st.inbox[:k]
                updates = self._take(st, k)
            self._window_update(updates)
        return bytes(msg)

    def _read_exact(self, n: int) -> Optional[bytes]:
        data = self._rfile.read(n) if n else b""
        return data if len(data) == n else None

    def _read_loop(self) -> None:
        reason = "connection closed"
        try:
            if not self.client and self._read_exact(len(PREFACE)) != PREFACE:
                raise H2Error(PROTOCOL_ERROR, "no connection preface")
            block: Optional[Tuple[int, int, bytearray]] = None
            while True:
                head = self._read_exact(9)
                if head is None:
                    break
                n, ftype, flags, sid = unpack_header(head)
                if n > self.max_frame:
                    raise H2Error(FRAME_SIZE_ERROR, f"frame of {n} bytes")
                payload = self._read_exact(n)
                if payload is None:
                    break
                if block is not None:
                    if ftype != CONTINUATION or sid != block[0]:
                        raise H2Error(PROTOCOL_ERROR, "expected CONTINUATION")
                    block[2].extend(payload)
                    if flags & END_HEADERS:
                        self._on_headers(block[0], block[1], bytes(block[2]))
                        block = None
                elif ftype == DATA:
                    self._on_data(sid, flags, payload)
                elif ftype == HEADERS:
                    frag = header_fragment(flags, payload)
                    if flags & END_HEADERS:
                        self._on_headers(sid, flags, frag)
                    else:
                        block = (sid, flags, bytearray(frag))
                elif ftype == CONTINUATION:
                    raise H2Error(PROTOCOL_ERROR, "CONTINUATION out of place")
                elif ftype == SETTINGS:
                    self._on_settings(flags, payload)
                elif ftype == WINDOW_UPDATE:
                    self._on_window_update(sid, payload)
                elif ftype == PING:
                    if not flags & ACK:
                        self.send_frame(PING, ACK, 0, payload)
                elif ftype == RST_STREAM:
                    (code,) = struct.unpack(">I", payload[:4])
                    with self.cond:
                        st = self.streams.get(sid)
                        if st is not None and st.reset is None:
                            st.reset = code
                        self.cond.notify_all()
                elif ftype == GOAWAY:
                    last, code = struct.unpack(">II", payload[:8])
                    self._on_goaway(last & 0x7FFFFFFF, code)
                elif ftype == PUSH_PROMISE:
                    raise H2Error(PROTOCOL_ERROR, "PUSH_PROMISE (push off)")
                # PRIORITY and unknown frame types are ignored
        except H2Error as e:
            reason = f"protocol error: {e}"
            try:
                self.send_frame(GOAWAY, 0, 0, struct.pack(
                    ">II", self.last_peer_stream, e.code))
            except OSError:
                pass
        except (OSError, ValueError, struct.error) as e:
            reason = f"connection lost: {e}"
        finally:
            self._lose(reason)

    def _on_data(self, sid: int, flags: int, payload: bytes) -> None:
        data = strip_padding(flags, payload)
        credit = len(payload) - len(data)      # padding, credited at once
        with self.cond:
            st = self.streams.get(sid)
            if st is None or st.reset is not None or st.remote_closed:
                credit = len(payload)
            else:
                st.inbox += data
                if flags & END_STREAM:
                    st.remote_closed = True
                self.cond.notify_all()
            due = self._due(credit)
        self._window_update([(0, due)] if due else [])

    def _on_headers(self, sid: int, flags: int, block: bytes) -> None:
        headers = self.decoder.decode(block)     # in order, every block
        new = None
        with self.cond:
            st = self.streams.get(sid)
            if st is None:
                if self.client or sid % 2 == 0 or \
                        sid <= self.last_peer_stream:
                    return                     # a stream already forgotten
                st = new = _Stream(sid, self.peer_window)
                self.streams[sid] = st
                self.last_peer_stream = sid
                st.headers = headers
            elif st.headers is None:
                st.headers = headers
            else:
                st.trailers = headers
            if flags & END_STREAM:
                st.remote_closed = True
            self.cond.notify_all()
        if new is not None and self.on_stream is not None:
            self.on_stream(self, new)

    def _on_settings(self, flags: int, payload: bytes) -> None:
        if flags & ACK:
            return
        if len(payload) % 6:
            raise H2Error(FRAME_SIZE_ERROR, "SETTINGS length")
        with self.cond:
            for i in range(0, len(payload), 6):
                ident, value = struct.unpack_from(">HI", payload, i)
                if ident == INITIAL_WINDOW_SIZE:
                    if value > MAX_WINDOW:
                        raise H2Error(FLOW_CONTROL_ERROR, "window too large")
                    delta = value - self.peer_window
                    self.peer_window = value
                    for st in self.streams.values():
                        st.send_window += delta
                elif ident == MAX_FRAME_SIZE:
                    if not DEFAULT_FRAME <= value <= (1 << 24) - 1:
                        raise H2Error(PROTOCOL_ERROR, "MAX_FRAME_SIZE")
                    self.peer_frame = value
                # HEADER_TABLE_SIZE: the encoder keeps no table; other
                # settings (and private ones such as 0xfe03) are ignored
            self.cond.notify_all()
        self.send_frame(SETTINGS, ACK, 0)

    def _on_window_update(self, sid: int, payload: bytes) -> None:
        (inc,) = struct.unpack(">I", payload[:4])
        inc &= 0x7FFFFFFF
        with self.cond:
            if sid == 0:
                self.send_window += inc
            elif sid in self.streams:
                self.streams[sid].send_window += inc
            self.cond.notify_all()

    def _on_goaway(self, last: int, code: int) -> None:
        with self.cond:
            for sid, st in self.streams.items():
                if sid > last and st.reset is None:
                    st.reset = REFUSED_STREAM
            self.cond.notify_all()

    def _lose(self, reason: str) -> None:
        with self.cond:
            self.lost = reason
            for st in self.streams.values():
                if st.reset is None and not st.remote_closed:
                    st.reset = -1
            self.cond.notify_all()
        for closer in (self._rfile.close, self.sock.close):
            try:
                closer()
            except OSError:
                pass
        if self.on_close is not None:
            self.on_close(self)

    def close(self) -> None:
        """GOAWAY, then the socket shut down; the reader thread ends."""
        try:
            self.send_frame(GOAWAY, 0, 0, struct.pack(
                ">II", self.last_peer_stream, NO_ERROR))
        except OSError:
            pass
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        if threading.current_thread() is not self.thread and \
                self.thread.ident is not None:
            self.thread.join(10.0)


class _TooLarge(Exception):
    def __init__(self, n: int, limit: int):
        super().__init__(f"Received message larger than max ({n} vs. "
                         f"{limit})")


def _remaining(deadline: Optional[float]) -> Optional[float]:
    return None if deadline is None else max(0.0,
                                             deadline - time.monotonic())


def _expired(deadline: Optional[float]) -> bool:
    return deadline is not None and time.monotonic() >= deadline


# ---------------------------------------------------------------------------
# gRPC
# ---------------------------------------------------------------------------

_TIMEOUT_UNITS = (("u", 10 ** 3), ("m", 10 ** 6), ("S", 10 ** 9),
                  ("M", 60 * 10 ** 9), ("H", 3600 * 10 ** 9))   # in ns


def encode_timeout(seconds: float) -> str:
    """``grpc-timeout``: at most 8 digits, in the finest unit that fits
    (rounded up)."""
    ns = max(0, round(seconds * 1e9))
    for unit, scale in _TIMEOUT_UNITS:
        v = -(-ns // scale)
        if v < 10 ** 8:
            return f"{v}{unit}"
    return "99999999H"


def decode_timeout(value: str) -> float:
    scale = dict(_TIMEOUT_UNITS, n=1)[value[-1]]
    return int(value[:-1]) * scale / 1e9


def encode_message(text: str) -> str:
    """grpc-message: UTF-8, every octet outside 0x20-0x7E and '%' as %XX."""
    return "".join(chr(c) if 0x20 <= c <= 0x7E and c != 0x25 else
                   f"%{c:02X}" for c in text.encode("utf-8"))


def decode_message(value: str) -> str:
    return urllib.parse.unquote(value, errors="replace")


def _status_of(st: _Stream) -> Tuple[str, str]:
    """(status name, details) from a stream's trailers, or from its
    headers for a trailers-only response."""
    fields = dict(st.trailers if st.trailers is not None else
                  st.headers or [])
    if "grpc-status" not in fields:
        return "UNKNOWN", "the stream ended without grpc-status"
    code = int(fields["grpc-status"])
    name = STATUS[code] if 0 <= code < len(STATUS) else "UNKNOWN"
    return name, decode_message(fields.get("grpc-message", ""))


class MethodHandler(NamedTuple):
    kind: str                          # "unary_stream" or "stream_unary"
    fn: Callable[..., Any]
    request_deserializer: Optional[Callable[[bytes], Any]]
    response_serializer: Optional[Callable[[Any], bytes]]


def unary_stream_handler(fn, request_deserializer=None,
                         response_serializer=None) -> MethodHandler:
    """``fn(request)`` yields the responses."""
    return MethodHandler("unary_stream", fn, request_deserializer,
                         response_serializer)


def stream_unary_handler(fn, request_deserializer=None,
                         response_serializer=None) -> MethodHandler:
    """``fn(request_iterator)`` returns the response."""
    return MethodHandler("stream_unary", fn, request_deserializer,
                         response_serializer)


class _Status(Exception):
    """Ends a call with this status (raised inside the server's call)."""

    def __init__(self, code: str, details: str):
        super().__init__(details)
        self.code = code
        self.details = details


class Server:
    """A gRPC server: ``lookup(method path)`` gives a ``MethodHandler``
    or None (UNIMPLEMENTED). Handlers run on 8 worker threads; each
    connection has its reader thread; ``stop`` ends them all."""

    def __init__(self, lookup: Callable[[str], Optional[MethodHandler]],
                 window: int = GRPC_WINDOW, max_frame: int = GRPC_FRAME):
        self._lookup = lookup
        self._window = window
        self._max_frame = max_frame
        self._pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix="h2-worker")
        self._lock = threading.Lock()
        self._conns: set = set()
        self._readers: List[threading.Thread] = []
        self._listener: Optional[socket.socket] = None
        self._accepter: Optional[threading.Thread] = None
        self._stopped = False

    def add_insecure_port(self, address: str) -> int:
        host, port = address.rsplit(":", 1)
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((host, int(port)))
            sock.listen(128)
        except OSError:
            sock.close()
            raise
        self._listener = sock
        return sock.getsockname()[1]

    def start(self) -> None:
        self._accepter = threading.Thread(target=self._accept_loop,
                                          daemon=True, name="h2-accept")
        self._accepter.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = Connection(sock, client=False, window=self._window,
                              max_frame=self._max_frame,
                              on_stream=self._on_stream,
                              on_close=self._on_close)
            with self._lock:
                if self._stopped:
                    sock.close()
                    return
                self._conns.add(conn)
                self._readers = [t for t in self._readers if t.is_alive()]
                self._readers.append(conn.thread)
            try:
                conn.start()
            except OSError:
                conn.close()

    def _on_close(self, conn: Connection) -> None:
        with self._lock:
            self._conns.discard(conn)

    def _on_stream(self, conn: Connection, st: _Stream) -> None:
        try:
            self._pool.submit(self._serve, conn, st)
        except RuntimeError:                     # the pool is shut down
            conn.reset_stream(st, REFUSED_STREAM)
            conn.release(st)

    def _serve(self, conn: Connection, st: _Stream) -> None:
        fields = dict(st.headers or [])
        method = fields.get(":path", "")
        try:
            deadline = time.monotonic() + decode_timeout(
                fields["grpc-timeout"])
        except (KeyError, ValueError, IndexError):
            deadline = None
        sent = [False]

        # the transport's own failures, told apart from the handler's
        def send(msg: bytes) -> None:
            try:
                if not sent[0]:
                    conn.send_headers(st, [
                        (":status", "200"),
                        ("content-type", "application/grpc")])
                    sent[0] = True
                conn.send_message(st, msg, deadline)
            except TimeoutError:
                raise _Status("DEADLINE_EXCEEDED", "Deadline Exceeded")
            except OSError as e:
                raise _Gone(str(e))

        def recv() -> Optional[bytes]:
            try:
                return conn.recv_message(st, MAX_MESSAGE, deadline)
            except _TooLarge as e:
                raise _Status("RESOURCE_EXHAUSTED", f"SERVER: {e}")
            except TimeoutError:
                raise _Status("DEADLINE_EXCEEDED", "Deadline Exceeded")

        try:
            handler = self._lookup(method)
            if handler is None:
                raise _Status("UNIMPLEMENTED", "Method not found!")
            load = handler.request_deserializer or (lambda b: b)
            dump = handler.response_serializer or (lambda b: b)
            if handler.kind == "unary_stream":
                request = recv()
                if request is None:
                    raise _Status("INTERNAL", "no request message")
                responses = handler.fn(load(request))
                try:
                    for resp in responses:
                        send(dump(resp))
                except (_Status, _Gone):
                    raise
                except Exception as e:
                    raise _Status("UNKNOWN",
                                  f"Exception iterating responses: {e}")
                finally:
                    close = getattr(responses, "close", None)
                    if close is not None:
                        close()
            else:
                def requests() -> Iterator[Any]:
                    while True:
                        msg = recv()
                        if msg is None:
                            return
                        yield load(msg)
                try:
                    resp = handler.fn(requests())
                except (_Status, _Gone):
                    raise
                except Exception as e:
                    raise _Status("UNKNOWN",
                                  f"Exception calling application: {e}")
                send(dump(resp))
            self._finish(conn, st, "OK", "", sent[0])
        except _Status as s:
            self._finish(conn, st, s.code, s.details, sent[0])
        except _Gone:
            pass                  # the client went away; nothing to answer
        finally:
            conn.release(st)

    def _finish(self, conn: Connection, st: _Stream, code: str,
                details: str, headers_sent: bool) -> None:
        fields = [] if headers_sent else [
            (":status", "200"), ("content-type", "application/grpc")]
        fields.append(("grpc-status", str(STATUS_CODE[code])))
        if details:
            fields.append(("grpc-message", encode_message(details)))
        try:
            conn.send_headers(st, fields, end_stream=True)
            if not st.remote_closed:
                # the client may still be sending: tell it to stop
                conn.reset_stream(st, NO_ERROR)
        except OSError:
            pass

    def stop(self, grace: Optional[float] = None) -> None:
        """Stop listening, close every connection (calls in progress end
        at once, or after ``grace`` seconds), and join every thread."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._listener.close()
        if self._accepter is not None:
            self._accepter.join(10.0)
        if grace:
            deadline = time.monotonic() + grace
            while time.monotonic() < deadline and any(
                    c.streams for c in list(self._conns)):
                time.sleep(0.01)
        with self._lock:
            conns = list(self._conns)
            readers = list(self._readers)
        for conn in conns:
            conn.close()
        self._pool.shutdown(wait=True)
        for t in readers:
            t.join(10.0)


# what a call's transport can raise; _fail turns each into an RpcError
_CALL_ERRORS = (RpcError, _Gone, _TooLarge, TimeoutError, OSError)


def _target_address(target: str) -> Tuple[str, int]:
    host, port = target.rsplit(":", 1)
    return host.strip("[]"), int(port)


class Channel:
    """One client connection to ``target`` (``host:port``), opened at
    the first call; ``close`` (or leaving a ``with`` block) ends it."""

    def __init__(self, target: str, window: int = GRPC_WINDOW,
                 max_frame: int = GRPC_FRAME):
        self.target = target
        self._window = window
        self._max_frame = max_frame
        self._conn: Optional[Connection] = None
        self._lock = threading.Lock()

    def __enter__(self) -> "Channel":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        with self._lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()

    def _connection(self) -> Connection:
        with self._lock:
            if self._conn is not None and not self._conn.lost:
                return self._conn
        # connect outside the lock; a racing caller's connection is kept
        try:
            sock = socket.create_connection(_target_address(self.target))
        except OSError as e:
            raise RpcError("UNAVAILABLE", f"failed to connect to "
                           f"{self.target}: {e}") from None
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = Connection(sock, client=True, window=self._window,
                          max_frame=self._max_frame)
        try:
            conn.start()
        except OSError as e:
            conn.close()
            raise RpcError("UNAVAILABLE", str(e)) from None
        with self._lock:
            if self._conn is None or self._conn.lost:
                self._conn, conn = conn, None
            kept = self._conn
        if conn is not None:
            conn.close()
        return kept

    def _open(self, method: str, timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        headers = [(":method", "POST"), (":scheme", "http"),
                   (":path", method), (":authority", self.target),
                   ("content-type", "application/grpc"), ("te", "trailers")]
        if timeout is not None:
            headers.append(("grpc-timeout", encode_timeout(timeout)))
        conn = self._connection()
        try:
            return conn, conn.open_stream(headers), deadline
        except (_Gone, OSError) as e:
            raise RpcError("UNAVAILABLE", str(e)) from None

    def _send(self, conn, st, requests, dump, deadline) -> None:
        """Every request, then END_STREAM; stops quietly when the server
        ends the stream first (its status is then read)."""
        try:
            for req in requests:
                conn.send_message(st, dump(req), deadline)
            conn.send_data(st, b"", True, deadline)
        except _Gone:
            if not st.remote_closed:
                raise

    def _fail(self, conn, st, e: BaseException) -> RpcError:
        """The RpcError for an exception in a call (the stream is reset
        where the client ends it)."""
        if isinstance(e, RpcError):
            return e
        if isinstance(e, TimeoutError):
            conn.reset_stream(st, CANCEL)
            return RpcError("DEADLINE_EXCEEDED", "Deadline Exceeded")
        if isinstance(e, _TooLarge):
            conn.reset_stream(st, CANCEL)
            return RpcError("RESOURCE_EXHAUSTED", f"CLIENT: {e}")
        if st.remote_closed:
            code, details = _status_of(st)
            if code != "OK":
                return RpcError(code, details)
        if st.reset is not None and st.reset >= 0:
            return RpcError("CANCELLED" if st.reset == CANCEL else
                            "INTERNAL", f"Received RST_STREAM with error "
                            f"code {st.reset}")
        return RpcError("UNAVAILABLE", str(e) or "connection lost")

    def _recv_all(self, conn, st, load, deadline) -> Iterator[Any]:
        while True:
            msg = conn.recv_message(st, MAX_MESSAGE, deadline)
            if msg is None:
                break
            yield load(msg)
        # the trailers follow END_STREAM's HEADERS at once
        code, details = _status_of(st)
        if code != "OK":
            raise RpcError(code, details)

    def unary_stream(self, method: str, request_serializer=None,
                     response_deserializer=None):
        """-> call(request, timeout=None): an iterator of the responses,
        each as it arrives. The request is sent when the call is made."""
        dump = request_serializer or (lambda b: b)
        load = response_deserializer or (lambda b: b)

        def call(request, timeout: Optional[float] = None) -> Iterator[Any]:
            conn, st, deadline = self._open(method, timeout)
            try:
                self._send(conn, st, [request], dump, deadline)
            except BaseException as e:
                conn.release(st)
                if isinstance(e, _CALL_ERRORS):
                    raise self._fail(conn, st, e) from None
                raise

            def responses() -> Iterator[Any]:
                done = False
                try:
                    yield from self._recv_all(conn, st, load, deadline)
                    done = True
                except _CALL_ERRORS as e:
                    done = True
                    raise self._fail(conn, st, e) from None
                finally:
                    if not done:                 # abandoned by the caller
                        conn.reset_stream(st, CANCEL)
                    conn.release(st)
            return responses()
        return call

    def stream_unary(self, method: str, request_serializer=None,
                     response_deserializer=None):
        """-> call(request_iterator, timeout=None): the one response."""
        dump = request_serializer or (lambda b: b)
        load = response_deserializer or (lambda b: b)

        def call(requests: Iterable[Any],
                 timeout: Optional[float] = None) -> Any:
            conn, st, deadline = self._open(method, timeout)
            try:
                self._send(conn, st, requests, dump, deadline)
                out = list(self._recv_all(conn, st, load, deadline))
                if len(out) != 1:
                    raise RpcError("INTERNAL", f"{len(out)} responses to "
                                   "a unary response call")
                return out[0]
            except _CALL_ERRORS as e:
                raise self._fail(conn, st, e) from None
            finally:
                conn.release(st)
        return call
