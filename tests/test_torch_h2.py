"""The port's HTTP/2 transport (``pinot_tpu_torch/cluster/h2.py``).

HPACK against RFC 7541's Appendix C examples (integers, fields, requests
with and without Huffman coding, responses with eviction at a 256-byte
table), the Huffman code over every octet and its refusals, the frame
codec, and a 1 MiB message each way between the port's own server and
client at the RFC's default window (65,535) and frame size (16,384).
"""
import socket
import struct
import threading

import pytest

from pinot_tpu_torch.cluster import h2


def _hex(s: str) -> bytes:
    return bytes.fromhex("".join(s.split()))


def split_frames(data: bytes):
    """Every whole frame in ``data`` as (type, flags, stream id, payload)."""
    out, i = [], 0
    while i + 9 <= len(data):
        n, ftype, flags, sid = h2.unpack_header(data[i:i + 9])
        if i + 9 + n > len(data):
            break
        out.append((ftype, flags, sid, bytes(data[i + 9:i + 9 + n])))
        i += 9 + n
    return out


# -- C.1: integers ------------------------------------------------------------

@pytest.mark.parametrize("value,prefix,wire", [
    (10, 5, "0a"),                 # C.1.1
    (1337, 5, "1f9a0a"),           # C.1.2
    (42, 8, "2a"),                 # C.1.3
])
def test_integer_representation(value, prefix, wire):
    assert h2.encode_int(value, prefix) == _hex(wire)
    assert h2.decode_int(_hex(wire), 0, prefix) == (value, len(_hex(wire)))


# -- C.2: header fields -------------------------------------------------------

@pytest.mark.parametrize("wire,field,table", [
    ("400a 6375 7374 6f6d 2d6b 6579 0d63 7573 746f 6d2d 6865 6164 6572",
     ("custom-key", "custom-header"), [("custom-key", "custom-header")]),
    ("040c 2f73 616d 706c 652f 7061 7468", (":path", "/sample/path"), []),
    ("1008 7061 7373 776f 7264 0673 6563 7265 74", ("password", "secret"),
     []),
    ("82", (":method", "GET"), []),
])
def test_header_field_representation(wire, field, table):
    dec = h2.HpackDecoder()
    assert dec.decode(_hex(wire)) == [field]
    assert [(n.decode(), v.decode()) for n, v in dec.table] == table
    assert dec.size == sum(len(n) + len(v) + 32 for n, v in table)


REQUESTS = [
    [(":method", "GET"), (":scheme", "http"), (":path", "/"),
     (":authority", "www.example.com")],
    [(":method", "GET"), (":scheme", "http"), (":path", "/"),
     (":authority", "www.example.com"), ("cache-control", "no-cache")],
    [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
     (":authority", "www.example.com"), ("custom-key", "custom-value")],
]
REQUEST_TABLES = [
    ([(":authority", "www.example.com")], 57),
    ([("cache-control", "no-cache"), (":authority", "www.example.com")],
     110),
    ([("custom-key", "custom-value"), ("cache-control", "no-cache"),
      (":authority", "www.example.com")], 164),
]
# C.3 (plain literals) and C.4 (Huffman-coded)
REQUEST_WIRES = {
    "C.3": ["8286 8441 0f77 7777 2e65 7861 6d70 6c65 2e63 6f6d",
            "8286 84be 5808 6e6f 2d63 6163 6865",
            "8287 85bf 400a 6375 7374 6f6d 2d6b 6579 0c63 7573 746f 6d2d "
            "7661 6c75 65"],
    "C.4": ["8286 8441 8cf1 e3c2 e5f2 3a6b a0ab 90f4 ff",
            "8286 84be 5886 a8eb 1064 9cbf",
            "8287 85bf 4088 25a8 49e9 5ba9 7d7f 8925 a849 e95b b8e8 b4bf"],
}


@pytest.mark.parametrize("section", ["C.3", "C.4"])
def test_request_examples(section):
    dec = h2.HpackDecoder()
    for wire, headers, (table, size) in zip(REQUEST_WIRES[section],
                                            REQUESTS, REQUEST_TABLES):
        assert dec.decode(_hex(wire)) == headers
        assert [(n.decode(), v.decode()) for n, v in dec.table] == table
        assert dec.size == size


DATE1 = "Mon, 21 Oct 2013 20:13:21 GMT"
DATE2 = "Mon, 21 Oct 2013 20:13:22 GMT"
COOKIE = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
LOC = "https://www.example.com"
RESPONSES = [
    [(":status", "302"), ("cache-control", "private"), ("date", DATE1),
     ("location", LOC)],
    [(":status", "307"), ("cache-control", "private"), ("date", DATE1),
     ("location", LOC)],
    [(":status", "200"), ("cache-control", "private"), ("date", DATE2),
     ("location", LOC), ("content-encoding", "gzip"),
     ("set-cookie", COOKIE)],
]
RESPONSE_TABLES = [
    ([("location", LOC), ("date", DATE1), ("cache-control", "private"),
      (":status", "302")], 222),
    ([(":status", "307"), ("location", LOC), ("date", DATE1),
      ("cache-control", "private")], 222),
    ([("set-cookie", COOKIE), ("content-encoding", "gzip"),
      ("date", DATE2)], 215),
]
# C.5 (plain literals) and C.6 (Huffman-coded), a 256-byte table
RESPONSE_WIRES = {
    "C.5": ["4803 3330 3258 0770 7269 7661 7465 611d 4d6f 6e2c 2032 3120 "
            "4f63 7420 3230 3133 2032 303a 3133 3a32 3120 474d 546e 1768 "
            "7474 7073 3a2f 2f77 7777 2e65 7861 6d70 6c65 2e63 6f6d",
            "4803 3330 37c1 c0bf",
            "88c1 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133 2032 303a "
            "3133 3a32 3220 474d 54c0 5a04 677a 6970 7738 666f 6f3d 4153 "
            "444a 4b48 514b 425a 584f 5157 454f 5049 5541 5851 5745 4f49 "
            "553b 206d 6178 2d61 6765 3d33 3630 303b 2076 6572 7369 6f6e "
            "3d31"],
    "C.6": ["4882 6402 5885 aec3 771a 4b61 96d0 7abe 9410 54d4 44a8 2005 "
            "9504 0b81 66e0 82a6 2d1b ff6e 919d 29ad 1718 63c7 8f0b 97c8 "
            "e9ae 82ae 43d3",
            "4883 640e ffc1 c0bf",
            "88c1 6196 d07a be94 1054 d444 a820 0595 040b 8166 e084 a62d "
            "1bff c05a 839b d9ab 77ad 94e7 821d d7f2 e6c7 b335 dfdf cd5b "
            "3960 d5af 2708 7f36 72c1 ab27 0fb5 291f 9587 3160 65c0 03ed "
            "4ee5 b106 3d50 07"],
}


@pytest.mark.parametrize("section", ["C.5", "C.6"])
def test_response_examples_with_eviction(section):
    dec = h2.HpackDecoder(limit=256)
    for wire, headers, (table, size) in zip(RESPONSE_WIRES[section],
                                            RESPONSES, RESPONSE_TABLES):
        assert dec.decode(_hex(wire)) == headers
        assert [(n.decode(), v.decode()) for n, v in dec.table] == table
        assert dec.size == size


def test_huffman_encoder_gives_the_appendix_strings():
    for plain, coded in [
            ("www.example.com", "f1e3 c2e5 f23a 6ba0 ab90 f4ff"),
            ("no-cache", "a8eb 1064 9cbf"),
            ("custom-key", "25a8 49e9 5ba9 7d7f"),
            ("custom-value", "25a8 49e9 5bb8 e8b4 bf"),
            ("302", "6402"), ("private", "aec3 771a 4b"),
            (DATE1, "d07a be94 1054 d444 a820 0595 040b 8166 e082 a62d "
                    "1bff"),
            (LOC, "9d29 ad17 1863 c78f 0b97 c8e9 ae82 ae43 d3")]:
        assert h2.huffman_encode(plain.encode()) == _hex(coded)


def test_huffman_round_trip_every_octet():
    data = bytes(range(256))
    assert h2.huffman_decode(h2.huffman_encode(data)) == data
    for b in range(256):
        one = bytes([b]) * 3
        assert h2.huffman_decode(h2.huffman_encode(one)) == one
    # the code is complete (Kraft's sum is exactly 1) and canonical
    assert sum(2.0 ** -n for _c, n in h2.HUFFMAN_CODES) == 1.0
    assert h2.HUFFMAN_CODES[h2.EOS] == (0x3FFFFFFF, 30)


@pytest.mark.parametrize("coded", [
    "f1e3 c2e5 f23a 6ba0 ab90 f4fe",   # padding not all ones
    "f1e3 c2e5 f23a 6ba0 ab90 f4ff ff", # 8 bits or more of padding
    "ffff fffc",                        # the EOS symbol itself
])
def test_huffman_refuses_bad_padding_and_eos(coded):
    with pytest.raises(h2.HpackError):
        h2.huffman_decode(_hex(coded))


def test_table_size_update_and_limit():
    dec = h2.HpackDecoder(limit=256)
    dec.decode(_hex(RESPONSE_WIRES["C.5"][0]))
    assert dec.size == 222
    dec.decode(h2.encode_int(64, 5, 0x20))        # shrink: one is left
    assert dec.size == 63 and len(dec.table) == 1
    dec.decode(h2.encode_int(0, 5, 0x20))         # all evicted
    assert dec.size == 0 and not dec.table
    with pytest.raises(h2.HpackError):
        dec.decode(h2.encode_int(257, 5, 0x20))   # over the advertised
    with pytest.raises(h2.HpackError):
        dec.decode(_hex("be"))                    # no such entry


def test_encoder_literals_decode_back():
    headers = [(":status", "200"), ("content-type", "application/grpc"),
               ("grpc-message", h2.encode_message("bad % thing\n é"))]
    dec = h2.HpackDecoder()
    assert dec.decode(h2.encode_headers(headers)) == headers
    assert not dec.table
    assert h2.decode_message(headers[2][1]) == "bad % thing\n é"


# -- frames -------------------------------------------------------------------

def test_frame_codec():
    f = h2.pack_frame(h2.DATA, h2.END_STREAM, 3, b"abc")
    assert f == _hex("000003 00 01 00000003") + b"abc"
    assert h2.unpack_header(f[:9]) == (3, h2.DATA, h2.END_STREAM, 3)
    big = h2.pack_frame(h2.DATA, 0, 0x7FFFFFFF, b"x" * 70000)
    assert h2.unpack_header(big[:9]) == (70000, h2.DATA, 0, 0x7FFFFFFF)
    frames = split_frames(f + big + f[:5])
    assert [(t, fl, s, len(p)) for t, fl, s, p in frames] == [
        (h2.DATA, 1, 3, 3), (h2.DATA, 0, 0x7FFFFFFF, 70000)]
    # padding and the PRIORITY fields are dropped on read
    padded = bytes([2]) + b"hello" + b"\0\0"
    assert h2.strip_padding(h2.PADDED, padded) == b"hello"
    with pytest.raises(h2.H2Error):
        h2.strip_padding(h2.PADDED, bytes([9]) + b"abc")
    prio = bytes([1]) + b"\x80\0\0\x01\x10" + b"blk" + b"\0"
    assert h2.header_fragment(h2.PADDED | h2.PRIORITY_FLAG, prio) == b"blk"
    s = h2.pack_settings({h2.INITIAL_WINDOW_SIZE: 65535, 0xFE03: 1})
    assert s == _hex("0004 0000ffff fe03 00000001")
    assert h2.encode_timeout(60.0) == "60000000u"
    assert h2.encode_timeout(1e9) == "16666667M"
    assert h2.decode_timeout("250m") == 0.25


def test_connection_answers_ping_settings_and_padded_frames():
    """A raw peer: SETTINGS with a private id, a PING, a padded HEADERS
    with PRIORITY fields split over a CONTINUATION; the server
    acknowledges both and answers UNIMPLEMENTED trailers-only."""
    server = h2.Server(lambda m: None, window=h2.DEFAULT_WINDOW,
                       max_frame=h2.DEFAULT_FRAME)
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    try:
        sock = socket.create_connection(("127.0.0.1", port))
        block = h2.encode_headers([
            (":method", "POST"), (":scheme", "http"),
            (":path", "/x.Y/Nope"), (":authority", "t"),
            ("content-type", "application/grpc"), ("te", "trailers")])
        first = bytes([1]) + b"\0\0\0\0\x10" + block[:7] + b"\0"
        sock.sendall(
            h2.PREFACE
            + h2.pack_frame(h2.SETTINGS, 0, 0, h2.pack_settings(
                {h2.ENABLE_PUSH: 0, 0xFE03: 1}))
            + h2.pack_frame(h2.PING, 0, 0, b"12345678")
            + h2.pack_frame(h2.HEADERS, h2.PADDED | h2.PRIORITY_FLAG, 1,
                            first)
            + h2.pack_frame(h2.CONTINUATION, h2.END_HEADERS, 1, block[7:])
            + h2.pack_frame(h2.DATA, h2.END_STREAM, 1,
                            struct.pack(">BI", 0, 2) + b"hi"))
        got = b""
        dec = h2.HpackDecoder()
        seen = {}
        sock.settimeout(10)
        while h2.HEADERS not in seen or h2.PING not in seen:
            got += sock.recv(65536)
            for t, fl, sid, p in split_frames(got):
                seen.setdefault(t, (fl, sid, p))
        frames = split_frames(got)
        assert (h2.SETTINGS, h2.ACK, 0, b"") in frames
        assert (h2.PING, h2.ACK, 0, b"12345678") in frames
        fl, sid, p = seen[h2.HEADERS]
        assert sid == 1 and fl & h2.END_STREAM
        fields = dict(dec.decode(p))
        assert fields["grpc-status"] == "12"
        assert fields["grpc-message"] == "Method not found!"
        sock.close()
    finally:
        server.stop()


# -- a large message each way at the RFC defaults -----------------------------

def _joined(it):
    return b"".join(it)


def _blob(req):
    yield req[::-1]
    yield req


@pytest.mark.parametrize("window,frame", [
    (h2.DEFAULT_WINDOW, h2.DEFAULT_FRAME), (h2.GRPC_WINDOW, h2.GRPC_FRAME)])
def test_one_mib_each_way(window, frame):
    handlers = {"/t.S/Up": h2.stream_unary_handler(_joined),
                "/t.S/Down": h2.unary_stream_handler(_blob)}
    server = h2.Server(handlers.get, window=window, max_frame=frame)
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    msg = bytes(range(256)) * 4096                     # 1 MiB
    try:
        with h2.Channel(f"127.0.0.1:{port}", window=window,
                        max_frame=frame) as ch:
            up = ch.stream_unary("/t.S/Up")([msg, msg[:1000]], timeout=60)
            assert up == msg + msg[:1000]
            down = list(ch.unary_stream("/t.S/Down")(msg, timeout=60))
            assert down == [msg[::-1], msg]
            # more calls on the same connection: the windows recovered
            for _ in range(3):
                assert ch.stream_unary("/t.S/Up")([msg], timeout=60) == msg
    finally:
        server.stop()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("h2-")]


def test_client_request_headers_and_cancel_on_timeout():
    """Against a raw peer that never answers: the port's client sends
    gRPC's request headers and one prefixed message, then on its timeout
    raises DEADLINE_EXCEEDED and resets the stream with CANCEL."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    port = listener.getsockname()[1]
    got = []

    def peer():
        sock, _ = listener.accept()
        sock.settimeout(10)
        sock.sendall(h2.pack_frame(h2.SETTINGS, 0, 0))
        data = b""
        try:
            while not any(t == h2.RST_STREAM
                          for t, *_ in split_frames(data[24:])):
                chunk = sock.recv(65536)
                if not chunk:
                    break
                data += chunk
        finally:
            got.append(data)
            sock.close()

    t = threading.Thread(target=peer)
    t.start()
    try:
        with h2.Channel(f"127.0.0.1:{port}") as ch:
            with pytest.raises(h2.RpcError) as e:
                list(ch.unary_stream("/t.S/Never")(b"ping", timeout=0.2))
        assert (e.value.code, e.value.details) == ("DEADLINE_EXCEEDED",
                                                   "Deadline Exceeded")
        t.join(10)
        assert not t.is_alive()
    finally:
        listener.close()
    data = got[0]
    assert data.startswith(h2.PREFACE)
    frames = split_frames(data[len(h2.PREFACE):])
    headers = next(p for ft, _f, sid, p in frames if ft == h2.HEADERS)
    fields = dict(h2.HpackDecoder().decode(headers))
    assert {k: fields[k] for k in (":method", ":scheme", ":path",
                                   "content-type", "te")} == {
        ":method": "POST", ":scheme": "http", ":path": "/t.S/Never",
        "content-type": "application/grpc", "te": "trailers"}
    assert 0 < h2.decode_timeout(fields["grpc-timeout"]) <= 0.2
    body = b"".join(p for ft, _f, sid, p in frames if ft == h2.DATA)
    assert body == struct.pack(">BI", 0, 4) + b"ping"
    assert [(sid, p) for ft, _f, sid, p in frames
            if ft == h2.RST_STREAM] == [(1, struct.pack(">I", h2.CANCEL))]
