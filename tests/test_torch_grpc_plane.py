"""The port's gRPC data plane against the JAX package's, on the CPU.

A JAX ``ServerNode`` and a port ``ServerNode(device="cpu")`` serve the
same three segments (as ``tests/test_grpc_plane.py`` builds them), each
under its own controller. Four pairings of client and server are held
to the reference pairing (the JAX client against the JAX server):

- ``jax>port``: the JAX package's ``grpcio`` client against the port's
  server;
- ``port>jax``: the port's client (its own HTTP/2) against the JAX
  package's ``grpcio`` server;
- ``port>port``: the port against itself;
- ``raw>port``: a raw-protobuf ``grpcio`` channel (``server_pb2.Frame``
  built by hand, as ``tests/test_grpc_contract.py`` does) against the
  port's server.

Each pairing gives the reference's META headers, ``encode_partial``
blocks (byte-equal), reduced rows, mailbox counts and drained relations,
trace trees, and status codes and details for an unknown method, a
handler exception, a client timeout and a message over the 4 MiB
receive limit on either side; 16 concurrent Submits are all answered.
The port's protos are byte-equal to the reference's, and a port server
node leaves no thread or listening socket once stopped.
"""
import json
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the engine)

import pinot_tpu.cluster as jcluster
import pinot_tpu.engine.datablock as jblock
import pinot_tpu.engine.reduce as jreduce
import pinot_tpu.multistage.dispatch as jdisp
import pinot_tpu.multistage.relation as jrel
import pinot_tpu.protos.plan_pb2 as jplan_pb2
import pinot_tpu.protos.server_pb2 as jserver_pb2
import pinot_tpu.query.context as jctx
import pinot_tpu.query.sql as jsql
import pinot_tpu.segment as jseg
import pinot_tpu.spi as jspi
import pinot_tpu_torch.cluster as tcluster
import pinot_tpu_torch.cluster.grpc_plane as tplane
import pinot_tpu_torch.engine.datablock as tblock
import pinot_tpu_torch.engine.reduce as treduce
import pinot_tpu_torch.multistage.dispatch as tdisp
import pinot_tpu_torch.multistage.relation as trel
import pinot_tpu_torch.protos.plan_pb2 as tplan_pb2
import pinot_tpu_torch.protos.server_pb2 as tserver_pb2
import pinot_tpu_torch.query.context as tctx
import pinot_tpu_torch.query.sql as tsql
from pinot_tpu_torch.cluster import h2

N_SEGMENTS = 3
ROWS = 400
WAIT_S = 30.0
SERVICE = "pinot.tpu.Server"
SQLS = [
    "SELECT k, SUM(v), COUNT(*) FROM g GROUP BY k ORDER BY k LIMIT 5",
    "SELECT COUNT(*), MAX(v) FROM g WHERE v > 40",
    "SELECT k, v FROM g WHERE v > 90 ORDER BY v, k LIMIT 7",
]
PAIRINGS = ["jax>port", "port>jax", "port>port", "raw>port"]
BIG = (4 << 20) + 1                        # one byte over the limit


def _wait(pred, what):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"{what} not within {WAIT_S} s")


@pytest.fixture(scope="module")
def seg_dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grpc_segs")
    rng = np.random.default_rng(5)
    schema = jspi.Schema("g", [
        jspi.FieldSpec("k", jspi.DataType.STRING, jspi.FieldType.DIMENSION),
        jspi.FieldSpec("v", jspi.DataType.INT, jspi.FieldType.METRIC)])
    dirs = []
    for i in range(N_SEGMENTS):
        cols = {"k": rng.choice(["a", "b"], ROWS),
                "v": rng.integers(0, 100, ROWS).astype(np.int32)}
        dirs.append(jseg.SegmentBuilder(schema, jspi.TableConfig("g")).build(
            cols, str(tmp / "seg"), f"seg_{i}"))
    return schema, dirs


def _side(pkg, schema, dirs, tmp):
    ctrl = pkg.Controller(str(tmp / "ctrl"), heartbeat_timeout=30.0,
                          reconcile_interval=0.1)
    kw = {"device": "cpu"} if pkg is tcluster else {}
    server = pkg.ServerNode("server_0", ctrl.url, poll_interval=0.1, **kw)
    ctrl.add_table("g", schema.to_dict(), replication=1)
    for i, d in enumerate(dirs):
        ctrl.add_segment("g", f"seg_{i}", d)
    _wait(lambda: server._tables.get("g") is not None and len(
        server._tables["g"].acquire_segments()) == N_SEGMENTS,
        "the segments")
    return ctrl, server


@pytest.fixture(scope="module")
def jax_side(seg_dirs, tmp_path_factory):
    ctrl, server = _side(jcluster, *seg_dirs,
                         tmp_path_factory.mktemp("jax_side"))
    yield server
    server.stop()
    ctrl.stop()


@pytest.fixture(scope="module")
def port_side(seg_dirs, tmp_path_factory):
    ctrl, server = _side(tcluster, *seg_dirs,
                         tmp_path_factory.mktemp("port_side"))
    yield SimpleNamespace(server=server, ctrl=ctrl)
    server.stop()
    ctrl.stop()


# ---------------------------------------------------------------------------
# the clients, each speaking for one package
# ---------------------------------------------------------------------------

def _grpc():
    return pytest.importorskip("grpc")


class _JaxClient:
    """The JAX package's plane (``grpcio``)."""
    block, reduce, ctx, sql, disp, rel = (jblock, jreduce, jctx, jsql,
                                          jdisp, jrel)

    def submit(self, target, sql, timeout=60.0, trace_ctx=None):
        from pinot_tpu.cluster.grpc_plane import submit_stream
        header, partials = submit_stream(target, sql, timeout=timeout,
                                         trace_ctx=trace_ctx)
        return header, [self.block.encode_partial(p) for p in partials], \
            partials

    def mailbox(self, target, frames, timeout=60.0):
        from pinot_tpu.cluster.grpc_plane import mailbox_send
        return mailbox_send(target, frames, timeout=timeout)

    def unknown(self, target):
        grpc = _grpc()
        with grpc.insecure_channel(target) as ch:
            return list(ch.unary_stream(f"/{SERVICE}/Nope")(b"", timeout=10))

    def status(self, fn):
        grpc = _grpc()
        try:
            fn()
        except grpc.RpcError as e:
            return e.code().name, e.details()
        return "OK", ""


class _PortClient:
    """The port's plane (``h2``)."""
    block, reduce, ctx, sql, disp, rel = (tblock, treduce, tctx, tsql,
                                          tdisp, trel)

    def submit(self, target, sql, timeout=60.0, trace_ctx=None):
        header, partials = tplane.submit_stream(target, sql, timeout=timeout,
                                                trace_ctx=trace_ctx)
        return header, [self.block.encode_partial(p) for p in partials], \
            partials

    def mailbox(self, target, frames, timeout=60.0):
        return tplane.mailbox_send(target, frames, timeout=timeout)

    def unknown(self, target):
        with h2.Channel(target) as ch:
            return list(ch.unary_stream(f"/{SERVICE}/Nope")(b"", timeout=10))

    def status(self, fn):
        try:
            fn()
        except h2.RpcError as e:
            return e.code, e.details
        return "OK", ""


class _RawClient(_JaxClient):
    """A ``grpcio`` channel with pre-serialized protobuf Frames and the
    raw wire bytes back: no helper of either plane."""

    def _channel(self, target):
        return _grpc().insecure_channel(target)

    def submit(self, target, sql, timeout=60.0, trace_ctx=None):
        req = jserver_pb2.Frame(payload=json.dumps(
            {"sql": sql, "traceContext": trace_ctx}).encode())
        with self._channel(target) as ch:
            call = ch.unary_stream(f"/{SERVICE}/Submit",
                                   request_serializer=lambda b: b,
                                   response_deserializer=lambda b: b)
            payloads = [jserver_pb2.Frame.FromString(c).payload
                        for c in call(req.SerializeToString(),
                                      timeout=timeout)]
        assert sum(p[:4] == b"META" for p in payloads) == 1
        header = json.loads(next(p for p in payloads
                                 if p[:4] == b"META")[4:])
        blocks = [p for p in payloads if p[:4] != b"META"]
        return header, blocks, [self.block.decode_partial(b) for b in blocks]

    def mailbox(self, target, frames, timeout=60.0):
        with self._channel(target) as ch:
            call = ch.stream_unary(f"/{SERVICE}/Mailbox",
                                   request_serializer=lambda b: b,
                                   response_deserializer=lambda b: b)
            ack = call(iter(jserver_pb2.Frame(payload=f).SerializeToString()
                            for f in frames), timeout=timeout)
        return json.loads(jserver_pb2.Frame.FromString(ack).payload)[
            "delivered"]


CLIENTS = {"jax": _JaxClient(), "port": _PortClient(), "raw": _RawClient()}


def _pair(pairing, jax_side, port_side):
    client, server = pairing.split(">")
    if "jax" in (client, server) or client == "raw":
        _grpc()
    node = jax_side if server == "jax" else port_side.server
    return CLIENTS[client], node, f"127.0.0.1:{node.grpc_port}"


def _reference(jax_side):
    return CLIENTS["jax"], jax_side, f"127.0.0.1:{jax_side.grpc_port}"


def _rows(client, sql, partials):
    ctx = client.ctx.build_query_context(client.sql.parse_sql(sql))
    return [tuple(r) for r in client.reduce.reduce_partials(ctx,
                                                            partials).rows]


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------

def test_protos_are_the_reference_bytes():
    for port, ref in ((tserver_pb2, jserver_pb2), (tplan_pb2, jplan_pb2)):
        assert port.DESCRIPTOR.serialized_pb == ref.DESCRIPTOR.serialized_pb
        with open(port.__file__) as a, open(ref.__file__) as b:
            line = [ln for ln in a if "AddSerializedFile" in ln]
            assert line == [ln for ln in b if "AddSerializedFile" in ln]
    from pinot_tpu.cluster.grpc_plane import _unwrap, _wrap
    rng = np.random.default_rng(5)
    for payload in (b"", b"x", b"\x00\x01" * 300,
                    rng.integers(0, 256, 5000).astype(np.uint8).tobytes()):
        assert tplane._wrap(payload) == _wrap(payload)
        assert tplane._unwrap(_wrap(payload)) == payload
        assert _unwrap(tplane._wrap(payload)) == payload


def test_server_node_serves_grpc(port_side):
    assert port_side.server.grpc_port
    assert isinstance(port_side.server.grpc_server, h2.Server)


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_submit_matches_the_reference(pairing, jax_side, port_side):
    client, _node, target = _pair(pairing, jax_side, port_side)
    ref, _rnode, ref_target = _reference(jax_side)
    for sql in SQLS:
        want_h, want_blocks, want_p = ref.submit(ref_target, sql)
        got_h, got_blocks, got_p = client.submit(target, sql)
        assert got_h == want_h == {"segmentsQueried": N_SEGMENTS}
        assert len(got_blocks) == N_SEGMENTS
        assert sorted(got_blocks) == sorted(want_blocks), sql
        assert _rows(client, sql, got_p) == _rows(ref, sql, want_p), sql


def _relations(pkg, n):
    rng = np.random.default_rng(n)
    return [pkg.Relation({"x": np.arange(k, dtype=np.int64) + 10 * k,
                          "y": rng.random(k)}, {}, "t")
            for k in (4, 1000, 3)]


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_mailbox_matches_the_reference(pairing, jax_side, port_side):
    client, node, target = _pair(pairing, jax_side, port_side)
    ref, rnode, ref_target = _reference(jax_side)
    qid = f"q_{pairing}"
    out = []
    for c, nd, tgt in ((client, node, target), (ref, rnode, ref_target)):
        frames = [c.disp.encode_mailbox_frame(qid, 7, 0, r)
                  for r in _relations(c.rel, 3)]
        frames.append(c.disp.encode_mailbox_frame(qid, 7, 0, None))
        n = c.mailbox(tgt, frames)
        blocks = nd.mailboxes.mailbox(qid, 7, 0).drain(timeout=10)
        nd.mailboxes.release(qid)
        out.append((n, [{k: np.asarray(v).tolist() for k, v in b.data.items()}
                        for b in blocks]))
    assert out[0] == out[1]
    assert out[0][0] == 4 and len(out[0][1]) == 3


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_trace_propagation(pairing, jax_side, port_side):
    client, _node, target = _pair(pairing, jax_side, port_side)
    sql = "SELECT COUNT(*) FROM g"
    header, _b, _p = client.submit(target, sql, trace_ctx={
        "queryId": "qg1", "sampled": True, "parentSpanId": "ab12cd34"})
    tree = header.get("trace")
    assert tree and tree["name"] == "server_query"
    assert tree["attrs"]["query_id"] == "qg1"
    assert tree["attrs"]["parent_span_id"] == "ab12cd34"
    assert tree["attrs"]["segments"] == N_SEGMENTS
    header2, _b, _p = client.submit(target, sql)
    assert "trace" not in header2


def _provoke(client, node, target, case):
    """(status name, details) of one provoked failure."""
    sql = "SELECT COUNT(*) FROM g"
    real = node.execute
    block = (jblock if isinstance(node, jcluster.ServerNode) else tblock)
    real_encode = block.encode_partial
    try:
        if case == "unknown_method":
            return client.status(lambda: client.unknown(target))
        if case == "handler_exception":
            def boom(*a, **k):
                raise ValueError("boom")
            node.execute = boom
            return client.status(lambda: client.submit(target, sql))
        if case == "timeout":
            def slow(*a, **k):
                time.sleep(0.6)
                return real(*a, **k)
            node.execute = slow
            return client.status(lambda: client.submit(target, sql,
                                                       timeout=0.15))
        if case == "too_large_request":
            return client.status(lambda: client.mailbox(
                target, [b"\0" * BIG], timeout=30))
        if case == "too_large_response":
            block.encode_partial = lambda p: b"\0" * BIG
            return client.status(lambda: client.submit(target, sql))
        raise AssertionError(case)
    finally:
        node.execute = real
        block.encode_partial = real_encode


@pytest.mark.parametrize("case", ["unknown_method", "handler_exception",
                                  "timeout", "too_large_request",
                                  "too_large_response"])
@pytest.mark.parametrize("pairing", PAIRINGS)
def test_status_codes_match_the_reference(pairing, case, jax_side,
                                          port_side):
    client, node, target = _pair(pairing, jax_side, port_side)
    want = _provoke(*_reference(jax_side), case)
    got = _provoke(client, node, target, case)
    assert got == want
    assert want[0] == {"unknown_method": "UNIMPLEMENTED",
                       "handler_exception": "UNKNOWN",
                       "timeout": "DEADLINE_EXCEEDED",
                       "too_large_request": "RESOURCE_EXHAUSTED",
                       "too_large_response": "RESOURCE_EXHAUSTED"}[case]
    # the server answers as before once the failure has passed
    time.sleep(0.6 if case == "timeout" else 0)
    header, blocks, _p = client.submit(target, SQLS[0])
    assert header == {"segmentsQueried": N_SEGMENTS}
    assert len(blocks) == N_SEGMENTS


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_sixteen_concurrent_submits(pairing, jax_side, port_side):
    client, _node, target = _pair(pairing, jax_side, port_side)
    ref, _rnode, ref_target = _reference(jax_side)
    want = {sql: sorted(ref.submit(ref_target, sql)[1]) for sql in SQLS}
    jobs = [SQLS[i % len(SQLS)] for i in range(16)]
    with ThreadPoolExecutor(16) as pool:
        got = list(pool.map(lambda s: client.submit(target, s), jobs))
    for sql, (header, blocks, _p) in zip(jobs, got):
        # concurrent queries may be micro-batched, which the header says
        assert header.pop("segmentsQueried") == N_SEGMENTS
        assert set(header) <= {"batched", "batchSize"}, header
        assert sorted(blocks) == want[sql]


def _h2_threads():
    return {t for t in threading.enumerate() if t.name.startswith("h2-")}


def test_stop_leaves_no_thread_or_listener(port_side):
    before = _h2_threads()
    node = tcluster.ServerNode("server_x", port_side.ctrl.url,
                               poll_interval=0.1, device="cpu")
    port = node.grpc_port
    try:
        header, _p = tplane.submit_stream(f"127.0.0.1:{port}",
                                          "SELECT COUNT(*) FROM g")
        assert header["segmentsQueried"] >= 0
        assert tplane.mailbox_send(f"127.0.0.1:{port}", []) == 0
        assert _h2_threads() - before
    finally:
        node.stop()
    assert _h2_threads() == before
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
    node.stop()                                  # a second stop is a no-op
    with pytest.raises(h2.RpcError) as e:
        tplane.submit_stream(f"127.0.0.1:{port}", "SELECT COUNT(*) FROM g")
    assert e.value.code == "UNAVAILABLE"


def test_bind_failure_raises(port_side):
    taken = port_side.server.grpc_port
    with pytest.raises(OSError):
        tplane.start_grpc(port_side.server, taken)


def test_failed_start_stops_the_plane(port_side):
    # the HTTP port is taken: the node raises after its gRPC plane started,
    # and stops that plane before it does
    before = _h2_threads()
    with pytest.raises(OSError):
        tcluster.ServerNode("server_y", port_side.ctrl.url,
                            port=port_side.server.port, device="cpu")
    assert _h2_threads() == before
