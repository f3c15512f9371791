"""gRPC data plane: streaming query responses + mailbox delivery.

Reference parity: pinot-core/.../transport/grpc/GrpcQueryServer.java:165
(server.proto:25 `rpc Submit(...) returns (stream ...)`: results stream
back block by block instead of one buffered DataTable) and the gRPC
mailbox of mailbox.proto:25. The wire contract IS protos/server.proto:
every message on the wire is a protobuf-encoded Frame (vendored protoc
gencode, protos/server_pb2.py) whose payload carries the framework's
binary frames (engine/datablock.py). HTTP (/query/bin, /mailbox)
remains the default data plane; gRPC adds streaming delivery (partials
arrive as they are produced, the reference's StreamingResponseUtils
behavior) and a client-streamed alternative for mailbox fan-out.

Port of ``pinot_tpu/cluster/grpc_plane.py``, with the same names and
semantics. The transport is the port's own HTTP/2 (``h2.py``), so a
``grpcio`` peer speaks to it and nothing outside the standard library
and the protobuf runtime is needed.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..protos import server_pb2
from . import h2

SERVICE = "pinot.tpu.Server"
_META = b"META"


def _wrap(payload: bytes) -> bytes:
    """bytes -> wire form of a pinot.tpu.Frame (the proto contract)."""
    return server_pb2.Frame(payload=payload).SerializeToString()


def _unwrap(wire: bytes) -> bytes:
    return server_pb2.Frame.FromString(wire).payload


class _Handlers:
    def __init__(self, node):
        self.node = node

    def service(self, method: str) -> Optional[h2.MethodHandler]:
        if method == f"/{SERVICE}/Submit":
            return h2.unary_stream_handler(
                self._submit, request_deserializer=_unwrap,
                response_serializer=_wrap)
        if method == f"/{SERVICE}/Mailbox":
            return h2.stream_unary_handler(
                self._mailbox, request_deserializer=_unwrap,
                response_serializer=_wrap)
        return None

    def _submit(self, request: bytes) -> Iterator[bytes]:
        """One partial block per chunk AS EACH SEGMENT FINISHES, then a
        META trailer: the streaming selection/response path the buffered
        HTTP plane lacks."""
        from ..engine.datablock import encode_partial
        req = json.loads(request)
        resp = self.node.execute(req["sql"], req.get("segments"),
                                 deadline_ms=req.get("deadlineMs"),
                                 trace_ctx=req.get("traceContext"))
        partials = resp.pop("partials_raw", [])
        for p in partials:
            yield encode_partial(p)
        yield _META + json.dumps(resp).encode()

    def _mailbox(self, request_iterator) -> bytes:
        from ..multistage.dispatch import deliver_mailbox_frame
        n = 0
        for frame in request_iterator:
            deliver_mailbox_frame(self.node.mailboxes, frame)
            n += 1
        return json.dumps({"delivered": n}).encode()


def start_grpc(node, port: int = 0) -> Tuple[h2.Server, int]:
    """Serve ``node`` on 127.0.0.1:``port`` (0: any free port) with 8
    handler threads; raises OSError when the port cannot be bound."""
    server = h2.Server(_Handlers(node).service)
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    return server, bound


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

def submit_stream(target: str, sql: str,
                  segments: Optional[List[str]] = None,
                  timeout: float = 60.0,
                  deadline_ms: Optional[float] = None,
                  trace_ctx: Optional[Dict[str, Any]] = None):
    """-> (header dict, [decoded partials]); partials decode as chunks
    arrive (GrpcBrokerRequestHandler analog). A sampled ``trace_ctx``
    (http_util.inject_trace_context shape) makes the server root a span
    tree; it arrives on the META trailer header as ``trace``. A status
    other than OK raises ``h2.RpcError``."""
    from ..engine.datablock import decode_partial
    from ..utils.faults import rpc_faults
    rpc_faults(f"GRPC {target}/Submit")
    partials: List[Any] = []
    header: Dict[str, Any] = {}
    with h2.Channel(target) as channel:
        call = channel.unary_stream(
            f"/{SERVICE}/Submit", request_serializer=_wrap,
            response_deserializer=_unwrap)
        req = json.dumps({"sql": sql, "segments": segments,
                          "deadlineMs": deadline_ms,
                          "traceContext": trace_ctx}).encode()
        for chunk in call(req, timeout=timeout):
            if chunk[:4] == _META:
                header = json.loads(chunk[4:])
            else:
                partials.append(decode_partial(chunk))
    return header, partials


def mailbox_send(target: str, frames: List[bytes],
                 timeout: float = 60.0) -> int:
    from ..utils.faults import rpc_faults
    rpc_faults(f"GRPC {target}/Mailbox")
    with h2.Channel(target) as channel:
        call = channel.stream_unary(
            f"/{SERVICE}/Mailbox", request_serializer=_wrap,
            response_deserializer=_unwrap)
        ack = call(iter(frames), timeout=timeout)
    return json.loads(ack)["delivered"]
