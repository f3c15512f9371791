"""Tiny stdlib HTTP plumbing shared by the cluster roles (the Netty/gRPC/
Jersey stack of the reference system collapses to ThreadingHTTPServer +
urllib for the host-side control and data planes).

Port of ``pinot_tpu/cluster/http_util.py``, with two differences: a
handler that raises ``NotImplementedError`` (a route of a module the port
does not have yet) answers HTTP 501 with the message, not 500; and the
listen backlog is 128, not socketserver's 5, so a wave of concurrent
clients queues instead of being reset."""
from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple


class JsonHandler(BaseHTTPRequestHandler):
    """Dispatches (method, path-prefix) to registered handlers returning
    (status, json-able)."""

    routes: Dict[Tuple[str, str], Callable] = {}
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _dispatch(self, method: str) -> None:
        body = None
        length = int(self.headers.get("Content-Length") or 0)
        raw = "octet-stream" in (self.headers.get("Content-Type") or "")
        if length and raw:
            # binary data plane: the handler receives the raw bytes
            body = self.rfile.read(length)
        elif length:
            try:
                body = json.loads(self.rfile.read(length))
            except ValueError as e:
                data = json.dumps(
                    {"error": f"malformed JSON body: {e}"}).encode()
                self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
        for (m, prefix), fn in sorted(self.routes.items(),
                                      key=lambda kv: -len(kv[0][1])):
            if m == method and self.path.split("?")[0].startswith(prefix):
                try:
                    status, payload = fn(self, body)
                except Exception as e:
                    # capacity/shed rejections (broker/workload.
                    # OverloadShedError, engine/scheduler.
                    # SchedulerRejectedError) must surface as
                    # STRUCTURED retryable JSON — HTTP 429 with
                    # errorCode + retryAfterMs — never a 500/stack
                    # trace a client can't act on
                    if getattr(e, "retry_after_ms", None) is not None \
                            and hasattr(e, "error_code"):
                        payload = (e.payload() if hasattr(e, "payload")
                                   else {"error": str(e),
                                         "errorCode": e.error_code,
                                         "retryAfterMs":
                                             e.retry_after_ms})
                        status = 429
                    elif isinstance(e, NotImplementedError):
                        status, payload = 501, {"error": str(e)}
                    else:  # surface handler errors as 500 JSON
                        status, payload = 500, {
                            "error": f"{type(e).__name__}: {e}"}
                if isinstance(payload, (bytes, bytearray)):
                    # binary data plane (DataTable-over-Netty analog)
                    data = bytes(payload)
                    ctype = "application/octet-stream"
                elif isinstance(payload, tuple) and len(payload) == 2 \
                        and isinstance(payload[0], str):
                    # (content_type, body) — e.g. the controller UI page
                    ctype, body = payload
                    data = body if isinstance(body, bytes) \
                        else str(body).encode()
                else:
                    data = json.dumps(payload).encode()
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
        self.send_response(404)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")


class _Server(ThreadingHTTPServer):
    # the listen backlog: a wave of concurrent clients must queue, not be
    # reset (socketserver's default backlog is 5)
    request_queue_size = 128


def start_http(handler_cls, port: int = 0) -> Tuple[ThreadingHTTPServer,
                                                    int, threading.Thread]:
    """Bind host: loopback by default (in-process clusters, tests);
    containerized deployments set PINOT_BIND_HOST=0.0.0.0 so the
    advertised service names are actually reachable across containers
    (deploy/)."""
    import os
    host = os.environ.get("PINOT_BIND_HOST", "127.0.0.1")
    srv = _Server((host, port), handler_cls)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1], t


def inject_trace_context(body: Dict[str, Any],
                         query_id: Optional[str] = None,
                         sampled: bool = False,
                         parent_span_id: Optional[str] = None,
                         remaining_ms: Optional[float] = None
                         ) -> Dict[str, Any]:
    """Cross-node trace-context wire format: the broker stamps every
    scatter call (HTTP and gRPC) with ``traceContext`` so the server can
    root a remote span tree that stitches back under the dispatching
    call span. ``sampled`` gates the server-side tree (zero cost when
    false); ``parentSpanId`` is the dispatching scatter_call span;
    ``remainingMs`` mirrors the deadlineMs budget for span annotation
    (deadlineMs stays the accountant-authoritative field)."""
    ctx: Dict[str, Any] = {"queryId": query_id, "sampled": bool(sampled)}
    if parent_span_id is not None:
        ctx["parentSpanId"] = parent_span_id
    if remaining_ms is not None:
        ctx["remainingMs"] = int(remaining_ms)
    body["traceContext"] = ctx
    return body


def http_raw(method: str, url: str, body: Any = None,
             timeout: float = 10.0,
             headers: Optional[Dict[str, str]] = None) -> bytes:
    """Raw-bytes response; body may be JSON-able or raw bytes (the latter
    POSTs as octet-stream — the binary data plane both ways). ``headers``
    adds/overrides request headers (the trace-context side channel for
    binary-body planes, where the payload is opaque proto bytes)."""
    from ..utils.faults import rpc_faults
    rpc_faults(f"{method} {url}")
    if isinstance(body, (bytes, bytearray)):
        data = bytes(body)
        ctype = "application/octet-stream"
    else:
        data = json.dumps(body).encode() if body is not None else None
        ctype = "application/json"
    hdrs = {"Content-Type": ctype}
    if headers:
        hdrs.update(headers)
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=hdrs)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def http_json(method: str, url: str, body: Any = None,
              timeout: float = 10.0,
              headers: Optional[Dict[str, str]] = None) -> Any:
    payload = http_raw(method, url, body, timeout, headers)
    return json.loads(payload) if payload else None


# binary-body planes (POST /stage ships StagePlan proto bytes) cannot
# carry traceContext in the payload; it rides this header instead
TRACE_HEADER = "X-Pinot-Trace-Context"


def trace_context_header(ctx: Optional[Dict[str, Any]]
                         ) -> Optional[Dict[str, str]]:
    """traceContext dict -> request-headers dict (None when no ctx)."""
    if not ctx:
        return None
    return {TRACE_HEADER: json.dumps(ctx)}


def trace_context_from(headers: Any) -> Optional[Dict[str, Any]]:
    """Parse the trace-context header off an incoming request; a missing
    or malformed header is simply an unsampled request — tracing must
    never fail the data path."""
    raw = headers.get(TRACE_HEADER) if headers is not None else None
    if not raw:
        return None
    try:
        ctx = json.loads(raw)
    except ValueError:
        return None
    return ctx if isinstance(ctx, dict) else None
