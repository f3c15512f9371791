"""In-process S3-compatible object store (test fixture).

The MinIO-of-the-test-suite: an HTTP server speaking enough of the S3
REST API for S3PinotFS — PUT/GET(Range)/HEAD/DELETE object, server-side
copy (x-amz-copy-source), ListObjectsV2 (prefix/delimiter/continuation),
multipart upload (initiate/part/complete/abort). Verifies AWS SigV4
signatures when credentials are configured (recomputing the signature
from the raw request — the client and server share only the public
algorithm, not code paths: the server reconstructs the canonical request
from what arrived on the wire). Supports failure injection (`fail_next`)
so client retry/backoff paths are testable.

Port of ``pinot_tpu/fs/stub.py``, unchanged.
"""
from __future__ import annotations

import hashlib
import http.server
import threading
import urllib.parse
from typing import Dict, List, Optional, Tuple

from .s3 import sigv4_headers


class _Store:
    def __init__(self):
        self.objects: Dict[Tuple[str, str], bytes] = {}
        self.uploads: Dict[str, Dict[int, bytes]] = {}
        self.lock = threading.Lock()
        self.next_upload = 0


def _xml_escape(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


class _S3Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    # -- plumbing ---------------------------------------------------------

    @property
    def stub(self) -> "FakeS3Server":
        return self.server.stub  # type: ignore[attr-defined]

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _respond(self, status: int, body: bytes = b"",
                 headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def _error(self, status: int, code: str, msg: str = "") -> None:
        body = (f"<Error><Code>{code}</Code>"
                f"<Message>{_xml_escape(msg)}</Message></Error>").encode()
        self._respond(status, body)

    def _parse(self) -> Tuple[str, str, Dict[str, str]]:
        parsed = urllib.parse.urlparse(self.path)
        q = {k: v[0] for k, v in
             urllib.parse.parse_qs(parsed.query,
                                   keep_blank_values=True).items()}
        path = urllib.parse.unquote(parsed.path).lstrip("/")
        bucket, _, key = path.partition("/")
        return bucket, key, q

    def _check_auth(self, body: bytes) -> bool:
        stub = self.stub
        if stub.access_key is None:
            return True
        auth = self.headers.get("Authorization") or ""
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            self._error(403, "AccessDenied", "missing SigV4 authorization")
            return False
        try:
            fields = dict(
                f.strip().split("=", 1)
                for f in auth[len("AWS4-HMAC-SHA256 "):].split(","))
            signed = fields["SignedHeaders"].split(";")
            sent_sig = fields["Signature"]
        except (ValueError, KeyError):
            self._error(403, "AccessDenied", "malformed authorization")
            return False
        parsed = urllib.parse.urlparse(self.path)
        q = {k: v[0] for k, v in
             urllib.parse.parse_qs(parsed.query,
                                   keep_blank_values=True).items()}
        # reconstruct the canonical request from the wire
        hdrs = {k: self.headers[k] for k in signed
                if k not in ("host",) and self.headers.get(k) is not None}
        payload_sha = self.headers.get("x-amz-content-sha256",
                                       hashlib.sha256(body).hexdigest())
        expect = sigv4_headers(
            self.command, self.headers.get("Host", ""),
            urllib.parse.unquote(parsed.path), q, hdrs, payload_sha,
            stub.access_key, stub.secret_key, stub.region,
            self.headers.get("x-amz-date", ""))
        exp_sig = expect["Authorization"].rsplit("Signature=", 1)[1]
        if exp_sig != sent_sig:
            self._error(403, "SignatureDoesNotMatch",
                        "recomputed signature differs")
            return False
        if payload_sha != hashlib.sha256(body).hexdigest():
            self._error(400, "XAmzContentSHA256Mismatch", "payload hash")
            return False
        return True

    def _inject_failure(self) -> bool:
        stub = self.stub
        with stub._lock:
            if stub.fail_next > 0:
                stub.fail_next -= 1
                self._error(500, "InternalError", "injected failure")
                return True
        return False

    # -- verbs ------------------------------------------------------------

    def do_PUT(self) -> None:
        body = self._read_body()
        if self._inject_failure() or not self._check_auth(body):
            return
        bucket, key, q = self._parse()
        store = self.stub.store
        if "partNumber" in q and "uploadId" in q:
            with store.lock:
                up = store.uploads.get(q["uploadId"])
                if up is None:
                    return self._error(404, "NoSuchUpload", q["uploadId"])
                up[int(q["partNumber"])] = body
            etag = hashlib.md5(body).hexdigest()
            return self._respond(200, headers={"ETag": f'"{etag}"'})
        src = self.headers.get("x-amz-copy-source")
        if src is not None:
            sp = urllib.parse.unquote(src).lstrip("/")
            sb, _, sk = sp.partition("/")
            with store.lock:
                data = store.objects.get((sb, sk))
                if data is None:
                    return self._error(404, "NoSuchKey", sp)
                store.objects[(bucket, key)] = data
            return self._respond(
                200, b"<CopyObjectResult><ETag/></CopyObjectResult>")
        with store.lock:
            store.objects[(bucket, key)] = body
        self._respond(200, headers={"ETag": '"etag"'})

    def do_GET(self) -> None:
        if self._inject_failure() or not self._check_auth(b""):
            return
        bucket, key, q = self._parse()
        store = self.stub.store
        if not key and q.get("list-type") == "2":
            return self._list(bucket, q)
        with store.lock:
            data = store.objects.get((bucket, key))
        if data is None:
            return self._error(404, "NoSuchKey", key)
        rng = self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            lo_s, _, hi_s = rng[len("bytes="):].partition("-")
            lo = int(lo_s)
            hi = min(int(hi_s), len(data) - 1) if hi_s else len(data) - 1
            part = data[lo:hi + 1]
            return self._respond(206, part, headers={
                "Content-Range": f"bytes {lo}-{hi}/{len(data)}"})
        self._respond(200, data)

    def _list(self, bucket: str, q: Dict[str, str]) -> None:
        store = self.stub.store
        prefix = q.get("prefix", "")
        delim = q.get("delimiter", "")
        start = q.get("continuation-token", "")
        page = self.stub.list_page_size
        if "max-keys" in q:
            page = min(page, max(int(q["max-keys"]), 1))
        with store.lock:
            keys = sorted(k for b, k in store.objects if b == bucket
                          and k.startswith(prefix))
            sizes = {k: len(store.objects[(bucket, k)]) for k in keys}
        # collapse into ordered units (key or rolled-up common prefix) —
        # prefixes count toward the page and are emitted exactly once
        # across pages (real MaxKeys semantics), so continuation tokens
        # can never re-emit a prefix
        units: List[Tuple[str, bool]] = []
        for k in keys:
            if delim:
                rest = k[len(prefix):]
                if delim in rest:
                    p = prefix + rest.split(delim, 1)[0] + delim
                    if not units or units[-1][0] != p:
                        units.append((p, True))
                    continue
            units.append((k, False))
        contents: List[Tuple[str, int]] = []
        prefixes: List[str] = []
        truncated = False
        next_token = ""
        for name, is_prefix in units:
            if name <= start:
                continue
            if len(contents) + len(prefixes) >= page:
                truncated = True
                break
            next_token = name
            if is_prefix:
                prefixes.append(name)
            else:
                contents.append((name, sizes[name]))
        parts = ["<?xml version='1.0'?><ListBucketResult>"]
        for k, size in contents:
            parts.append(f"<Contents><Key>{_xml_escape(k)}</Key>"
                         f"<Size>{size}</Size></Contents>")
        for p in prefixes:
            parts.append(f"<CommonPrefixes><Prefix>{_xml_escape(p)}"
                         "</Prefix></CommonPrefixes>")
        parts.append(f"<IsTruncated>{'true' if truncated else 'false'}"
                     "</IsTruncated>")
        if next_token:
            parts.append(f"<NextContinuationToken>"
                         f"{_xml_escape(next_token)}"
                         "</NextContinuationToken>")
        parts.append("</ListBucketResult>")
        self._respond(200, "".join(parts).encode())

    def do_HEAD(self) -> None:
        if self._inject_failure() or not self._check_auth(b""):
            return
        bucket, key, _q = self._parse()
        with self.stub.store.lock:
            data = self.stub.store.objects.get((bucket, key))
        if data is None:
            return self._respond(404)
        self._respond(200, data)  # HEAD: length header only, no body

    def do_DELETE(self) -> None:
        if self._inject_failure() or not self._check_auth(b""):
            return
        bucket, key, q = self._parse()
        store = self.stub.store
        if "uploadId" in q:
            with store.lock:
                store.uploads.pop(q["uploadId"], None)
            return self._respond(204)
        with store.lock:
            store.objects.pop((bucket, key), None)
        self._respond(204)

    def do_POST(self) -> None:
        body = self._read_body()
        if self._inject_failure() or not self._check_auth(body):
            return
        bucket, key, q = self._parse()
        store = self.stub.store
        if "uploads" in q:
            with store.lock:
                store.next_upload += 1
                uid = f"up-{store.next_upload}"
                store.uploads[uid] = {}
            xml = (f"<InitiateMultipartUploadResult>"
                   f"<Bucket>{_xml_escape(bucket)}</Bucket>"
                   f"<Key>{_xml_escape(key)}</Key>"
                   f"<UploadId>{uid}</UploadId>"
                   "</InitiateMultipartUploadResult>")
            return self._respond(200, xml.encode())
        if "uploadId" in q:
            with store.lock:
                up = store.uploads.pop(q["uploadId"], None)
                if up is None:
                    return self._error(404, "NoSuchUpload", q["uploadId"])
                store.objects[(bucket, key)] = b"".join(
                    up[n] for n in sorted(up))
            return self._respond(
                200, b"<CompleteMultipartUploadResult/>")
        self._error(400, "InvalidRequest", "unsupported POST")


class FakeS3Server:
    """S3-compatible store on 127.0.0.1 (port 0 = ephemeral)."""

    def __init__(self, port: int = 0, access_key: Optional[str] = None,
                 secret_key: str = "", region: str = "us-east-1",
                 list_page_size: int = 1000):
        self.store = _Store()
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.list_page_size = list_page_size
        self.fail_next = 0
        self._lock = threading.Lock()

        class _Srv(http.server.ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Srv(("127.0.0.1", port), _S3Handler)
        self._server.stub = self  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]
        self.endpoint_url = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def inject_failures(self, n: int) -> None:
        with self._lock:
            self.fail_next = n

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
