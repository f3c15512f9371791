"""In-process GCS / WebHDFS / ADLS Gen2 protocol stubs (test fixtures).

Sibling of fs/stub.py (the S3 stub): each server speaks enough of the
real wire protocol for its PinotFS client — the client and stub share
only the public contract, never code paths. All three support failure
injection (`inject_failures(n)` makes the next n requests 503) so the
retry/backoff paths are testable, and verify auth when configured
(bearer token for GCS/ADLS, user.name presence for WebHDFS).

Port of ``pinot_tpu/fs/stub_cloud.py``, unchanged.
"""
from __future__ import annotations

import http.server
import json
import re
import threading
import urllib.parse
from typing import Dict, List, Optional, Tuple


class _BaseHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    @property
    def stub(self):
        return self.server.stub  # type: ignore[attr-defined]

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _respond(self, status: int, body: bytes = b"",
                 headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        hdrs = dict(headers or {})
        for k, v in hdrs.items():
            self.send_header(k, v)
        if not any(k.lower() == "content-length" for k in hdrs):
            self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _inject_failure(self) -> bool:
        with self.stub._lock:
            if self.stub.fail_next > 0:
                self.stub.fail_next -= 1
                self._respond(503, b"injected failure")
                return True
        return False

    def _parse(self) -> Tuple[str, Dict[str, str]]:
        u = urllib.parse.urlparse(self.path)
        return (urllib.parse.unquote(u.path),
                dict(urllib.parse.parse_qsl(u.query)))


class _BaseServer:
    handler_cls: type

    def __init__(self, port: int = 0, **cfg):
        self.fail_next = 0
        self._lock = threading.Lock()
        self.cfg = cfg

        class _Srv(http.server.ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Srv(("127.0.0.1", port), self.handler_cls)
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


# ---------------------------------------------------------------------------
# GCS JSON API
# ---------------------------------------------------------------------------

class _GcsHandler(_BaseHandler):
    def _check_auth(self) -> bool:
        tok = self.stub.cfg.get("token")
        if tok is None:
            return True
        if self.headers.get("Authorization") == f"Bearer {tok}":
            return True
        self._respond(401, json.dumps(
            {"error": {"message": "invalid bearer token"}}).encode())
        return False

    def _err(self, status: int, msg: str) -> None:
        self._respond(status, json.dumps(
            {"error": {"message": msg}}).encode())

    def do_GET(self) -> None:
        if self._inject_failure() or not self._check_auth():
            return
        path, q = self._parse()
        m = re.fullmatch(r"/storage/v1/b/([^/]+)/o/(.+)", path)
        if m:
            bucket, obj = m.group(1), m.group(2)
            data = self.stub.objects.get((bucket, obj))
            if data is None:
                return self._err(404, f"object {obj!r} not found")
            if q.get("alt") == "media":
                rng = self.headers.get("Range")
                if rng:
                    lo, hi = map(int, rng.split("=")[1].split("-"))
                    return self._respond(206, data[lo: hi + 1])
                return self._respond(200, data)
            return self._respond(200, json.dumps(
                {"name": obj, "size": str(len(data))}).encode())
        m = re.fullmatch(r"/storage/v1/b/([^/]+)/o", path)
        if m:
            return self._list(m.group(1), q)
        self._err(400, f"bad GET {path}")

    def _list(self, bucket: str, q: Dict[str, str]) -> None:
        prefix = q.get("prefix", "")
        delim = q.get("delimiter", "")
        page = int(q.get("maxResults", self.stub.cfg.get("page", 1000)))
        names = sorted(k for (b, k) in self.stub.objects
                       if b == bucket and k.startswith(prefix))
        items: List[dict] = []
        prefixes: List[str] = []
        for k in names:
            rest = k[len(prefix):]
            if delim and delim in rest:
                p = prefix + rest.split(delim)[0] + delim
                if p not in prefixes:
                    prefixes.append(p)
                continue
            items.append({"name": k,
                          "size": str(len(self.stub.objects[(bucket, k)]))})
        start = int(q.get("pageToken", 0))
        out = {"items": items[start: start + page],
               "prefixes": prefixes if start == 0 else []}
        if start + page < len(items):
            out["nextPageToken"] = str(start + page)
        self._respond(200, json.dumps(out).encode())

    def do_POST(self) -> None:
        body = self._read_body()
        if self._inject_failure() or not self._check_auth():
            return
        path, q = self._parse()
        m = re.fullmatch(r"/upload/storage/v1/b/([^/]+)/o", path)
        if m:
            bucket = m.group(1)
            name = q.get("name", "")
            if q.get("uploadType") == "media":
                self.stub.objects[(bucket, name)] = body
                return self._respond(200, json.dumps(
                    {"name": name, "size": str(len(body))}).encode())
            if q.get("uploadType") == "resumable":
                with self.stub._lock:
                    self.stub.next_session += 1
                    sid = f"sess-{self.stub.next_session}"
                    self.stub.sessions[sid] = (bucket, name, bytearray())
                loc = (f"{self.stub.endpoint_url}{path}?"
                       + urllib.parse.urlencode(
                           {"uploadType": "resumable", "name": name,
                            "upload_id": sid}))
                return self._respond(200, headers={"Location": loc})
        m = re.fullmatch(r"/storage/v1/b/([^/]+)/o/(.+?)"
                         r"/rewriteTo/b/([^/]+)/o/(.+)", path)
        if m:
            sb, so, db, do = (m.group(i) for i in range(1, 5))
            data = self.stub.objects.get((sb, so))
            if data is None:
                return self._err(404, "source not found")
            self.stub.objects[(db, do)] = data
            return self._respond(200, json.dumps(
                {"done": True,
                 "resource": {"name": do,
                              "size": str(len(data))}}).encode())
        self._err(400, f"bad POST {path}")

    def do_PUT(self) -> None:
        body = self._read_body()
        if self._inject_failure() or not self._check_auth():
            return
        path, q = self._parse()
        sid = q.get("upload_id")
        sess = self.stub.sessions.get(sid) if sid else None
        if sess is None:
            return self._err(400, "unknown upload session")
        bucket, name, buf = sess
        cr = self.headers.get("Content-Range", "")
        mq = re.fullmatch(r"bytes \*/(\d+)", cr)
        if mq:
            # status query: finalize when complete, else report Range
            if len(buf) == int(mq.group(1)):
                self.stub.objects[(bucket, name)] = bytes(buf)
                del self.stub.sessions[sid]
                return self._respond(200, json.dumps(
                    {"name": name, "size": str(len(buf))}).encode())
            return self._respond(
                308, headers={"Range": f"bytes=0-{len(buf) - 1}"})
        m = re.fullmatch(r"bytes (\d+)-(\d+)/(\d+)", cr)
        if not m:
            return self._err(400, f"bad Content-Range {cr!r}")
        lo, hi, total = map(int, m.groups())
        if lo != len(buf):
            return self._err(
                409, f"out-of-order chunk at {lo}, have {len(buf)}")
        with self.stub._lock:
            truncate = self.stub.truncate_next > 0
            if truncate:
                self.stub.truncate_next -= 1
            stall = self.stub.stall_finalize_next > 0
            if stall and hi + 1 == total:
                self.stub.stall_finalize_next -= 1
            else:
                stall = False
        if truncate and len(body) > 1:
            # persist only half the chunk: the 308 Range tells the
            # client where to resume (the resumable protocol contract)
            body = body[: len(body) // 2]
            buf.extend(body)
            return self._respond(
                308, headers={"Range": f"bytes=0-{len(buf) - 1}"})
        if stall:
            # persist everything but DON'T finalize: the client must
            # issue a 'bytes */total' status query to complete
            buf.extend(body)
            return self._respond(
                308, headers={"Range": f"bytes=0-{len(buf) - 1}"})
        buf.extend(body)
        if hi + 1 == total:
            self.stub.objects[(bucket, name)] = bytes(buf)
            del self.stub.sessions[sid]
            return self._respond(200, json.dumps(
                {"name": name, "size": str(total)}).encode())
        self._respond(308, headers={"Range": f"bytes=0-{len(buf) - 1}"})

    def do_DELETE(self) -> None:
        if self._inject_failure() or not self._check_auth():
            return
        path, _q = self._parse()
        m = re.fullmatch(r"/storage/v1/b/([^/]+)/o/(.+)", path)
        if m and (m.group(1), m.group(2)) in self.stub.objects:
            del self.stub.objects[(m.group(1), m.group(2))]
            return self._respond(204)
        self._err(404, "not found")


class FakeGcsServer(_BaseServer):
    handler_cls = _GcsHandler

    def __init__(self, port: int = 0, token: Optional[str] = None,
                 page: int = 1000):
        self.objects: Dict[Tuple[str, str], bytes] = {}
        self.sessions: Dict[str, tuple] = {}
        self.next_session = 0
        self.truncate_next = 0     # partial-persist injection (308 Range)
        self.stall_finalize_next = 0
        super().__init__(port, token=token, page=page)

    def truncate_chunks(self, n: int) -> None:
        """Make the next n resumable chunk PUTs persist only half and
        reply 308 with the committed Range — clients must resume from
        the reported offset, not their own bookkeeping."""
        with self._lock:
            self.truncate_next = n

    def stall_finalize(self, n: int) -> None:
        """Make the next n FINAL chunk PUTs persist fully but answer 308
        (full Range) instead of finalizing — clients must complete the
        session with a 'bytes */total' status-query PUT."""
        with self._lock:
            self.stall_finalize_next = n


# ---------------------------------------------------------------------------
# WebHDFS
# ---------------------------------------------------------------------------

class _HdfsHandler(_BaseHandler):
    def _err(self, status: int, exc: str, msg: str) -> None:
        self._respond(status, json.dumps({"RemoteException": {
            "exception": exc, "message": msg}}).encode())

    def _check_auth(self, q: Dict[str, str]) -> bool:
        if self.stub.cfg.get("require_user") and "user.name" not in q:
            self._err(401, "AuthenticationException", "no user.name")
            return False
        return True

    @staticmethod
    def _fs_path(path: str) -> str:
        assert path.startswith("/webhdfs/v1")
        return path[len("/webhdfs/v1"):] or "/"

    def _status_of(self, p: str) -> Optional[dict]:
        st = self.stub
        if p in st.files:
            return {"pathSuffix": p.rsplit("/", 1)[-1], "type": "FILE",
                    "length": len(st.files[p])}
        if p in st.dirs or any(f.startswith(p.rstrip("/") + "/")
                               for f in list(st.files) + list(st.dirs)):
            return {"pathSuffix": p.rstrip("/").rsplit("/", 1)[-1],
                    "type": "DIRECTORY", "length": 0}
        return None

    def do_GET(self) -> None:
        if self._inject_failure():
            return
        path, q = self._parse()
        if not self._check_auth(q):
            return
        p = self._fs_path(path)
        op = q.get("op", "").upper()
        if op == "OPEN":
            if "redirected" not in q:
                loc = (f"{self.stub.endpoint_url}{self.path}"
                       "&redirected=true")
                return self._respond(307, headers={"Location": loc})
            data = self.stub.files.get(p)
            if data is None:
                return self._err(404, "FileNotFoundException", p)
            off = int(q.get("offset", 0))
            ln = int(q.get("length", len(data) - off))
            return self._respond(200, data[off: off + ln])
        if op == "GETFILESTATUS":
            st = self._status_of(p)
            if st is None:
                return self._err(404, "FileNotFoundException", p)
            return self._respond(200, json.dumps(
                {"FileStatus": st}).encode())
        if op == "LISTSTATUS":
            base = p.rstrip("/")
            kids: Dict[str, dict] = {}
            for f, data in self.stub.files.items():
                if f.startswith(base + "/"):
                    rest = f[len(base) + 1:]
                    name = rest.split("/")[0]
                    if "/" in rest:
                        kids[name] = {"pathSuffix": name,
                                      "type": "DIRECTORY", "length": 0}
                    else:
                        kids[name] = {"pathSuffix": name, "type": "FILE",
                                      "length": len(data)}
            for d in self.stub.dirs:
                if d.rstrip("/").startswith(base + "/"):
                    name = d[len(base) + 1:].split("/")[0]
                    kids.setdefault(name, {"pathSuffix": name,
                                           "type": "DIRECTORY",
                                           "length": 0})
            return self._respond(200, json.dumps({"FileStatuses": {
                "FileStatus": [kids[k] for k in sorted(kids)]}}).encode())
        self._err(400, "UnsupportedOperationException", op)

    def do_PUT(self) -> None:
        body = self._read_body()
        if self._inject_failure():
            return
        path, q = self._parse()
        if not self._check_auth(q):
            return
        p = self._fs_path(path)
        op = q.get("op", "").upper()
        if op == "CREATE":
            if "redirected" not in q:
                loc = (f"{self.stub.endpoint_url}{self.path}"
                       "&redirected=true")
                return self._respond(307, headers={"Location": loc})
            if q.get("overwrite", "true") != "true" \
                    and p in self.stub.files:
                return self._err(403, "FileAlreadyExistsException", p)
            self.stub.files[p] = body
            return self._respond(201)
        if op == "MKDIRS":
            self.stub.dirs.add(p.rstrip("/"))
            return self._respond(200, b'{"boolean": true}')
        if op == "RENAME":
            dst = q.get("destination", "")
            ok = False
            if p in self.stub.files:
                self.stub.files[dst] = self.stub.files.pop(p)
                ok = True
            else:
                pre = p.rstrip("/") + "/"
                moves = [f for f in self.stub.files if f.startswith(pre)]
                for f in moves:
                    self.stub.files[dst.rstrip("/") + "/" + f[len(pre):]] \
                        = self.stub.files.pop(f)
                    ok = True
                if p.rstrip("/") in self.stub.dirs:
                    self.stub.dirs.discard(p.rstrip("/"))
                    self.stub.dirs.add(dst.rstrip("/"))
                    ok = True
            return self._respond(
                200, json.dumps({"boolean": ok}).encode())
        self._err(400, "UnsupportedOperationException", op)

    def do_DELETE(self) -> None:
        if self._inject_failure():
            return
        path, q = self._parse()
        if not self._check_auth(q):
            return
        p = self._fs_path(path)
        ok = False
        if p in self.stub.files:
            del self.stub.files[p]
            ok = True
        else:
            pre = p.rstrip("/") + "/"
            if q.get("recursive") == "true":
                for f in [f for f in self.stub.files
                          if f.startswith(pre)]:
                    del self.stub.files[f]
                    ok = True
            if p.rstrip("/") in self.stub.dirs:
                self.stub.dirs.discard(p.rstrip("/"))
                ok = True
        self._respond(200, json.dumps({"boolean": ok}).encode())


class FakeWebHdfsServer(_BaseServer):
    handler_cls = _HdfsHandler

    def __init__(self, port: int = 0, require_user: bool = True):
        self.files: Dict[str, bytes] = {}
        self.dirs: set = set()
        super().__init__(port, require_user=require_user)


# ---------------------------------------------------------------------------
# ADLS Gen2 (dfs endpoint)
# ---------------------------------------------------------------------------

class _AdlsHandler(_BaseHandler):
    def _err(self, status: int, code: str, msg: str) -> None:
        self._respond(status, json.dumps(
            {"error": {"code": code, "message": msg}}).encode())

    def _check_auth(self) -> bool:
        tok = self.stub.cfg.get("token")
        if tok is None:
            return True
        if self.headers.get("Authorization") == f"Bearer {tok}":
            return True
        self._err(401, "InvalidAuthenticationInfo", "bad bearer token")
        return False

    def _split(self, path: str) -> Tuple[str, str]:
        parts = path.lstrip("/").split("/", 1)
        return parts[0], parts[1] if len(parts) > 1 else ""

    def do_PUT(self) -> None:
        self._read_body()
        if self._inject_failure() or not self._check_auth():
            return
        path, q = self._parse()
        fs, p = self._split(path)
        src = self.headers.get("x-ms-rename-source")
        if src:
            sfs, sp = self._split(urllib.parse.unquote(src))
            st = self.stub
            moved = False
            if (sfs, sp) in st.files:
                st.files[(fs, p)] = st.files.pop((sfs, sp))
                moved = True
            pre = sp.rstrip("/") + "/"
            for (f2, k) in [k2 for k2 in st.files
                            if k2[0] == sfs and k2[1].startswith(pre)]:
                st.files[(fs, p.rstrip("/") + "/" + k[len(pre):])] = \
                    st.files.pop((f2, k))
                moved = True
            if (sfs, sp.rstrip("/")) in st.dirs:
                st.dirs.discard((sfs, sp.rstrip("/")))
                st.dirs.add((fs, p.rstrip("/")))
                moved = True
            if not moved:
                return self._err(404, "PathNotFound", sp)
            return self._respond(201)
        if q.get("resource") == "file":
            self.stub.pending[(fs, p)] = bytearray()
            return self._respond(201)
        if q.get("resource") == "directory":
            self.stub.dirs.add((fs, p.rstrip("/")))
            return self._respond(201)
        self._err(400, "InvalidRequest", "unsupported PUT")

    def do_PATCH(self) -> None:
        body = self._read_body()
        if self._inject_failure() or not self._check_auth():
            return
        path, q = self._parse()
        fs, p = self._split(path)
        buf = self.stub.pending.get((fs, p))
        if buf is None:
            return self._err(404, "PathNotFound", p)
        if q.get("action") == "append":
            pos = int(q.get("position", 0))
            if pos != len(buf):
                return self._err(409, "InvalidFlushPosition",
                                 f"{pos} != {len(buf)}")
            buf.extend(body)
            return self._respond(202)
        if q.get("action") == "flush":
            if int(q.get("position", 0)) != len(buf):
                return self._err(409, "InvalidFlushPosition", "short")
            self.stub.files[(fs, p)] = bytes(buf)
            del self.stub.pending[(fs, p)]
            return self._respond(200)
        self._err(400, "InvalidRequest", "unsupported PATCH")

    def do_GET(self) -> None:
        if self._inject_failure() or not self._check_auth():
            return
        path, q = self._parse()
        fs, p = self._split(path)
        if q.get("resource") == "filesystem":
            directory = q.get("directory", "").rstrip("/")
            rec = q.get("recursive") == "true"
            paths = []
            seen_dirs = set()
            for (f2, k) in sorted(self.stub.files):
                if f2 != fs:
                    continue
                if directory and not k.startswith(directory + "/"):
                    continue
                rel = k[len(directory) + 1:] if directory else k
                if not rec and "/" in rel:
                    d = (directory + "/" if directory else "") \
                        + rel.split("/")[0]
                    if d not in seen_dirs:
                        seen_dirs.add(d)
                        paths.append({"name": d, "isDirectory": "true",
                                      "contentLength": "0"})
                    continue
                paths.append({"name": k, "contentLength":
                              str(len(self.stub.files[(f2, k)]))})
            for (f2, d) in sorted(self.stub.dirs):
                if f2 != fs or d in seen_dirs:
                    continue
                if directory and not d.startswith(directory + "/"):
                    continue
                rel = d[len(directory) + 1:] if directory else d
                if not rec and "/" in rel:
                    continue
                paths.append({"name": d, "isDirectory": "true",
                              "contentLength": "0"})
            return self._respond(200, json.dumps(
                {"paths": paths}).encode())
        data = self.stub.files.get((fs, p))
        if data is None:
            return self._err(404, "PathNotFound", p)
        rng = self.headers.get("Range")
        if rng:
            lo, hi = map(int, rng.split("=")[1].split("-"))
            return self._respond(206, data[lo: hi + 1])
        self._respond(200, data)

    def do_HEAD(self) -> None:
        if self._inject_failure() or not self._check_auth():
            return
        path, _q = self._parse()
        fs, p = self._split(path)
        data = self.stub.files.get((fs, p))
        if data is not None:
            return self._respond(200, headers={
                "x-ms-resource-type": "file",
                "Content-Length": str(len(data))})
        if (fs, p.rstrip("/")) in self.stub.dirs or any(
                k2[0] == fs and k2[1].startswith(p.rstrip("/") + "/")
                for k2 in self.stub.files):
            return self._respond(200, headers={
                "x-ms-resource-type": "directory"})
        self._respond(404)

    def do_DELETE(self) -> None:
        if self._inject_failure() or not self._check_auth():
            return
        path, q = self._parse()
        fs, p = self._split(path)
        st = self.stub
        found = False
        if (fs, p) in st.files:
            del st.files[(fs, p)]
            found = True
        if q.get("recursive") == "true":
            pre = p.rstrip("/") + "/"
            for k2 in [k for k in st.files
                       if k[0] == fs and k[1].startswith(pre)]:
                del st.files[k2]
                found = True
        if (fs, p.rstrip("/")) in st.dirs:
            st.dirs.discard((fs, p.rstrip("/")))
            found = True
        if not found:
            return self._err(404, "PathNotFound", p)
        self._respond(200)


class FakeAdlsServer(_BaseServer):
    handler_cls = _AdlsHandler

    def __init__(self, port: int = 0, token: Optional[str] = None):
        self.files: Dict[Tuple[str, str], bytes] = {}
        self.pending: Dict[Tuple[str, str], bytearray] = {}
        self.dirs: set = set()
        super().__init__(port, token=token)
