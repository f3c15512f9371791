"""HDFS PinotFS over the WebHDFS REST API, stdlib-only.

Reference analog: pinot-plugins/pinot-file-system/pinot-hdfs/.../
HadoopPinotFS.java (the hadoop-client FileSystem is replaced by
WebHDFS — the REST gateway every namenode ships; a public, stable
contract since Hadoop 1.x).

Protocol notes implemented faithfully:
- CREATE and OPEN are TWO-STEP: the namenode answers 307 with a
  Location pointing at a datanode; the client re-issues the request
  (with the body / for the bytes) against that location. The stub
  test server exercises the same redirect handshake.
- APPEND is not needed (segments upload whole); RENAME, DELETE
  (recursive), MKDIRS, LISTSTATUS, GETFILESTATUS cover the PinotFS
  surface. user.name query auth (simple auth), as Hadoop defaults to.

Paths are plain absolute paths under hdfs:// (scheme-local).

Port of ``pinot_tpu/fs/hdfs.py``, unchanged.
"""
from __future__ import annotations

import json
import os
import urllib.parse
from typing import Dict, List, Optional, Tuple

from ..spi.filesystem import PinotFS, register_fs
from .common import walk_local
from .rest import RestClient, RestError


class WebHdfsClient:
    def __init__(self, endpoint_url: str, user: str = "pinot",
                 timeout: float = 30.0, max_retries: int = 3,
                 backoff: float = 0.2):
        self.rest = RestClient(endpoint_url, timeout=timeout,
                               max_retries=max_retries, backoff=backoff)
        self.user = user

    def _q(self, op: str, **extra: str) -> Dict[str, str]:
        q = {"op": op, "user.name": self.user}
        q.update(extra)
        return q

    @staticmethod
    def _path(path: str) -> str:
        if not path.startswith("/"):
            path = "/" + path
        return "/webhdfs/v1" + urllib.parse.quote(path)

    @staticmethod
    def _check(st: int, body: bytes, ok=(200,)) -> None:
        if st not in ok:
            try:
                exc = json.loads(body.decode())["RemoteException"]
                msg = f"{exc.get('exception')}: {exc.get('message')}"
            except (ValueError, KeyError, TypeError):
                msg = body.decode(errors="replace")
            raise RestError(st, msg)

    def _redirected(self, method: str, path: str, q: Dict[str, str],
                    body: bytes = b"") -> Tuple[int, bytes]:
        """The namenode 307 handshake: re-issue against Location."""
        st, h, resp = self.rest.request(method, path, query=q,
                                        retriable=not body)
        if st == 307:
            loc = urllib.parse.urlparse(h.get("location", ""))
            q2 = dict(urllib.parse.parse_qsl(loc.query))
            st, _h, resp = self.rest.request(
                method, loc.path, query=q2, body=body,
                headers={"Content-Type": "application/octet-stream"},
                retriable=not body)
        return st, resp

    # -- file ops ---------------------------------------------------------

    def create(self, path: str, data: bytes,
               overwrite: bool = True) -> None:
        st, body = self._redirected(
            "PUT", self._path(path),
            self._q("CREATE", overwrite=str(overwrite).lower()), data)
        self._check(st, body, ok=(200, 201))

    def open(self, path: str, offset: Optional[int] = None,
             length: Optional[int] = None) -> bytes:
        extra: Dict[str, str] = {}
        if offset is not None:
            extra["offset"] = str(offset)
        if length is not None:
            extra["length"] = str(length)
        st, body = self._redirected("GET", self._path(path),
                                    self._q("OPEN", **extra))
        self._check(st, body)
        return body

    def status(self, path: str) -> Optional[dict]:
        st, _h, body = self.rest.request(
            "GET", self._path(path), query=self._q("GETFILESTATUS"))
        if st == 404:
            return None
        self._check(st, body)
        return json.loads(body.decode())["FileStatus"]

    def list_status(self, path: str) -> List[dict]:
        st, _h, body = self.rest.request(
            "GET", self._path(path), query=self._q("LISTSTATUS"))
        self._check(st, body)
        return json.loads(body.decode())["FileStatuses"]["FileStatus"]

    def mkdirs(self, path: str) -> None:
        st, _h, body = self.rest.request(
            "PUT", self._path(path), query=self._q("MKDIRS"))
        self._check(st, body)

    def rename(self, src: str, dst: str) -> bool:
        st, _h, body = self.rest.request(
            "PUT", self._path(src),
            query=self._q("RENAME", destination=dst))
        self._check(st, body)
        return bool(json.loads(body.decode()).get("boolean"))

    def delete(self, path: str, recursive: bool = False) -> bool:
        st, _h, body = self.rest.request(
            "DELETE", self._path(path),
            query=self._q("DELETE", recursive=str(recursive).lower()))
        self._check(st, body)
        return bool(json.loads(body.decode()).get("boolean"))


class HdfsPinotFS(PinotFS):
    """PinotFS over WebHDFS (HadoopPinotFS.java analog)."""

    DOWNLOAD_CHUNK = 8 << 20

    def __init__(self, client: WebHdfsClient):
        self.client = client

    @classmethod
    def register(cls, **kwargs) -> "HdfsPinotFS":
        fs = cls(WebHdfsClient(**kwargs))
        register_fs("hdfs", lambda: fs)
        return fs

    def exists(self, path: str) -> bool:
        return self.client.status(path) is not None

    def length(self, path: str) -> int:
        st = self.client.status(path)
        if st is None:
            raise FileNotFoundError(path)
        return int(st.get("length", 0))

    def mkdir(self, path: str) -> None:
        self.client.mkdirs(path)

    def listdir(self, path: str) -> List[str]:
        return sorted(s["pathSuffix"] for s in
                      self.client.list_status(path) if s["pathSuffix"])

    def delete(self, path: str, force: bool = False) -> bool:
        st = self.client.status(path)
        if st is None:
            return False
        if st.get("type") == "DIRECTORY" and not force:
            kids = self.client.list_status(path)
            if kids:
                return False
        return self.client.delete(path, recursive=True)

    def move(self, src: str, dst: str) -> None:
        if not self.client.rename(src, dst):
            raise OSError(f"rename failed: {src} -> {dst}")

    def copy(self, src: str, dst: str) -> None:
        st = self.client.status(src)
        if st is None:
            raise FileNotFoundError(src)
        if st.get("type") == "DIRECTORY":
            self.client.mkdirs(dst)
            for s in self.client.list_status(src):
                self.copy(f"{src.rstrip('/')}/{s['pathSuffix']}",
                          f"{dst.rstrip('/')}/{s['pathSuffix']}")
            return
        self.client.create(dst, self.client.open(src))

    def copy_from_local(self, local_src: str, dst: str) -> None:
        if os.path.isdir(local_src):
            self.client.mkdirs(dst)
            for full, rel in walk_local(local_src):
                self.copy_from_local(full, f"{dst.rstrip('/')}/{rel}")
            return
        with open(local_src, "rb") as fh:
            self.client.create(dst, fh.read())

    def copy_to_local(self, src: str, local_dst: str) -> None:
        from .common import download_ranged
        size = self.length(src)
        download_ranged(
            lambda lo, hi: self.client.open(src, offset=lo,
                                            length=hi - lo + 1),
            size, local_dst, self.DOWNLOAD_CHUNK)
