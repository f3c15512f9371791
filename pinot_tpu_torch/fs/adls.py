"""Azure Data Lake Storage Gen2 PinotFS (dfs REST API), stdlib-only.

Reference analog: pinot-plugins/pinot-file-system/pinot-adls/.../
AzurePinotFS.java + pinot-environment/pinot-azure (the azure-storage
SDK is replaced by a from-scratch client for the public ADLS Gen2
"dfs" endpoint — the hierarchical-namespace Path REST contract).

Protocol implemented:
- create file: PUT ?resource=file, then PATCH ?action=append (chunked,
  position=N) and PATCH ?action=flush&position=total — the Gen2
  three-step write
- read: GET with Range; properties: HEAD (x-ms-* + Content-Length)
- list: GET /{filesystem}?resource=filesystem&directory=&recursive=
  with continuation tokens
- rename: PUT dst with x-ms-rename-source (atomic on HNS accounts)
- delete: DELETE ?recursive=
- bearer-token auth (OAuth) or anonymous against emulators

Paths are scheme-local `filesystem/path...` (abfss://fs@account/path
maps to fs/path).

Port of ``pinot_tpu/fs/adls.py``, unchanged.
"""
from __future__ import annotations

import json
import os
import urllib.parse
from typing import Dict, List, Optional, Tuple

from ..spi.filesystem import PinotFS, register_fs
from .common import (TokenSource, bearer_headers, download_ranged,
                     split_bucket_path, walk_local)
from .rest import RestClient, RestError


class AdlsClient:
    def __init__(self, endpoint_url: str, token: TokenSource = None,
                 timeout: float = 30.0, max_retries: int = 3,
                 backoff: float = 0.2, chunk_size: int = 8 << 20):
        self.rest = RestClient(endpoint_url, timeout=timeout,
                               max_retries=max_retries, backoff=backoff)
        self._token = token
        self.chunk_size = chunk_size

    def _auth(self) -> Dict[str, str]:
        return bearer_headers(self._token)

    @staticmethod
    def _p(fs: str, path: str = "") -> str:
        out = "/" + urllib.parse.quote(fs, safe="")
        if path:
            out += "/" + urllib.parse.quote(path)
        return out

    @staticmethod
    def _check(st: int, body: bytes, ok=(200,)) -> None:
        if st not in ok:
            try:
                err = json.loads(body.decode())["error"]
                msg = f"{err.get('code')}: {err.get('message')}"
            except (ValueError, KeyError, TypeError):
                msg = body.decode(errors="replace")
            raise RestError(st, msg)

    # -- path ops ---------------------------------------------------------

    def create_file(self, fs: str, path: str, data: bytes) -> None:
        import io
        self.create_file_stream(fs, path, io.BytesIO(data))

    def create_file_stream(self, fs: str, path: str, fh) -> None:
        """The Gen2 three-step write (create / chunked append / flush),
        streaming from a file handle — one chunk in memory at a time."""
        st, _h, body = self.rest.request(
            "PUT", self._p(fs, path), query={"resource": "file"},
            headers=self._auth())
        self._check(st, body, ok=(201,))
        pos = 0
        while True:
            chunk = fh.read(self.chunk_size)
            if not chunk:
                break
            # append is NOT idempotent (a blind transport replay after a
            # lost response lands at a stale position and 409s); surface
            # transient failures to the caller instead (rest.py contract:
            # idempotent requests only)
            st, _h, body = self.rest.request(
                "PATCH", self._p(fs, path),
                query={"action": "append", "position": str(pos)},
                headers=self._auth(), body=chunk, retriable=False)
            self._check(st, body, ok=(202,))
            pos += len(chunk)
        st, _h, body = self.rest.request(
            "PATCH", self._p(fs, path),
            query={"action": "flush", "position": str(pos)},
            headers=self._auth())
        self._check(st, body, ok=(200,))

    def mkdirs(self, fs: str, path: str) -> None:
        st, _h, body = self.rest.request(
            "PUT", self._p(fs, path), query={"resource": "directory"},
            headers=self._auth())
        self._check(st, body, ok=(201,))

    def read(self, fs: str, path: str,
             rng: Optional[Tuple[int, int]] = None) -> bytes:
        headers = dict(self._auth())
        if rng is not None:
            headers["Range"] = f"bytes={rng[0]}-{rng[1]}"
        st, _h, body = self.rest.request("GET", self._p(fs, path),
                                         headers=headers)
        self._check(st, body, ok=(200, 206))
        return body

    def properties(self, fs: str, path: str) -> Optional[dict]:
        st, h, _b = self.rest.request("HEAD", self._p(fs, path),
                                      headers=self._auth())
        if st == 404:
            return None
        if st != 200:
            raise RestError(st, "HEAD failed")
        return {"length": int(h.get("content-length", "0")),
                "directory": h.get("x-ms-resource-type") == "directory"}

    def list_paths(self, fs: str, directory: str = "",
                   recursive: bool = False,
                   max_results: Optional[int] = None) -> List[dict]:
        out: List[dict] = []
        token = None
        while True:
            q = {"resource": "filesystem",
                 "recursive": str(recursive).lower()}
            if directory:
                q["directory"] = directory
            if max_results is not None:
                q["maxResults"] = str(max_results)
            if token:
                q["continuation"] = token
            st, h, body = self.rest.request("GET", self._p(fs), query=q,
                                            headers=self._auth())
            self._check(st, body)
            out.extend(json.loads(body.decode()).get("paths", []))
            if max_results is not None and len(out) >= max_results:
                return out
            token = h.get("x-ms-continuation")
            if not token:
                return out

    def rename(self, fs: str, src: str, dst: str) -> None:
        st, _h, body = self.rest.request(
            "PUT", self._p(fs, dst),
            headers={**self._auth(),
                     "x-ms-rename-source": self._p(fs, src)})
        self._check(st, body, ok=(201,))

    def delete(self, fs: str, path: str, recursive: bool = False) -> None:
        st, _h, body = self.rest.request(
            "DELETE", self._p(fs, path),
            query={"recursive": str(recursive).lower()},
            headers=self._auth())
        self._check(st, body, ok=(200, 202))


class AdlsPinotFS(PinotFS):
    """PinotFS over ADLS Gen2 (AzurePinotFS.java analog); paths are
    `filesystem/path...`."""

    DOWNLOAD_CHUNK = 8 << 20

    def __init__(self, client: AdlsClient):
        self.client = client

    @classmethod
    def register(cls, scheme: str = "adl", **kwargs) -> "AdlsPinotFS":
        fs = cls(AdlsClient(**kwargs))
        register_fs(scheme, lambda: fs)
        if scheme == "adl":        # default registration covers all three
            for alias in ("abfs", "abfss"):
                register_fs(alias, lambda: fs)
        return fs

    @staticmethod
    def _split(path: str) -> Tuple[str, str]:
        return split_bucket_path(path, "adls")

    def exists(self, path: str) -> bool:
        fs, p = self._split(path)
        if not p:
            try:
                self.client.list_paths(fs, max_results=1)
                return True
            except RestError as e:
                if e.status == 404:
                    return False
                raise
        return self.client.properties(fs, p) is not None

    def length(self, path: str) -> int:
        fs, p = self._split(path)
        props = self.client.properties(fs, p)
        if props is None:
            raise FileNotFoundError(path)
        return props["length"]

    def mkdir(self, path: str) -> None:
        fs, p = self._split(path)
        if p:
            self.client.mkdirs(fs, p)

    def listdir(self, path: str) -> List[str]:
        fs, p = self._split(path)
        base = p.rstrip("/")
        entries = self.client.list_paths(fs, directory=base)
        out = []
        strip = (base + "/") if base else ""
        for e in entries:
            name = e.get("name", "")
            if strip and name.startswith(strip):
                name = name[len(strip):]
            if name:
                out.append(name.split("/")[0])
        return sorted(set(out))

    def delete(self, path: str, force: bool = False) -> bool:
        fs, p = self._split(path)
        props = self.client.properties(fs, p)
        if props is None:
            return False
        if props["directory"] and not force:
            if self.client.list_paths(fs, directory=p.rstrip("/"),
                                      max_results=1):
                return False
        self.client.delete(fs, p, recursive=True)
        return True

    def move(self, src: str, dst: str) -> None:
        sfs, sp = self._split(src)
        dfs, dp = self._split(dst)
        if sfs != dfs:
            raise ValueError("ADLS rename is filesystem-local; "
                             f"{sfs!r} != {dfs!r}")
        self.client.rename(sfs, sp, dp)

    def copy(self, src: str, dst: str) -> None:
        sfs, sp = self._split(src)
        dfs, dp = self._split(dst)
        props = self.client.properties(sfs, sp)
        if props is None:
            raise FileNotFoundError(src)
        if props["directory"]:
            for e in self.client.list_paths(sfs, directory=sp.rstrip("/"),
                                            recursive=True):
                if e.get("isDirectory") in (True, "true"):
                    continue
                rel = e["name"][len(sp.rstrip("/")) + 1:]
                self.copy(f"{sfs}/{e['name']}",
                          f"{dfs}/{dp.rstrip('/')}/{rel}")
            return
        data = self.client.read(sfs, sp)
        self.client.create_file(dfs, dp, data)

    def copy_from_local(self, local_src: str, dst: str) -> None:
        fs, p = self._split(dst)
        if os.path.isdir(local_src):
            for full, rel in walk_local(local_src):
                self.copy_from_local(full, f"{fs}/{p.rstrip('/')}/{rel}")
            return
        with open(local_src, "rb") as fh:
            self.client.create_file_stream(fs, p, fh)

    def copy_to_local(self, src: str, local_dst: str) -> None:
        fs, p = self._split(src)
        size = self.length(src)
        download_ranged(
            lambda lo, hi: self.client.read(fs, p, (lo, hi)),
            size, local_dst, self.DOWNLOAD_CHUNK)
