"""Google Cloud Storage PinotFS over the public JSON API, stdlib-only.

Reference analog: pinot-plugins/pinot-file-system/pinot-gcs/.../
GcsPinotFS.java (the google-cloud-storage SDK client is replaced by a
from-scratch REST client — the JSON API is a public, stable contract).

Client features:
- media upload below the chunk size, RESUMABLE upload above it
  (POST uploadType=resumable -> session URI -> chunked PUTs with
  Content-Range, 308 Resume Incomplete handshake)
- ranged GET (alt=media) streaming downloads
- objects.list with prefix/delimiter + pageToken continuation
- server-side rewrite (objects.rewriteTo, following rewriteToken)
- bearer-token auth (static token or a callable for metadata-server
  style refresh); anonymous against emulators
- bounded retries with exponential backoff on 5xx/connection errors

Paths are scheme-local `bucket/object...` (gs://bucket/obj);
directories are prefixes, exactly like the S3 mapping.

Port of ``pinot_tpu/fs/gcs.py``, unchanged.
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


def _committed_end(range_header: Optional[str]) -> int:
    """Last byte index the service persisted, from a 308 Range header
    ('bytes=0-N'); -1 when absent (nothing persisted — resend from 0)."""
    if not range_header:
        return -1
    try:
        return int(range_header.split("-")[-1])
    except ValueError:
        return -1


class GcsClient:
    def __init__(self, endpoint_url: str, token: TokenSource = None,
                 timeout: float = 30.0, max_retries: int = 3,
                 backoff: float = 0.2, chunk_size: int = 8 << 20):
        self.rest = RestClient(endpoint_url, timeout=timeout,
                               max_retries=max_retries, backoff=backoff)
        self._token = token
        # resumable chunks must be 256 KiB multiples (API contract)
        self.chunk_size = max(chunk_size - chunk_size % (256 << 10),
                              256 << 10)

    def _auth(self) -> Dict[str, str]:
        return bearer_headers(self._token)

    @staticmethod
    def _obj_path(bucket: str, obj: str) -> str:
        return (f"/storage/v1/b/{urllib.parse.quote(bucket, safe='')}"
                f"/o/{urllib.parse.quote(obj, safe='')}")

    def _check(self, st: int, body: bytes, ok=(200,)) -> None:
        if st not in ok:
            try:
                msg = json.loads(body.decode())["error"]["message"]
            except (ValueError, KeyError, TypeError):
                msg = body.decode(errors="replace")
            raise RestError(st, msg)

    # -- object ops -------------------------------------------------------

    def upload(self, bucket: str, obj: str, data: bytes) -> None:
        path = (f"/upload/storage/v1/b/"
                f"{urllib.parse.quote(bucket, safe='')}/o")
        st, _h, body = self.rest.request(
            "POST", path, query={"uploadType": "media", "name": obj},
            headers={**self._auth(),
                     "Content-Type": "application/octet-stream"},
            body=data)
        self._check(st, body)

    def upload_stream(self, bucket: str, obj: str, fh, total: int) -> None:
        """Resumable upload streaming from a file handle — never holds
        more than one chunk in memory: one POST (no body) -> session
        URI -> chunked PUTs with Content-Range; the final chunk carries
        the total size."""
        path = (f"/upload/storage/v1/b/"
                f"{urllib.parse.quote(bucket, safe='')}/o")
        st, h, body = self.rest.request(
            "POST", path, query={"uploadType": "resumable", "name": obj},
            headers={**self._auth(),
                     "x-upload-content-type": "application/octet-stream"},
            retriable=False)
        self._check(st, body)
        loc = h.get("location", "")
        q = dict(urllib.parse.parse_qsl(urllib.parse.urlparse(loc).query))
        upath = urllib.parse.urlparse(loc).path
        pos = 0
        while pos < total:
            chunk = fh.read(min(self.chunk_size, total - pos))
            end = pos + len(chunk) - 1
            st, h, body = self.rest.request(
                "PUT", upath, query=q,
                headers={**self._auth(),
                         "Content-Range": f"bytes {pos}-{end}/{total}"},
                body=chunk)
            if st == 308:
                # the 308 Range header reports how much the service
                # PERSISTED — possibly less than the chunk sent, on ANY
                # chunk including the final one (the resumable
                # protocol's whole point); resume from there, never past
                committed = _committed_end(h.get("range"))
                if committed + 1 >= total:
                    # every byte persisted but the session didn't
                    # finalize: a zero-byte status-query PUT
                    # (Content-Range 'bytes */total') must complete it —
                    # returning here without a 200/201 would report
                    # success for an object that may not exist
                    st, _h2, body = self.rest.request(
                        "PUT", upath, query=q,
                        headers={**self._auth(),
                                 "Content-Range": f"bytes */{total}"})
                    self._check(st, body, ok=(200, 201))
                    return
                if committed + 1 != end + 1:
                    fh.seek(committed + 1)
                pos = committed + 1
                continue
            # non-308: only a completed upload is acceptable, and only
            # on the final chunk
            if end + 1 < total:
                self._check(st, body, ok=(308,))
            else:
                self._check(st, body, ok=(200, 201))
            pos = end + 1

    def download(self, bucket: str, obj: str,
                 rng: Optional[Tuple[int, int]] = None) -> bytes:
        headers = dict(self._auth())
        if rng is not None:
            headers["Range"] = f"bytes={rng[0]}-{rng[1]}"
        st, _h, body = self.rest.request(
            "GET", self._obj_path(bucket, obj), query={"alt": "media"},
            headers=headers)
        self._check(st, body, ok=(200, 206))
        return body

    def stat(self, bucket: str, obj: str) -> Optional[int]:
        """Object size, or None when absent."""
        st, _h, body = self.rest.request(
            "GET", self._obj_path(bucket, obj), headers=self._auth())
        if st == 404:
            return None
        self._check(st, body)
        return int(json.loads(body.decode()).get("size", 0))

    def delete(self, bucket: str, obj: str) -> None:
        st, _h, body = self.rest.request(
            "DELETE", self._obj_path(bucket, obj), headers=self._auth())
        self._check(st, body, ok=(200, 204))

    def rewrite(self, sb: str, so: str, db: str, do: str) -> None:
        path = (self._obj_path(sb, so)
                + f"/rewriteTo/b/{urllib.parse.quote(db, safe='')}"
                f"/o/{urllib.parse.quote(do, safe='')}")
        token = None
        while True:
            q = {"rewriteToken": token} if token else {}
            st, _h, body = self.rest.request(
                "POST", path, query=q, headers=self._auth())
            self._check(st, body)
            res = json.loads(body.decode())
            if res.get("done", True):
                return
            token = res.get("rewriteToken")

    def list_objects(self, bucket: str, prefix: str = "",
                     delimiter: str = "",
                     max_results: Optional[int] = None
                     ) -> Tuple[List[Tuple[str, int]], List[str]]:
        keys: List[Tuple[str, int]] = []
        prefixes: List[str] = []
        seen = set()
        token = None
        path = f"/storage/v1/b/{urllib.parse.quote(bucket, safe='')}/o"
        while True:
            q: Dict[str, str] = {"prefix": prefix}
            if delimiter:
                q["delimiter"] = delimiter
            if max_results is not None:
                q["maxResults"] = str(max_results)
            if token:
                q["pageToken"] = token
            st, _h, body = self.rest.request("GET", path, query=q,
                                             headers=self._auth())
            self._check(st, body)
            res = json.loads(body.decode())
            for it in res.get("items", []):
                keys.append((it["name"], int(it.get("size", 0))))
            for p in res.get("prefixes", []):
                if p not in seen:
                    seen.add(p)
                    prefixes.append(p)
            if max_results is not None and \
                    len(keys) + len(prefixes) >= max_results:
                return keys, prefixes
            token = res.get("nextPageToken")
            if not token:
                return keys, prefixes


class GcsPinotFS(PinotFS):
    """PinotFS over GCS (GcsPinotFS.java analog); paths `bucket/obj`."""

    DOWNLOAD_CHUNK = 8 << 20

    def __init__(self, client: GcsClient):
        self.client = client

    @classmethod
    def register(cls, **kwargs) -> "GcsPinotFS":
        fs = cls(GcsClient(**kwargs))
        register_fs("gs", lambda: fs)
        return fs

    @staticmethod
    def _split(path: str) -> Tuple[str, str]:
        return split_bucket_path(path, "gs")

    def exists(self, path: str) -> bool:
        bucket, obj = self._split(path)
        if not obj:
            try:
                self.client.list_objects(bucket, max_results=1)
                return True
            except RestError as e:
                if e.status == 404:
                    return False
                raise
        if self.client.stat(bucket, obj) is not None:
            return True
        keys, prefixes = self.client.list_objects(
            bucket, prefix=obj.rstrip("/") + "/", delimiter="/",
            max_results=1)
        return bool(keys or prefixes)

    def length(self, path: str) -> int:
        bucket, obj = self._split(path)
        n = self.client.stat(bucket, obj)
        if n is None:
            raise FileNotFoundError(path)
        return n

    def mkdir(self, path: str) -> None:
        pass  # prefixes are implicit

    def listdir(self, path: str) -> List[str]:
        bucket, obj = self._split(path)
        prefix = obj.rstrip("/") + "/" if obj else ""
        keys, prefixes = self.client.list_objects(bucket, prefix=prefix,
                                                  delimiter="/")
        names = [k[len(prefix):] for k, _s in keys if k != prefix]
        names += [p[len(prefix):].rstrip("/") for p in prefixes]
        return sorted(n for n in names if n)

    def delete(self, path: str, force: bool = False) -> bool:
        bucket, obj = self._split(path)
        if self.client.stat(bucket, obj) is not None:
            self.client.delete(bucket, obj)
            return True
        keys, _p = self.client.list_objects(bucket,
                                            prefix=obj.rstrip("/") + "/")
        if not keys or not force:
            return False
        for k, _s in keys:
            self.client.delete(bucket, k)
        return True

    def copy(self, src: str, dst: str) -> None:
        sb, so = self._split(src)
        db, do = self._split(dst)
        if self.client.stat(sb, so) is not None:
            self.client.rewrite(sb, so, db, do)
            return
        prefix = so.rstrip("/") + "/"
        keys, _p = self.client.list_objects(sb, prefix=prefix)
        if not keys:
            raise FileNotFoundError(src)
        for k, _s in keys:
            self.client.rewrite(sb, k, db,
                                do.rstrip("/") + "/" + k[len(prefix):])

    def move(self, src: str, dst: str) -> None:
        self.copy(src, dst)
        self.delete(src, force=True)

    def copy_from_local(self, local_src: str, dst: str) -> None:
        bucket, obj = self._split(dst)
        if os.path.isdir(local_src):
            for full, rel in walk_local(local_src):
                self.copy_from_local(
                    full, f"{bucket}/{obj.rstrip('/')}/{rel}")
            return
        size = os.path.getsize(local_src)
        with open(local_src, "rb") as fh:
            if size <= self.client.chunk_size:
                self.client.upload(bucket, obj, fh.read())
            else:
                self.client.upload_stream(bucket, obj, fh, size)

    def copy_to_local(self, src: str, local_dst: str) -> None:
        bucket, obj = self._split(src)
        size = self.client.stat(bucket, obj)
        if size is None:
            raise FileNotFoundError(src)
        download_ranged(
            lambda lo, hi: self.client.download(bucket, obj, (lo, hi)),
            size, local_dst, self.DOWNLOAD_CHUNK)
