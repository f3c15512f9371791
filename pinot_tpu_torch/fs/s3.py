"""S3-compatible object-store PinotFS, stdlib-only.

Port of ``pinot_tpu/fs/s3.py``, unchanged: the SigV4 signer, the REST
client and the PinotFS (the S3PinotFS.java:90 analog, with the AWS SDK
replaced by a REST client over the public S3 API and AWS Signature
Version 4, which any S3-compatible store speaks). A request signed by
either package carries the same headers; the port's Kinesis client signs
with the same function (service "kinesis").

Client features:
- AWS Signature V4 signing (canonical request -> string-to-sign -> HMAC
  chain); x-amz-content-sha256 carries the real SHA-256
- path-style addressing against any endpoint (endpoint_url config)
- ranged GET streaming for downloads, single-PUT below the part size,
  multipart upload (CreateMultipartUpload / UploadPart /
  CompleteMultipartUpload, abort on failure) above it
- ListObjectsV2 with prefix/delimiter + continuation tokens
- server-side copy (x-amz-copy-source) for move/copy
- bounded retries with exponential backoff on 5xx/connection errors
  (idempotent requests only)

The PinotFS mapping treats `s3://bucket/key...` scheme-local paths as
`bucket/key`; directories are prefixes (mkdir is a no-op, exists on a
prefix checks for any object under it), matching S3PinotFS semantics.
"""
from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import os
import time
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Dict, Iterator, List, Optional, Tuple

from ..spi.filesystem import PinotFS, register_fs

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


class S3Error(Exception):
    def __init__(self, status: int, code: str, message: str):
        super().__init__(f"S3 error {status} {code}: {message}")
        self.status = status
        self.code = code


# ---------------------------------------------------------------------------
# SigV4
# ---------------------------------------------------------------------------

def _uri_encode(s: str, encode_slash: bool) -> str:
    safe = "~" if encode_slash else "~/"
    return urllib.parse.quote(s, safe=safe)


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_headers(method: str, host: str, uri: str,
                  query: Dict[str, str], headers: Dict[str, str],
                  payload_sha256: str, access_key: str, secret_key: str,
                  region: str, amz_date: str,
                  service: str = "s3") -> Dict[str, str]:
    """AWS Signature Version 4 over the given request; returns the
    headers to send (input headers + host/x-amz-date/x-amz-content-
    sha256/Authorization). amz_date: YYYYMMDDTHHMMSSZ."""
    date = amz_date[:8]
    all_headers = dict(headers)
    all_headers["host"] = host
    all_headers["x-amz-date"] = amz_date
    all_headers["x-amz-content-sha256"] = payload_sha256

    canon_q = "&".join(
        f"{_uri_encode(k, True)}={_uri_encode(v, True)}"
        for k, v in sorted(query.items()))
    lower = {k.lower(): " ".join(v.split()) for k, v in all_headers.items()}
    signed = ";".join(sorted(lower))
    canon_h = "".join(f"{k}:{lower[k]}\n" for k in sorted(lower))
    canon_req = "\n".join([method, _uri_encode(uri, False), canon_q,
                           canon_h, signed, payload_sha256])
    scope = f"{date}/{region}/{service}/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(canon_req.encode()).hexdigest()])
    k = _hmac(("AWS4" + secret_key).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    all_headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={sig}")
    return all_headers


# ---------------------------------------------------------------------------
# REST client
# ---------------------------------------------------------------------------

class S3Client:
    """Minimal S3 REST client (path-style) with SigV4 + retries."""

    def __init__(self, endpoint_url: str, access_key: str = "",
                 secret_key: str = "", region: str = "us-east-1",
                 timeout: float = 30.0, max_retries: int = 3,
                 backoff: float = 0.2, part_size: int = 8 << 20):
        p = urllib.parse.urlparse(endpoint_url)
        if p.scheme not in ("http", "https"):
            raise ValueError(f"endpoint_url needs http(s): {endpoint_url}")
        self.secure = p.scheme == "https"
        self.host = p.hostname or ""
        self.port = p.port or (443 if self.secure else 80)
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff = backoff
        self.part_size = max(part_size, 5 << 20)  # S3 minimum part size

    def _host_header(self) -> str:
        default = 443 if self.secure else 80
        return self.host if self.port == default \
            else f"{self.host}:{self.port}"

    def request(self, method: str, bucket: str, key: str = "",
                query: Optional[Dict[str, str]] = None,
                headers: Optional[Dict[str, str]] = None,
                body: bytes = b"", retriable: bool = True
                ) -> Tuple[int, Dict[str, str], bytes]:
        query = query or {}
        uri = "/" + bucket + (("/" + key) if key else "")
        payload_hash = hashlib.sha256(body).hexdigest() if body \
            else _EMPTY_SHA256
        attempts = self.max_retries if retriable else 0
        for attempt in range(attempts + 1):
            amz_date = datetime.datetime.now(datetime.timezone.utc)\
                .strftime("%Y%m%dT%H%M%SZ")
            hdrs = sigv4_headers(method, self._host_header(), uri, query,
                                 headers or {}, payload_hash,
                                 self.access_key, self.secret_key,
                                 self.region, amz_date)
            qs = urllib.parse.urlencode(sorted(query.items()))
            path = _uri_encode(uri, False) + (("?" + qs) if qs else "")
            conn_cls = (http.client.HTTPSConnection if self.secure
                        else http.client.HTTPConnection)
            conn = conn_cls(self.host, self.port, timeout=self.timeout)
            try:
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
                rh = {k.lower(): v for k, v in resp.getheaders()}
                if resp.status >= 500 and attempt < attempts:
                    time.sleep(self.backoff * (2 ** attempt))
                    continue
                return resp.status, rh, data
            except (ConnectionError, OSError, http.client.HTTPException):
                if attempt == attempts:
                    raise
                time.sleep(self.backoff * (2 ** attempt))
            finally:
                conn.close()
        raise AssertionError("unreachable")

    @staticmethod
    def _raise_for(status: int, body: bytes) -> None:
        code, msg = "Unknown", ""
        try:
            root = ET.fromstring(body.decode() or "<Error/>")
            code = root.findtext("Code") or code
            msg = root.findtext("Message") or ""
        except ET.ParseError:
            pass
        raise S3Error(status, code, msg)

    # -- object ops -------------------------------------------------------

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        # non-retriable at this layer only for conservative semantics?
        # PUT object IS idempotent (full overwrite), so retries are safe
        st, _h, body = self.request("PUT", bucket, key, body=data)
        if st != 200:
            self._raise_for(st, body)

    def get_object(self, bucket: str, key: str,
                   rng: Optional[Tuple[int, int]] = None) -> bytes:
        headers = {}
        if rng is not None:
            headers["range"] = f"bytes={rng[0]}-{rng[1]}"
        st, _h, body = self.request("GET", bucket, key, headers=headers)
        if st not in (200, 206):
            self._raise_for(st, body)
        return body

    def head_object(self, bucket: str, key: str) -> Optional[int]:
        """Content length, or None when absent."""
        st, h, _b = self.request("HEAD", bucket, key)
        if st == 200:
            return int(h.get("content-length", "0"))
        if st == 404:
            return None
        self._raise_for(st, _b)

    def delete_object(self, bucket: str, key: str) -> None:
        st, _h, body = self.request("DELETE", bucket, key)
        if st not in (200, 204):
            self._raise_for(st, body)

    def copy_object(self, src_bucket: str, src_key: str, dst_bucket: str,
                    dst_key: str) -> None:
        src = _uri_encode(f"/{src_bucket}/{src_key}", False)
        st, _h, body = self.request("PUT", dst_bucket, dst_key,
                                    headers={"x-amz-copy-source": src})
        if st != 200:
            self._raise_for(st, body)

    def list_objects(self, bucket: str, prefix: str = "",
                     delimiter: str = "",
                     max_keys: Optional[int] = None
                     ) -> Tuple[List[Tuple[str, int]], List[str]]:
        """-> ([(key, size)], [deduped common prefixes]); follows
        continuation tokens (ListObjectsV2). max_keys bounds the TOTAL
        entries fetched (existence probes pass 1 — no full-bucket
        crawl)."""
        keys: List[Tuple[str, int]] = []
        prefixes: List[str] = []
        seen_prefixes = set()
        token = None
        while True:
            q = {"list-type": "2", "prefix": prefix}
            if delimiter:
                q["delimiter"] = delimiter
            if max_keys is not None:
                q["max-keys"] = str(max_keys)
            if token:
                q["continuation-token"] = token
            st, _h, body = self.request("GET", bucket, query=q)
            if st != 200:
                self._raise_for(st, body)
            ns = ""
            root = ET.fromstring(body.decode())
            if root.tag.startswith("{"):
                ns = root.tag[: root.tag.index("}") + 1]
            for c in root.findall(f"{ns}Contents"):
                keys.append((c.findtext(f"{ns}Key"),
                             int(c.findtext(f"{ns}Size") or 0)))
            for c in root.findall(f"{ns}CommonPrefixes"):
                p = c.findtext(f"{ns}Prefix")
                if p not in seen_prefixes:   # dedup across pages
                    seen_prefixes.add(p)
                    prefixes.append(p)
            if max_keys is not None and \
                    len(keys) + len(prefixes) >= max_keys:
                return keys, prefixes
            if (root.findtext(f"{ns}IsTruncated") or "false") != "true":
                return keys, prefixes
            token = root.findtext(f"{ns}NextContinuationToken")
            if not token:
                return keys, prefixes

    # -- multipart --------------------------------------------------------

    def multipart_upload(self, bucket: str, key: str,
                         parts: Iterator[bytes]) -> None:
        # initiate/complete POSTs are NOT idempotent (a retried initiate
        # leaks an orphan upload; a retried complete after a lost 200
        # 404s on an already-committed object): retriable=False, the
        # caller sees transient failures. UploadPart PUTs stay retriable.
        st, _h, body = self.request("POST", bucket, key,
                                    query={"uploads": ""},
                                    retriable=False)
        if st != 200:
            self._raise_for(st, body)
        root = ET.fromstring(body.decode())
        ns = root.tag[: root.tag.index("}") + 1] \
            if root.tag.startswith("{") else ""
        upload_id = root.findtext(f"{ns}UploadId")
        etags: List[Tuple[int, str]] = []
        try:
            for n, part in enumerate(parts, start=1):
                st, h, body = self.request(
                    "PUT", bucket, key,
                    query={"partNumber": str(n), "uploadId": upload_id},
                    body=part)
                if st != 200:
                    self._raise_for(st, body)
                etags.append((n, h.get("etag", "")))
            xml_parts = "".join(
                f"<Part><PartNumber>{n}</PartNumber>"
                f"<ETag>{e}</ETag></Part>" for n, e in etags)
            done = (f"<CompleteMultipartUpload>{xml_parts}"
                    "</CompleteMultipartUpload>").encode()
            st, _h, body = self.request(
                "POST", bucket, key, query={"uploadId": upload_id},
                body=done, retriable=False)
            if st != 200:
                self._raise_for(st, body)
        except BaseException:
            # abort so the store doesn't accrete orphaned part uploads
            self.request("DELETE", bucket, key,
                         query={"uploadId": upload_id})
            raise


# ---------------------------------------------------------------------------
# the PinotFS
# ---------------------------------------------------------------------------

class S3PinotFS(PinotFS):
    """PinotFS over an S3-compatible store (S3PinotFS.java:90 analog).

    Paths are scheme-local `bucket/key...`. Register for `s3://` URIs:

        S3PinotFS.register(endpoint_url="http://127.0.0.1:9000",
                           access_key="ak", secret_key="sk")
    """

    # streaming chunk for ranged downloads
    DOWNLOAD_CHUNK = 8 << 20

    def __init__(self, client: S3Client):
        self.client = client

    @classmethod
    def register(cls, **kwargs) -> "S3PinotFS":
        fs = cls(S3Client(**kwargs))
        register_fs("s3", lambda: fs)
        return fs

    @staticmethod
    def _split(path: str) -> Tuple[str, str]:
        from .common import split_bucket_path
        return split_bucket_path(path, "s3")

    def exists(self, path: str) -> bool:
        bucket, key = self._split(path)
        if not key:
            # bucket existence: a bounded 1-entry probe; NoSuchBucket ->
            # False, any listable bucket (even empty) -> True
            try:
                self.client.list_objects(bucket, max_keys=1)
                return True
            except S3Error as e:
                if e.code == "NoSuchBucket" or e.status == 404:
                    return False
                raise
        if self.client.head_object(bucket, key) is not None:
            return True
        keys, prefixes = self.client.list_objects(
            bucket, prefix=key.rstrip("/") + "/", delimiter="/",
            max_keys=1)
        return bool(keys or prefixes)

    def length(self, path: str) -> int:
        bucket, key = self._split(path)
        n = self.client.head_object(bucket, key)
        if n is None:
            raise FileNotFoundError(path)
        return n

    def mkdir(self, path: str) -> None:
        pass  # prefixes are implicit

    def listdir(self, path: str) -> List[str]:
        bucket, key = self._split(path)
        prefix = key.rstrip("/") + "/" if key else ""
        keys, prefixes = self.client.list_objects(bucket, prefix=prefix,
                                                  delimiter="/")
        names = [k[len(prefix):] for k, _s in keys if k != prefix]
        names += [p[len(prefix):].rstrip("/") for p in prefixes]
        return sorted(n for n in names if n)

    def delete(self, path: str, force: bool = False) -> bool:
        bucket, key = self._split(path)
        if self.client.head_object(bucket, key) is not None:
            self.client.delete_object(bucket, key)
            return True
        prefix = key.rstrip("/") + "/"
        keys, _p = self.client.list_objects(bucket, prefix=prefix)
        if not keys:
            return False
        if not force:
            return False
        for k, _s in keys:
            self.client.delete_object(bucket, k)
        return True

    def copy(self, src: str, dst: str) -> None:
        sb, sk = self._split(src)
        db, dk = self._split(dst)
        if self.client.head_object(sb, sk) is not None:
            self.client.copy_object(sb, sk, db, dk)
            return
        prefix = sk.rstrip("/") + "/"
        keys, _p = self.client.list_objects(sb, prefix=prefix)
        if not keys:
            raise FileNotFoundError(src)
        for k, _s in keys:
            self.client.copy_object(sb, k, db,
                                    dk.rstrip("/") + "/" + k[len(prefix):])

    def move(self, src: str, dst: str) -> None:
        self.copy(src, dst)
        self.delete(src, force=True)

    def copy_from_local(self, local_src: str, dst: str) -> None:
        from .common import iter_file_chunks, walk_local
        bucket, key = self._split(dst)
        if os.path.isdir(local_src):
            for full, rel in walk_local(local_src):
                self.copy_from_local(
                    full, f"{bucket}/{key.rstrip('/')}/{rel}")
            return
        size = os.path.getsize(local_src)
        with open(local_src, "rb") as fh:
            if size <= self.client.part_size:
                self.client.put_object(bucket, key, fh.read())
            else:
                self.client.multipart_upload(
                    bucket, key,
                    iter_file_chunks(fh, self.client.part_size))

    def copy_to_local(self, src: str, local_dst: str) -> None:
        from .common import download_ranged
        bucket, key = self._split(src)
        size = self.client.head_object(bucket, key)
        if size is None:
            raise FileNotFoundError(src)
        download_ranged(
            lambda lo, hi: self.client.get_object(bucket, key, (lo, hi)),
            size, local_dst, self.DOWNLOAD_CHUNK)
