"""Shared stdlib HTTP transport for the object-store PinotFS clients.

Port of ``pinot_tpu/fs/rest.py``, unchanged. In the port its one user so
far is the Kinesis client (``realtime/kinesis.py``), which retries and
re-signs itself and so runs this transport with ``max_retries=0``.

The S3 client (fs/s3.py) carries its own connection handling because
SigV4 signs per-attempt; the GCS / WebHDFS / ADLS clients share this
one: bounded retries with exponential backoff on 5xx/connection errors
(idempotent requests only), optional redirect capture (WebHDFS's
two-step CREATE/OPEN handshake returns 307s that must NOT be followed
blindly — the data request goes to the redirect target with a body).
"""
from __future__ import annotations

import http.client
import time
import urllib.parse
from typing import Dict, Optional, Tuple


class RestError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message[:300]}")
        self.status = status


class RestClient:
    """One origin; request() takes an absolute path + query."""

    def __init__(self, endpoint_url: str, timeout: float = 30.0,
                 max_retries: int = 3, backoff: float = 0.2,
                 headers: Optional[Dict[str, str]] = None):
        p = urllib.parse.urlparse(endpoint_url)
        if p.scheme not in ("http", "https"):
            raise ValueError(f"endpoint needs http(s): {endpoint_url}")
        self.secure = p.scheme == "https"
        self.host = p.hostname or ""
        self.port = p.port or (443 if self.secure else 80)
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff = backoff
        self.base_headers = dict(headers or {})

    def request(self, method: str, path: str,
                query: Optional[Dict[str, str]] = None,
                headers: Optional[Dict[str, str]] = None,
                body: bytes = b"", retriable: bool = True
                ) -> Tuple[int, Dict[str, str], bytes]:
        qs = urllib.parse.urlencode(sorted((query or {}).items()))
        full = path + (("?" + qs) if qs else "")
        hdrs = {**self.base_headers, **(headers or {})}
        attempts = self.max_retries if retriable else 0
        conn_cls = (http.client.HTTPSConnection if self.secure
                    else http.client.HTTPConnection)
        for attempt in range(attempts + 1):
            conn = conn_cls(self.host, self.port, timeout=self.timeout)
            try:
                conn.request(method, full, body=body, headers=hdrs)
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
