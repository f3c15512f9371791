"""AWS Signature Version 4 for S3-compatible REST APIs.

Port of the signing part of ``pinot_tpu/fs/s3.py`` (``S3Error``,
``_uri_encode``, ``_hmac``, ``sigv4_headers``), unchanged, so a request
signed by either package carries the same headers. The port's Kinesis
client signs with it (service "kinesis"). ``S3Client`` and
``S3PinotFS`` come with the cluster plane.
"""
from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from typing import Dict

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
