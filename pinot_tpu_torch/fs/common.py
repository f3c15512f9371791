"""Shared helpers for the object-store PinotFS plugins.

Port of ``pinot_tpu/fs/common.py``, unchanged. The four filesystems
(S3, GCS, ADLS, HDFS) share the local-tree upload recursion, the chunked
ranged-download loop, the bucket/key path split and the bearer-auth
header; a fix to any of these lands once here.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

TokenSource = Union[str, Callable[[], str], None]


def bearer_headers(token: TokenSource) -> Dict[str, str]:
    """Authorization header for a static token or refresh callable."""
    if token is None:
        return {}
    tok = token() if callable(token) else token
    return {"Authorization": f"Bearer {tok}"}


def split_bucket_path(path: str, what: str) -> Tuple[str, str]:
    """`bucket/key...` scheme-local split shared by S3/GCS/ADLS."""
    path = path.lstrip("/")
    bucket, _, key = path.partition("/")
    if not bucket:
        raise ValueError(f"{what} path needs a bucket: {path!r}")
    return bucket, key


def walk_local(local_src: str) -> Iterator[Tuple[str, str]]:
    """(absolute file path, posix-relative path) for every file under
    local_src — the shared directory-upload recursion."""
    for root, _dirs, files in os.walk(local_src):
        for f in files:
            full = os.path.join(root, f)
            yield full, os.path.relpath(full, local_src)\
                .replace(os.sep, "/")


def download_ranged(read_range: Callable[[int, int], bytes], size: int,
                    local_dst: str, chunk: int) -> None:
    """Chunked ranged download to a local file. read_range(lo, hi) must
    return the inclusive byte range."""
    os.makedirs(os.path.dirname(local_dst) or ".", exist_ok=True)
    with open(local_dst, "wb") as fh:
        pos = 0
        while pos < size:
            end = min(pos + chunk, size) - 1
            fh.write(read_range(pos, end))
            pos = end + 1


def iter_file_chunks(fh, chunk: int) -> Iterator[bytes]:
    while True:
        data = fh.read(chunk)
        if not data:
            return
        yield data
