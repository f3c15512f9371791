"""Deep-store filesystem SPI.

Reference parity: pinot-spi/.../spi/filesystem/PinotFS.java (copy / move /
delete / exists / listFiles / mkdir over URIs) + PinotFSFactory (scheme ->
implementation registry), with LocalPinotFS as the built-in and the cloud
filesystems (s3/gs/abfs/hdfs — pinot-plugins/pinot-file-system/) gated
behind their client libraries, which are not installable in this
environment: they register as stubs that raise with a clear message, and
a real implementation can be dropped in via register_fs().

Port of ``pinot_tpu/spi/filesystem.py``: ``fs_for_uri`` and the local
filesystem. ``s3``, ``gs``, ``hdfs`` and ``abfs`` stay gated until their
client (``pinot_tpu_torch.fs``) is registered with its endpoint.
"""
from __future__ import annotations

import os
import shutil
import urllib.parse
from typing import Callable, Dict, List, Tuple


class PinotFS:
    """Filesystem operations over scheme-local paths (the part of the URI
    after the scheme)."""

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def delete(self, path: str, force: bool = False) -> bool:
        raise NotImplementedError

    def mkdir(self, path: str) -> None:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def move(self, src: str, dst: str) -> None:
        raise NotImplementedError

    def copy(self, src: str, dst: str) -> None:
        raise NotImplementedError

    def copy_to_local(self, src: str, local_dst: str) -> None:
        raise NotImplementedError

    def copy_from_local(self, local_src: str, dst: str) -> None:
        raise NotImplementedError

    def length(self, path: str) -> int:
        raise NotImplementedError


class LocalPinotFS(PinotFS):
    """file:// — plain filesystem ops (LocalPinotFS.java)."""

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def delete(self, path: str, force: bool = False) -> bool:
        if os.path.isdir(path):
            if os.listdir(path) and not force:
                return False
            shutil.rmtree(path)
            return True
        if os.path.exists(path):
            os.remove(path)
            return True
        return False

    def mkdir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def listdir(self, path: str) -> List[str]:
        return sorted(os.listdir(path))

    def move(self, src: str, dst: str) -> None:
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        shutil.move(src, dst)

    def copy(self, src: str, dst: str) -> None:
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        if os.path.isdir(src):
            shutil.copytree(src, dst, dirs_exist_ok=True)
        else:
            shutil.copy2(src, dst)

    def copy_to_local(self, src: str, local_dst: str) -> None:
        self.copy(src, local_dst)

    def copy_from_local(self, local_src: str, dst: str) -> None:
        self.copy(local_src, dst)

    def length(self, path: str) -> int:
        return os.path.getsize(path)


class _GatedFS(PinotFS):
    """Unconfigured/unavailable filesystem placeholder: every operation
    raises with the remedy spelled out."""

    def __init__(self, scheme: str, needs: str = "", msg: str = ""):
        self._msg = msg or (
            f"{scheme}:// deep store needs the {needs!r} client library, "
            f"which is not installed in this environment; register a "
            f"real implementation via "
            f"pinot_tpu_torch.spi.filesystem.register_fs({scheme!r}, ...)")

    def _raise(self, *a, **kw):
        raise RuntimeError(self._msg)

    exists = delete = mkdir = listdir = move = copy = _raise
    copy_to_local = copy_from_local = length = _raise


def _UnconfiguredS3() -> PinotFS:
    """s3:// has a real implementation (pinot_tpu_torch.fs.S3PinotFS) but
    it needs endpoint + credentials; until registered, operations explain
    how."""
    return _GatedFS("s3", msg=(
        "s3:// deep store is not configured; call "
        "pinot_tpu_torch.fs.S3PinotFS.register(endpoint_url=..., "
        "access_key=..., secret_key=..., region=...) first"))


_REGISTRY: Dict[str, Callable[[], PinotFS]] = {
    "": LocalPinotFS,
    "file": LocalPinotFS,
    "s3": _UnconfiguredS3,
    "gs": lambda: _GatedFS("gs", "google-cloud-storage"),
    "abfs": lambda: _GatedFS("abfs", "azure-storage-file-datalake"),
    "hdfs": lambda: _GatedFS("hdfs", "pyarrow.hdfs"),
}
_INSTANCES: Dict[str, PinotFS] = {}


def register_fs(scheme: str, factory: Callable[[], PinotFS]) -> None:
    _REGISTRY[scheme] = factory
    _INSTANCES.pop(scheme, None)


def fs_for_uri(uri: str) -> Tuple[PinotFS, str]:
    """(filesystem, scheme-local path) for a URI; bare paths are local."""
    parsed = urllib.parse.urlparse(uri)
    scheme = parsed.scheme if "://" in uri else ""
    factory = _REGISTRY.get(scheme)
    if factory is None:
        raise ValueError(f"no PinotFS registered for scheme {scheme!r} "
                         f"(have {sorted(_REGISTRY)})")
    if scheme not in _INSTANCES:
        _INSTANCES[scheme] = factory()
    if scheme in ("", "file"):
        path = (parsed.netloc + parsed.path) if "://" in uri else uri
    else:
        path = parsed.netloc + parsed.path
    return _INSTANCES[scheme], path
