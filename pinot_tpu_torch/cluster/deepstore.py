"""Deep-store segment packaging: tar.gz up/down through PinotFS.

Reference parity: segment tar.gz packaging (TarGzCompressionUtils) +
deep-store upload in the split-commit path (SplitSegmentCommitter /
SegmentUploader) and the server download-untar path
(SegmentOnlineOfflineStateModelFactory.java:128 onBecomeOnlineFromOffline
-> download from deep store via PinotFS -> untar -> load).

Port of ``pinot_tpu/cluster/deepstore.py``. The archives are readable by
either package.
"""
from __future__ import annotations

import os
import tarfile
import tempfile

from ..spi.filesystem import fs_for_uri

SEGMENT_EXT = ".tar.gz"


def pack_segment(seg_dir: str, out_path: str = "") -> str:
    """tar.gz one segment directory; returns the archive path."""
    name = os.path.basename(seg_dir.rstrip("/"))
    if not out_path:
        out_path = os.path.join(tempfile.mkdtemp(prefix="ptpu_pack_"),
                                name + SEGMENT_EXT)
    with tarfile.open(out_path, "w:gz") as tar:
        tar.add(seg_dir, arcname=name)
    return out_path


def unpack_segment(archive: str, dest_root: str) -> str:
    """Untar into dest_root; returns the extracted segment dir."""
    os.makedirs(dest_root, exist_ok=True)
    with tarfile.open(archive, "r:gz") as tar:
        names = tar.getnames()
        top = {n.split("/", 1)[0] for n in names}
        if len(top) != 1:
            raise ValueError(f"segment archive must hold one directory, "
                             f"got {sorted(top)}")
        tar.extractall(dest_root, filter="data")
    return os.path.join(dest_root, top.pop())


def upload_segment(seg_dir: str, deepstore_uri: str) -> str:
    """Pack + copy a segment into the deep store; returns the download
    URI (metadata-push style: the caller hands this to the controller)."""
    name = os.path.basename(seg_dir.rstrip("/"))
    archive = pack_segment(seg_dir)
    dest_uri = deepstore_uri.rstrip("/") + "/" + name + SEGMENT_EXT
    fs, path = fs_for_uri(dest_uri)
    fs.copy_from_local(archive, path)
    os.remove(archive)
    return dest_uri


def download_segment(download_uri: str, dest_root: str) -> str:
    """Fetch + untar a deep-store segment; returns the local segment
    dir."""
    from ..utils import faults
    if faults.active():
        # handoff.stall: the COMMITTED-replica artifact fetch stalls
        # (delay_ms) then breaks — the adopter retries on its next poll.
        # Site key = archive basename, NOT the full URI: decision purity
        # in (seed, point, key) must survive run-scoped store roots
        # (tmp dirs would perturb the stream between identical runs)
        faults.fault_point("handoff.stall",
                           os.path.basename(download_uri.rstrip("/")))
    fs, path = fs_for_uri(download_uri)
    with tempfile.TemporaryDirectory(prefix="ptpu_dl_") as tmp:
        local = os.path.join(tmp, os.path.basename(path))
        fs.copy_to_local(path, local)
        return unpack_segment(local, dest_root)


def is_deepstore_uri(location: str) -> bool:
    return location.endswith(SEGMENT_EXT)


def pruning_metadata(seg_dir: str):
    """Broker-pruning metadata (per-column min/max/partitions + doc
    count) from a local segment dir; None when unreadable. The shape the
    controller stores per segment (ZK segment-metadata analog)."""
    import json
    try:
        with open(os.path.join(seg_dir, "metadata.json")) as fh:
            m = json.load(fh)
    except (OSError, ValueError):
        return None
    cols = {}
    for name, cm in (m.get("columns") or {}).items():
        entry = {k: cm[k] for k in ("min", "max", "partitions") if k in cm}
        if entry:
            cols[name] = entry
    out = {"columns": cols, "totalDocs": m.get("totalDocs"),
           "numPartitions": m.get("numPartitions")}
    # creationTimeMs drives age-based tier selection at the controller
    for k in ("startOffset", "endOffset", "partition", "creationTimeMs"):
        if k in m:
            out[k] = m[k]
    return out
