"""Segment directory abstraction: v1 (file-per-index) and v3 (single
packed file) formats behind one buffer API.

Reference parity: pinot-segment-spi/.../store/SegmentDirectory.java with
its v1/v2 (per-index files) and v3 (single ``columns.psf`` + index map)
implementations, SegmentVersion lineage, and
SegmentFormatConverterFactory (v1->v3 conversion on load when
tableConfig asks for it). Same trade: v3 keeps ONE mmap per segment —
one file handle, one page-table range, one object to ship to deep store
— while v1 stays trivially inspectable and append-friendly.

All readers access segment bytes through :func:`read_array` /
:func:`read_json` / :func:`exists`; in v1 those hit loose files, in v3
they return zero-copy slices of the packed mmap. Writers (segment build,
index reload) always produce loose files; :func:`fold_new_files` absorbs
them into a v3 segment afterwards (the reference's v3 writer appends to
the single file the same way, leaving dead bytes on removal until the
next repack).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import leak

V3_FILE = "columns.psf"
V3_MAP = "index_map.json"
METADATA_FILE = "metadata.json"
# mutable runtime artifacts (rewritten in place after load) must never be
# absorbed into the immutable packed file — a stale packed copy would
# resurrect after the loose file is deleted (upsert valid-docs snapshots)
RUNTIME_FILES = frozenset({"valid.bin"})
_ALIGN = 64  # slice alignment so device uploads see aligned hosts buffers

# seg_dir -> (packed mmap, {name: [offset, length]}, map mtime).
# Bounded LRU: segment churn (rebalance, minion purge) must not pin
# unlinked columns.psf mmaps for process lifetime; removal paths also
# call invalidate() eagerly.
from collections import OrderedDict
import threading
_CACHE: "OrderedDict[str, Tuple[np.memmap, Dict[str, List[int]], float]]" \
    = OrderedDict()
_CACHE_MAX = 256
_CACHE_LOCK = threading.Lock()  # LRU mutation is not GIL-atomic; broker/
# gRPC thread pools hit _load_map concurrently


def is_v3(seg_dir: str) -> bool:
    return os.path.exists(os.path.join(seg_dir, V3_MAP))


def _load_map(seg_dir: str) -> Tuple[np.memmap, Dict[str, List[int]]]:
    map_path = os.path.join(seg_dir, V3_MAP)
    mtime = os.path.getmtime(map_path)
    with _CACHE_LOCK:
        hit = _CACHE.get(seg_dir)
        if hit is not None and hit[2] == mtime:
            _CACHE.move_to_end(seg_dir)
            return hit[0], hit[1]
    with open(map_path) as fh:
        index_map = json.load(fh)
    packed = np.memmap(os.path.join(seg_dir, V3_FILE), dtype=np.uint8,
                       mode="r")
    leak.track(packed, "segdir_mmap", seg_dir)
    with _CACHE_LOCK:
        _CACHE[seg_dir] = (packed, index_map, mtime)
        _CACHE.move_to_end(seg_dir)
        while len(_CACHE) > _CACHE_MAX:
            _CACHE.popitem(last=False)
    return packed, index_map


def invalidate(seg_dir: str) -> None:
    with _CACHE_LOCK:
        _CACHE.pop(seg_dir, None)


def exists(seg_dir: str, name: str) -> bool:
    # loose files win over packed entries: runtime artifacts (upsert
    # valid-doc snapshots, freshly built indexes awaiting fold) are
    # always the newest copy
    if os.path.exists(os.path.join(seg_dir, name)):
        return True
    if is_v3(seg_dir):
        _, index_map = _load_map(seg_dir)
        return name in index_map
    return False


def _slice(seg_dir: str, name: str) -> Optional[np.ndarray]:
    """The raw uint8 view for ``name`` in a v3 segment, else None."""
    if not is_v3(seg_dir):
        return None
    packed, index_map = _load_map(seg_dir)
    ent = index_map.get(name)
    if ent is None:
        return None
    off, length = ent
    return packed[off:off + length]


def read_array(seg_dir: str, name: str, dtype, count: int = -1,
               shape: Optional[Tuple[int, ...]] = None,
               mmap: bool = True) -> np.ndarray:
    """Typed array for a segment entry. v3: zero-copy slice of the packed
    mmap; v1: np.memmap (mmap=True) or np.fromfile."""
    dt = np.dtype(dtype)
    path = os.path.join(seg_dir, name)
    view = None if os.path.exists(path) else _slice(seg_dir, name)
    if view is not None:
        arr = view.view(dt)
        if count >= 0:
            arr = arr[:count]
        return arr.reshape(shape) if shape is not None else arr
    if os.path.getsize(path) == 0:
        # np.memmap refuses empty files; a 0-byte artifact is legitimate
        # (CSR docs file of an index with no postings)
        arr = np.zeros(0, dtype=dt)
        return arr.reshape(shape) if shape is not None else arr
    if shape is not None and mmap:
        return np.memmap(path, dtype=dt, mode="r", shape=shape)
    if mmap:
        arr = np.memmap(path, dtype=dt, mode="r")
        return arr[:count] if count >= 0 else arr
    arr = np.fromfile(path, dtype=dt, count=count)
    return arr.reshape(shape) if shape is not None else arr


def read_bytes(seg_dir: str, name: str) -> bytes:
    path = os.path.join(seg_dir, name)
    view = None if os.path.exists(path) else _slice(seg_dir, name)
    if view is not None:
        return view.tobytes()
    with open(path, "rb") as fh:
        return fh.read()


def read_json(seg_dir: str, name: str) -> Any:
    path = os.path.join(seg_dir, name)
    view = None if os.path.exists(path) else _slice(seg_dir, name)
    if view is not None:
        return json.loads(view.tobytes().decode("utf-8"))
    with open(path) as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# conversion + maintenance
# ---------------------------------------------------------------------------

def _data_files(seg_dir: str) -> List[str]:
    out = []
    for fn in sorted(os.listdir(seg_dir)):
        if fn in (METADATA_FILE, V3_FILE, V3_MAP) or fn in RUNTIME_FILES:
            continue
        if os.path.isfile(os.path.join(seg_dir, fn)):
            out.append(fn)
    return out


def _set_version(seg_dir: str, version: str) -> None:
    meta_path = os.path.join(seg_dir, METADATA_FILE)
    with open(meta_path) as fh:
        meta = json.load(fh)
    meta["formatVersion"] = version
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(meta, fh, indent=1)
    os.replace(tmp, meta_path)


def convert_to_v3(seg_dir: str) -> Dict[str, List[int]]:
    """Pack every loose data file into columns.psf (v1 -> v3)."""
    if is_v3(seg_dir):
        _, index_map = _load_map(seg_dir)
        return index_map
    names = _data_files(seg_dir)
    index_map: Dict[str, List[int]] = {}
    tmp = os.path.join(seg_dir, V3_FILE + ".tmp")
    off = 0
    with open(tmp, "wb") as out:
        for name in names:
            pad = (-off) % _ALIGN
            if pad:
                out.write(b"\0" * pad)
                off += pad
            with open(os.path.join(seg_dir, name), "rb") as fh:
                data = fh.read()
            out.write(data)
            index_map[name] = [off, len(data)]
            off += len(data)
    os.replace(tmp, os.path.join(seg_dir, V3_FILE))
    map_tmp = os.path.join(seg_dir, V3_MAP + ".tmp")
    with open(map_tmp, "w") as fh:
        json.dump(index_map, fh)
    os.replace(map_tmp, os.path.join(seg_dir, V3_MAP))
    _set_version(seg_dir, "v3")
    for name in names:
        os.remove(os.path.join(seg_dir, name))
    invalidate(seg_dir)
    return index_map


def convert_to_v1(seg_dir: str) -> None:
    """Unpack columns.psf back into loose files (v3 -> v1)."""
    if not is_v3(seg_dir):
        return
    packed, index_map = _load_map(seg_dir)
    for name, (off, length) in index_map.items():
        with open(os.path.join(seg_dir, name), "wb") as fh:
            fh.write(packed[off:off + length].tobytes())
    invalidate(seg_dir)
    del packed
    os.remove(os.path.join(seg_dir, V3_MAP))
    os.remove(os.path.join(seg_dir, V3_FILE))
    _set_version(seg_dir, "v1")


def fold_new_files(seg_dir: str) -> List[str]:
    """Absorb loose files written next to a v3 segment (index reload)
    into the packed file by appending; returns the folded names."""
    if not is_v3(seg_dir):
        return []
    names = _data_files(seg_dir)
    if not names:
        return []
    packed, index_map = _load_map(seg_dir)
    index_map = dict(index_map)
    del packed
    invalidate(seg_dir)
    with open(os.path.join(seg_dir, V3_FILE), "ab") as out:
        off = out.tell()
        for name in names:
            pad = (-off) % _ALIGN
            if pad:
                out.write(b"\0" * pad)
                off += pad
            with open(os.path.join(seg_dir, name), "rb") as fh:
                data = fh.read()
            out.write(data)
            index_map[name] = [off, len(data)]
            off += len(data)
    map_tmp = os.path.join(seg_dir, V3_MAP + ".tmp")
    with open(map_tmp, "w") as fh:
        json.dump(index_map, fh)
    os.replace(map_tmp, os.path.join(seg_dir, V3_MAP))
    for name in names:
        os.remove(os.path.join(seg_dir, name))
    return names


def remove_entries(seg_dir: str, names: List[str]) -> List[str]:
    """Drop entries from a v3 index map (bytes stay until the next
    repack — the reference's v3 removal works the same way)."""
    if not is_v3(seg_dir):
        return []
    _, index_map = _load_map(seg_dir)
    index_map = dict(index_map)
    dropped = [n for n in names if index_map.pop(n, None) is not None]
    if dropped:
        map_tmp = os.path.join(seg_dir, V3_MAP + ".tmp")
        with open(map_tmp, "w") as fh:
            json.dump(index_map, fh)
        os.replace(map_tmp, os.path.join(seg_dir, V3_MAP))
        invalidate(seg_dir)
    return dropped


def entry_names(seg_dir: str) -> List[str]:
    """All data entry names (v3 map keys + any loose files)."""
    if is_v3(seg_dir):
        _, index_map = _load_map(seg_dir)
        return sorted(set(index_map) | set(_data_files(seg_dir)))
    return _data_files(seg_dir)
