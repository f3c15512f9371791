"""Native host runtime: ctypes bindings over the C++ library, with numpy
fallbacks so the engine runs without the compiled artifact.

Port of ``pinot_tpu/native/__init__.py`` over the port's own copy of the
C++ source (``src/pinot_native.cpp``): the same C ABI, the same byte
layouts (the fixed-bit stream, the codecs' streams, DELTA's 18-byte
header) and the same numpy fallbacks, so a forward index written by either
package reads in the other.

The library builds at first use with ``g++`` exactly as the reference
builds it (``-O3 -shared -fPIC -std=c++17 ... -lz -lzstd``), into
``build/torch_kernels/`` beside the package (named by a hash of the source
and flags, so an edited source never loads a stale build), never into the
package directory. Where zstd's header or library is missing it builds
once more with ``-DPINOT_NO_ZSTD`` and without ``-lzstd``: the other
codecs work and ZSTD raises (``zstd_available()`` says which; the segment
builder then writes ZLIB and names it). The failed full build is
remembered beside its target, so only the first process pays for it.
``build_log()`` returns what the compiler printed. This is host code; it
does not go through ``nvcc``.

The port's library adds ``crc32c`` (Castagnoli), the checksum of Kafka's
RecordBatch v2 and Pulsar's payload frames, on the SSE4.2 instruction
where the host has it, else on slicing-by-8 tables; ``crc32c`` here calls
it and falls back to the reference's table loop (``crc32c_plain``) when
the library cannot load, like the codecs' numpy fallbacks.
``crc32c_route()`` says which one runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import List, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "pinot_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_kernels")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_FULL = ([], ["-lz", "-lzstd"])
_NO_ZSTD = (["-DPINOT_NO_ZSTD"], ["-lz"])

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_zstd = False
_log: List[str] = []
_build_s = 0.0


def _target(variant) -> str:
    defs, libs = variant
    h = hashlib.sha256(" ".join(CXX_FLAGS + defs + libs).encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libpinot_native_{h.hexdigest()[:16]}.so")


def _build(variant) -> Optional[str]:  # holds-lock: _lock
    """The library of ``variant`` (built now unless a build exists), or
    None when g++ fails; the compiler's output goes to the build log
    (``_log``, guarded by ``_lock``, which ``load``, the only caller,
    holds). A
    compile that failed leaves ``<target>.failed`` holding its output, so
    later processes skip straight to the next variant (remove the build
    directory to try again)."""
    so = _target(variant)
    for path in (so + ".log", so + ".failed"):
        if os.path.exists(path):
            with open(path) as fh:
                _log.append(fh.read())
    if os.path.exists(so):
        return so
    if os.path.exists(so + ".failed"):
        return None
    defs, libs = variant
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, *defs, _SRC, "-o", tmp, *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True,  # concur: ok CC202
                              text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        _log.append(f"$ {' '.join(cmd)}\n{type(e).__name__}: {e}\n")
        return None
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}" \
          f"exit {proc.returncode}\n"
    _log.append(log)
    if proc.returncode != 0:
        with open(so + ".failed", "w") as fh:
            fh.write(log)
        return None
    with open(so + ".log", "w") as fh:
        fh.write(log)
    os.replace(tmp, so)  # concur: ok CC202
    return so


def load() -> Optional[ctypes.CDLL]:
    """The shared library, building it on first use; None if unavailable."""
    global _lib, _tried, _zstd, _build_s
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        t0 = time.perf_counter()
        # one g++ build a process, by design: every caller of the
        # library waits for it under _lock, and nothing else contends
        so, zstd = _build(_FULL), True  # concur: ok CC202
        if so is None:
            so, zstd = _build(_NO_ZSTD), False  # concur: ok CC202
        _build_s = time.perf_counter() - t0
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            _log.append(f"loading {so}: {e}\n")
            return None
        c_i64 = ctypes.c_int64
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.fixedbit_pack.restype = c_i64
        lib.fixedbit_pack.argtypes = [p_i32, c_i64, ctypes.c_int, p_u8]
        lib.fixedbit_unpack.restype = None
        lib.fixedbit_unpack.argtypes = [p_u8, c_i64, ctypes.c_int, p_i32]
        names = ("zlib", "lz4", "snappy") + (("zstd",) if zstd else ())
        for name in names:
            fn = getattr(lib, f"{name}_compress_chunk")
            fn.restype = c_i64
            fn.argtypes = [p_u8, c_i64, p_u8, c_i64, ctypes.c_int]
            fn = getattr(lib, f"{name}_decompress_chunk")
            fn.restype = c_i64
            fn.argtypes = [p_u8, c_i64, p_u8, c_i64]
        lib.compress_bound.restype = c_i64
        lib.compress_bound.argtypes = [c_i64]
        lib.crc32c.restype = ctypes.c_uint32
        lib.crc32c.argtypes = [ctypes.c_char_p, c_i64, ctypes.c_int]
        lib.crc32c_route.restype = ctypes.c_int
        lib.crc32c_route.argtypes = []
        _lib, _zstd = lib, zstd
        return _lib


def available() -> bool:
    return load() is not None


def zstd_available() -> bool:
    """Whether the loaded library has the ZSTD codec (False without a
    library: the fallback has no ZSTD either)."""
    return load() is not None and _zstd


def build_log() -> str:
    """What g++ printed for this process's build (or the cached build's
    saved log), command lines included."""
    load()
    return "".join(_log)


def build_seconds() -> float:
    """Wall seconds this process spent building (or finding) the library."""
    load()
    return _build_s


def _codec_fn(lib: ctypes.CDLL, codec: str, op: str):
    name = {"ZSTD": "zstd", "ZLIB": "zlib", "LZ4": "lz4",
            "SNAPPY": "snappy"}[codec]   # an unknown codec: KeyError
    if codec == "ZSTD" and not _zstd:
        raise RuntimeError("native library was built without zstd (its "
                           "header or library is missing); codec 'ZSTD' "
                           "is unavailable")
    return getattr(lib, f"{name}_{op}_chunk")


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli): the record-batch and payload-frame checksum
# ---------------------------------------------------------------------------

def _make_crc32c_table() -> List[int]:
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _make_crc32c_table()


def crc32c_plain(data: bytes) -> int:
    """The reference's byte loop (``pinot_tpu/realtime/kafka.crc32c``)."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c(data: bytes, route: Optional[str] = None) -> int:
    """CRC32C of ``data`` (bytes-like). ``route`` None takes the library's
    best ("sse42" or "tables") and the plain loop without a library;
    "tables" forces the library's slicing-by-8 path (tests compare it)."""
    lib = load()
    if lib is None:
        return crc32c_plain(data)
    if not isinstance(data, bytes):
        data = bytes(data)
    return int(lib.crc32c(data, len(data), 0 if route == "tables" else -1))


def crc32c_route() -> str:
    """Which CRC32C runs: "sse42", "tables" (both native) or "plain"."""
    lib = load()
    if lib is None:
        return "plain"
    return "sse42" if lib.crc32c_route() else "tables"


# ---------------------------------------------------------------------------
# fixed-bit pack/unpack (numpy fallback mirrors the C++ exactly)
# ---------------------------------------------------------------------------

def bits_for(cardinality: int) -> int:
    return max(1, int(cardinality - 1).bit_length()) if cardinality > 1 else 1


def fixedbit_pack(ids: np.ndarray, bits: int) -> np.ndarray:
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    n = len(ids)
    nbytes = (n * bits + 7) // 8
    lib = load()
    if lib is not None:
        out = np.zeros(nbytes + 8, dtype=np.uint8)  # +8: unpack window pad
        lib.fixedbit_pack(ids, n, bits, out)
        return out
    # numpy fallback: expand to a bit matrix then packbits (little-endian)
    shifts = np.arange(bits, dtype=np.uint32)
    bitmat = ((ids.astype(np.uint32)[:, None] >> shifts) & 1).astype(np.uint8)
    flat = bitmat.reshape(-1)
    out = np.packbits(flat, bitorder="little")
    padded = np.zeros(nbytes + 8, dtype=np.uint8)
    padded[: len(out)] = out
    return padded


def fixedbit_unpack(buf: np.ndarray, n: int, bits: int) -> np.ndarray:
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    lib = load()
    if lib is not None:
        out = np.empty(n, dtype=np.int32)
        lib.fixedbit_unpack(buf, n, bits, out)
        return out
    flat = np.unpackbits(buf, bitorder="little")[: n * bits]
    bitmat = flat.reshape(n, bits).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(bits, dtype=np.uint32))
    return (bitmat * weights).sum(axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# chunk codecs
# ---------------------------------------------------------------------------

CODECS = ("ZSTD", "ZLIB", "LZ4", "SNAPPY", "PASS_THROUGH", "DELTA")


def compress(data: np.ndarray, codec: str = "ZSTD", level: int = 3
             ) -> np.ndarray:
    if codec == "PASS_THROUGH":
        return np.ascontiguousarray(data).view(np.uint8).reshape(-1).copy()
    if codec == "DELTA":
        return delta_pack(data)
    raw = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    lib = load()
    if lib is not None:
        cap = int(lib.compress_bound(len(raw)))
        out = np.empty(cap, dtype=np.uint8)
        sz = _codec_fn(lib, codec, "compress")(raw, len(raw), out, cap,
                                                level)
        if sz < 0:
            raise RuntimeError(f"{codec} compression failed")
        return out[:sz].copy()
    if codec != "ZLIB":
        # never write a codec the metadata can't honor elsewhere: a silent
        # zlib stream labeled ZSTD is unreadable wherever the lib exists
        raise RuntimeError(f"native library unavailable; codec {codec!r} "
                           "needs it (use ZLIB for the pure-python path)")
    import zlib
    return np.frombuffer(zlib.compress(raw.tobytes(), level), dtype=np.uint8)


def decompress(data: np.ndarray, raw_size: int, codec: str = "ZSTD"
               ) -> np.ndarray:
    buf = np.ascontiguousarray(data, dtype=np.uint8)
    if codec == "PASS_THROUGH":
        return buf[:raw_size]
    if codec == "DELTA":
        out = delta_unpack(buf)
        if len(out) != raw_size:
            raise RuntimeError(
                f"DELTA decompression failed ({len(out)} != {raw_size})")
        return out
    lib = load()
    if lib is not None:
        out = np.empty(raw_size, dtype=np.uint8)
        sz = _codec_fn(lib, codec, "decompress")(buf, len(buf), out,
                                                  raw_size)
        if sz != raw_size:
            raise RuntimeError(f"{codec} decompression failed ({sz})")
        return out
    if codec != "ZLIB":
        raise RuntimeError(f"native library unavailable; cannot decode "
                           f"{codec!r} column (rebuild the native lib)")
    import zlib
    return np.frombuffer(zlib.decompress(buf.tobytes()), dtype=np.uint8)


# ---------------------------------------------------------------------------
# DELTA codec: zigzag deltas + fixed-bit packing, for sorted or clustered
# integer columns (timestamps, auto-increment keys).
# Layout: [1B itemsize][1B bits][8B n][8B first value][packed deltas].
# ---------------------------------------------------------------------------

_DELTA_HEADER = 18


def delta_pack(data: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(data)
    if arr.dtype.kind not in "iu" or arr.ndim != 1:
        raise RuntimeError("DELTA codec needs a 1-D integer column")
    a = arr.astype(np.int64)
    n = len(a)
    first = a[0] if n else np.int64(0)
    delta = np.diff(a)
    zz = ((delta << 1) ^ (delta >> 63)).astype(np.uint64)  # zigzag
    hi = int(zz.max()) if len(zz) else 0
    bits = max(int(hi).bit_length(), 1)
    if bits > 32:
        raise RuntimeError("DELTA deltas exceed 32 bits; use ZSTD")
    packed = fixedbit_pack(zz.astype(np.int64).astype(np.uint32)
                           .view(np.int32), bits)
    out = np.empty(_DELTA_HEADER + len(packed), dtype=np.uint8)
    out[0] = arr.dtype.itemsize
    out[1] = bits
    out[2:10] = np.frombuffer(np.int64(n).tobytes(), dtype=np.uint8)
    out[10:18] = np.frombuffer(np.int64(first).tobytes(), dtype=np.uint8)
    out[_DELTA_HEADER:] = packed
    return out


def delta_unpack(buf: np.ndarray) -> np.ndarray:
    itemsize = int(buf[0])
    bits = int(buf[1])
    n = int(np.frombuffer(buf[2:10].tobytes(), dtype=np.int64)[0])
    first = np.int64(np.frombuffer(buf[10:18].tobytes(),
                                   dtype=np.int64)[0])
    dtype = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[itemsize]
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    zz = fixedbit_unpack(np.ascontiguousarray(buf[_DELTA_HEADER:]),
                         n - 1, bits).view(np.uint32).astype(np.uint64)
    delta = (zz >> 1).astype(np.int64) ^ -(zz & 1).astype(np.int64)
    out = np.empty(n, dtype=np.int64)
    out[0] = first
    out[1:] = first + np.cumsum(delta)
    return out.astype(dtype).view(np.uint8)
