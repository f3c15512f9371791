"""The port's native codec runtime against the JAX package's.

``pinot_tpu_torch.native`` carries its own copy of the C++ source, built
at first use with ``g++`` into ``build/torch_kernels/``. On the same
numpy-seeded inputs it must write the reference's bytes: the fixed-bit
stream for every width 1-31 (n of 0, 1 and two ragged tails), every codec's
stream (ZSTD, ZLIB, LZ4, SNAPPY, PASS_THROUGH, DELTA with its 18-byte
header), and each package must decode the other's. DELTA on deltas
wider than 32 bits raises as the reference's does; the numpy fallback
gives the native path's bytes; a library built without zstd refuses the
ZSTD codec and serves the others.
"""
import os

import numpy as np
import pytest

from pinot_tpu import native as jn
from pinot_tpu_torch import native as tn

RNG_SEED = 20261017
N_CASES = (0, 1, 37, 4099)


def _ids(n: int, bits: int) -> np.ndarray:
    rng = np.random.default_rng(RNG_SEED + 97 * bits + n)
    ids = rng.integers(0, 1 << bits, n, dtype=np.int64).astype(np.int32)
    if n:
        ids[-1] = (1 << bits) - 1       # the widest value of the width
    return ids


def test_library_builds_outside_the_package():
    assert tn.available()
    log = tn.build_log()
    assert "g++" in log and "-O3" in log and "-shared" in log
    pkg = os.path.dirname(os.path.abspath(tn.__file__))
    assert not any(f.endswith(".so") for f in os.listdir(pkg))
    assert os.path.isdir(tn.BUILD_DIR)
    assert tn.build_seconds() >= 0.0


@pytest.mark.parametrize("n", N_CASES)
@pytest.mark.parametrize("bits", range(1, 32))
def test_fixedbit_bytes_and_values_equal_reference(bits, n):
    ids = _ids(n, bits)
    buf, jbuf = tn.fixedbit_pack(ids, bits), jn.fixedbit_pack(ids, bits)
    assert buf.dtype == jbuf.dtype and buf.tobytes() == jbuf.tobytes()
    np.testing.assert_array_equal(tn.fixedbit_unpack(jbuf, n, bits), ids)
    np.testing.assert_array_equal(jn.fixedbit_unpack(buf, n, bits), ids)


def test_bits_for_equals_reference():
    for card in list(range(0, 70)) + [255, 256, 257, 1 << 20, (1 << 20) + 1]:
        assert tn.bits_for(card) == jn.bits_for(card)


def _columns():
    rng = np.random.default_rng(RNG_SEED)
    return {
        "int32": rng.integers(0, 5000, 20_000).astype(np.int32),
        "int64_sorted": np.cumsum(rng.integers(0, 300, 20_000)),
        "float64": rng.normal(size=20_000),
        "int16": rng.integers(-300, 300, 4097).astype(np.int16),
        "empty": np.zeros(0, dtype=np.int32),
    }


@pytest.mark.parametrize("col", list(_columns()))
@pytest.mark.parametrize("codec", tn.CODECS)
def test_codec_bytes_equal_and_decode_both_ways(codec, col):
    arr = _columns()[col]
    if codec == "DELTA" and arr.dtype.kind not in "iu":
        for mod in (tn, jn):
            with pytest.raises(RuntimeError, match="integer"):
                mod.compress(arr, codec)
        return
    out, jout = tn.compress(arr, codec), jn.compress(arr, codec)
    assert out.tobytes() == jout.tobytes()
    raw = arr.view(np.uint8).reshape(-1) if arr.size else \
        np.zeros(0, np.uint8)
    if codec == "DELTA" and not arr.size:
        return                  # an empty DELTA stream decodes to 0 bytes
    for dec, enc in ((tn, jout), (jn, out)):
        got = dec.decompress(enc, arr.nbytes, codec)
        assert got.tobytes() == raw.tobytes()


def test_delta_header_layout():
    arr = np.array([5, 6, 8, 7], dtype=np.int32)
    out = tn.compress(arr, "DELTA")
    # deltas 1, 2, -1 zigzag to 2, 4, 1: three bits each
    assert out[0] == 4 and out[1] == 3          # itemsize, bits
    assert int(out[2:10].view(np.int64)[0]) == 4
    assert int(out[10:18].view(np.int64)[0]) == 5
    assert len(out) == 18 + (3 * 3 + 7) // 8 + 8
    np.testing.assert_array_equal(
        tn.decompress(out, arr.nbytes, "DELTA").view(np.int32), arr)


def test_wide_deltas_degrade_like_the_reference():
    arr = np.array([0, 1 << 40, 3], dtype=np.int64)
    errs = []
    for mod in (tn, jn):
        with pytest.raises(RuntimeError) as e:
            mod.compress(arr, "DELTA")
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "32 bits" in errs[0]


def test_native_equals_numpy_fallback(monkeypatch):
    cases = [(_ids(n, b), b) for b in (1, 3, 7, 13, 31) for n in N_CASES]
    native_out = [tn.fixedbit_pack(ids, b).tobytes() for ids, b in cases]
    col = _columns()["int64_sorted"]
    native_zlib = tn.compress(col, "ZLIB")
    native_delta = tn.compress(col, "DELTA").tobytes()
    monkeypatch.setattr(tn, "load", lambda: None)
    assert not tn.available()
    for (ids, b), want in zip(cases, native_out):
        buf = tn.fixedbit_pack(ids, b)
        assert buf.tobytes() == want
        np.testing.assert_array_equal(tn.fixedbit_unpack(buf, len(ids), b),
                                      ids)
    assert tn.compress(col, "DELTA").tobytes() == native_delta
    # the pure-python ZLIB path reads the native stream and vice versa
    assert tn.decompress(native_zlib, col.nbytes, "ZLIB").tobytes() \
        == col.tobytes()
    for codec in ("ZSTD", "LZ4", "SNAPPY"):
        with pytest.raises(RuntimeError, match="native library"):
            tn.compress(col, codec)


def test_a_build_without_zstd_refuses_zstd_only(monkeypatch):
    col = _columns()["int32"]
    monkeypatch.setattr(tn, "_zstd", False)
    assert not tn.zstd_available()
    for op in (lambda: tn.compress(col, "ZSTD"),
               lambda: tn.decompress(jn.compress(col, "ZSTD"), col.nbytes,
                                     "ZSTD")):
        with pytest.raises(RuntimeError, match="without zstd"):
            op()
    for codec in ("ZLIB", "LZ4", "SNAPPY"):
        assert tn.compress(col, codec).tobytes() == \
            jn.compress(col, codec).tobytes()
    with pytest.raises(KeyError):
        tn.compress(col, "NOPE")


def test_the_no_zstd_variant_compiles_without_zstd(monkeypatch, tmp_path):
    """The fallback build (-DPINOT_NO_ZSTD, no -lzstd) compiles and lacks
    only the zstd entry points."""
    import ctypes

    monkeypatch.setattr(tn, "BUILD_DIR", str(tmp_path))
    so = tn._build(tn._NO_ZSTD)
    assert so is not None and so.startswith(str(tmp_path))
    assert "-DPINOT_NO_ZSTD" in tn._log[-1] and "-lzstd" not in tn._log[-1]
    lib = ctypes.CDLL(so)
    assert hasattr(lib, "zlib_compress_chunk")
    assert hasattr(lib, "lz4_compress_chunk")
    assert not hasattr(lib, "zstd_compress_chunk")


def test_a_failed_build_is_remembered(monkeypatch, tmp_path):
    """A variant that does not link leaves ``<target>.failed`` with the
    compiler's output; later calls return None without running g++ and
    still show that output in the build log."""
    monkeypatch.setattr(tn, "BUILD_DIR", str(tmp_path))
    broken = ([], ["-lpinot_no_such_library"])
    assert tn._build(broken) is None
    marker = tn._target(broken) + ".failed"
    assert os.path.exists(marker)
    with open(marker) as fh:
        first = fh.read()
    assert "-lpinot_no_such_library" in first and "exit 0" not in first

    def no_compile(*a, **k):
        raise AssertionError("g++ ran again for a remembered failure")

    monkeypatch.setattr(tn.subprocess, "run", no_compile)
    n_log = len(tn._log)
    assert tn._build(broken) is None
    assert tn._log[n_log:] == [first]
