"""The port's masked row compaction against the JAX package's.

On the CPU, ``pinot_tpu_torch.ops.compact.compact`` runs its plain
version; it must equal ``pinot_tpu.ops.compact._compact_xla`` (and the
public ``compact()``, which splits 64-bit columns around it) byte for
byte: same valid flags, same compacted rows in the same order, zeros past
``matched``, same ``n_valid``, ``matched`` and ``overflow``. The CUDA
kernel is held to the same plain version on the card (chip_smoke.py and
tests/test_torch_cuda.py). The multiset and overflow contract of
tests/test_compact_pallas.py is restated for the port at the end.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pinot_tpu.ops import compact as JC
from pinot_tpu_torch.ops import compact as TC

N = 1 << 14
RAGGED = N - 77                      # not a multiple of 128
SELS = [0.0, 0.001, 0.03, 0.25, 1.0]
DTYPES = [np.int32, np.int64, np.float32, np.float64]


def _column(rng, n, dtype):
    if dtype == np.int32:
        return rng.integers(-2**31, 2**31, n, dtype=np.int32)
    if dtype == np.int64:
        return rng.integers(-2**62, 2**62, n, dtype=np.int64)
    return (rng.normal(0, 1e9, n)).astype(dtype)


def _caps(n, matched):
    return {"tight": max(matched // (2 * TC.LANES), 1),
            "default": TC.default_slots_cap(n),
            "full": TC.full_slots_cap(n)}


def _port(mask, cols, cap):
    return TC.compact(torch.from_numpy(mask),
                      tuple(torch.from_numpy(c) for c in cols), cap)


def _assert_same(port, ref):
    valid_p, cols_p, nv_p, m_p, of_p = port
    valid_r, cols_r, nv_r, m_r, of_r = ref
    assert valid_p.numpy().tobytes() == np.asarray(valid_r).tobytes()
    for cp, cr in zip(cols_p, cols_r):
        cr = np.asarray(cr)
        assert cp.numpy().dtype == cr.dtype
        assert cp.numpy().tobytes() == cr.tobytes()
    for a, b in ((nv_p, nv_r), (m_p, m_r), (of_p, of_r)):
        assert a.dtype == torch.int32 and np.asarray(b).dtype == np.int32
        assert int(a) == int(b)


@pytest.mark.parametrize("n", [N, RAGGED], ids=["n2^14", "ragged"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("sel", SELS)
def test_compact_matches_xla_bytes(sel, dtype, n):
    rng = np.random.default_rng(int(sel * 1000) + n)
    mask = rng.random(n) < sel
    cols = (rng.integers(0, 1 << 20, n).astype(np.int32),
            _column(rng, n, dtype))
    for name, cap in _caps(n, int(mask.sum())).items():
        port = _port(mask, cols, cap)
        valid, outs, n_slots, matched, ov = JC._compact_xla(
            jnp.asarray(mask), tuple(jnp.asarray(c) for c in cols), n, cap)
        _assert_same(port, (valid, outs, n_slots * JC.LANES, matched, ov))
        pub = JC.compact(jnp.asarray(mask),
                         tuple(jnp.asarray(c) for c in cols), cap)
        _assert_same(port, pub)
        if name == "tight" and mask.sum() > cap * TC.LANES:
            assert int(port[4]) == 1


def test_compact_empty_input():
    mask = np.zeros(0, bool)
    col = np.zeros(0, np.int32)
    valid, (c,), n_valid, matched, overflow = _port(mask, (col,), 8)
    assert valid.shape == (8 * TC.LANES,) and not valid.any()
    assert not c.any() and int(matched) == 0 and int(n_valid) == 0
    assert int(overflow) == 0


def test_compact_rejects_bad_inputs():
    mask = torch.ones(10, dtype=torch.bool)
    with pytest.raises(ValueError):
        TC.compact(mask, (torch.ones(10, dtype=torch.int16),), 8)
    with pytest.raises(ValueError):
        TC.compact(mask, (torch.ones(11, dtype=torch.int32),), 8)
    with pytest.raises(ValueError):
        TC.compact(mask.to(torch.int32), (), 8)
    with pytest.raises(ValueError):
        TC.compact(mask, tuple(torch.ones(10) for _ in range(9)), 8)


MIXED8 = [np.int32, np.int64, np.float32, np.float64] * 2


@pytest.mark.parametrize("offset", [1, 3, 15])
def test_compact_slices_of_eight_mixed_columns_match_xla(offset):
    """Slices that start off a 16-byte boundary (the CUDA kernel reads
    their head and tail a byte at a time) and all 8 columns, 4- and
    8-byte mixed, give _compact_xla's bytes."""
    n = RAGGED
    rng = np.random.default_rng(offset)
    mask = rng.random(n + offset) < 0.1
    cols = tuple(_column(rng, n + offset, d) for d in MIXED8)
    for cap in _caps(n, int(mask[offset:].sum())).values():
        port = TC.compact(torch.from_numpy(mask)[offset:],
                          tuple(torch.from_numpy(c)[offset:] for c in cols),
                          cap)
        valid, outs, n_slots, matched, ov = JC._compact_xla(
            jnp.asarray(mask[offset:]),
            tuple(jnp.asarray(c[offset:]) for c in cols), n, cap)
        _assert_same(port, (valid, outs, n_slots * JC.LANES, matched, ov))


@pytest.mark.parametrize("offset", [0, 3])
def test_compact_keeps_every_nonzero_mask_byte(offset):
    """A bool mask that views bytes other than 0 and 1 keeps every row
    whose byte is non-zero, as the CUDA kernel does."""
    n = RAGGED
    rng = np.random.default_rng(100 + offset)
    raw = rng.integers(0, 4, n + offset, dtype=np.uint8)[offset:]
    cols = (_column(rng, n, np.int32), _column(rng, n, np.float64))
    for cap in _caps(n, int((raw != 0).sum())).values():
        port = TC.compact(torch.from_numpy(raw).view(torch.bool),
                          tuple(torch.from_numpy(c) for c in cols), cap)
        valid, outs, n_slots, matched, ov = JC._compact_xla(
            jnp.asarray(raw != 0), tuple(jnp.asarray(c) for c in cols), n,
            cap)
        _assert_same(port, (valid, outs, n_slots * JC.LANES, matched, ov))


# -- the contract of tests/test_compact_pallas.py, for the port ------------

@pytest.mark.parametrize("p", [0.001, 0.03, 0.25])
def test_compact_multiset(p):
    rng = np.random.default_rng(int(p * 1000))
    mask = rng.random(N) < p
    a = rng.integers(-2**31, 2**31, N, dtype=np.int32)
    b = rng.integers(-2**62, 2**62, N, dtype=np.int64)
    f = rng.normal(0, 1e9, N)
    cap = TC.default_slots_cap(N) if p < 0.1 else TC.full_slots_cap(N)
    valid, (ac, bc, fc), n_valid, matched, ov = _port(mask, (a, b, f), cap)
    v = valid.numpy()
    assert int(ov) == 0
    assert int(matched) == int(mask.sum()) == int(v.sum())
    assert int(n_valid) >= int(mask.sum())
    assert not v[int(n_valid):].any()
    got = sorted(zip(ac.numpy()[v].tolist(), bc.numpy()[v].tolist(),
                     fc.numpy()[v].tolist()))
    assert got == sorted(zip(a[mask].tolist(), b[mask].tolist(),
                             f[mask].tolist()))
    # the port is order-preserving, not only multiset-equal
    assert ac.numpy()[v].tolist() == a[mask].tolist()


def test_compact_overflow_flag():
    mask = np.ones(N, bool)
    a = np.arange(N, dtype=np.int32)
    tight = N // (2 * TC.LANES)              # half the needed rows
    valid, (ac,), _, matched, ov = _port(mask, (a,), tight)
    assert int(ov) == 1 and int(matched) == N
    # only the first cap rows are written
    assert ac.numpy().tolist() == a[:tight * TC.LANES].tolist()
    valid, (ac,), _, matched, ov = _port(mask, (a,), TC.full_slots_cap(N))
    assert int(ov) == 0
    assert np.array_equal(ac.numpy()[valid.numpy()], a)


def test_compact_ragged_and_all_false():
    n = N + 12345
    rng = np.random.default_rng(4)
    mask = rng.random(n) < 0.02
    a = rng.integers(-500, 500, n).astype(np.int32)
    cap = TC.default_slots_cap(n)
    valid, (ac,), _, matched, _ov = _port(mask, (a,), cap)
    assert int(matched) == int(mask.sum())
    assert ac.numpy()[valid.numpy()].tolist() == a[mask].tolist()
    valid, (ac,), _, matched, _ov = _port(np.zeros(n, bool), (a,), cap)
    assert int(matched) == 0 and not valid.any() and not ac.any()
