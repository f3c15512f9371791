"""The port's device sketches (K10) against the JAX package's, on the CPU.

Each function of ``pinot_tpu_torch/ops/kernels.py`` that builds a sketch
state (splitmix64 hashing, HLL slots and presence, the theta sketch's k
smallest distinct hashes, grouped HLL presence, percentile centroids) runs
beside its ``pinot_tpu/ops/kernels.py`` counterpart on the same seeded
numpy inputs. Hashes, slots, presence bitmaps and theta hashes must be
bitwise equal (the port's int64 bit patterns viewed as uint64); centroid
weights exactly, centroid means to a relative 1e-9 of the largest value's
magnitude (a mean is a difference of prefix sums that add in another
order, so a centroid near zero keeps the error of its neighbours).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pinot_tpu.ops import ir as JIR
from pinot_tpu.ops import kernels as JK
from pinot_tpu_torch.ops import ir as TIR
from pinot_tpu_torch.ops import kernels as TK

N = 5000


def _edge_values(dtype):
    rng = np.random.default_rng(7)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        body = rng.integers(info.min, info.max, N, dtype=dtype)
        edge = [0, -1, 1, info.min, info.max, info.min + 1, info.max - 1]
    else:
        info = np.finfo(dtype)
        body = (rng.normal(0, 1e6, N)).astype(dtype)
        edge = [0.0, -0.0, np.nan, np.inf, -np.inf, info.max, -info.max,
                info.tiny]
    return np.concatenate([body, np.asarray(edge, dtype=dtype)])


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64,
                                   np.float32])
def test_splitmix64_bitwise(dtype):
    v = _edge_values(dtype)
    want = np.asarray(JK._device_splitmix64(jnp.asarray(v)))
    got = TK._device_splitmix64(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), want)


def _inputs(seed=3):
    """A raw int64 column, a dict-id column with its per-id hash table,
    a float64 column, a mask and group keys."""
    from pinot_tpu_torch.ops.aggregations import _hash64
    rng = np.random.default_rng(seed)
    card = 700
    raw = rng.integers(-10**12, 10**12, N).astype(np.int64)
    ids = rng.integers(0, card, N).astype(np.int32)
    dvals = np.array([f"v{i:04d}" for i in range(card)])
    table = _hash64(dvals)
    fl = np.round(rng.normal(0, 1000, N), 3)
    fl[::97] = np.nan
    mask = rng.random(N) < 0.6
    keys = rng.integers(0, 5, N).astype(np.int32)
    return raw, ids, table, fl, mask, keys


def _both(cols, params):
    jc = tuple(jnp.asarray(c) for c in cols)
    jp = tuple(jnp.asarray(p) for p in params)
    tc = tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in cols)
    tp = tuple(torch.from_numpy(np.ascontiguousarray(
        p.view(np.int64) if p.dtype == np.uint64 else p)) for p in params)
    return jc, jp, tc, tp


def _specs(kind, card):
    """(JAX spec, port spec) over the raw column and over the dict column
    through its hash table."""
    return [(JIR.AggSpec(kind, JIR.Col(0), False, card=card),
             TIR.AggSpec(kind, TIR.Col(0), False, card=card)),
            (JIR.AggSpec(kind, JIR.Col(1, 0), False, card=card),
             TIR.AggSpec(kind, TIR.Col(1, 0), False, card=card))]


@pytest.mark.parametrize("log2m", [4, 12, 16])
def test_hll_slots_and_presence_bitwise(log2m):
    raw, ids, table, _fl, mask, _keys = _inputs()
    jc, jp, tc, tp = _both((raw, ids), (table,))
    for jspec, tspec in _specs("distinct_count_hll", log2m):
        jslot, jr = JK._hll_slots(jspec, jc, jp)
        tslot, tr = TK._hll_slots(tspec, tc, tp)
        assert jr == tr
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
        jo, to = {}, {}
        JK._scalar_hll("a", jspec, jnp.asarray(mask), jc, jp, jo)
        TK._scalar_hll("a", tspec, torch.from_numpy(mask), tc, tp, to)
        np.testing.assert_array_equal(to["a_present"].numpy(),
                                      np.asarray(jo["a_present"]))


@pytest.mark.parametrize("k", [16, 256, 8192])
@pytest.mark.parametrize("sel", [0.0, 0.6])
def test_theta_hashes_bitwise(k, sel):
    raw, ids, table, _fl, _mask, _keys = _inputs()
    mask = np.random.default_rng(k).random(N) < sel
    jc, jp, tc, tp = _both((raw, ids), (table,))
    for jspec, tspec in _specs("distinct_count_theta", k):
        jo, to = {}, {}
        JK._scalar_theta("t", jspec, jnp.asarray(mask), jc, jp, jo)
        TK._scalar_theta("t", tspec, torch.from_numpy(mask), tc, tp, to)
        got = to["t_hashes"].numpy().view(np.uint64)
        np.testing.assert_array_equal(got, np.asarray(jo["t_hashes"]))


def test_grouped_hll_presence_bitwise():
    raw, ids, table, _fl, mask, keys = _inputs()
    space = 5
    keys_s = np.where(mask, keys, space).astype(np.int32)
    jc, jp, tc, tp = _both((raw, ids), (table,))
    for jspec, tspec in _specs("distinct_count_hll", 6):
        jo, to = {}, {}
        JK._group_hll("g", jspec, jnp.asarray(mask), jnp.asarray(keys_s),
                      space, jc, jp, jo)
        TK._group_hll("g", tspec, torch.from_numpy(mask),
                      torch.from_numpy(keys_s), space, tc, tp, to)
        assert to["g_present"].shape == jo["g_present"].shape
        np.testing.assert_array_equal(to["g_present"].numpy(),
                                      np.asarray(jo["g_present"]))


@pytest.mark.parametrize("sel", [0.0, 0.01, 0.6, 1.0])
def test_percentile_centroids(sel):
    _raw, _ids, _table, fl, _mask, _keys = _inputs()
    mask = np.random.default_rng(5).random(N) < sel
    jspec = JIR.AggSpec("percentile_sketch", JIR.Col(0), False, card=128)
    tspec = TIR.AggSpec("percentile_sketch", TIR.Col(0), False, card=128)
    jo, to = {}, {}
    JK._scalar_percentile("p", jspec, jnp.asarray(mask),
                          (jnp.asarray(fl),), (), jo)
    TK._scalar_percentile("p", tspec, torch.from_numpy(mask),
                          (torch.from_numpy(fl),), (), to)
    np.testing.assert_array_equal(to["p_pc_w"].numpy(),
                                  np.asarray(jo["p_pc_w"]))
    scale = np.nanmax(np.abs(fl[np.isfinite(fl)]))
    np.testing.assert_allclose(to["p_pc_mean"].numpy(),
                               np.asarray(jo["p_pc_mean"]), rtol=1e-9,
                               atol=1e-9 * scale)


def test_clz64_matches_a_bit_loop():
    rng = np.random.default_rng(11)
    x = rng.integers(-2**63, 2**63 - 1, 2000, dtype=np.int64)
    x = np.concatenate([x, np.array([1, -1, 2**62, 2**31, -2**63],
                                    dtype=np.int64)])
    x[x == 0] = 1
    u = x.view(np.uint64)
    want = np.array([64 - int(v).bit_length() for v in u])
    np.testing.assert_array_equal(TK._clz64(torch.from_numpy(x)).numpy(),
                                  want)
