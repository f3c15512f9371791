"""K16: the port's device_equi_join against the JAX package's.

Keys are made with numpy from a seed and go through both functions:
duplicates (max_dup 1 to 8), null keys poisoned to -1 as
``device_join._poisoned_codes`` poisons them, int32 and int64 codes, an
empty probe side and an empty build side. ``match`` must be equal
exactly, and ``r_idx`` wherever ``match`` is set (past a run the index
is unspecified). The build side's runs come out in the stable sort's
order, which the row order of ``materialize_join`` and the fused plane's
``pos`` depend on: ``test_stable_run_order`` holds the port to it on a
build side of many equal keys, and the numpy join gives the same pairs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.ops.join import device_equi_join as jax_join
from pinot_tpu_torch.multistage.device_join import (_bounded_max_dup,
                                                    _poisoned_codes)
from pinot_tpu_torch.multistage.join import hash_join
from pinot_tpu_torch.multistage.relation import Relation
from pinot_tpu_torch.ops.join import device_equi_join


def _both(lk: np.ndarray, rk: np.ndarray, max_dup: int):
    jm, jr = (np.asarray(a) for a in jax_join(jnp.asarray(lk),
                                              jnp.asarray(rk), max_dup))
    tm, tr = device_equi_join(torch.from_numpy(lk), torch.from_numpy(rk),
                              max_dup)
    tm, tr = tm.numpy(), tr.numpy()
    assert tm.shape == jm.shape == (len(lk), max_dup)
    assert tr.dtype == np.int32
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tr[tm], jr[jm])
    return tm, tr


@pytest.mark.parametrize("seed,n_l,n_r,card,null_frac,dtype", [
    (1, 5000, 300, 300, 0.0, np.int32),     # few duplicates
    (2, 5000, 400, 100, 0.0, np.int64),     # duplicates
    (3, 3000, 256, 40, 0.1, np.int32),      # duplicates and null keys
    (3, 3000, 256, 40, 0.1, np.int64),
    (4, 1, 1, 1, 0.0, np.int32),
    (5, 700, 2000, 60, 0.05, np.int64),     # build larger than probe
])
def test_matches_jax(seed, n_l, n_r, card, null_frac, dtype):
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, card + 5, n_l).astype(dtype)
    rk = rng.integers(0, card, n_r).astype(dtype)
    lk[rng.random(n_l) < null_frac] = -1
    rk[rng.random(n_r) < null_frac] = -1
    rk = rk[rk >= 0]              # the caller drops null build rows
    max_dup = _bounded_max_dup(rk)
    match, _ = _both(lk, rk, max_dup)
    # every probe row's count equals its key's multiplicity on the build
    # side (a null probe key matches nothing)
    counts = {k: int(c) for k, c in zip(*np.unique(rk, return_counts=True))}
    np.testing.assert_array_equal(match.sum(1),
                                  [counts.get(k, 0) for k in lk])


def test_empty_probe():
    rng = np.random.default_rng(6)
    match, _ = _both(np.zeros(0, np.int32),
                     rng.integers(0, 10, 50).astype(np.int32), 4)
    assert match.shape == (0, 4)


@pytest.mark.parametrize("n_l", [0, 50])
def test_empty_build(n_l):
    """The callers never pass an empty build side (try_device_join
    returns "empty_build", the fused plane pads to one row), and the JAX
    function cannot take one; the port's matches nothing."""
    lk = np.random.default_rng(6).integers(0, 10, n_l).astype(np.int32)
    match, r_idx = device_equi_join(torch.from_numpy(lk),
                                    torch.zeros(0, dtype=torch.int32), 4)
    assert match.shape == r_idx.shape == (n_l, 4) and not match.any()


def test_stable_run_order():
    """Within a key's run the build rows come in their original order:
    with many equal keys interleaved with others, slot j of a probe row
    holds the j-th build row of that key, as numpy's stable argsort
    (and jnp.argsort) order them."""
    rng = np.random.default_rng(7)
    rk = rng.integers(0, 64, 512).astype(np.int32)
    rk[rng.permutation(512)[:40]] = 5         # one heavy key
    rk[rk == 9] = 10                          # a run of another size
    lk = rng.integers(0, 64, 4096).astype(np.int32)
    max_dup = _bounded_max_dup(rk)
    match, r_idx = _both(lk, rk, max_dup)
    order = np.argsort(rk, kind="stable")
    sorted_rk = rk[order]
    for i in np.nonzero(lk == 5)[0][:20].tolist() + [int(np.argmax(lk == 10))]:
        runs = order[sorted_rk == lk[i]]
        np.testing.assert_array_equal(r_idx[i][match[i]], runs)


def test_device_pairs_equal_numpy_join():
    """Pairs from K16 in the order try_device_join reads them equal the
    numpy hash join's, including null keys and duplicate build keys."""
    rng = np.random.default_rng(8)
    left = Relation({"l.k": rng.integers(0, 60, 3000).astype(np.int64)},
                    {"l.k": rng.random(3000) < 0.05})
    right = Relation({"r.k": rng.integers(0, 50, 400).astype(np.int64),
                      "r.v": np.arange(400)},
                     {"r.k": rng.random(400) < 0.05})
    code_l, code_r = _poisoned_codes(left, right, ["l.k"], ["r.k"])
    valid_r = np.nonzero(code_r >= 0)[0]
    match, r_dense = device_equi_join(
        torch.from_numpy(code_l), torch.from_numpy(code_r[valid_r]),
        _bounded_max_dup(code_r[valid_r]))
    li, j = np.nonzero(match.numpy())
    r_idx = valid_r[r_dense.numpy()[li, j]]
    _rel, l_ref, r_ref, _m = hash_join(left, right, ["l.k"], ["r.k"],
                                       "inner", return_idx=True)
    np.testing.assert_array_equal(li, l_ref)
    np.testing.assert_array_equal(r_idx, r_ref)
