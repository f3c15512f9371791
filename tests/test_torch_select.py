"""The port's device selection kernel (K9) against the JAX package's.

``build_select_kernel`` of both packages runs one SelectPlan over the same
seeded columns: low-cardinality dict-id keys, so every ORDER BY has long
runs of equal keys and the LIMIT cuts through them. The first
min(matched, k) selected rows and order keys must be equal, row for row:
among equal keys both take the lower row first (``lax.top_k``'s order,
which the port keeps with a stable descending sort).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pinot_tpu.ops import ir as JIR
from pinot_tpu.ops import kernels as JK
from pinot_tpu_torch.ops import ir as TIR
from pinot_tpu_torch.ops import kernels as TK

BUCKET = 4096
N_DOCS = 3900


def _cols():
    rng = np.random.default_rng(17)
    return (rng.integers(0, 4, BUCKET).astype(np.int32),      # card 4
            rng.integers(0, 7, BUCKET).astype(np.int32),      # card 7
            rng.integers(-1000, 1000, BUCKET).astype(np.int64),  # raw
            np.arange(BUCKET, dtype=np.int32))


def _run(ir, kernels, to, pred, order, k, params):
    sp = ir.SelectPlan(pred=pred(ir), select_cols=(3, 0, 2),
                       order=order, k=k)
    out = kernels.build_select_kernel(sp, BUCKET)(
        tuple(to(c) for c in _cols()), N_DOCS, tuple(to(p) for p in params))
    return {k_: np.asarray(v) for k_, v in out.items()}


def _all(ir):
    return ir.TrueP()


def _some(ir):
    return ir.IdRange(1, 0, 1)       # col 1 in [params[0], params[1]]


CASES = {
    # (pred, order, k, params)
    "asc_tie_cut": (_all, ((0, False, 4),), 10, (0, 6)),
    "desc_tie_cut": (_all, ((0, True, 4),), 10, (0, 6)),
    "two_keys": (_some, ((0, True, 4), (1, False, 7)), 25, (2, 4)),
    "raw_desc": (_some, ((2, True, 0),), 40, (1, 5)),
    "raw_asc": (_all, ((2, False, 0),), 40, (0, 6)),
    "doc_order": (_some, (), 10, (3, 3)),
    "k_past_matched": (_some, ((0, False, 4),), 1000, (6, 6)),
    "nothing_matched": (_some, ((0, False, 4),), 10, (5, 4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_select_kernel_matches_jax(case):
    pred, order, k, params = CASES[case]
    params = tuple(np.int32(p) for p in params)
    want = _run(JIR, JK, jnp.asarray, pred, order, k, params)
    got = _run(TIR, TK, lambda a: torch.as_tensor(np.asarray(a)), pred,
               order, k, params)
    assert int(got["matched"]) == int(want["matched"])
    n = min(int(want["matched"]), k)
    if case == "k_past_matched":
        assert n < k
    for key in want:
        if key != "matched":
            np.testing.assert_array_equal(got[key][:n], want[key][:n], key)
    if case.endswith("tie_cut"):
        # the LIMIT cut a run of equal keys: the lowest rows of it won
        rows = got["sel_0"][:n]
        assert (np.diff(rows) > 0).all()
