"""K17's partition aggregate: the port's plain version against the JAX
package, and the wrapper's contract (CPU).

Seeded numpy inputs go through the JAX ``_segment_agg_jit`` (on the CPU)
and ``ops/segagg.segment_agg_reference`` (what ``segment_agg`` runs on a
CPU tensor), for every op, both dtypes and several segment counts:
integers, counts and min/max must be equal bitwise, float64 sums and
averages to a relative 1e-12 (the two add in different orders). A
segment holding both zeros must give the reference's zero (-0.0 for min,
+0.0 for max) whichever comes first. The wrapper refuses other dtypes,
ops, shapes and devices with ``ValueError``. The CUDA kernel itself is
held to the plain version on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from pinot_tpu.multistage import window as jw
from pinot_tpu_torch.multistage import window as tw
from pinot_tpu_torch.ops import segagg as A
from pinot_tpu_torch.ops.stream_scratch import StreamScratch

OPS = ("sum", "count", "avg", "min", "max")
SEGS = (1, 2, 8, 64, 1024)


def _inputs(op, dtype, segs, n, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, segs, n).astype(np.int64)
    if op == "count":
        v = np.ones(n, dtype=np.int64)     # what the window stage passes
    elif dtype == "int64":
        lim = 2**62 if op in ("min", "max") else 2**40
        v = rng.integers(-lim, lim, n).astype(np.int64)
    elif op in ("sum", "avg"):
        v = rng.random(n) * 1e9
    else:
        v = np.round(rng.normal(0, 1e3, n), 1)
        v[rng.random(n) < 0.05] = 0.0
        v[rng.random(n) < 0.05] = -0.0
    return v, ids


def _jax(op, segs, v, ids):
    return np.asarray(jw._segment_agg_jit(op, segs)(v, ids))


def _same(got, want, op):
    got = np.asarray(got)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if got.dtype == np.float64 and op in ("sum", "avg"):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        assert np.array_equal(got.view(np.int64), want.view(np.int64))


# count always gets int64 ones from the window stage
CASES = [(op, dtype, segs) for op in OPS for dtype in ("int64", "float64")
         for segs in SEGS if not (op == "count" and dtype == "float64")]


@pytest.mark.parametrize("op,dtype,segs", CASES)
def test_reference_matches_jax(op, dtype, segs):
    v, ids = _inputs(op, dtype, segs, 5000, segs * 7 + len(op))
    got = A.segment_agg_reference(op, segs, torch.from_numpy(v),
                                  torch.from_numpy(ids))
    _same(got.numpy(), _jax(op, segs, v, ids), op)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("order", ["pos_first", "neg_first"])
def test_both_zeros_give_the_references_zero(op, order):
    """scatter_reduce_ alone keeps whichever zero comes first; the
    reference keeps -0.0 for min and +0.0 for max."""
    zeros = [0.0, -0.0] if order == "pos_first" else [-0.0, 0.0]
    v = np.array(zeros + [1.0] + zeros[::-1] + [-0.0, 5.0], dtype=np.float64)
    ids = np.array([0, 0, 0, 1, 1, 2, 2], dtype=np.int64)
    got = A.segment_agg(op, 4, torch.from_numpy(v), torch.from_numpy(ids))
    want = _jax(op, 4, v, ids)
    _same(got.numpy(), want, op)
    # min: segments 0 and 1 hold the least value, a zero; max: segment 1
    zero_rows = got[:5] if op == "min" else got[3:5]
    assert bool(torch.all(zero_rows == 0))
    assert bool(torch.all(torch.signbit(zero_rows) == (op == "min")))


@pytest.mark.parametrize("op", OPS)
def test_window_stage_routes_cpu_tensors_to_the_plain_version(op):
    v, ids = _inputs(op, "int64", 8, 300, 3)
    vals, idt = torch.from_numpy(v), torch.from_numpy(ids)
    before = A.launches
    got = tw._segment_agg(op, 8, vals, idt)
    assert torch.equal(got, A.segment_agg_reference(op, 8, vals, idt))
    assert A.launches == before       # the counter counts kernel launches


def test_int64_sums_wrap_as_the_reference():
    big = np.full(4, 2**62, dtype=np.int64)
    ids = np.zeros(4, dtype=np.int64)
    got = A.segment_agg("sum", 1, torch.from_numpy(big),
                        torch.from_numpy(ids))
    _same(got.numpy(), _jax("sum", 1, big, ids), "sum")


def test_empty_input():
    e = torch.zeros(0, dtype=torch.int64)
    assert A.segment_agg("sum", 4, e, e).shape == (0,)
    assert A.segment_agg("avg", 4, e.double(), e).dtype == torch.float64


@pytest.mark.parametrize("bad", [
    ("median", 4, torch.zeros(3, dtype=torch.int64),
     torch.zeros(3, dtype=torch.int64)),
    ("sum", 4, torch.zeros(3, dtype=torch.float32),
     torch.zeros(3, dtype=torch.int64)),
    ("sum", 4, torch.zeros(3, dtype=torch.int64),
     torch.zeros(3, dtype=torch.int32)),
    ("sum", 4, torch.zeros(3, dtype=torch.int64),
     torch.zeros(4, dtype=torch.int64)),
    ("sum", 4, torch.zeros((3, 2), dtype=torch.int64),
     torch.zeros((3, 2), dtype=torch.int64)),
    ("sum", 4, torch.zeros(6, dtype=torch.int64)[::2],
     torch.zeros(3, dtype=torch.int64)),
    ("sum", 0, torch.zeros(3, dtype=torch.int64),
     torch.zeros(3, dtype=torch.int64)),
    ("sum", 4, torch.zeros(3, dtype=torch.int64, device="meta"),
     torch.zeros(3, dtype=torch.int64)),
    ("sum", 4, torch.zeros(3, dtype=torch.int64, device="meta"),
     torch.zeros(3, dtype=torch.int64, device="meta")),
], ids=["op", "vals-dtype", "ids-dtype", "shape", "2-d", "strided",
        "segs", "devices-differ", "meta-device"])
def test_wrapper_refuses(bad):
    with pytest.raises(ValueError):
        A.segment_agg(*bad)


def test_agg_bytes_counts_each_input_once():
    assert A.agg_bytes("sum", 10) == 240
    assert A.agg_bytes("count", 10) == 160


def test_stream_scratch_grows_and_tags_epochs():
    """One buffer a (device, stream), zeroed when allocated, grown to a
    power of two; epochs count up from 1 and start again with a new
    buffer; a dropped buffer is allocated anew."""
    sc = StreamScratch()
    dev = torch.device("cpu")
    with sc.lock:
        a, e1 = sc.take(dev, 7, 5)
        b, e2 = sc.take(dev, 7, 3)
        c, e3 = sc.take(dev, 8, 3)
    assert a.numel() == 8 and b is a and (e1, e2) == (1, 2)
    assert c is not a and e3 == 1 and not bool(a.any())
    with sc.lock:
        d, e4 = sc.take(dev, 7, 9)
    assert d.numel() == 16 and e4 == 1
    sc.drop(dev, 7)
    with sc.lock:
        f, e5 = sc.take(dev, 7, 1)
    assert f is not d and e5 == 1
