"""K17 and the window evaluator: the port against the JAX package.

One relation made with numpy from a seed (partitions of many sizes, an
ORDER BY key with ties, int64 values past 2^53, floats) goes through
the JAX ``compute_window`` and the port's, for every function in
``RANK_FUNCS``, ``VALUE_FUNCS`` and ``AGG_FUNCS``, ROWS and RANGE frames
and the unordered partition aggregate (the segment agg), on the host
path (default threshold) and on the device path (threshold 0: the JAX
package's jitted scans on the CPU, the port's plain segmented scan and
torch segment agg). Integers must be equal exactly, floats to a
relative 1e-9 (``tools/fuzzer.digest``'s tolerance: the JAX scan adds
in tree order, the port's plain scan in another).

The plain segmented scan (``ops/segscan.seg_scan_reference``) is also
held against the reference's host scans (``_seg_cumsum`` exactly on
int64, ``_seg_cummax``/``_seg_cummin`` on values where their float
offset trick is exact) and against the JAX ``_device_seg_scan``:
int64 and min/max bitwise, float64 sums to a relative 1e-12.
"""
import numpy as np
import pytest
import torch

from pinot_tpu.multistage import window as jw
from pinot_tpu.multistage.relation import Relation as JRel
from pinot_tpu.query.sql import parse_sql as j_parse
from pinot_tpu_torch.multistage import window as tw
from pinot_tpu_torch.multistage.relation import Relation as TRel
from pinot_tpu_torch.ops.segscan import seg_scan, seg_scan_reference
from pinot_tpu_torch.query.sql import parse_sql as t_parse

N = 3000


def _data():
    rng = np.random.default_rng(17)
    sizes = [1, 2, 5, 40, 300, 900, 1752]
    p = np.repeat(np.arange(len(sizes)), sizes)[rng.permutation(N)]
    return {
        "t.p": p.astype(np.int64),
        "t.q": rng.choice(["a", "b", "c"], N),
        "t.o": rng.integers(0, 200, N).astype(np.int64),     # ties
        "t.k": np.arange(N).astype(np.int64),
        "t.v": rng.integers(-10**6, 10**6, N).astype(np.int64),
        "t.big": (rng.integers(0, 2**20, N).astype(np.int64) << 40),
        "t.f": np.round(rng.normal(0, 100, N), 6),
    }


WINDOWS = [
    "ROW_NUMBER() OVER (PARTITION BY p ORDER BY o, k)",
    "RANK() OVER (PARTITION BY p ORDER BY o)",
    "DENSE_RANK() OVER (PARTITION BY p, q ORDER BY o DESC)",
    "NTILE(4) OVER (PARTITION BY p ORDER BY k)",
    "LAG(v) OVER (PARTITION BY p ORDER BY k)",
    "LAG(f, 2, 0) OVER (PARTITION BY p ORDER BY k)",
    "LEAD(v, 3) OVER (PARTITION BY p ORDER BY o, k)",
    "FIRST_VALUE(v) OVER (PARTITION BY p ORDER BY o)",
    "LAST_VALUE(f) OVER (PARTITION BY p ORDER BY o)",
    "FIRST_VALUE(v) OVER (PARTITION BY p ORDER BY k ROWS BETWEEN "
    "2 PRECEDING AND 1 FOLLOWING)",
    "LAST_VALUE(q) OVER (PARTITION BY p ORDER BY o RANGE BETWEEN "
    "5 PRECEDING AND 5 FOLLOWING)",
    "SUM(v) OVER (PARTITION BY p ORDER BY o)",
    "SUM(big) OVER (PARTITION BY p ORDER BY k)",
    "SUM(f) OVER (PARTITION BY p ORDER BY o)",
    "COUNT(*) OVER (PARTITION BY q ORDER BY o)",
    "AVG(v) OVER (PARTITION BY p ORDER BY o)",
    "MIN(v) OVER (PARTITION BY p ORDER BY k)",
    "MAX(big) OVER (PARTITION BY p ORDER BY o, k)",
    "MIN(f) OVER (PARTITION BY p ORDER BY o)",
    "SUM(v) OVER (PARTITION BY p ORDER BY k ROWS BETWEEN 3 PRECEDING "
    "AND CURRENT ROW)",
    "AVG(f) OVER (PARTITION BY p ORDER BY k ROWS BETWEEN 1 PRECEDING "
    "AND 2 FOLLOWING)",
    "MAX(v) OVER (PARTITION BY p ORDER BY k ROWS BETWEEN UNBOUNDED "
    "PRECEDING AND 1 FOLLOWING)",
    "MIN(big) OVER (PARTITION BY p ORDER BY k ROWS BETWEEN 2 PRECEDING "
    "AND UNBOUNDED FOLLOWING)",
    "MAX(f) OVER (PARTITION BY p ORDER BY k ROWS BETWEEN 2 PRECEDING "
    "AND 2 FOLLOWING)",
    "SUM(v) OVER (PARTITION BY p ORDER BY o RANGE BETWEEN 10 PRECEDING "
    "AND 5 FOLLOWING)",
    "COUNT(v) OVER (PARTITION BY p ORDER BY o RANGE BETWEEN 3 PRECEDING "
    "AND CURRENT ROW)",
    "MAX(v) OVER (PARTITION BY p ORDER BY o RANGE BETWEEN 20 PRECEDING "
    "AND 20 FOLLOWING)",
    "SUM(v) OVER (PARTITION BY p)",
    "SUM(big) OVER (PARTITION BY p, q)",
    "COUNT(*) OVER (PARTITION BY q)",
    "AVG(f) OVER (PARTITION BY p)",
    "MIN(v) OVER (PARTITION BY p)",
    "MAX(f) OVER (PARTITION BY p)",
    "COUNT(DISTINCT o) OVER (PARTITION BY p)",
    "SUM(v) OVER ()",
]


def _wf(parse, sql):
    return parse(f"SELECT {sql} FROM t").select[0].expr


def assert_same(got, want, rel=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f" or got.dtype.kind == "f":
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=rel,
                                   atol=0, equal_nan=True)
    else:
        assert got.dtype.kind == want.dtype.kind, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def rels():
    d = _data()
    return JRel(dict(d)), TRel(dict(d))


def test_every_function_is_covered():
    names = {w.split("(")[0].lower() for w in WINDOWS}
    assert jw.RANK_FUNCS | jw.VALUE_FUNCS | jw.AGG_FUNCS <= names
    assert (tw.RANK_FUNCS, tw.VALUE_FUNCS, tw.AGG_FUNCS) == \
        (jw.RANK_FUNCS, jw.VALUE_FUNCS, jw.AGG_FUNCS)


@pytest.mark.parametrize("threshold", ["0", "1000000000"],
                         ids=["device", "host"])
@pytest.mark.parametrize("sql", WINDOWS)
def test_compute_window_equals_jax(rels, sql, threshold, monkeypatch):
    monkeypatch.setenv("PINOT_DEVICE_WINDOW_MIN_ROWS", threshold)
    jrel, trel = rels
    want = jw.compute_window(jrel, _wf(j_parse, sql))
    got = tw.compute_window(trel, _wf(t_parse, sql), "cpu")
    assert_same(got, want)


def test_segment_agg_runs_on_device_path(monkeypatch, rels):
    """Threshold 0 sends an unordered partition aggregate to the torch
    segment agg, with the partition count bucketed to a power of two."""
    monkeypatch.setenv("PINOT_DEVICE_WINDOW_MIN_ROWS", "0")
    seen = []
    real = tw._segment_agg

    def spy(op, segs, vals, ids):
        seen.append((op, segs, vals.dtype))
        return real(op, segs, vals, ids)

    monkeypatch.setattr(tw, "_segment_agg", spy)
    for sql in ("SUM(big) OVER (PARTITION BY p)",
                "AVG(v) OVER (PARTITION BY p)"):
        tw.compute_window(rels[1], _wf(t_parse, sql), "cpu")
    assert seen == [("sum", 8, torch.int64), ("avg", 8, torch.float64)]


def _flags(n, rng, density):
    f = rng.random(n) < density
    if n:
        f[0] = True
    return f


SCAN_CASES = [(1, 1.0), (2, 0.5), (4096, 0.0), (4097, 1.0), (12_289, 0.001),
              (30_000, 0.02)]


@pytest.mark.parametrize("n,density", SCAN_CASES)
def test_plain_scan_against_reference_host_scans(n, density):
    rng = np.random.default_rng(n)
    new_part = _flags(n, rng, density)
    part_ids = np.cumsum(new_part) - 1
    part_start = jw._part_starts(new_part)
    flags = torch.from_numpy(new_part)
    v = rng.integers(-2**40, 2**40, n).astype(np.int64)
    got = seg_scan_reference("sum", torch.from_numpy(v), flags).numpy()
    np.testing.assert_array_equal(got, jw._seg_cumsum(v, part_start))
    # the float offset trick is exact on small integers
    w = rng.integers(-1000, 1000, n).astype(np.float64)
    for op, ref in (("max", jw._seg_cummax), ("min", jw._seg_cummin)):
        got = seg_scan_reference(op, torch.from_numpy(w), flags).numpy()
        np.testing.assert_array_equal(got, ref(w, part_ids))


# lengths whose power-of-two padding (1, 4096) the JAX scans above have
# already compiled
@pytest.mark.parametrize("n,density", [(1, 1.0), (4000, 0.02),
                                       (4096, 1.0)])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_plain_scan_against_jax_device_scan(n, density, op):
    rng = np.random.default_rng(7 * n + 1)
    new_part = _flags(n, rng, density)
    v = rng.integers(-2**62, 2**62, n).astype(np.int64)
    if op == "sum":
        v >>= 16          # sums stay inside int64
    f = rng.normal(0, 1e6, n)
    if op == "sum":
        f = np.abs(f)     # no cancellation: a relative bound is meaningful
    for vals, rel in ((v, 0), (f, 1e-12 if op == "sum" else 0)):
        want = jw._device_seg_scan(op, vals, new_part)
        got = seg_scan(op, torch.from_numpy(vals),
                       torch.from_numpy(new_part)).numpy()
        if rel:
            np.testing.assert_allclose(got, want, rtol=rel, atol=0)
        else:
            np.testing.assert_array_equal(got.view(np.int64),
                                          want.view(np.int64))


def test_scan_refuses_other_dtypes_and_ops():
    v = torch.zeros(4, dtype=torch.int32)
    f = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        seg_scan("sum", v, f)
    with pytest.raises(ValueError):
        seg_scan("prod", v.long(), f)
    with pytest.raises(ValueError):
        seg_scan("sum", v.long(), f[:3])
