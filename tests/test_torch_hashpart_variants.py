"""The hash partition kernel's timing variants still apply to their source.

``pinot_tpu_torch.tools.hashpart_variants`` builds each variant by
anchored text substitutions in ``hashpart.cu``; an anchor the source lost
would only show on the card. These checks run on the CPU.
"""
import numpy as np
import pytest

from pinot_tpu_torch.tools import hashpart_variants as V


@pytest.mark.parametrize("name", list(V.VARIANTS))
def test_variant_substitutions_apply(name):
    base = V.variant_source(())
    src = V.variant_source(V.VARIANTS[name])
    assert (src == base) == (name == "committed")
    for old, new in V.VARIANTS[name]:
        assert src.count(new) == 1 and old not in src


def test_missing_anchor_fails():
    with pytest.raises(RuntimeError, match="anchor"):
        V.variant_source((("no such text in the source", ""),))


def test_cases_are_seeded_and_shaped_as_the_mesh_path():
    rows = 1 << 12
    a = V.case_arrays(1719, rows)
    b = V.case_arrays(1719, rows)
    assert [c[0] for c in a] == ["widest", "skewed", "dev64", "int64_ids",
                                 "small"]
    for (_l, ca, pa, da, ka), (_m, cb, pb, db, kb) in zip(a, b):
        assert (ca == cb).all() and (da, ka) == (db, kb)
        assert all((x == y).all() for x, y in zip(pa, pb))
        assert ca.dtype == np.int32 and ka & (ka - 1) == 0
    shapes = {c[0]: (len(c[1]), [p.dtype for p in c[2]], c[3], c[4])
              for c in a}
    i32 = [np.dtype(np.int32)] * 3
    assert shapes["widest"] == (rows, i32, 4, rows // 2)
    assert shapes["skewed"] == (rows, i32, 4, rows // 2)
    assert shapes["dev64"] == (rows, i32, 64, rows // 32)
    assert shapes["int64_ids"] == (rows, [np.dtype(np.int64)], 4, rows // 2)
    assert shapes["small"] == (4096, i32, 4, 2048)
    # the skewed keys put one code on a large share of the rows
    skewed = a[1][1]
    assert np.bincount(skewed[skewed >= 0]).max() > rows // 8
    assert V.PATH_ROWS == 1 << 20
