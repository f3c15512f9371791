"""The segmented scan kernel's timing variants still apply to their source.

``pinot_tpu_torch.tools.segscan_variants`` builds each variant by anchored
text substitutions in ``segscan.cu``; an anchor the source lost would
only show on the card. These checks run on the CPU.
"""
import pytest

from pinot_tpu_torch.tools import segscan_variants as V


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


def test_path_cases_are_seeded_and_shaped_like_the_window_scan():
    rows = 1 << 12
    cases = [c[:2] for c in V.case_arrays(rows, 1717)]
    assert cases == [("path_int64_sum", "sum"), ("one_float64_sum", "sum"),
                     ("sparse_float64_min", "min")]
    a = V.case_arrays(rows, 1717)
    b = V.case_arrays(rows, 1717)
    for (_l, _o, va, fa), (_m, _p, vb, fb) in zip(a, b):
        assert (va == vb).all() and (fa == fb).all() and fa[0]
    assert int(a[0][3].sum()) == 25          # 25 partitions, as the path
    assert int(a[1][3].sum()) == 1
