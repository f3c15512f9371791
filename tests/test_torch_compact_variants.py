"""The compaction kernel's timing variants still apply to its source.

``pinot_tpu_torch.tools.compact_variants`` builds each variant by anchored
text substitutions in ``compact.cu``; an anchor the source lost would
only show on the card. These checks run on the CPU.
"""
import pytest

from pinot_tpu_torch.tools import compact_variants as V


@pytest.mark.parametrize("name", list(V.VARIANTS))
def test_variant_substitutions_apply(name):
    base = V.variant_source(())
    src = V.variant_source(V.VARIANTS[name])
    assert (src == base) == (name == "committed")
    for _old, new in V.VARIANTS[name]:
        assert new in src


def test_missing_anchor_fails():
    with pytest.raises(RuntimeError, match="anchor"):
        V.variant_source((("no such text in the source", ""),))
