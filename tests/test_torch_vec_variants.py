"""The vector search kernels' timing variants still apply to their source.

``pinot_tpu_torch.tools.vec_variants`` builds each variant by anchored
text substitutions in ``vecsearch.cu``; an anchor the source lost would
only show on the card. These checks run on the CPU.
"""
import pytest

from pinot_tpu_torch.tools import vec_variants as V


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


def test_ptxas_lines_keep_entries_registers_and_spills():
    log = ("ptxas info    : Compiling entry function '_Z9vec_probe' for "
           "'sm_90a'\nptxas info    : Function properties for _Z9vec_probe\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 40 registers, used 1 barriers\n"
           "ptxas info    : Compile time = 1.0 ms\n")
    lines = V.ptxas_lines(log)
    assert len(lines) == 3 and "vec_probe" in lines[0]
    assert "spill" in lines[1] and "40 registers" in lines[2]
