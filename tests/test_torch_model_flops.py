"""``launch/model_flops.py``: the port's analytic model FLOPs equal the
reference's (``repro.launch.model_flops``) key for key and value for value:
the same plain arithmetic on configs copied field for field."""
import pytest

from repro.configs import REGISTRY
from repro.launch import model_flops as jmf
from repro_torch.launch import model_flops as mf


def test_all_model_flops_equal_the_reference():
    want = jmf.all_model_flops()
    got = mf.all_model_flops()
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k] == v, k
        assert v > 0, k  # every cell is modelled


def test_arch_table_is_the_registry():
    """The port's ``(arch, family, shapes)`` table is the reference
    registry's, in its order."""
    assert [(n, f, tuple(s)) for n, f, s in mf.ARCHS] == [
        (n, a.family, tuple(a.shapes)) for n, a in REGISTRY.items()]


@pytest.mark.parametrize("arch,shape", [("smollm-360m", "train_4k"), ("gemma3-27b", "decode_32k"),
                                        ("dien", "retrieval_cand"), ("gatedgcn", "molecule")])
def test_model_flops_one_cell(arch, shape):
    assert mf.model_flops(arch, shape) == jmf.model_flops(arch, shape)
