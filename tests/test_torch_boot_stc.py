"""The port's first SlotToCoeff factor (CPU, plain versions) held against
the JAX package on the same carried ciphertext: a fresh encryption at
CoeffToSlot's output level and scale Δ. Tolerance: exact (``array_equal``
words, equal scales). The stages before it: tests/test_torch_boot.py and
tests/test_torch_boot_stages.py.
"""

import pytest

import torch_port_common as common
from torch_port_common import single_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def both():
    """The JAX package's stc0 on its input, and the port's Bootstrapper."""
    jctx, _, jenc, jboot = common.build_reference()
    x = common.stage_input(jctx, jenc,
                           common.cts_output_level(jctx, jboot))
    [y] = common.stage_fns(jboot)["stc0"]([x])
    return {"port": common.build_port()[4], "stage": (x, y)}


@pytest.mark.parametrize("name", ["stc0"])
def test_stage_equals_reference(both, name):
    jx, ref = both["stage"]
    [got] = common.stage_fns(both["port"])[name]([common.to_port(jx)])
    common.assert_same(got, ref, name)
    assert got.batch == ()
