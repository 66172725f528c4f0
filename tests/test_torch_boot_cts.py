"""The port's first CoeffToSlot factor (CPU, plain versions) held against
the JAX package on the same carried ciphertext: a fresh encryption at the
full chain and scale Δ, where prep hands CoeffToSlot its input. Tolerance:
exact (``array_equal`` words, equal scales). The stages before and after
it: tests/test_torch_boot.py, tests/test_torch_boot_stages.py and
tests/test_torch_boot_stc.py.
"""

import pytest

import torch_port_common as common
from torch_port_common import single_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def both():
    """The JAX package's cts0 on its input, and the port's Bootstrapper."""
    jctx, _, jenc, jboot = common.build_reference()
    x = common.stage_input(jctx, jenc, jctx.L)
    [y] = common.stage_fns(jboot)["cts0"]([x])
    return {"port": common.build_port()[4], "stage": (x, y)}


@pytest.mark.parametrize("name", ["cts0"])
def test_stage_equals_reference(both, name):
    jx, ref = both["stage"]
    [got] = common.stage_fns(both["port"])[name]([common.to_port(jx)])
    common.assert_same(got, ref, name)
    assert got.batch == ()
