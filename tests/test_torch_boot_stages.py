"""The port's bootstrap stages after CoeffToSlot (CPU, plain versions) held
against the JAX package: split and recombine, each on the same carried
ciphertext. Tolerance: exact (``array_equal`` words, equal scales).
tests/test_torch_boot.py covers ModRaise, prep, the first CoeffToSlot
factor and the whole bootstrap; tests/test_torch_boot_stc.py the first
SlotToCoeff factor.
"""

import pytest

import torch_port_common as common
from torch_port_common import single_torch_thread  # noqa: F401

STAGES = ("split", "recombine")


@pytest.fixture(scope="module")
def both():
    """The JAX package's chain of stages: split on a fresh encryption at
    CoeffToSlot's output level and scale Δ, recombine on split's output
    (EvalMod left out: it only moves the stacked pair down the chain).
    {stage: (input, output)}."""
    jctx, _, jenc, jboot = common.build_reference()
    jfns = common.stage_fns(jboot)
    x = common.stage_input(jctx, jenc,
                           common.cts_output_level(jctx, jboot))
    chain = {}
    for name in STAGES:
        [y] = jfns[name]([x])
        chain[name] = (x, y)
        x = y
    return {"port": common.build_port()[4], "chain": chain}


@pytest.mark.parametrize("name", STAGES)
def test_stage_equals_reference(both, name):
    jx, ref = both["chain"][name]
    [got] = common.stage_fns(both["port"])[name]([common.to_port(jx)])
    common.assert_same(got, ref, name)
    assert got.batch == ((2,) if name == "split" else ())
