"""The port's EvalMod on the u64 engine (CPU) held against the JAX
package's, first half: the Chebyshev cosine of ``eval_mod`` (the
``cos_plan``), on a carried stacked pair of values I + f (|I| <= 10,
|f| <= 2^-9, split's output form) at scale Δ, 3 levels below the top of
test_full_bootstrap's chain (tests/torch_u64_common.py). Exact
(``array_equal`` words, equal scales). The JAX side runs eagerly and
compiles every op at every level it passes, so EvalMod is held in two
halves: the double angles and the arcsin correction are in
tests/test_torch_u64_boot_evalmod_tail.py.
"""

import pytest

from fhe_gpt2_tpu.approx.chebeval import eval_plan as jeval_plan
from fhe_gpt2_tpu_torch.approx.chebeval import eval_plan

import torch_port_common as common
from torch_port_common import single_torch_thread  # noqa: F401
from torch_u64_common import build_evalmod, evalmod_input


@pytest.fixture(scope="module")
def both():
    return build_evalmod("ref"), build_evalmod("got")


def test_u64_evalmod_cosine_equals_reference(both):
    (jctx, jB, jem, jenc), (ctx, B, em, _) = both
    jx = evalmod_input(jctx, jenc, jctx.L - 3)
    ref = jeval_plan(jB, jem.cos_plan, jx)
    got = eval_plan(B, em.cos_plan, common.to_port(jx))
    assert got.batch == (2,)
    common.assert_same(got, ref, "EvalMod cosine")
