"""The port's EvalMod on the u64 engine (CPU) held against the JAX
package's, second half: ``eval_mod``'s double-angle iterations and its
arcsin correction (amplitude Q0/Δ folded in), on a carried stacked pair
of values in (-1, 1) encrypted at the level and scale where the cosine
half (tests/test_torch_u64_boot_evalmod.py) leaves its output. Exact
(``array_equal`` words, equal scales).
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


def _tail(B, em, y, plan):
    for _ in range(em.num_double):
        y = B.add_const(B.mul_const(B.square(y), 2.0), -1.0)
    return plan(B, em.arcsin_plan, y)


def test_u64_evalmod_tail_equals_reference(both):
    (jctx, jB, jem, jenc), (ctx, B, em, enc) = both
    # Where the cosine half leaves its output: the port runs it on its own
    # encryption (fast), the JAX side starts from there.
    x = enc.encrypt(B.ev.make_plain(0.5, ctx.params.scale, ctx.L - 3))
    cos = eval_plan(B, em.cos_plan, x)
    jy = evalmod_input(jctx, jenc, cos.level, seed=8, lo=0, hi=1, frac=0.9,
                       scale=cos.scale)
    ref = _tail(jB, jem, jy, jeval_plan)
    got = _tail(B, em, common.to_port(jy), eval_plan)
    assert got.batch == (2,)
    common.assert_same(got, ref, "EvalMod double angle + arcsin")
