"""The port's u64 engine against the JAX package's on the CPU: the hoisted
rotations (``rotate_hoisted``, ``hoisted_rotations_ext`` and
``mod_down_ext``), the one-shot mod-down and the reduced-error ops, each
``array_equal``, on a u64 chain with one special prime (logN=11) and with
two (logN=10). The mod-down's float32 overflow estimate sums k terms:
for k <= 2 its order cannot matter (and k = 1 clamps it to 0), so both
cases are held word for word, with no ±1-unit allowance.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fhe_gpt2_tpu.core.evaluator import _mod_down_core
from fhe_gpt2_tpu.core.modmath import add_mod as jadd_mod
from fhe_gpt2_tpu_torch.core import tks
from fhe_gpt2_tpu_torch.core.modmath import add_mod, word_tensor

from torch_port_common import CPU, ref_plain, same_words, to_port, \
    single_torch_thread  # noqa: F401
from torch_u64_common import u64_pair

STEPS = [0, 1, 3, 5]            # 5 has no key: three hops


@pytest.fixture(scope="module", params=[1, 2], ids=["k1", "k2"])
def s(request):
    k = request.param
    return u64_pair(logn=11 if k == 1 else 10, num_special=k)


def test_u64_hoisted_rotations_equal_reference(s):
    ref, got = s["ref"]["ev"], s["got"]["ev"]
    a, pa = s["a"], s["pa"]
    for r, g in zip(ref.rotate_hoisted(a, STEPS),
                    got.rotate_hoisted(pa, STEPS)):
        same_words(g, r, "rotate_hoisted")
    jext = ref.hoisted_rotations_ext(a, STEPS)
    ext = got.hoisted_rotations_ext(pa, STEPS)
    for r, g in zip(jext, ext):
        same_words(g, r, "hoisted_rotations_ext")
    l, q = got.ctx.L, got.ctx.tables(got.ctx.key_limbs(got.ctx.L)).q
    jq = s["ref"]["ctx"].tables(s["ref"]["ctx"].key_limbs(l)).q
    jsum = ref.mod_down_ext(jadd_mod(jext[1], jext[2], jq), l, a.scale)
    psum = got.mod_down_ext(add_mod(ext[1], ext[2], q), l, pa.scale)
    same_words(psum, jsum, "mod_down_ext")
    x = s["x"]
    want = np.roll(x, -1) + np.roll(x, -3)
    assert np.abs(s["got"]["dec"].decrypt(psum) - want).max() < 1e-5


def test_u64_one_shot_mod_down_equals_reference(s):
    """The key-switch mod-down by P = the product of k special primes, on
    random words of the extended basis (batched)."""
    jctx, ctx = s["ref"]["ctx"], s["got"]["ctx"]
    l = ctx.L - 1
    limbs = ctx.key_limbs(l)
    rng = np.random.default_rng(ctx.k_sp)
    x = np.stack([rng.integers(0, ctx.all_moduli[i], size=(2, ctx.n),
                               dtype=np.uint64) for i in limbs], axis=-2)
    sp = tuple(ctx.L + i for i in range(ctx.k_sp))
    want = _mod_down_core(jnp.asarray(x), jctx.tables(sp), jctx.tables(l),
                          jctx.mod_down_onestep_tables(l))
    got = tks.fused_mod_down(word_tensor(x, CPU, word=np.uint64),
                             ctx.tables(sp),
                             ctx.tables(l), ctx.fused_md_tables(l))
    same_words(got, want, f"mod-down k={ctx.k_sp}")


def test_u64_reduced_error_ops_equal_reference(s):
    ref, got = s["ref"]["ev"], s["got"]["ev"]
    jctx = s["ref"]["ctx"]
    scale, L = jctx.params.scale, jctx.L
    a, pa = s["a"], s["pa"]
    jenc = s["ref"]["enc"]
    # Off-scale operands: a non-integer ratio (1.37), and an integer one (4)
    # one level lower.
    b = jenc.encrypt(ref_plain(jctx, s["y"], scale * 1.37, range(L)))
    c = jenc.encrypt(ref_plain(jctx, s["y"], scale * 4, range(L - 1)))
    pb, pc = to_port(b), to_port(c)
    same_words(got.add_reduced_error(pa, pb), ref.add_reduced_error(a, b),
               "add_reduced_error (1.37)")
    same_words(got.sub_reduced_error(pa, pc), ref.sub_reduced_error(a, c),
               "sub_reduced_error (4, lower level)")
    same_words(got.multiply_reduced_error(pa, pc),
               ref.multiply_reduced_error(a, c), "multiply_reduced_error")
    same_words(got.set_scale_exact(pb, scale), ref.set_scale_exact(b, scale),
               "set_scale_exact")
    same_words(got.rescale_to_scale(got.multiply(pa, pa), scale),
               ref.rescale_to_scale(ref.multiply(a, a), scale),
               "rescale_to_scale")
