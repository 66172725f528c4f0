"""The port's u64 engine (int64 words, plain PyTorch ops) against the JAX
package's u64 engine on the CPU: the context, keys, the three
encryptions, the evaluator's unit ops and decryption, all ``array_equal``,
plus the decrypt budgets of tests/test_ckks.py (1e-8 at Δ=2^40 after a
multiply+rescale and after rotations). The chain is ``test_params(11, 4)``
(tests/torch_u64_common.py); the hoisted rotations, the reduced-error ops
and the two-special-prime chain are in test_torch_u64_core_hoist.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_gpt2_tpu.core import context as jcontext
from fhe_gpt2_tpu.core.evaluator import Encryptor as JEncryptor
from fhe_gpt2_tpu.core.evaluator import expand_uniform as jexpand_uniform
from fhe_gpt2_tpu_torch.core import context as tcontext
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Encryptor

from torch_port_common import CPU, ref_plain, same_words, \
    single_torch_thread  # noqa: F401
from torch_u64_common import u64_pair


@pytest.fixture(scope="module")
def s():
    return u64_pair()


@pytest.mark.parametrize("name,args", [("test_params", ()),
                                       ("test_params", (11, 6)),
                                       ("cnn_params", ()),
                                       ("gpt2_params", ())])
def test_u64_parameter_sets_equal_reference(name, args):
    assert vars(getattr(tcontext, name)(*args)) == vars(
        getattr(jcontext, name)(*args))


def test_u64_contexts_build_on_the_cpu_and_need_a_device_choice():
    """The reference's regimes build (int64 words); without device= the
    context still takes the card, which this host lacks."""
    for p in (tcontext.gpt2_params(), tcontext.cnn_params(),
              tcontext.test_params()):
        ctx = CkksContext(p, device=CPU)
        assert ctx.dtype == torch.int64 and ctx.word == np.uint64
        assert ctx.ntt_all.q.dtype == torch.int64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            CkksContext(tcontext.test_params())
    assert CkksContext(tcontext.test_params_w32(), device=CPU).dtype \
        == torch.int32


def test_u64_context_tables_equal_reference(s):
    ref, got = s["ref"]["ctx"], s["got"]["ctx"]
    assert got.word == ref.word and got.word_bits == 64
    lv = got.L
    for a, b in ((ref.drop_last_tables(lv), got.drop_last_tables(lv)),
                 (ref.mod_down_tables(lv, 0), got.mod_down_tables(lv, 0))):
        assert a.q_last == b.q_last
        for f in ("half_mod", "inv_qlast", "inv_qlast_shoup", "q"):
            same_words(getattr(b, f), getattr(a, f), f)
    for a, b in zip(ref.decomp_tables(lv), got.decomp_tables(lv)):
        for f in ("inv_punc", "inv_punc_shoup", "src_q", "punc_mod_dst",
                  "dst_q", "dst_r0", "dst_r1"):
            same_words(getattr(b, f), getattr(a, f), f)
    md, tmd = ref.mod_down_onestep_tables(lv), got.mod_down_onestep_tables(lv)
    for f in ("half_p", "half_q", "inv_p", "inv_p_shoup", "p_mod_q"):
        same_words(getattr(tmd, f), getattr(md, f), f)
    for a, b in zip(ref.p_residues(lv), got.p_residues(lv)):
        same_words(b, a, "p_residues")
    assert np.array_equal(ref.const_residues(-12345, (0, 1, 4)),
                          got.const_residues(-12345, (0, 1, 4)))


def test_u64_keys_equal_reference(s):
    ref, got = s["ref"], s["got"]
    same_words(got["kg"].secret.ntt, ref["kg"].secret.ntt, "secret")
    same_words(got["relin"].data, ref["relin"].data, "relin")
    same_words(got["pk"].data, ref["pk"].data, "public")
    assert sorted(got["gk"].keys) == sorted(ref["gk"].keys)
    assert len(got["gk"].keys) == 3                       # 1, 3, conjugate
    for elt, k in ref["gk"].keys.items():
        same_words(got["gk"].keys[elt].data, k.data, f"galois {elt}")


def test_u64_encryptions_equal_reference(s):
    """Symmetric, seeded (c1 expanded from the port's seed on the JAX side)
    and public-key encryption, each by fresh encryptors of one seed."""
    ref, got = s["ref"], s["got"]
    jctx, ctx = ref["ctx"], got["ctx"]
    x = s["x"]
    jpt = ref_plain(jctx, x, jctx.params.scale, range(jctx.L))
    pt = got["ev"].make_plain(x, ctx.params.scale, ctx.L)
    same_words(pt.data, jpt.data, "encode")

    def pair(seed, **keys):
        return (JEncryptor(jctx, seed=seed, **keys["ref"]),
                Encryptor(ctx, seed=seed, **keys["got"]))

    sk = {side: dict(secret=s[side]["kg"].secret) for side in ("ref", "got")}
    jenc, enc = pair(11, **sk)
    ct = enc.encrypt(pt)
    assert ct.data.dtype == torch.int64
    same_words(ct, jenc.encrypt(jpt), "symmetric")
    jenc, enc = pair(12, **sk)
    got_ct, seed = enc.encrypt_symmetric_seeded(pt)
    mods = [jctx.all_moduli[i] for i in range(jctx.L)]
    a = jnp.asarray(jexpand_uniform(seed, jctx.n, mods, jctx.word))
    same_words(got_ct, jenc.encrypt_symmetric(jpt, a=a), "seeded")
    jenc, enc = pair(13, **{side: dict(public=s[side]["pk"])
                            for side in ("ref", "got")})
    same_words(enc.encrypt(pt), jenc.encrypt(jpt), "public key")


def test_u64_evaluator_ops_equal_reference(s):
    ref, got = s["ref"]["ev"], s["got"]["ev"]
    a, b, pa, pb = s["a"], s["b"], s["pa"], s["pb"]
    prod3 = got.multiply(pa, pb, relin=False)
    same_words(prod3, ref.multiply(a, b, relin=False), "multiply (no relin)")
    same_words(got.relinearize(prod3), ref.relinearize(
        ref.multiply(a, b, relin=False)), "relinearize")
    mul = got.multiply(pa, pb)
    jmul = ref.multiply(a, b)
    same_words(mul, jmul, "multiply+relin")
    same_words(got.rescale(mul), ref.rescale(jmul), "rescale")
    same_words(got.rotate(pa, 1), ref.rotate(a, 1), "rotate 1")
    assert got._hops(5) == ref._hops(5) == [3, 1, 1]
    same_words(got.rotate(pa, 5), ref.rotate(a, 5), "rotate 5 (3 hops)")
    same_words(got.conjugate(pa), ref.conjugate(a), "conjugate")
    same_words(got.add(pa, pb), ref.add(a, b), "add")
    same_words(got.sub(pa, pb), ref.sub(a, b), "sub")
    same_words(got.negate(pa), ref.negate(a), "negate")
    same_words(got.mul_const(pa, -0.75), ref.mul_const(a, -0.75), "mul_const")
    same_words(got.add_const(pa, 0.3), ref.add_const(a, 0.3), "add_const")
    jctx = s["ref"]["ctx"]
    jpt = ref_plain(jctx, s["y"], jctx.params.scale, range(jctx.L))
    pt = got.make_plain(s["y"], got.ctx.params.scale, got.ctx.L)
    same_words(got.mul_plain(pa, pt), ref.mul_plain(a, jpt), "mul_plain")
    same_words(got.mod_switch_drop(pa, 2), ref.mod_switch_drop(a, 2),
               "mod_switch_drop")


def test_u64_decryption_equals_reference_within_budgets(s):
    """decrypt_to_rns word for word (uint64 residues), and decrypt budgets
    at Δ=2^40: 1e-8 after encryption and after multiply+rescale (the
    encode round trip's bound in tests/test_ckks.py), and that file's 1e-5
    after rotations and conjugation (their key-switch noise is ~2.6e-8
    here, the JAX package's to the bit)."""
    ref, got = s["ref"], s["got"]
    ev, dec = got["ev"], got["dec"]
    pa, pb, x, y = s["pa"], s["pb"], s["x"], s["y"]
    res = dec.decrypt_to_rns(pa)
    assert res.dtype == np.uint64
    assert np.array_equal(res, np.asarray(ref["dec"].decrypt_to_rns(s["a"])))
    three = ev.multiply(pa, pb, relin=False)
    assert np.array_equal(dec.decrypt_to_rns(three), np.asarray(
        ref["dec"].decrypt_to_rns(ref["ev"].multiply(s["a"], s["b"],
                                                    relin=False))))
    assert np.abs(dec.decrypt(pa) - x).max() < 1e-8
    assert np.abs(dec.decrypt(ev.rescale(ev.multiply(pa, pb)))
                  - x * y).max() < 1e-8
    for k in (1, 5):
        assert np.abs(dec.decrypt(ev.rotate(pa, k))
                      - np.roll(x, -k)).max() < 1e-5
    assert np.abs(dec.decrypt(ev.conjugate(pa)) - x).max() < 1e-5
    pt = ev.make_plain(x, got["ctx"].params.scale, got["ctx"].L)
    assert np.abs(ev.decode_plain(pt) - x).max() < 1e-8


def test_context_rejects_a_modulus_past_the_u64_bound():
    p = CkksParams(n=1024, moduli=((1 << 62) + 1,), special=(12289,),
                   scale=2.0 ** 40)
    with pytest.raises(ValueError, match="2\\*\\*62"):
        CkksContext(p, device=CPU)
