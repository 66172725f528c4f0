"""The port's core (fhe_gpt2_tpu_torch) held against the JAX package on the
CPU: modular arithmetic, primes and moduli chains, NTT tables, the plain
NTT/iNTT, and every context table. Residues are canonical on both sides, so
every comparison is ``array_equal`` (bit for bit).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fhe_gpt2_tpu.core import modmath as jmod
from fhe_gpt2_tpu.core import ntt as jntt
from fhe_gpt2_tpu.core import primes as jprimes
from fhe_gpt2_tpu.core import rns as jrns
from fhe_gpt2_tpu.core import tntt as jtntt
from fhe_gpt2_tpu.core.context import CkksContext as JContext
from fhe_gpt2_tpu.core.context import CkksParams as JParams
from fhe_gpt2_tpu.core.evaluator import mod_sum as jmod_sum
from fhe_gpt2_tpu.core.keys import digit_steps as jdigit_steps

from fhe_gpt2_tpu_torch.core import modmath as tmod
from fhe_gpt2_tpu_torch.core import ntt as tntt
from fhe_gpt2_tpu_torch.core import primes as tprimes
from fhe_gpt2_tpu_torch.core import rns as trns
from fhe_gpt2_tpu_torch.core import tntt as ttntt
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.keys import digit_steps
from fhe_gpt2_tpu_torch.carry import to_numpy

CPU = "cpu"


def _t(a):
    """uint32 numpy -> the port's int32 tensor (same bits)."""
    return tmod.word_tensor(np.asarray(a), CPU)


def _residues(rng, moduli, shape_prefix=(), n=256):
    cols = [rng.integers(0, q, size=shape_prefix + (n,), dtype=np.uint64)
            .astype(np.uint32) for q in moduli]
    return np.stack(cols, axis=-2)


# -- modmath -----------------------------------------------------------------

MODULI_SETS = {
    "scale25": jprimes.gen_primes_balanced(25, 3, 4096),
    "special31": jprimes.gen_primes(31, 3, 4096),
    "mixed": [jprimes.gen_primes(29, 1, 4096)[0],
              jprimes.gen_primes(31, 1, 4096)[0], 12289],
}


@pytest.mark.parametrize("name", sorted(MODULI_SETS))
def test_modmath_ops_equal_reference(name):
    mods = MODULI_SETS[name]
    rng = np.random.default_rng(11)
    a = _residues(rng, mods)
    b = _residues(rng, mods)
    q = np.array(mods, dtype=np.uint32).reshape(-1, 1)
    r = [jmod.barrett_ratio(m, 32) for m in mods]
    r0 = np.array([x[0] for x in r], dtype=np.uint32).reshape(-1, 1)
    r1 = np.array([x[1] for x in r], dtype=np.uint32).reshape(-1, 1)
    w = b[:, :1]                                   # one constant per limb
    ws = np.array([jmod.shoup(int(w[i, 0]), m, 32) for i, m in enumerate(mods)],
                  dtype=np.uint32).reshape(-1, 1)
    ja, jb, jq = jnp.asarray(a), jnp.asarray(b), jnp.asarray(q)
    ta, tb, tq = _t(a), _t(b), _t(q)
    pairs = [
        (jmod.add_mod(ja, jb, jq), tmod.add_mod(ta, tb, tq)),
        (jmod.sub_mod(ja, jb, jq), tmod.sub_mod(ta, tb, tq)),
        (jmod.neg_mod(ja, jq), tmod.neg_mod(ta, tq)),
        (jmod.mul_mod(ja, jb, jq, jnp.asarray(r0), jnp.asarray(r1)),
         tmod.mul_mod(ta, tb, tq)),
        (jmod.mul_mod_shoup(ja, jnp.asarray(w), jnp.asarray(ws), jq),
         tmod.mul_mod_shoup(ta, _t(w), _t(ws), tq)),
        (jmod_sum(ja.reshape(3, 1, -1).repeat(5, axis=1), jq,
                  jnp.asarray(r1), axis=1),
         tmod.mod_sum(ta.reshape(3, 1, -1).repeat(1, 5, 1), tq, axis=1)),
    ]
    for ref, got in pairs:
        assert np.array_equal(np.asarray(ref), to_numpy(got))


def test_modmath_host_helpers():
    for q in MODULI_SETS["mixed"]:
        assert tmod.barrett_ratio(q) == jmod.barrett_ratio(q, 32)
        assert tmod.shoup(q - 1, q) == jmod.shoup(q - 1, q, 32)
    mods = MODULI_SETS["scale25"]
    assert tmod.word_dtype(mods) == jmod.word_dtype(mods) == np.uint32
    assert tmod.word_bits_of(np.uint32) == 32
    for slots, base in ((1024, 16), (512, 4)):
        assert digit_steps(slots, base) == jdigit_steps(slots, base)


# -- primes and moduli chains --------------------------------------------------

def test_primes_equal_reference():
    two_n = 1 << 12
    assert tprimes.gen_primes(31, 4, two_n) == jprimes.gen_primes(31, 4, two_n)
    assert (tprimes.gen_primes_balanced(25, 7, two_n)
            == jprimes.gen_primes_balanced(25, 7, two_n))
    assert (tprimes.gen_prime_pairs(50, 3, two_n)
            == jprimes.gen_prime_pairs(50, 3, two_n))
    for q in MODULI_SETS["mixed"]:
        assert tprimes.root_of_unity(two_n, q) == jprimes.root_of_unity(two_n, q)
        assert tprimes.mod_inverse(12345, q) == jprimes.mod_inverse(12345, q)


CHAINS = [
    ("create", dict(logn=11, log_q0=29, log_scale=25, num_levels=6,
                    log_special=31, num_special=2, hamming_weight=16)),
    ("create", dict(logn=15, log_q0=29, log_scale=25, num_levels=22,
                    log_special=31, num_special=8, hamming_weight=192)),
    ("create_composite", dict(logn=11, num_levels=4, num_special=3)),
    ("create_composite", dict(logn=15, num_levels=4, num_special=3,
                              hamming_weight=192)),
]


@pytest.mark.parametrize("ctor,kw", CHAINS)
def test_moduli_chains_equal_reference(ctor, kw):
    ref = getattr(JParams, ctor)(**kw)
    got = getattr(CkksParams, ctor)(**kw)
    for f in ("n", "moduli", "special", "scale", "hamming_weight",
              "rescale_limbs", "base_limbs"):
        assert getattr(got, f) == getattr(ref, f), f


# -- NTT -------------------------------------------------------------------------

_NTT_FIELDS = ("q", "ratio0", "ratio1", "roots", "roots_shoup", "inv_roots",
               "inv_roots_shoup", "n_inv", "n_inv_shoup")


def _tables(mods, n=2048):
    return (jntt.make_ntt_tables(mods, n, fourstep=True),
            tntt.make_ntt_tables(mods, n, device=CPU))


@pytest.fixture(scope="module")
def single_tables():
    return _tables(jprimes.gen_primes_balanced(25, 3, 4096))


@pytest.fixture(scope="module")
def composite_tables():
    return _tables(JParams.create_composite(logn=11, num_levels=1,
                                            num_special=1).moduli)


@pytest.mark.parametrize("which", ["single_tables", "composite_tables"])
def test_ntt_tables_equal_reference(which, request):
    ref, got = request.getfixturevalue(which)
    for f in _NTT_FIELDS:
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              to_numpy(getattr(got, f))), f
    assert got.moduli == ref.moduli and got.psi == ref.psi
    assert (got.n, got.logn) == (ref.n, ref.logn)


@pytest.mark.parametrize("which", ["single_tables", "composite_tables"])
@pytest.mark.parametrize("prefix", [(), (2, 3)])
def test_plain_ntt_equals_reference_and_fourstep(which, prefix, request):
    """Forward and inverse, against the XLA stage loop and the Pallas
    four-step kernel in interpret mode (the tests/test_pallas_ntt.py cases),
    over plain and batched leading dims."""
    ref, got = request.getfixturevalue(which)
    x = _residues(np.random.default_rng(7), ref.moduli, prefix, ref.n)
    f_ref = np.asarray(jntt._ntt_stages(jnp.asarray(x), ref))
    f_fs = np.asarray(jtntt.fourstep_ntt(jnp.asarray(x), ref.fs, interpret=True))
    f_got = to_numpy(tntt.ntt(_t(x), got))
    assert np.array_equal(f_got, f_ref)
    assert np.array_equal(f_got, f_fs)
    i_ref = np.asarray(jntt._intt_stages(jnp.asarray(f_ref), ref))
    i_fs = np.asarray(jtntt.fourstep_intt(jnp.asarray(f_ref), ref.fs,
                                          interpret=True))
    i_got = to_numpy(tntt.intt(_t(f_ref), got))
    assert np.array_equal(i_got, i_ref)
    assert np.array_equal(i_got, i_fs)
    assert np.array_equal(i_got, x)


def test_plain_ntt_limb_slice(single_tables):
    ref, got = single_tables
    sub_ref, sub_got = ref.slice([0, 2]), got.slice([0, 2])
    x = _residues(np.random.default_rng(7), ref.moduli, (), ref.n)[[0, 2]]
    want = np.asarray(jtntt.fourstep_ntt(jnp.asarray(x), sub_ref.fs,
                                         interpret=True))
    assert np.array_equal(to_numpy(tntt.ntt(_t(x), sub_got)), want)
    assert np.array_equal(
        np.asarray(jntt._ntt_stages(jnp.asarray(x), sub_ref)), want)


def test_host_oracle_and_galois_maps():
    n = 32
    q = jprimes.gen_primes(25, 1, 2 * n)[0]
    t = tntt.make_ntt_tables([q], n, device=CPU)
    x = np.random.default_rng(3).integers(0, q, n)
    want = tntt.host_ntt([int(v) for v in x], q, t.psi[0])
    assert want == jntt.host_ntt([int(v) for v in x], q, t.psi[0])
    got = to_numpy(tntt.ntt(_t(x.astype(np.uint32)[None]), t))[0]
    assert [int(v) for v in got] == want
    assert tntt.host_intt(want, q, t.psi[0]) == [int(v) for v in x]
    assert np.array_equal(tntt.point_exponents(n), jntt.point_exponents(n))
    for elt in (5, 25, 2 * n - 1):
        assert np.array_equal(tntt.galois_ntt_permutation(n, elt),
                              jntt.galois_ntt_permutation(n, elt))
        for a, b in zip(tntt.galois_coeff_maps(n, elt),
                        jntt.galois_coeff_maps(n, elt)):
            assert np.array_equal(a, b)


# -- context tables ---------------------------------------------------------------

@pytest.fixture(scope="module", params=["single", "composite"])
def contexts(request):
    if request.param == "single":
        kw = dict(logn=11, log_q0=29, log_scale=25, num_levels=5,
                  log_special=31, num_special=2, hamming_weight=16)
        ref_p, got_p = JParams.create(**kw), CkksParams.create(**kw)
    else:
        kw = dict(logn=11, num_levels=3, num_special=3, hamming_weight=16)
        ref_p, got_p = JParams.create_composite(**kw), \
            CkksParams.create_composite(**kw)
    return JContext(ref_p), CkksContext(got_p, device=CPU)


def _eq(ref, got):
    return np.array_equal(np.asarray(ref), to_numpy(got))


def _bct_equal(ref, got):
    assert ref.src == got.src and ref.dst == got.dst
    for f in ("inv_punc", "inv_punc_shoup", "src_q", "punc_mod_dst", "dst_q",
              "dst_r0", "dst_r1"):
        assert _eq(getattr(ref, f), getattr(got, f)), f


def _mdt_equal(ref, got):
    _bct_equal(ref.bct, got.bct)
    for f in ("half_p", "half_q", "inv_p", "inv_p_shoup", "p_mod_q"):
        assert _eq(getattr(ref, f), getattr(got, f)), f
    assert np.array_equal(np.asarray(ref.p_invf), got.p_invf.numpy())


def test_context_tables_equal_reference(contexts):
    ref, got = contexts
    assert got.all_moduli == ref.all_moduli and got.device.type == "cpu"
    for lv in (got.L, got.L - got.rescale_limbs):
        for limbs in (lv, got.key_limbs(lv)):
            for f in _NTT_FIELDS:
                assert _eq(getattr(ref.tables(limbs), f),
                           getattr(got.tables(limbs), f)), (limbs, f)
        assert got.key_limbs(lv) == ref.key_limbs(lv)
        assert got.digit_groups(lv) == ref.digit_groups(lv)
        assert got.num_digits(lv) == ref.num_digits(lv)
        for rb, gb in zip(ref.decomp_tables(lv), got.decomp_tables(lv)):
            _bct_equal(rb, gb)
        _mdt_equal(ref.mod_down_onestep_tables(lv),
                   got.mod_down_onestep_tables(lv))
        fr, fg = ref.fused_ks_tables(lv), got.fused_ks_tables(lv)
        assert (fr.D, fr.A) == (fg.D, fg.A)
        for f in ("own", "pw", "inv_punc", "inv_punc_shoup", "src_q"):
            assert np.array_equal(np.asarray(getattr(fr, f)),
                                  to_numpy(getattr(fg, f)).astype(
                                      np.asarray(getattr(fr, f)).dtype)), f
        assert np.array_equal(np.asarray(fr.gather), fg.gather.numpy())
    lv = got.L
    if got.rescale_limbs == 1:
        dr, dg = ref.drop_last_tables(lv), got.drop_last_tables(lv)
        assert dr.q_last == dg.q_last and int(dr.half) == dg.half
        for f in ("half_mod", "inv_qlast", "inv_qlast_shoup", "q"):
            assert _eq(getattr(dr, f), getattr(dg, f)), f
    else:
        _mdt_equal(ref.rescale_pair_tables(lv), got.rescale_pair_tables(lv))
        fmd = got.fused_md_tables(lv, pair=True)
        assert (fmd.k, fmd.l) == (2, lv - 2)
    for elt in (got.galois_elt_from_step(3), got.galois_elt_conjugate):
        assert np.array_equal(np.asarray(ref.galois_perm(elt)),
                              got.galois_perm(elt).numpy())
    assert got.step_from_elt(got.galois_elt_from_step(7)) == 7
    assert ref.galois_elt_from_step(7) == got.galois_elt_from_step(7)
    assert np.array_equal(ref.slot_to_index, got.slot_to_index)
    assert np.array_equal(ref.conj_slot_to_index, got.conj_slot_to_index)
    assert np.array_equal(ref.const_residues(-12345, (0, 1, 2)),
                          got.const_residues(-12345, (0, 1, 2)))


def test_context_rejects_u64_chain():
    params = CkksParams.create(logn=11, log_q0=50, log_scale=40, num_levels=2,
                               log_special=51)
    with pytest.raises(NotImplementedError):
        CkksContext(params, device=CPU)


def test_wrapper_refuses_foreign_device(single_tables):
    """No silent route: a tensor on neither the CPU nor the card raises."""
    _, got = single_tables
    x = torch.zeros((3, got.n), dtype=torch.int32, device="meta")
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        ttntt.ntt_forward(x, got)


def test_divide_round_last_equals_reference(contexts):
    ref, got = contexts
    lv = got.L
    rng = np.random.default_rng(9)
    x = _residues(rng, got.moduli[:lv - 1], (2,), got.n)
    last = _residues(rng, [got.moduli[lv - 1]], (2,), got.n)[..., 0, :]
    want = jrns.divide_round_last(jnp.asarray(x), jnp.asarray(last),
                                  ref.drop_last_tables(lv))
    out = trns.divide_round_last(_t(x), _t(last), got.drop_last_tables(lv))
    assert np.array_equal(to_numpy(out), np.asarray(want))
