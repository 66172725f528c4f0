"""The port's NTT on the u64 engine (int64 words) against the JAX package.

The tables of a u64 chain (moduli of 40 to 60 bits) equal
``fhe_gpt2_tpu.core.ntt.make_ntt_tables`` word for word as uint64, Shoup
and Barrett words included; ``ntt``/``intt`` equal the JAX ones (jitted,
which take the stage loop ``_ntt_stages``/``_intt_stages`` on a u64 chain)
at logN=10 and 11, batched and on limb subsets; and a product of
transforms is the negacyclic convolution of Python ints.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_gpt2_tpu.core import ntt as jntt
from fhe_gpt2_tpu_torch.carry import to_numpy
from fhe_gpt2_tpu_torch.core import ntt as nttmod
from fhe_gpt2_tpu_torch.core import primes, tntt
from fhe_gpt2_tpu_torch.core.modmath import mul_mod, word_tensor

FIELDS = ("q", "ratio0", "ratio1", "roots", "roots_shoup", "inv_roots",
          "inv_roots_shoup", "n_inv", "n_inv_shoup")


def _moduli(n):
    """q0 of 50 bits, two 40-bit scale primes, a 60-bit special (the width
    of gpt2_params' special prime) and a 61-bit one."""
    two_n = 2 * n
    return (primes.gen_primes(50, 1, two_n) + primes.gen_primes(40, 2, two_n)
            + primes.gen_primes(60, 1, two_n) + primes.gen_primes(61, 1, two_n))


@pytest.fixture(scope="module", params=[10, 11])
def tables(request):
    n = 1 << request.param
    mods = _moduli(n)
    return jntt.make_ntt_tables(mods, n), nttmod.make_ntt_tables(mods, n,
                                                                 "cpu")


def _residues(rng, moduli, lead, n):
    x = np.stack([rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
                  for q in moduli], axis=-2)
    return x, word_tensor(x, "cpu", word=np.uint64)


def test_tables_equal_reference_word_for_word(tables):
    ref, got = tables
    assert got.q.dtype == torch.int64
    assert got.moduli == ref.moduli and got.psi == ref.psi
    for f in FIELDS:
        want = np.asarray(getattr(ref, f))
        assert want.dtype == np.uint64, f
        assert np.array_equal(to_numpy(getattr(got, f)), want), f


def test_powers_of_a_60_bit_modulus():
    q = primes.gen_primes(60, 1, 1 << 12)[0]
    psi = primes.root_of_unity(1 << 12, q)
    got = nttmod._powers(psi, 100, q)
    assert [int(v) for v in got] == [pow(psi, e, q) for e in range(100)]


@pytest.mark.parametrize("lead,limbs", [((), (0, 1, 2, 3, 4)), ((3,), (0, 1)),
                                        ((2, 2), (1, 3, 4)), ((), (4,))])
def test_ntt_equals_reference_stages(tables, lead, limbs):
    ref, got = tables
    rt, gt = ref.slice(list(limbs)), got.slice(list(limbs))
    x, xt = _residues(np.random.default_rng(len(lead) + len(limbs)),
                      gt.moduli, lead, gt.n)
    want = np.asarray(jntt.ntt(jnp.asarray(x), rt))   # jitted stage loop
    fwd = nttmod.ntt(xt, gt)
    assert fwd.dtype == torch.int64
    assert np.array_equal(to_numpy(fwd), want)
    assert np.array_equal(to_numpy(tntt.ntt_forward(xt, gt)), want)
    back = nttmod.intt(fwd, gt)
    assert np.array_equal(to_numpy(back), np.asarray(
        jntt.intt(jnp.asarray(want), rt)))
    assert np.array_equal(to_numpy(back), x)


def test_ntt_product_is_the_negacyclic_convolution(tables):
    """NTT(a)·NTT(b) -> iNTT equals a·b mod (X^N + 1) over Python ints, on
    the 60- and 61-bit limbs (whose products need the full 124 bits)."""
    _, got = tables
    t = got.slice([3, 4])
    n = t.n
    rng = np.random.default_rng(3)
    a, at = _residues(rng, t.moduli, (), n)
    b, bt = _residues(rng, t.moduli, (), n)
    prod = nttmod.intt(mul_mod(nttmod.ntt(at, t), nttmod.ntt(bt, t), t.q,
                               t.ratio0, t.ratio1), t)
    k = 16                                   # check the first k coefficients
    for li, q in enumerate(t.moduli):
        al = [int(v) for v in a[li]]
        bl = [int(v) for v in b[li]]
        want = []
        for i in range(k):
            s = 0
            for j in range(n):
                c = al[j] * bl[(i - j) % n]
                s += c if j <= i else -c
            want.append(s % q)
        assert [int(v) for v in to_numpy(prod)[li, :k]] == want
