"""The port's approximation machinery held against the JAX package: the
Remez exchange, the Chebyshev plans and their evaluation, and the EvalMod
polynomials read from the port's own cache.

Tolerance: exact. The host code is the same numpy/mpmath code, so
coefficients, plans and plain-backend values are ``array_equal``; on the
CKKS backends (CPU, both packages' plain paths) the evaluated ciphertexts
are ``array_equal`` words with equal scales.
"""

import os

import numpy as np
import pytest
from mpmath import mpf, cos as mp_cos

from fhe_gpt2_tpu.approx import chebeval as jcheb
from fhe_gpt2_tpu.approx import remez as jremez
from fhe_gpt2_tpu.boot.bootstrap import eval_mod as jeval_mod
from fhe_gpt2_tpu.boot.bootstrap import make_evalmod as jmake_evalmod
from fhe_gpt2_tpu.core.context import CkksContext as JContext
from fhe_gpt2_tpu.core.context import CkksParams as JParams
from fhe_gpt2_tpu.core.evaluator import Encryptor as JEncryptor
from fhe_gpt2_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_gpt2_tpu.core.keys import KeyGenerator as JKeyGenerator
from fhe_gpt2_tpu.nn.backend import CkksBackend as JCkksBackend
from fhe_gpt2_tpu.nn.backend import PlainBackend as JPlainBackend

from fhe_gpt2_tpu_torch import carry
from fhe_gpt2_tpu_torch.approx import chebeval, remez
from fhe_gpt2_tpu_torch.boot import bootstrap as tboot
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Evaluator
from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
from fhe_gpt2_tpu_torch.nn.backend import CkksBackend, PlainBackend

from torch_port_common import single_torch_thread  # noqa: F401

CPU = "cpu"


def _target(x):
    return mp_cos(3 * x) / 2


def _target_np(x):
    return np.cos(3 * np.asarray(x)) / 2


@pytest.mark.parametrize("odd,use_np", [(False, True), (False, False),
                                        (True, True)])
def test_remez_equals_reference(odd, use_np):
    """A small minimax problem, with and without the float64 scan, and an
    odd fit: the same mpf coefficients, error and float coefficients."""
    if odd:
        f, fnp = (lambda x: x / (1 + x * x)), (lambda x: x / (1 + x * x))
        ivs = [(mpf("0.05"), mpf("0.9"))]
        deg = 7
    else:
        f, fnp = _target, _target_np
        ivs = [(mpf(-1), mpf("-0.2")), (mpf("0.1"), mpf(1))]
        deg = 9
    kw = dict(odd=odd, prec_dps=30, scan=200,
              func_np=fnp if use_np else None)
    poly, err = remez.remez(f, ivs, deg, **kw)
    jpoly, jerr = jremez.remez(f, ivs, deg, **kw)
    assert poly.coeffs == jpoly.coeffs and err == jerr
    assert (poly.lo, poly.hi) == (jpoly.lo, jpoly.hi)
    assert np.array_equal(remez.to_float_coeffs(poly),
                          jremez.to_float_coeffs(jpoly))
    assert poly.monomial_coeffs() == jpoly.monomial_coeffs()
    assert poly(mpf("0.3")) == jpoly(mpf("0.3"))


def test_cheb_interp_equals_reference():
    a = remez.cheb_interp(np.tanh, -2.0, 3.0, 12)
    b = jremez.cheb_interp(np.tanh, -2.0, 3.0, 12)
    assert a.coeffs == b.coeffs and (a.lo, a.hi) == (b.lo, b.hi)


def _same_node(a, b):
    if a.leaf_coeffs is not None or b.leaf_coeffs is not None:
        assert np.array_equal(a.leaf_coeffs, b.leaf_coeffs)
        return
    assert a.m == b.m
    _same_node(a.q, b.q)
    _same_node(a.r, b.r)


@pytest.mark.parametrize("degree,k", [(7, None), (30, None), (59, None),
                                      (20, 4)])
def test_make_plan_equals_reference(degree, k):
    c = np.random.default_rng(degree).normal(size=degree + 1)
    p, jp = chebeval.make_plan(c, -3.0, 2.0, k), jcheb.make_plan(c, -3.0, 2.0, k)
    assert np.array_equal(p.coeffs, jp.coeffs)
    assert (p.lo, p.hi, p.k, p.giants, p.degree) == \
        (jp.lo, jp.hi, jp.k, jp.giants, jp.degree)
    _same_node(p.root, jp.root)
    x = np.linspace(-3, 2, 101)
    assert np.array_equal(chebeval.eval_cheb_numpy(c, -3.0, 2.0, x),
                          jcheb.eval_cheb_numpy(c, -3.0, 2.0, x))
    # On the plain backend the plan evaluates the same float64 ops.
    got = chebeval.eval_plan(PlainBackend(101), p, x)
    assert np.array_equal(got, jcheb.eval_plan(JPlainBackend(101), jp, x))
    np.testing.assert_allclose(got, chebeval.eval_cheb_numpy(c, -3.0, 2.0, x),
                               rtol=1e-9, atol=1e-9)


# (K, eps, degree, prec) of the EvalMod sets the port's tests and
# chip_smoke.py read.
EVALMOD = [(12, 2 ** -5 * 1.05, 45, 60), (25, 0.0328, 59, 80)]


@pytest.mark.parametrize("K,eps,degree,prec", EVALMOD)
def test_evalmod_from_port_cache_equals_reference(K, eps, degree, prec):
    """make_evalmod reads the port's copy of the cache (never the JAX
    package's directory) and builds the same plans; eval_mod on the plain
    backend gives the same values."""
    kw = dict(K=K, eps=eps, degree=degree, arcsin_degree=3, prec_dps=prec)
    path = tboot.evalmod_cache_path(num_double=2, **kw)
    assert os.path.exists(path) and "fhe_gpt2_tpu_torch" in path
    em, jem = tboot.make_evalmod(**kw), jmake_evalmod(**kw)
    for a, b in ((em.cos_plan, jem.cos_plan), (em.arcsin_plan, jem.arcsin_plan)):
        assert np.array_equal(a.coeffs, b.coeffs) and (a.lo, a.hi) == (b.lo, b.hi)
        _same_node(a.root, b.root)
    em, jem = em.with_amplitude(32.0), jem.with_amplitude(32.0)
    assert np.array_equal(em.arcsin_plan.coeffs, jem.arcsin_plan.coeffs)
    rng = np.random.default_rng(0)
    x = rng.integers(-K, K + 1, 256) + rng.uniform(-eps, eps, 256)
    got = tboot.eval_mod(PlainBackend(256), x, em)
    assert np.array_equal(got, jeval_mod(JPlainBackend(256), x, jem))


@pytest.fixture(scope="module")
def backends():
    """CKKS backends of both packages on a composite chain at logN=11 with
    the depth a degree-7 plan needs."""
    kw = dict(logn=11, num_levels=5, num_special=2, hamming_weight=16)
    jctx = JContext(JParams.create_composite(**kw))
    ctx = CkksContext(CkksParams.create_composite(**kw), device=CPU)
    jkg, kg = JKeyGenerator(jctx, seed=3), KeyGenerator(ctx, seed=3)
    jB = JCkksBackend(ctx=jctx, ev=JEvaluator(jctx, relin_key=jkg.relin_key()))
    B = CkksBackend(ctx=ctx, ev=Evaluator(ctx, relin_key=kg.relin_key()))
    x = np.random.default_rng(2).uniform(-1, 1, jctx.params.slots)
    jct = JEncryptor(jctx, secret=jkg.secret, seed=4).encrypt(
        jB.ev.make_plain(x, jctx.params.scale, jctx.L))
    return B, jB, x, jct, Decryptor(ctx, kg.secret)


def test_eval_plan_on_ckks_equals_reference(backends):
    """A degree-7 plan (baby steps T1, T2, giant T4, one split) on a
    ciphertext: the same words and scale, and the polynomial's values."""
    B, jB, x, jct, dec = backends
    c = np.random.default_rng(7).normal(size=8) / 4
    p, jp = chebeval.make_plan(c, -1.0, 1.0), jcheb.make_plan(c, -1.0, 1.0)
    assert p.giants and p.root.leaf_coeffs is None
    ref = jcheb.eval_plan(jB, jp, jct)
    got = chebeval.eval_plan(B, p, carry.ciphertext_from_reference(
        np.asarray(jct.data), jct.scale, CPU))
    assert got.scale == ref.scale
    assert np.array_equal(carry.to_numpy(got), np.asarray(ref.data))
    want = chebeval.eval_cheb_numpy(c, -1.0, 1.0, x)
    assert np.max(np.abs(np.real(dec.decrypt(got)) - want)) < 1e-6
