"""The port's BSGS linear-transform engine and bootstrap FFT factors held
against the JAX package.

Tolerance: exact. Factors, specs and plans are the same numpy code
(``array_equal`` diagonals, equal plans); on the CKKS backends (CPU, both
packages' plain paths) ``apply_lt`` gives ``array_equal`` words with equal
scales, on the double-hoisted path and with ``no_ext_hoist``. Decrypts are
held to the w32 budget at Δ = 2^25 (1e-3).
"""

import numpy as np
import pytest

from fhe_gpt2_tpu.boot import fft as jfft
from fhe_gpt2_tpu.core.context import CkksContext as JContext
from fhe_gpt2_tpu.core.context import CkksParams as JParams
from fhe_gpt2_tpu.core.evaluator import Encryptor as JEncryptor
from fhe_gpt2_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_gpt2_tpu.core.keys import KeyGenerator as JKeyGenerator
from fhe_gpt2_tpu.nn import linear as jlinear
from fhe_gpt2_tpu.nn.backend import CkksBackend as JCkksBackend
from fhe_gpt2_tpu.nn.backend import PlainBackend as JPlainBackend

from fhe_gpt2_tpu_torch import carry
from fhe_gpt2_tpu_torch.boot import fft
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Evaluator
from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
from fhe_gpt2_tpu_torch.nn import linear
from fhe_gpt2_tpu_torch.nn.backend import CkksBackend, PlainBackend, \
    RecordingBackend

from torch_port_common import single_torch_thread  # noqa: F401

CPU = "cpu"
SLOTS = 1024                     # logN = 11


def _exp(ns):
    """The 5-orbit exponents of a subring of ns slots (Bootstrapper)."""
    e = np.zeros(ns, dtype=np.int64)
    g = 1
    for j in range(ns):
        e[j] = g % (4 * ns)
        g = g * 5 % (4 * SLOTS)
    return e


def _same_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("ns,inverse,factors", [
    (64, True, 2), (64, False, 2), (256, True, 3), (1024, False, 2)])
def test_fft_factors_equal_reference(ns, inverse, factors):
    e = _exp(ns)
    scale = 1.0 / (SLOTS // ns) if inverse else 1.0
    got = fft.build_fft_factors(ns, e, 4 * ns, inverse, factors, scale)
    ref = jfft.build_fft_factors(ns, e, 4 * ns, inverse, factors, scale)
    assert len(got) == len(ref) == factors
    for g, r in zip(got, ref):
        _same_dict(g, r)
    y = np.random.default_rng(ns).normal(size=ns) + 0j
    assert np.array_equal(fft.apply_factors_numpy(got, y),
                          jfft.apply_factors_numpy(ref, y))
    spec = fft.factor_to_ltspec(got[0], ns)
    jspec = jfft.factor_to_ltspec(ref[0], ns)
    assert spec.rotation_amounts == jspec.rotation_amounts
    _same_dict(spec.diagonals, jspec.diagonals)


def test_fft_factors_invert():
    """Encode direction after decode direction is the identity."""
    ns = 64
    e = _exp(ns)
    fwd = fft.build_fft_factors(ns, e, 4 * ns, False, 2)
    inv = fft.build_fft_factors(ns, e, 4 * ns, True, 2)
    y = np.random.default_rng(0).normal(size=ns) + 0j
    np.testing.assert_allclose(
        fft.apply_factors_numpy(inv, fft.apply_factors_numpy(fwd, y)), y,
        atol=1e-12)


def _triples(seed, n_src, n_dst, rhos, slots=SLOTS):
    rng = np.random.default_rng(seed)
    dst_ct, dst_slot, src_ct, src_slot, w = [], [], [], [], []
    for rho in rhos:
        for s in range(n_src):
            for d in range(n_dst):
                ds = rng.choice(slots, slots // 2, replace=False)
                dst_ct += [d] * len(ds)
                dst_slot += list(ds)
                src_ct += [s] * len(ds)
                src_slot += list((ds + rho) % slots)
                w += list(rng.uniform(-0.5, 0.5, len(ds)))
    return n_src, n_dst, dst_ct, dst_slot, src_ct, src_slot, w


RHOS = [0, 1, 3, 18, 40, 77]


def _specs(seed=1, n_src=2, n_dst=2):
    args = _triples(seed, n_src, n_dst, RHOS)
    return (linear.lt_from_triples(SLOTS, *args, name="t"),
            jlinear.lt_from_triples(SLOTS, *args, name="t"))


def _same_plan(p, jp):
    assert p.giant == jp.giant and p.baby_amounts == jp.baby_amounts
    assert p.num_rotations() == jp.num_rotations()
    assert sorted(p.groups) == sorted(jp.groups)
    for jg in jp.groups:
        assert sorted(p.groups[jg]) == sorted(jp.groups[jg])
        for dst, terms in jp.groups[jg].items():
            mine = p.groups[jg][dst]
            assert [t[:2] for t in mine] == [t[:2] for t in terms]
            for a, b in zip(mine, terms):
                assert np.array_equal(a[2], b[2])


@pytest.mark.parametrize("giant", [None, 8, 32])
def test_spec_and_bsgs_plan_equal_reference(giant):
    spec, jspec = _specs()
    assert spec.rotation_amounts == jspec.rotation_amounts == RHOS
    _same_dict(spec.diagonals, jspec.diagonals)
    _same_plan(spec.bsgs_plan(giant), jspec.bsgs_plan(giant))
    xs = np.random.default_rng(3).uniform(-1, 1, (2, SLOTS))
    want = linear.lt_matrix_oracle(spec, xs)
    assert np.array_equal(want, jlinear.lt_matrix_oracle(jspec, xs))
    # The plain backend through BSGS, fused and term by term, and unplanned.
    plan = spec.bsgs_plan(giant)
    got = linear.apply_lt(PlainBackend(SLOTS), plan, list(xs))
    ref = jlinear.apply_lt(JPlainBackend(SLOTS), jspec.bsgs_plan(giant),
                           list(xs))
    for g, r, w in zip(got, ref, want):
        assert np.array_equal(g, r)
        np.testing.assert_allclose(g, w, atol=1e-12)
    for g, w in zip(linear.apply_lt_unplanned(PlainBackend(SLOTS), spec,
                                              list(xs)), want):
        np.testing.assert_allclose(g, w, atol=1e-12)


def test_recording_backend_records_plan_steps():
    spec, _ = _specs()
    plan = spec.bsgs_plan()
    rec = RecordingBackend(SLOTS)
    linear.apply_lt(rec, plan, list(np.zeros((2, SLOTS))))
    want = sorted({a for a in plan.baby_amounts if a} | {g for g in plan.groups
                                                         if g})
    assert rec.key_steps() == want


@pytest.fixture(scope="module")
def ckks():
    """Both packages' CKKS backends on the single-prime w32 chain at
    logN=11, with keys for the test plan's rotations."""
    kw = dict(logn=11, log_q0=29, log_scale=25, num_levels=4, log_special=31,
              num_special=2, hamming_weight=16)
    jctx = JContext(JParams.create(**kw))
    ctx = CkksContext(CkksParams.create(**kw), device=CPU)
    spec, jspec = _specs()
    plan, jplan = spec.bsgs_plan(), jspec.bsgs_plan()
    steps = sorted({a for a in plan.baby_amounts if a} | set(plan.groups)
                   | set(RHOS))
    jkg, kg = JKeyGenerator(jctx, seed=3), KeyGenerator(ctx, seed=3)
    jev = JEvaluator(jctx, relin_key=jkg.relin_key(),
                     galois_keys=jkg.galois_keys(steps))
    ev = Evaluator(ctx, relin_key=kg.relin_key(),
                   galois_keys=kg.galois_keys(steps))
    enc = JEncryptor(jctx, secret=jkg.secret, seed=4)
    xs = np.random.default_rng(3).uniform(-1, 1, (2, SLOTS))
    jcts = [enc.encrypt(jev.make_plain(x, jctx.params.scale, jctx.L))
            for x in xs]
    return dict(ctx=ctx, jctx=jctx, ev=ev, jev=jev, spec=spec, plan=plan,
                jplan=jplan, xs=xs, jcts=jcts, dec=Decryptor(ctx, kg.secret))


def _port(jct):
    return carry.ciphertext_from_reference(np.asarray(jct.data), jct.scale, CPU)


def _same_ct(got, ref):
    assert got.scale == ref.scale
    assert np.array_equal(carry.to_numpy(got), np.asarray(ref.data))


@pytest.mark.parametrize("no_ext_hoist", [False, True])
def test_apply_lt_on_ckks_equals_reference(ckks, no_ext_hoist):
    """Two sources, two destinations: the double-hoisted path stacks the
    sources into one decomposition and batches the giant steps; the
    single-hoisted path mod-downs each baby rotation."""
    c = ckks
    B = CkksBackend(ctx=c["ctx"], ev=c["ev"], no_ext_hoist=no_ext_hoist)
    jB = JCkksBackend(ctx=c["jctx"], ev=c["jev"], no_ext_hoist=no_ext_hoist)
    ref = jlinear.apply_lt(jB, c["jplan"], c["jcts"])
    got = linear.apply_lt(B, c["plan"], [_port(x) for x in c["jcts"]])
    want = linear.lt_matrix_oracle(c["spec"], c["xs"])
    for g, r, w in zip(got, ref, want):
        _same_ct(g, r)
        assert np.max(np.abs(np.real(c["dec"].decrypt(g)) - w)) < 1e-3


BACKEND_OPS = {
    "mul_plain_many_sum": lambda B, a, b, m: B.mul_plain_many_sum(
        [a, b, a], [m[0], m[1], m[0] * 0.5]),
    "take_batch": lambda B, a, b, m: B.take_batch(B.stack([a, b, a]), (1,)),
    "reduce_sum_batch": lambda B, a, b, m: B.reduce_sum_batch(B.stack([a, b])),
    "mul_plain_batched_mask": lambda B, a, b, m: B.mul_plain(
        B.stack([a, b]), m),
    "rotate_many": lambda B, a, b, m: B.rotate_many(a, [0, 1, 40])[2],
    "mul": lambda B, a, b, m: B.mul(a, b),
    "sub": lambda B, a, b, m: B.sub(B.mul_const(a, 0.3), b),
    "unstack": lambda B, a, b, m: B.unstack(B.stack([a, b]))[1],
}


@pytest.mark.parametrize("op", sorted(BACKEND_OPS))
def test_backend_op_equals_reference(ckks, op):
    c = ckks
    B = CkksBackend(ctx=c["ctx"], ev=c["ev"])
    jB = JCkksBackend(ctx=c["jctx"], ev=c["jev"])
    m = np.random.default_rng(4).uniform(-1, 1, (2, SLOTS))
    ja, jb = c["jcts"]
    ref = BACKEND_OPS[op](jB, ja, jb, m)
    got = BACKEND_OPS[op](B, _port(ja), _port(jb), m)
    _same_ct(got, ref)
