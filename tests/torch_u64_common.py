"""Shared set-up of the port's u64-engine CPU tests
(tests/test_torch_u64_{core,core_hoist,net,nn}.py).

``u64_pair`` builds both packages on one u64 chain (``test_params``' shape:
q0 of 50 bits, 40-bit scale primes, 51-bit special primes, h=16) with keys
from the same seed, and encodes the JAX inputs through
``torch_port_common.ref_plain``. The port runs on the CPU and takes its
int64 route; the JAX package takes its u64 XLA path.
"""

import numpy as np

from fhe_gpt2_tpu.core.context import CkksContext as JContext
from fhe_gpt2_tpu.core.context import CkksParams as JParams
from fhe_gpt2_tpu.core.evaluator import Decryptor as JDecryptor
from fhe_gpt2_tpu.core.evaluator import Encryptor as JEncryptor
from fhe_gpt2_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_gpt2_tpu.core.keys import KeyGenerator as JKeyGenerator

from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Encryptor, Evaluator
from fhe_gpt2_tpu_torch.core.keys import KeyGenerator

from fhe_gpt2_tpu.core.evaluator import stack_cts as jstack_cts
from torch_port_common import CPU, ref_plain, to_port


def u64_params(cls, logn=11, levels=4, num_special=1):
    """``test_params(logn, levels)`` with `num_special` special primes."""
    return cls.create(logn=logn, log_q0=50, log_scale=40, num_levels=levels,
                      log_special=51, num_special=num_special,
                      hamming_weight=16)


def u64_pair(logn=11, levels=4, num_special=1, steps=(1, 3)):
    """Both packages on one u64 chain: contexts, key generators (seed 3),
    evaluators with relinearization, Galois (`steps`) and conjugation
    keys, public keys, encryptors (seed 4; public-key ones seed 5) and
    decryptors, the slot values ``x``/``y`` and their JAX ciphertexts
    ``a``/``b`` at the chain top."""
    out = {}
    for side, P, C, KG, EV, ENC, DEC in (
            ("ref", JParams, JContext, JKeyGenerator, JEvaluator, JEncryptor,
             JDecryptor),
            ("got", CkksParams, CkksContext, KeyGenerator, Evaluator,
             Encryptor, Decryptor)):
        p = u64_params(P, logn, levels, num_special)
        ctx = C(p) if side == "ref" else C(p, device=CPU)
        kg = KG(ctx, seed=3)
        relin, gk = kg.relin_key(), kg.galois_keys(list(steps),
                                                   conjugate=True)
        pk = kg.public_key()
        out[side] = dict(
            ctx=ctx, kg=kg, relin=relin, gk=gk, pk=pk,
            ev=EV(ctx, relin_key=relin, galois_keys=gk),
            enc=ENC(ctx, secret=kg.secret, seed=4),
            enc_pk=ENC(ctx, public=pk, seed=5), dec=DEC(ctx, kg.secret))
    jctx = out["ref"]["ctx"]
    rng = np.random.default_rng(1)
    out["x"], out["y"] = (rng.uniform(-1, 1, jctx.params.slots)
                          for _ in range(2))
    enc = out["ref"]["enc"]
    out["a"], out["b"] = (enc.encrypt(ref_plain(jctx, v, jctx.params.scale,
                                                range(jctx.L)))
                          for v in (out["x"], out["y"]))
    out["pa"], out["pb"] = to_port(out["a"]), to_port(out["b"])
    return out


# -- the u64 bootstrap of tests/test_bootstrap.py::test_full_bootstrap ------

BOOT_NS = 64
BOOT_PARAMS = dict(logn=10, log_q0=45, log_scale=40, num_levels=22,
                   log_special=51, hamming_weight=16, sparse_slots=BOOT_NS)


def build_boot(side: str):
    """(ctx, ev, enc, dec, Bootstrapper) of one package ("ref": the JAX
    package, "got": the port on the CPU) at test_full_bootstrap's
    parameters: keys from seed 3, encryptor seed 4, EvalMod K=12 / degree 45
    with eps = max(1.05·Δ/q0, 2^-5), read from each package's cache."""
    from fhe_gpt2_tpu.boot.bootstrap import Bootstrapper as JBootstrapper
    from fhe_gpt2_tpu.boot.bootstrap import make_evalmod as jmake_evalmod
    from fhe_gpt2_tpu.nn.backend import CkksBackend as JCkksBackend
    from fhe_gpt2_tpu_torch.boot.bootstrap import Bootstrapper, make_evalmod
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
    from torch_port_common import _evalmod_kw, fast_encoding
    ref = side == "ref"
    P, C = (JParams, JContext) if ref else (CkksParams, CkksContext)
    params = P.create(**BOOT_PARAMS)
    ctx = C(params) if ref else C(params, device=CPU)
    KG, EV, ENC, DEC = ((JKeyGenerator, JEvaluator, JEncryptor, JDecryptor)
                        if ref else (KeyGenerator, Evaluator, Encryptor,
                                     Decryptor))
    kg = KG(ctx, seed=3)
    ev = EV(ctx, relin_key=kg.relin_key())
    if ref:
        fast_encoding(ev)
    enc = ENC(ctx, secret=kg.secret, seed=4)
    B = (JCkksBackend if ref else CkksBackend)(ctx=ctx, ev=ev, enc=enc,
                                               dec=None, default_level=ctx.L)
    em = (jmake_evalmod if ref else make_evalmod)(
        **_evalmod_kw(params, ctx.q0_float))
    boot = (JBootstrapper if ref else Bootstrapper)(B, num_slots=BOOT_NS,
                                                    evalmod=em)
    ev.galois_keys = kg.galois_keys(steps=boot.required_steps(),
                                    conjugate=True)
    return ctx, ev, enc, DEC(ctx, kg.secret), boot


def build_evalmod(side: str):
    """(ctx, backend, EvalMod polynomials with the Q0/Δ amplitude folded
    in, encryptor) of one package at test_full_bootstrap's parameters, as
    ``build_boot`` makes them but without the Bootstrapper's plans and
    rotation keys: EvalMod multiplies only."""
    from fhe_gpt2_tpu.boot.bootstrap import make_evalmod as jmake_evalmod
    from fhe_gpt2_tpu.nn.backend import CkksBackend as JCkksBackend
    from fhe_gpt2_tpu_torch.boot.bootstrap import make_evalmod
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
    from torch_port_common import _evalmod_kw
    ref = side == "ref"
    params = (JParams if ref else CkksParams).create(**BOOT_PARAMS)
    ctx = JContext(params) if ref else CkksContext(params, device=CPU)
    kg = (JKeyGenerator if ref else KeyGenerator)(ctx, seed=3)
    ev = (JEvaluator if ref else Evaluator)(ctx, relin_key=kg.relin_key())
    enc = (JEncryptor if ref else Encryptor)(ctx, secret=kg.secret, seed=4)
    B = (JCkksBackend if ref else CkksBackend)(ctx=ctx, ev=ev,
                                               default_level=ctx.L)
    em = (jmake_evalmod if ref else make_evalmod)(
        **_evalmod_kw(params, ctx.q0_float))
    return ctx, B, em.with_amplitude(ctx.q0_float / params.scale), enc


def evalmod_input(jctx, jenc, level: int, seed=7, lo=-10, hi=11,
                  frac=2.0 ** -9, scale=None):
    """A JAX stacked pair of encryptions of I + f (split's output form),
    I in [lo, hi) and |f| <= frac, at `level` and scale (default Δ)."""
    rng = np.random.default_rng(seed)
    cts = []
    for _ in range(2):
        v = rng.integers(lo, hi, BOOT_NS) + rng.uniform(-frac, frac, BOOT_NS)
        cts.append(jenc.encrypt(ref_plain(
            jctx, v, scale or jctx.params.scale, range(level))))
    return jstack_cts(cts)


# -- the encrypted LayerNorm of tests/test_torch_u64_nn_ln*.py --------------

def ln_front(B, K, x, sh, ln):
    """``layer_norm``'s body up to the Newton loop, on one ciphertext (K:
    the package's ``nn.kernels``): (z, Σz² + eps, the Taylor seed)."""
    w = sh.stride // 2
    sums = K.fold_sum(B, B.add(x, B.rotate(x, -w)), w)
    z = B.sub(B.mul_const(x, float(sh.hidden)), sums)
    y = B.mul_plain(B.square(z), ln.data_mask[0])
    xx = B.add_const(K.fold_sum(B, B.add(y, B.rotate(y, -w)), w), ln.eps)
    return z, xx, K.taylor_rsqrt_seed(B, xx, ln.newton_init)


def ln_back(B, z, xx, y, ln):
    """The rest of ``layer_norm``: the Newton iterations, then z·rsqrt·γ√d
    + β."""
    for _ in range(ln.newton_iters):
        t = B.add_const(B.mul_const(B.mul(xx, B.square(y)), -0.5), 1.5)
        y = B.mul(y, t)
    return B.add_plain(B.mul_plain(B.mul(z, y), ln.gamma_sqrt_d[0]),
                       ln.beta[0])


def ln_case(L, jL):
    """tests/test_encrypted_nn.py's LayerNorm case (seq 8, hidden 16, 3
    Newton iterations, eps 1e-4) at 512 slots: (shapes, plans, JAX
    plans, packed input)."""
    rng = np.random.default_rng(1)
    kw = dict(slots=512, seq=8, hidden=16, heads=4)
    sh, jsh = L.GPT2Shapes(**kw), jL.GPT2Shapes(**kw)
    A = rng.standard_normal((sh.seq, sh.hidden))
    gamma = rng.uniform(0.8, 1.2, sh.hidden)
    beta = rng.uniform(-0.1, 0.1, sh.hidden)
    ss = ((sh.hidden * (A - A.mean(-1, keepdims=True))) ** 2).sum(-1).mean()
    ln = L.build_ln_plans(sh, gamma, beta, newton_init=ss, iters=3, eps=1e-4)
    jln = jL.build_ln_plans(jsh, gamma, beta, newton_init=ss, iters=3,
                            eps=1e-4)
    xs = list(sh.act.pack(A))
    assert len(xs) == 1
    return sh, ln, jln, xs[0]
