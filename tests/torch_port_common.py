"""Shared set-up of the port's CPU tests of hoisting, the reduced-error
ops, approximation, the LT engine and the bootstrap
(tests/test_torch_{hoist,reduced*,approx,linear,boot*}.py).

``single_torch_thread`` (autouse wherever a test module imports it) runs a
module's tests with one intra-op thread: the plain versions issue many
small ops, and the test run's worker processes share the host's cores, where
several threads per worker only wait on each other.

``run`` (hoisting and the reduced-error ops) builds both packages on each
uint32 chain at logN=11 with keys from the same seed, and JAX ciphertexts
for the port to carry over.

For the bootstrap, both packages build the composite chain of tests/test_composite.py's full
bootstrap (logN=10, 22 level pairs = 46 limbs, two special primes, h=16,
64 sparse slots, K=12 / degree 45 EvalMod read from each package's cache),
with keys from the same seed. The port runs on the CPU, so it takes its
plain versions throughout.

The JAX inputs are encoded by ``ref_plain``, the body of the JAX package's
``make_plain`` with its NTT loop jitted: the package runs that loop op by
op, which on a cold compile cache costs about 15 s per limb count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_gpt2_tpu.boot.bootstrap import Bootstrapper as JBootstrapper
from fhe_gpt2_tpu.boot.bootstrap import make_evalmod as jmake_evalmod
from fhe_gpt2_tpu.core import embedding as jembedding
from fhe_gpt2_tpu.core import ntt as jnttmod
from fhe_gpt2_tpu.core.context import CkksContext as JContext
from fhe_gpt2_tpu.core.context import CkksParams as JParams
from fhe_gpt2_tpu.core.evaluator import Ciphertext as JCiphertext
from fhe_gpt2_tpu.core.evaluator import Encryptor as JEncryptor
from fhe_gpt2_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_gpt2_tpu.core.evaluator import Plaintext as JPlaintext
from fhe_gpt2_tpu.core.evaluator import stack_cts as jstack_cts
from fhe_gpt2_tpu.core.keys import KeyGenerator as JKeyGenerator
from fhe_gpt2_tpu.nn.backend import CkksBackend as JCkksBackend

from fhe_gpt2_tpu_torch import carry
from fhe_gpt2_tpu_torch.boot.bootstrap import Bootstrapper, make_evalmod
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Encryptor, Evaluator
from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
from fhe_gpt2_tpu_torch.nn.backend import CkksBackend

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KEY_STEPS = [1, 2, 5]


@pytest.fixture(scope="module", params=["single", "composite"])
def run(request):
    """Both packages on one uint32 chain at logN=11: contexts, key
    generators and evaluators with relinearization, Galois (KEY_STEPS) and
    conjugation keys, the slot values ``x`` and the JAX ciphertexts ``a``
    (scale Δ), ``b`` (Δ·1.37), ``c`` (Δ·4, one rescale unit lower) and
    ``stacked`` (a with a second one)."""
    if request.param == "single":
        kw = dict(logn=11, log_q0=29, log_scale=25, num_levels=3,
                  log_special=31, num_special=2, hamming_weight=16)
        jp, p = JParams.create(**kw), CkksParams.create(**kw)
    else:
        kw = dict(logn=11, num_levels=2, num_special=2, hamming_weight=16)
        jp, p = JParams.create_composite(**kw), CkksParams.create_composite(**kw)
    jctx, ctx = JContext(jp), CkksContext(p, device=CPU)
    out = {"jctx": jctx, "ctx": ctx}
    for side, C, KG, EV in (("ref", jctx, JKeyGenerator, JEvaluator),
                            ("got", ctx, KeyGenerator, Evaluator)):
        kg = KG(C, seed=3)
        out[side] = (kg, EV(C, relin_key=kg.relin_key(),
                            galois_keys=kg.galois_keys(KEY_STEPS,
                                                       conjugate=True)))
    jenc = JEncryptor(jctx, secret=out["ref"][0].secret, seed=4)
    rng = np.random.default_rng(1)
    scale = jctx.params.scale
    xs = [rng.uniform(-1, 1, jctx.params.slots) for _ in range(3)]
    out["x"] = xs

    def encrypt(x, s, level):
        return jenc.encrypt(ref_plain(jctx, x, s, range(level)))
    out["a"] = encrypt(xs[0], scale, jctx.L)
    # Off-scale operands: a non-integer ratio (1.37) and an integer one (4).
    out["b"] = encrypt(xs[1], scale * 1.37, jctx.L)
    out["c"] = encrypt(xs[2], scale * 4, jctx.L - jctx.rescale_limbs)
    out["stacked"] = jstack_cts([out["a"], encrypt(xs[1], scale, jctx.L)])
    return out


def same_words(got, ref, what=""):
    """Port ciphertext or tensor vs JAX ciphertext or array: equal scales
    (ciphertexts) and equal words."""
    if isinstance(ref, JCiphertext):
        assert got.scale == ref.scale, (what, got.scale, ref.scale)
        got, ref = got.data, ref.data
    have, want = carry.to_numpy(got), np.asarray(ref)
    assert have.shape == want.shape, (what, have.shape, want.shape)
    assert np.array_equal(have, want), (
        f"{what}: {np.count_nonzero(have != want)} words differ")


NS = 64
PARAMS = dict(logn=10, num_levels=22, log_scale=50, log_q0=55, log_special=31,
              num_special=2, hamming_weight=16, sparse_slots=NS)


def _evalmod_kw(params, q0_float):
    eps = params.scale / q0_float
    return dict(K=12, eps=max(eps * 1.05, 2 ** -5), degree=45,
                arcsin_degree=3, prec_dps=60)


def build_port():
    """(ctx, ev, enc, dec, Bootstrapper) of the port on the CPU, with the
    relinearization, Galois (required steps) and conjugation keys."""
    params = CkksParams.create_composite(**PARAMS)
    ctx = CkksContext(params, device=CPU)
    kg = KeyGenerator(ctx, seed=3)
    ev = Evaluator(ctx, relin_key=kg.relin_key())
    enc = Encryptor(ctx, secret=kg.secret, seed=4)
    B = CkksBackend(ctx=ctx, ev=ev, enc=enc, dec=None, default_level=ctx.L)
    boot = Bootstrapper(B, num_slots=NS,
                        evalmod=make_evalmod(**_evalmod_kw(params,
                                                           ctx.q0_float)))
    ev.galois_keys = kg.galois_keys(steps=boot.required_steps(),
                                    conjugate=True)
    return ctx, ev, enc, Decryptor(ctx, kg.secret), boot


def build_reference():
    """The same objects of the JAX package (its CPU path)."""
    params = JParams.create_composite(**PARAMS)
    ctx = JContext(params)
    kg = JKeyGenerator(ctx, seed=3)
    ev = JEvaluator(ctx, relin_key=kg.relin_key())
    enc = JEncryptor(ctx, secret=kg.secret, seed=4)
    B = JCkksBackend(ctx=ctx, ev=ev, enc=enc, dec=None, default_level=ctx.L)
    boot = JBootstrapper(B, num_slots=NS,
                         evalmod=jmake_evalmod(**_evalmod_kw(params,
                                                             ctx.q0_float)))
    ev.galois_keys = kg.galois_keys(steps=boot.required_steps(),
                                    conjugate=True)
    return ctx, ev, enc, boot


_REF_NTT: dict = {}


def ref_plain(ref_ctx, values, scale: float, limbs) -> JPlaintext:
    """The JAX package's encoding over the limb set ``limbs``: the body of
    its ``make_plain`` (limbs 0..l-1) and ``make_plain_ext`` (key limbs),
    ``embedding.encode`` then the NTT stage loop, with the loop jitted as
    one program. The package runs the loop op by op, which on a cold
    compile cache compiles every stage's ops anew (about 15 s per limb
    count at logN 10-11); the words are the same."""
    limbs = tuple(limbs)
    key = (id(ref_ctx), limbs)
    if key not in _REF_NTT:
        t = ref_ctx.tables(limbs)
        # The context stays referenced, so its id is not reused.
        _REF_NTT[key] = (ref_ctx, jax.jit(lambda r: jnttmod._ntt_stages(r, t)))
    res = jembedding.encode(values, scale, ref_ctx, limbs)
    return JPlaintext(data=_REF_NTT[key][1](jnp.asarray(res)), scale=scale)


def entry(ref_ev, ref_enc, ref_ctx, seed=5):
    """(slot values, JAX ciphertext at the base level)."""
    z = np.random.default_rng(seed).uniform(-1, 1, NS)
    ct = ref_enc.encrypt(ref_plain(ref_ctx, z, ref_ctx.params.scale,
                                   range(ref_ctx.base_limbs)))
    return z, ct


def stage_input(ref_ctx, ref_enc, level: int, seed=5):
    """A JAX encryption of the entry values at ``level`` and scale Δ: the
    input of a stage test that does not run the stages before it."""
    z = np.random.default_rng(seed).uniform(-1, 1, NS)
    return ref_enc.encrypt(ref_plain(ref_ctx, z, ref_ctx.params.scale,
                                     range(level)))


def cts_output_level(ref_ctx, ref_boot) -> int:
    """The level CoeffToSlot hands on: the full chain less one rescale unit
    per factor."""
    return ref_ctx.L - len(ref_boot.cts_plans) * ref_ctx.rescale_limbs


def to_port(jct):
    return carry.ciphertext_from_reference(np.asarray(jct.data), jct.scale,
                                           CPU)


def to_ref(ct):
    return JCiphertext(carry.to_numpy(ct), ct.scale)


def stage_fns(boot) -> dict:
    return dict(boot.stages())


def assert_same(got, ref, what):
    """Port ciphertext vs JAX ciphertext: same scale, same words."""
    want = np.asarray(ref.data)
    have = carry.to_numpy(got)
    assert got.scale == ref.scale, (what, got.scale, ref.scale)
    assert have.shape == want.shape, (what, have.shape, want.shape)
    assert np.array_equal(have, want), (
        f"{what}: {np.count_nonzero(have != want)} words differ")
