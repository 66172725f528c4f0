"""The port's ResNet segment driver (cnn/resnet.py ``forward(jit=True)``)
on the encrypted backend, on the CPU, where each segment is a sealed call:
its first use runs the warm pass, every later use runs it sealed over its
own caches (what the card replays as CUDA graphs).

The miniature ResNet of torch_port_common (depth 8, 4x4, sign of degree 7)
runs on a 9-level uint32 chain with the auto-refresh floor at one level,
where the driver's refreshes (before each ReLU and the tail) fall where the
eager forward's do: ``forward(jit=True)`` equals the eager ``forward``
word for word, and a second forward over the same inputs (the encryptor's
sampler reset), whose every segment runs sealed, equals it again.
tests/test_torch_cnn_encrypted.py and tests/test_torch_cnn_block.py hold
the eager forward against the JAX package's, and the ``slow`` test here
the whole jit forward (the JAX side runs op by op, minutes on a CPU host).

Tolerance: exact (``torch.equal`` words, equal scales and levels); the
logits within the mini-net tolerance of tests/test_cnn_encrypted.py (0.25)
of the plain run.
"""

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu_torch.cnn import resnet as R
from fhe_gpt2_tpu_torch.core import seal
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Encryptor, Evaluator
from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
from fhe_gpt2_tpu_torch.nn.backend import CkksBackend, RecordingBackend

from torch_port_common import MINI_CHAIN, MINI_DEPTH, MINI_H, MINI_SIGN, \
    MINI_SLOTS, single_torch_thread  # noqa: F401

RESNET_LEVELS = 9         # the driver's refreshes fall where eager's do
RESNET_HEADROOM = 1


def _same(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.scale, g.level) == (w.scale, w.level), (what, i)
        assert torch.equal(g.data, w.data), (what, i)


def _tap_refreshes(B) -> list:
    """Log (level, inside a sealed call) of every refresh B makes."""
    seen, inner = [], B.bootstrap

    def logged(v, **kw):
        seen.append((v.level, seal.current() is not None))
        return inner(v, **kw)

    B.bootstrap = logged
    return seen


@pytest.fixture(scope="module")
def resnet(tmp_path_factory):
    from fhe_gpt2_tpu_torch.approx import minimax
    from fhe_gpt2_tpu_torch.nn import kernels as K

    rng = np.random.default_rng(0)
    weights = R.synthetic_weights(rng, MINI_DEPTH)
    img = rng.uniform(-1, 1, (3, MINI_H, MINI_H))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(minimax, "_CACHE_DIR", str(tmp_path_factory.mktemp("c")))
        sp = K.SignPlans.from_composite(minimax.sign_composite(**MINI_SIGN))
    rp = R.build_resnet_plans(weights, MINI_DEPTH, MINI_SLOTS, h=MINI_H,
                              relu_bound=10.0, sign=sp)
    rec = RecordingBackend(MINI_SLOTS)
    plain = R.forward(rec, R.pack_input(rp, img), rp, boot_between=False)
    return rp, img, rec.key_steps(), R.logits_from_slots(rp, plain[0]), \
        weights


def _resnet_backend(steps):
    C = CkksContext(CkksParams.create(**dict(
        MINI_CHAIN, num_levels=RESNET_LEVELS)), device="cpu")
    kg = KeyGenerator(C, seed=1)
    ev = Evaluator(C, relin_key=kg.relin_key(),
                   galois_keys=kg.galois_keys(steps, conjugate=True))
    B = CkksBackend(ctx=C, ev=ev, enc=Encryptor(C, secret=kg.secret, seed=2),
                    dec=Decryptor(C, kg.secret), default_level=C.L)
    B.min_level_headroom = RESNET_HEADROOM
    return B


def test_resnet_jit_equals_eager_and_replays(resnet):
    rp, img, steps, plain, _ = resnet
    eB, B = _resnet_backend(steps), _resnet_backend(steps)
    eseen, seen = _tap_refreshes(eB), _tap_refreshes(B)
    want = R.forward(eB, [eB.from_slots(v) for v in R.pack_input(rp, img)],
                     rp)
    xs = [B.from_slots(v) for v in R.pack_input(rp, img)]
    state = B.enc.rng.bit_generator.state
    got = R.forward(B, list(xs), rp, jit=True)
    _same(got, want, "first forward")
    assert seen == eseen and len(seen) > 0
    assert not any(inside for _, inside in seen)
    [(model, calls, _)] = B._segments.values()
    assert model is rp
    parts = {(name if isinstance(name, str) else name[0], part)
             for name, part, _ in calls}
    assert parts == {("stem", None), ("relu", None), ("tail", None)} | {
        (c, i) for c in ("conv1", "conv2") for i in range(len(rp.blocks))}
    # The second forward: every segment runs sealed, over the same inputs
    # and the same refresh samples.
    B.enc.rng.bit_generator.state = state
    seen.clear()
    _same(R.forward(B, list(xs), rp, jit=True), want, "second forward")
    assert seen == eseen
    assert all(p.seal.sealed for c in calls.values()
               for p in c.programs.values())
    logits = R.logits_from_slots(rp, B.to_slots(got[0]))
    assert np.argmax(logits) == np.argmax(plain)
    assert np.abs(logits - plain).max() < 0.25


@pytest.mark.slow
def test_resnet_jit_equals_reference_eager(resnet, tmp_path):
    """The whole jit forward against the JAX package's eager forward on the
    same chain (the JAX side runs op by op: minutes on a CPU host)."""
    from fhe_gpt2_tpu.approx import minimax as jminimax
    from fhe_gpt2_tpu.cnn import resnet as jR
    from fhe_gpt2_tpu.core.context import CkksContext as JContext
    from fhe_gpt2_tpu.core.context import CkksParams as JParams
    from fhe_gpt2_tpu.core.evaluator import Decryptor as JDecryptor
    from fhe_gpt2_tpu.core.evaluator import Encryptor as JEncryptor
    from fhe_gpt2_tpu.core.evaluator import Evaluator as JEvaluator
    from fhe_gpt2_tpu.core.keys import KeyGenerator as JKeyGenerator
    from fhe_gpt2_tpu.nn import kernels as jK
    from fhe_gpt2_tpu.nn.backend import CkksBackend as JCkksBackend

    from torch_port_common import fast_encoding, same_cts

    rp, img, steps, _, weights = resnet
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jminimax, "_CACHE_DIR", str(tmp_path))
        jsp = jK.SignPlans.from_composite(
            jminimax.sign_composite(**MINI_SIGN))
    jrp = jR.build_resnet_plans(weights, MINI_DEPTH, MINI_SLOTS, h=MINI_H,
                                relu_bound=10.0, sign=jsp)
    C = JContext(JParams.create(**dict(MINI_CHAIN,
                                       num_levels=RESNET_LEVELS)))
    kg = JKeyGenerator(C, seed=1)
    ev = fast_encoding(JEvaluator(C, relin_key=kg.relin_key(),
                                  galois_keys=kg.galois_keys(
                                      steps, conjugate=True)))
    jB = JCkksBackend(ctx=C, ev=ev, enc=JEncryptor(C, secret=kg.secret,
                                                   seed=2),
                      dec=JDecryptor(C, kg.secret), default_level=C.L)
    jB.min_level_headroom = RESNET_HEADROOM
    B = _resnet_backend(steps)
    got = R.forward(B, [B.from_slots(v) for v in R.pack_input(rp, img)], rp,
                    jit=True)
    want = jR.forward(jB, [jB.from_slots(v)
                           for v in jR.pack_input(jrp, img)], jrp)
    same_cts(got, want, "jit forward vs the JAX eager forward")
