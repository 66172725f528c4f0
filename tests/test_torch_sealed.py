"""The port's sealed calls (nn/backend.py ``jit_sealed``/``rebind_sealed``)
held against the JAX package's on the CPU, where a sealed call runs its
function eagerly over its own caches.

The setting is the JAX package's tests/test_encrypted_nn.py
``test_rebind_sealed_shares_compile``: two same-structure BSGS matmuls
(different weights) on an 8 x 12 tight layout, here on a uint32 chain at
logN=11 with keys and encryptions from the same seeds on both packages.

  * the warm pass's sequential cache: the same keys in the same order as
    the JAX ``_plain_cache`` after ``jit_sealed``'s eval_shape warm pass,
    and each mask's words those of the JAX encoding of the same mask;
  * ``jit_sealed`` + ``rebind_sealed``: the first call (the warm pass) and
    a sealed call give the words of the JAX package's eager ``apply_lt``;
  * a sealed call whose mask, constant or encoding is missing, or that
    copies between the host and the device, raises;
  * a new input signature makes a new program;
  * two threads take turns through one sealed call, and a sealed call's
    sequential keys stay on its own thread.

Tolerance: exact (``array_equal`` words, equal scales).
"""

import threading

import jax
import numpy as np
import pytest

from fhe_gpt2_tpu.core.evaluator import Ciphertext as JCiphertext
from fhe_gpt2_tpu.nn.linear import apply_lt as japply_lt

from fhe_gpt2_tpu_torch.core.evaluator import Ciphertext
from fhe_gpt2_tpu_torch.core.seal import SealedCacheMiss
from fhe_gpt2_tpu_torch.nn.backend import RecordingBackend, jit_sealed, \
    rebind_sealed
from fhe_gpt2_tpu_torch.nn.formats import TightLayout, matmul_spec
from fhe_gpt2_tpu_torch.nn.linear import apply_lt

from torch_port_common import ref_plain, same_cts, same_words, \
    single_torch_thread  # noqa: F401

LOGN = 11
SLOTS = 1 << (LOGN - 1)
CHAIN = dict(logn=LOGN, log_q0=29, log_scale=25, num_levels=4,
             log_special=31, num_special=2, hamming_weight=16)


@pytest.fixture(scope="module")
def case():
    """Both packages' backends, the two plans and the encrypted inputs."""
    from fhe_gpt2_tpu.core.context import CkksContext as JContext
    from fhe_gpt2_tpu.core.context import CkksParams as JParams
    from fhe_gpt2_tpu.core.evaluator import Decryptor as JDecryptor
    from fhe_gpt2_tpu.core.evaluator import Encryptor as JEncryptor
    from fhe_gpt2_tpu.core.evaluator import Evaluator as JEvaluator
    from fhe_gpt2_tpu.core.keys import KeyGenerator as JKeyGenerator
    from fhe_gpt2_tpu.nn.backend import CkksBackend as JCkksBackend
    from fhe_gpt2_tpu.nn.formats import TightLayout as JTightLayout
    from fhe_gpt2_tpu.nn.formats import matmul_spec as jmatmul_spec

    from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
    from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Encryptor, \
        Evaluator
    from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend

    from torch_port_common import fast_encoding

    rng = np.random.default_rng(4)
    rows, d = 8, 12
    W1 = rng.standard_normal((d, d)) * 0.3
    W2 = rng.standard_normal((d, d)) * 0.3
    A = rng.standard_normal((rows, d)) * 0.5
    lay, jlay = TightLayout(rows, d, SLOTS), JTightLayout(rows, d, SLOTS)
    plans = [matmul_spec(W, lay).bsgs_plan() for W in (W1, W2)]
    jplans = [jmatmul_spec(W, jlay).bsgs_plan() for W in (W1, W2)]
    assert sorted(plans[0].baby_amounts) == sorted(plans[1].baby_amounts)
    xs_p = list(lay.pack(A))
    rec = RecordingBackend(SLOTS)
    apply_lt(rec, plans[0], xs_p)
    apply_lt(rec, plans[1], xs_p)
    out = {}
    for side, C, KG, EV, ENC, DEC, BK in (
            ("got", CkksContext(CkksParams.create(**CHAIN), device="cpu"),
             KeyGenerator, Evaluator, Encryptor, Decryptor, CkksBackend),
            ("ref", JContext(JParams.create(**CHAIN)), JKeyGenerator,
             JEvaluator, JEncryptor, JDecryptor, JCkksBackend)):
        kg = KG(C, seed=5)
        ev = EV(C, relin_key=kg.relin_key(),
                galois_keys=kg.galois_keys(steps=rec.key_steps()))
        if BK is JCkksBackend:
            fast_encoding(ev)
        B = BK(ctx=C, ev=ev, enc=ENC(C, secret=kg.secret, seed=6),
               dec=DEC(C, kg.secret), default_level=C.L)
        out[side] = (B, [B.from_slots(v) for v in xs_p])
    same_cts(out["got"][1], out["ref"][1], "inputs")
    out.update(plans=plans, jplans=jplans, xs_p=xs_p)
    return out


def _jax_warm_pass(jB, fn, *args):
    """The JAX package's jit_sealed warm pass under sequential keys (a fresh
    cache, seq counter at 0, eval_shape), recording the (mask, level,
    scale) of each _plain/_plain_ext call. Returns (cache keys, calls)."""
    calls = []
    inner = {k: getattr(jB, k) for k in ("_plain", "_plain_ext")}

    def tap(kind):
        def f(v, level, scale):
            calls.append((kind, np.asarray(v), level, scale))
            return inner[kind](v, level, scale)
        return f

    saved = jB._plain_cache, jB._seq
    jB._plain_cache, jB._seq = {}, [0]
    jB._plain, jB._plain_ext = tap("_plain"), tap("_plain_ext")
    try:
        jax.eval_shape(fn, *args)
        keys = list(jB._plain_cache)
    finally:
        jB._plain_cache, jB._seq = saved
        del jB._plain, jB._plain_ext
    return keys, calls


def test_warm_pass_cache_equals_reference(case):
    """The sequential keys ("q"/"ext", rank, level, scale), in order, and
    each mask's words: the JAX encoding of the mask the JAX warm pass
    asked for at that rank."""
    B, xs = case["got"]
    jB, jxs = case["ref"]
    plan, jplan = case["plans"][0], case["jplans"][0]
    scale = jxs[0].scale

    def jfn(*ds):
        return tuple(o.data for o in japply_lt(
            jB, jplan, [JCiphertext(v, scale) for v in ds]))

    jkeys, calls = _jax_warm_pass(jB, jfn, *(x.data for x in jxs))
    call = jit_sealed(B, lambda vs: apply_lt(B, plan, vs), xs, seq_keys=True)
    [prog] = call.programs.values()
    cache = prog.seal.plains
    assert list(cache) == jkeys and len(jkeys) == len(calls) > 0
    jctx = jB.ctx
    for key, (kind, v, level, s) in zip(jkeys, calls):
        assert key[2:] == (level, s)
        limbs = (range(level) if kind == "_plain"
                 else jctx.key_limbs(level))
        same_words(cache[key].data, ref_plain(jctx, v.ravel(), s, limbs).data,
                   f"mask {key}")
        assert cache[key].scale == s


def test_rebind_equals_reference_apply_lt(case):
    """Two matmuls of one structure: the first through jit_sealed, the
    second through rebind_sealed, each called twice (the warm pass's
    output, then a sealed run on another list of the same ciphertexts):
    the words of the JAX package's eager apply_lt. The rebound call has a
    program of its own, its masks under the same sequential keys as the
    base's (on the card, a graph of its own)."""
    B, xs = case["got"]
    jB, jxs = case["ref"]
    calls = []
    for i, (plan, jplan) in enumerate(zip(case["plans"], case["jplans"])):
        want = japply_lt(jB, jplan, jxs)
        fn = (lambda vs, plan=plan: apply_lt(B, plan, vs))
        c = (jit_sealed(B, fn, xs, seq_keys=True) if i == 0
             else rebind_sealed(calls[0], fn, xs))
        calls.append(c)
        same_cts(c(xs), want, f"matmul {i}, warm pass")
        same_cts(c(list(xs)), want, f"matmul {i}, sealed")
    [base] = calls[0].programs.values()
    [prog] = calls[1].programs.values()
    assert prog is not base and prog.seal is not base.seal
    assert list(prog.seal.plains) == list(base.seal.plains)


def test_missing_mask_constant_or_encoding_raises(case):
    """Once sealed, a call reads only what its warm pass made: a mask, a
    constant or an evaluator encoding taken out of its caches raises."""
    B, xs = case["got"]
    plan = case["plans"][0]

    def fn(vs):
        out = apply_lt(B, plan, vs)
        # a constant, and an encoding of the evaluator's own
        # (set_scale_exact's corrective plaintext)
        y = B.add_const(out[0], 0.25)
        return [B.ev.set_scale_exact(y, y.scale * 1.5)]

    c = jit_sealed(B, fn, xs, seq_keys=True)
    [prog] = c.programs.values()
    s = prog.seal
    want = c(xs)
    assert s.consts and s.encodes and s.plains
    same = c(list(xs))
    assert np.array_equal(same[0].data.numpy(), want[0].data.numpy())
    for cache in (s.plains, s.consts, s.encodes):
        key = next(iter(cache))
        held = cache.pop(key)
        with pytest.raises(SealedCacheMiss):
            c(list(xs))
        cache[key] = held
    assert np.array_equal(c(list(xs))[0].data.numpy(), want[0].data.numpy())


def test_new_signature_makes_a_new_program(case):
    """A call at another level makes (and warms) a program of its own; the
    first stays as it was."""
    B, xs = case["got"]
    plan = case["plans"][0]
    c = jit_sealed(B, lambda vs: apply_lt(B, plan, vs), xs, seq_keys=True)
    low = [B.ev.mod_switch_to(x, x.level - 1) for x in xs]
    want = apply_lt(B, plan, low)
    got = c(low)
    assert len(c.programs) == 2
    assert got[0].level == want[0].level
    assert np.array_equal(got[0].data.numpy(), want[0].data.numpy())
    assert np.array_equal(c(list(low))[0].data.numpy(), want[0].data.numpy())
    assert isinstance(c(list(xs))[0], Ciphertext)


def test_host_copy_in_a_sealed_run_raises(case):
    """A host-to-device or device-to-host copy (word_tensor, to_numpy_word)
    runs in the warm pass and raises once the call is sealed, as it would
    inside a capture on the card."""
    from fhe_gpt2_tpu_torch.core.modmath import to_numpy_word, word_tensor
    B, xs = case["got"]

    def h2d(vs):
        one = word_tensor([[1]], "cpu", word=B.ctx.word)
        return [Ciphertext(v.data + one, v.scale, v.level) for v in vs]

    def d2h(vs):
        to_numpy_word(vs[0].data)
        return vs

    for fn in (h2d, d2h):
        c = jit_sealed(B, fn, xs)
        assert len(c(xs)) == len(xs)
        with pytest.raises(SealedCacheMiss):
            c(list(xs))


def test_threads_take_turns_and_keep_their_keys(case):
    """While one thread is inside a seq-keyed sealed call, another thread's
    masks keep their identity keys in the backend's cache, and a second
    call of the same sealed function waits until the first is out; both
    give the words of the eager apply_lt (the service's workers share one
    backend)."""
    B, xs = case["got"]
    plan = case["plans"][0]
    entered, release = threading.Event(), threading.Event()
    pause = [False]

    def fn(vs):
        out = apply_lt(B, plan, vs)
        if pause[0]:
            pause[0] = False
            entered.set()
            assert release.wait(60)
        return out

    c = jit_sealed(B, fn, xs, seq_keys=True)
    want = apply_lt(B, plan, xs)
    got = {}

    def call(name):
        got[name] = c(list(xs))

    pause[0] = True
    first = threading.Thread(target=call, args=("first",))
    first.start()
    try:
        assert entered.wait(60)
        mask = np.full(B.slots, 0.5)
        level, scale = xs[0].level, xs[0].scale
        B._plain(mask, level, scale)
        assert ("q", id(mask), level, scale) in B._plain_cache
        second = threading.Thread(target=call, args=("second",))
        second.start()
        second.join(0.5)
        assert second.is_alive() and "second" not in got
    finally:
        release.set()
        first.join(60)
    second.join(60)
    for name in ("first", "second"):
        assert len(got[name]) == len(want), name
        for g, w in zip(got[name], want):
            assert (g.scale, g.level) == (w.scale, w.level), name
            assert np.array_equal(g.data.numpy(), w.data.numpy()), name
