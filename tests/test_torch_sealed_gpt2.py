"""The port's GPT-2 segment driver (nn/model.py ``forward(jit=True,
boot_need=n)``) on the encrypted backend, on the CPU, where each segment is
a sealed call: its first use runs the warm pass, every later use runs it
sealed over its own caches (what the card replays as CUDA graphs).

Two layers whose LayerNorms have different Newton seeds (one Newton step,
the toy model of tests/test_torch_gpt2_block_encrypted.py), boot_need
refreshing segment inputs between segments, with attention and MLP stood in
by constant multiplies so that each segment fits a 14-pair chain (an
encrypted attention alone takes 26 level pairs at this width):

  * the sealed driver, first and second forward, equals the same driver
    with plain segments (words, refreshes); layer 1's LN2 and MLP rebind
    to layer 0's, each with a program of its own; its decrypt is within
    1e-5 of the plain driver, which a layer running layer 0's seeds misses
    by 2.3e-3;
  * layer 1's LN2 as its sealed program ran it equals the JAX package's
    eager layer_norm with that layer's plans on the same ciphertexts, in
    levels, scales and decrypts (within 1e-9; words may differ by the
    JAX split key switch's one-unit rounding, ROADMAP "Reference
    behaviour");
  * the attention's gather (``_gather_deltas`` over ``_row_shift_stacks``:
    the device index constants of ``take_batch``) as a sealed call on a
    3-pair chain equals the JAX package's eager gather in words; its index
    constants are made by the warm pass, and a sealed run without one
    raises.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu.nn import layers as jL

from fhe_gpt2_tpu_torch.core import seal
from fhe_gpt2_tpu_torch.nn import backend as NB
from fhe_gpt2_tpu_torch.nn import layers as L
from fhe_gpt2_tpu_torch.nn import model as M
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend, RecordingBackend

from torch_port_common import single_torch_thread  # noqa: F401


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


GPT2_TOY = ["--layers", "2", "--logn", "10", "--ln-iters", "1", "--weights",
            "synthetic", "--newton-inits", "rowmax", "--cpu"]
GPT2_LEVELS, GPT2_NEED = 14, 12


def _stand_ins(monkeypatch):
    """Attention and MLP as constant multiplies, the same in every layer
    and in both packages: small, so the residual stream stays near the
    embedding the rowmax Newton seeds were taken on."""
    for mod in (L, jL):
        monkeypatch.setattr(mod, "attention", lambda B, h, sh, ap: [
            B.mul_const(v, 0.02) for v in h])
        monkeypatch.setattr(mod, "mlp", lambda B, h, sh, mp: [
            B.mul_const(v, 0.01) for v in h])


@pytest.fixture(scope="module")
def gpt2_run():
    """The toy model with stand-ins on the encrypted backend: the driver
    with plain segments (the reference), then the sealed driver twice (warm
    passes, then sealed runs), each from the same encryptor state; the
    refreshes of each, and the input and output of the second layer's LN2
    in the sealed runs."""
    from fhe_gpt2_tpu_torch import run_gpt2
    from torch_gpt2_common import ENC_SH, encrypted_backends

    m = run_gpt2.load_model(run_gpt2.parse_args(GPT2_TOY))
    ln2 = m.plans.blocks[1].ln2
    taken = {}
    with pytest.MonkeyPatch.context() as mp:
        _stand_ins(mp)
        inner = L.layer_norm

        def layer_norm(B, xs, sh, ln):
            out = inner(B, xs, sh, ln)
            if ln is ln2 and seal.current() is not None:
                taken["ln2"] = (list(xs), out)
            return out

        mp.setattr(L, "layer_norm", layer_norm)
        rec = RecordingBackend(ENC_SH.slots)
        M.forward(rec, list(ENC_SH.act.pack(m.emb)), m.plans)
        B = encrypted_backends(rec.key_steps(), num_levels=GPT2_LEVELS)[0]
        B.min_level_headroom = 0
        xs = [B.from_slots(v) for v in ENC_SH.act.pack(m.emb)]
        state = B.enc.rng.bit_generator.state
        seen = _tap_refreshes(B)
        with mp.context() as mp2:
            mp2.setattr(NB, "segment_runner", lambda B, kind, model: (
                lambda name, fn, vs, part=None: fn(vs)))
            want = M.forward(B, list(xs), m.plans, jit=True,
                             boot_need=GPT2_NEED)
        out = {"want": want, "want_seen": list(seen)}
        assert not B._segments
        for run in ("first", "second"):
            B.enc.rng.bit_generator.state = state
            seen.clear()
            out[run] = M.forward(B, list(xs), m.plans, jit=True,
                                 boot_need=GPT2_NEED)
            out[run + "_seen"] = list(seen)
        plains = [M.forward(PlainBackend(ENC_SH.slots),
                            list(ENC_SH.act.pack(m.emb)), plans, jit=True,
                            boot_need=GPT2_NEED)
                  for plans in (m.plans, _layer0_seeds(m.plans))]
    out.update(m=m, B=B, ln2=taken["ln2"], plain=np.stack(plains[0]),
               swapped=np.stack(plains[1]))
    return out


def _layer0_seeds(plans):
    """plans with every later layer's LayerNorm Newton seeds replaced by
    layer 0's: what a driver sharing layer 0's program computes."""
    b0 = plans.blocks[0]
    return replace(plans, blocks=[b0] + [
        replace(b, ln1=replace(b.ln1, newton_init=b0.ln1.newton_init),
                ln2=replace(b.ln2, newton_init=b0.ln2.newton_init))
        for b in plans.blocks[1:]])


def test_gpt2_jit_keeps_each_layers_constants(gpt2_run):
    """The sealed driver's words, first and second forward, equal the same
    driver with plain segments, with the same refreshes (none inside a
    segment); layer 1's LN2 and MLP, rebound to layer 0's, have programs of
    their own, LN2's with other constants (its Newton seed); the decrypt is
    within 1e-5 of the plain driver (4.1e-7 here), where the plain driver
    with layer 0's seeds in layer 1 lies more than 1e-3 away (2.3e-3
    here)."""
    r = gpt2_run
    m, B = r["m"], r["B"]
    inits = [(b.ln1.newton_init, b.ln2.newton_init) for b in m.plans.blocks]
    assert inits[0][0] != inits[1][0] and inits[0][1] != inits[1][1]
    assert len(r["want_seen"]) > 0
    assert all(not inside for _, inside in r["want_seen"])
    for run in ("first", "second"):
        _same(r[run], r["want"], f"{run} forward")
        assert r[run + "_seen"] == r["want_seen"], run
    [(model, calls, _)] = B._segments.values()
    assert model is m.plans
    by = {(name, part): c for (name, part, _), c in calls.items()}
    assert len(by) == 4 * 2 + 1
    # The second layer's LN2 and MLP meet the first's signatures and rebind
    # to them, each with a program (on the card a graph) of its own: LN2's
    # constants differ (its Newton seed), the MLP's are equal. (LN1 and
    # attention meet a lower residual level, a new signature.)
    for name, same_consts in (("ln2", False), ("mlp", True)):
        [p0] = by[name, 0].programs.values()
        [p1] = by[name, 1].programs.values()
        assert p1.seal is not p0.seal, name
        assert (set(p1.seal.consts) == set(p0.seal.consts)) == same_consts, \
            name
    out = np.stack([B.to_slots(o) for o in r["second"]])
    assert np.abs(out - r["plain"]).max() < 1e-5
    assert np.abs(r["swapped"] - r["plain"]).max() > 1e-3


def test_gpt2_jit_layer_norm_equals_reference(gpt2_run):
    """The second layer's LN2 as its sealed program ran it (the second
    forward) against the JAX package's eager layer_norm with that layer's
    plans on the same ciphertexts, keys from the same seed: equal levels
    and scales, and decrypts within 1e-9. Words are not compared: the JAX
    key switch on this chain sums the mod-down's float32 estimate with
    jnp.sum, the port in order, as the JAX Pallas kernel does, and the two
    may differ by one unit of P^-1 (ROADMAP "Reference behaviour"). The
    port's eager layer_norm with layer 0's seed lies more than 1e-4 away
    from the sealed output."""
    import jax.numpy as jnp
    from fhe_gpt2_tpu.core.evaluator import Ciphertext as JCiphertext
    from torch_gpt2_common import ENC_JSH, ENC_SH, encrypted_backends

    r = gpt2_run
    m, B = r["m"], r["B"]
    xs, got = r["ln2"]
    ln2 = m.plans.blocks[1].ln2
    jln2 = jL.LnPlans(gamma_sqrt_d=ln2.gamma_sqrt_d, beta=ln2.beta,
                      data_mask=ln2.data_mask, newton_init=ln2.newton_init,
                      newton_iters=ln2.newton_iters, eps=ln2.eps)
    rec = RecordingBackend(ENC_SH.slots)
    L.layer_norm(rec, [B.to_slots(x) for x in xs], ENC_SH, ln2)
    jB = encrypted_backends(rec.key_steps(), num_levels=GPT2_LEVELS)[1]
    jB.min_level_headroom = 0
    jxs = [JCiphertext(jnp.asarray(x.data.numpy().astype(np.uint32)),
                       x.scale) for x in xs]
    want = jL.layer_norm(jB, jxs, ENC_JSH, jln2)
    for g, w in zip(got, want):
        assert (g.scale, g.level) == (w.scale, w.data.shape[-2])
    gv = np.stack([B.to_slots(g) for g in got])
    assert np.abs(gv - np.stack([jB.to_slots(w) for w in want])).max() < 1e-9
    seed0 = replace(ln2, newton_init=m.plans.blocks[0].ln2.newton_init)
    other = np.stack([B.to_slots(o)
                      for o in L.layer_norm(B, xs, ENC_SH, seed0)])
    assert np.abs(gv - other).max() > 1e-4


def test_sealed_gather_deltas_equals_reference():
    """The attention's gather of row shifts as a sealed call: the warm pass
    and a sealed run equal the JAX package's eager gather, the warm pass
    made its gather indices as device constants of the call, and a sealed
    run missing one raises."""
    from torch_gpt2_common import ENC_JSH, ENC_SH, attn_args, block_case, \
        encrypted_backends

    A, w = block_case(3)
    ap = L.build_attn_plans(ENC_SH, *attn_args(w))
    jap = jL.build_attn_plans(ENC_JSH, *attn_args(w))
    packed = list(ENC_SH.act.pack(A))
    n, lo, hi = len(packed), 0, ENC_SH.seq

    def gather(mod, B, ap_, sh):
        def fn(ks):
            pos, neg = mod._row_shift_stacks(B, B.stack(ks), sh)
            return mod._gather_deltas(B, ap_, sh, pos, neg, len(ks), lo, hi)
        return fn

    rec = RecordingBackend(ENC_SH.slots)
    gather(L, rec, ap, ENC_SH)(packed)
    B, jB = encrypted_backends(rec.key_steps(), num_levels=3)
    ks = [B.from_slots(v) for v in packed]
    jks = [jB.from_slots(v) for v in ENC_JSH.act.pack(A)]
    want = gather(jL, jB, jap, ENC_JSH)(jks)
    c = NB.jit_sealed(B, gather(L, B, ap, ENC_SH), ks, seq_keys=True)
    [prog] = c.programs.values()
    index = [k for k in prog.seal.consts if k[0] == "index"]
    # r_idx, ct_idx and (ct_idx + 1) % n, over [C, n] = [16, n]
    assert len(index) == 3 and all(k[1] == (hi - lo, n) for k in index)
    for run, got in (("warm", c(ks)), ("sealed", c(list(ks)))):
        assert got.data.shape[1:3] == (hi - lo, n), run
        assert (got.scale, got.level) == (want.scale, want.data.shape[-2])
        assert np.array_equal(got.data.numpy(), np.asarray(want.data)), run
    held = prog.seal.consts.pop(index[0])
    with pytest.raises(seal.SealedCacheMiss, match="index"):
        c(list(ks))
    prog.seal.consts[index[0]] = held
