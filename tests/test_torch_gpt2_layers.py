"""The port's GPT-2 layers (nn/layers.py) held against the JAX package's,
on both packages' plain backends, at tests/test_layers.py's shape (1024
slots, seq 16, hidden 32, 4 heads) and weights.

Tolerance: exact. The layers are the same numpy code over the backend
protocol, so the plans are equal array for array and every output value is
equal to the JAX package's bit for bit (NaNs in the same places), as are
the rotation sets a RecordingBackend records. Each case also holds the
port to the tests/test_layers.py oracle at that test's tolerance.
"""

import numpy as np
import pytest

from fhe_gpt2_tpu.approx.minimax import auto_schedule as jauto_schedule
from fhe_gpt2_tpu.nn import kernels as jK
from fhe_gpt2_tpu.nn import layers as jL
from fhe_gpt2_tpu.nn.backend import PlainBackend as JPlainBackend
from fhe_gpt2_tpu.nn.backend import RecordingBackend as JRecordingBackend

from fhe_gpt2_tpu_torch.approx.minimax import auto_schedule
from fhe_gpt2_tpu_torch.nn import kernels as K
from fhe_gpt2_tpu_torch.nn import layers as L
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend, RecordingBackend

from torch_gpt2_common import JSH, SH, attn_args, block_case, \
    both_block_plans, same_attn_plans, same_block_plans, same_ln_plans, \
    same_mlp_plans, same_values, ss_of
from test_layers import oracle_attention, oracle_gelu, oracle_ln

B, JB = PlainBackend(SH.slots), JPlainBackend(JSH.slots)


def _both_attn(w, **knobs):
    aps = [mod.build_attn_plans(sh, *attn_args(w))
           for mod, sh in ((L, SH), (jL, JSH))]
    for ap in aps:
        for k, v in knobs.items():
            setattr(ap, k, v)
    return aps


def test_expand_row_vector_and_shapes_equal_reference():
    v = np.arange(SH.hidden, dtype=float)
    assert (SH.dh, SH.stride, SH.act.n_cts, SH.act.rows_per_ct) == \
        (JSH.dh, JSH.stride, JSH.act.n_cts, JSH.act.rows_per_ct)
    assert np.array_equal(L.expand_row_vector(SH, v),
                          jL.expand_row_vector(JSH, v))


@pytest.mark.parametrize("iters,eps", [(16, 1e-4), (12, 1.0)])
def test_layer_norm_equals_reference(iters, eps):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((SH.seq, SH.hidden))
    gamma = rng.uniform(0.5, 1.5, SH.hidden)
    beta = rng.uniform(-0.2, 0.2, SH.hidden)
    ln = L.build_ln_plans(SH, gamma, beta, newton_init=ss_of(A), iters=iters,
                          eps=eps)
    jln = jL.build_ln_plans(JSH, gamma, beta, newton_init=ss_of(A),
                            iters=iters, eps=eps)
    same_ln_plans(ln, jln)
    got = L.layer_norm(B, list(SH.act.pack(A)), SH, ln)
    same_values(got, jL.layer_norm(JB, list(JSH.act.pack(A)), JSH, jln))
    if eps < 1:
        assert np.abs(SH.act.unpack(np.stack(got))
                      - oracle_ln(A, gamma, beta)).max() < 1e-4


def test_attention_plans_equal_reference():
    same_attn_plans(*_both_attn(block_case(1)[1]))


SMAX = dict(exp_r=7, inv_iters=14, inv_prescale=2.0)


@pytest.mark.parametrize("delta_chunk", [0, 5])
def test_attention_smax_equals_reference(delta_chunk):
    A, w = block_case(1)
    ap, jap = _both_attn(w, **SMAX)
    got = L.attention(B, list(SH.act.pack(A)), SH, ap, smax_gamma=4.0,
                      delta_chunk=delta_chunk)
    same_values(got, jL.attention(JB, list(JSH.act.pack(A)), JSH, jap,
                                  smax_gamma=4.0, delta_chunk=delta_chunk))
    want = oracle_attention(A, *attn_args(w), SH, 4.0, 7, 14, 2.0)
    assert np.abs(SH.act.unpack(np.stack(got)) - want).max() < 1e-6


def test_attention_max_equals_reference():
    """The real-max softmax (approx-max tree over Δ), with the sign plans
    of tests/test_layers.py from each package's cache."""
    A, w = block_case(7)
    knobs = dict(exp_r=6, inv_iters=20, inv_prescale=2.0 / (SH.seq + 1),
                 max_bound=2.0)
    ap, jap = _both_attn(w, **knobs)
    ap.sign = K.SignPlans.from_composite(
        auto_schedule(target_err=2.0 ** -12, eps=2.0 ** -9))
    jap.sign = jK.SignPlans.from_composite(
        jauto_schedule(target_err=2.0 ** -12, eps=2.0 ** -9))
    got = L.attention(B, list(SH.act.pack(A)), SH, ap, softmax="max")
    same_values(got, jL.attention(JB, list(JSH.act.pack(A)), JSH, jap,
                                  softmax="max"))
    assert np.isfinite(np.stack(got)).all()


@pytest.mark.parametrize("delta_chunk", [0, 6])
def test_attention_consmax_equals_reference(delta_chunk):
    """The trained-ConsMax softmax (per-head β/γ, constant denominator)."""
    A, w = block_case(8)
    rng = np.random.default_rng(8)
    knobs = dict(softmax_mode="consmax", exp_r=8,
                 consmax_beta=rng.uniform(0.5, 1.5, SH.heads),
                 consmax_gamma=rng.uniform(2.0, 6.0, SH.heads))
    ap, jap = _both_attn(w, **knobs)
    same_attn_plans(ap, jap)
    got = L.attention(B, list(SH.act.pack(A)), SH, ap,
                      delta_chunk=delta_chunk)
    same_values(got, jL.attention(JB, list(JSH.act.pack(A)), JSH, jap,
                                  delta_chunk=delta_chunk))
    assert np.isfinite(np.stack(got)).all()


def test_mlp_equals_reference():
    A, w = block_case(3)
    mp = L.build_mlp_plans(SH, w["w1"], w["b1"], w["w2"], w["b2"])
    jmp = jL.build_mlp_plans(JSH, w["w1"], w["b1"], w["w2"], w["b2"])
    same_mlp_plans(mp, jmp)
    got = L.mlp(B, list(SH.act.pack(A)), SH, mp)
    same_values(got, jL.mlp(JB, list(JSH.act.pack(A)), JSH, jmp))
    want = oracle_gelu(A @ w["w1"] + w["b1"]) @ w["w2"] + w["b2"]
    assert np.abs(SH.act.unpack(np.stack(got)) - want).max() < 1e-3


def _block_case():
    A, w = block_case(4, 0.3)
    h1 = oracle_ln(A, w["g1"], w["be1"])
    r1 = A + oracle_attention(h1, *attn_args(w), SH, 4.0, 8, 16, 2.0)
    bp, jbp = both_block_plans(w, ss_of(A), ss_of(r1), exp_r=8, inv_iters=16,
                               inv_prescale=2.0, smax_gamma=4.0)
    want = r1 + oracle_gelu(oracle_ln(r1, w["g2"], w["be2"]) @ w["w1"]
                            + w["b1"]) @ w["w2"] + w["b2"]
    return A, bp, jbp, want


def test_block_equals_reference():
    A, bp, jbp, want = _block_case()
    same_block_plans(bp, jbp)
    got = L.block(B, list(SH.act.pack(A)), SH, bp)
    same_values(got, jL.block(JB, list(JSH.act.pack(A)), JSH, jbp))
    assert np.abs(SH.act.unpack(np.stack(got)) - want).max() < 5e-3


def test_block_key_steps_equal_reference():
    """The rotation set a RecordingBackend records over one block (the
    Galois keys an encrypted run generates)."""
    A, bp, jbp, _ = _block_case()
    rec, jrec = RecordingBackend(SH.slots), JRecordingBackend(JSH.slots)
    L.block(rec, list(SH.act.pack(A)), SH, bp)
    jL.block(jrec, list(JSH.act.pack(A)), JSH, jbp)
    assert rec.key_steps() == jrec.key_steps()
    assert len(rec.key_steps()) > 0
