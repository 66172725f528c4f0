"""The port's encrypted attention (nn/layers.py, softmax "smax", on the
CkksBackend) held against the JAX package's eager run on the CPU, in three
stages (``torch_gpt2_common.attention_qkv``, ``attention_softmax``,
``attention_back``): the Q, K and V projections here, the Δ-batched scores
and softmax in tests/test_torch_gpt2_attn_softmax_encrypted.py, the
Goldschmidt inverse, S·V and the output projection in
tests/test_torch_gpt2_attn_back_encrypted.py. The whole block is compared
in a ``slow`` test (tests/test_torch_gpt2_block_encrypted.py).

Both packages run torch_gpt2_common's encrypted set-up (a composite uint32
chain at logN=10 with 6 level pairs, the same seeds, the decrypt/re-encrypt
refresh to the chain top). At 512 slots an activation of 16 rows x 32
columns is two ciphertexts, so the Δ batch is [16, 2] = 32 ciphertexts, the
structure of the full-width run.

Tolerance: exact. The ciphertexts are ``array_equal`` with equal scales.
The decrypts are held to the plain run within 1e-3.
"""

import numpy as np
import pytest

from fhe_gpt2_tpu.nn import layers as jL

from fhe_gpt2_tpu_torch.nn import kernels as K
from fhe_gpt2_tpu_torch.nn import layers as L
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend, RecordingBackend

from torch_gpt2_common import ENC_JSH, ENC_SH, attention_back, \
    attention_qkv, attention_softmax, attn_args, block_case, decrypt_all, \
    encrypted_backends, same_array
from torch_port_common import same_cts, single_torch_thread  # noqa: F401

# A short exp ladder and Goldschmidt inverse: fewer levels, fewer of the JAX
# side's compiles; the softmax still refreshes on the way.
KNOBS = dict(exp_r=2, inv_iters=2, inv_prescale=2.0 / (ENC_SH.seq + 1),
             smax_gamma=2.0)


def attn_case():
    """(activations, port plans, JAX plans) of the attention tests."""
    A, w = block_case(2, 0.5)
    ap = L.build_attn_plans(ENC_SH, *attn_args(w))
    jap = jL.build_attn_plans(ENC_JSH, *attn_args(w))
    for p in (ap, jap):
        for k, v in KNOBS.items():
            setattr(p, k, v)
    return A, ap, jap


def test_stages_are_the_attention():
    """On the plain backend the three stages in turn give ``attention``
    exactly, so holding each stage holds the attention."""
    A, ap, _ = attn_case()
    B = PlainBackend(ENC_SH.slots)
    xs = list(ENC_SH.act.pack(A))
    q, k, v = attention_qkv(L, B, xs, ap)
    e, denom = attention_softmax(L, K, B, q, k, ENC_SH, ap)
    got = attention_back(L, K, B, e, denom, v, ENC_SH, ap)
    for g, w in zip(got, L.attention(B, xs, ENC_SH, ap)):
        same_array(g, w)


@pytest.fixture(scope="module")
def case():
    A, ap, jap = attn_case()
    rec = RecordingBackend(ENC_SH.slots)
    attention_qkv(L, rec, list(ENC_SH.act.pack(A)), ap)
    B, jB = encrypted_backends(rec.key_steps())
    return A, ap, jap, B, jB


def test_attention_qkv_equals_reference(case):
    A, ap, jap, B, jB = case
    packed = ENC_SH.act.pack(A)
    assert len(packed) == 2 and ENC_SH.act.rows_per_ct == 8
    want = attention_qkv(L, PlainBackend(ENC_SH.slots), list(packed), ap)
    xs = [B.from_slots(v) for v in packed]
    jxs = [jB.from_slots(v) for v in packed]
    same_cts(xs, jxs, "input")
    out = attention_qkv(L, B, xs, ap)
    same_cts(out, attention_qkv(jL, jB, jxs, jap), "q, k, v")
    for got, plain in zip(out, want):
        assert np.abs(decrypt_all(B, got) - plain).max() < 1e-3
