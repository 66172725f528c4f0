"""The second stage of the port's encrypted attention (the Δ-batched
scores, exp, causal mask and row sums: ``torch_gpt2_common.
attention_softmax``) held against the JAX package's eager run on the CPU,
from encryptions of the plain Q and K projections. The other stages are in
tests/test_torch_gpt2_attn{,_back}_encrypted.py.

Both packages run torch_gpt2_common's encrypted set-up (a composite uint32
chain at logN=10 with 6 level pairs, the same seeds, the decrypt/re-encrypt
refresh to the chain top), which the exp ladder over the [16, 2] Δ batch
reaches on the way.

Tolerance: exact. The ciphertexts are ``array_equal`` with equal scales,
and the refreshes come at the same levels. The decrypts are held to the
plain run within 1e-3.
"""

import numpy as np
import pytest

from fhe_gpt2_tpu.nn import kernels as jK
from fhe_gpt2_tpu.nn import layers as jL

from fhe_gpt2_tpu_torch.nn import kernels as K
from fhe_gpt2_tpu_torch.nn import layers as L
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend, RecordingBackend

from torch_gpt2_common import ENC_JSH, ENC_SH, attention_qkv, \
    attention_softmax, count_refreshes, decrypt_all, encrypt_value, \
    encrypted_backends
from torch_port_common import same_cts, single_torch_thread  # noqa: F401
from test_torch_gpt2_attn_encrypted import attn_case


@pytest.fixture(scope="module")
def case():
    A, ap, jap = attn_case()
    pB = PlainBackend(ENC_SH.slots)
    q, k, _ = attention_qkv(L, pB, list(ENC_SH.act.pack(A)), ap)
    rec = RecordingBackend(ENC_SH.slots)
    attention_softmax(L, K, rec, q, k, ENC_SH, ap)
    B, jB = encrypted_backends(rec.key_steps())
    return (q, k), ap, jap, B, jB, attention_softmax(L, K, pB, q, k, ENC_SH,
                                                      ap)


def test_attention_softmax_equals_reference(case):
    qk, ap, jap, B, jB, want = case
    level = B.ctx.L - B.ctx.rescale_limbs
    ins = [encrypt_value(B, x, level) for x in qk]
    jins = [encrypt_value(jB, x, level) for x in qk]
    same_cts(ins, jins, "q, k")
    seen, jseen = count_refreshes(B), count_refreshes(jB)
    out = attention_softmax(L, K, B, *ins, ENC_SH, ap)
    jout = attention_softmax(jL, jK, jB, *jins, ENC_JSH, jap)
    same_cts(out, jout, "e, denom")
    assert seen == jseen and len(seen) > 0
    assert out[0].data.shape[1:3] == (ENC_SH.seq, 2)
    for got, plain in zip(out, want):
        assert np.abs(decrypt_all(B, got) - plain).max() < 1e-3
