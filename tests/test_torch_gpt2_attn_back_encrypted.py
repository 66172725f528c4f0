"""The last stage of the port's encrypted attention (the Goldschmidt
inverse of the row sums, S·V over the Δ batch, the output projection:
``torch_gpt2_common.attention_back``) held against the JAX package's eager
run on the CPU, from encryptions of the plain stages before it. The other
stages are in tests/test_torch_gpt2_attn{,_softmax}_encrypted.py.

Both packages run torch_gpt2_common's encrypted set-up (a composite uint32
chain at logN=10 with 6 level pairs, the same seeds, the decrypt/re-encrypt
refresh to the chain top). The inputs are encrypted two level pairs below
the top, so that the inverse reaches the refresh floor.

Tolerance: exact. The output ciphertexts are ``array_equal`` with equal
scales, and the refreshes come at the same levels. The decrypts are held to
the plain run within 1e-3.
"""

import numpy as np
import pytest

from fhe_gpt2_tpu.nn import kernels as jK
from fhe_gpt2_tpu.nn import layers as jL

from fhe_gpt2_tpu_torch.nn import kernels as K
from fhe_gpt2_tpu_torch.nn import layers as L
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend, RecordingBackend

from torch_gpt2_common import ENC_JSH, ENC_SH, attention_back, \
    attention_qkv, attention_softmax, count_refreshes, encrypt_value, \
    encrypted_backends
from torch_port_common import same_cts, single_torch_thread  # noqa: F401
from test_torch_gpt2_attn_encrypted import attn_case


@pytest.fixture(scope="module")
def case():
    A, ap, jap = attn_case()
    pB = PlainBackend(ENC_SH.slots)
    q, k, v = attention_qkv(L, pB, list(ENC_SH.act.pack(A)), ap)
    front = (*attention_softmax(L, K, pB, q, k, ENC_SH, ap), v)
    rec = RecordingBackend(ENC_SH.slots)
    attention_back(L, K, rec, *front, ENC_SH, ap)
    B, jB = encrypted_backends(rec.key_steps())
    return front, ap, jap, B, jB, attention_back(L, K, pB, *front, ENC_SH,
                                                 ap)


def test_attention_back_equals_reference(case):
    front, ap, jap, B, jB, want = case
    level = B.ctx.L - 2 * B.ctx.rescale_limbs
    ins = [encrypt_value(B, x, level) for x in front]
    jins = [encrypt_value(jB, x, level) for x in front]
    same_cts(ins, jins, "e, denom, v")
    assert ins[0].data.shape[1:3] == (ENC_SH.seq, 2)
    seen, jseen = count_refreshes(B), count_refreshes(jB)
    out = attention_back(L, K, B, *ins, ENC_SH, ap)
    jout = attention_back(jL, jK, jB, *jins, ENC_JSH, jap)
    same_cts(out, jout, "attention")
    assert seen == jseen and len(seen) > 0
    got = np.stack([B.to_slots(o) for o in out])
    assert np.abs(got - np.stack(want)).max() < 1e-3
