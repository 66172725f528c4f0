"""The second stage of the port's encrypted MLP (fc2 over the four column
groups and its bias: ``torch_gpt2_common.mlp_fc2``) held against the JAX
package's eager run on the CPU, from encryptions of the plain first stage's
outputs. The first stage is in tests/test_torch_gpt2_mlp_encrypted.py.

Both packages run torch_gpt2_common's encrypted set-up (a composite uint32
chain at logN=10 with 6 level pairs, the same seeds).

Tolerance: exact. The output ciphertexts are ``array_equal`` with equal
scales. The decrypts are held to the plain run within 1e-3.
"""

import numpy as np
import pytest

from fhe_gpt2_tpu.nn import layers as jL

from fhe_gpt2_tpu_torch.nn import kernels as K
from fhe_gpt2_tpu_torch.nn import layers as L
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend, RecordingBackend

from torch_gpt2_common import ENC_JSH, ENC_SH, encrypted_backends, \
    mlp_fc1, mlp_fc2
from torch_port_common import same_cts, single_torch_thread  # noqa: F401
from test_torch_gpt2_mlp_encrypted import mlp_case


@pytest.fixture(scope="module")
def case():
    A, mp, jmp = mlp_case()
    pB = PlainBackend(ENC_SH.slots)
    groups = mlp_fc1(L, K, pB, list(ENC_SH.act.pack(A)), ENC_SH, mp)
    rec = RecordingBackend(ENC_SH.slots)
    mlp_fc2(L, rec, groups, ENC_SH, mp)
    B, jB = encrypted_backends(rec.key_steps())
    return groups, mp, jmp, B, jB, mlp_fc2(L, pB, groups, ENC_SH, mp)


def test_mlp_fc2_equals_reference(case):
    groups, mp, jmp, B, jB, want = case
    ins = [[B.from_slots(v) for v in g] for g in groups]
    jins = [[jB.from_slots(v) for v in g] for g in groups]
    for g, jg in zip(ins, jins):
        same_cts(g, jg, "input")
    out = mlp_fc2(L, B, ins, ENC_SH, mp)
    same_cts(out, mlp_fc2(jL, jB, jins, ENC_JSH, jmp), "mlp")
    got = np.stack([B.to_slots(o) for o in out])
    assert np.abs(got - np.stack(want)).max() < 1e-3
