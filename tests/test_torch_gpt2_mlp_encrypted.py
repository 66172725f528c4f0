"""The port's encrypted MLP (nn/layers.py on the CkksBackend) held against
the JAX package's eager run on the CPU, in two stages
(``torch_gpt2_common.mlp_fc1``, ``mlp_fc2``): fc1 over the four column
groups with the even-polynomial GELU here, fc2 in
tests/test_torch_gpt2_mlp_fc2_encrypted.py.

Both packages run torch_gpt2_common's encrypted set-up (a composite uint32
chain at logN=10 with 6 level pairs, the same seeds, the decrypt/re-encrypt
refresh to the chain top at the backend's floor). The input is encrypted two
level pairs below the top, so that the GELU reaches the floor.

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

from torch_gpt2_common import ENC_JSH, ENC_SH, block_case, \
    count_refreshes, encrypted_backends, mlp_fc1, mlp_fc2, same_array
from torch_port_common import same_cts, single_torch_thread  # noqa: F401


def mlp_case():
    """(activations, port plans, JAX plans) of the MLP tests, with a
    degree-8 GELU on [-6, 6]: fewer levels, fewer of the JAX side's
    compiles."""
    A, w = block_case(3, 0.5)
    args = (w["w1"], w["b1"], w["w2"], w["b2"])
    kw = dict(gelu_bound=6.0, gelu_degree=8)
    return (A, L.build_mlp_plans(ENC_SH, *args, **kw),
            jL.build_mlp_plans(ENC_JSH, *args, **kw))


def test_stages_are_the_mlp():
    """On the plain backend the two stages in turn give ``mlp`` exactly."""
    A, mp, _ = mlp_case()
    B = PlainBackend(ENC_SH.slots)
    xs = list(ENC_SH.act.pack(A))
    got = mlp_fc2(L, B, mlp_fc1(L, K, B, xs, ENC_SH, mp), ENC_SH, mp)
    for g, w in zip(got, L.mlp(B, xs, ENC_SH, mp)):
        same_array(g, w)


@pytest.fixture(scope="module")
def case():
    A, mp, jmp = mlp_case()
    rec = RecordingBackend(ENC_SH.slots)
    mlp_fc1(L, K, rec, list(ENC_SH.act.pack(A)), ENC_SH, mp)
    want = mlp_fc1(L, K, PlainBackend(ENC_SH.slots),
                   list(ENC_SH.act.pack(A)), ENC_SH, mp)
    B, jB = encrypted_backends(rec.key_steps())
    return A, mp, jmp, want, B, jB


def test_mlp_fc1_equals_reference(case):
    A, mp, jmp, want, B, jB = case
    packed = ENC_SH.act.pack(A)
    level = B.ctx.L - 2 * B.ctx.rescale_limbs
    xs = [B.from_slots(v, level=level) for v in packed]
    jxs = [jB.from_slots(v, level=level) for v in packed]
    same_cts(xs, jxs, "input")
    seen, jseen = count_refreshes(B), count_refreshes(jB)
    out = mlp_fc1(L, K, B, xs, ENC_SH, mp)
    jout = mlp_fc1(jL, jK, jB, jxs, ENC_JSH, jmp)
    assert len(out) == len(jout) == ENC_SH.mlp_ratio
    for co, (g, jg) in enumerate(zip(out, jout)):
        same_cts(g, jg, f"group {co}")
        got = np.stack([B.to_slots(v) for v in g])
        assert np.abs(got - np.stack(want[co])).max() < 1e-3
    assert seen == jseen and len(seen) > 0
