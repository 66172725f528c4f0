"""The second half of the port's encrypted LayerNorm on the u64 engine
(see tests/test_torch_u64_nn_ln.py): the 3 Newton iterations and z·rsqrt·γ√d
+ β, on carried JAX encryptions of the plain run's z, Σz² + eps and Taylor
seed, each at the level and scale where the port's first half leaves it.
Tolerance: exact (``array_equal`` words, equal scales); the decrypt within
test_encrypted_nn's 1e-3 of the plain run.
"""

import numpy as np

from fhe_gpt2_tpu.nn import layers as jL
from fhe_gpt2_tpu_torch.nn import kernels as K
from fhe_gpt2_tpu_torch.nn import layers as L
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend, RecordingBackend

from test_torch_u64_nn import SLOTS, backends
from torch_port_common import ref_plain, same_cts, to_port, \
    single_torch_thread  # noqa: F401
from torch_u64_common import ln_back, ln_case, ln_front


def test_u64_layer_norm_newton_equals_reference():
    sh, ln, jln, x = ln_case(L, jL)
    rec = RecordingBackend(SLOTS)
    L.layer_norm(rec, [x], sh, ln)
    B, jB = backends(rec.key_steps())
    P = PlainBackend(SLOTS)
    plain = ln_front(P, K, x, sh, ln)
    # Where the port's first half leaves its three outputs (fast here).
    front = ln_front(B, K, B.from_slots(x), sh, ln)
    jctx = jB.ctx
    jins = [jB.enc.encrypt(ref_plain(jctx, v, c.scale, range(c.level)))
            for v, c in zip(plain, front)]
    out = ln_back(B, *[to_port(j) for j in jins], ln)
    same_cts([out], [ln_back(jB, *jins, jln)], "LayerNorm Newton + γ, β")
    want = ln_back(P, *plain, ln)
    assert np.abs(B.to_slots(out) - want).max() < 1e-3
