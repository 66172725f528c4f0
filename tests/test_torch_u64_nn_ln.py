"""The port's encrypted LayerNorm on the u64 engine (int64 words, CPU)
against the JAX package's, after tests/test_encrypted_nn.py's
test_encrypted_layer_norm (seq 8, hidden 16, 3 Newton iterations), on
tests/test_torch_u64_nn.py's u64 chain (logN=10, q0 of 50 bits, 40-bit
scale primes, a 51-bit special prime, h=32).

The JAX side runs eagerly and compiles every op at every level it visits,
so the LayerNorm is held in two halves (tests/torch_u64_common.py
``ln_front``/``ln_back``, whose composition is ``layer_norm``): here the
folds, the square and the Taylor seed; the Newton iterations and γ, β in
tests/test_torch_u64_nn_ln_newton.py. Tolerance: exact (``array_equal``
words, equal scales).
"""

import numpy as np

from fhe_gpt2_tpu.nn import kernels as jK
from fhe_gpt2_tpu.nn import layers as jL
from fhe_gpt2_tpu_torch.nn import kernels as K
from fhe_gpt2_tpu_torch.nn import layers as L
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend, RecordingBackend

from test_torch_u64_nn import SLOTS, backends
from torch_port_common import same_cts, single_torch_thread  # noqa: F401
from torch_u64_common import ln_back, ln_case, ln_front


def test_u64_layer_norm_halves_compose_to_layer_norm():
    sh, ln, _, x = ln_case(L, jL)
    P = PlainBackend(SLOTS)
    [want] = L.layer_norm(P, [x], sh, ln)
    assert np.array_equal(ln_back(P, *ln_front(P, K, x, sh, ln), ln), want)


def test_u64_layer_norm_front_equals_reference():
    sh, ln, jln, x = ln_case(L, jL)
    rec = RecordingBackend(SLOTS)
    L.layer_norm(rec, [x], sh, ln)
    B, jB = backends(rec.key_steps())
    front = ln_front(B, K, B.from_slots(x), sh, ln)
    jfront = ln_front(jB, jK, jB.from_slots(x), sh, jln)
    same_cts(list(front), list(jfront), "LayerNorm z, Σz² + eps, seed")
