"""The port's host encoder (fhe_gpt2_tpu_torch/core/embedding.py ``encode``
and ``coeffs_to_rns``) held against the JAX package's on the CPU, on a
uint32 chain and a u64 chain, by the native route and by the numpy route
(forced through ``native.available`` on both packages).

Tolerance: exact. Both routes round the same float64 transform half to
even and reduce the integers exactly, so the words are ``array_equal``;
``Evaluator._encode``, which reduces the same coefficients on the device,
gives them too.
"""

import numpy as np
import pytest

from fhe_gpt2_tpu.core import embedding as jembedding
from fhe_gpt2_tpu.core.context import CkksContext as JContext
from fhe_gpt2_tpu.core.context import CkksParams as JParams
from fhe_gpt2_tpu.runtime import native as jnative

from fhe_gpt2_tpu_torch.core import embedding
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Evaluator
from fhe_gpt2_tpu_torch.core.modmath import to_numpy_word
from fhe_gpt2_tpu_torch.runtime import native

CHAINS = {
    "uint32": dict(logn=11, log_q0=29, log_scale=25, num_levels=3,
                   log_special=31, num_special=2, hamming_weight=16),
    "u64": dict(logn=10, log_q0=50, log_scale=40, num_levels=4,
                log_special=51, hamming_weight=16),
}


@pytest.fixture(scope="module", params=sorted(CHAINS))
def chain(request):
    kw = CHAINS[request.param]
    ctx = CkksContext(CkksParams.create(**kw), device="cpu")
    jctx = JContext(JParams.create(**kw))
    assert ctx.word == jctx.word == (np.uint32 if request.param == "uint32"
                                     else np.uint64)
    return ctx, jctx


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        assert native.available() and jnative.available()
    return request.param


def _values(ctx, seed, sparse=False):
    rng = np.random.default_rng(seed)
    n = ctx.params.slots // (8 if sparse else 1)
    return rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)


@pytest.mark.parametrize("sparse", [False, True])
def test_encode_equals_reference(chain, route, sparse):
    """Full and sparse (replicated) slot vectors over the data limbs and
    over the key limbs (data + special), as host words in ctx.word."""
    ctx, jctx = chain
    z = _values(ctx, 3, sparse)
    scale = ctx.params.scale
    for limbs in (tuple(range(ctx.L)), ctx.key_limbs(ctx.L)):
        got = embedding.encode(z, scale, ctx, limbs)
        want = jembedding.encode(z, scale, jctx, limbs)
        assert got.dtype == want.dtype == ctx.word
        assert got.shape == (len(limbs), ctx.n)
        assert np.array_equal(got, want)
        # The evaluator's on-device reduction of the same coefficients.
        on_device = Evaluator(ctx)._encode(z, scale, ctx.tables(limbs))
        assert np.array_equal(to_numpy_word(on_device), got)


def test_coeffs_to_rns_equals_reference(chain, route):
    ctx, jctx = chain
    coeffs = embedding.encode_to_coeffs(_values(ctx, 4), ctx.params.scale,
                                        ctx)
    assert np.array_equal(coeffs, jembedding.encode_to_coeffs(
        _values(ctx, 4), ctx.params.scale, jctx))
    limbs = ctx.key_limbs(ctx.L)
    got = embedding.coeffs_to_rns(coeffs, ctx, limbs)
    assert got.dtype == ctx.word
    assert np.array_equal(got, jembedding.coeffs_to_rns(coeffs, jctx, limbs))


def test_encode_refuses_a_non_dividing_vector(chain, route):
    ctx, _ = chain
    with pytest.raises((ValueError, AssertionError)):
        embedding.encode(np.ones(3), ctx.params.scale, ctx, (0,))
