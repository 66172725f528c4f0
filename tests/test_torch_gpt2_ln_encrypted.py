"""The port's encrypted LayerNorm (nn/layers.py on the CkksBackend) held
against the JAX package's eager run on the CPU.

Both packages run torch_gpt2_common's encrypted set-up, on a composite
uint32 chain at logN=10 with 8 level pairs (Δ ≈ 2^50), keys and
encryptions from the same seeds, and the decrypt/re-encrypt refresh to the
chain top at the backend's floor, which the LayerNorm's Newton iterations
reach on the way.

Tolerance: exact. Each step issues the same ops in the same order, so the
output ciphertexts are ``array_equal`` with equal scales, as are the levels
of the refreshes. The decrypts are held to the plain run within 1e-3.
"""

import numpy as np
import pytest

from fhe_gpt2_tpu.nn import layers as jL

from fhe_gpt2_tpu_torch.nn import layers as L
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend, RecordingBackend

from torch_gpt2_common import ENC_JSH, ENC_SH, count_refreshes, \
    encrypted_backends
from torch_port_common import same_cts, single_torch_thread  # noqa: F401

ITERS = 3


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((ENC_SH.seq, ENC_SH.hidden))
    gamma = rng.uniform(0.8, 1.2, ENC_SH.hidden)
    beta = rng.standard_normal(ENC_SH.hidden) * 0.02
    d = ENC_SH.hidden
    init = 1.25 * float(((d * (A - A.mean(-1, keepdims=True))) ** 2)
                        .sum(-1).max())
    ln = L.build_ln_plans(ENC_SH, gamma, beta, newton_init=init, iters=ITERS)
    jln = jL.build_ln_plans(ENC_JSH, gamma, beta, newton_init=init,
                            iters=ITERS)
    rec = RecordingBackend(ENC_SH.slots)
    want = L.layer_norm(PlainBackend(ENC_SH.slots), list(ENC_SH.act.pack(A)),
                        ENC_SH, ln)
    L.layer_norm(rec, list(ENC_SH.act.pack(A)), ENC_SH, ln)
    # 8 level pairs: the Taylor seed (powers of Σz² - init, far beyond
    # what a refresh can encode) ends above the floor, and the refreshes
    # land in the Newton iterations.
    B, jB = encrypted_backends(rec.key_steps(), num_levels=8)
    return A, ln, jln, want, B, jB


def test_layer_norm_equals_reference(case):
    A, ln, jln, want, B, jB = case
    packed = ENC_SH.act.pack(A)
    assert len(packed) == 2
    xs = [B.from_slots(v) for v in packed]
    jxs = [jB.from_slots(v) for v in packed]
    same_cts(xs, jxs, "input")
    seen, jseen = count_refreshes(B), count_refreshes(jB)
    out = L.layer_norm(B, xs, ENC_SH, ln)
    jout = jL.layer_norm(jB, jxs, ENC_JSH, jln)
    same_cts(out, jout, "layer norm")
    assert seen == jseen and len(seen) > 0
    got = np.stack([B.to_slots(o) for o in out])
    assert np.array_equal(got, np.stack([jB.to_slots(o) for o in jout]))
    assert np.abs(got - np.stack(want)).max() < 1e-3


def test_mask_cache_is_bounded_by_bytes(case, monkeypatch):
    """The CkksBackend's mask cache evicts its oldest entries beyond
    MAX_CACHE_BYTES of plaintext (a GPT-2 block at full width encodes
    36,840 masks of up to 12.6 MB); an evicted mask is encoded again to
    the same words."""
    from fhe_gpt2_tpu_torch.nn import backend

    _, ln, _, _, B, _ = case
    level, scale = B.ctx.L, B.ctx.params.scale
    one = B.ctx.L * B.ctx.n * 4
    monkeypatch.setattr(backend, "MAX_CACHE_BYTES", 3 * one)
    B.release_caches()
    assert B._cache_bytes == 0 and not B._plain_cache
    masks = [ln.gamma_sqrt_d[0], ln.gamma_sqrt_d[1], ln.beta[0], ln.beta[1]]
    first = B._plain(masks[0], level, scale).data.clone()
    for m in masks[1:]:
        B._plain(m, level, scale)
    assert B._cache_bytes == 3 * one and len(B._plain_cache) == 3
    assert ("q", id(masks[0]), level, scale) not in B._plain_cache
    assert np.array_equal(B._plain(masks[0], level, scale).data.numpy(),
                          first.numpy())
    B.release_caches()
    assert not B._plain_cache and not B._keepalive
    assert all(not k._sliced for k in B.ev.galois_keys.keys.values())
