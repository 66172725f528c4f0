"""The port's encrypted Granite 4.0-H pieces on the CkksBackend against the
float64 reference at a small width: the activations (SiLU, softplus, the
wide-domain exp), RMSNorm, the SwiGLU MLP half-layer and the grouped-query
attention half-layer.

Tolerances, each from the program's own approximation (the encrypted
runs add CKKS noise at Δ ≈ 2^54, under 1e-9 here):
* SiLU 2e-9 and softplus 2e-9 on [-8, 8]: the fits' 6.6e-10 and 7.5e-10;
  exp_scaled 1e-9 relative on [-3000, 0]: the fit's 1e-13 times 2^11
  squarings. At degree 24 SiLU's 1.4e-4 fails its bound.
* RMSNorm 1e-8 (outputs ~1): the Newton rsqrt from a seed at 1.25 times
  the largest row, converged in the iterations given (1e-12 relative).
* SwiGLU half-layer 2e-9 (outputs ~9e-4 at this width): SiLU's error
  times the gate's v (~0.02) and output_linear's sums (6e-11 seen on the
  plain simulator).
* Attention half-layer 1e-6 (outputs ~7e-3): the smax softmax
  (``layers.attention``: the exp ladder (1 + x/2^r)^(2^r), r ≤ 8, and
  Goldschmidt's inverse, calibrated for a relative error of 1e-3) on
  these near-uniform scores (1.8e-8 seen on the plain simulator).
"""

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu_torch.nn import granite as G
from fhe_gpt2_tpu_torch.nn import kernels as K
from fhe_gpt2_tpu_torch.nn import layers as L
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend, RecordingBackend
from fhe_gpt2_tpu_torch.reference import granite as R

from torch_granite_common import CFG, SEQ, SLOTS, backend, case, \
    decrypt_all, two_torch_threads  # noqa: F401

ATTN = CFG["layer_types"].index("attention")
MLP_TOL = 2e-9
ATTN_TOL = 1e-6


def test_activations_plain():
    B = PlainBackend(SLOTS)
    x = np.linspace(-8, 8, SLOTS)
    silu = x / (1 + np.exp(-x))
    assert np.abs(K.silu(B, x) - silu).max() < 2e-9
    assert np.abs(K.silu(B, x, degree=24) - silu).max() > 1e-4
    assert np.abs(K.softplus(B, x) - np.log1p(np.exp(x))).max() < 2e-9
    y = np.linspace(-3000, 0, SLOTS)
    got = K.exp_scaled(B, y / 2 ** 11, 11)
    assert np.all(np.abs(got - np.exp(y)) <= 1e-9 * np.exp(y) + 1e-300)


def test_activations_encrypted():
    B = backend([], num_levels=20)
    rng = np.random.default_rng(5)
    x = rng.uniform(-8, 8, SLOTS)
    y = rng.uniform(-60, 0, SLOTS)
    ct = B.from_slots(x)
    assert np.abs(B.to_slots(K.silu(B, ct)) - x / (1 + np.exp(-x))).max() \
        < 1e-7
    assert np.abs(B.to_slots(K.softplus(B, ct))
                  - np.log1p(np.exp(x))).max() < 1e-7
    e = B.to_slots(K.exp_scaled(B, B.from_slots(y / 2 ** 5), 5))
    assert np.all(np.abs(e - np.exp(y)) <= 1e-9 * np.exp(y) + 1e-12)


@pytest.fixture(scope="module")
def model():
    w, x = case(1)
    cal = G.calibrate(w, CFG, x, layers=[0, ATTN])
    gp = G.build_granite_plans(CFG, w, SLOTS, SEQ, cal, layers=[0, ATTN])
    return w, x, gp


def _encrypted(gp, fn, x):
    rec = RecordingBackend(SLOTS)
    fn(rec, list(gp.sh.act.pack(x)))
    B = backend(rec.key_steps())
    out = fn(B, [B.from_slots(v) for v in gp.sh.act.pack(x)])
    return gp.sh.act.unpack(np.stack([decrypt_all(B, o) for o in out]))


def test_rms_norm(model):
    w, x, gp = model
    want = R.rms_norm(torch.as_tensor(x), R.weight(
        w, "layers.0.input_layernorm.weight"), CFG["rms_norm_eps"]).numpy()
    got = _encrypted(gp, lambda B, xs: L.rms_norm(B, xs, gp.sh,
                                                  gp.layers[0].ln1), x)
    assert np.abs(got - want).max() < 1e-8


def test_swiglu(model):
    w, x, gp = model
    lp = gp.layers[0]
    want = (R.mlp_sublayer(torch.as_tensor(x), w, 0, CFG).numpy() - x)

    def fn(B, xs):
        return G.swiglu(B, L.rms_norm(B, xs, gp.sh, lp.ln2), gp, lp)
    got = _encrypted(gp, fn, x)
    assert np.abs(got - want).max() < MLP_TOL


def test_gqa_attention(model):
    w, x, gp = model
    lp = gp.layers[1]
    assert lp.kind == "attention" and lp.attn.qb is None
    assert CFG["num_key_value_heads"] < CFG["num_attention_heads"]
    want = (R.mixer_sublayer(torch.as_tensor(x), w, ATTN, CFG).numpy() - x)

    def fn(B, xs):
        return [B.sub(a, b) for a, b in zip(G.mixer_sublayer(B, xs, gp, lp),
                                            xs)]
    got = _encrypted(gp, fn, x)
    assert np.abs(got - want).max() < ATTN_TOL


def test_projection_releases_its_masks(model):
    """A projection runs block by block and leaves none of its masks in the
    backend's cache (a layer's do not fit the card at published widths),
    and gives x @ W within the CKKS noise of one LT at Δ ≈ 2^54 (2e-14
    seen on outputs ~0.1)."""
    w, x, gp = model
    proj = gp.layers[0].mlp_in
    rec = RecordingBackend(SLOTS)
    proj.apply(rec, [list(gp.sh.act.pack(x))])
    B = backend(rec.key_steps())
    out = proj.apply(B, [[B.from_slots(v) for v in gp.sh.act.pack(x)]])
    assert not B._plain_cache and B._cache_bytes == 0
    d = CFG["hidden_size"]
    for co in (0, proj.k_out - 1):
        got = gp.sh.act.unpack(np.stack([decrypt_all(B, o)
                                         for o in out[co]]))
        want = x @ proj.W[:, co * d:(co + 1) * d]
        assert np.abs(got - want).max() < 1e-12
