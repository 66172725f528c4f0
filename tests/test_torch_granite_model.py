"""The port's Granite 4.0-H model (nn/granite.py, run_granite.py) over the
published period at a small width, its plans from an HF-format state
dict, and GPT-2's defaults left as they were.

The 10-layer model (M×9, A: layers 6-15 of the published ``layer_types``)
runs on the plain simulator, which runs the encrypted path's operations
on float64 slot vectors (tests/test_torch_granite_{core,layers}.py hold
those operations on the CkksBackend). Tolerance 5e-7 on a hidden state of
magnitude ~3 after the final RMSNorm: each layer adds its SiLU, softplus,
Newton and softmax errors (7e-8 seen over ten layers); SiLU and softplus
at degree 24 fail it.
"""

import json

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu_torch import run_granite
from fhe_gpt2_tpu_torch.nn import granite as G
from fhe_gpt2_tpu_torch.nn import kernels as K
from fhe_gpt2_tpu_torch.nn import layers as L
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend
from fhe_gpt2_tpu_torch.reference import granite as R

from torch_granite_common import CFG, SEQ, SLOTS, case, \
    two_torch_threads  # noqa: F401

TOL = 5e-7


def forward(w, x, **kw):
    cal = G.calibrate(w, CFG, x)
    gp = G.build_granite_plans(CFG, w, SLOTS, SEQ, cal, **kw)
    out = G.forward(PlainBackend(SLOTS), list(gp.sh.act.pack(x)), gp)
    return gp.sh.act.unpack(np.stack(out))


@pytest.fixture(scope="module")
def period():
    w, x = case(2)
    return w, x, R.forward(w, torch.as_tensor(x), CFG).numpy()


def test_period_matches_reference(period):
    w, x, want = period
    assert CFG["layer_types"] == ["mamba"] * 9 + ["attention"]
    assert np.abs(forward(w, x) - want).max() < TOL


def test_period_lower_degree_fails(period):
    w, x, want = period
    got = forward(w, x, silu_degree=24, softplus_degree=24)
    assert np.abs(got - want).max() > TOL


@pytest.mark.parametrize("name,value,where", [
    ("layers.0.mamba.conv1d.bias", 9.0, "layer 0's mixer"),
    ("layers.0.mamba.dt_bias", 9.0, "layer 0's mixer"),
    ("layers.0.shared_mlp.input_linear.weight", 10.0, "layer 0's MLP")])
def test_calibration_holds_activation_domain(name, value, where):
    """A SiLU or softplus input of the float forward outside the fits'
    ±ACT_BOUND stops the calibration: a conv output (bias 9), a softplus
    step (dt_bias 9), an MLP gate (weights N(0, 10), rows ~57)."""
    w, x = case(3)
    G.calibrate(w, CFG, x, layers=[0])
    w = dict(w)
    if name.endswith("input_linear.weight"):
        w[name] = np.random.default_rng(0).normal(0, value, w[name].shape)
    else:
        w[name] = np.full_like(w[name], value)
    with pytest.raises(ValueError, match=where):
        G.calibrate(w, CFG, x, layers=[0])


def test_hf_state_dict():
    """``model.``-prefixed torch tensors (a GraniteMoeHybridForCausalLM's
    state dict) give the plans the bare numpy dict gives."""
    w, x = case(3, G.small_config(32, 2))
    cfg = G.small_config(32, 2)
    hf = {"model." + k: torch.as_tensor(v) for k, v in w.items()}
    cal = G.calibrate(w, cfg, x)
    a = G.build_granite_plans(cfg, w, SLOTS, SEQ, cal)
    b = G.build_granite_plans(cfg, hf, SLOTS, SEQ, cal)
    for la, lb in zip(a.layers, b.layers):
        assert np.array_equal(la.in_proj.W, lb.in_proj.W)
        assert np.array_equal(la.core.conv_keep, lb.core.conv_keep)
        assert np.array_equal(la.mlp_out.W, lb.mlp_out.W)


def test_in_proj_columns():
    """in_proj's output columns land in the core's groups: z, x, B, C
    (zero past the state) and dt repeated over each head's columns."""
    cfg = G.small_config(32, 1)
    w, _ = case(4, cfg)
    d, P = cfg["hidden_size"], cfg["mamba_d_head"]
    N, H = cfg["mamba_d_state"], cfg["mamba_n_heads"]
    Win = G.get(w, "layers.0.mamba.in_proj.weight")
    cols = G.in_proj_columns(cfg, Win)
    u = np.random.default_rng(0).normal(size=(3, d))
    z, xbc, dt = R.split_in_proj(torch.as_tensor(u @ Win.T), cfg)
    got = u @ cols
    assert np.allclose(got[:, :2 * d], z.numpy())
    assert np.allclose(got[:, 2 * d:4 * d], xbc[:, :2 * d].numpy())
    assert np.allclose(got[:, 4 * d:4 * d + N], xbc[:, 2 * d:2 * d + N])
    assert not got[:, 4 * d + N:5 * d].any()
    assert np.allclose(got[:, 5 * d:5 * d + N], xbc[:, 2 * d + N:])
    assert np.allclose(got[:, 6 * d:], np.repeat(dt.numpy(), P, axis=1))
    assert H * P == 2 * d


def test_entry_point_plain(capsys):
    run_granite.main(["--layers", "6", "--seq", "8", "--hidden", "32",
                      "--plain", "--cpu", "--slots", str(SLOTS)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["layer_types"] == ["mamba"] * 5 + ["attention"]
    assert line["max_err_vs_reference"] < TOL
    assert line["top1_agreement"] == 1.0


def test_gpt2_defaults_unchanged():
    """The generalised pieces GPT-2 shares keep their defaults: the score
    scale 1/√dh and the biases of ``build_attn_plans``, the (x − 1) seed
    of ``newton_rsqrt`` (its steps now ``newton_step``)."""
    sh = L.GPT2Shapes(slots=SLOTS, seq=SEQ, hidden=32, heads=4)
    rng = np.random.default_rng(5)
    ws = [rng.normal(size=(32, 32)) for _ in range(4)]
    bs = [rng.normal(size=32) for _ in range(4)]
    args = [v for pair in zip(ws, bs) for v in pair]
    a = L.build_attn_plans(sh, *args)
    b = L.build_attn_plans(sh, *args, scale=1 / np.sqrt(sh.dh))
    assert np.array_equal(a.qb, b.qb) and np.array_equal(a.kb, b.kb)
    assert np.array_equal(a.qb, L.expand_row_vector(
        sh, bs[0] * (1.0 / np.sqrt(sh.dh))))
    for da, db in zip(a.q.spec.diagonals.values(),
                      b.q.spec.diagonals.values()):
        assert np.array_equal(da, db)
    B = PlainBackend(SLOTS)
    x = np.linspace(5.0, 50.0, SLOTS)
    am1 = 60.0 - 1.0
    dx = x - 60.0
    seed = (am1 ** -0.5 - 0.5 * am1 ** -1.5 * dx + 0.375 * am1 ** -2.5
            * dx * dx - 0.3125 * am1 ** -3.5 * dx ** 3)
    assert np.allclose(K.taylor_rsqrt_seed(B, x, 60.0), seed, rtol=1e-12)
    y = seed
    for _ in range(3):
        y = y * (1.5 - 0.5 * x * y * y)
    assert np.allclose(K.newton_rsqrt(B, x, 60.0, 3), y, rtol=1e-12)
