"""The plain Granite 4.0-H reference (``fhe_gpt2_tpu_torch/reference/
granite.py``) held against ``transformers``' ``GraniteMoeHybridModel`` at a
tiny seeded configuration with both layer kinds, against the Mamba-2
recurrence written as a scan, and to its imports.

Tolerances: against ``transformers`` 2e-6 on a hidden state of magnitude
~4: ``transformers`` computes the mixer in float32 (its A, the SSD sums
and the gated norm), the reference in float64, so the gap is float32's
rounding through a layer (3e-7 seen). Against the scan, 1e-12: both are
float64 and differ only in the order of the sums.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu_torch.nn import granite as G
from fhe_gpt2_tpu_torch.reference import granite as R

TINY = dict(hidden_size=64, intermediate_size=128,
            shared_intermediate_size=128, num_attention_heads=4,
            num_key_value_heads=2, mamba_n_heads=8, mamba_d_head=16,
            mamba_d_state=16, mamba_n_groups=1, mamba_d_conv=4,
            mamba_expand=2, num_local_experts=0, num_experts_per_tok=0,
            vocab_size=50, position_embedding_type="nope",
            attention_multiplier=1 / 64, embedding_multiplier=12,
            residual_multiplier=0.22, logits_scaling=8, rms_norm_eps=1e-5,
            mamba_chunk_size=4)


@pytest.mark.parametrize("types", [["mamba", "attention"],
                                   ["attention", "mamba", "mamba"]])
def test_matches_transformers(types):
    tr = pytest.importorskip("transformers")
    kw = dict(TINY, num_hidden_layers=len(types), layer_types=types)
    torch.manual_seed(0)
    net = tr.GraniteMoeHybridModel(tr.GraniteMoeHybridConfig(**kw))
    net = net.double().eval()
    g = torch.Generator().manual_seed(1)
    sd = {k: v.detach().clone() for k, v in net.state_dict().items()}
    for k in sd:
        # Norm weights away from 1 and the conv at its own scale, so every
        # weight the reference reads carries data.
        if k.endswith("norm.weight") or k.endswith("layernorm.weight"):
            sd[k] = 0.8 + 0.4 * torch.rand(sd[k].shape, generator=g,
                                           dtype=torch.float64)
        if "conv1d" in k:
            sd[k] = torch.rand(sd[k].shape, generator=g,
                               dtype=torch.float64) - 0.5
    net.load_state_dict(sd)
    ids = torch.randint(0, kw["vocab_size"], (1, 10), generator=g)
    with torch.no_grad():
        want = net(ids).last_hidden_state[0]
    got = R.forward(sd, R.embed(sd, ids[0], kw), kw)
    assert float((got - want).abs().max()) < 2e-6


def _scan(z, xbc, dt_raw, p, cfg):
    """The mixer core as the Mamba-2 recurrence h ← exp(A·dt)·h + dt·B·x,
    y = C·h + D·x (``torch_forward``'s decode branch, token by token)."""
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    N = cfg["mamba_d_state"]
    inner = H * P
    xbc = R.silu(R.causal_conv(xbc, p["conv1d.weight"], p["conv1d.bias"]))
    x, Bm, Cm = xbc[:, :inner], xbc[:, inner:inner + N], xbc[:, inner + N:]
    dt = R.softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    h = torch.zeros(H, P, N, dtype=torch.float64)
    ys = []
    for t in range(x.shape[0]):
        xt = x[t].reshape(H, P)
        h = torch.exp(A * dt[t])[:, None, None] * h + (
            dt[t][:, None, None] * xt[..., None] * Bm[t])
        ys.append((h @ Cm[t] + p["D"][:, None] * xt).reshape(inner))
    v = torch.stack(ys) * R.silu(z)
    return R.rms_norm(v, p["norm.weight"], cfg["rms_norm_eps"])


def test_core_equals_recurrence():
    cfg = G.small_config(64, 1)
    rng = np.random.default_rng(3)
    w = G.synthetic_weights(rng, cfg)
    p = {k: torch.as_tensor(G.get(w, "layers.0.mamba." + k)) for k in (
        "conv1d.weight", "conv1d.bias", "dt_bias", "A_log", "D",
        "norm.weight")}
    S, inner = 12, 2 * cfg["hidden_size"]
    N, H = cfg["mamba_d_state"], cfg["mamba_n_heads"]
    z = torch.as_tensor(rng.normal(0, 1, (S, inner)))
    xbc = torch.as_tensor(rng.normal(0, 1, (S, inner + 2 * N)))
    dt = torch.as_tensor(rng.normal(0, 1, (S, H)))
    want = _scan(z, xbc, dt, p, cfg)
    got = R.mixer_core(z, xbc, dt, p, cfg)
    assert float((got - want).abs().max()) < 1e-12


def test_imports_only_torch():
    """The reference imports torch and nothing of the port or JAX."""
    src = Path(R.__file__).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or ".").split(".")[0] if node.level == 0
                      else ".")
    assert names <= {"torch", "__future__"}, names
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
