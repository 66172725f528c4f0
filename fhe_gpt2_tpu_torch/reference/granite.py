"""Plain float64 reference of Granite 4.0-H (HF ``granitemoehybrid``, dense).

The published forward of ``ibm-granite/granite-4.0-h-micro`` in plain
``torch`` (float64, on whatever device the arrays are on), written from
``transformers``' ``modeling_granitemoehybrid.py``
(``GraniteMoeHybridMambaLayer.torch_forward``,
``GraniteMoeHybridRMSNormGated``, ``GraniteMoeHybridMLP``,
``GraniteMoeHybridAttention``, ``GraniteMoeHybridDecoderLayer.forward``):

* embedding × ``embedding_multiplier``; per layer
  ``h = x + r·mixer(RMSNorm(x))`` and ``out = h + r·MLP(RMSNorm(h))``
  with r = ``residual_multiplier``; a final RMSNorm; tied logits divided
  by ``logits_scaling``.
* Mamba-2 mixer: ``[z | xBC | dt] = in_proj(u)``; xBC through the causal
  depthwise conv (kernel ``mamba_d_conv``, zero before token 0) and SiLU;
  ``dt = softplus(dt + dt_bias)``, ``A = −exp(A_log)``;
  ``y[t] = Σ_{s≤t} (C[t]·B[s]) · exp(Σ_{r=s+1..t} A·dt[r]) · dt[s] · x[s]
  + D·x[t]`` per head (one group of B and C, shared by every head); then
  ``out_proj(w ⊙ RMSNorm(y ⊙ SiLU(z)))`` over the whole inner width.
* Attention: grouped-query (``num_key_value_heads`` K/V heads, each
  serving ``num_attention_heads / num_key_value_heads`` query heads),
  causal softmax of ``q·k · attention_multiplier``, no position encoding
  (``position_embedding_type`` ``nope``), no biases.
* MLP: ``output_linear(SiLU(g) ⊙ v)``, ``[g | v] = input_linear(h)``.

The SSD sum is the exact quadratic (attention-like) form, which equals
the chunked scan of ``torch_forward`` for any chunk size. There is no
polynomial, Newton iteration or refresh here. Departures from
``transformers``: none in the mathematics; ``transformers`` computes the
mixer's gated norm and its A in float32, this file everything in float64.
``time_step_limit`` is (0, inf) there, so its clamp is left out.

Weights are an HF-format state dict (``model.``-prefixed or not; numpy
arrays or tensors; ``nn.Linear`` weights as [out, in]). Each layer is a
function of its own, so a caller at published widths evaluates one layer
at a time.

Imports nothing but ``torch``.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64


def _t(v, device=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(dtype=F64, device=device or v.device)
    return torch.as_tensor(v, dtype=F64, device=device)


def weight(w: dict, name: str, device=None) -> torch.Tensor:
    """Weight `name` (without the ``model.`` prefix) of the state dict."""
    for k in (name, "model." + name):
        if k in w:
            return _t(w[k], device)
    raise KeyError(name)


def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    return torch.nn.functional.softplus(x)


def rms_norm(x, w, eps: float):
    """x / √(mean(x²) + eps) · w over the last axis."""
    x = _t(x)
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * _t(
        w, x.device)


# ---------------------------------------------------------------------------
# Mamba-2 mixer
# ---------------------------------------------------------------------------

def split_in_proj(proj, cfg: dict):
    """(z, xBC, dt_raw) of in_proj's output [S, 2·inner + 2·N + heads]."""
    inner = cfg["mamba_expand"] * cfg["hidden_size"]
    n = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    return (proj[..., :inner], proj[..., inner:2 * inner + 2 * n],
            proj[..., 2 * inner + 2 * n:])


def causal_conv(xbc, conv_w, conv_b):
    """The depthwise causal conv of ``nn.Conv1d(groups=channels,
    padding=k−1)[..., :S]``: out[t, c] = b[c] + Σ_j w[c, j]·x[t−k+1+j, c],
    zero before token 0. conv_w [channels, 1, k] or [channels, k]."""
    xbc = _t(xbc)
    w = _t(conv_w, xbc.device).reshape(xbc.shape[-1], -1)
    k = w.shape[-1]
    S = xbc.shape[0]
    pad = torch.cat([torch.zeros(k - 1, xbc.shape[-1], dtype=F64,
                                 device=xbc.device), xbc])
    out = _t(conv_b, xbc.device).expand(S, -1).clone()
    for j in range(k):
        out = out + w[:, j] * pad[j:j + S]
    return out


def mixer_core(z, xbc, dt_raw, p: dict, cfg: dict):
    """The Mamba-2 mixer between in_proj and out_proj: the gated RMSNorm's
    output [S, inner] (out_proj's input) from in_proj's three outputs.

    p holds the layer's ``conv1d.weight``, ``conv1d.bias``, ``dt_bias``,
    ``A_log``, ``D`` and ``norm.weight`` (the names after ``mamba.``)."""
    return rms_norm(gated_norm_input(z, xbc, dt_raw, p, cfg),
                    p["norm.weight"], cfg["rms_norm_eps"])


def gated_norm_input(z, xbc, dt_raw, p: dict, cfg: dict):
    """y ⊙ SiLU(z) [S, inner]: the SSD output with its D skip, gated, which
    the mixer's RMSNorm normalizes (``mixer_core`` without that norm)."""
    z, xbc, dt_raw = _t(z), _t(xbc), _t(dt_raw)
    dev = z.device
    S = z.shape[0]
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    N = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    inner = H * P
    xbc = silu(causal_conv(xbc, p["conv1d.weight"], p["conv1d.bias"]))
    x, Bm, Cm = xbc[:, :inner], xbc[:, inner:inner + N], xbc[:, inner + N:]
    dt = softplus(dt_raw + _t(p["dt_bias"], dev))                 # [S, H]
    A = -torch.exp(_t(p["A_log"], dev))                           # [H]
    cs = torch.cumsum(dt * A, dim=0)                              # [S, H]
    seg = cs[:, None, :] - cs[None, :, :]                         # [t, s, H]
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=dev))
    decay = torch.where(causal[..., None], torch.exp(
        torch.where(causal[..., None], seg, torch.zeros_like(seg))),
        torch.zeros_like(seg))
    G = Cm @ Bm.T                                                 # [t, s]
    xh = x.reshape(S, H, P)
    w = G[..., None] * decay * dt[None, :, :]                     # [t, s, H]
    y = torch.einsum("tsh,shp->thp", w, xh)
    y = y + _t(p["D"], dev)[:, None] * xh
    return y.reshape(S, inner) * silu(z)


def mamba_mixer(u, w: dict, layer: int, cfg: dict):
    """The whole mixer of layer `layer` over its normalized input u."""
    pre = f"layers.{layer}.mamba."
    dev = _t(u).device
    p = {k: weight(w, pre + k, dev) for k in (
        "conv1d.weight", "conv1d.bias", "dt_bias", "A_log", "D",
        "norm.weight")}
    proj = _t(u) @ weight(w, pre + "in_proj.weight", dev).T
    core = mixer_core(*split_in_proj(proj, cfg), p, cfg)
    return core @ weight(w, pre + "out_proj.weight", dev).T


# ---------------------------------------------------------------------------
# Attention, MLP, layers, model
# ---------------------------------------------------------------------------

def attention(u, w: dict, layer: int, cfg: dict):
    """Grouped-query causal attention of layer `layer` over its normalized
    input u [S, hidden]."""
    pre = f"layers.{layer}.self_attn."
    u = _t(u)
    dev = u.device
    S = u.shape[0]
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg["hidden_size"] // Hq
    q = (u @ weight(w, pre + "q_proj.weight", dev).T).reshape(S, Hq, dh)
    k = (u @ weight(w, pre + "k_proj.weight", dev).T).reshape(S, Hkv, dh)
    v = (u @ weight(w, pre + "v_proj.weight", dev).T).reshape(S, Hkv, dh)
    rep = Hq // Hkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("thd,shd->hts", q, k) * cfg["attention_multiplier"]
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=dev))
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), v)
    return o.reshape(S, Hq * dh) @ weight(w, pre + "o_proj.weight", dev).T


def mlp(h, w: dict, layer: int):
    """The shared SwiGLU MLP of layer `layer` over its normalized input."""
    pre = f"layers.{layer}.shared_mlp."
    h = _t(h)
    gv = h @ weight(w, pre + "input_linear.weight", h.device).T
    g, v = gv.chunk(2, dim=-1)
    return (silu(g) * v) @ weight(w, pre + "output_linear.weight",
                                  h.device).T


def mixer_sublayer(x, w: dict, layer: int, cfg: dict):
    """x + r·mixer(RMSNorm(x)): the first half of a layer, with the mixer
    of its kind (``cfg["layer_types"][layer]``)."""
    x = _t(x)
    u = rms_norm(x, weight(w, f"layers.{layer}.input_layernorm.weight",
                           x.device), cfg["rms_norm_eps"])
    if cfg["layer_types"][layer] == "mamba":
        m = mamba_mixer(u, w, layer, cfg)
    else:
        m = attention(u, w, layer, cfg)
    return x + cfg["residual_multiplier"] * m


def mlp_sublayer(h, w: dict, layer: int, cfg: dict):
    """h + r·MLP(RMSNorm(h)): the second half of a layer."""
    h = _t(h)
    u = rms_norm(h, weight(
        w, f"layers.{layer}.post_attention_layernorm.weight", h.device),
        cfg["rms_norm_eps"])
    return h + cfg["residual_multiplier"] * mlp(u, w, layer)


def layer(x, w: dict, i: int, cfg: dict):
    """Decoder layer i."""
    return mlp_sublayer(mixer_sublayer(x, w, i, cfg), w, i, cfg)


def embed(w: dict, ids, cfg: dict, device=None):
    """The embedding rows of token ids, × embedding_multiplier."""
    table = weight(w, "embed_tokens.weight", device)
    return table[torch.as_tensor(ids, device=table.device)] * cfg[
        "embedding_multiplier"]


def forward(w: dict, x, cfg: dict, layers=None):
    """The last hidden state (after the final RMSNorm) over the embedded
    input x [S, hidden] through `layers` (default all of
    ``cfg["num_hidden_layers"]``)."""
    x = _t(x)
    for i in (range(cfg["num_hidden_layers"]) if layers is None
              else layers):
        x = layer(x, w, i, cfg)
    return rms_norm(x, weight(w, "norm.weight", x.device),
                    cfg["rms_norm_eps"])


def logits(w: dict, hidden, cfg: dict):
    """Tied logits over the final hidden state, / logits_scaling."""
    hidden = _t(hidden)
    return hidden @ weight(w, "embed_tokens.weight", hidden.device).T / cfg[
        "logits_scaling"]
