"""Full encrypted GPT-2: weight import, plan building, end-to-end forward.

Counterpart of the reference's model layer: plain_approx/full_gpt2.py
(gpt2_setup / gpt2_inference), gpt2_ckks run/infer_gpt2.cpp, and the
weights.proto export pipeline. Weights come from a HuggingFace GPT-2 state
dict (or any dict with the same keys); embedding and LM head run host-side
(the reference's EmbeddingLayer is also plaintext — the private-embedding
variant goes through the PIR path, net/).

The port's copy of ``fhe_gpt2_tpu/nn/model.py``. ``build_gpt2_plans``,
``embed``, ``logits`` and ``calibrate_newton_inits`` are unchanged. The
forward runs eagerly, or through the segment driver (``_forward_jit``),
whose segments are sealed programs (CUDA graphs on the card); unlike the
JAX driver's, a layer never runs another layer's constants. Added for
runs without ``transformers``: ``synthetic_weights`` (an HF-format state
dict drawn from a numpy generator), ``forward_float`` (the float64 GPT-2
forward, the oracle) and ``rowmax_newton_inits`` (LayerNorm Newton seeds
from the float forward's largest row).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import layers as L


@dataclass
class GPT2ModelPlans:
    sh: L.GPT2Shapes
    blocks: list                  # [BlockPlans]
    ln_f: L.LnPlans
    wte: Optional[np.ndarray] = None     # [vocab, d] host embedding
    wpe: Optional[np.ndarray] = None     # [pos, d]


def _get(weights, *names):
    for n in names:
        if n in weights:
            w = weights[n]
            return w.detach().cpu().numpy() if hasattr(w, "detach") else np.asarray(w)
    raise KeyError(names)


def build_gpt2_plans(sh: L.GPT2Shapes, weights: dict, n_layers: int,
                     newton_inits=None, giant=None,
                     attn_overrides: dict = None,
                     ln_iters: int = 12) -> GPT2ModelPlans:
    """Build all per-layer LT plans from a HF-style GPT-2 state dict.

    `newton_inits`: per-layer (ln1, ln2) Σz² magnitudes (host-calibrated on
    representative data, like the reference's hardcoded 40298902 /
    5.74e8 inits, full_gpt2.py:101,130); defaults to 1e4·d² heuristics.
    """
    d = sh.hidden
    blocks = []
    for i in range(n_layers):
        p = f"transformer.h.{i}." if any(
            k.startswith("transformer.h.") for k in weights) else f"h.{i}."
        cw = _get(weights, p + "attn.c_attn.weight")
        cb = _get(weights, p + "attn.c_attn.bias")
        wq, wk, wv = np.split(cw, 3, axis=-1)
        bq, bk, bv = np.split(cb, 3, axis=-1)
        wo = _get(weights, p + "attn.c_proj.weight")
        bo = _get(weights, p + "attn.c_proj.bias")
        ap = L.build_attn_plans(sh, wq, bq, wk, bk, wv, bv, wo, bo, giant)
        for k, v in (attn_overrides or {}).items():
            # A list value is per-layer (e.g. trained per-layer/per-head
            # ConsMax β/γ from calibrate.train_consmax).
            setattr(ap, k, v[i] if isinstance(v, list) else v)
        init1, init2 = (newton_inits[i] if newton_inits else
                        (1e4 * d * d, 1e4 * d * d))
        ln1 = L.build_ln_plans(
            sh, _get(weights, p + "ln_1.weight"), _get(weights, p + "ln_1.bias"),
            newton_init=init1, iters=ln_iters)
        ln2 = L.build_ln_plans(
            sh, _get(weights, p + "ln_2.weight"), _get(weights, p + "ln_2.bias"),
            newton_init=init2, iters=ln_iters)
        mp = L.build_mlp_plans(
            sh,
            _get(weights, p + "mlp.c_fc.weight"), _get(weights, p + "mlp.c_fc.bias"),
            _get(weights, p + "mlp.c_proj.weight"), _get(weights, p + "mlp.c_proj.bias"),
            giant)
        blocks.append(L.BlockPlans(ln1=ln1, attn=ap, ln2=ln2, mlp=mp))
    pf = "transformer." if any(k.startswith("transformer.") for k in weights) else ""
    ln_f = L.build_ln_plans(
        sh, _get(weights, pf + "ln_f.weight"), _get(weights, pf + "ln_f.bias"),
        newton_init=(newton_inits[-1][0] if newton_inits else 1e4 * d * d),
        iters=ln_iters)
    wte = wpe = None
    try:
        wte = _get(weights, pf + "wte.weight")
        wpe = _get(weights, pf + "wpe.weight")
    except KeyError:
        pass
    return GPT2ModelPlans(sh=sh, blocks=blocks, ln_f=ln_f, wte=wte, wpe=wpe)


def embed(plans: GPT2ModelPlans, token_ids: np.ndarray) -> np.ndarray:
    """Host-side embedding lookup: [seq] -> [seq, d]."""
    sh = plans.sh
    assert len(token_ids) <= sh.seq
    out = np.zeros((sh.seq, sh.hidden))
    n = len(token_ids)
    out[:n] = plans.wte[token_ids] + plans.wpe[:n]
    return out


def forward(B, xs, plans: GPT2ModelPlans, jit: bool = False,
            boot_need: int = 0):
    """Run all blocks + final LN on backend values (act-layout ct list).

    Eagerly by default, each op issued as it is called; refreshes happen
    where the backend's level floor asks for them. jit=True runs the
    segment driver (``_forward_jit``): each block is four sealed programs
    (LN1, attention+residual, LN2, MLP+residual; CUDA graphs on the card),
    and boot_need > 0 puts B.maybe_bootstrap(·, boot_need) before each
    segment, outside the programs. boot_need acts only under jit=True, as
    in the JAX package."""
    if jit:
        return _forward_jit(B, xs, plans, boot_need)
    for bp in plans.blocks:
        xs = L.block(B, xs, plans.sh, bp)
    return L.layer_norm(B, xs, plans.sh, plans.ln_f)


def _forward_jit(B, xs, plans: GPT2ModelPlans, boot_need: int = 0):
    """The JAX package's segment driver, with one difference: a layer
    has a program of its own (``rebind_sealed``), so each layer keeps its
    own LayerNorm Newton seed where the JAX driver's shared program keeps
    layer 0's."""
    from .backend import segment_runner

    sh = plans.sh
    run = segment_runner(B, "gpt2", plans)

    def boot(vs):
        if not boot_need:
            return vs
        return [B.maybe_bootstrap(v, boot_need) for v in vs]

    for li, bp in enumerate(plans.blocks):
        n = len(xs)

        def ln1_fn(vs, bp=bp):
            return L.layer_norm(B, vs, sh, bp.ln1)

        def attn_fn(both, bp=bp, n=n):
            h, res = both[:n], both[n:]
            a = L.attention(B, h, sh, bp.attn)
            return [B.add(x, y) for x, y in zip(res, a)]

        def ln2_fn(vs, bp=bp):
            return L.layer_norm(B, vs, sh, bp.ln2)

        def mlp_fn(both, bp=bp, n=n):
            h, res = both[:n], both[n:]
            m = L.mlp(B, h, sh, bp.mlp)
            return [B.add(x, y) for x, y in zip(res, m)]

        h = run("ln1", ln1_fn, boot(xs), part=li)
        xs = run("attn", attn_fn, boot(h) + xs, part=li)
        h = run("ln2", ln2_fn, boot(xs), part=li)
        xs = run("mlp", mlp_fn, boot(h) + xs, part=li)

    def lnf_fn(vs):
        return L.layer_norm(B, vs, sh, plans.ln_f)

    return run("ln_f", lnf_fn, boot(xs))


def logits(plans: GPT2ModelPlans, hidden: np.ndarray) -> np.ndarray:
    """Host-side LM head (weight-tied): hidden [seq, d] -> [seq, vocab]."""
    return hidden @ plans.wte.T


def calibrate_newton_inits(sh: L.GPT2Shapes, weights: dict, n_layers: int,
                           sample: np.ndarray) -> list:
    """Measure per-layer Σz² magnitudes on plaintext sample activations —
    the host-side analogue of the reference's hand-tuned Newton constants."""
    import torch
    outs = []
    x = sample

    def ss(M):
        z = sh.hidden * (M - M.mean(-1, keepdims=True))
        return float((z ** 2).sum(-1).mean())

    def ln(M, g, b):
        mu = M.mean(-1, keepdims=True)
        v = ((M - mu) ** 2).mean(-1, keepdims=True)
        return (M - mu) / np.sqrt(v + 1e-5) * g + b

    def gelu(v):
        import math
        erf = np.vectorize(math.erf)
        return v / 2 * (1 + erf(v / np.sqrt(2)))

    for i in range(n_layers):
        p = f"transformer.h.{i}." if any(
            k.startswith("transformer.h.") for k in weights) else f"h.{i}."
        g1, b1 = _get(weights, p + "ln_1.weight"), _get(weights, p + "ln_1.bias")
        g2, b2 = _get(weights, p + "ln_2.weight"), _get(weights, p + "ln_2.bias")
        s1 = ss(x)
        h = ln(x, g1, b1)
        cw = _get(weights, p + "attn.c_attn.weight")
        cb = _get(weights, p + "attn.c_attn.bias")
        wq, wk, wv = np.split(cw, 3, -1)
        bq, bk, bv = np.split(cb, 3, -1)
        Q, K_, V = h @ wq + bq, h @ wk + bk, h @ wv + bv
        S = x.shape[0]
        att = np.zeros_like(h)
        dh = sh.dh
        for hd in range(sh.heads):
            sl = slice(hd * dh, (hd + 1) * dh)
            sc = Q[:, sl] @ K_[:, sl].T / np.sqrt(dh)
            sc = np.where(np.tril(np.ones((S, S))) > 0, sc, -1e9)
            e = np.exp(sc - sc.max(-1, keepdims=True))
            att[:, sl] = (e / e.sum(-1, keepdims=True)) @ V[:, sl]
        x = x + att @ _get(weights, p + "attn.c_proj.weight") + _get(
            weights, p + "attn.c_proj.bias")
        s2 = ss(x)
        h2 = ln(x, g2, b2)
        m = gelu(h2 @ _get(weights, p + "mlp.c_fc.weight") +
                 _get(weights, p + "mlp.c_fc.bias"))
        x = x + m @ _get(weights, p + "mlp.c_proj.weight") + _get(
            weights, p + "mlp.c_proj.bias")
        outs.append((s1, s2))
    outs.append((ss(x), ss(x)))
    return outs


# ---------------------------------------------------------------------------
# Runs without ``transformers``: synthetic weights and the float64 oracle
# ---------------------------------------------------------------------------

INIT_STD = 0.02           # GPT-2's initializer_range
# The residual projections (attn.c_proj, mlp.c_proj) are drawn at
# INIT_STD/sqrt(2·n_layer) with GPT-2 small's n_layer = 12, whatever depth is
# run.
PROJ_STD = INIT_STD / np.sqrt(2 * 12)
# The token and position embeddings are drawn at 0.05, not 0.02. The
# encrypted LayerNorm has no epsilon of its own (its +1 on Σz² = d³·var is
# 1/d³ on the variance), so it differs from GPT-2's by LN_EPS/var: at 0.02
# the first LayerNorm's input variance is 8e-4 and that difference alone
# moves the 768-wide hidden state by 0.017; at 0.05 by 0.003.
EMBED_STD = 0.05
LN_EPS = 1e-5             # GPT-2's layer_norm_epsilon


def synthetic_weights(rng, n_layers: int, hidden: int, heads: int,
                      vocab: int, n_positions: int) -> dict:
    """An HF-format GPT-2 state dict (``transformer.*`` keys, numpy float64,
    Conv1D weights as [in, out]) with every key ``build_gpt2_plans`` reads,
    drawn from the numpy generator ``rng`` at GPT-2's init scale: weights
    N(0, 0.02), the two c_proj weights N(0, 0.02/sqrt(24)). Unlike HF's
    random init, the embeddings are N(0, EMBED_STD), biases and LN β are
    N(0, 0.02) and LN γ is U(0.8, 1.2), so every bias and γ mask carries
    data. ``heads`` must divide ``hidden``; it sets no shape."""
    assert hidden % heads == 0
    d = hidden

    def normal(std, *shape):
        return rng.normal(0.0, std, shape)

    def ln(p):
        return {p + ".weight": rng.uniform(0.8, 1.2, d),
                p + ".bias": normal(INIT_STD, d)}

    w = {"transformer.wte.weight": normal(EMBED_STD, vocab, d),
         "transformer.wpe.weight": normal(EMBED_STD, n_positions, d)}
    for i in range(n_layers):
        p = f"transformer.h.{i}."
        w.update(ln(p + "ln_1"))
        w[p + "attn.c_attn.weight"] = normal(INIT_STD, d, 3 * d)
        w[p + "attn.c_attn.bias"] = normal(INIT_STD, 3 * d)
        w[p + "attn.c_proj.weight"] = normal(PROJ_STD, d, d)
        w[p + "attn.c_proj.bias"] = normal(INIT_STD, d)
        w.update(ln(p + "ln_2"))
        w[p + "mlp.c_fc.weight"] = normal(INIT_STD, d, 4 * d)
        w[p + "mlp.c_fc.bias"] = normal(INIT_STD, 4 * d)
        w[p + "mlp.c_proj.weight"] = normal(PROJ_STD, 4 * d, d)
        w[p + "mlp.c_proj.bias"] = normal(INIT_STD, d)
    w.update(ln("transformer.ln_f"))
    return w


def _float_forward(weights: dict, ids, n_layers: int, heads: int):
    """GPT-2's forward in float64 numpy: (last hidden state [seq, d], the
    per-row Σz² = Σ_c (d·(x − mean x))² at each LayerNorm's input, as
    [(ln_1 rows, ln_2 rows) per layer] + [(ln_f rows, ln_f rows)])."""
    pf = "transformer." if any(k.startswith("transformer.")
                               for k in weights) else ""
    ids = np.asarray(ids)
    S = len(ids)
    x = _get(weights, pf + "wte.weight")[ids] + _get(
        weights, pf + "wpe.weight")[:S]
    d = x.shape[-1]
    dh = d // heads
    causal = np.tril(np.ones((S, S), dtype=bool))

    def sums(M):
        return ((d * (M - M.mean(-1, keepdims=True))) ** 2).sum(-1)

    def ln(M, p):
        mu = M.mean(-1, keepdims=True)
        v = ((M - mu) ** 2).mean(-1, keepdims=True)
        return ((M - mu) / np.sqrt(v + LN_EPS) * _get(weights, p + ".weight")
                + _get(weights, p + ".bias"))

    def gelu_new(v):
        return 0.5 * v * (1.0 + np.tanh(np.sqrt(2.0 / np.pi)
                                        * (v + 0.044715 * v ** 3)))

    taps = []
    for i in range(n_layers):
        p = f"{pf}h.{i}."
        s1 = sums(x)
        h = ln(x, p + "ln_1")
        qkv = h @ _get(weights, p + "attn.c_attn.weight") + _get(
            weights, p + "attn.c_attn.bias")
        Q, K_, V = np.split(qkv, 3, axis=-1)
        att = np.zeros_like(h)
        for hd in range(heads):
            sl = slice(hd * dh, (hd + 1) * dh)
            sc = Q[:, sl] @ K_[:, sl].T / np.sqrt(dh)
            sc = np.where(causal, sc, -np.inf)
            e = np.exp(sc - sc.max(-1, keepdims=True))
            att[:, sl] = (e / e.sum(-1, keepdims=True)) @ V[:, sl]
        x = x + att @ _get(weights, p + "attn.c_proj.weight") + _get(
            weights, p + "attn.c_proj.bias")
        taps.append((s1, sums(x)))
        h2 = ln(x, p + "ln_2")
        m = gelu_new(h2 @ _get(weights, p + "mlp.c_fc.weight")
                     + _get(weights, p + "mlp.c_fc.bias"))
        x = x + m @ _get(weights, p + "mlp.c_proj.weight") + _get(
            weights, p + "mlp.c_proj.bias")
    taps.append((sums(x), sums(x)))
    return ln(x, pf + "ln_f"), taps


def forward_float(weights: dict, ids, n_layers: int, heads: int) -> np.ndarray:
    """The float64 GPT-2 forward (HF ``GPT2Model``: LayerNorm eps 1e-5, the
    tanh GELU, causal softmax attention) over token ``ids``: the last hidden
    state [len(ids), d], after ``ln_f``. The oracle wherever
    ``transformers`` is absent."""
    return _float_forward(weights, ids, n_layers, heads)[0]


def ln_input_sums(weights: dict, ids, n_layers: int, heads: int) -> list:
    """The per-row Σz² = Σ_c (d·(x − mean x))² at each LayerNorm's input in
    the float forward over ``ids``: [(ln_1 rows, ln_2 rows) per layer] +
    [(ln_f rows, ln_f rows)], ``calibrate_newton_inits``' layout."""
    return _float_forward(weights, ids, n_layers, heads)[1]


def rowmax_newton_inits(weights: dict, ids, n_layers: int, heads: int,
                        margin: float = 1.25) -> list:
    """LayerNorm Newton seeds for ``build_gpt2_plans(newton_inits=...)``:
    ``margin`` times the largest row's Σz² at each LayerNorm's input in the
    float forward, in ``calibrate_newton_inits``' format. The Taylor seed of
    ``kernels.newton_rsqrt`` goes negative above about three times its
    centre, so a seed at the row mean diverges on rows far above it; one
    above every row converges on all of them."""
    return [(margin * float(a.max()), margin * float(b.max()))
            for a, b in ln_input_sums(weights, ids, n_layers, heads)]
