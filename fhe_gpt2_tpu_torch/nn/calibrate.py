"""Data-driven calibration of the encrypted-attention nonlinearity knobs.

The reference hand-tunes its approximation constants per model: ConsMax
gamma/beta are *trained* offline (plain_approx/gpt2_approx_checkpoint_2.py:
37-83 ApproxSoftmax), the Goldschmidt prescale and iteration counts are
hardcoded (PolyApprox.cpp compute_inverse call sites), and the exp ladder r
is fixed. Here every knob is derived from plaintext activation statistics on
a representative sample — the same calibration posture as
model.calibrate_newton_inits, extended to the whole attention stack:

  exp_r        — ladder depth for exp(x) = (1+x/2^r)^(2^r): r chosen so the
                 relative ladder error x²/2^(r+1) at the observed argument
                 range stays under `tol`.
  smax_gamma   — ConsMax shift, fitted per layer to minimize the mean L2
                 distance between exp(s−γ)/Σexp(s−γ) and the true softmax
                 over the sample scores (golden-section search — the
                 train-free counterpart of the learned gamma).
  inv_prescale — Goldschmidt normalizer 2/(d_max+d_min) placing the observed
                 softmax denominators symmetrically inside (0, 2).
  inv_iters    — from the contraction rho = (d_max−d_min)/(d_max+d_min):
                 error after k iterations is rho^(2^k); k solves that ≤ tol.
  max_bound    — score magnitude bound for the softmax="max" path (quickMax
                 normalization), with a 1.25 safety margin.

The port's copy of ``fhe_gpt2_tpu/nn/calibrate.py``, unchanged (numpy, and
torch for ``train_consmax``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .model import _get


@dataclass
class AttnKnobs:
    exp_r: int
    smax_gamma: float
    inv_prescale: float
    inv_iters: int
    max_bound: float

    def as_overrides(self) -> dict:
        return dict(exp_r=self.exp_r, smax_gamma=self.smax_gamma,
                    inv_prescale=self.inv_prescale, inv_iters=self.inv_iters,
                    max_bound=self.max_bound)


def _softmax(s, axis=-1):
    e = np.exp(s - s.max(axis, keepdims=True))
    return e / e.sum(axis, keepdims=True)


def fit_consmax_gamma(scores: np.ndarray, lo: float = -5.0,
                      hi: float = 30.0, iters: int = 60) -> float:
    """Golden-section fit of the ConsMax shift γ on masked score rows
    [rows, targets] (−inf-free; use −1e9 fills). Minimizes
    E‖exp(s−γ)/Σexp(s−γ) − softmax(s)‖²; exp overflow is excluded by
    clipping the argument at 30."""
    sm = _softmax(scores)

    def loss(g):
        e = np.exp(np.clip(scores - g, -60.0, 30.0))
        cs = e / np.maximum(e.sum(-1, keepdims=True), 1e-30)
        return float(((cs - sm) ** 2).mean())

    phi = (math.sqrt(5) - 1) / 2
    a, b = lo, hi
    c, d = b - phi * (b - a), a + phi * (b - a)
    fc, fd = loss(c), loss(d)
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - phi * (b - a)
            fc = loss(c)
        else:
            a, c, fc = c, d, fd
            d = a + phi * (b - a)
            fd = loss(d)
    return float((a + b) / 2)


def _collect_layer_scores(sh, weights, n_layers, sample):
    """Plain forward over `sample` collecting per-layer masked score tensors
    [heads, S, S] (the shared front half of calibrate_attn_knobs /
    train_consmax)."""
    d, dh, S = sh.hidden, sh.dh, sample.shape[0]
    causal = np.tril(np.ones((S, S))) > 0

    def ln(M, g, b):
        mu = M.mean(-1, keepdims=True)
        v = ((M - mu) ** 2).mean(-1, keepdims=True)
        return (M - mu) / np.sqrt(v + 1e-5) * g + b

    def gelu(v):
        erf = np.vectorize(math.erf)
        return v / 2 * (1 + erf(v / np.sqrt(2)))

    x = np.array(sample)
    out = []
    for i in range(n_layers):
        p = f"transformer.h.{i}." if any(
            k.startswith("transformer.h.") for k in weights) else f"h.{i}."
        h = ln(x, _get(weights, p + "ln_1.weight"),
               _get(weights, p + "ln_1.bias"))
        cw = _get(weights, p + "attn.c_attn.weight")
        cb = _get(weights, p + "attn.c_attn.bias")
        wq, wk, wv = np.split(cw, 3, -1)
        bq, bk, bv = np.split(cb, 3, -1)
        Q, K_, V = h @ wq + bq, h @ wk + bk, h @ wv + bv
        att = np.zeros_like(h)
        layer_scores = []
        for hd in range(sh.heads):
            sl = slice(hd * dh, (hd + 1) * dh)
            sc = Q[:, sl] @ K_[:, sl].T / np.sqrt(dh)
            scm = np.where(causal, sc, -1e9)
            layer_scores.append(scm)
            att[:, sl] = _softmax(scm) @ V[:, sl]
        out.append(np.stack(layer_scores))
        x = x + att @ _get(weights, p + "attn.c_proj.weight") + _get(
            weights, p + "attn.c_proj.bias")
        h2 = ln(x, _get(weights, p + "ln_2.weight"),
                _get(weights, p + "ln_2.bias"))
        m = gelu(h2 @ _get(weights, p + "mlp.c_fc.weight") +
                 _get(weights, p + "mlp.c_fc.bias"))
        x = x + m @ _get(weights, p + "mlp.c_proj.weight") + _get(
            weights, p + "mlp.c_proj.bias")
    return out, causal


def train_consmax(sh, weights: dict, n_layers: int, sample: np.ndarray,
                  iters: int = 400, lr: float = 0.05):
    """Train per-layer, PER-HEAD ConsMax β/γ by gradient descent — the
    counterpart of the reference's learnable ApproxSoftmax
    (gpt2_approx_checkpoint_2.py:37-83: X ← exp(X − β)/γ with β, γ
    nn.Parameters trained end-to-end). Here the objective is distillation
    against the true softmax on the sample's masked scores: per head,
    minimize E‖exp(s−β)/γ − softmax(s)‖² (Adam). The constant denominator
    removes the row-sum fold AND the Goldschmidt inverse from the encrypted
    path (attention(softmax="consmax")).

    Returns (betas, gammas): lists of per-layer float64 arrays [heads],
    installable via build_gpt2_plans(attn_overrides={"softmax_mode":
    "consmax", "consmax_beta": betas, "consmax_gamma": gammas}).
    """
    import torch

    scores_per_layer, causal = _collect_layer_scores(
        sh, weights, n_layers, sample)
    mask = torch.tensor(causal, dtype=torch.float64)
    betas, gammas = [], []
    for sc_np in scores_per_layer:
        sc = torch.tensor(sc_np, dtype=torch.float64)    # [H, S, S]
        tgt = torch.softmax(torch.where(mask > 0, sc, torch.tensor(-1e9)),
                            dim=-1) * mask
        # Init: β at the per-head causal max (range control, like the
        # reference's beta_start), γ at the mean row sum of exp(s−β0).
        with torch.no_grad():
            sc_m = torch.where(mask > 0, sc, torch.tensor(-1e30))
            b0 = sc_m.amax(dim=(-2, -1))
            e0 = torch.exp(torch.clamp(sc - b0[:, None, None],
                                       -60.0, 30.0)) * mask
            g0 = e0.sum(-1).mean(-1)
        beta = b0.clone().requires_grad_(True)
        log_gamma = torch.log(torch.clamp(g0, min=1e-6)).requires_grad_(True)
        opt = torch.optim.Adam([beta, log_gamma], lr=lr)
        for _ in range(iters):
            opt.zero_grad()
            e = torch.exp(torch.clamp(sc - beta[:, None, None],
                                      -60.0, 30.0)) * mask
            cs = e / torch.exp(log_gamma)[:, None, None]
            loss = ((cs - tgt) ** 2).mean()
            loss.backward()
            opt.step()
        betas.append(beta.detach().numpy().astype(np.float64))
        gammas.append(np.exp(log_gamma.detach().numpy()).astype(np.float64))
    return betas, gammas


def calibrate_attn_knobs(sh, weights: dict, n_layers: int,
                         sample: np.ndarray, tol: float = 1e-3,
                         margin: float = 1.25) -> AttnKnobs:
    """Derive attention knobs from the plain forward on `sample` [seq, d].

    Statistics are pooled across layers (the encrypted model shares one knob
    set, like the reference's per-model constants); per-layer γ fits are
    averaged — the spread is reported in the returned knobs only through the
    pooled denominator range.
    """
    d = sh.hidden
    dh = sh.dh
    S = sample.shape[0]
    causal = np.tril(np.ones((S, S))) > 0

    def ln(M, g, b):
        mu = M.mean(-1, keepdims=True)
        v = ((M - mu) ** 2).mean(-1, keepdims=True)
        return (M - mu) / np.sqrt(v + 1e-5) * g + b

    def gelu(v):
        erf = np.vectorize(math.erf)
        return v / 2 * (1 + erf(v / np.sqrt(2)))

    x = np.array(sample)
    score_max = 0.0
    gammas = []
    layer_stats = []          # (gamma_i, den_lo_i, den_hi_i, arg_lo_i)
    for i in range(n_layers):
        p = f"transformer.h.{i}." if any(
            k.startswith("transformer.h.") for k in weights) else f"h.{i}."
        h = ln(x, _get(weights, p + "ln_1.weight"),
               _get(weights, p + "ln_1.bias"))
        cw = _get(weights, p + "attn.c_attn.weight")
        cb = _get(weights, p + "attn.c_attn.bias")
        wq, wk, wv = np.split(cw, 3, -1)
        bq, bk, bv = np.split(cb, 3, -1)
        Q, K_, V = h @ wq + bq, h @ wk + bk, h @ wv + bv
        att = np.zeros_like(h)
        layer_scores = []
        for hd in range(sh.heads):
            sl = slice(hd * dh, (hd + 1) * dh)
            sc = Q[:, sl] @ K_[:, sl].T / np.sqrt(dh)
            scm = np.where(causal, sc, -1e9)
            layer_scores.append(scm)
            att[:, sl] = _softmax(scm) @ V[:, sl]
        sc_all = np.stack(layer_scores)           # [heads, S, S]
        score_max = max(score_max, float(np.abs(sc_all[:, causal]).max()))
        g = fit_consmax_gamma(sc_all.reshape(-1, S))
        gammas.append(g)
        e = np.exp(np.clip(sc_all - g, -60, 30)) * causal
        den = e.sum(-1)
        layer_stats.append((g, float(den.min()), float(den.max()),
                            float((sc_all[:, causal] - g).min(initial=0.0))))
        x = x + att @ _get(weights, p + "attn.c_proj.weight") + _get(
            weights, p + "attn.c_proj.bias")
        h2 = ln(x, _get(weights, p + "ln_2.weight"),
                _get(weights, p + "ln_2.bias"))
        m = gelu(h2 @ _get(weights, p + "mlp.c_fc.weight") +
                 _get(weights, p + "mlp.c_fc.bias"))
        x = x + m @ _get(weights, p + "mlp.c_proj.weight") + _get(
            weights, p + "mlp.c_proj.bias")

    gamma = float(np.mean(gammas))
    # The model runs with ONE pooled γ, so restate each layer's stats at
    # that γ exactly: den(γ) = den(g_i)·e^{g_i−γ} and arg(γ) = arg(g_i)
    # + (g_i − γ). (Accumulating raw per-layer-γ stats understates the
    # denominator spread by e^{|g_i−γ|}, which can push the Goldschmidt
    # input outside (0,2) on models with real γ spread.)
    den_lo, den_hi, arg_lo = np.inf, 0.0, 0.0
    for g_i, lo_i, hi_i, a_i in layer_stats:
        f = math.exp(g_i - gamma)
        den_lo = min(den_lo, lo_i * f)
        den_hi = max(den_hi, hi_i * f)
        arg_lo = min(arg_lo, a_i + (g_i - gamma))
    # exp ladder: |x| ≤ A := max(|arg_lo|, score range). Relative ladder
    # error ≈ A²/2^(r+1); the causal −1e9 fills never reach exp (masked).
    A = max(abs(arg_lo), gamma + score_max, 1.0)
    exp_r = max(2, math.ceil(math.log2(A * A / (2 * tol))))
    den_lo = max(den_lo, 1e-3)
    den_hi = den_hi * margin
    prescale = 2.0 / (den_hi + den_lo)
    rho = (den_hi - den_lo) / (den_hi + den_lo)
    if rho <= 0:
        inv_iters = 2
    else:
        inv_iters = max(2, math.ceil(math.log2(
            math.log(tol) / math.log(max(rho, 1e-12)))))
    return AttnKnobs(exp_r=int(exp_r), smax_gamma=gamma,
                     inv_prescale=float(prescale), inv_iters=int(inv_iters),
                     max_bound=float(score_max * margin))
