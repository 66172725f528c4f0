"""Encrypted Granite 4.0-H (HF ``granitemoehybrid``, dense): plans from an
HF-format state dict, synthetic weights, the eager forward over
``layer_types`` with both layer kinds.

A layer is ``x + r·mixer(RMSNorm(x))`` then ``h + r·MLP(RMSNorm(h))``
(r = ``residual_multiplier``, folded into out_proj, o_proj and
output_linear). The mixer is a Mamba-2 layer (in_proj, the core of
``nn/mamba.py``, out_proj) or grouped-query attention (``layers.attention``
with the score scale ``attention_multiplier``, no biases, each K/V head's
weights repeated for the query heads it serves); the MLP is SwiGLU. Every
projection is an LT over column groups of the activation layout
(``formats.prefold_layout(seq, hidden)``); in_proj's outputs land in the
core's groups (``mamba.pack_core_inputs``' layout: z, x, B, C, and dt
repeated over each head's columns), so no repacking runs on ciphertexts.

The embedding (× ``embedding_multiplier``) and the tied logits
(÷ ``logits_scaling``) run on the host. The Newton seeds of the RMSNorms,
the gated norm's lift and the attention knobs are calibrated on the float
forward of ``reference/granite.py`` over the served tokens, as GPT-2's
``rowmax`` seeds are. Refreshes are the backend's: a Mamba mixer's input
is refreshed before in_proj (its core takes most of the chain, and
in_proj's outputs are twice as many ciphertexts), an attention's and an
MLP's when fewer levels are left than they take, the rest where the level
floor asks.

The projections of a layer at published widths hold 16,380 diagonal masks
per 2048 × 2048 block: ``BlockMatmul`` builds each block's plan when it
runs and releases its masks after.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import kernels as K
from . import layers as L
from . import mamba as Mb
from .calibrate import fit_consmax_gamma
from .formats import matmul_spec
from .linear import apply_lt
from ..utils import telemetry

# The catalog's granite-4.0-h-micro (HF ibm-granite/granite-4.0-h-micro,
# config.json): the keys the forward reads.
PUBLISHED = {
    "hidden_size": 2048, "num_hidden_layers": 40,
    "layer_types": (["mamba"] * 5 + ["attention"]
                    + (["mamba"] * 9 + ["attention"]) * 3 + ["mamba"] * 4),
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "attention_multiplier": 0.015625, "intermediate_size": 8192,
    "shared_intermediate_size": 8192, "mamba_n_heads": 64,
    "mamba_d_head": 64, "mamba_d_state": 128, "mamba_n_groups": 1,
    "mamba_d_conv": 4, "mamba_expand": 2, "rms_norm_eps": 1e-5,
    "residual_multiplier": 0.22, "embedding_multiplier": 12,
    "logits_scaling": 8, "vocab_size": 100352,
}
INIT_STD = 0.02           # the config's initializer_range
# Newton iterations of every RMSNorm: the gated norm's rows span a ratio
# near 2000 at published widths, and 13 steps from a seed at 1.25 times
# the largest reach 1e-12 relative on the smallest.
NEWTON_ITERS = 13


def small_config(hidden: int, layers: int, vocab: int = 997) -> dict:
    """The published configuration scaled to width `hidden` for the CPU:
    heads of hidden/32 columns (at least 8; 32 query heads over 8 K/V
    heads and 64 Mamba-2 heads at 2048), the MLP and the state scaled by
    hidden/2048 (the state at least 8), the score scale 1/head width, and
    the first `layers` layers of the published ``layer_types``."""
    f = hidden / PUBLISHED["hidden_size"]
    hd = max(8, hidden // 32)
    cfg = dict(PUBLISHED)
    cfg.update(hidden_size=hidden, num_hidden_layers=layers,
               layer_types=PUBLISHED["layer_types"][:layers],
               num_attention_heads=hidden // hd,
               num_key_value_heads=max(1, hidden // hd // 4),
               intermediate_size=int(8192 * f),
               shared_intermediate_size=int(8192 * f),
               mamba_n_heads=2 * hidden // hd, mamba_d_head=hd,
               mamba_d_state=max(8, int(128 * f)), vocab_size=vocab,
               attention_multiplier=1.0 / hd)
    return cfg


def synthetic_weights(rng, cfg: dict, layers=None) -> dict:
    """An HF-format state dict (``GraniteMoeHybridModel``'s keys, numpy
    float64, linear weights [out, in]) drawn from the numpy generator rng:
    linear weights and embeddings N(0, 0.02); conv weights and biases
    U(±0.5) (PyTorch's Conv1d init at 4 taps); A_log = log(1..heads), D = 1,
    dt_bias = 1 (the model's own init); every RMSNorm weight U(0.8, 1.2), so
    each norm mask carries data. `layers` (default all) limits the layers
    drawn."""
    d = cfg["hidden_size"]
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    N = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    inner, kc = H * P, cfg["mamba_d_conv"]
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // Hq
    I = cfg["shared_intermediate_size"]

    def normal(*shape):
        return rng.normal(0.0, INIT_STD, shape)

    def norm(n):
        return rng.uniform(0.8, 1.2, n)

    w = {"embed_tokens.weight": normal(cfg["vocab_size"], d)}
    for i in (range(cfg["num_hidden_layers"]) if layers is None else layers):
        p = f"layers.{i}."
        w[p + "input_layernorm.weight"] = norm(d)
        if cfg["layer_types"][i] == "mamba":
            m = p + "mamba."
            w[m + "in_proj.weight"] = normal(2 * inner + 2 * N + H, d)
            w[m + "conv1d.weight"] = rng.uniform(-0.5, 0.5,
                                                 (inner + 2 * N, 1, kc))
            w[m + "conv1d.bias"] = rng.uniform(-0.5, 0.5, inner + 2 * N)
            w[m + "dt_bias"] = np.ones(H)
            w[m + "A_log"] = np.log(np.arange(1, H + 1, dtype=float))
            w[m + "D"] = np.ones(H)
            w[m + "norm.weight"] = norm(inner)
            w[m + "out_proj.weight"] = normal(d, inner)
        else:
            a = p + "self_attn."
            w[a + "q_proj.weight"] = normal(Hq * dh, d)
            w[a + "k_proj.weight"] = normal(Hkv * dh, d)
            w[a + "v_proj.weight"] = normal(Hkv * dh, d)
            w[a + "o_proj.weight"] = normal(d, Hq * dh)
        w[p + "post_attention_layernorm.weight"] = norm(d)
        w[p + "shared_mlp.input_linear.weight"] = normal(2 * I, d)
        w[p + "shared_mlp.output_linear.weight"] = normal(d, I)
    w["norm.weight"] = norm(d)
    return w


def get(w: dict, name: str) -> np.ndarray:
    """Weight `name` (without ``model.``) as a float64 numpy array."""
    for k in (name, "model." + name):
        if k in w:
            v = w[k]
            v = v.detach().cpu().numpy() if hasattr(v, "detach") else v
            return np.asarray(v, dtype=np.float64)
    raise KeyError(name)


def mamba_shapes(cfg: dict, slots: int, seq: int) -> Mb.MambaShapes:
    return Mb.MambaShapes(
        slots=slots, seq=seq, hidden=cfg["hidden_size"],
        heads=cfg["mamba_n_heads"], head_dim=cfg["mamba_d_head"],
        state=cfg["mamba_n_groups"] * cfg["mamba_d_state"],
        conv=cfg["mamba_d_conv"])


def attn_shapes(cfg: dict, slots: int, seq: int) -> L.GPT2Shapes:
    return L.GPT2Shapes(slots=slots, seq=seq, hidden=cfg["hidden_size"],
                        heads=cfg["num_attention_heads"])


# ---------------------------------------------------------------------------
# Projections over column groups
# ---------------------------------------------------------------------------

class BlockMatmul:
    """x @ W for W [groups_in·d, groups_out·d] over column groups of d =
    layout.cols in the act layout: block (ko, co) is one LT plan
    (``formats.matmul_spec``), built when it runs, its masks released from
    the backend's cache after it. A 2048 × 2048 block holds 16,380
    diagonal masks, and a Mamba-2 layer's projections 22 blocks: kept,
    they would not fit the card beside the mixer's values."""

    def __init__(self, W: np.ndarray, layout, name: str):
        d = layout.cols
        if W.shape[0] % d or W.shape[1] % d:
            raise ValueError(f"{name}: {W.shape} is not in blocks of {d}")
        self.W, self.layout, self.name = W, layout, name
        self.k_in, self.k_out = W.shape[0] // d, W.shape[1] // d

    def plan(self, ko: int, co: int):
        d = self.layout.cols
        blk = self.W[ko * d:(ko + 1) * d, co * d:(co + 1) * d]
        return matmul_spec(blk, self.layout,
                           f"{self.name}[{ko},{co}]").bsgs_plan()

    def apply(self, B, groups: list) -> list:
        """groups[ko]: the n cts of input group ko; returns the output
        groups' cts, summed over the input groups (an all-zero block has
        no diagonal and is left out)."""
        d = self.layout.cols
        release = getattr(B, "release_masks", None)
        out = []
        for co in range(self.k_out):
            acc = None
            for ko in range(self.k_in):
                if not self.W[ko * d:(ko + 1) * d, co * d:(co + 1) * d].any():
                    continue
                p = self.plan(ko, co)
                y = apply_lt(B, p, groups[ko])
                if release is not None:
                    release(p.masks())
                acc = y if acc is None else [B.add(a, b)
                                             for a, b in zip(acc, y)]
            out.append(acc)
        return out


def in_proj_columns(cfg: dict, w_in: np.ndarray) -> np.ndarray:
    """in_proj's weight [2·inner + 2N + heads, hidden] as x @ W with the
    output columns in the core's eight groups of hidden: z (2), x (2),
    B and C (zero past N), dt repeated over each head's columns (2)."""
    d = cfg["hidden_size"]
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    N = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    inner = H * P
    Wt = np.asarray(w_in).T                         # [hidden, outputs]
    out = np.zeros((d, 8 * d))
    out[:, :2 * d] = Wt[:, :inner]
    out[:, 2 * d:4 * d] = Wt[:, inner:2 * inner]
    out[:, 4 * d:4 * d + N] = Wt[:, 2 * inner:2 * inner + N]
    out[:, 5 * d:5 * d + N] = Wt[:, 2 * inner + N:2 * inner + 2 * N]
    out[:, 6 * d:] = np.repeat(Wt[:, 2 * inner + 2 * N:], P, axis=1)
    return out


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

@dataclass
class GraniteLayerPlans:
    kind: str                           # "mamba" or "attention"
    ln1: L.RmsPlans
    ln2: L.RmsPlans
    mlp_in: BlockMatmul                 # [g | v] groups
    mlp_out: BlockMatmul                # × residual_multiplier
    in_proj: Optional[BlockMatmul] = None
    core: Optional[Mb.MambaPlans] = None
    out_proj: Optional[BlockMatmul] = None   # × residual_multiplier
    attn: Optional[L.AttnPlans] = None
    mlp_need: int = 0
    attn_need: int = 0


@dataclass
class GranitePlans:
    cfg: dict
    sh: Mb.MambaShapes
    ash: L.GPT2Shapes
    layers: list
    norm: L.RmsPlans
    silu_degree: int = 56


@dataclass
class Calibration:
    """What the plans take from the float forward over the served tokens:
    per layer the rows' Σx² at each RMSNorm's input, the gated norm's
    (Mamba layers) and the attention scores [heads, S, S] (attention
    layers); the final norm's rows."""

    ln1: list
    ln2: list
    gate: list
    scores: list
    final: np.ndarray


def check_act_domain(name: str, *values) -> None:
    """Raise ValueError where a SiLU or softplus input of the float forward
    leaves ±``kernels.ACT_BOUND``, the interval their polynomials are
    fitted on: outside it the fits' error grows fast, and nothing on the
    encrypted side shows it."""
    top = max(float(np.abs(np.asarray(v)).max()) for v in values)
    if top > K.ACT_BOUND:
        raise ValueError(f"{name}: a SiLU or softplus input reaches {top:.3g},"
                         f" outside the fits' ±{K.ACT_BOUND}")


def core_act_inputs(z, xbc, dt_raw, p: dict) -> tuple:
    """The mixer core's SiLU and softplus inputs in float64 from in_proj's
    outputs: z (the gate), the causal conv's output, dt_raw + dt_bias."""
    from ..reference import granite as R
    return (np.asarray(z),
            R.causal_conv(xbc, p["conv1d.weight"], p["conv1d.bias"]).numpy(),
            np.asarray(dt_raw) + np.asarray(p["dt_bias"]))


def calibrate(w: dict, cfg: dict, x: np.ndarray, layers=None) -> Calibration:
    """The float forward of ``reference/granite.py`` over the embedded
    input x [S, hidden] through `layers` (default all), recording what the
    plans calibrate on; every SiLU and softplus input is held to
    ``check_act_domain``."""
    import torch

    from ..reference import granite as R

    x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    eps = cfg["rms_norm_eps"]
    out = Calibration([], [], [], [], None)
    todo = range(cfg["num_hidden_layers"]) if layers is None else layers
    for i in todo:
        p = f"layers.{i}."
        out.ln1.append((x * x).sum(-1).numpy())
        u = R.rms_norm(x, R.weight(w, p + "input_layernorm.weight"), eps)
        if cfg["layer_types"][i] == "mamba":
            m = p + "mamba."
            pm = {k: R.weight(w, m + k) for k in (
                "conv1d.weight", "conv1d.bias", "dt_bias", "A_log", "D",
                "norm.weight")}
            proj = u @ R.weight(w, m + "in_proj.weight").T
            core_in = [t.numpy() for t in R.split_in_proj(proj, cfg)]
            check_act_domain(f"layer {i}'s mixer",
                             *core_act_inputs(*core_in, pm))
            v = R.gated_norm_input(*core_in, pm, cfg)
            out.gate.append((v * v).sum(-1).numpy())
            out.scores.append(None)
        else:
            out.gate.append(None)
            out.scores.append(attention_scores(w, i, cfg, u.numpy()))
        h = R.mixer_sublayer(x, w, i, cfg)
        out.ln2.append((h * h).sum(-1).numpy())
        u = R.rms_norm(h, R.weight(w, p + "post_attention_layernorm.weight"),
                       eps)
        gv = u @ R.weight(w, p + "shared_mlp.input_linear.weight").T
        check_act_domain(f"layer {i}'s MLP", gv.chunk(2, dim=-1)[0].numpy())
        x = R.mlp_sublayer(h, w, i, cfg)
    out.final = (x * x).sum(-1).numpy()
    return out


def attention_scores(w: dict, i: int, cfg: dict, u: np.ndarray) -> np.ndarray:
    """Layer i's scores q·k·attention_multiplier [heads, S, S] over its
    normalized input u (each K head repeated for its query heads)."""
    p = f"layers.{i}.self_attn."
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg["hidden_size"] // Hq
    S = u.shape[0]
    q = (u @ get(w, p + "q_proj.weight").T).reshape(S, Hq, dh)
    k = (u @ get(w, p + "k_proj.weight").T).reshape(S, Hkv, dh)
    k = np.repeat(k, Hq // Hkv, axis=1)
    return np.einsum("thd,shd->hts", q, k) * cfg["attention_multiplier"]


def attn_knobs(scores: np.ndarray) -> dict:
    """The smax knobs of ``calibrate.calibrate_attn_knobs`` for one layer's
    scores [heads, S, S] at its tolerance 1e-3 and margin 1.25: the
    ConsMax shift γ, the exp ladder r (at most 8 squarings: each squares
    the scale's offset from the chain's primes, ``kernels.exp_scaled``),
    the Goldschmidt prescale and iterations."""
    tol, margin = 1e-3, 1.25
    S = scores.shape[-1]
    causal = np.tril(np.ones((S, S))) > 0
    gamma = fit_consmax_gamma(np.where(causal, scores, -1e9).reshape(-1, S))
    e = np.exp(np.clip(scores - gamma, -60, 30)) * causal
    den = e.sum(-1)
    arg_lo = float((scores[:, causal] - gamma).min(initial=0.0))
    A = max(abs(arg_lo), gamma + float(np.abs(scores[:, causal]).max()), 1.0)
    exp_r = min(8, max(2, math.ceil(math.log2(A * A / (2 * tol)))))
    den_lo, den_hi = max(float(den.min()), 1e-3), float(den.max()) * margin
    rho = (den_hi - den_lo) / (den_hi + den_lo)
    inv_iters = max(2, math.ceil(math.log2(
        math.log(tol) / math.log(max(rho, 1e-12))))) if rho > 0 else 2
    return dict(exp_r=int(exp_r), smax_gamma=float(gamma),
                inv_prescale=2.0 / (den_hi + den_lo),
                inv_iters=int(inv_iters))


def _rms(sh, w, rows, cfg):
    eps = cfg["rms_norm_eps"]
    init, m = L.rms_calibration(rows, sh.hidden, eps)
    return L.build_rms_plans(sh, w, eps, init, NEWTON_ITERS, m=m)


def build_core_plans(sh: Mb.MambaShapes, w: dict, i: int, cfg: dict,
                     gate_rows, silu_degree: int = 56,
                     softplus_degree: int = 48) -> Mb.MambaPlans:
    """Layer i's mixer-core plans, its gated norm calibrated on the rows'
    Σv² (``Calibration.gate``)."""
    m = f"layers.{i}.mamba."
    p = {k: get(w, m + k) for k in ("conv1d.weight", "conv1d.bias",
                                    "dt_bias", "A_log", "D", "norm.weight")}
    eps = cfg["rms_norm_eps"]
    init, m = L.rms_calibration(gate_rows, sh.inner, eps)
    return Mb.build_mamba_plans(sh, p, init, m, NEWTON_ITERS, eps,
                                silu_degree=silu_degree,
                                softplus_degree=softplus_degree)


def build_granite_plans(cfg: dict, w: dict, slots: int, seq: int,
                        cal: Calibration, layers=None, silu_degree: int = 56,
                        softplus_degree: int = 48) -> GranitePlans:
    """Plans of `layers` (default all) from the HF-format state dict w and
    the float forward's calibration (``calibrate`` over the same layers)."""
    sh, ash = mamba_shapes(cfg, slots, seq), attn_shapes(cfg, slots, seq)
    d, r = cfg["hidden_size"], cfg["residual_multiplier"]
    todo = list(range(cfg["num_hidden_layers"]) if layers is None
                else layers)
    # in_proj's input is refreshed always, the MLP's and the attention's
    # when fewer levels are left than they take.
    mlp_need = 3 + _plan_depth(K.silu_even_plan(K.ACT_BOUND, silu_degree))
    out = []
    for j, i in enumerate(todo):
        p = f"layers.{i}."
        kind = cfg["layer_types"][i]
        I = cfg["shared_intermediate_size"]
        w_mlp = get(w, p + "shared_mlp.input_linear.weight").T  # [d, 2I]
        lp = GraniteLayerPlans(
            kind=kind,
            ln1=_rms(sh, get(w, p + "input_layernorm.weight"), cal.ln1[j],
                     cfg),
            ln2=_rms(sh, get(w, p + "post_attention_layernorm.weight"),
                     cal.ln2[j], cfg),
            mlp_in=BlockMatmul(w_mlp, sh.act, f"l{i}.mlp_in"),
            mlp_out=BlockMatmul(
                r * get(w, p + "shared_mlp.output_linear.weight").T,
                sh.act, f"l{i}.mlp_out"),
            mlp_need=mlp_need)
        assert I % d == 0
        if kind == "mamba":
            m = p + "mamba."
            lp.in_proj = BlockMatmul(in_proj_columns(cfg, get(
                w, m + "in_proj.weight")), sh.act, f"l{i}.in_proj")
            lp.core = build_core_plans(sh, w, i, cfg, cal.gate[j],
                                       silu_degree, softplus_degree)
            lp.out_proj = BlockMatmul(r * get(w, m + "out_proj.weight").T,
                                      sh.act, f"l{i}.out_proj")
        else:
            a = p + "self_attn."
            Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
            dh = d // Hq
            rep = (np.arange(Hq) // (Hq // Hkv))[:, None] * dh \
                + np.arange(dh)[None, :]

            def kv(name):
                return get(w, a + name).T[:, rep.ravel()]

            lp.attn = L.build_attn_plans(
                ash, get(w, a + "q_proj.weight").T, None, kv("k_proj.weight"),
                None, kv("v_proj.weight"), None,
                r * get(w, a + "o_proj.weight").T, None,
                scale=cfg["attention_multiplier"])
            for k_, v_ in attn_knobs(cal.scores[j]).items():
                setattr(lp.attn, k_, v_)
            # Projection, gather, q·k, segment mask, exp ladder, causal
            # mask, Goldschmidt, the normalization, ·v, o_proj.
            lp.attn_need = (lp.attn.exp_r + 2 * lp.attn.inv_iters + 8)
        out.append(lp)
    norm = _rms(sh, get(w, "norm.weight"), cal.final, cfg)
    return GranitePlans(cfg=cfg, sh=sh, ash=ash, layers=out, norm=norm,
                        silu_degree=silu_degree)


def _plan_depth(plan) -> int:
    from ..approx.chebeval import eval_plan
    from ..approx.minimax import _CostBackend
    return int(eval_plan(_CostBackend(), plan, 0))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def core_input_level(B) -> int:
    """The level the mixer core's inputs arrive at: the mixer refreshes
    its in_proj input to the chain top (``mamba_mixer``), and in_proj
    takes one level."""
    return B.default_level - B.ctx.rescale_limbs


def split_core_inputs(B, groups: list) -> tuple:
    """in_proj's eight output groups (lists of n cts) as the core's batched
    values: z [2, n], xBC [4, n], dt [2, n]."""
    v = [B.stack(g) for g in groups]
    return B.stack(v[0:2]), B.stack(v[2:6]), B.stack(v[6:8])


def mamba_mixer(B, h: list, gp: GranitePlans, lp: GraniteLayerPlans) -> list:
    """out_proj(core(in_proj(h))) × r on normalized act-layout cts h."""
    sh = gp.sh
    h = [B.bootstrap(x) for x in h]           # to the chain top
    z, xbc, dt = split_core_inputs(B, lp.in_proj.apply(B, [h]))
    core = Mb.mixer_core(B, z, xbc, dt, sh, lp.core)
    groups = [B.unstack(B.take_batch(core, (g,))) for g in range(2)]
    return lp.out_proj.apply(B, groups)[0]


@telemetry.traced("swiglu")
def swiglu(B, h: list, gp: GranitePlans, lp: GraniteLayerPlans) -> list:
    """output_linear(SiLU(g) ⊙ v) × r, [g | v] = input_linear(h)."""
    h = [B.maybe_bootstrap(x, lp.mlp_need) for x in h]
    gv = lp.mlp_in.apply(B, [h])
    half = len(gv) // 2
    g = B.stack([B.stack(c) for c in gv[:half]])
    v = B.stack([B.stack(c) for c in gv[half:]])
    a = B.mul(K.silu(B, g, degree=gp.silu_degree), v)
    groups = [B.unstack(B.take_batch(a, (j,))) for j in range(half)]
    return lp.mlp_out.apply(B, groups)[0]


def mixer_sublayer(B, xs: list, gp: GranitePlans,
                   lp: GraniteLayerPlans) -> list:
    """x + r·mixer(RMSNorm(x)) on act-layout cts xs, the mixer of the
    layer's kind."""
    h = L.rms_norm(B, xs, gp.sh, lp.ln1)
    if lp.kind == "mamba":
        m = mamba_mixer(B, h, gp, lp)
    else:
        h = [B.maybe_bootstrap(x, lp.attn_need) for x in h]
        m = L.attention(B, h, gp.ash, lp.attn)
    return [B.add(x, y) for x, y in zip(xs, m)]


def mlp_sublayer(B, xs: list, gp: GranitePlans,
                 lp: GraniteLayerPlans) -> list:
    """h + r·SwiGLU(RMSNorm(h))."""
    m = swiglu(B, L.rms_norm(B, xs, gp.sh, lp.ln2), gp, lp)
    return [B.add(x, y) for x, y in zip(xs, m)]


def layer(B, xs: list, gp: GranitePlans, lp: GraniteLayerPlans) -> list:
    """One decoder layer on act-layout cts xs."""
    return mlp_sublayer(B, mixer_sublayer(B, xs, gp, lp), gp, lp)


def forward(B, xs: list, gp: GranitePlans) -> list:
    """Every planned layer, then the final RMSNorm."""
    for lp in gp.layers:
        xs = layer(B, xs, gp, lp)
    return L.rms_norm(B, xs, gp.sh, gp.norm)
