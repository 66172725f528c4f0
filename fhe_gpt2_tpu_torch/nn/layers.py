"""Encrypted GPT-2 layers: LayerNorm, attention, MLP, transformer block.

Semantics match the reference stack (gpt2_ckks layers.cpp + the authoritative
Python specs plain_approx/{attn,layers}.py) but the dataflow is redesigned
TPU-first around two ideas:

1. All plaintext-weight matmuls are same-stride LT diagonals with BSGS
   (nn/linear.py) instead of the reference's fold matmuls — O(√s) rotations.

2. **Diagonal-form attention**: instead of extracting per-head Q/K/V
   ciphertexts (attn_proj_row/col) and doing per-head qk/sv matmuls, scores
   are computed for ALL heads at once in "diagonal form":

       P_Δ = Q ⊙ rot(K, Δ·stride)          (aligns row r with row r+Δ)
       scores_Δ[r·st + h·dh + u] = Σ_{c'} Q[r, h·dh+c']·K[r+Δ, h·dh+c']

   i.e. ct Δ holds diagonal Δ of every head's S×S score matrix, replicated
   across each dh-wide segment. Softmax over a row then becomes a reduction
   across the Δ axis — zero rotations — and S·V is
   out = Σ_Δ attnw_Δ ⊙ rot(V, Δ·st), landing directly in the activation
   layout with no head merge. Rotation budget per attention layer drops from
   the reference's ~10^5 to ~2·seq + O(log dh) batched steps + 4 BSGS
   matmuls.

The causal mask, bias addition, and 1/√dh scaling are folded into
host-precomputed plaintext vectors.

The port's copy of ``fhe_gpt2_tpu/nn/layers.py``: numpy over the backend
protocol of ``nn/backend.py``, unchanged but for the ``layer_norm`` span of
``utils/telemetry.py``, so on the port's backends it issues the same ops in
the same order as the JAX package does on its own. Added for Granite 4.0-H
(no JAX counterpart): RMSNorm (``rms_norm``, span ``rms_norm``) and
``build_attn_plans``' score scale and optional biases, whose defaults are
GPT-2's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import kernels as K
from .formats import StridedLayout, p2, prefold_layout, blocks_matmul_specs, \
    matmul_spec
from .linear import apply_lt
from ..utils import telemetry


@dataclass(frozen=True)
class GPT2Shapes:
    slots: int
    seq: int
    hidden: int
    heads: int
    mlp_ratio: int = 4

    @property
    def dh(self) -> int:
        return self.hidden // self.heads

    @property
    def act(self) -> StridedLayout:
        return prefold_layout(self.seq, self.hidden, self.slots)

    @property
    def stride(self) -> int:
        return self.act.stride


def expand_row_vector(sh: GPT2Shapes, v: np.ndarray) -> np.ndarray:
    """Tile a length-hidden vector across every row slot (bias/gamma/beta
    layout; the reference's expand_bias, pack.py:78)."""
    return sh.act.pack(np.tile(v, (sh.seq, 1)))


@dataclass
class AttnPlans:
    q: list          # BSGS plans for W_q (one per src->dst LT; here one spec)
    k: list
    v: list
    o: list
    qb: np.ndarray   # bias vectors in act layout [n_cts, slots]
    kb: np.ndarray
    vb: np.ndarray
    ob: np.ndarray
    causal_zero: np.ndarray  # per-Δ 0/1 valid-target mask [S, n_cts, slots]
    keep_row: np.ndarray     # per-Δ in-ct row-shift keep mask [S, 1, slots]
    spill_row: np.ndarray    # per-Δ next-ct spill mask [S, 1, slots]
    seg_starts: np.ndarray   # mask selecting slot r·st + h·dh (segment starts)
    exp_r: int = 5
    inv_iters: int = 9
    smax_gamma: float = 8.0
    # Goldschmidt needs den·prescale ∈ (0,2), ideally near 1: convergence is
    # (1−d₀)^(2^iters), so d₀ ≪ 2^-iters never converges. Choose per model
    # from the expected row-sum range of exp(scores−γ).
    inv_prescale: float = 1.0
    # Real-max softmax path (compute_softmax, PolyApprox.cpp:533): sign plans
    # for the approx-max tree and the score bound it normalizes by. Scores
    # must lie in ±max_bound, and max_bound ≤ 2^exp_r (else exp diverges on
    # masked −max_bound−m arguments).
    sign: Optional[object] = None
    max_bound: float = 8.0
    # Default softmax path for block()/model forwards: "smax" (constant-γ
    # shift + Goldschmidt row normalization), "max" (real quickMax softmax),
    # or "consmax" (the reference's trained ApproxSoftmax,
    # gpt2_approx_checkpoint_2.py:37-83: exp(s−β)/γ with PER-HEAD learned
    # β/γ and a CONSTANT denominator — no fold, no inverse; the cheapest
    # path homomorphically). consmax_beta/gamma: per-head arrays [heads],
    # e.g. from calibrate.train_consmax.
    softmax_mode: str = "smax"
    consmax_beta: Optional[np.ndarray] = None
    consmax_gamma: Optional[np.ndarray] = None
    _chunks: dict = field(default_factory=dict, repr=False)

    def chunk_arrays(self, lo: int, hi: int) -> tuple:
        """Memoized per-chunk host mask slices (stable identities so the
        backend's encoding cache keys by id() across calls)."""
        key = (lo, hi, self.max_bound)
        out = self._chunks.get(key)
        if out is None:
            causal = np.ascontiguousarray(self.causal_zero[lo:hi])
            out = (np.ascontiguousarray(self.keep_row[lo:hi]),
                   np.ascontiguousarray(self.spill_row[lo:hi]),
                   causal,
                   (causal - 1.0) * self.max_bound)
            self._chunks[key] = out
        return out

    def consmax_arrays(self, sh: "GPT2Shapes", lo: int, hi: int) -> tuple:
        """Memoized ConsMax operand arrays for a Δ chunk: (−β broadcast
        [C, n_cts, slots], causal·γ⁻¹ [C, n_cts, slots]). β is per TARGET
        head, constant across Δ; γ⁻¹ is folded into the causal mask so the
        constant denominator costs zero extra ops."""
        key = ("consmax", lo, hi)
        out = self._chunks.get(key)
        if out is None:
            bneg = expand_row_vector(
                sh, -np.repeat(np.asarray(self.consmax_beta), sh.dh))
            inv_g = expand_row_vector(
                sh, np.repeat(1.0 / np.asarray(self.consmax_gamma), sh.dh))
            out = (np.ascontiguousarray(
                       np.broadcast_to(bneg, (hi - lo, *bneg.shape))),
                   np.ascontiguousarray(self.causal_zero[lo:hi] * inv_g))
            self._chunks[key] = out
        return out


@dataclass
class MlpPlans:
    fc1: list        # specs[ko][co] plans, d -> ratio·d column groups
    fc2: list        # specs[ko][co] plans, ratio·d -> d
    b1: list         # per output group bias
    b2: np.ndarray
    gelu_bound: float = 12.0
    gelu_degree: int = 62


@dataclass
class LnPlans:
    gamma_sqrt_d: np.ndarray    # gamma·√d in act layout
    beta: np.ndarray
    data_mask: np.ndarray       # 1 on data slots (col < hidden), 0 on padding
    newton_init: float = 4e7
    newton_iters: int = 8
    eps: float = 1.0            # zero-row guard added to Σz² (reference's +1)


@dataclass
class BlockPlans:
    ln1: LnPlans
    attn: AttnPlans
    ln2: LnPlans
    mlp: MlpPlans


def build_ln_plans(sh: GPT2Shapes, gamma: np.ndarray, beta: np.ndarray,
                   newton_init: float, iters: int = 8,
                   eps: float = 1.0) -> LnPlans:
    d = sh.hidden
    mask = sh.act.pack(np.ones((sh.seq, d)))
    return LnPlans(
        gamma_sqrt_d=expand_row_vector(sh, gamma * np.sqrt(d)),
        beta=expand_row_vector(sh, beta),
        data_mask=mask, newton_init=newton_init, newton_iters=iters, eps=eps)


def build_attn_plans(sh: GPT2Shapes, wq, bq, wk, bk, wv, bv, wo, bo,
                     giant: Optional[int] = None,
                     scale: Optional[float] = None) -> AttnPlans:
    """Plans of the diagonal attention. `scale` multiplies the scores
    (default 1/√dh); a bias of None is no bias (its add is left out)."""
    scale = 1.0 / np.sqrt(sh.dh) if scale is None else scale
    # Fold the 1/√dh into W_q and its bias (free).
    specs = {
        "q": matmul_spec(np.asarray(wq) * scale, sh.act, "wq"),
        "k": matmul_spec(np.asarray(wk), sh.act, "wk"),
        "v": matmul_spec(np.asarray(wv), sh.act, "wv"),
        "o": matmul_spec(np.asarray(wo), sh.act, "wo"),
    }
    plans = {k: v.bsgs_plan(giant) for k, v in specs.items()}
    # Per-Δ causal masks in diagonal form: Δ ct covers (r -> target r+Δ mod S);
    # valid iff (r+Δ) mod S <= r. Mask is per-row, replicated across columns.
    causal = np.stack([
        sh.act.pack(np.repeat(
            ((((np.arange(sh.seq) + dlt) % sh.seq) <= np.arange(sh.seq))
             )[:, None], sh.hidden, axis=1).astype(float))
        for dlt in range(sh.seq)])                     # [S, n_cts, slots]
    # Row-shift masks: Δ = cs·rpc + rr pulls row r+rr from the same ct (keep)
    # and the wrapped rows from the next ct (spill). rr=0 → keep all.
    st, rpc = sh.stride, sh.act.rows_per_ct
    keep = np.zeros((sh.seq, 1, sh.slots))
    spill = np.zeros((sh.seq, 1, sh.slots))
    for dlt in range(sh.seq):
        rr = dlt % rpc
        keep[dlt, 0, : (rpc - rr) * st] = 1.0
        if rr:
            spill[dlt, 0, (rpc - rr) * st:] = 1.0
    seg = np.zeros((sh.act.n_cts, sh.slots))
    r, h = np.meshgrid(np.arange(sh.seq), np.arange(sh.heads), indexing="ij")
    ct, sl = sh.act.place(r.ravel(), (h * sh.dh).ravel())
    seg[ct, sl] = 1.0

    def bias(b, f=1.0):
        return None if b is None else expand_row_vector(sh, np.asarray(b) * f)

    return AttnPlans(
        q=plans["q"], k=plans["k"], v=plans["v"], o=plans["o"],
        qb=bias(bq, scale), kb=bias(bk), vb=bias(bv), ob=bias(bo),
        causal_zero=causal,
        keep_row=keep, spill_row=spill, seg_starts=seg)


def build_mlp_plans(sh: GPT2Shapes, w1, b1, w2, b2,
                    giant: Optional[int] = None,
                    gelu_bound: float = 12.0, gelu_degree: int = 62) -> MlpPlans:
    d = sh.hidden
    s1 = blocks_matmul_specs(np.asarray(w1), sh.act, "fc1")
    s2 = blocks_matmul_specs(np.asarray(w2), sh.act, "fc2")
    p1 = [[s.bsgs_plan(giant) for s in row] for row in s1]
    p2_ = [[s.bsgs_plan(giant) for s in row] for row in s2]
    b1v = [expand_row_vector(sh, np.asarray(b1)[g * d:(g + 1) * d])
           for g in range(sh.mlp_ratio)]
    return MlpPlans(fc1=p1, fc2=p2_, b1=b1v,
                    b2=expand_row_vector(sh, b2),
                    gelu_bound=gelu_bound, gelu_degree=gelu_degree)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _apply_matmul(B, plans, xs, bias=None):
    out = apply_lt(B, plans, xs)
    if bias is not None:
        out = [B.add_plain(o, bias[i]) for i, o in enumerate(out)]
    return out


@telemetry.traced("layer_norm")
def layer_norm(B, xs, sh: GPT2Shapes, ln: LnPlans):
    """Per-row LayerNorm (layers.py:24-90 semantics, our folds).

    xs: list of act-layout cts. Computes z = d·x − Σx, then
    z·rsqrt(Σz²+1)·γ√d + β. Newton-seeded rsqrt, init at ln.newton_init.
    """
    d = sh.hidden
    w = sh.stride // 2
    out = []
    for i, x in enumerate(xs):
        rep = B.add(x, B.rotate(x, -w))
        sums = K.fold_sum(B, rep, w)
        z = B.sub(B.mul_const(x, float(d)), sums)
        y = B.mul_plain(B.square(z), ln.data_mask[i])
        rep2 = B.add(y, B.rotate(y, -w))
        ss = K.fold_sum(B, rep2, w)
        r = K.newton_rsqrt(B, B.add_const(ss, ln.eps), ln.newton_init,
                           ln.newton_iters)
        zn = B.mul(z, r)
        out.append(B.add_plain(B.mul_plain(zn, ln.gamma_sqrt_d[i]), ln.beta[i]))
    return out


@dataclass
class RmsPlans:
    """An RMSNorm over rows of `cols` values (Granite 4.0-H's): x·w /
    √(mean(x²) + eps), as x · rsqrt(m·(Σx² + cols·eps)) · √(m·cols) · w.
    The power of two m brings the Newton operand to at most 8, where a
    refresh can re-encode it; √(m·cols) is an exact integer multiply
    (`root`, free) times a factor of at most √2 in the weight mask."""

    weight: np.ndarray          # w·√(m·cols)/root in act layout
    newton_init: float
    newton_iters: int
    m: float = 1.0
    eps_add: float = 0.0        # cols·eps
    root: int = 1

    @property
    def need(self) -> int:
        """Levels the Newton rsqrt takes (seed 3, then 4 an iteration): its
        operand is refreshed first unless that many are left."""
        return 3 + 4 * self.newton_iters


def rms_calibration(row_sums, cols: int, eps: float) -> tuple:
    """(newton_init, m) for Σx² of the rows an RMSNorm will see (each row
    once, over `cols` values): m the power of two bringing the largest
    m·(Σx² + cols·eps) into (4, 8] (a refresh re-encodes values below
    2^8 at Δ = 2^54), and the Newton seed at 1.25 times it
    (``model.rowmax_newton_inits``' rule)."""
    v = float(np.max(np.asarray(row_sums, dtype=float))) + cols * eps
    m = 2.0 ** -math.ceil(math.log2(v / 8.0))
    return 1.25 * m * v, m


def build_rms_plans(sh, w: np.ndarray, eps: float, newton_init: float,
                    iters: int, m: float = 1.0, cols: Optional[int] = None,
                    groups: int = 1) -> RmsPlans:
    """RMSNorm plans over `cols` (default sh.hidden, a power of two) values
    a row, held as `groups` column groups of sh.hidden in act layout: the
    weight mask is [groups, n_cts, slots] (groups > 1) or [n_cts, slots]."""
    cols = cols or sh.hidden
    d = sh.hidden
    e = math.log2(m * cols)
    if e != int(e):
        raise ValueError("an RMSNorm's width and scale must be powers of two")
    root = 1 << (int(e) // 2) if e >= 0 else 1
    w = np.asarray(w, dtype=float) * (math.sqrt(m * cols) / root)
    masks = [expand_row_vector(sh, w[g * d:(g + 1) * d])
             for g in range(groups)]
    return RmsPlans(weight=np.stack(masks) if groups > 1 else masks[0],
                    newton_init=float(newton_init), newton_iters=int(iters),
                    m=float(m), eps_add=float(cols * eps), root=root)


def rms_rsqrt(B, sq, sh, rp: RmsPlans):
    """root·rsqrt(m·(Σ_row sq + cols·eps)) at every data slot of each row,
    from the squares sq of a batched act-layout value (zero outside the
    data): the row sum broadcast by ``layer_norm``'s replicate-and-fold,
    the operand refreshed unless the Newton iteration fits, then
    ``kernels.newton_rsqrt``'s steps seeded by the Taylor polynomial of
    1/√x."""
    w = sh.stride // 2
    rep = B.add(sq, B.rotate(sq, -w))
    ss = K.fold_sum(B, rep, w)
    xp = B.mul_const(B.add_const(ss, rp.eps_add), rp.m)
    xp = B.maybe_bootstrap(xp, rp.need)
    # The iterate is refreshed before a step that would reach the level
    # floor (4 levels and the floor's headroom), once, where letting the
    # floor refresh each operand on the way down would take three or more.
    need = 4 + getattr(B, "min_level_headroom", 0)
    y = K.taylor_rsqrt_seed(B, xp, rp.newton_init, shift=0.0)
    for _ in range(rp.newton_iters):
        y = K.newton_step(B, xp, B.maybe_bootstrap(y, need))
    return B.mul_const(y, float(rp.root))


@telemetry.traced("rms_norm")
def rms_norm(B, xs, sh, rp: RmsPlans):
    """RMSNorm of act-layout cts xs (zero outside the data slots), batched
    over the list."""
    x = B.stack(xs)
    r = rms_rsqrt(B, B.square(x), sh, rp)
    return B.unstack(B.mul_plain(B.mul(x, r), rp.weight))


def _row_shift_stacks(B, x, sh: GPT2Shapes):
    """All in-ct row shifts of a [n_cts]-batched value as two stacked values.

    pos[r] = rot(x, r·st) for r in [0, rpc)   (hoisted: ONE decomposition)
    neg[r] = rot(x, −(rpc−r)·st) for r in [1, rpc); slot r=0 is a dummy
    (masked to zero at assembly). Returns (Pos [rpc, n], Neg [rpc, n]).
    """
    st, rpc = sh.stride, sh.act.rows_per_ct
    pos = B.rotate_many(x, [r * st for r in range(rpc)])
    if rpc > 1:
        neg = [pos[0]] + B.rotate_many(
            x, [-(rpc - r) * st for r in range(1, rpc)])
    else:
        neg = [pos[0]]
    return B.stack(pos), B.stack(neg)


def _gather_deltas(B, ap: AttnPlans, sh: GPT2Shapes, pos, neg, n: int,
                   lo: int, hi: int):
    """Assemble the Δ-batched row shifts for Δ ∈ [lo, hi):
    out[Δ, i] = keep_Δ ⊙ pos[rr(Δ), (i+cs(Δ)) % n]
              + spill_Δ ⊙ neg[rr(Δ), (i+cs(Δ)+1) % n]."""
    rpc = sh.act.rows_per_ct
    ds = np.arange(lo, hi)
    cs, rr = np.divmod(ds, rpc)
    ct_idx = (np.arange(n)[None, :] + cs[:, None]) % n          # [C, n]
    r_idx = np.broadcast_to(rr[:, None], ct_idx.shape)
    keep, spill, _, _ = ap.chunk_arrays(lo, hi)
    a = B.take_batch(pos, (r_idx, ct_idx))
    b = B.take_batch(neg, (r_idx, (ct_idx + 1) % n))
    return B.add(B.mul_plain(a, keep), B.mul_plain(b, spill))


def _max_over_batch(B, x, size: int, sp, bound: float):
    """Approx-max tree-reduce over the leading batch axis (quickMax over Δ).

    `bound` bounds the VALUES (±bound); pairwise differences span ±2·bound,
    which is what the sign composite normalizes by (computeMax semantics,
    Fold.cpp:60-80)."""
    if size == 1:
        return B.take_batch(x, (0,))
    half = size // 2
    a = B.take_batch(x, (np.arange(half),))
    b = B.take_batch(x, (np.arange(half, 2 * half),))
    m = _max_over_batch(B, K.approx_max(B, a, b, sp, 2 * bound),
                        half, sp, bound)
    if size % 2:
        m = K.approx_max(B, m, B.take_batch(x, (size - 1,)), sp, 2 * bound)
    return m


def attention(B, xs, sh: GPT2Shapes, ap: AttnPlans,
              softmax: Optional[str] = None,
              smax_gamma: Optional[float] = None, delta_chunk: int = 0,
              kv: Optional[tuple] = None):
    """Diagonal-form multi-head attention (see module docstring), batched
    over the Δ (diagonal) axis: all per-Δ work — row shifts, Q⊙K products,
    segment folds, exp, masking, S·V accumulation — runs on the ciphertext
    batch axis as single dispatches instead of Python loops over cts.

    softmax="smax" subtracts the constant `smax_gamma` (the reference's
    ConsMax optimization, PolyApprox.cpp:595 / ApproxSoftmax). "max" is the
    reference's real softmax (compute_softmax, PolyApprox.cpp:533-593):
    masked scores → approx-max tree over Δ (quickMax) → subtract → exp →
    re-mask → sum → Goldschmidt inverse. Requires `ap.sign` plans; scores
    must lie within ±ap.max_bound.

    delta_chunk bounds how many Δ diagonals are materialized at once
    (memory control at production shapes); 0 = all S at once.

    kv: optional (k_list, v_list) of already-projected K/V activation cts —
    the KV-cache decode path (optimize.cpp / layers.cpp:44-50): the caller
    projects and cache-augments K/V itself and attention only projects Q.
    """
    softmax = softmax or ap.softmax_mode
    smax_gamma = ap.smax_gamma if smax_gamma is None else smax_gamma
    q = B.stack(_apply_matmul(B, ap.q, xs, ap.qb))
    if kv is None:
        k = B.stack(_apply_matmul(B, ap.k, xs, ap.kb))
        v = B.stack(_apply_matmul(B, ap.v, xs, ap.vb))
    else:
        k, v = B.stack(kv[0]), B.stack(kv[1])
    n = len(xs)
    S, rpc = sh.seq, sh.act.rows_per_ct
    assert n * rpc == S, "diagonal attention needs seq == n_cts·rows_per_ct"
    kpos, kneg = _row_shift_stacks(B, k, sh)
    chunk = delta_chunk or S
    bounds = [(lo, min(lo + chunk, S)) for lo in range(0, S, chunk)]

    def scores_chunk(lo, hi):
        kd = _gather_deltas(B, ap, sh, kpos, kneg, n, lo, hi)
        prod = B.mul(q, kd)
        s = K.fold_sum(B, prod, sh.dh)          # correct at segment starts
        s = B.mul_plain(s, ap.seg_starts)
        return K.replicate(B, s, 1, sh.dh)      # broadcast within segment

    exps = []          # per chunk: [C, n] batched exp(score−sub)·mask
    denom = None
    if softmax == "max":
        assert ap.sign is not None, "softmax='max' needs ap.sign plans"
        scs, m = [], None
        for lo, hi in bounds:
            _, _, causal, negfill = ap.chunk_arrays(lo, hi)
            # Invalid targets pinned to −max_bound so they never win the max.
            s = B.add_plain(B.mul_plain(scores_chunk(lo, hi), causal),
                            negfill)
            scs.append(s)
            cm = _max_over_batch(B, s, hi - lo, ap.sign, ap.max_bound)
            m = cm if m is None else K.approx_max(B, m, cm, ap.sign,
                                                  2 * ap.max_bound)
        for (lo, hi), s in zip(bounds, scs):
            _, _, causal, _ = ap.chunk_arrays(lo, hi)
            e = K.exp(B, B.sub(s, m), r=ap.exp_r)
            e = B.mul_plain(e, causal)
            exps.append(e)
            part = B.reduce_sum_batch(e, 0)
            denom = part if denom is None else B.add(denom, part)
    elif softmax == "consmax":
        # Trained ConsMax (ApproxSoftmax, gpt2_approx_checkpoint_2.py:37-83):
        # exp(s − β_head) · γ_head⁻¹ with a CONSTANT per-head denominator —
        # no row-sum fold and no Goldschmidt inverse (γ⁻¹ rides the causal
        # mask for free), saving ~inv_iters+2 multiplicative levels.
        assert ap.consmax_beta is not None and ap.consmax_gamma is not None, \
            "softmax='consmax' needs trained consmax_beta/gamma " \
            "(nn.calibrate.train_consmax)"
        for lo, hi in bounds:
            bneg, cg = ap.consmax_arrays(sh, lo, hi)
            sc = B.add_plain(scores_chunk(lo, hi), bneg)
            e = B.mul_plain(K.exp(B, sc, r=ap.exp_r), cg)
            exps.append(e)
    else:
        for lo, hi in bounds:
            _, _, causal, _ = ap.chunk_arrays(lo, hi)
            sc = B.add_const(scores_chunk(lo, hi), -smax_gamma)
            e = B.mul_plain(K.exp(B, sc, r=ap.exp_r), causal)
            exps.append(e)
            part = B.reduce_sum_batch(e, 0)
            denom = part if denom is None else B.add(denom, part)

    inv = None
    if denom is not None:
        inv = K.goldschmidt_inverse(
            B, B.add_const(B.mul_const(denom, 0.0), ap.inv_prescale),
            B.mul_const(denom, ap.inv_prescale), ap.inv_iters)

    # S·V: out = Σ_Δ (e_Δ ⊙ inv) ⊙ rot(V, Δ·st), reduced over the Δ axis.
    vpos, vneg = _row_shift_stacks(B, v, sh)
    out = None
    for (lo, hi), e in zip(bounds, exps):
        vd = _gather_deltas(B, ap, sh, vpos, vneg, n, lo, hi)
        w_ = e if inv is None else B.mul(e, inv)
        part = B.reduce_sum_batch(B.mul(w_, vd), 0)
        out = part if out is None else B.add(out, part)

    return _apply_matmul(B, ap.o, B.unstack(out), ap.ob)


def mlp(B, xs, sh: GPT2Shapes, mp: MlpPlans):
    """FeedForward: d → ratio·d (column groups) → GELU → d (layers.cpp:3)."""
    groups = []
    for co in range(sh.mlp_ratio):
        acc = None
        for ko in range(len(mp.fc1)):
            y = apply_lt(B, mp.fc1[ko][co], xs)
            acc = y if acc is None else [B.add(a, b) for a, b in zip(acc, y)]
        acc = [B.add_plain(a, mp.b1[co][i]) for i, a in enumerate(acc)]
        acc = [K.gelu(B, a, mp.gelu_bound, mp.gelu_degree) for a in acc]
        groups.append(acc)
    out = None
    for ko in range(sh.mlp_ratio):
        y = apply_lt(B, mp.fc2[ko][0], groups[ko])
        out = y if out is None else [B.add(a, b) for a, b in zip(out, y)]
    return [B.add_plain(o, mp.b2[i]) for i, o in enumerate(out)]


def block(B, xs, sh: GPT2Shapes, bp: BlockPlans):
    """One transformer block: LN → attn → residual → LN → MLP → residual."""
    h = layer_norm(B, xs, sh, bp.ln1)
    a = attention(B, h, sh, bp.attn)
    xs = [B.add(x, y) for x, y in zip(xs, a)]
    h = layer_norm(B, xs, sh, bp.ln2)
    m = mlp(B, h, sh, bp.mlp)
    return [B.add(x, y) for x, y in zip(xs, m)]
