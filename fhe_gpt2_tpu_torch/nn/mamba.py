"""Encrypted Mamba-2 mixer core (Granite 4.0-H): causal conv, softplus
step, decay products, the diagonal-form SSD sum, the gated RMSNorm.

The core runs from in_proj's outputs to out_proj's input, on the
activation layout of ``nn/layers.py`` (rows of ``hidden`` values at a
stride of 2·p2(hidden)). The mixer's inner width (2·hidden) is held as two
column groups of ``hidden``; B and C (``state`` values each) as one group
each, zero past ``state``; dt as two groups with each head's value
repeated over its ``head_dim`` columns (in_proj's weights make that
layout for free). Values are batched ciphertexts: z and dt [2, n], xBC
[4, n] (x's two groups, B, C), n the act layout's ciphertexts.

It is written like ``layers.attention`` in diagonal form: Δ ∈ [0, S)
pairs row r with row s = (r + Δ) mod S, valid where s ≤ r, through the
same row shifts (``_row_shift_stacks``: one hoisted rotation set; a
gather of Δ-batched shifts, masked). Per request:

* conv: out[t] = b + Σ_k w_k ⊙ xBC[t − k], the shifts k ≥ 1 gathered with
  masks that carry the taps and zero rows before token 0; then SiLU.
* decay: dt = softplus(dt_raw + dt_bias), a = A·dt·2^-r (A = −exp(A_log)
  per head, the 2^-r of ``exp_scaled`` folded into the mask), the prefix
  sums cs[r] = Σ_{s≤r} a[s] as one causal gather summed over Δ, then per Δ
  diff = cs[r] − cs[s] (masked to 0 where invalid) and
  L = exp_scaled(diff): Π_{q=s+1..r} exp(A·dt[q]).
* scan: G_Δ = C[r]·B[s] (the product folded over the state and broadcast
  over the row), y = Σ_Δ G_Δ ⊙ L_Δ ⊙ (dt ⊙ x)[s] + D ⊙ x.
* gate_norm: v = y ⊙ SiLU(z), RMSNorm over both groups (``layers.rms_rsqrt``
  on the summed squares) times the norm weight.

Each phase is a span of ``utils/telemetry.py`` (``mamba.conv``,
``mamba.decay``, ``mamba.scan``, ``mamba.gate_norm``); the counter
``mamba.deltas`` counts the Δ diagonals the SSD sum adds. Every mask is an
array of the plans, so the backend's cache holds it across requests.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import kernels as K
from . import layers as L
from .formats import StridedLayout, prefold_layout
from ..utils import telemetry


@dataclass(frozen=True)
class MambaShapes:
    """A Mamba-2 layer's widths on a ring of `slots` slots: `hidden` wide
    rows, `heads` heads of `head_dim` (heads·head_dim = 2·hidden), B and C
    of `state` values (one group), a conv of `conv` taps."""

    slots: int
    seq: int
    hidden: int
    heads: int
    head_dim: int
    state: int
    conv: int = 4

    def __post_init__(self):
        if self.heads * self.head_dim != 2 * self.hidden:
            raise ValueError("heads·head_dim must be 2·hidden")
        if self.state > self.hidden or self.conv > self.seq:
            raise ValueError("state ≤ hidden and conv ≤ seq")

    @property
    def inner(self) -> int:
        return self.heads * self.head_dim

    @property
    def act(self) -> StridedLayout:
        return prefold_layout(self.seq, self.hidden, self.slots)

    @property
    def stride(self) -> int:
        return self.act.stride

    @property
    def n(self) -> int:
        return self.act.n_cts

    # Column groups (offset into the tensor, width) of the core's values.
    @property
    def z_groups(self) -> tuple:
        d = self.hidden
        return ((0, d), (d, d))

    @property
    def xbc_groups(self) -> tuple:
        d, N = self.hidden, self.state
        return ((0, d), (d, d), (2 * d, N), (2 * d + N, N))


def pack_groups(sh: MambaShapes, M: np.ndarray, groups) -> np.ndarray:
    """[S, ·] rows as column groups in act layout: [len(groups), n, slots],
    zero outside each group's width."""
    out = []
    for off, width in groups:
        A = np.zeros((sh.seq, sh.hidden))
        A[:, :width] = np.asarray(M)[:, off:off + width]
        out.append(sh.act.pack(A))
    return np.stack(out)


def unpack_groups(sh: MambaShapes, v: np.ndarray, groups) -> np.ndarray:
    """The inverse of ``pack_groups``: [S, Σ widths]."""
    return np.concatenate([sh.act.unpack(v[g])[:, :width]
                           for g, (_, width) in enumerate(groups)], axis=1)


def pack_core_inputs(sh: MambaShapes, z, xbc, dt_raw) -> tuple:
    """The core's inputs as slot arrays: (z [2, n, slots], xBC [4, n,
    slots], dt [2, n, slots] with each head's dt_raw over its columns)."""
    dt = np.repeat(np.asarray(dt_raw), sh.head_dim, axis=1)
    return (pack_groups(sh, z, sh.z_groups),
            pack_groups(sh, xbc, sh.xbc_groups),
            pack_groups(sh, dt, sh.z_groups))


def encrypt_groups(B, arr: np.ndarray, level=None):
    """[G, n, slots] slot arrays as one value batched [G, n]."""
    return B.stack([B.from_slots(a, level) if level else B.from_slots(a)
                    for a in arr])


@dataclass
class MambaPlans:
    """The core's masks, index arrays and knobs (``build_mamba_plans``).
    Index arrays are (stack entry, group, ct) triples over batch axes."""

    conv_w0: np.ndarray       # [4, n, slots]: the tap on token t
    conv_keep: np.ndarray     # [conv−1, 4, n, slots]: taps on t−k, in-ct
    conv_spill: np.ndarray    # [conv−1, 4, n, slots]: taps on t−k, next ct
    conv_b: np.ndarray        # [4, n, slots]
    dt_bias: np.ndarray       # [2, n, slots]
    a_mask: np.ndarray        # A·2^-r on each head's columns [2, n, slots]
    d_mask: np.ndarray        # D over each head's columns [2, n, slots]
    keep: np.ndarray          # per Δ: in-ct shift ⊙ causal [S, 1, n, slots]
    spill: np.ndarray         # per Δ: next-ct row shift ⊙ causal
    causal: np.ndarray        # per Δ: valid data slots [S, 1, n, slots]
    norm: L.RmsPlans          # the gated RMSNorm over both groups
    exp_r: int                # exp_scaled's squarings
    idx: dict                 # index arrays by use (``_indices``)
    silu_degree: int = 56
    softplus_degree: int = 48


def _indices(sh: MambaShapes) -> dict:
    """The index arrays of the core's gathers: ``conv`` [conv−1, 4, n] (the
    shifts k ≥ 1 of xBC), ``shift2``/``shift1`` [S, G, n] (every Δ of a
    2- or 1-group value), ``here2`` [S, 2, n] (the unshifted entry over
    Δ), ``c`` [S, 1, n] (xBC's group 3, C, over Δ; groups and cts only)
    and ``g2`` [S, 2, n] (a [S, 1, n] value over both groups)."""
    S, n = sh.seq, sh.n

    def grid(*arrays):
        shape = np.broadcast_shapes(*(a.shape for a in arrays))
        return tuple(np.broadcast_to(a, shape).astype(np.int64).copy()
                     for a in arrays)

    d = np.arange(S)[:, None, None]
    g2 = np.arange(2)[None, :, None]
    ct = np.arange(n)[None, None, :]
    zero = np.zeros((1, 1, 1), np.int64)
    return {
        "conv": _shift_index(sh, S - np.arange(1, sh.conv), 4),
        "shift2": _shift_index(sh, np.arange(S), 2),
        "shift1": _shift_index(sh, np.arange(S), 1),
        "here2": grid(zero + 0 * d, g2, ct),
        "c": grid(np.full((S, 1, 1), 3), ct),
        "g2": grid(d, zero + 0 * g2, ct),
    }


def _shift_index(sh: MambaShapes, deltas: np.ndarray, groups: int) -> tuple:
    """(rows, groups, cts, next cts) [len(deltas), groups, n]: row r of ct
    i comes from stack entry rr(Δ) of ct (i + cs(Δ)) % n, or of the next
    ct (``_gather_deltas``)."""
    rpc, n = sh.act.rows_per_ct, sh.n
    cs, rr = np.divmod(np.asarray(deltas), rpc)
    shape = (len(deltas), groups, n)
    ct = (np.arange(n)[None, None, :] + cs[:, None, None]) % n
    ct = np.broadcast_to(ct, shape).copy()
    return (np.broadcast_to(rr[:, None, None], shape).copy(),
            np.broadcast_to(np.arange(groups)[None, :, None], shape).copy(),
            ct, (ct + 1) % n)


def _rows_cols(sh: MambaShapes):
    """(row index, column, data) of every slot of each act ct: [n, slots]."""
    st, rpc = sh.stride, sh.act.rows_per_ct
    slot = np.arange(sh.slots)
    r = np.arange(sh.n)[:, None] * rpc + slot[None, :] // st
    c = np.broadcast_to(slot[None, :] % st, r.shape)
    return r, c, (r < sh.seq) & (c < sh.hidden)


def _shift_masks(sh: MambaShapes, delta: int) -> tuple:
    """(keep, spill) [n, slots] of the row shift by Δ (``build_attn_plans``'
    row-shift masks), times the Δ's causal validity on data slots."""
    st, rpc = sh.stride, sh.act.rows_per_ct
    r, _, data = _rows_cols(sh)
    valid = data & (((r + delta) % sh.seq) <= r)
    rr = delta % rpc
    slot = np.arange(sh.slots)[None, :]
    keep = valid & (slot < (rpc - rr) * st)
    spill = valid & (slot >= (rpc - rr) * st) if rr else np.zeros_like(valid)
    return keep.astype(float), spill.astype(float), valid.astype(float)


def _per_column(sh: MambaShapes, v: np.ndarray, groups) -> np.ndarray:
    """A per-channel vector v as a mask [len(groups), n, slots] on every
    data row."""
    return pack_groups(sh, np.tile(np.asarray(v, float), (sh.seq, 1)),
                       groups)


def exp_steps(sh: MambaShapes, a_log: np.ndarray) -> int:
    """The squarings r of ``exp_scaled`` that cover every decay sum:
    |Σ A·dt| ≤ (S − 1)·max|A|·dt_max, dt_max = softplus(ACT_BOUND) (+1
    for the fit's own error)."""
    b = K.ACT_BOUND
    dt_max = b + math.log1p(math.exp(-b)) + 1.0
    worst = (sh.seq - 1) * float(np.exp(np.asarray(a_log)).max()) * dt_max
    return max(0, math.ceil(math.log2(worst / K.EXP_NEG_BOUND)))


def build_mamba_plans(sh: MambaShapes, p: dict, norm_init: float,
                      norm_m: float, norm_iters: int, eps: float,
                      silu_degree: int = 56,
                      softplus_degree: int = 48) -> MambaPlans:
    """The core's plans from a layer's mixer weights p (``conv1d.weight``
    [channels, 1, k], ``conv1d.bias``, ``dt_bias``, ``A_log``, ``D``,
    ``norm.weight``; numpy) and the gated RMSNorm's Newton seed and scale
    (``layers.rms_calibration`` of its rows)."""
    S, n, kc = sh.seq, sh.n, sh.conv
    xg, zg = sh.xbc_groups, sh.z_groups
    w = np.asarray(p["conv1d.weight"], float).reshape(-1, kc)
    # Tap j of the conv multiplies token t − (kc − 1 − j): shift k = kc−1−j.
    w0 = _per_column(sh, w[:, kc - 1], xg)
    keep, spill = [], []
    for k in range(1, kc):
        kp, sp, _ = _shift_masks(sh, S - k)
        taps = _per_column(sh, w[:, kc - 1 - k], xg)
        keep.append(taps * kp[None])
        spill.append(taps * sp[None])
    a = -np.exp(np.asarray(p["A_log"], float))
    r = exp_steps(sh, p["A_log"])
    per_head = lambda v: _per_column(sh, np.repeat(v, sh.head_dim), zg)
    masks = [_shift_masks(sh, dl) for dl in range(S)]
    stackd = lambda j: np.stack([m[j] for m in masks])[:, None]
    return MambaPlans(
        conv_w0=w0, conv_keep=np.stack(keep), conv_spill=np.stack(spill),
        conv_b=_per_column(sh, p["conv1d.bias"], xg),
        dt_bias=per_head(np.asarray(p["dt_bias"], float)),
        a_mask=per_head(a * 2.0 ** -r),
        d_mask=per_head(np.asarray(p["D"], float)),
        keep=stackd(0), spill=stackd(1), causal=stackd(2),
        norm=L.build_rms_plans(sh, p["norm.weight"], eps, norm_init,
                               norm_iters, m=norm_m, cols=sh.inner,
                               groups=2),
        exp_r=r, idx=_indices(sh), silu_degree=silu_degree,
        softplus_degree=softplus_degree)


def _gather(B, stacks, idx, keep, spill):
    """keep ⊙ pos[idx] + spill ⊙ neg[idx'] of stacks = (pos, neg) (idx'
    takes the next ct): the masked Δ-batched row shift of
    ``_gather_deltas``."""
    pos, neg = stacks
    rows, groups, cts, nxt = idx
    a = B.take_batch(pos, (rows, groups, cts))
    b = B.take_batch(neg, (rows, groups, nxt))
    return B.add(B.mul_plain(a, keep), B.mul_plain(b, spill))


def _take(B, v, lo: int, count: int):
    """Groups lo..lo+count of a [G, n] value."""
    return B.take_batch(v, (np.arange(lo, lo + count),))


def mixer_core(B, z, xbc, dt, sh: MambaShapes, mp: MambaPlans):
    """The Mamba-2 core on batched values z [2, n], xbc [4, n], dt [2, n]
    (``pack_core_inputs``' layout): out_proj's input, [2, n]."""
    S, ix = sh.seq, mp.idx
    with telemetry.span("mamba.conv"):
        shifted = _gather(B, L._row_shift_stacks(B, xbc, sh), ix["conv"],
                          mp.conv_keep, mp.conv_spill)
        conv = B.add(B.reduce_sum_batch(shifted, 0),
                     B.mul_plain(xbc, mp.conv_w0))
        xbc = K.silu(B, B.add_plain(conv, mp.conv_b),
                     degree=mp.silu_degree)
    with telemetry.span("mamba.decay"):
        dt = K.softplus(B, B.add_plain(dt, mp.dt_bias),
                        degree=mp.softplus_degree)
        a = L._row_shift_stacks(B, B.mul_plain(dt, mp.a_mask), sh)
        cs = B.reduce_sum_batch(_gather(B, a, ix["shift2"], mp.keep,
                                        mp.spill), 0)
        cs = L._row_shift_stacks(B, cs, sh)
        here = B.mul_plain(B.take_batch(cs[0], ix["here2"]), mp.causal)
        diff = B.sub(here, _gather(B, cs, ix["shift2"], mp.keep, mp.spill))
        decay = K.exp_scaled(B, diff, mp.exp_r)
    with telemetry.span("mamba.scan"):
        x = B.take_batch(xbc, (np.arange(2),))
        xs = _gather(B, L._row_shift_stacks(B, B.mul(x, dt), sh),
                     ix["shift2"], mp.keep, mp.spill)
        bs = _gather(B, L._row_shift_stacks(
            B, B.take_batch(xbc, (np.arange(2, 3),)), sh),
            ix["shift1"], mp.keep, mp.spill)
        prod = B.mul(B.take_batch(xbc, ix["c"]), bs)           # [S, 1, n]
        w = sh.stride // 2
        g = K.fold_sum(B, B.add(prod, B.rotate(prod, -w)), w)
        g = B.take_batch(g, ix["g2"])                          # [S, 2, n]
        y = B.reduce_sum_batch(B.mul(B.mul(g, xs), decay), 0)
        telemetry.count("mamba.deltas", S)
        y = B.add(y, B.mul_plain(x, mp.d_mask))
    with telemetry.span("mamba.gate_norm"):
        v = B.mul(y, K.silu(B, z, degree=mp.silu_degree))
        sq = B.reduce_sum_batch(B.square(v), 0)
        r = L.rms_rsqrt(B, sq, sh, mp.norm)
        return B.mul_plain(B.mul(v, B.stack([r, r])), mp.norm.weight)
