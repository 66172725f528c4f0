"""Key-switch and mod-down kernel wrappers: the Hopper counterpart of
``fhe_gpt2_tpu/core/tks.py``.

``fused_switch_key`` replaces the Pallas ``_ks_kernel`` (decompose → NTT →
key MAC in one TPU program per key limb); on the card it is the iNTT kernel,
the per-digit ``y`` operands as torch ops (XLA ops in the JAX package), and
``csrc/keyswitch.cu``'s convert-MAC and splice+key-MAC kernels around the
forward NTT kernel. ``fused_mod_down`` replaces the Pallas ``_md_kernel``
(convert → correct → NTT → subtract·P⁻¹); on the card it is the iNTT kernel
on the dropped limbs, the ``v`` operands as torch ops, and
``csrc/moddown.cu``'s convert and finish kernels around the forward NTT.
Each source carries its note on what bounds it and what its design does.

Route: CUDA tensors launch the kernels (or the wrapper raises); CPU tensors
run the plain versions below, which nothing on the card path calls:
``switch_key_plain`` is the port of ``_decompose_core`` + ``_ks_mac_core``
and ``mod_down_plain`` is ``mod_down_convert`` + NTT with the kernel's
sequential float32 sum.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _cuda, rns
from .modmath import add_mod, sub_mod, mul_mod, mul_mod_shoup, mod_sum, \
    word_tensor
from .ntt import NttTables, _intt_stages, _ntt_stages
from .tntt import ntt_forward, ntt_inverse


# ---------------------------------------------------------------------------
# Key switch
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusedKsTables:
    """Constants for one (level → key basis) key switch."""

    D: int                    # digits
    A: int                    # widest digit (source limbs per digit)
    bcts: tuple               # per-digit rns.BaseConvTables (plain version)
    own: torch.Tensor         # [D, J] int32: digit d owns data limb j
    pw: torch.Tensor          # [D, J, A] (Q_d/q_a) mod q_j, zero-padded
    gather: torch.Tensor      # [D*A] int64 source limb of (d, a), pad -> 0
    inv_punc: torch.Tensor    # [D, A, 1] (pad rows 0)
    inv_punc_shoup: torch.Tensor
    src_q: torch.Tensor       # [D, A, 1] (pad rows 1)


def make_fused_ks_tables(ctx, level: int) -> FusedKsTables:
    """From the context's digit structure (digit_groups/decomp_tables)."""
    groups = ctx.digit_groups(level)
    bcts = ctx.decomp_tables(level)
    J = len(ctx.key_limbs(level))
    D = len(groups)
    A = max(len(g) for g in groups)
    own = np.zeros((D, J), dtype=np.int32)
    pw = np.zeros((D, J, A), dtype=np.uint64)
    gather = np.zeros((D, A), dtype=np.int64)
    ipunc = np.zeros((D, A, 1), dtype=np.uint64)
    ipunc_sh = np.zeros((D, A, 1), dtype=np.uint64)
    srcq = np.ones((D, A, 1), dtype=np.uint64)
    for d, g in enumerate(groups):
        S = 1
        for i in g:
            S *= ctx.moduli[i]
        own[d, list(g)] = 1
        w = len(g)
        gather[d, :w] = g
        for a, i in enumerate(g):
            qa = ctx.moduli[i]
            pw[d, :, a] = [(S // qa) % ctx.all_moduli[j]
                           for j in ctx.key_limbs(level)]
            iv = pow((S // qa) % qa, -1, qa)
            ipunc[d, a, 0] = iv
            ipunc_sh[d, a, 0] = (iv << 32) // qa
            srcq[d, a, 0] = qa
    dev = ctx.device
    return FusedKsTables(
        D=D, A=A, bcts=bcts,
        own=torch.from_numpy(own).to(dev),
        pw=word_tensor(pw, dev), gather=torch.from_numpy(gather.ravel()).to(dev),
        inv_punc=word_tensor(ipunc, dev), inv_punc_shoup=word_tensor(ipunc_sh, dev),
        src_q=word_tensor(srcq, dev))


def _decompose_core(c, kt: NttTables, lt: NttTables, bcts, own_mask):
    """Hybrid digit decomposition of NTT-form c[..., l, N] into
    tpoly[..., D, l+k, N] (``evaluator._decompose_core``), plain ops only."""
    c_coeff = _intt_stages(c, lt)
    start, digs = 0, []
    for bct in bcts:
        w = len(bct.src)
        digs.append(rns.base_convert(c_coeff[..., start:start + w, :], bct))
        start += w
    tpoly = _ntt_stages(torch.stack(digs, dim=-3), kt)      # [..., D, l+k, N]
    k_sp = tpoly.shape[-2] - c.shape[-2]
    pad = torch.zeros((*c.shape[:-2], k_sp, c.shape[-1]), dtype=c.dtype,
                      device=c.device)
    c_pad = torch.cat([c, pad], dim=-2)
    return torch.where(own_mask, c_pad[..., None, :, :], tpoly)


def _ks_mac_core(tpoly, kdata, kt: NttTables):
    """MAC over the digit axis (``evaluator._ks_mac_core``): tpoly
    [..., D, l+k, N], kdata [2, D, l+k, N] -> [2, ..., l+k, N]."""
    D, nk, n = tpoly.shape[-3:]
    batch_ndim = tpoly.ndim - 3
    kdata = kdata.reshape(2, *(1,) * batch_ndim, D, nk, n)
    prod = mul_mod(tpoly[None], kdata, kt.q)
    return mod_sum(prod, kt.q, axis=-3)


def switch_key_plain(c_ntt, kdata, lt, kt, ft: FusedKsTables):
    """Plain version of ``fused_switch_key`` on any device."""
    own_mask = (ft.own != 0)[..., None]
    return _ks_mac_core(_decompose_core(c_ntt, kt, lt, ft.bcts, own_mask),
                        kdata, kt)


def fused_switch_key(c_ntt: torch.Tensor, kdata: torch.Tensor,
                     lt: NttTables, kt: NttTables,
                     ft: FusedKsTables) -> torch.Tensor:
    """Decompose + NTT + key MAC of NTT-form c_ntt[*B, l, N] against the
    active key digits kdata[2, D, J, N]. Returns [2, *B, J, N] before the
    mod-down; equals ``_ks_mac_core(_decompose_core(...))``."""
    if c_ntt.device.type == "cpu":
        return switch_key_plain(c_ntt, kdata, lt, kt, ft)
    *lead, l, n = c_ntt.shape
    M = int(np.prod(lead)) if lead else 1
    D, A = ft.D, ft.A
    J = kt.q.shape[0]
    _cuda.check_operand(c_ntt, "c_ntt")
    _cuda.check_operand(kdata, "kdata", (2, D, J, n))
    if ft.own.shape != (D, J) or lt.q.shape[0] != l:
        raise ValueError("key-switch tables do not match the operand level")
    c_coeff = ntt_inverse(c_ntt, lt)
    g = c_coeff.reshape(M, l, n).index_select(1, ft.gather).reshape(M, D, A, n)
    y = mul_mod_shoup(g, ft.inv_punc, ft.inv_punc_shoup, ft.src_q)
    t = torch.empty((M, D, J, n), dtype=torch.int32, device=c_ntt.device)
    _cuda.call("keyswitch", "ks_convert_mac", y, ft.pw, kt.q, kt.ratio0,
               kt.ratio1, t, M, D, A, J, n)
    tn = ntt_forward(t, kt)
    out = torch.empty((2, M, J, n), dtype=torch.int32, device=c_ntt.device)
    _cuda.call("keyswitch", "ks_key_mac", c_ntt, tn, kdata, ft.own, kt.q,
               kt.ratio0, kt.ratio1, out, M, D, J, l, n)
    _cuda.LAUNCHES["keyswitch"] += 1
    return out.reshape(2, *lead, J, n)


# ---------------------------------------------------------------------------
# Mod-down
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusedMdTables:
    """Constants for dividing NTT-form x[..., l+k, N] by P = prod of the k
    trailing primes: the rns.ModDownTables, plus the output level."""

    mdt: rns.ModDownTables
    k: int
    l: int


def make_fused_md_tables(mdt: rns.ModDownTables, kt: NttTables) -> FusedMdTables:
    return FusedMdTables(mdt=mdt, k=mdt.half_p.shape[0], l=kt.q.shape[0])


def mod_down_plain(x: torch.Tensor, t_sp: NttTables, t_q: NttTables,
                   ft: FusedMdTables) -> torch.Tensor:
    """Plain version of ``fused_mod_down`` on any device."""
    mdt = ft.mdt
    l = x.shape[-2] - ft.k
    a = _intt_stages(x[..., l:, :], t_sp)
    img = _ntt_stages(rns.mod_down_convert(a, mdt), t_q)
    diff = sub_mod(x[..., :l, :], img, t_q.q)
    return mul_mod_shoup(diff, mdt.inv_p, mdt.inv_p_shoup, t_q.q)


def fused_mod_down(x: torch.Tensor, t_sp: NttTables, t_q: NttTables,
                   ft: FusedMdTables) -> torch.Tensor:
    """One-shot divide-and-round of NTT-form x[..., l+k, N] by P = prod of
    the k trailing primes (HPS, float32 overflow correction clamped to
    [0, k-1]). Returns [..., l, N]."""
    if x.device.type == "cpu":
        return mod_down_plain(x, t_sp, t_q, ft)
    *lead, lk, n = x.shape
    k, l = ft.k, ft.l
    if lk != l + k or t_sp.q.shape[0] != k:
        raise ValueError(f"mod-down operand has {lk} limbs, tables {l}+{k}")
    M = int(np.prod(lead)) if lead else 1
    _cuda.check_operand(x, "x")
    mdt = ft.mdt
    a = ntt_inverse(x[..., l:, :].contiguous(), t_sp)
    v = mul_mod_shoup(add_mod(a, mdt.half_p, mdt.bct.src_q),
                      mdt.bct.inv_punc, mdt.bct.inv_punc_shoup, mdt.bct.src_q)
    v = v.contiguous()
    img = torch.empty((M, l, n), dtype=torch.int32, device=x.device)
    _cuda.call("moddown", "md_convert", v, mdt.bct.punc_mod_dst, mdt.p_invf,
               mdt.p_mod_q, mdt.half_q, t_q.q, t_q.ratio0, t_q.ratio1, img,
               M, k, l, n)
    z = ntt_forward(img, t_q)
    out = torch.empty((M, l, n), dtype=torch.int32, device=x.device)
    _cuda.call("moddown", "md_finish", x, z, mdt.inv_p, mdt.inv_p_shoup,
               t_q.q, out, M, l, k, n)
    _cuda.LAUNCHES["moddown"] += 1
    return out.reshape(*lead, l, n)
