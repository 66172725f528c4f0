"""Key-switch and mod-down kernel wrappers: the Hopper counterpart of
``fhe_gpt2_tpu/core/tks.py``.

``fused_switch_key`` replaces the Pallas ``_ks_kernel`` (decompose → NTT →
key MAC in one TPU program per key limb); on the card it is the iNTT kernel
(``csrc/ntt.cu``) and then one launch of ``csrc/keyswitch.cu``, one
thread-block cluster per (batch, key limb) that forms each digit's
base-converted limb, runs its NTT across the cluster's shared memory
(``csrc/ntt_cluster.cuh``) and accumulates the key product in registers.
``fused_mod_down`` replaces the Pallas ``_md_kernel`` (convert → correct →
NTT → subtract·P⁻¹); on the card it is the iNTT of the dropped limbs, read
in place, and one launch of ``csrc/moddown.cu``, one cluster per (batch,
output limb). Each source carries its note on what bounds it and what its
design does. ``cluster_for`` (``core/tntt.py``) picks the cluster size;
``cluster=`` forces it.

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
from .modmath import sub_mod, mul_mod, mul_mod_shoup, mod_sum, shoup, \
    to_numpy_u32, word_tensor
from .ntt import NttTables, _intt_stages, _ntt_stages
# The cluster geometry lives with the NTT wrappers; its names stay
# importable from here.
from .tntt import CLUSTER_THREADS, CLUSTER_WORDS, MAX_CLUSTER, \
    _check_aligned, _check_cluster, _geometry, _sms, cluster_for, \
    cluster_sizes, cluster_threads, ctas_per_sm, ntt_inverse  # noqa: F401


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
    pw_shoup: torch.Tensor    # [D, J, A] Shoup word of pw for q_j
    mont: torch.Tensor        # [3, J] -q_j^-1 mod 2^32, 2^32 mod q_j, its
                              # Shoup word (the kernel's key product)
    gather: torch.Tensor      # [D*A] int32 source limb of (d, a), pad -> 0
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
    pw_sh = np.zeros((D, J, A), dtype=np.uint64)
    gather = np.zeros((D, A), dtype=np.int32)
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
            for jj, j in enumerate(ctx.key_limbs(level)):
                qj = ctx.all_moduli[j]
                pw[d, jj, a] = (S // qa) % qj
                pw_sh[d, jj, a] = shoup(int(pw[d, jj, a]), qj)
            iv = pow((S // qa) % qa, -1, qa)
            ipunc[d, a, 0] = iv
            ipunc_sh[d, a, 0] = (iv << 32) // qa
            srcq[d, a, 0] = qa
    qs = [ctx.all_moduli[j] for j in ctx.key_limbs(level)]
    mont = [[(-pow(q, -1, 1 << 32)) % (1 << 32) for q in qs],
            [(1 << 32) % q for q in qs],
            [shoup((1 << 32) % q, q) for q in qs]]
    dev = ctx.device
    return FusedKsTables(
        D=D, A=A, bcts=bcts, mont=word_tensor(mont, dev),
        own=torch.from_numpy(own).to(dev),
        pw=word_tensor(pw, dev), pw_shoup=word_tensor(pw_sh, dev),
        gather=torch.from_numpy(gather.ravel()).to(dev),
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
                     lt: NttTables, kt: NttTables, ft: FusedKsTables,
                     cluster: int | None = None) -> torch.Tensor:
    """Decompose + NTT + key MAC of NTT-form c_ntt[*B, l, N] against the
    active key digits kdata[2, D, J, N]. Returns [2, *B, J, N] before the
    mod-down; equals ``_ks_mac_core(_decompose_core(...))``. ``cluster``
    forces the kernel's cluster size (one of ``cluster_sizes``)."""
    _check_cluster(kt.logn, cluster)
    if c_ntt.device.type == "cpu":
        return switch_key_plain(c_ntt, kdata, lt, kt, ft)
    *lead, l, n = c_ntt.shape
    M = int(np.prod(lead)) if lead else 1
    D, J = ft.D, kt.q.shape[0]
    _cuda.check_operand(c_ntt, "c_ntt")
    _cuda.check_operand(kdata, "kdata", (2, D, J, n))
    _check_aligned(c_ntt, "c_ntt")
    _check_aligned(kdata, "kdata")
    if ft.own.shape != (D, J) or lt.q.shape[0] != l or kt.n != n:
        raise ValueError("key-switch tables do not match the operand level")
    log_c, threads = _geometry(kt.logn, M * J, c_ntt, cluster)
    c_coeff = ntt_inverse(c_ntt, lt)
    out = torch.empty((2, M, J, n), dtype=torch.int32, device=c_ntt.device)
    _cuda.call("keyswitch", "ks_fused", *ks_fused_args(
        c_coeff, c_ntt, kdata, kt, ft, out, log_c, threads))
    _cuda.LAUNCHES["keyswitch"] += 1
    return out.reshape(2, *lead, J, n)


def ks_fused_args(c_coeff, c_ntt, kdata, kt: NttTables, ft: FusedKsTables,
                  out, log_c: int, threads: int) -> tuple:
    """The arguments of the C entry ``ks_fused`` but the stream, in its
    order; out is [2, M, J, N]."""
    M, J, l = out.shape[1], out.shape[2], c_ntt.shape[-2]
    return (c_coeff, c_ntt, kdata, ft.own, ft.pw, ft.pw_shoup, ft.gather,
            ft.inv_punc, ft.inv_punc_shoup, ft.src_q, kt.q, ft.mont, kt.roots,
            kt.roots_shoup, out, M, ft.D, ft.A, J, l, kt.logn, log_c, threads)


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
    punc_shoup: torch.Tensor     # [k, l] Shoup word of (P/p_i) mod q_j
    p_mod_q_shoup: torch.Tensor  # [l, 1] Shoup word of P mod q_j


def make_fused_md_tables(mdt: rns.ModDownTables, kt: NttTables) -> FusedMdTables:
    q = to_numpy_u32(kt.q).ravel().astype(np.uint64)
    punc = to_numpy_u32(mdt.bct.punc_mod_dst).astype(np.uint64)
    pmodq = to_numpy_u32(mdt.p_mod_q).ravel().astype(np.uint64)
    dev = kt.q.device
    return FusedMdTables(
        mdt=mdt, k=mdt.half_p.shape[0], l=kt.q.shape[0],
        punc_shoup=word_tensor((punc << np.uint64(32)) // q, dev),
        p_mod_q_shoup=word_tensor(((pmodq << np.uint64(32)) // q)[:, None], dev))


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
                   ft: FusedMdTables, cluster: int | None = None) -> torch.Tensor:
    """One-shot divide-and-round of NTT-form x[..., l+k, N] by P = prod of
    the k trailing primes (HPS, float32 overflow correction clamped to
    [0, k-1]). Returns [..., l, N]. ``cluster`` forces the kernel's cluster
    size (one of ``cluster_sizes``)."""
    _check_cluster(t_q.logn, cluster)
    if x.device.type == "cpu":
        return mod_down_plain(x, t_sp, t_q, ft)
    *lead, lk, n = x.shape
    k, l = ft.k, ft.l
    if lk != l + k or t_sp.q.shape[0] != k or t_q.n != n:
        raise ValueError(f"mod-down operand has {lk} limbs, tables {l}+{k}")
    M = int(np.prod(lead)) if lead else 1
    _cuda.check_operand(x, "x")
    _check_aligned(x, "x")
    log_c, threads = _geometry(t_q.logn, M * l, x, cluster)
    a = ntt_inverse(x[..., l:, :], t_sp)
    out = torch.empty((M, l, n), dtype=torch.int32, device=x.device)
    _cuda.call("moddown", "md_fused", *md_fused_args(a, x, t_q, ft, out,
                                                     log_c, threads))
    _cuda.LAUNCHES["moddown"] += 1
    return out.reshape(*lead, l, n)


def md_fused_args(a, x, t_q: NttTables, ft: FusedMdTables, out, log_c: int,
                  threads: int) -> tuple:
    """The arguments of the C entry ``md_fused`` but the stream, in its
    order; a is the iNTT of the dropped limbs, out is [M, l, N]."""
    mdt = ft.mdt
    return (a, x, mdt.half_p, mdt.bct.inv_punc, mdt.bct.inv_punc_shoup,
            mdt.bct.src_q, mdt.bct.punc_mod_dst, ft.punc_shoup, mdt.p_invf,
            mdt.p_mod_q, ft.p_mod_q_shoup, mdt.half_q, mdt.inv_p,
            mdt.inv_p_shoup, t_q.q, t_q.roots, t_q.roots_shoup, out,
            out.shape[0], ft.k, ft.l, t_q.logn, log_c, threads)
