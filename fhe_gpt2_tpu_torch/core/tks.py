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

Route: by word first, then by device. int32 CUDA tensors launch the
kernels (or the wrapper raises); int32 CPU tensors, and int64 tensors (the
u64 engine) on any device, run the plain versions below, which no int32
card path calls: ``switch_key_plain`` is the port of ``_decompose_core`` +
``_ks_mac_core`` and ``mod_down_plain`` is ``mod_down_convert`` + NTT with
the kernel's sequential float32 sum. The JAX package takes the same split
path for its u64 engine (``_fused_ks_mode`` is None without Pallas tables,
which exist only for 32-bit chains), so int64 never reaches a kernel. The
hoisted rotations (``core/evaluator.py``) use the split halves themselves,
as the JAX package does: ``_decompose_core`` with its transforms on the NTT
route, then per rotation ``hoisted_mac`` (the key product with the Galois
gather) and, for the double-hoisted form, ``add_lifted`` (P·c0 rotated,
added in place); the LT engine's masked sums are ``masked_sum``. Those
three launch ``csrc/mac.cu`` for int32 CUDA words, which the JAX package
leaves to XLA; their plain versions (``hoisted_mac_plain``,
``add_lifted_plain``, ``masked_sum_plain``) are the torch ops the port ran
before, which the CPU and the u64 engine keep. ``hoisted_mac`` and
``masked_sum`` count each call as ``mac.calls`` and each that launched as
``mac.kernel`` (``utils/telemetry.py``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import _cuda, rns
from ..utils import telemetry
from .modmath import add_mod, sub_mod, mul_mod, mul_mod_shoup, mod_sum, \
    shoup, to_numpy_u32, word_tensor
from .ntt import NttTables, _intt_stages, _ntt_stages
# The cluster geometry lives with the NTT wrappers; its names stay
# importable from here.
from .tntt import CLUSTER_THREADS, CLUSTER_WORDS, MAX_CLUSTER, \
    _check_aligned, _check_cluster, _geometry, _sms, cluster_for, \
    cluster_sizes, cluster_threads, ctas_per_sm, ntt_forward, \
    ntt_inverse  # noqa: F401


# ---------------------------------------------------------------------------
# Key switch
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusedKsTables:
    """Constants for one (level → key basis) key switch. A u64 chain has
    no kernel, so it keeps only the plain version's fields (D, A, bcts,
    own) and the kernel's are None."""

    D: int                    # digits
    A: int                    # widest digit (source limbs per digit)
    bcts: tuple               # per-digit rns.BaseConvTables (plain version)
    own: torch.Tensor         # [D, J] int32: digit d owns key row j
    rows: torch.Tensor        # [J] int32: the row of c that key row j takes
                              # where a digit owns it, its data limb (the
                              # identity on one device; the special rows,
                              # owned by no digit, hold l + i, never read)
    splice: torch.Tensor | None   # int64 data limbs of the key rows, None
                                  # where rows is the identity
    pw: torch.Tensor | None   # [D, J, A] (Q_d/q_a) mod q_j, zero-padded
    pw_shoup: torch.Tensor    # [D, J, A] Shoup word of pw for q_j
    mont: torch.Tensor        # [3, J] -q_j^-1 mod 2^32, 2^32 mod q_j, its
                              # Shoup word (the kernel's key product)
    gather: torch.Tensor      # [D*A] int32 source limb of (d, a), pad -> 0
    inv_punc: torch.Tensor    # [D, A, 1] (pad rows 0)
    inv_punc_shoup: torch.Tensor
    src_q: torch.Tensor       # [D, A, 1] (pad rows 1)


def make_fused_ks_tables(ctx, level: int) -> FusedKsTables:
    """From the context's digit structure (digit_groups/decomp_tables), for
    its key rows at `level` (``key_limbs``: every data limb below the level
    on one device, a mesh position's own on a limb axis, then the
    specials)."""
    groups = ctx.digit_groups(level)
    bcts = ctx.decomp_tables(level)
    key = ctx.key_limbs(level)
    J = len(key)
    D = len(groups)
    A = max(len(g) for g in groups)
    own = np.array([[j in g for j in key] for g in groups], dtype=np.int32)
    rows = [j if j < ctx.L else level + j - ctx.L for j in key]
    data = [j for j in key if j < ctx.L]
    dev = ctx.device
    tabs = dict(
        D=D, A=A, bcts=bcts, own=torch.from_numpy(own).to(dev),
        rows=torch.tensor(rows, dtype=torch.int32, device=dev),
        splice=(None if rows == list(range(J))
                else torch.tensor(data, dtype=torch.long, device=dev)))
    if ctx.word_bits == 64:
        return FusedKsTables(**tabs, pw=None, pw_shoup=None, mont=None,
                             gather=None, inv_punc=None, inv_punc_shoup=None,
                             src_q=None)
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
        w = len(g)
        gather[d, :w] = g
        for a, i in enumerate(g):
            qa = ctx.moduli[i]
            for jj, j in enumerate(key):
                qj = ctx.all_moduli[j]
                pw[d, jj, a] = (S // qa) % qj
                pw_sh[d, jj, a] = shoup(int(pw[d, jj, a]), qj)
            iv = pow((S // qa) % qa, -1, qa)
            ipunc[d, a, 0] = iv
            ipunc_sh[d, a, 0] = (iv << 32) // qa
            srcq[d, a, 0] = qa
    qs = [ctx.all_moduli[j] for j in key]
    mont = [[(-pow(q, -1, 1 << 32)) % (1 << 32) for q in qs],
            [(1 << 32) % q for q in qs],
            [shoup((1 << 32) % q, q) for q in qs]]
    return FusedKsTables(
        **tabs, mont=word_tensor(mont, dev), pw=word_tensor(pw, dev),
        pw_shoup=word_tensor(pw_sh, dev),
        gather=torch.from_numpy(gather.ravel()).to(dev),
        inv_punc=word_tensor(ipunc, dev), inv_punc_shoup=word_tensor(ipunc_sh, dev),
        src_q=word_tensor(srcq, dev))


def _decompose_core(c, kt: NttTables, lt: NttTables, bcts, own_mask,
                    splice=None, plain: bool = False):
    """Hybrid digit decomposition of NTT-form c[..., l, N] into
    tpoly[..., D, J, N] over the key rows of kt (``evaluator._decompose_core``,
    where J = l+k): the expensive half of a key switch, which the hoisted
    rotations share. A digit's own rows take c's rows ``splice`` (the key
    rows' data limbs; c's rows in order where None). Its iNTT and NTT go
    through ``ntt_inverse``/``ntt_forward``, so a CUDA c launches the NTT
    kernels; ``plain=True`` runs the stage loops on any device."""
    intt, ntt = ((_intt_stages, _ntt_stages) if plain
                 else (ntt_inverse, ntt_forward))
    c_coeff = intt(c, lt)
    start, digs = 0, []
    for bct in bcts:
        w = len(bct.src)
        digs.append(rns.base_convert(c_coeff[..., start:start + w, :], bct))
        start += w
    tpoly = ntt(torch.stack(digs, dim=-3), kt)              # [..., D, J, N]
    own = c if splice is None else c.index_select(-2, splice)
    pad = torch.zeros((*c.shape[:-2], tpoly.shape[-2] - own.shape[-2],
                       c.shape[-1]), dtype=c.dtype, device=c.device)
    c_pad = torch.cat([own, pad], dim=-2)
    return torch.where(own_mask, c_pad[..., None, :, :], tpoly)


MAC_WORDS = 1 << 26     # int64 key-MAC products formed at once


def _ks_mac_core(tpoly, kdata, kt: NttTables):
    """MAC over the digit axis (``evaluator._ks_mac_core``): tpoly
    [..., D, l+k, N], kdata [2, D, l+k, N] -> [2, ..., l+k, N]. On the
    int64 word the digits go in chunks of about MAC_WORDS products, each
    folded into the sum with ``add_mod``: the exact products' transients
    stay bounded, and the canonical sum is the JAX one."""
    D, nk, n = tpoly.shape[-3:]
    batch_ndim = tpoly.ndim - 3
    kdata = kdata.reshape(2, *(1,) * batch_ndim, D, nk, n)
    if tpoly.dtype != torch.int64:
        prod = mul_mod(tpoly[None], kdata, kt.q)
        return mod_sum(prod, kt.q, axis=-3)
    step = max(1, MAC_WORDS // (2 * tpoly[..., :1, :, :].numel()))
    acc = None
    for d in range(0, D, step):
        prod = mul_mod(tpoly[None, ..., d:d + step, :, :],
                       kdata[..., d:d + step, :, :], kt.q, kt.ratio0,
                       kt.ratio1)
        part = mod_sum(prod, kt.q, axis=-3)
        acc = part if acc is None else add_mod(acc, part, kt.q)
    return acc


def switch_key_plain(c_ntt, kdata, lt, kt, ft: FusedKsTables):
    """Plain version of ``fused_switch_key`` on any device."""
    own_mask = (ft.own != 0)[..., None]
    return _ks_mac_core(_decompose_core(c_ntt, kt, lt, ft.bcts, own_mask,
                                        ft.splice, plain=True), kdata, kt)


def fused_switch_key(c_ntt: torch.Tensor, kdata: torch.Tensor,
                     lt: NttTables, kt: NttTables, ft: FusedKsTables,
                     cluster: int | None = None) -> torch.Tensor:
    """Decompose + NTT + key MAC of NTT-form c_ntt[*B, l, N] (every limb
    below the level) against the active key digits kdata[2, D, J, N] of
    the key rows of kt and ft (``ft.rows`` maps them to c's rows). Returns
    [2, *B, J, N] before the mod-down; equals
    ``_ks_mac_core(_decompose_core(...))``. ``cluster`` forces the kernel's
    cluster size (one of ``cluster_sizes``)."""
    _check_cluster(kt.logn, cluster)
    if c_ntt.dtype == torch.int64 or c_ntt.device.type == "cpu":
        return switch_key_plain(c_ntt, kdata, lt, kt, ft)
    *lead, l, n = c_ntt.shape
    M = int(np.prod(lead)) if lead else 1
    D, J = ft.D, kt.q.shape[0]
    _cuda.check_operand(c_ntt, "c_ntt")
    _cuda.check_operand(kdata, "kdata", (2, D, J, n))
    _check_aligned(c_ntt, "c_ntt")
    _check_aligned(kdata, "kdata")
    if (ft.own.shape != (D, J) or ft.rows.shape != (J,)
            or lt.q.shape[0] != l or kt.n != n):
        raise ValueError("key-switch tables do not match the operand level")
    log_c, threads = _geometry(kt.logn, M * J, c_ntt, cluster)
    c_coeff = ntt_inverse(c_ntt, lt)
    out = torch.empty((2, M, J, n), dtype=torch.int32, device=c_ntt.device)
    _cuda.call("keyswitch", "ks_fused", *ks_fused_args(
        c_coeff, c_ntt, kdata, kt, ft, out, log_c, threads))
    _cuda.count("keyswitch")
    return out.reshape(2, *lead, J, n)


def ks_fused_args(c_coeff, c_ntt, kdata, kt: NttTables, ft: FusedKsTables,
                  out, log_c: int, threads: int) -> tuple:
    """The arguments of the C entry ``ks_fused`` but the stream, in its
    order; out is [2, M, J, N]."""
    M, J, l = out.shape[1], out.shape[2], c_ntt.shape[-2]
    return (c_coeff, c_ntt, kdata, ft.own, ft.rows, ft.pw, ft.pw_shoup,
            ft.gather,
            ft.inv_punc, ft.inv_punc_shoup, ft.src_q, kt.q, ft.mont, kt.roots,
            kt.roots_shoup, out, M, ft.D, ft.A, J, l, kt.logn, log_c, threads)


# ---------------------------------------------------------------------------
# Mod-down
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusedMdTables:
    """Constants for dividing NTT-form x[..., l+k, N] by P = prod of the k
    trailing primes: the rns.ModDownTables, plus the output level (the
    kernel's Shoup words are None on a u64 chain, which has no kernel)."""

    mdt: rns.ModDownTables
    k: int
    l: int
    punc_shoup: torch.Tensor | None     # [k, l] Shoup word of (P/p_i) mod q_j
    p_mod_q_shoup: torch.Tensor | None  # [l, 1] Shoup word of P mod q_j


def make_fused_md_tables(mdt: rns.ModDownTables, kt: NttTables) -> FusedMdTables:
    if kt.q.dtype == torch.int64:
        return FusedMdTables(mdt=mdt, k=mdt.half_p.shape[0], l=kt.q.shape[0],
                             punc_shoup=None, p_mod_q_shoup=None)
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
    *lead, lk, n = x.shape
    if ft.l == 0:
        # A mesh position that holds no limb below the output level.
        return x.new_empty((*lead, 0, n))
    if x.dtype == torch.int64 or x.device.type == "cpu":
        return mod_down_plain(x, t_sp, t_q, ft)
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
    _cuda.count("moddown")
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


# ---------------------------------------------------------------------------
# Modular multiply-accumulates of the double-hoisted LT path (csrc/mac.cu)
# ---------------------------------------------------------------------------

MAC_CHUNK = 8           # masked-sum terms per launch and per int64 product
MAC_THREADS = 256       # threads of a mac.cu CTA (csrc/mac.cu kThreads)


def _mac_threads(n: int) -> int:
    """Threads of a mac.cu CTA over rows of n words: 8 words a thread and
    at most MAC_THREADS, so that a CTA's block of 8·threads words divides
    the row."""
    threads = min(MAC_THREADS, n // 8)
    if threads < 1 or n & (n - 1):
        raise ValueError(f"mac kernels: rows of {n} words (want a power of "
                         "two of at least 8)")
    return threads


def hoisted_mac_plain(tpoly, kdata, perm, kt: NttTables):
    """Plain version of ``hoisted_mac`` on any device: the gather, then
    ``_ks_mac_core``."""
    return _ks_mac_core(tpoly.index_select(-1, perm), kdata, kt)


def hoisted_mac(tpoly: torch.Tensor, kdata: torch.Tensor,
                perm: torch.Tensor, kt: NttTables) -> torch.Tensor:
    """One hoisted rotation's key product: the shared digits
    tpoly[*B, D, J, N] permuted by the automorphism's NTT-slot map perm
    (int64 [N], ``CkksContext.galois_perm``) and multiply-accumulated with
    its key kdata[2, D, J, N] over the digits, mod the rows' moduli of kt.
    Returns [2, *B, J, N] before the mod-down; equals
    ``_ks_mac_core(tpoly.index_select(-1, perm), kdata, kt)``. An int32
    CUDA tpoly launches ``csrc/mac.cu``'s ``hoisted_mac`` (the gather in
    the kernel) or raises; a CPU or int64 one runs the plain version."""
    telemetry.count("mac.calls")
    if tpoly.dtype == torch.int64 or tpoly.device.type == "cpu":
        return hoisted_mac_plain(tpoly, kdata, perm, kt)
    *lead, D, J, n = tpoly.shape
    M = int(np.prod(lead)) if lead else 1
    _cuda.check_operand(tpoly, "tpoly")
    _cuda.check_operand(kdata, "kdata", (2, D, J, n))
    if (perm.dtype != torch.int64 or perm.shape != (n,)
            or perm.device != tpoly.device or not perm.is_contiguous()):
        raise ValueError(f"hoisted_mac: perm must be a contiguous int64 [{n}] "
                         f"on {tpoly.device}")
    if kt.q.shape[0] != J:
        raise ValueError(f"hoisted_mac: tables of {kt.q.shape[0]} rows for "
                         f"{J} key rows")
    _check_aligned(tpoly, "tpoly")
    _check_aligned(kdata, "kdata")
    threads = _mac_threads(n)
    out = torch.empty((2, M, J, n), dtype=torch.int32, device=tpoly.device)
    _cuda.call("mac", "hoisted_mac", tpoly, kdata, perm, kt.q, kt.ratio0,
               kt.ratio1, out, M, D, J, n, threads)
    _cuda.count("mac")
    telemetry.count("mac.kernel")
    return out.reshape(2, *lead, J, n)


def add_lifted_plain(acc, c0, perm, p, p_shoup, q):
    """Plain version of ``add_lifted`` on any device (a new tensor)."""
    r = q.shape[0]
    pc0 = mul_mod_shoup(c0.index_select(-1, perm), p[:r], p_shoup[:r], q)
    e0 = torch.cat([add_mod(acc[0][..., :r, :], pc0, q), acc[0][..., r:, :]],
                   dim=-2)
    return torch.stack([e0, acc[1]])


def add_lifted(acc: torch.Tensor, c0: torch.Tensor, perm: torch.Tensor,
               p: torch.Tensor, p_shoup: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """A double-hoisted rotation in the extended basis: a hoisted key
    product acc[2, *B, J, N] (``hoisted_mac``) with P·c0[*B, r, N] permuted
    by perm added to the r data rows of its first component; P's residues
    p and their Shoup words over the key rows ([J, 1], their first r rows
    read), q the data rows' moduli [r, 1]. An int32 CUDA acc is updated in
    place by ``csrc/mac.cu``'s ``add_lifted`` and returned (acc must be
    contiguous, as ``hoisted_mac`` returns it); a CPU or int64 one gets
    the plain version, a new tensor."""
    if acc.dtype == torch.int64 or acc.device.type == "cpu":
        return add_lifted_plain(acc, c0, perm, p, p_shoup, q)
    _, *lead, J, n = acc.shape
    r = q.shape[0]
    M = int(np.prod(lead)) if lead else 1
    c0 = c0.contiguous()
    _cuda.check_operand(acc, "acc")
    _cuda.check_operand(c0, "c0", (*lead, r, n))
    if perm.dtype != torch.int64 or perm.shape != (n,) or r > J:
        raise ValueError("add_lifted: operands do not match")
    _check_aligned(acc, "acc")
    _check_aligned(c0, "c0")
    pr, ps = p[:r].contiguous(), p_shoup[:r].contiguous()
    _cuda.call("mac", "add_lifted", c0, perm, pr, ps, q, acc, M, r, J, n,
               _mac_threads(n))
    _cuda.count("mac")
    return acc


def masked_sum_plain(values: list, pts: list, t: NttTables) -> torch.Tensor:
    """Plain version of ``masked_sum`` on any device: the JAX package's
    stacked ``mul_mod`` + ``mod_sum`` over the term axis, in chunks of
    MAC_CHUNK terms. On the int32 word an int64 sum of the canonical
    products, reduced once, is the same canonical residue; on the int64
    word (residues up to 2**62, whose sum of products would overflow) each
    chunk folds with ``mod_sum`` and the chunks with ``add_mod``."""
    q = t.q
    wide = values[0].dtype == torch.int64
    acc = None
    for i in range(0, len(values), MAC_CHUNK):
        v = torch.stack(values[i:i + MAC_CHUNK], dim=1)        # [2, T, ...]
        p = torch.stack(pts[i:i + MAC_CHUNK])                  # [T, l, N]
        p = p.reshape(p.shape[0], *(1,) * (v.ndim - 4), *p.shape[1:])
        prod = mul_mod(v, p, q, t.ratio0, t.ratio1)
        if wide:
            part = mod_sum(prod, q, axis=1)
            acc = part if acc is None else add_mod(acc, part, q)
        else:
            part = prod.long().sum(dim=1)
            acc = part if acc is None else acc + part
    return acc if wide else torch.remainder(acc, q).to(torch.int32)


def _term_rows(v: torch.Tensor, M: int, J: int, n: int) -> tuple:
    """(stride of c, of the flattened batch, of j) of a term v[2, *B, J, N]
    whose batch axes merge into one and whose rows are contiguous words
    starting on 16 bytes."""
    try:
        s = v.view(2, M, J, n).stride()
    except RuntimeError:
        raise ValueError(f"masked_sum: a term of shape {tuple(v.shape)} and "
                         f"strides {v.stride()} has no [2, M, J, N] view")
    _check_aligned(v, "term")
    if s[3] != 1 or any(x % 4 for x in s[:3]):
        raise ValueError(f"masked_sum: a term's strides {v.stride()} do not "
                         "give rows of contiguous words on 16 bytes")
    return s[0], s[1], s[2]


def masked_sum(values: list, pts: list, t: NttTables) -> torch.Tensor:
    """Σ_t values[t]·pts[t] mod q over terms [2, *B, l, N] (views with any
    row, batch and component strides) and masks [l, N], with q and its
    Barrett words from the NTT tables t: [2, *B, l, N]. int32 CUDA terms
    launch ``csrc/mac.cu``'s ``masked_sum`` once per MAC_CHUNK terms (each
    launch after the first accumulating onto the output) or raise (every
    row must start on 16 bytes); CPU or int64 ones run the plain
    version."""
    telemetry.count("mac.calls")
    v0 = values[0]
    if v0.dtype == torch.int64 or v0.device.type == "cpu":
        return masked_sum_plain(values, pts, t)
    if len(values) != len(pts):
        raise ValueError(f"masked_sum: {len(values)} terms, {len(pts)} masks")
    shape, (J, n) = tuple(v0.shape), v0.shape[-2:]
    lead = shape[1:-2]
    M = int(np.prod(lead)) if lead else 1
    if shape[0] != 2 or t.q.shape[0] != J:
        raise ValueError(f"masked_sum: terms {shape} against tables of "
                         f"{t.q.shape[0]} rows")
    threads = _mac_threads(n)
    out = torch.empty((2, M, J, n), dtype=torch.int32, device=v0.device)
    words = [0] * (6 * MAC_CHUNK)
    for i in range(0, len(values), MAC_CHUNK):
        vs, ps = values[i:i + MAC_CHUNK], pts[i:i + MAC_CHUNK]
        for k, (v, p) in enumerate(zip(vs, ps)):
            _cuda.check_operand(v, "term", shape, contiguous=False)
            _cuda.check_operand(p, "mask", (J, n), contiguous=False)
            _check_aligned(p, "mask")
            if p.stride(1) != 1 or p.stride(0) % 4:
                raise ValueError(f"masked_sum: a mask's strides "
                                 f"{p.stride()} do not give rows of "
                                 "contiguous words on 16 bytes")
            words[k::MAC_CHUNK] = (v.data_ptr(), p.data_ptr(),
                                   *_term_rows(v, M, J, n), p.stride(0))
        desc = (ctypes.c_longlong * len(words))(*words)
        _cuda.call("mac", "masked_sum", ctypes.addressof(desc), len(vs),
                   t.q, t.ratio0, t.ratio1, out, M, J, n, threads, int(i > 0))
    _cuda.count("mac")
    telemetry.count("mac.kernel")
    return out.reshape(2, *lead, J, n)
