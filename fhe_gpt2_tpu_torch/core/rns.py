"""RNS base tooling: approximate base conversion, exact divide-and-round by
the last modulus, and the one-shot HPS mod-down by a product of primes.

Counterpart of ``fhe_gpt2_tpu/core/rns.py`` (``:64-245``), as plain
PyTorch ops on int32 residues. Tables are built host-side with exact
Python ints and live on the context's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import primes
from .modmath import add_mod, sub_mod, mul_mod, mul_mod_shoup, reduce_mod, \
    barrett_ratio, shoup, word_tensor


def _wcol(vals, device) -> torch.Tensor:
    return word_tensor(vals, device, (-1, 1))


@dataclass(frozen=True)
class BaseConvTables:
    """Constants for approximate conversion from base `src` to base `dst`.

    out_j = Σ_i [x_i · (S/s_i)^{-1}]_{s_i} · (S/s_i) mod d_j   (+ small k·S slack)
    """

    src: tuple
    dst: tuple
    inv_punc: torch.Tensor         # [ks,1]  [(S/s_i)^{-1}]_{s_i}
    inv_punc_shoup: torch.Tensor   # [ks,1]
    src_q: torch.Tensor            # [ks,1]
    punc_mod_dst: torch.Tensor     # [ks,kd] (S/s_i) mod d_j
    dst_q: torch.Tensor            # [kd,1]
    dst_r0: torch.Tensor           # [kd,1]
    dst_r1: torch.Tensor           # [kd,1]


def make_base_conv(src: list[int], dst: list[int],
                   device="cuda") -> BaseConvTables:
    S = 1
    for s in src:
        S *= s
    inv_punc = [primes.mod_inverse((S // s) % s, s) for s in src]
    punc_mod = np.array([[(S // s) % d for d in dst] for s in src],
                        dtype=np.uint64).reshape(len(src), len(dst))
    return BaseConvTables(
        src=tuple(src), dst=tuple(dst),
        inv_punc=_wcol(inv_punc, device),
        inv_punc_shoup=_wcol([shoup(v, s) for v, s in zip(inv_punc, src)],
                             device),
        src_q=_wcol(src, device),
        punc_mod_dst=word_tensor(punc_mod, device),
        dst_q=_wcol(dst, device),
        dst_r0=_wcol([barrett_ratio(d)[0] for d in dst], device),
        dst_r1=_wcol([barrett_ratio(d)[1] for d in dst], device),
    )


def base_convert_mac(y: torch.Tensor, t: BaseConvTables) -> torch.Tensor:
    """MAC half of a base conversion from precomputed y_i = [x_i·(S/s_i)^{-1}]:
    out[..., j, n] = Σ_i y[..., i, n] · (S/s_i) mod d_j."""
    acc = None
    for i in range(len(t.src)):
        w = t.punc_mod_dst[i].reshape(-1, 1)                 # [kd, 1]
        term = mul_mod(y[..., i:i + 1, :], w, t.dst_q)       # [..., kd, N]
        acc = term if acc is None else add_mod(acc, term, t.dst_q)
    return acc


def base_convert(x: torch.Tensor, t: BaseConvTables) -> torch.Tensor:
    """Approximate RNS base conversion of coefficient-domain x[..., ks, N]."""
    y = mul_mod_shoup(x, t.inv_punc, t.inv_punc_shoup, t.src_q)
    return base_convert_mac(y, t)


@dataclass(frozen=True)
class DropLastTables:
    """Constants for exact centered divide-and-round by the last modulus."""

    q_last: int
    half: int                       # q_last >> 1
    half_mod: torch.Tensor          # [k,1]  (q_last>>1) mod q_j
    inv_qlast: torch.Tensor         # [k,1]  q_last^{-1} mod q_j
    inv_qlast_shoup: torch.Tensor
    q: torch.Tensor                 # [k,1] remaining moduli


def make_drop_last(remaining: list[int], q_last: int,
                   device="cuda") -> DropLastTables:
    half = q_last >> 1
    inv = [primes.mod_inverse(q_last % q, q) for q in remaining]
    return DropLastTables(
        q_last=q_last,
        half=half,
        half_mod=_wcol([half % q for q in remaining], device),
        inv_qlast=_wcol(inv, device),
        inv_qlast_shoup=_wcol([shoup(v, q) for v, q in zip(inv, remaining)],
                              device),
        q=_wcol(remaining, device),
    )


@dataclass(frozen=True)
class ModDownTables:
    """Constants for ONE-SHOT divide-and-round by P = prod(special primes)
    (Halevi-Polyakov-Shoup approximate mod-down; see the JAX module)."""

    bct: BaseConvTables          # src = special primes, dst = remaining q
    half_p: torch.Tensor         # [k,1]  (P>>1) mod p_i
    half_q: torch.Tensor         # [l,1]  (P>>1) mod q_j
    inv_p: torch.Tensor          # [l,1]  P^{-1} mod q_j
    inv_p_shoup: torch.Tensor    # [l,1]
    p_invf: torch.Tensor         # [k,1]  float32 1/p_i (overflow estimator)
    p_mod_q: torch.Tensor        # [l,1]  P mod q_j


def make_mod_down(remaining: list[int], specials: list[int],
                  device="cuda") -> ModDownTables:
    P = 1
    for p in specials:
        P *= p
    half = P >> 1
    inv = [primes.mod_inverse(P % q, q) for q in remaining]
    return ModDownTables(
        bct=make_base_conv(specials, remaining, device),
        half_p=_wcol([half % p for p in specials], device),
        half_q=_wcol([half % q for q in remaining], device),
        inv_p=_wcol(inv, device),
        inv_p_shoup=_wcol([shoup(v, q) for v, q in zip(inv, remaining)],
                          device),
        p_invf=torch.tensor(np.array([1.0 / p for p in specials],
                                     dtype=np.float32).reshape(-1, 1),
                            device=device),
        p_mod_q=_wcol([P % q for q in remaining], device),
    )


def mod_down_convert(a: torch.Tensor, t: ModDownTables) -> torch.Tensor:
    """Centered conversion of a[..., k, N] (residues mod the special primes)
    into the destination base, with the float32 correction of the fast
    conversion's +u·P overflow. Returns the image of the centered
    representative minus P/2.

    The float32 sum runs i = 0..k-1 sequentially with separate multiply and
    add (no ``torch.sum``), the order of the CUDA kernel in
    ``csrc/moddown.cu``; the JAX ``mod_down_convert`` sums with ``jnp.sum``
    and may differ by one unit where f sits on a floor boundary."""
    a = add_mod(a, t.half_p, t.bct.src_q)
    v = mul_mod_shoup(a, t.bct.inv_punc, t.bct.inv_punc_shoup, t.bct.src_q)
    img = base_convert_mac(v, t.bct)
    k = v.shape[-2]
    f = None
    for i in range(k):
        fi = v[..., i:i + 1, :].to(torch.float32) * t.p_invf[i]
        f = fi if f is None else f + fi
    u = torch.clamp(torch.floor(f), 0.0, float(k - 1)).to(torch.int32)
    img = sub_mod(img, mul_mod(u, t.p_mod_q, t.bct.dst_q), t.bct.dst_q)
    return sub_mod(img, t.half_q, t.bct.dst_q)


def divide_round_last(x: torch.Tensor, last: torch.Tensor,
                      t: DropLastTables) -> torch.Tensor:
    """Exact centered divide-and-round of coefficient-domain x[..., k, N] by
    its dropped last limb last[..., N]."""
    shifted = add_mod(last, t.half, t.q_last)
    img = reduce_mod(shifted[..., None, :], t.q)
    img = sub_mod(img, t.half_mod, t.q)
    diff = sub_mod(x, img, t.q)
    return mul_mod_shoup(diff, t.inv_qlast, t.inv_qlast_shoup, t.q)
