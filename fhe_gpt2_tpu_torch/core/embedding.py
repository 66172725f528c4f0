"""Canonical-embedding encode/decode (host side, numpy float64).

The port's own copy of the numpy path of ``fhe_gpt2_tpu/core/embedding.py``.
The evaluation network is the same butterfly graph as the NTT
(core/ntt.py) over C with ζ = exp(iπ/n), so slot j holds m(ζ^{5^j mod 2n})
in exactly the NTT's slot order. Residues come out as uint32 numpy arrays;
``carry``/``modmath.word_tensor`` move them onto a device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .ntt import bit_reverse


@lru_cache(maxsize=None)
def _stage_twiddles(n: int, inverse: bool):
    logn = n.bit_length() - 1
    zeta = np.exp((-1j if inverse else 1j) * np.pi / n)
    out = []
    for s in range(logn):
        m = 1 << s
        ws = np.array(
            [zeta ** bit_reverse(m + i, logn) for i in range(m)],
            dtype=np.complex128,
        ).reshape(m, 1)
        out.append(ws)
    return out


def eval_transform(x: np.ndarray) -> np.ndarray:
    """Coefficients -> evaluations at ζ^{2·br(j)+1}; batched over leading dims."""
    n = x.shape[-1]
    logn = n.bit_length() - 1
    x = np.asarray(x, dtype=np.complex128)
    tw = _stage_twiddles(n, inverse=False)
    for s in range(logn):
        m = 1 << s
        half = n >> (s + 1)
        xv = x.reshape(*x.shape[:-1], m, 2, half)
        u = xv[..., 0, :]
        v = xv[..., 1, :] * tw[s]
        x = np.stack([u + v, u - v], axis=-2).reshape(*x.shape[:-1], n)
    return x


def coeff_transform(x: np.ndarray) -> np.ndarray:
    """Inverse of eval_transform (evaluations -> coefficients)."""
    n = x.shape[-1]
    logn = n.bit_length() - 1
    x = np.asarray(x, dtype=np.complex128)
    tw = _stage_twiddles(n, inverse=True)
    for s in range(logn - 1, -1, -1):
        m = 1 << s
        half = n >> (s + 1)
        xv = x.reshape(*x.shape[:-1], m, 2, half)
        u = xv[..., 0, :]
        v = xv[..., 1, :]
        x = np.stack([u + v, (u - v) * tw[s]], axis=-2).reshape(*x.shape[:-1], n)
    return x / n


def encode_to_coeffs(values: np.ndarray, scale: float, ctx) -> np.ndarray:
    """Complex slot values -> rounded integer coefficients (int64, centered).
    Fewer than n/2 values are replicated cyclically (sparse slots)."""
    slots = ctx.n // 2
    values = np.asarray(values, dtype=np.complex128).ravel()
    if len(values) < slots:
        if slots % len(values):
            raise ValueError(f"{len(values)} values do not divide {slots} slots")
        values = np.tile(values, slots // len(values))
    evals = np.zeros(ctx.n, dtype=np.complex128)
    evals[ctx.slot_to_index] = values * scale
    evals[ctx.conj_slot_to_index] = np.conj(values) * scale
    coeffs = coeff_transform(evals)
    c = np.round(np.real(coeffs))
    if np.max(np.abs(c)) >= 2 ** 62:
        raise ValueError("encoded coefficient too large for int64 path")
    return c.astype(np.int64)


def coeffs_to_rns(coeffs: np.ndarray, ctx, limbs) -> np.ndarray:
    """Centered int64 coefficients -> uint32 RNS residues [len(limbs), n]."""
    out = np.zeros((len(limbs), len(coeffs)), dtype=ctx.word)
    for row, li in enumerate(limbs):
        q = ctx.all_moduli[li]
        out[row] = np.mod(coeffs, np.int64(q)).astype(ctx.word)
    return out


def encode(values, scale: float, ctx, limbs) -> np.ndarray:
    return coeffs_to_rns(encode_to_coeffs(values, scale, ctx), ctx, limbs)


def rns_to_centered_ints(res: np.ndarray, ctx, limbs) -> np.ndarray:
    """uint32[k, n] residues -> exact centered big-int coefficients (object),
    from only as many limbs as a 240-bit magnitude bound needs."""
    need_bits = 240
    use = []
    prod = 1
    for row, li in enumerate(limbs):
        use.append((row, ctx.all_moduli[li]))
        prod *= ctx.all_moduli[li]
        if prod.bit_length() > need_bits:
            break
    P = 1
    for _, q in use:
        P *= q
    acc = np.zeros(res.shape[-1], dtype=object)
    for row, q in use:
        punc = P // q
        inv = pow(punc % q, -1, q)
        t = (res[row].astype(object) * inv) % q
        acc = (acc + t * punc) % P
    return np.where(acc > P // 2, acc - P, acc)


def decode(res: np.ndarray, scale: float, ctx, limbs, num_slots=None) -> np.ndarray:
    """uint32 RNS coefficients -> complex slot values."""
    centered = rns_to_centered_ints(res, ctx, limbs)
    coeffs = centered.astype(np.float64) / scale
    evals = eval_transform(coeffs)
    z = evals[ctx.slot_to_index]
    if num_slots is not None and num_slots < len(z):
        z = z.reshape(-1, num_slots).mean(axis=0)
    return z
