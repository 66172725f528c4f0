"""Negacyclic NTT over RNS limb towers (uint32 engine).

Counterpart of ``fhe_gpt2_tpu/core/ntt.py``: the same tables, the same
butterfly network and the same output order (slot j holds the evaluation at
ψ^(2·br(j)+1), ``point_exponents``), so Galois maps and the canonical
embedding are shared with the JAX package.

``ntt``/``intt`` route by device: a CUDA tensor goes to the hand-written
kernel in ``core/tntt.py`` for every N from 2048 to 65536; a CPU tensor goes
to the plain stage loop ``_ntt_stages``/``_intt_stages``.

Conventions: ``x`` is ``int32[..., L, N]`` residues, limb axis second to
last, leading batch dims flattened by the kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import primes
from .modmath import add_mod, sub_mod, mul_mod_shoup, word_tensor


def bit_reverse(x: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


def _bit_reverse_array(logn: int) -> np.ndarray:
    """br(i) over logn bits for i in [0, 2**logn), vectorised."""
    i = np.arange(1 << logn, dtype=np.int64)
    out = np.zeros_like(i)
    for b in range(logn):
        out |= ((i >> b) & 1) << (logn - 1 - b)
    return out


@dataclass(frozen=True)
class NttTables:
    """Per-modulus-set NTT constants on one device.

    Shapes: moduli/Barrett/N^-1 columns ``[L, 1]``, twiddles ``[L, N]``,
    all int32 (Shoup and Barrett words keep their uint32 bits). The TPU
    four-step tables (``fs``) of the JAX package have no counterpart: the
    CUDA kernel reads ``roots``/``inv_roots`` directly."""

    n: int
    logn: int
    q: torch.Tensor            # [L, 1]
    ratio0: torch.Tensor       # [L, 1] floor(2^64/q) low word
    ratio1: torch.Tensor       # [L, 1] floor(2^64/q) high word
    roots: torch.Tensor        # [L, N] ψ^{br(i)}
    roots_shoup: torch.Tensor
    inv_roots: torch.Tensor    # [L, N] ψ^{-br(i)}
    inv_roots_shoup: torch.Tensor
    n_inv: torch.Tensor        # [L, 1] N^{-1} mod q
    n_inv_shoup: torch.Tensor
    moduli: tuple = field(default_factory=tuple)
    psi: tuple = field(default_factory=tuple)

    @property
    def device(self) -> torch.device:
        return self.q.device

    def slice(self, idx: list[int]) -> "NttTables":
        """Tables restricted to a subset of limbs (contiguous copies, so the
        kernels can take them as they are)."""
        i = torch.as_tensor(list(idx), dtype=torch.long, device=self.device)

        def s(x):
            return x.index_select(0, i).contiguous()

        return NttTables(
            n=self.n, logn=self.logn,
            q=s(self.q), ratio0=s(self.ratio0), ratio1=s(self.ratio1),
            roots=s(self.roots), roots_shoup=s(self.roots_shoup),
            inv_roots=s(self.inv_roots), inv_roots_shoup=s(self.inv_roots_shoup),
            n_inv=s(self.n_inv), n_inv_shoup=s(self.n_inv_shoup),
            moduli=tuple(self.moduli[j] for j in idx),
            psi=tuple(self.psi[j] for j in idx),
        )


def _powers(base: int, count: int, q: int) -> np.ndarray:
    """[base^e mod q for e in range(count)] as uint64 (q < 2**31, so every
    product of two residues fits), by repeated doubling of the prefix."""
    out = np.ones(count, dtype=np.uint64)
    k = 1
    step = base % q                         # base^k
    qq = np.uint64(q)
    while k < count:
        m = min(k, count - k)
        out[k:k + m] = out[:m] * np.uint64(step) % qq
        k += m
        step = step * step % q
    return out


def make_ntt_tables(moduli: list[int], n: int,
                    device: str | torch.device = "cuda") -> NttTables:
    """Precompute twiddle tables for each modulus (host, exact), then move
    them to `device`. Bit-identical to the JAX package's tables."""
    logn = n.bit_length() - 1
    assert 1 << logn == n
    if max(moduli) >= (1 << 31):
        raise NotImplementedError("only the uint32 engine (moduli < 2**31) "
                                  "is ported")
    L = len(moduli)
    br = _bit_reverse_array(logn)
    roots = np.zeros((L, n), dtype=np.uint64)
    roots_sh = np.zeros((L, n), dtype=np.uint64)
    inv_roots = np.zeros((L, n), dtype=np.uint64)
    inv_roots_sh = np.zeros((L, n), dtype=np.uint64)
    cols = {k: [] for k in ("q", "r0", "r1", "ninv", "ninv_sh")}
    psis = []
    for li, q in enumerate(moduli):
        psi = primes.root_of_unity(2 * n, q)
        psis.append(psi)
        inv_psi = primes.mod_inverse(psi, q)
        qq = np.uint64(q)
        # Only exponents < n are read (br(i) < n), so n powers suffice.
        pw = _powers(psi, n, q)[br]
        ipw = _powers(inv_psi, n, q)[br]
        roots[li] = pw
        roots_sh[li] = (pw << np.uint64(32)) // qq
        inv_roots[li] = ipw
        inv_roots_sh[li] = (ipw << np.uint64(32)) // qq
        rat = (1 << 64) // q
        iv = primes.mod_inverse(n, q)
        cols["q"].append(q)
        cols["r0"].append(rat & 0xFFFFFFFF)
        cols["r1"].append(rat >> 32)
        cols["ninv"].append(iv)
        cols["ninv_sh"].append((iv << 32) // q)

    def col(v):
        return word_tensor(v, device, (L, 1))

    return NttTables(
        n=n, logn=logn,
        q=col(cols["q"]), ratio0=col(cols["r0"]), ratio1=col(cols["r1"]),
        roots=word_tensor(roots, device), roots_shoup=word_tensor(roots_sh, device),
        inv_roots=word_tensor(inv_roots, device),
        inv_roots_shoup=word_tensor(inv_roots_sh, device),
        n_inv=col(cols["ninv"]), n_inv_shoup=col(cols["ninv_sh"]),
        moduli=tuple(moduli), psi=tuple(psis),
    )


def ntt(x: torch.Tensor, t: NttTables) -> torch.Tensor:
    """Forward negacyclic NTT along the last axis, batched over [..., L, N]."""
    from .tntt import ntt_forward
    return ntt_forward(x, t)


def intt(x: torch.Tensor, t: NttTables) -> torch.Tensor:
    """Inverse negacyclic NTT; returns natural-order coefficients."""
    from .tntt import ntt_inverse
    return ntt_inverse(x, t)


def _ntt_stages(x: torch.Tensor, t: NttTables) -> torch.Tensor:
    """Plain stage-loop forward NTT (``ntt.py:207-225`` of the JAX package)."""
    n, logn = t.n, t.logn
    q = t.q
    for s in range(logn):
        m = 1 << s
        half = n >> (s + 1)
        xv = x.reshape(*x.shape[:-1], m, 2, half)
        w = t.roots[:, m:2 * m, None]                  # [L, m, 1]
        ws = t.roots_shoup[:, m:2 * m, None]
        qq = q[:, :, None]                             # [L, 1, 1]
        u = xv[..., 0, :]
        v = mul_mod_shoup(xv[..., 1, :], w, ws, qq)
        x = torch.stack([add_mod(u, v, qq), sub_mod(u, v, qq)],
                        dim=-2).reshape(x.shape)
    return x


def _intt_stages(x: torch.Tensor, t: NttTables) -> torch.Tensor:
    """Plain stage-loop inverse NTT (``ntt.py:237-255`` of the JAX package)."""
    n, logn = t.n, t.logn
    q = t.q
    for s in range(logn - 1, -1, -1):
        m = 1 << s
        half = n >> (s + 1)
        xv = x.reshape(*x.shape[:-1], m, 2, half)
        w = t.inv_roots[:, m:2 * m, None]
        ws = t.inv_roots_shoup[:, m:2 * m, None]
        qq = q[:, :, None]
        u = xv[..., 0, :]
        v = xv[..., 1, :]
        x = torch.stack(
            [add_mod(u, v, qq), mul_mod_shoup(sub_mod(u, v, qq), w, ws, qq)],
            dim=-2,
        ).reshape(x.shape)
    return mul_mod_shoup(x, t.n_inv, t.n_inv_shoup, q)


def host_ntt(coeffs: list[int], q: int, psi: int) -> list[int]:
    """Python-int oracle: same butterfly network as ``ntt`` for one limb."""
    n = len(coeffs)
    logn = n.bit_length() - 1
    x = list(coeffs)
    for s in range(logn):
        m = 1 << s
        half = n >> (s + 1)
        for i in range(m):
            w = pow(psi, bit_reverse(m + i, logn), q)
            base = i * 2 * half
            for j in range(base, base + half):
                u = x[j]
                v = x[j + half] * w % q
                x[j] = (u + v) % q
                x[j + half] = (u - v) % q
    return x


def host_intt(vals: list[int], q: int, psi: int) -> list[int]:
    """Python-int oracle inverse of ``host_ntt``."""
    n = len(vals)
    logn = n.bit_length() - 1
    inv_psi = primes.mod_inverse(psi, q)
    x = list(vals)
    for s in range(logn - 1, -1, -1):
        m = 1 << s
        half = n >> (s + 1)
        for i in range(m):
            w = pow(inv_psi, bit_reverse(m + i, logn), q)
            base = i * 2 * half
            for j in range(base, base + half):
                u = x[j]
                v = x[j + half]
                x[j] = (u + v) % q
                x[j + half] = (u - v) * w % q
    n_inv = primes.mod_inverse(n, q)
    return [c * n_inv % q for c in x]


def point_exponents(n: int) -> np.ndarray:
    """Exponent e[j] (odd, mod 2N) such that forward-NTT output slot j holds
    the evaluation of the input polynomial at ψ**e[j]: ψ^{2·br(j)+1}."""
    logn = n.bit_length() - 1
    return (2 * _bit_reverse_array(logn) + 1) % (2 * n)


def galois_ntt_permutation(n: int, galois_elt: int) -> np.ndarray:
    """Index map ``perm`` with (x∘X^g in NTT form)[j] = x_ntt[perm[j]]."""
    e = point_exponents(n)
    index_of = np.zeros(2 * n, dtype=np.int64)
    index_of[e] = np.arange(n)
    g = galois_elt % (2 * n)
    return index_of[(g * e) % (2 * n)].astype(np.int32)


def galois_coeff_maps(n: int, galois_elt: int) -> tuple[np.ndarray, np.ndarray]:
    """(src, sign) for coefficient-domain Galois: out[j] = sign[j]·x[src[j]]
    (sign -1 where i·g mod 2n >= n, since X^{n+k} = -X^k)."""
    g = galois_elt % (2 * n)
    i = np.arange(n, dtype=np.int64)
    d = i * g % (2 * n)
    src = np.zeros(n, dtype=np.int32)
    sign = np.zeros(n, dtype=np.int8)
    lo = d < n
    src[d[lo]] = i[lo]
    sign[d[lo]] = 1
    src[d[~lo] - n] = i[~lo]
    sign[d[~lo] - n] = -1
    return src, sign
