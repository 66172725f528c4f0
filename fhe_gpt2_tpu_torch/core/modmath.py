"""Modular arithmetic on int32 residue tensors (uint32 engine only).

Counterpart of ``fhe_gpt2_tpu/core/modmath.py``. The JAX module computes
Barrett and Shoup products in wrapping uint32 words; CPU PyTorch has no
uint32 add, compare or remainder, so the plain ops here widen to int64 for
products (below 2**62, exact) and take the remainder. Every op returns the
canonical residue in [0, q), so the results equal the JAX package's bit for
bit. The CUDA kernels do the same arithmetic with ``__umulhi`` Shoup and
64-bit Barrett products (``csrc/modarith.cuh``).

Operands are residues ``[..., L, N]`` with per-limb constants ``[L, 1]``
broadcasting over coefficients; a and b are < q < 2**31.
"""

from __future__ import annotations

import numpy as np
import torch


def word_dtype(moduli) -> np.dtype:
    """The engine word dtype for a modulus chain (host helper)."""
    return np.dtype(np.uint32) if max(moduli) < (1 << 31) else np.dtype(np.uint64)


def word_bits_of(dtype) -> int:
    return 32 if np.dtype(dtype) == np.uint32 else 64


def add_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    # a - (q - b) lies in (-q, q): no int32 overflow, unlike a + b.
    s = a - (q - b)
    return torch.where(s < 0, s + q, s)


def sub_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    d = a - b
    return torch.where(d < 0, d + q, d)


def neg_mod(a: torch.Tensor, q) -> torch.Tensor:
    return torch.where(a == 0, a, q - a)


def mul_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """a*b mod q: the widened product reduced exactly (the kernels use the
    Barrett ratio words of the tables)."""
    return torch.remainder(a.long() * b.long(), q).to(torch.int32)


def mul_mod_shoup(a: torch.Tensor, w, w_shoup, q) -> torch.Tensor:
    """a*w mod q for a precomputed constant w (w_shoup = floor(w·2^32/q) is
    what the kernels use; the plain version reduces the exact product)."""
    return torch.remainder(a.long() * w.long(), q).to(torch.int32)


def reduce_mod(a: torch.Tensor, q) -> torch.Tensor:
    """a mod q for any non-negative a (the JAX ``barrett_reduce``)."""
    return torch.remainder(a.long(), q).to(torch.int32)


def mod_sum(x: torch.Tensor, q, axis: int = 0) -> torch.Tensor:
    """Sum residues along `axis` mod q (``evaluator.mod_sum``). An int64 sum
    of < 2**32 addends below 2**31 cannot overflow; the remainder is the
    canonical residue the JAX grouped Barrett fold returns."""
    return torch.remainder(x.long().sum(dim=axis), q).to(torch.int32)


# ---------------------------------------------------------------------------
# Host-side constant precomputation (Python ints; exact).
# ---------------------------------------------------------------------------

def barrett_ratio(q: int, word_bits: int = 32) -> tuple[int, int]:
    """(lo, hi) words of floor(2**(2w) / q)."""
    r = (1 << (2 * word_bits)) // q
    mask = (1 << word_bits) - 1
    return r & mask, r >> word_bits


def shoup(w: int, q: int, word_bits: int = 32) -> int:
    """floor(w * 2**w / q) for w < q."""
    return (w << word_bits) // q


def word_tensor(values, device, shape=None) -> torch.Tensor:
    """uint32 host values -> int32 tensor holding the same bit pattern.

    Residues (< 2**31) keep their value; Shoup/Barrett words >= 2**31 read
    back as negative int32 on the host and as the uint32 word in a kernel."""
    a = np.ascontiguousarray(np.asarray(values, dtype=np.uint64).astype(np.uint32))
    if shape is not None:
        a = a.reshape(shape)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> uint32 numpy array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
