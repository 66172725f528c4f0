"""Modular arithmetic on residue tensors, for both engine words.

Counterpart of ``fhe_gpt2_tpu/core/modmath.py``. The word follows the
modulus chain, as the JAX module's does (``word_dtype``), and every op here
dispatches on the operand's dtype:

* **int32** holds the uint32 engine (every modulus < 2**31). CPU PyTorch has
  no uint32 add, compare or remainder, so the plain ops widen to int64 for
  products (below 2**62, exact) and take the remainder. The CUDA kernels do
  the same arithmetic with ``__umulhi`` Shoup and 64-bit Barrett products
  (``csrc/modarith.cuh``).
* **int64** holds the u64 engine (any modulus >= 2**31; all < 2**62). The
  JAX module multiplies 32-bit halves in wrapping uint64 words; signed
  int64 overflow is undefined in the C++ PyTorch is built from, so no op
  here may wrap. Operands below 2**62 split into 31-bit halves, whose four
  partial products stay below 2**62 and whose middle sum stays below 2**63;
  the 124-bit product is held exactly as (hi, lo) in base 2**62
  (``mulwide``) and reduced exactly: Barrett with floor(2**124/q) restated
  from the JAX tables' 64-bit ratio words, or Shoup with the tables' 64-bit
  Shoup word.

Every op returns the canonical residue in [0, q) (only ``*_lazy`` returns
[0, 2q)), so the results equal the JAX package's bit for bit whichever
exact method computes them. Operands are residues ``[..., L, N]`` with
per-limb constants ``[L, 1]`` broadcasting over coefficients.
"""

from __future__ import annotations

import numpy as np
import torch

from . import seal

_M31 = (1 << 31) - 1
_M32 = (1 << 32) - 1
_M60 = (1 << 60) - 1
_M62 = (1 << 62) - 1
_B62 = 1 << 62
MAX_MODULUS = 1 << 62          # every modulus of a chain lies below this


def word_dtype(moduli) -> np.dtype:
    """The engine word dtype for a modulus chain (host helper)."""
    return np.dtype(np.uint32) if max(moduli) < (1 << 31) else np.dtype(np.uint64)


def word_bits_of(dtype) -> int:
    return 32 if np.dtype(dtype) == np.uint32 else 64


def torch_word(word) -> torch.dtype:
    """The tensor dtype that holds a word: int32 for uint32, int64 for
    uint64 (the same bits)."""
    return torch.int32 if word_bits_of(word) == 32 else torch.int64


def _wide(x: torch.Tensor) -> bool:
    return x.dtype == torch.int64


def add_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    # a - (q - b) lies in (-q, q): no overflow in either word, unlike a + b.
    s = a - (q - b)
    return torch.where(s < 0, s + q, s)


def sub_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    d = a - b
    return torch.where(d < 0, d + q, d)


def neg_mod(a: torch.Tensor, q) -> torch.Tensor:
    return torch.where(a == 0, a, q - a)


# ---------------------------------------------------------------------------
# The 64-bit word: exact products in base 2**62
# ---------------------------------------------------------------------------

def mulwide(a: torch.Tensor, b) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with a·b = hi·2**62 + lo, lo < 2**62, for int64 a, b in
    [0, 2**62). Every intermediate stays below 2**63."""
    a1, a0 = a >> 31, a & _M31
    b1, b0 = b >> 31, b & _M31
    mid = a1 * b0 + a0 * b1                       # < 2**63
    lo = a0 * b0 + ((mid & _M31) << 31)           # < 2**63
    hi = a1 * b1 + (mid >> 31) + (lo >> 62)
    return hi, lo & _M62


def _mulhi64(a: torch.Tensor, s) -> torch.Tensor:
    """floor(a·s / 2**64) for a in [0, 2**62) and s any uint64 word held in
    int64 bits (a Shoup word): the JAX ``mulhi`` of the 64-bit engine."""
    s_hi = (s >> 62) & 3                          # s = s_hi·2**62 + s_lo
    h, _ = mulwide(a, s & _M62)
    # a·s = (h + a·s_hi)·2**62 + lo; the quotient by 4 of h + a·s_hi, split
    # so that no term reaches 2**63.
    return (h >> 2) + (a >> 2) * s_hi + (((h & 3) + (a & 3) * s_hi) >> 2)


def _sub_wide(h1, l1, h2, l2) -> torch.Tensor:
    """(h1·2**62 + l1) - (h2·2**62 + l2) for a difference known to lie in
    [0, 2**63): h1 - h2 - 1 is -1, 0 or 1 and l1 - l2 + 2**62 in (0, 2**63)."""
    return (h1 - h2 - 1) * _B62 + (l1 - l2 + _B62)


def _below(r: torch.Tensor, q) -> torch.Tensor:
    return torch.where(r >= q, r - q, r)


def _ratio62(ratio0, ratio1):
    """(lo, hi) words of floor(2**124/q) in base 2**62, from the tables'
    (lo, hi) 64-bit words of floor(2**128/q): the same number shifted
    right by four."""
    r1 = (ratio1 >> 2) & _M62
    r0 = ((ratio1 & 3) << 60) | ((ratio0 >> 4) & _M60)
    return r0, r1


def barrett_reduce_wide(hi: torch.Tensor, lo: torch.Tensor, q,
                        ratio0, ratio1) -> torch.Tensor:
    """hi·B + lo mod q for hi < q: B = 2**62 on the int64 word (the pair
    ``mulwide`` returns), B = 2**32 on the int32 word (uint32 words held in
    int32 bits). ratio0/ratio1 are the tables' Barrett words of q.

    The int64 route is the JAX ``barrett_reduce_wide`` restated in base
    2**62: its quotient estimate is floor(x·floor(2**124/q) / 2**124), at
    most one below the true quotient and below q, so every partial product
    fits and the remainder lies in [0, 2q) before one subtraction."""
    if not _wide(lo):
        x = ((hi.long() & _M32) << 32) | (lo.long() & _M32)
        return torch.remainder(x, q).to(torch.int32)
    r0, r1 = _ratio62(ratio0, ratio1)
    carry, _ = mulwide(lo, r0)
    h1, l1 = mulwide(lo, r1)
    tmp1 = l1 + carry
    tmp3 = h1 + (tmp1 >> 62)
    h2, l2 = mulwide(hi, r0)
    carry2 = h2 + (((tmp1 & _M62) + l2) >> 62)
    qhat = hi * r1 + tmp3 + carry2
    h3, l3 = mulwide(qhat, q)
    return _below(_sub_wide(hi, lo, h3, l3), q)


def mul_mod(a: torch.Tensor, b: torch.Tensor, q, ratio0=None,
            ratio1=None) -> torch.Tensor:
    """a*b mod q for a, b < q. The int32 word reduces the widened product
    exactly (the kernels use the Barrett ratio words of the tables); the
    int64 word needs the tables' Barrett words ratio0/ratio1."""
    if not _wide(a):
        return torch.remainder(a.long() * b.long(), q).to(torch.int32)
    if ratio0 is None or ratio1 is None:
        raise ValueError("mul_mod on the 64-bit word needs the Barrett "
                         "ratio words of q")
    hi, lo = mulwide(a, b)
    return barrett_reduce_wide(hi, lo, q, ratio0, ratio1)


def mul_mod_shoup_lazy(a: torch.Tensor, w, w_shoup, q) -> torch.Tensor:
    """a*w mod q in [0, 2q) for a precomputed constant w with its Shoup word
    w_shoup = floor(w·2^w/q): the JAX lazy product, word for word (on the
    int32 word the result may pass 2**31 and is held as uint32 bits)."""
    if not _wide(a):
        qhat = ((a.long() & _M32) * (w_shoup.long() & _M32)) >> 32
        r = a.long() * w.long() - qhat * q.long()
        return (r - ((r >> 31) << 32)).to(torch.int32)
    qhat = _mulhi64(a, w_shoup)
    h1, l1 = mulwide(a, w)
    h2, l2 = mulwide(qhat, q)
    return _sub_wide(h1, l1, h2, l2)


def mul_mod_shoup(a: torch.Tensor, w, w_shoup, q) -> torch.Tensor:
    """a*w mod q for a precomputed constant w (w_shoup = floor(w·2^w/q)).
    The int32 plain version reduces the exact product; the int64 word takes
    the Shoup quotient and one subtraction."""
    if not _wide(a):
        return torch.remainder(a.long() * w.long(), q).to(torch.int32)
    return _below(mul_mod_shoup_lazy(a, w, w_shoup, q), q)


def reduce_mod(a: torch.Tensor, q) -> torch.Tensor:
    """a mod q for any non-negative a (the JAX ``barrett_reduce``); the
    int64 remainder is exact on both devices."""
    if _wide(a):
        return torch.remainder(a, q)
    return torch.remainder(a.long(), q).to(torch.int32)


def barrett_reduce(a: torch.Tensor, q, ratio1=None) -> torch.Tensor:
    """The JAX name of ``reduce_mod`` (its ratio word is not needed)."""
    return reduce_mod(a, q)


def lazy_group(dtype) -> int:
    """Addends below the word's largest modulus that an int64 sum takes
    before it must be reduced: the port's counterpart of the JAX
    ``lazy_group``. The int32 word widens to int64 (2**32 addends below
    2**31); the int64 word holds residues below 2**62, so two."""
    bound = (1 << 31) if dtype == torch.int32 else MAX_MODULUS
    return ((1 << 63) - 1) // (bound - 1)


def mod_sum(x: torch.Tensor, q, axis: int = 0) -> torch.Tensor:
    """Sum residues along `axis` mod q (``evaluator.mod_sum``). An int64 sum
    of int32 residues cannot overflow and is reduced once; int64 residues
    fold in a tree of ``add_mod`` (``lazy_group`` is 2). Either way the
    result is the canonical residue the JAX grouped Barrett fold returns."""
    if not _wide(x):
        return torch.remainder(x.long().sum(dim=axis), q).to(torch.int32)
    x = x.movedim(axis, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        s = add_mod(x[:h], x[h:2 * h], q)
        x = torch.cat([s, x[2 * h:]]) if x.shape[0] % 2 else s
    return x[0]


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


def word_tensor(values, device, shape=None, word=np.uint32) -> torch.Tensor:
    """Host words -> a tensor holding the same bit pattern: uint32 words in
    int32, uint64 words in int64.

    Residues keep their value; Shoup/Barrett words at or above 2**31
    (2**63) read back as negative on the host and as the unsigned word in a
    kernel or in the int64 route's shifts and masks. Not inside a sealed
    call's sealed run (``core/seal.py``): it copies from the host."""
    seal.host_copy("word_tensor")
    a = np.asarray(values, dtype=np.uint64)
    if word_bits_of(word) == 32:
        a = a.astype(np.uint32)
    a = np.ascontiguousarray(a)
    if shape is not None:
        a = a.reshape(shape)
    signed = np.int32 if a.dtype == np.uint32 else np.int64
    return torch.from_numpy(a.view(signed).copy()).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> uint32 numpy array with the same bits."""
    seal.host_copy("to_numpy_u32")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def to_numpy_u64(t: torch.Tensor) -> np.ndarray:
    """int64 word tensor -> uint64 numpy array with the same bits."""
    seal.host_copy("to_numpy_u64")
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def to_numpy_word(t: torch.Tensor) -> np.ndarray:
    """A word tensor of either engine as the JAX package's array: uint32
    for int32, uint64 for int64."""
    return to_numpy_u64(t) if _wide(t) else to_numpy_u32(t)
