"""Key generation: sparse-ternary secret, public key, relinearization and
Galois key-switching keys (hybrid scheme, digits of alpha = k_sp limbs).

Counterpart of ``fhe_gpt2_tpu/core/keys.py``. Sampling runs host-side with
the numpy RNG (or the SHAKE-256 CSPRNG of ``core/csprng.py``) and draws in
the same order as the JAX package, so the same seed gives the same keys
whatever the word; the NTT and the modular products run on ``ctx.device``.
All keys are stored NTT-form in the chain's word (int32 residues for
uint32 chains, int64 for u64 chains).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import ntt as nttmod, seal
from .context import CkksContext
from .modmath import add_mod, neg_mod, mul_mod, mul_mod_shoup, shoup, \
    word_dtype, word_tensor


# ---------------------------------------------------------------------------
# Host-side samplers (numpy RNG): the JAX package's, call for call.
# ---------------------------------------------------------------------------

def _to_rns(signed: np.ndarray, moduli: list[int]) -> np.ndarray:
    """Small signed int64 coefficients -> word-dtype [L, N] residues."""
    dt = word_dtype(moduli)
    out = np.zeros((len(moduli), signed.shape[-1]), dtype=dt)
    for i, q in enumerate(moduli):
        out[i] = np.mod(signed, np.int64(q)).astype(dt)
    return out


def sample_ternary(rng: np.random.Generator, n: int, hamming_weight: int = 0):
    """Ternary secret coefficients; exactly h nonzero ±1 entries if h > 0."""
    if hamming_weight:
        c = np.zeros(n, dtype=np.int64)
        pos = rng.choice(n, size=hamming_weight, replace=False)
        c[pos] = rng.integers(0, 2, size=hamming_weight) * 2 - 1
        return c
    return rng.integers(-1, 2, size=n).astype(np.int64)


def sample_gaussian(rng: np.random.Generator, n: int, std: float = 3.2):
    return np.round(rng.normal(0.0, std, size=n)).astype(np.int64)


def sample_uniform_rns(rng: np.random.Generator, n: int, moduli: list[int]):
    dt = word_dtype(moduli)
    out = np.zeros((len(moduli), n), dtype=dt)
    for i, q in enumerate(moduli):
        out[i] = rng.integers(0, q, size=n, dtype=np.uint64).astype(dt)
    return out


# ---------------------------------------------------------------------------
# Key containers
# ---------------------------------------------------------------------------

@dataclass
class SecretKey:
    ntt: torch.Tensor      # words [L+k, N], NTT form over the full basis
    coeffs: np.ndarray     # int64 [N] ternary (host)


@dataclass
class PublicKey:
    data: torch.Tensor     # words [2, L+k, N] NTT form (b, a) at key level


@dataclass
class KSwitchKey:
    """data[digit] = words [2, L+k, N] NTT form; digit j covers the limb
    group [j*alpha, (j+1)*alpha)."""
    data: torch.Tensor     # words [num_digits, 2, L+k, N]
    # The chain limbs of data's rows where it holds only some (a mesh
    # position's key rows, ``parallel/limbs.py``); None: all, in order.
    limbs: tuple | None = None
    # Active digits/limbs per level in the kernel's [2, D, J, N] layout,
    # cut once and reused by every key switch at that level.
    _sliced: dict = field(default_factory=dict, repr=False, compare=False)

    def sliced(self, key_limbs: tuple, D: int) -> torch.Tensor:
        k = (key_limbs, D)
        s = seal.current()
        if k not in self._sliced:
            if s is not None:
                s.miss(f"key slice of {len(key_limbs)} limbs")
            rows = (key_limbs if self.limbs is None
                    else [self.limbs.index(j) for j in key_limbs])
            idx = torch.as_tensor(rows, dtype=torch.long,
                                  device=self.data.device)
            self._sliced[k] = (self.data[:D].index_select(2, idx)
                               .transpose(0, 1).contiguous())
        if s is not None:
            # The sealed call holds what its program reads: release_caches
            # may clear _sliced while the call lives.
            s.hold(self._sliced[k])
        return self._sliced[k]


@dataclass
class GaloisKeys:
    keys: dict = field(default_factory=dict)   # galois_elt -> KSwitchKey

    def __contains__(self, elt):
        return elt in self.keys

    def __getitem__(self, elt) -> KSwitchKey:
        return self.keys[elt]

    def step_set(self, ctx) -> frozenset:
        """Rotation steps covered by the held keys (for multi-hop planning)."""
        return frozenset(
            s for s in (ctx.step_from_elt(e) for e in self.keys)
            if s is not None)


def digit_steps(slots: int, base: int = 16) -> list[int]:
    """Base-`base` digit rotation set {j·base^k, 0<j<base}."""
    out = set()
    b = 1
    while b < slots:
        for j in range(1, base):
            s = j * b
            if s < slots:
                out.add(s)
        b *= base
    return sorted(out)


def make_rng(seed: int, secure: bool, rng):
    """The sampler the key generator and the encryptor draw from: ``rng``
    if given, else a SHAKE-256 CSPRNG with a fresh os.urandom seed when
    ``secure``, else seeded numpy PCG (reproducible tests and benches)."""
    if rng is not None:
        return rng
    if secure:
        from .csprng import ShakeRng
        return ShakeRng()
    return np.random.default_rng(seed)


class KeyGenerator:
    def __init__(self, ctx: CkksContext, seed: int = 0, secure: bool = False,
                 rng=None):
        self.ctx = ctx
        self.rng = make_rng(seed, secure, rng)
        s = sample_ternary(self.rng, ctx.n, ctx.params.hamming_weight)
        tables = ctx.tables(tuple(range(len(ctx.all_moduli))))
        s_rns = self._words(_to_rns(s, ctx.all_moduli))
        self.secret = SecretKey(ntt=nttmod.ntt(s_rns, tables), coeffs=s)
        self._tables_all = tables

    def _words(self, host, shape=None) -> torch.Tensor:
        return word_tensor(host, self.ctx.device, shape, self.ctx.word)

    def _mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        t = self._tables_all
        return mul_mod(a, b, t.q, t.ratio0, t.ratio1)

    def _rlwe(self, a: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        """b = -(a·s) + NTT(e) over the full basis, batched over leading dims."""
        t = self._tables_all
        return add_mod(neg_mod(self._mul(a, self.secret.ntt), t.q),
                       nttmod.ntt(e, t), t.q)

    def public_key(self) -> PublicKey:
        ctx = self.ctx
        a = self._words(sample_uniform_rns(self.rng, ctx.n, ctx.all_moduli))
        e = self._words(_to_rns(sample_gaussian(self.rng, ctx.n,
                                                ctx.params.error_std),
                                ctx.all_moduli))
        return PublicKey(data=torch.stack([self._rlwe(a, e), a]))

    def _kswitch_key(self, s_src_ntt: torch.Tensor) -> KSwitchKey:
        """Key-switching key from s_src to the secret: one digit per group
        of alpha ciphertext limbs; digit j holds (-a_j·s + e_j + P·s_src on
        its own limbs, a_j)."""
        ctx = self.ctx
        t = self._tables_all
        D = ctx.num_digits(ctx.L)
        P = 1
        for p in ctx.special:
            P *= p
        a = np.stack([sample_uniform_rns(self.rng, ctx.n, ctx.all_moduli)
                      for _ in range(D)])
        e = np.stack([
            _to_rns(sample_gaussian(self.rng, ctx.n, ctx.params.error_std),
                    ctx.all_moduli) for _ in range(D)])
        a = self._words(a)
        b = self._rlwe(a, self._words(e))
        p_factor = self._words([P % q for q in ctx.all_moduli], (-1, 1))
        p_sh = self._words([shoup(P % q, q, ctx.word_bits)
                            for q in ctx.all_moduli], (-1, 1))
        own = np.zeros((D, len(ctx.all_moduli), 1), dtype=bool)
        for j, g in enumerate(ctx.digit_groups(ctx.L)):
            own[j, list(g)] = True
        own = torch.from_numpy(own).to(ctx.device)
        term = mul_mod_shoup(s_src_ntt, p_factor, p_sh, t.q)     # [L+k, N]
        b = torch.where(own, add_mod(b, term[None], t.q), b)
        return KSwitchKey(data=torch.stack([b, a], dim=1))       # [D,2,L+k,N]

    def relin_key(self) -> KSwitchKey:
        return self._kswitch_key(self._mul(self.secret.ntt, self.secret.ntt))

    def galois_key(self, galois_elt: int) -> KSwitchKey:
        perm = self.ctx.galois_perm(galois_elt)
        return self._kswitch_key(self.secret.ntt.index_select(-1, perm))

    def galois_keys(self, steps: list[int], conjugate: bool = False) -> GaloisKeys:
        """Keys for a set of rotation steps (and optionally conjugation)."""
        out = GaloisKeys()
        elts = {self.ctx.galois_elt_from_step(s) for s in steps
                if s % (self.ctx.n // 2) != 0}
        if conjugate:
            elts.add(self.ctx.galois_elt_conjugate)
        for elt in sorted(elts):
            out.keys[elt] = self.galois_key(elt)
        return out
