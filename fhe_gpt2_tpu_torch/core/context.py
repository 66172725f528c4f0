"""CKKS parameter sets and the device-resident context, for both words.

Counterpart of ``fhe_gpt2_tpu/core/context.py`` (``:25-440``): the same
parameter constructors (so the moduli chains come out identical, the
reference's ``cnn_params``/``gpt2_params`` regimes included) and the same
table accessors, with every table a tensor on ``ctx.device`` in the chain's
word: int32 when every modulus is below 2**31, else int64 (``word_dtype``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import primes, ntt as nttmod, rns, seal
from .modmath import MAX_MODULUS, shoup, torch_word, word_dtype, \
    word_bits_of, word_tensor


@dataclass(frozen=True)
class CkksParams:
    """Static CKKS parameters (host-side, hashable)."""

    n: int                      # polynomial degree (2^logn)
    moduli: tuple               # ciphertext modulus chain q_0..q_{L-1}
    special: tuple              # special (key-switching) primes
    scale: float                # default encoding scale
    hamming_weight: int = 0     # sparse ternary secret weight (0 = dense)
    sparse_slots: int = 0       # bootstrap sparse slot count (0 = n/2)
    error_std: float = 3.2
    rescale_limbs: int = 1      # limbs one rescale drops (2 = composite)
    base_limbs: int = 1

    @property
    def levels(self) -> int:
        return len(self.moduli)

    @property
    def slots(self) -> int:
        return self.n // 2

    @property
    def word_bits(self) -> int:
        return word_bits_of(word_dtype(list(self.moduli) + list(self.special)))

    @staticmethod
    def create(logn: int, log_q0: int, log_scale: int, num_levels: int,
               log_special: int = 0, num_special: int = 1,
               hamming_weight: int = 0, sparse_slots: int = 0,
               balanced: bool = True) -> "CkksParams":
        """SEAL-style chain: [q0 (log_q0 bits), num_levels scale primes
        (log_scale bits, balanced around 2**log_scale), special primes
        (log_special bits, defaults to log_q0)]."""
        n = 1 << logn
        two_n = 2 * n
        log_special = log_special or log_q0
        q0 = primes.gen_primes(log_q0, 1, two_n)
        if balanced:
            scale_primes = primes.gen_primes_balanced(
                log_scale, num_levels, two_n, exclude=set(q0))
        else:
            scale_primes = primes.gen_primes(log_scale, num_levels, two_n)
        used = set(q0) | set(scale_primes)
        sp = []
        below = None
        while len(sp) < num_special:
            cands = primes.gen_primes(log_special, num_special + len(used),
                                      two_n, below=below)
            sp = [p for p in cands if p not in used][:num_special]
            below = cands[-1]
        return CkksParams(
            n=n,
            moduli=tuple(q0 + scale_primes),
            special=tuple(sp),
            scale=float(2 ** log_scale),
            hamming_weight=hamming_weight,
            sparse_slots=sparse_slots,
        )

    @staticmethod
    def create_composite(logn: int, num_levels: int, log_scale: int = 50,
                         log_q0: int = 55, log_special: int = 31,
                         num_special: int = 3, hamming_weight: int = 0,
                         sparse_slots: int = 0) -> "CkksParams":
        """Composite two-prime scaling chain on <2**31 moduli: Δ = q·q′ ≈
        2**log_scale per level, base modulus Q0 = q0·q0′ ≈ 2**log_q0."""
        n = 1 << logn
        two_n = 2 * n
        q0 = primes.gen_prime_pairs(log_q0, 1, two_n)
        used = set(q0)
        chain = primes.gen_prime_pairs(log_scale, num_levels, two_n,
                                       exclude=used)
        used |= set(chain)
        sp = []
        below = None
        while len(sp) < num_special:
            cands = primes.gen_primes(log_special, num_special + len(used),
                                      two_n, below=below)
            sp = [p for p in cands if p not in used][:num_special]
            below = cands[-1]
        if max(q0 + chain + sp) >= (1 << 31):
            raise ValueError("composite chain must be u32")
        return CkksParams(
            n=n,
            moduli=tuple(q0 + chain),
            special=tuple(sp),
            scale=float(2 ** log_scale),
            hamming_weight=hamming_weight,
            sparse_slots=sparse_slots,
            rescale_limbs=2,
            base_limbs=2,
        )


def resolve_device(device=None) -> torch.device:
    """The port's device rule: the card unless the caller names another.
    With no card and no explicit device this raises; it never drops to the
    CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


class CkksContext:
    """Precomputed device constants for one parameter set.

    Holds NTT tables over the full basis (q chain + special primes),
    per-level rescale/mod-down/key-switch tables, and Galois permutations,
    all on ``self.device``. The word is the chain's (``self.word``, as the
    JAX context's; ``self.dtype`` is the tensor dtype holding it): uint32
    chains run on int32 tensors and the CUDA kernels, u64 chains (any
    modulus >= 2**31) on int64 tensors and the plain PyTorch ops on any
    device."""

    def __init__(self, params: CkksParams, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.n = params.n
        self.logn = params.n.bit_length() - 1
        self.moduli = list(params.moduli)
        self.special = list(params.special)
        self.all_moduli = self.moduli + self.special
        if max(self.all_moduli) >= MAX_MODULUS:
            raise ValueError("every modulus must lie below 2**62")
        self.L = len(self.moduli)
        self.k_sp = len(self.special)
        self.word = word_dtype(self.all_moduli)       # np.uint32 / np.uint64
        self.word_bits = word_bits_of(self.word)
        self.dtype = torch_word(self.word)            # torch.int32 / int64
        self.ntt_all = nttmod.make_ntt_tables(self.all_moduli, self.n,
                                              self.device)
        self._level_tables: dict[tuple, nttmod.NttTables] = {}
        self._cache: dict[tuple, object] = {}
        # Slot index maps: slot j <-> exponent 5^j mod 2n.
        e = nttmod.point_exponents(self.n)
        index_of = np.zeros(2 * self.n, dtype=np.int64)
        index_of[e] = np.arange(self.n)
        self.exp_of_slot = np.zeros(self.n // 2, dtype=np.int64)
        g = 1
        for j in range(self.n // 2):
            self.exp_of_slot[j] = g
            g = g * 5 % (2 * self.n)
        self.slot_to_index = index_of[self.exp_of_slot]
        self.conj_slot_to_index = index_of[
            (2 * self.n - self.exp_of_slot) % (2 * self.n)]
        self._elt_to_step = None

    def _cached(self, key: tuple, build):
        """The device constant under key, made by build() on first use; a
        sealed call's first use raises (``core/seal.py``)."""
        if key not in self._cache:
            s = seal.current()
            if s is not None:
                s.miss(f"context constant {key[0]!r}")
            self._cache[key] = build()
        return self._cache[key]

    # -- composite-scaling geometry -----------------------------------------

    @property
    def rescale_limbs(self) -> int:
        return self.params.rescale_limbs

    @property
    def base_limbs(self) -> int:
        return self.params.base_limbs

    @property
    def q0_int(self) -> int:
        """Base modulus Q0 = prod(moduli[:base_limbs]) as an exact int."""
        return math.prod(self.moduli[: self.base_limbs])

    @property
    def q0_float(self) -> float:
        return float(self.q0_int)

    def rescale_divisor(self, level: int) -> float:
        """What the next rescale at `level` divides the scale by: the
        product of the rescale_limbs trailing primes."""
        return float(math.prod(
            self.moduli[level - self.rescale_limbs: level]))

    # -- the limbs held here ------------------------------------------------
    #
    # A context holds every limb; a mesh position's view of it
    # (``parallel/limbs.py``) holds some of them on a limb axis and
    # overrides these three. Every table accessor below that takes a level
    # answers for ``data_limbs(level)``.

    def data_limbs(self, level: int) -> tuple[int, ...]:
        """The chain limbs below `level` whose rows a ciphertext at that
        level holds here, in row order: all of them."""
        return tuple(range(level))

    def gather_limbs(self, x: torch.Tensor, level: int) -> torch.Tensor:
        """x[..., rows, N] at `level` with every limb below the level, in
        chain order: x itself here (an all-gather on a limb axis)."""
        return x

    def with_trailing(self, x: torch.Tensor, level: int,
                      g: int) -> torch.Tensor:
        """x's rows below level - g followed by the g trailing limbs of the
        level (what a rescale divides by): x itself here (a broadcast from
        the positions that hold them on a limb axis)."""
        return x

    # -- table accessors ----------------------------------------------------

    def tables(self, limbs: tuple[int, ...] | int) -> nttmod.NttTables:
        """NTT tables for a limb index set. ``int`` means the limbs held
        below that level (``data_limbs``)."""
        if isinstance(limbs, int):
            limbs = self.data_limbs(limbs)
        key = tuple(limbs)
        if key not in self._level_tables:
            s = seal.current()
            if s is not None:
                s.miss(f"NTT tables of {len(key)} limbs")
            self._level_tables[key] = self.ntt_all.slice(list(key))
        return self._level_tables[key]

    def _held(self, level: int) -> list[int]:
        return [self.moduli[i] for i in self.data_limbs(level)]

    def key_limbs(self, level: int) -> tuple[int, ...]:
        """Key-switching limb set at `level`: the data limbs held below it
        (q_0..q_{level-1}) + specials."""
        return self.data_limbs(level) + tuple(
            self.L + i for i in range(self.k_sp))

    # -- hybrid key-switch digit structure (alpha = number of specials) -----

    @property
    def alpha(self) -> int:
        return self.k_sp

    def num_digits(self, level: int) -> int:
        return -(-level // self.alpha)

    def digit_groups(self, level: int) -> tuple[tuple[int, ...], ...]:
        a = self.alpha
        return tuple(
            tuple(range(j * a, min((j + 1) * a, level)))
            for j in range(self.num_digits(level)))

    def decomp_tables(self, level: int):
        """Per-digit base-conversion tables: digit group -> full key basis."""
        def build():
            dst = [self.all_moduli[i] for i in self.key_limbs(level)]
            return tuple(
                rns.make_base_conv([self.moduli[i] for i in g], dst,
                                   self.device, self.word)
                for g in self.digit_groups(level))
        return self._cached(("decomp", level), build)

    def drop_last_tables(self, level: int) -> rns.DropLastTables:
        """Rescale tables: divide by q_{level-1}, keep q_0..q_{level-2}."""
        return self._cached(("drop", level), lambda: rns.make_drop_last(
            self._held(level - 1), self.moduli[level - 1], self.device,
            self.word))

    def rescale_pair_tables(self, level: int) -> rns.ModDownTables:
        """One-shot composite rescale: divide by the trailing
        rescale_limbs primes in one fast base conversion."""
        g = self.rescale_limbs
        return self._cached(("pair", level), lambda: rns.make_mod_down(
            self._held(level - g), self.moduli[level - g: level],
            self.device, self.word))

    def mod_down_onestep_tables(self, level: int) -> rns.ModDownTables:
        """One-shot key-switch mod-down: divide by P = prod(special)."""
        return self._cached(("onestep", level), lambda: rns.make_mod_down(
            self._held(level), self.special, self.device, self.word))

    def mod_down_tables(self, level: int, sp: int = 0) -> rns.DropLastTables:
        """Exact drop of special prime `sp`, keeping q_0..q_{level-1} +
        specials 0..sp-1 (the per-prime mod-down the one-shot form
        replaces; specials drop last to first)."""
        return self._cached(("drop_sp", level, sp), lambda: rns.make_drop_last(
            self._held(level) + self.special[:sp], self.special[sp],
            self.device, self.word))

    def fused_md_tables(self, level: int, pair: bool = False):
        """Constants of the mod-down kernel (core/tks.py): divide by the
        special primes (pair=False) or the trailing rescale pair (True)."""
        from . import tks

        def build():
            mdt = (self.rescale_pair_tables(level) if pair
                   else self.mod_down_onestep_tables(level))
            out_l = level - self.rescale_limbs if pair else level
            return tks.make_fused_md_tables(mdt, self.tables(out_l))
        return self._cached(("fmd", level, pair), build)

    def fused_ks_tables(self, level: int):
        """Constants of the key-switch kernel (core/tks.py), per level."""
        from . import tks
        return self._cached(("fks", level),
                            lambda: tks.make_fused_ks_tables(self, level))

    def galois_perm(self, galois_elt: int) -> torch.Tensor:
        """NTT-domain permutation for X -> X^g (int64 index, on device)."""
        return self._cached(("galois", galois_elt), lambda: torch.from_numpy(
            nttmod.galois_ntt_permutation(self.n, galois_elt)
            .astype(np.int64)).to(self.device))

    def galois_elt_from_step(self, step: int) -> int:
        """Rotation by `step` slots (left) = automorphism X -> X^{5^step}."""
        step = step % (self.n // 2)
        return pow(5, step, 2 * self.n)

    def step_from_elt(self, elt: int):
        """Inverse of galois_elt_from_step (None for conjugation/unknown)."""
        if self._elt_to_step is None:
            tab = {}
            g = 1
            for s in range(self.n // 2):
                tab[g] = s
                g = (g * 5) % (2 * self.n)
            self._elt_to_step = tab
        return self._elt_to_step.get(elt)

    @property
    def galois_elt_conjugate(self) -> int:
        return 2 * self.n - 1

    def p_residues(self, level: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(P mod q_i, its Shoup word) over the key basis at `level`, each
        [l+k, 1]; P = prod(special primes), so the special limbs hold 0.
        Lifts a base-Q polynomial into the extended QP basis (times P) for
        the double-hoisted rotations."""
        def build():
            P = math.prod(self.special)
            limbs = self.key_limbs(level)
            r = [P % self.all_moduli[i] for i in limbs]
            sh = [shoup(v, self.all_moduli[i], self.word_bits) if v else 0
                  for v, i in zip(r, limbs)]
            return (word_tensor(r, self.device, (-1, 1), self.word),
                    word_tensor(sh, self.device, (-1, 1), self.word))
        return self._cached(("p_res", level), build)

    def const_residues(self, value: int, limbs: tuple[int, ...]) -> np.ndarray:
        """[value mod q_i] for a limb set, as a word-dtype column."""
        return np.array(
            [value % self.all_moduli[i] for i in limbs], dtype=self.word
        ).reshape(-1, 1)


@lru_cache(maxsize=None)
def test_params(logn: int = 10, levels: int = 4) -> CkksParams:
    """Small u64-engine parameter set for fast CPU tests."""
    return CkksParams.create(
        logn=logn, log_q0=50, log_scale=40, num_levels=levels,
        log_special=51, hamming_weight=16,
    )


@lru_cache(maxsize=None)
def test_params_w32(logn: int = 10, levels: int = 6) -> CkksParams:
    """Small uint32-engine parameter set for fast CPU tests."""
    return CkksParams.create(
        logn=logn, log_q0=29, log_scale=25, num_levels=levels,
        log_special=31, num_special=2, hamming_weight=16,
    )


@lru_cache(maxsize=None)
def w32_params(logn: int = 15, levels: int = 22, num_special: int = 3,
               log_scale: int = 25, hamming_weight: int = 192,
               sparse_slots: int = 0) -> CkksParams:
    """Production uint32-engine chain: q0 ~2**29, balanced ~2**25 scale
    primes, ~2**31 special primes."""
    return CkksParams.create(
        logn=logn, log_q0=29, log_scale=log_scale, num_levels=levels,
        log_special=31, num_special=num_special,
        hamming_weight=hamming_weight, sparse_slots=sparse_slots,
    )


@lru_cache(maxsize=None)
def cnn_params() -> CkksParams:
    """Reference CNN parameter regime (infer_seal.cpp:287-322): logN=16,
    logq0=51, logp=46, L=16 usable + 14 bootstrap levels, special 51, h=192."""
    return CkksParams.create(
        logn=16, log_q0=51, log_scale=46, num_levels=30,
        log_special=51, hamming_weight=192, sparse_slots=1 << 14,
    )


@lru_cache(maxsize=None)
def gpt2_params() -> CkksParams:
    """Reference GPT-2 regime (run/infer_gpt2.cpp:63-85): logN=16, L=21+14,
    logq0=51, logp=46, special 60, h=192."""
    return CkksParams.create(
        logn=16, log_q0=51, log_scale=46, num_levels=35,
        log_special=60, hamming_weight=192, sparse_slots=1 << 14,
    )
