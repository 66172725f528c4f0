"""CKKS evaluator: the op surface of the crypto core (uint32 engine).

Counterpart of ``fhe_gpt2_tpu/core/evaluator.py``: the same ops, the same
arithmetic and the same key-switch structure (hybrid digits of alpha =
k_sp limbs, one-shot HPS mod-down), so on the same keys and seeds the
ciphertexts equal the JAX package's. Ciphertexts are ``int32[k, *batch, l,
N]`` NTT-form tensors on the context's device. Key switching and mod-down
go through ``core/tks.py`` and every transform through ``core/ntt.py``,
which route CUDA tensors to the hand-written kernels.

Not in this slice: hoisted rotations (``rotate_hoisted``,
``hoisted_rotations_ext``, ``mod_down_ext``), the reduced-error ops and
seeded/secure encryption.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import embedding, ntt as nttmod, tks
from .context import CkksContext
from .keys import GaloisKeys, KSwitchKey, PublicKey, SecretKey, \
    sample_gaussian, sample_ternary, sample_uniform_rns, _to_rns
from .modmath import add_mod, sub_mod, neg_mod, mul_mod, mul_mod_shoup, \
    reduce_mod, to_numpy_u32, word_tensor
from .rns import DropLastTables


@dataclass
class Ciphertext:
    """RNS-CKKS ciphertext. data: int32[k, *batch, l, N] in NTT form."""

    data: torch.Tensor
    scale: float

    @property
    def k(self) -> int:
        return self.data.shape[0]

    @property
    def level(self) -> int:
        return self.data.shape[-2]

    @property
    def batch(self) -> tuple:
        return tuple(self.data.shape[1:-2])


@dataclass
class Plaintext:
    """Encoded plaintext. data: int32[l, N] in NTT form."""

    data: torch.Tensor
    scale: float

    @property
    def level(self) -> int:
        return self.data.shape[-2]


def _scales_close(a: float, b: float, tol=1e-6):
    return abs(a - b) <= tol * max(abs(a), abs(b))


def _drop_last_core(x, t_rem, t_last, dlt: DropLastTables):
    """Exact divide-and-round of NTT-form x[..., l, N] by its trailing limb:
    iNTT only the dropped limb (``evaluator._drop_last_core``)."""
    last = nttmod.intt(x[..., -1:, :], t_last)[..., 0, :]
    shifted = add_mod(last, dlt.half, dlt.q_last)
    img = reduce_mod(shifted[..., None, :], dlt.q)
    img = sub_mod(img, dlt.half_mod, dlt.q)
    img = nttmod.ntt(img.contiguous(), t_rem)
    diff = sub_mod(x[..., :-1, :], img, dlt.q)
    return mul_mod_shoup(diff, dlt.inv_qlast, dlt.inv_qlast_shoup, dlt.q)


class Evaluator:
    """Stateless op library bound to a context (and optionally keys)."""

    def __init__(self, ctx: CkksContext, relin_key: Optional[KSwitchKey] = None,
                 galois_keys: Optional[GaloisKeys] = None):
        self.ctx = ctx
        self.relin_key = relin_key
        self.galois_keys = galois_keys

    # -- encoding -----------------------------------------------------------

    def make_plain(self, values, scale: float, level: int) -> Plaintext:
        """Encode a slot vector (host) into an NTT-form plaintext."""
        res = embedding.encode(values, scale, self.ctx, tuple(range(level)))
        t = self.ctx.tables(level)
        return Plaintext(data=nttmod.ntt(word_tensor(res, self.ctx.device), t),
                         scale=scale)

    def decode_plain(self, pt: Plaintext, num_slots=None) -> np.ndarray:
        res = to_numpy_u32(nttmod.intt(pt.data.contiguous(),
                                       self.ctx.tables(pt.level)))
        return embedding.decode(res, pt.scale, self.ctx,
                                tuple(range(pt.level)), num_slots)

    # -- add/sub/neg --------------------------------------------------------

    def _t(self, level: int):
        return self.ctx.tables(level)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.level == b.level and _scales_close(a.scale, b.scale), (
            f"add: level/scale mismatch {a.level}/{a.scale} vs {b.level}/{b.scale}")
        return Ciphertext(add_mod(a.data, b.data, self._t(a.level).q), a.scale)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.level == b.level and _scales_close(a.scale, b.scale)
        return Ciphertext(sub_mod(a.data, b.data, self._t(a.level).q), a.scale)

    def negate(self, a: Ciphertext) -> Ciphertext:
        return Ciphertext(neg_mod(a.data, self._t(a.level).q), a.scale)

    def _with_c0(self, a: Ciphertext, c0: torch.Tensor) -> torch.Tensor:
        return torch.cat([c0[None], a.data[1:]])

    def add_plain(self, a: Ciphertext, p: Plaintext) -> Ciphertext:
        assert a.level == p.level and _scales_close(a.scale, p.scale)
        q = self._t(a.level).q
        return Ciphertext(self._with_c0(a, add_mod(a.data[0], p.data, q)),
                          a.scale)

    def sub_plain(self, a: Ciphertext, p: Plaintext) -> Ciphertext:
        assert a.level == p.level and _scales_close(a.scale, p.scale)
        q = self._t(a.level).q
        return Ciphertext(self._with_c0(a, sub_mod(a.data[0], p.data, q)),
                          a.scale)

    def _const(self, m: int, level: int) -> torch.Tensor:
        return word_tensor(self.ctx.const_residues(m, tuple(range(level))),
                           self.ctx.device)

    def add_const(self, a: Ciphertext, value: float) -> Ciphertext:
        """a + value broadcast over slots (no level/scale cost)."""
        res = self._const(int(round(value * a.scale)), a.level)
        q = self._t(a.level).q
        return Ciphertext(self._with_c0(a, add_mod(a.data[0], res, q)), a.scale)

    def mul_const_int(self, a: Ciphertext, m: int) -> Ciphertext:
        """Multiply by an exact integer (scale unchanged)."""
        return Ciphertext(mul_mod(a.data, self._const(m, a.level),
                                  self._t(a.level).q), a.scale)

    def mul_const(self, a: Ciphertext, value: float,
                  const_scale: Optional[float] = None) -> Ciphertext:
        """Multiply all slots by a real constant encoded at const_scale."""
        cs = const_scale if const_scale is not None else self.ctx.params.scale
        out = self.mul_const_int(a, int(round(value * cs)))
        return Ciphertext(out.data, a.scale * cs)

    def mul_plain(self, a: Ciphertext, p: Plaintext) -> Ciphertext:
        assert a.level == p.level
        return Ciphertext(mul_mod(a.data, p.data, self._t(a.level).q),
                          a.scale * p.scale)

    def mul_vector(self, a: Ciphertext, values,
                   const_scale: Optional[float] = None) -> Ciphertext:
        cs = const_scale if const_scale is not None else self.ctx.params.scale
        return self.mul_plain(a, self.make_plain(values, cs, a.level))

    # -- multiply / relinearize ---------------------------------------------

    def multiply(self, a: Ciphertext, b: Ciphertext,
                 relin: bool = True) -> Ciphertext:
        assert a.level == b.level and a.k == 2 and b.k == 2
        q = self._t(a.level).q
        d0 = mul_mod(a.data[0], b.data[0], q)
        d1 = add_mod(mul_mod(a.data[0], b.data[1], q),
                     mul_mod(a.data[1], b.data[0], q), q)
        d2 = mul_mod(a.data[1], b.data[1], q)
        out = Ciphertext(torch.stack([d0, d1, d2]), a.scale * b.scale)
        if relin:
            out = self.relinearize(out)
        return out

    def square(self, a: Ciphertext, relin: bool = True) -> Ciphertext:
        return self.multiply(a, a, relin=relin)

    def relinearize(self, a: Ciphertext) -> Ciphertext:
        assert a.k == 3 and self.relin_key is not None
        ks = self._switch_key(a.data[2], a.level, self.relin_key)
        q = self._t(a.level).q
        return Ciphertext(torch.stack([add_mod(a.data[0], ks[0], q),
                                       add_mod(a.data[1], ks[1], q)]), a.scale)

    # -- rescale / mod switch -----------------------------------------------

    def rescale(self, a: Ciphertext) -> Ciphertext:
        """Divide by the trailing rescale unit: one prime q_{l-1} (exact
        drop), or the trailing PAIR under composite scaling (one-shot HPS
        mod-down through the mod-down kernel)."""
        ctx = self.ctx
        g = ctx.rescale_limbs
        assert a.level - g >= ctx.base_limbs, (
            "rescale at the chain floor: out of levels (bootstrap needed)")
        l = a.level
        if g == 1:
            data = _drop_last_core(a.data.contiguous(), ctx.tables(l - 1),
                                   ctx.tables((l - 1,)),
                                   ctx.drop_last_tables(l))
        else:
            data = tks.fused_mod_down(
                a.data.contiguous(), ctx.tables(tuple(range(l - g, l))),
                ctx.tables(l - g),
                ctx.fused_md_tables(l, pair=True))
        return Ciphertext(data, a.scale / float(
            np.prod([ctx.moduli[i] for i in range(l - g, l)])))

    def mod_switch_drop(self, a: Ciphertext, levels: int = 1) -> Ciphertext:
        """Drop limbs without scaling (mod_switch_to_next)."""
        assert a.level - levels >= 1
        return Ciphertext(a.data[..., : a.level - levels, :].contiguous(),
                          a.scale)

    def mod_switch_to(self, a: Ciphertext, level: int) -> Ciphertext:
        return self.mod_switch_drop(a, a.level - level) if a.level > level else a

    # -- key switching ------------------------------------------------------

    def _mod_down_special(self, x: torch.Tensor, level: int) -> torch.Tensor:
        """Divide-and-round of NTT-form x[..., l+k, N] by P = prod of the
        special primes (one-shot HPS mod-down)."""
        ctx = self.ctx
        sp_idx = tuple(ctx.L + i for i in range(ctx.k_sp))
        return tks.fused_mod_down(x, ctx.tables(sp_idx), ctx.tables(level),
                                  ctx.fused_md_tables(level))

    def _switch_key(self, c: torch.Tensor, level: int,
                    ksk: KSwitchKey) -> torch.Tensor:
        """Switch an NTT-form poly c[..., l, N] to the secret key basis.
        Returns [2, ..., l, N], already mod-downed past the special primes."""
        ctx = self.ctx
        ft = ctx.fused_ks_tables(level)
        key_limbs = ctx.key_limbs(level)
        acc = tks.fused_switch_key(
            c.contiguous(), ksk.sliced(key_limbs, ft.D), ctx.tables(level),
            ctx.tables(key_limbs), ft)
        return self._mod_down_special(acc, level)

    def apply_galois(self, a: Ciphertext, galois_elt: int) -> Ciphertext:
        """Galois automorphism + key switch (rotate/conjugate core)."""
        assert a.k == 2 and self.galois_keys is not None
        permuted = a.data.index_select(-1, self.ctx.galois_perm(galois_elt))
        ks = self._switch_key(permuted[1], a.level, self.galois_keys[galois_elt])
        q = self._t(a.level).q
        return Ciphertext(torch.stack([add_mod(permuted[0], ks[0], q), ks[1]]),
                          a.scale)

    def _hops(self, steps: int) -> list[int]:
        """Decompose a rotation into available key steps: one hop when the
        exact key exists, else greedy largest-available-step hops."""
        n2 = self.ctx.n // 2
        steps %= n2
        if steps == 0:
            return []
        have = self.galois_keys.step_set(self.ctx) if self.galois_keys else ()
        if steps in have:
            return [steps]
        hops = []
        rem = steps
        avail = sorted(have, reverse=True)
        while rem:
            nxt = next((s for s in avail if s <= rem), None)
            assert nxt is not None, (
                f"no Galois key path for rotation {steps} (have {len(avail)})")
            hops.append(nxt)
            rem -= nxt
        return hops

    def rotate(self, a: Ciphertext, steps: int) -> Ciphertext:
        """Rotate slots left by `steps`, composing key switches when the
        exact key is absent."""
        for s in self._hops(steps):
            a = self.apply_galois(a, self.ctx.galois_elt_from_step(s))
        return a

    def conjugate(self, a: Ciphertext) -> Ciphertext:
        return self.apply_galois(a, self.ctx.galois_elt_conjugate)


# ---------------------------------------------------------------------------
# Encryptor / Decryptor (host-boundary ops)
# ---------------------------------------------------------------------------

class Encryptor:
    def __init__(self, ctx: CkksContext, secret: Optional[SecretKey] = None,
                 public: Optional[PublicKey] = None, seed: int = 1, rng=None):
        self.ctx = ctx
        self.secret = secret
        self.public = public
        self.rng = rng if rng is not None else np.random.default_rng(seed)

    def _rns(self, host: np.ndarray) -> torch.Tensor:
        return word_tensor(host, self.ctx.device)

    def encrypt_symmetric(self, pt: Plaintext) -> Ciphertext:
        ctx, l = self.ctx, pt.level
        t = ctx.tables(l)
        mods = [ctx.all_moduli[i] for i in range(l)]
        a = self._rns(sample_uniform_rns(self.rng, ctx.n, mods))
        e = self._rns(_to_rns(
            sample_gaussian(self.rng, ctx.n, ctx.params.error_std), mods))
        s = self.secret.ntt[:l]
        b = add_mod(neg_mod(mul_mod(a, s, t.q), t.q), nttmod.ntt(e, t), t.q)
        b = add_mod(b, pt.data, t.q)
        return Ciphertext(torch.stack([b, a]), pt.scale)

    def encrypt(self, pt: Plaintext) -> Ciphertext:
        if self.public is None:
            return self.encrypt_symmetric(pt)
        return self.encrypt_asymmetric(pt)

    def encrypt_asymmetric(self, pt: Plaintext) -> Ciphertext:
        """pk encryption at key level, mod-down past the special primes,
        then add the plaintext."""
        ctx = self.ctx
        t = ctx.tables(tuple(range(len(ctx.all_moduli))))
        mods = list(ctx.all_moduli)
        u_ntt = nttmod.ntt(self._rns(_to_rns(sample_ternary(self.rng, ctx.n),
                                             mods)), t)
        cts = []
        for c in range(2):
            e = self._rns(_to_rns(
                sample_gaussian(self.rng, ctx.n, ctx.params.error_std), mods))
            cts.append(add_mod(mul_mod(self.public.data[c], u_ntt, t.q),
                               nttmod.ntt(e, t), t.q))
        data = Evaluator(ctx)._mod_down_special(torch.stack(cts), ctx.L)
        data = data[:, : pt.level]
        tq = ctx.tables(pt.level).q
        c0 = add_mod(data[0], pt.data, tq)
        return Ciphertext(torch.stack([c0, data[1]]), pt.scale)


class Decryptor:
    def __init__(self, ctx: CkksContext, secret: SecretKey):
        self.ctx = ctx
        self.secret = secret

    def decrypt_to_rns(self, ct: Ciphertext) -> np.ndarray:
        """c0 + c1·s (+ c2·s²) -> coefficient-domain uint32 residues [l, N]."""
        l = ct.level
        t = self.ctx.tables(l)
        s = self.secret.ntt[:l]
        acc = ct.data[0]
        spow = s
        for j in range(1, ct.k):
            acc = add_mod(acc, mul_mod(ct.data[j], spow, t.q), t.q)
            if j + 1 < ct.k:
                spow = mul_mod(spow, s, t.q)
        return to_numpy_u32(nttmod.intt(acc.contiguous(), t))

    def decrypt(self, ct: Ciphertext, num_slots=None) -> np.ndarray:
        res = self.decrypt_to_rns(ct)
        return embedding.decode(res, ct.scale, self.ctx,
                                tuple(range(ct.level)), num_slots)
