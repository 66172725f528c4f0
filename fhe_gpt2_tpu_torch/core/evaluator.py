"""CKKS evaluator: the op surface of the crypto core, for both words.

Counterpart of ``fhe_gpt2_tpu/core/evaluator.py``: the same ops, the same
arithmetic and the same key-switch structure (hybrid digits of alpha =
k_sp limbs, one-shot HPS mod-down), so on the same keys and seeds the
ciphertexts equal the JAX package's. Ciphertexts are NTT-form tensors
``[k, *batch, l, N]`` on the context's device, in the chain's word (int32
for uint32 chains, int64 for u64 chains). Key switching and mod-down go
through ``core/tks.py`` and every transform through ``core/ntt.py``, which
route int32 CUDA tensors to the hand-written kernels and int64 tensors (on
any device) to the plain PyTorch ops, as the JAX package runs its u64
engine on XLA ops. The coefficient-wise arithmetic between them (the
tensor product, plain and constant products, adds and batch sums) goes
through ``core/tdyadic.py``, which routes the same way to
``csrc/dyadic.cu``.

The hoisted rotations decompose c1 once (``tks._decompose_core``, whose
transforms are the NTT kernels on the card) and run only the key MAC
(``tks.hoisted_mac``: the MAC kernel on the card, torch ops elsewhere, as
the JAX package's XLA ops) and the mod-down kernel per rotation; the
double-hoisted form keeps the rotations in the extended QP basis until
one mod-down per accumulator (``mod_down_ext``).

Encryption samples on the host, as the JAX package does, so the same seeds
give the same ciphertexts; ``encrypt_symmetric_seeded`` expands its c1 from a
32-byte SHAKE-256 seed (``expand_uniform``).

While the recorder of ``utils/telemetry.py`` is on, each public op is an
``op.<name>`` span and an ``op.<name>@<level>`` count at its outermost call
on a thread, every key read (``_switch_key``, ``_hoisted_mac``) a ``ks``
count and every shared decomposition a ``ks.decompose`` count; off, each op
costs one flag check.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from . import embedding, ntt as nttmod, seal, tdyadic, tks
from ..utils import telemetry
from .context import CkksContext
from .keys import GaloisKeys, KSwitchKey, PublicKey, SecretKey, make_rng, \
    sample_gaussian, sample_ternary, sample_uniform_rns, _to_rns
from .modmath import add_mod, sub_mod, neg_mod, mul_mod, mul_mod_shoup, \
    reduce_mod, to_numpy_word, word_tensor
from .rns import DropLastTables


@dataclass
class Ciphertext:
    """RNS-CKKS ciphertext. data: [k, *batch, l, N] words in NTT form: the
    rows of the limbs below `level` that its context holds
    (``ctx.data_limbs``), all l = level of them unless the context is a
    mesh position's view (``parallel/limbs.py``), so level defaults to the
    row count."""

    data: torch.Tensor
    scale: float
    level: int | None = None

    def __post_init__(self):
        if self.level is None:
            self.level = self.data.shape[-2]

    @property
    def k(self) -> int:
        return self.data.shape[0]

    @property
    def batch(self) -> tuple:
        return tuple(self.data.shape[1:-2])


@dataclass
class Plaintext:
    """Encoded plaintext. data: [l, N] words in NTT form; level as a
    Ciphertext's."""

    data: torch.Tensor
    scale: float
    level: int | None = None

    def __post_init__(self):
        if self.level is None:
            self.level = self.data.shape[-2]


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

    def _host_coeffs(self, values, scale: float) -> np.ndarray:
        """The canonical-embedding rounding of a slot vector on the host
        (numpy float64, or the native runtime): int64 coefficients [N]."""
        return embedding.encode_to_coeffs(values, scale, self.ctx)

    def _encode(self, values, scale: float, t) -> torch.Tensor:
        """Coefficient-form residues of a slot vector over the limbs of
        tables t, as the JAX package's ``embedding.encode`` gives them: the
        host coefficients, reduced modulo every limb by one exact int64
        remainder on ctx.device, in the chain's word."""
        seal.host_copy("encoding a slot vector")
        coeffs = torch.from_numpy(self._host_coeffs(values, scale))
        return torch.remainder(coeffs.to(self.ctx.device)[None, :],
                               t.q.long()).to(t.q.dtype)

    def _sealed_encode(self, kind: str, build, scale: float,
                       level: int) -> Plaintext:
        """build() outside a sealed call; inside one, the call's encoding
        of this rank among its encodings (``core/seal.py``): made by the
        warm pass, read back afterwards."""
        s = seal.current()
        if s is None:
            return build()
        key = (kind, s.n_encodes, level, scale)
        s.n_encodes += 1
        pt = s.encodes.get(key)
        if pt is None:
            s.miss(f"encoding {key}")
            pt = s.encodes[key] = build()
        return pt

    def make_plain(self, values, scale: float, level: int) -> Plaintext:
        """Encode a slot vector (host) into an NTT-form plaintext."""
        def build():
            t = self.ctx.tables(level)
            return Plaintext(data=nttmod.ntt(self._encode(values, scale, t),
                                             t), scale=scale, level=level)
        return self._sealed_encode("plain", build, scale, level)

    def decode_plain(self, pt: Plaintext, num_slots=None) -> np.ndarray:
        res = to_numpy_word(nttmod.intt(pt.data.contiguous(),
                                        self.ctx.tables(pt.level)))
        return embedding.decode(res, pt.scale, self.ctx,
                                tuple(range(pt.level)), num_slots)

    # -- add/sub/neg --------------------------------------------------------

    def _t(self, level: int):
        return self.ctx.tables(level)

    @telemetry.op("add")
    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.level == b.level and _scales_close(a.scale, b.scale), (
            f"add: level/scale mismatch {a.level}/{a.scale} vs {b.level}/{b.scale}")
        return Ciphertext(tdyadic.add_mod(a.data, b.data, self._t(a.level)),
                          a.scale, a.level)

    @telemetry.op("sub")
    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.level == b.level and _scales_close(a.scale, b.scale)
        return Ciphertext(tdyadic.sub_mod(a.data, b.data, self._t(a.level)),
                          a.scale, a.level)

    @telemetry.op("negate")
    def negate(self, a: Ciphertext) -> Ciphertext:
        return Ciphertext(tdyadic.neg_mod(a.data, self._t(a.level)), a.scale,
                          a.level)

    @telemetry.op("add_plain")
    def add_plain(self, a: Ciphertext, p: Plaintext) -> Ciphertext:
        assert a.level == p.level and _scales_close(a.scale, p.scale)
        return Ciphertext(tdyadic.add_mod(a.data[0], p.data, self._t(a.level),
                                          rest=a.data[1:]), a.scale, a.level)

    @telemetry.op("sub_plain")
    def sub_plain(self, a: Ciphertext, p: Plaintext) -> Ciphertext:
        assert a.level == p.level and _scales_close(a.scale, p.scale)
        return Ciphertext(tdyadic.sub_mod(a.data[0], p.data, self._t(a.level),
                                          rest=a.data[1:]), a.scale, a.level)

    def _const(self, m: int, level: int) -> torch.Tensor:
        """[m mod q_i] over the limbs held below level, on the device: made
        from the host per call, or, inside a sealed call, the call's own
        copy keyed by (m, level), made by its warm pass."""
        return seal.device_constant(
            (m, level), f"constant {m} at level {level}",
            lambda: word_tensor(self.ctx.const_residues(
                m, self.ctx.data_limbs(level)), self.ctx.device,
                word=self.ctx.word))

    @telemetry.op("add_const")
    def add_const(self, a: Ciphertext, value: float) -> Ciphertext:
        """a + value broadcast over slots (no level/scale cost)."""
        res = self._const(int(round(value * a.scale)), a.level)
        return Ciphertext(tdyadic.add_mod(a.data[0], res, self._t(a.level),
                                          rest=a.data[1:]), a.scale, a.level)

    @telemetry.op("mul_const_int")
    def mul_const_int(self, a: Ciphertext, m: int) -> Ciphertext:
        """Multiply by an exact integer (scale unchanged)."""
        return Ciphertext(tdyadic.mul_mod(a.data, self._const(m, a.level),
                                          self._t(a.level)), a.scale, a.level)

    @telemetry.op("mul_const")
    def mul_const(self, a: Ciphertext, value: float,
                  const_scale: Optional[float] = None) -> Ciphertext:
        """Multiply all slots by a real constant encoded at const_scale."""
        cs = const_scale if const_scale is not None else self.ctx.params.scale
        out = self.mul_const_int(a, int(round(value * cs)))
        return Ciphertext(out.data, a.scale * cs, a.level)

    @telemetry.op("mul_plain")
    def mul_plain(self, a: Ciphertext, p: Plaintext) -> Ciphertext:
        assert a.level == p.level
        return Ciphertext(tdyadic.mul_mod(a.data, p.data, self._t(a.level)),
                          a.scale * p.scale, a.level)

    def mul_vector(self, a: Ciphertext, values,
                   const_scale: Optional[float] = None) -> Ciphertext:
        cs = const_scale if const_scale is not None else self.ctx.params.scale
        return self.mul_plain(a, self.make_plain(values, cs, a.level))

    # -- multiply / relinearize ---------------------------------------------

    @telemetry.op("multiply")
    def multiply(self, a: Ciphertext, b: Ciphertext,
                 relin: bool = True) -> Ciphertext:
        assert a.level == b.level and a.k == 2 and b.k == 2
        out = Ciphertext(tdyadic.tensor_product(a.data, b.data,
                                                self._t(a.level)),
                         a.scale * b.scale, a.level)
        if relin:
            out = self.relinearize(out)
        return out

    @telemetry.op("square")
    def square(self, a: Ciphertext, relin: bool = True) -> Ciphertext:
        return self.multiply(a, a, relin=relin)

    @telemetry.op("relinearize")
    def relinearize(self, a: Ciphertext) -> Ciphertext:
        assert a.k == 3 and self.relin_key is not None
        ks = self._switch_key(a.data[2], a.level, self.relin_key)
        return Ciphertext(tdyadic.add_mod(a.data[:2], ks, self._t(a.level)),
                          a.scale, a.level)

    # -- rescale / mod switch -----------------------------------------------

    @telemetry.op("rescale")
    def rescale(self, a: Ciphertext) -> Ciphertext:
        """Divide by the trailing rescale unit: one prime q_{l-1} (exact
        drop), or the trailing PAIR under composite scaling (one-shot HPS
        mod-down through the mod-down kernel)."""
        ctx = self.ctx
        g = ctx.rescale_limbs
        assert a.level - g >= ctx.base_limbs, (
            "rescale at the chain floor: out of levels (bootstrap needed)")
        l = a.level
        x = ctx.with_trailing(a.data.contiguous(), l, g)
        if g == 1:
            data = _drop_last_core(x, ctx.tables(l - 1),
                                   ctx.tables((l - 1,)),
                                   ctx.drop_last_tables(l))
        else:
            data = tks.fused_mod_down(
                x, ctx.tables(tuple(range(l - g, l))), ctx.tables(l - g),
                ctx.fused_md_tables(l, pair=True))
        return Ciphertext(data, a.scale / float(
            np.prod([ctx.moduli[i] for i in range(l - g, l)])), l - g)

    @telemetry.op("mod_switch_drop")
    def mod_switch_drop(self, a: Ciphertext, levels: int = 1) -> Ciphertext:
        """Drop limbs without scaling (mod_switch_to_next)."""
        assert a.level - levels >= 1
        lv = a.level - levels
        return Ciphertext(
            a.data[..., : len(self.ctx.data_limbs(lv)), :].contiguous(),
            a.scale, lv)

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
        Returns [2, ..., l, N], already mod-downed past the special primes.
        The base conversion reads every limb below the level
        (``gather_limbs``); the key rows are the context's."""
        telemetry.count("ks")
        ctx = self.ctx
        ft = ctx.fused_ks_tables(level)
        key_limbs = ctx.key_limbs(level)
        acc = tks.fused_switch_key(
            ctx.gather_limbs(c.contiguous(), level),
            ksk.sliced(key_limbs, ft.D), ctx.tables(tuple(range(level))),
            ctx.tables(key_limbs), ft)
        return self._mod_down_special(acc, level)

    @telemetry.op("apply_galois")
    def apply_galois(self, a: Ciphertext, galois_elt: int) -> Ciphertext:
        """Galois automorphism + key switch (rotate/conjugate core)."""
        assert a.k == 2 and self.galois_keys is not None
        permuted = a.data.index_select(-1, self.ctx.galois_perm(galois_elt))
        ks = self._switch_key(permuted[1], a.level, self.galois_keys[galois_elt])
        return Ciphertext(tdyadic.add_mod(permuted[0], ks[0], self._t(a.level),
                                          rest=ks[1:]), a.scale, a.level)

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

    @telemetry.op("rotate")
    def rotate(self, a: Ciphertext, steps: int) -> Ciphertext:
        """Rotate slots left by `steps`, composing key switches when the
        exact key is absent."""
        for s in self._hops(steps):
            a = self.apply_galois(a, self.ctx.galois_elt_from_step(s))
        return a

    # -- hoisted rotations -----------------------------------------------------

    def _decompose(self, a: Ciphertext):
        """(key tables, tpoly [..., D, l+k, N], D) of a's c1: the digit
        decomposition the hoisted rotations share, on the key-switch
        kernel's cached digit structure."""
        telemetry.count("ks.decompose")
        ctx, l = self.ctx, a.level
        ft = ctx.fused_ks_tables(l)
        kt = ctx.tables(ctx.key_limbs(l))
        return kt, tks._decompose_core(
            ctx.gather_limbs(a.data[1], l), kt, ctx.tables(tuple(range(l))),
            ft.bcts, (ft.own != 0)[..., None], ft.splice), ft.D

    def _hoisted_mac(self, tpoly, kt, elt: int, level: int, D: int):
        """Permute the shared digits by the automorphism and multiply-
        accumulate them with its key (``tks.hoisted_mac``): [2, ..., l+k, N]
        before mod-down."""
        telemetry.count("ks")
        key = self.galois_keys[elt].sliced(self.ctx.key_limbs(level), D)
        return tks.hoisted_mac(tpoly, key, self.ctx.galois_perm(elt), kt)

    @telemetry.op("rotate_hoisted")
    def rotate_hoisted(self, a: Ciphertext, steps: list[int]) -> list[Ciphertext]:
        """Many rotations of one ciphertext sharing a single digit
        decomposition: the automorphism commutes with the per-coefficient
        decomposition, so only the MAC and the mod-down run per rotation."""
        ctx = self.ctx
        l = a.level
        kt, tpoly, D = self._decompose(a)
        t = self._t(l)
        out = []
        for s in steps:
            s = s % (ctx.n // 2)
            if s == 0:
                out.append(a)
                continue
            hops = self._hops(s)
            # The first hop rides the shared decomposition; the rest key-
            # switch one by one.
            elt = ctx.galois_elt_from_step(hops[0])
            ks = self._mod_down_special(
                self._hoisted_mac(tpoly, kt, elt, l, D), l)
            c0p = a.data[0].index_select(-1, ctx.galois_perm(elt))
            r = Ciphertext(tdyadic.add_mod(c0p, ks[0], t, rest=ks[1:]),
                           a.scale, l)
            for h in hops[1:]:
                r = self.apply_galois(r, ctx.galois_elt_from_step(h))
            out.append(r)
        return out

    def make_plain_ext(self, values, scale: float, level: int) -> Plaintext:
        """Encode a slot vector over the extended key basis QP (data limbs +
        special primes): the operand of the double-hoisted masked sums."""
        def build():
            t = self.ctx.tables(self.ctx.key_limbs(level))
            return Plaintext(data=nttmod.ntt(self._encode(values, scale, t),
                                             t), scale=scale, level=level)
        return self._sealed_encode("ext", build, scale, level)

    @telemetry.op("hoisted_rotations_ext")
    def hoisted_rotations_ext(self, a: Ciphertext,
                              steps: list[int]) -> list[torch.Tensor]:
        """Double hoisting (Bossuat et al., EUROCRYPT'21): rotations of one
        ciphertext kept in the extended QP basis, without the per-rotation
        mod-down. Returns per step words [2, ..., l+k, N] holding
        P·(rotated ct); callers mask-multiply, accumulate in QP and pay one
        mod-down per accumulator (``mod_down_ext``)."""
        ctx = self.ctx
        l = a.level
        p_res, p_shoup = ctx.p_residues(l)
        t = self._t(l)
        q = t.q
        r = q.shape[0]                      # the data rows held

        def lift(ct_data):
            """P·ct in the extended basis: the special-limb residues of P·x
            are exactly zero, since every special prime divides P."""
            pc = tdyadic.mul_mod(ct_data, p_res[:r], t, p_shoup[:r])
            pad = pc.new_zeros((*pc.shape[:-2], ctx.k_sp, pc.shape[-1]))
            return torch.cat([pc, pad], dim=-2)

        dec = None
        out = []
        for s in steps:
            s = s % (ctx.n // 2)
            if s == 0:
                out.append(lift(a.data))
                continue
            if len(self._hops(s)) > 1:
                # No single-hop key: rotate fully and lift the result.
                out.append(lift(self.rotate(a, s).data))
                continue
            if dec is None:
                dec = self._decompose(a)
            kt, tpoly, D = dec
            elt = ctx.galois_elt_from_step(s)
            acc = self._hoisted_mac(tpoly, kt, elt, l, D)
            out.append(tks.add_lifted(acc, a.data[0], ctx.galois_perm(elt),
                                      p_res, p_shoup, q))
        return out

    @telemetry.op("mod_down_ext", level_arg=2)
    def mod_down_ext(self, data: torch.Tensor, level: int,
                     scale: float) -> Ciphertext:
        """Divide an extended-basis accumulator [2, ..., l+k, N] by P (exact
        divide-and-round): the one deferred mod-down of double hoisting."""
        return Ciphertext(self._mod_down_special(data.contiguous(), level),
                          scale, level)

    @telemetry.op("conjugate")
    def conjugate(self, a: Ciphertext) -> Ciphertext:
        return self.apply_galois(a, self.ctx.galois_elt_conjugate)

    # -- reduced-error ops (Kim et al. CT-RSA'22) -----------------------------

    @telemetry.op("set_scale_exact")
    def set_scale_exact(self, a: Ciphertext, target: float) -> Ciphertext:
        """Move a ciphertext to EXACTLY `target`: multiply by 1.0 encoded at
        the corrective scale target·q_last/scale, then rescale (one level)."""
        l = a.level
        assert l - self.ctx.rescale_limbs >= self.ctx.base_limbs, (
            "set_scale_exact: out of levels")
        cs = target * self.ctx.rescale_divisor(l) / a.scale
        out = self.rescale(self.mul_plain(
            a, self.make_plain(np.ones(1, dtype=np.float64), cs, l)))
        return replace(out, scale=float(target))

    def _match_scale_for_add(self, a: Ciphertext, b: Ciphertext):
        if _scales_close(a.scale, b.scale):
            return a, replace(b, scale=a.scale)
        if a.scale < b.scale:
            b, a = self._match_scale_for_add(b, a)
            return a, b
        f = a.scale / b.scale
        fi = int(round(f))
        if fi >= 1 and abs(f - fi) < 1e-6 * f:
            return a, replace(self.mul_const_int(b, fi), scale=a.scale)
        # Non-integer ratio (prime/scale drift): exact corrective multiply.
        b = self.set_scale_exact(b, a.scale)
        return self.mod_switch_to(a, b.level), b

    @telemetry.op("add_reduced_error")
    def add_reduced_error(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        l = min(a.level, b.level)
        a, b = self.mod_switch_to(a, l), self.mod_switch_to(b, l)
        return self.add(*self._match_scale_for_add(a, b))

    @telemetry.op("sub_reduced_error")
    def sub_reduced_error(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        l = min(a.level, b.level)
        a, b = self.mod_switch_to(a, l), self.mod_switch_to(b, l)
        neg = a.scale < b.scale
        if neg:
            a, b = b, a
        out = self.sub(*self._match_scale_for_add(a, b))
        return self.negate(out) if neg else out

    @telemetry.op("multiply_reduced_error")
    def multiply_reduced_error(self, a: Ciphertext, b: Ciphertext,
                               relin: bool = True) -> Ciphertext:
        l = min(a.level, b.level)
        return self.multiply(self.mod_switch_to(a, l),
                             self.mod_switch_to(b, l), relin=relin)

    @telemetry.op("rescale_to_scale")
    def rescale_to_scale(self, a: Ciphertext, target: float) -> Ciphertext:
        """Rescale once and relabel to `target` (the q/scale drift becomes
        approximation error, the reduced-error convention)."""
        out = self.rescale(a)
        assert _scales_close(out.scale, target, tol=0.05), (out.scale, target)
        return replace(out, scale=target)


def stack_cts(cts: list[Ciphertext], axis: int = 0) -> Ciphertext:
    """Stack same-scale ciphertexts on a new batch axis after the component
    axis: [k, l, N] x B -> [k, B, l, N]."""
    assert all(_scales_close(c.scale, cts[0].scale) for c in cts)
    return Ciphertext(torch.stack([c.data for c in cts], dim=1 + axis),
                      cts[0].scale, cts[0].level)


def unstack_cts(ct: Ciphertext, axis: int = 0) -> list[Ciphertext]:
    """The ciphertexts of one batch axis, each a contiguous copy."""
    return [Ciphertext(ct.data.select(1 + axis, i).contiguous(), ct.scale,
                       ct.level)
            for i in range(ct.data.shape[1 + axis])]


# ---------------------------------------------------------------------------
# Encryptor / Decryptor (host-boundary ops)
# ---------------------------------------------------------------------------

class Encryptor:
    def __init__(self, ctx: CkksContext, secret: Optional[SecretKey] = None,
                 public: Optional[PublicKey] = None, seed: int = 1,
                 secure: bool = False, rng=None):
        self.ctx = ctx
        self.secret = secret
        self.public = public
        self.rng = make_rng(seed, secure, rng)

    def _rns(self, host) -> torch.Tensor:
        return word_tensor(host, self.ctx.device, word=self.ctx.word)

    def encrypt_symmetric(self, pt: Plaintext, a=None) -> Ciphertext:
        """(b, a) with b = -(a·s) + e + m. ``a`` (residues [l, N], NTT
        form, numpy or a tensor in the chain's word) replaces the uniform
        draw. Recorded (``utils/telemetry.py``) as ``encrypt.sample`` spans
        (the host draws) and ``encrypt.device`` spans (the copies and the
        device part, the card synchronized at the end of the last)."""
        ctx, l = self.ctx, pt.level
        t = ctx.tables(l)
        mods = [ctx.all_moduli[i] for i in range(l)]
        if a is None:
            with telemetry.span("encrypt.sample"):
                a = sample_uniform_rns(self.rng, ctx.n, mods)
        if not isinstance(a, torch.Tensor):
            with telemetry.span("encrypt.device"):
                a = self._rns(a)
        with telemetry.span("encrypt.sample"):
            e = _to_rns(sample_gaussian(self.rng, ctx.n, ctx.params.error_std),
                        mods)
        with telemetry.span("encrypt.device", sync=True):
            e = self._rns(e)
            s = self.secret.ntt[:l]
            b = add_mod(neg_mod(mul_mod(a, s, t.q, t.ratio0, t.ratio1), t.q),
                        nttmod.ntt(e, t), t.q)
            b = add_mod(b, pt.data, t.q)
        return Ciphertext(torch.stack([b, a]), pt.scale)

    def encrypt_symmetric_seeded(self, pt: Plaintext):
        """Fresh symmetric encryption whose uniform c1 is expanded from a
        32-byte SHAKE-256 seed (SEAL's seeded-ciphertext compression): the
        wire form carries (c0, seed). Returns (Ciphertext, seed)."""
        seed = os.urandom(32)
        mods = [self.ctx.all_moduli[i] for i in range(pt.level)]
        a = expand_uniform(seed, self.ctx.n, mods, self.ctx.word)
        return self.encrypt_symmetric(pt, a=a), seed

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
            cts.append(add_mod(mul_mod(self.public.data[c], u_ntt, t.q,
                                       t.ratio0, t.ratio1),
                               nttmod.ntt(e, t), t.q))
        data = Evaluator(ctx)._mod_down_special(torch.stack(cts), ctx.L)
        data = data[:, : pt.level]
        tq = ctx.tables(pt.level).q
        c0 = add_mod(data[0], pt.data, tq)
        return Ciphertext(torch.stack([c0, data[1]]), pt.scale)


def expand_uniform(seed: bytes, n: int, moduli, word) -> np.ndarray:
    """Deterministic SHAKE-256 expansion of a uniform RNS poly (the c1 of a
    seeded ciphertext): both ends regenerate the same array from the seed."""
    from .csprng import ShakeRng
    rng = ShakeRng(seed)
    out = np.zeros((len(moduli), n), dtype=word)
    for i, q in enumerate(moduli):
        out[i] = rng.integers(0, int(q), size=n, dtype=np.uint64).astype(word)
    return out


class Decryptor:
    def __init__(self, ctx: CkksContext, secret: SecretKey):
        self.ctx = ctx
        self.secret = secret

    def decrypt_to_rns(self, ct: Ciphertext) -> np.ndarray:
        """c0 + c1·s (+ c2·s²) -> coefficient-domain residues [l, N], as
        the JAX package's array (uint32, or uint64 on a u64 chain)."""
        l = ct.level
        t = self.ctx.tables(l)
        s = self.secret.ntt[:l]
        acc = ct.data[0]
        spow = s
        for j in range(1, ct.k):
            acc = add_mod(acc, mul_mod(ct.data[j], spow, t.q, t.ratio0,
                                       t.ratio1), t.q)
            if j + 1 < ct.k:
                spow = mul_mod(spow, s, t.q, t.ratio0, t.ratio1)
        return to_numpy_word(nttmod.intt(acc.contiguous(), t))

    def decrypt(self, ct: Ciphertext, num_slots=None) -> np.ndarray:
        """Slot values of ct. Recorded as a ``decrypt.device`` span (the
        device decrypt and its copy to the host) and a ``decrypt.decode``
        span (the host CRT decode)."""
        with telemetry.span("decrypt.device"):
            res = self.decrypt_to_rns(ct)
        with telemetry.span("decrypt.decode"):
            return embedding.decode(res, ct.scale, self.ctx,
                                    tuple(range(ct.level)), num_slots)


def fake_bootstrap(ct: Ciphertext, dec: Decryptor, enc: Encryptor,
                   ev: Evaluator, target_level: int,
                   scale: Optional[float] = None) -> Ciphertext:
    """Decrypt/re-encrypt level reset: bring-up scaffolding only, which
    ``boot/bootstrap.py`` replaces. Batched ciphertexts refresh one by one.

    Recorded (``utils/telemetry.py``) as a ``refresh`` span, the card
    synchronized at its end, over the ``decrypt.*`` and ``encrypt.*`` spans
    of ``Decryptor.decrypt`` and ``Encryptor.encrypt_symmetric`` and a
    ``refresh.encode`` span of ``make_plain`` per ciphertext."""
    scale = scale or ev.ctx.params.scale
    with telemetry.span("refresh", level=ct.level, sync=True):
        return _refresh(ct, dec, enc, ev, target_level, scale)


def _refresh(ct, dec, enc, ev, target_level, scale) -> Ciphertext:
    if ct.batch:
        return stack_cts([_refresh(c, dec, enc, ev, target_level, scale)
                          for c in unstack_cts(ct)])
    values = dec.decrypt(ct)
    with telemetry.span("refresh.encode"):
        pt = ev.make_plain(values, scale, target_level)
    return enc.encrypt_symmetric(pt)
