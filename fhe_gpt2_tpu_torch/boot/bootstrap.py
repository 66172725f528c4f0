"""Full CKKS bootstrapping: ModRaise → SubSum → CoeffToSlot → EvalMod →
SlotToCoeff.

Counterpart of ``fhe_gpt2_tpu/boot/bootstrap.py``, on the port's evaluator:

  * CtS/StC are the factorised special-FFT LT specs (``boot/fft.py``)
    applied with the BSGS LT engine (``nn/linear.py``), double-hoisted;
  * EvalMod is a Remez minimax cosine over the integers evaluated with the
    Chebyshev planner, then double-angle iterations and an arcsin
    correction polynomial;
  * sparse slots come from SubSum and subring-sized FFT factors tiled over
    the replicated slot groups.

Scale bookkeeping: after ModRaise the scale is relabelled Q0, so the slots
hold x = (Δ/Q0)·m + I; EvalMod computes sin(2πx)/(2π) ≈ (Δ/Q0)·m with the
amplitude Q0/Δ folded into its last polynomial, and the output is
relabelled Δ.

``Bootstrapper.bootstrap`` runs the pipeline eagerly; ``bootstrap_jitted``
runs each stage as a sealed program (``nn/backend.py`` ``jit_sealed``: a
CUDA graph on the card, captured on first use), as the JAX package jits
each stage. EvalMod's
coefficients come from ``approx/_cache/``; ``approx/remez.py`` (and so
mpmath) is imported only to make a set the cache lacks.
"""

from __future__ import annotations

import copy
import json
import math
import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..approx.chebeval import eval_plan, make_plan
from ..core import ntt as nttmod
from ..core.evaluator import Ciphertext, stack_cts, unstack_cts
from ..core.modmath import reduce_mod, sub_mod, word_tensor
from ..nn.linear import LTSpec, apply_lt
from ..utils import telemetry
from . import fft

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "approx", "_cache")


# ---------------------------------------------------------------------------
# ModRaise
# ---------------------------------------------------------------------------

def _mod_raise_core(x, t_q0, t_full, q0_img, q0_half: int):
    """x: [k, 1, N] NTT form mod q0 -> [k, L, N] NTT form mod the full
    chain, in the chain's word (int32, or int64 on a u64 chain). Centred
    lift: v in [0, q0) maps to v if v <= q0/2, else v - q0, reduced into
    each target modulus."""
    coeff = nttmod.intt(x, t_q0)[..., 0, :]                 # [k, N] mod q0
    big = coeff > q0_half
    r = reduce_mod(coeff[..., None, :], t_full.q)
    r = torch.where(big[..., None, :], sub_mod(r, q0_img, t_full.q), r)
    return nttmod.ntt(r.contiguous(), t_full)


def _mod_raise_core2(x, t_base, t_full, q0_img, consts):
    """Composite-base ModRaise: x int32[k, 2, N] NTT form mod (q0a, q0b) ->
    int32[k, L, N] NTT form mod the full chain.

    Garner CRT-combines the two base limbs into X < Q0 = q0a·q0b < 2**62 in
    int64, centred-lifts it and reduces it into each target modulus with an
    exact remainder (canonical, so equal to the JAX package's 64-bit
    Barrett reduction)."""
    q0a, q0b, inv_a, q0_half = consts
    coeff = nttmod.intt(x, t_base)                           # [k, 2, N]
    x0 = coeff[..., 0, :]
    x1 = coeff[..., 1, :]
    x0b = reduce_mod(x0, q0b)                                # x0 mod q0b
    t = reduce_mod(sub_mod(x1, x0b, q0b).long() * inv_a, q0b)
    X = x0.long() + q0a * t.long()
    big = X > q0_half                                        # centred lift
    r = torch.remainder(X[..., None, :], t_full.q.long()).to(torch.int32)
    r = torch.where(big[..., None, :], sub_mod(r, q0_img, t_full.q), r)
    return nttmod.ntt(r.contiguous(), t_full)


def mod_raise(ctx, ct: Ciphertext) -> Ciphertext:
    """Raise a ciphertext at the base level (one limb, or the composite
    base pair) to the full chain, relabelled at scale Q0. On a limb axis
    every position reads the base limbs (``with_trailing``) and raises
    into its own."""
    Q0 = ctx.q0_int
    L = ctx.L
    t_full = ctx.tables(L)
    q0_img = ctx._cached(("q0_img", L), lambda: word_tensor(
        ctx.const_residues(Q0, ctx.data_limbs(L)), ctx.device,
        word=ctx.word))
    data = ctx.with_trailing(ct.data.contiguous(), ctx.base_limbs,
                             ctx.base_limbs)
    if ctx.base_limbs == 1:
        raised = _mod_raise_core(data, ctx.tables((0,)), t_full, q0_img,
                                 Q0 >> 1)
    else:
        assert ctx.base_limbs == 2, "composite base is a pair"
        q0a, q0b = ctx.moduli[0], ctx.moduli[1]
        raised = _mod_raise_core2(
            data, ctx.tables((0, 1)), t_full, q0_img,
            (q0a, q0b, pow(q0a, -1, q0b), Q0 >> 1))
    return Ciphertext(raised, float(Q0), L)


# ---------------------------------------------------------------------------
# EvalMod polynomial generation
# ---------------------------------------------------------------------------

@dataclass
class EvalModPoly:
    cos_plan: object          # Chebyshev plan for cos(2π(x-0.25)/sf) on ±K
    num_double: int
    arcsin_plan: object | None
    K: int
    eps: float
    arcsin_coeffs: object = None   # raw coeffs (for amplitude re-scaling)
    amp: float = 1.0               # folded output amplitude (Q0/Δ)

    def with_amplitude(self, amp: float) -> "EvalModPoly":
        """Fold an output amplitude into the final correction polynomial:
        how the Δ/Q0 value ratio is undone without extra multiplies."""
        ap = None
        if self.arcsin_coeffs is not None:
            c, lo, hi = self.arcsin_coeffs
            ap = make_plan(np.asarray(c) * amp, lo, hi)
        return replace(self, arcsin_plan=ap, amp=amp)


def evalmod_cache_path(K: int, eps: float, degree: int, num_double: int,
                       arcsin_degree: int, prec_dps: int) -> str:
    """The port's cache file of one EvalMod polynomial set (the JAX
    package's naming)."""
    return os.path.join(CACHE_DIR,
                        f"evalmod_K{K}_e{eps:.3e}_d{degree}_nd{num_double}"
                        f"_a{arcsin_degree}_p{prec_dps}.json")


def make_evalmod(K: int = 12, eps: float = 2 ** -8, degree: int = 30,
                 num_double: int = 2, arcsin_degree: int = 3,
                 prec_dps: int = 80, use_cache: bool = True) -> EvalModPoly:
    """Remez cosine over ∪_{i=-K..K} [i-eps, i+eps], then double-angle and
    arcsin correction. Read from ``approx/_cache/`` when the set is there;
    otherwise made with ``approx/remez.py`` and written there."""
    sf = 1 << num_double
    cache = evalmod_cache_path(K, eps, degree, num_double, arcsin_degree,
                               prec_dps)
    if use_cache and os.path.exists(cache):
        with open(cache) as f:
            d = json.load(f)
        cos_plan = make_plan(np.array(d["cos"]), d["cos_lo"], d["cos_hi"])
        arcsin_coeffs = None
        arcsin_plan = None
        if d.get("arcsin"):
            arcsin_coeffs = (np.array(d["arcsin"]), d["as_lo"], d["as_hi"])
            arcsin_plan = make_plan(*arcsin_coeffs)
        return EvalModPoly(cos_plan=cos_plan, num_double=num_double,
                           arcsin_plan=arcsin_plan, K=K, eps=eps,
                           arcsin_coeffs=arcsin_coeffs)
    from mpmath import asin as mp_asin, cos, mpf, pi as mp_pi

    from ..approx.remez import remez, to_float_coeffs
    intervals = [(mpf(i) - eps, mpf(i) + eps) for i in range(-K, K + 1)]

    def target(x):
        return cos(2 * mp_pi * (x - mpf("0.25")) / sf)

    def target_np(x):
        return np.cos(2 * np.pi * (np.asarray(x) - 0.25) / sf)

    poly, err = remez(target, intervals, degree, prec_dps=prec_dps,
                      scan=400, func_np=target_np)
    cos_plan = make_plan(to_float_coeffs(poly), float(poly.lo), float(poly.hi))
    arcsin_plan = None
    if arcsin_degree > 1:
        # Odd correction poly asin(t)/(2π): the argument is sin(2πf) with
        # |f| <= eps, so fit only the tiny range |t| <= ~2π·eps.
        bound = min(0.99, 2 * math.pi * eps * 1.5)
        ap, _ = remez(lambda t: mp_asin(t) / (2 * mp_pi),
                      [(mpf(bound) / 1000, mpf(bound))], arcsin_degree,
                      odd=True, prec_dps=prec_dps, scan=600,
                      func_np=lambda t: np.arcsin(np.asarray(t)) / (2 * np.pi))
        arcsin_plan = make_plan(to_float_coeffs(ap), float(ap.lo), float(ap.hi))
        arcsin_coeffs = (to_float_coeffs(ap), float(ap.lo), float(ap.hi))
    else:
        arcsin_coeffs = None
    if use_cache:
        d = {"cos": [float(c) for c in to_float_coeffs(poly)],
             "cos_lo": float(poly.lo), "cos_hi": float(poly.hi),
             "err": float(err)}
        if arcsin_coeffs is not None:
            d["arcsin"] = [float(c) for c in arcsin_coeffs[0]]
            d["as_lo"], d["as_hi"] = arcsin_coeffs[1], arcsin_coeffs[2]
        with open(cache, "w") as f:
            json.dump(d, f)
    return EvalModPoly(cos_plan=cos_plan, num_double=num_double,
                       arcsin_plan=arcsin_plan, K=K, eps=eps,
                       arcsin_coeffs=arcsin_coeffs)


def eval_mod(B, x, em: EvalModPoly):
    """y ≈ frac_centered(x) = x - round(x), for x within ±(K+eps) of
    integers: cos(2π(x-0.25)/sf), double-angle to sin(2πx), then
    asin(·)/(2π) (or the linear 1/(2π))."""
    y = eval_plan(B, em.cos_plan, x)
    for _ in range(em.num_double):
        y = B.add_const(B.mul_const(B.square(y), 2.0), -1.0)
    if em.arcsin_plan is not None:
        y = eval_plan(B, em.arcsin_plan, y)
    else:
        y = B.mul_const(y, em.amp / (2 * math.pi))
    return y


# ---------------------------------------------------------------------------
# Bootstrapper
# ---------------------------------------------------------------------------

class Bootstrapper:
    """Bootstraps level-exhausted ciphertexts back up the chain.

    Built over a CkksBackend (for the LT and polynomial kernels);
    construction precomputes the FFT factor plans and takes the EvalMod
    polynomials (its amplitude folded in)."""

    # True on a mesh position's copy (``on``): CkksBackend.bootstrap takes
    # the eager pipeline there, never the sealed one.
    eager_only = False

    def __init__(self, backend, num_slots: int | None = None,
                 target_level: int | None = None, cts_factors: int = 2,
                 stc_factors: int = 2, evalmod: EvalModPoly | None = None):
        B = backend
        ctx = B.ctx
        self.B = B
        self.ctx = ctx
        self.n = ctx.params.slots
        self.ns = num_slots or (ctx.params.sparse_slots or self.n)
        self.target_level = target_level or ctx.L
        em = evalmod or make_evalmod()
        # Fold Q0/Δ into the output amplitude (Q0: the base-limb product).
        self.em = em.with_amplitude(ctx.q0_float / ctx.params.scale)
        two_n_sub = 4 * self.ns
        exp_sub = (ctx.exp_of_slot[: self.ns] % two_n_sub).astype(np.int64)
        rep = self.n // self.ns
        # CoeffToSlot's inverse factors carry 1/2 per stage; the SubSum
        # replication factor 1/rep folds into the first one.
        inv = fft.build_fft_factors(self.ns, exp_sub, two_n_sub, inverse=True,
                                    num_factors=cts_factors,
                                    scale_all=1.0 / rep)
        fwd = fft.build_fft_factors(self.ns, exp_sub, two_n_sub, inverse=False,
                                    num_factors=stc_factors)
        self.cts_plans = [self._plan(f, "cts") for f in inv]
        self.stc_plans = [self._plan(f, "stc") for f in fwd]
        self.subsum_steps = [self.ns * (1 << i)
                             for i in range(int(math.log2(rep)))]
        self._i_vec = np.full(self.n, 1j)
        self._neg_i_vec = np.full(self.n, -1j)
        # The span of each stage (utils/telemetry.py): boot.<stage name>.
        self.stage_spans = tuple(f"boot.{name}" for name, _ in self.stages())

    def on(self, backend) -> "Bootstrapper":
        """This bootstrapper on another backend over the same chain (a mesh
        position's, ``parallel/mesh.py``): the FFT plans, the EvalMod
        polynomials and their host masks are shared, not rebuilt."""
        out = copy.copy(self)
        out.B, out.ctx = backend, backend.ctx
        out.__dict__.pop("_staged_jit", None)    # sealed on self.B
        # A position runs on its own thread and stream while the mesh's
        # exchanges wait on events across streams: it bootstraps eagerly.
        out.eager_only = True
        return out

    def _plan(self, diag: dict, name: str):
        rep = self.n // self.ns
        tiled = {(int(r), 0, 0): np.tile(v, rep) for r, v in diag.items()}
        spec = LTSpec(slots=self.n, n_src=1, n_dst=1, diagonals=tiled,
                      name=name)
        return spec.bsgs_plan()

    def required_steps(self) -> list[int]:
        """Rotation steps needed (for Galois keygen); conjugation is also
        needed."""
        steps = set(self.subsum_steps)
        for plan in self.cts_plans + self.stc_plans:
            steps.update(a for a in plan.baby_amounts if a)
            steps.update(jg for jg in plan.groups if jg)
        return sorted(steps)

    # -- pipeline -----------------------------------------------------------

    def stages(self) -> list:
        """[(name, fn)] with fn: list[Ciphertext] -> list[Ciphertext].
        Entry: one ct at the base level, scale exactly Δ. Exit: one ct up
        the chain, scale exactly Δ (value preserved)."""
        B, ctx = self.B, self.ctx
        ev = B.ev

        def prep(cts):
            [ct] = cts
            ct = mod_raise(ctx, ct)
            for s in self.subsum_steps:
                ct = ev.add(ct, ev.rotate(ct, s))
            return [ct]

        fns = [("prep", prep)]
        for i, p in enumerate(self.cts_plans):
            fns.append((f"cts{i}", lambda cts, p=p: apply_lt(B, p, cts)))

        def split(cts):
            # Real/imaginary split, stacked on the batch axis so EvalMod
            # (the deepest stage) runs once, batched.
            [y] = cts
            yc = ev.conjugate(y)
            ct_re = B.mul_const(ev.add(y, yc), 0.5)
            ct_im = B.mul_const(self._mul_neg_i(ev.sub(y, yc)), 0.5)
            ct_re = ev.mod_switch_to(ct_re, ct_im.level)
            return [stack_cts([ct_re, ct_im])]

        fns.append(("split", split))
        fns.append(("evalmod", lambda cts: [eval_mod(B, cts[0], self.em)]))

        def recombine(cts):
            ct_re, ct_im = unstack_cts(cts[0])
            return [B.add(ct_re, self._mul_i(ct_im))]

        fns.append(("recombine", recombine))
        for i, p in enumerate(self.stc_plans):
            fns.append((f"stc{i}", lambda cts, p=p: apply_lt(B, p, cts)))
        return fns

    def _normalize_entry(self, ct: Ciphertext) -> Ciphertext:
        """Mod-switch to the base level and pin the scale to exactly Δ.
        Drift up to 1e-4 is absorbed by relabelling; larger drift is fixed
        with one exact targeted multiply while levels remain."""
        ev = self.B.ev
        ctx = self.ctx
        delta = ctx.params.scale
        if (abs(ct.scale / delta - 1) > 1e-4
                and ct.level - ctx.rescale_limbs >= ctx.base_limbs):
            cs = delta * ctx.rescale_divisor(ct.level) / ct.scale
            ct = ev.rescale_to_scale(ev.mul_const(ct, 1.0, const_scale=cs),
                                     delta)
        if ct.level > ctx.base_limbs:
            ct = ev.mod_switch_to(ct, ctx.base_limbs)
        return replace(ct, scale=delta)

    def bootstrap(self, ct: Ciphertext, **kw) -> Ciphertext:
        """Refresh ct. Keywords are accepted and ignored, as in the JAX
        package. Each stage is a ``boot.<stage>`` span, with device events
        on the card."""
        assert ct.k == 2
        delta = ct.scale
        cuda = ct.data.is_cuda
        xs = [self._normalize_entry(ct)]
        for i, ((_, fn), name) in enumerate(zip(self.stages(),
                                                self.stage_spans)):
            with telemetry.span(name, index=i, events=cuda):
                xs = fn(xs)
        [out] = xs
        # The values are m at the context scale (amplitude folded into the
        # arcsin stage); relabel to the incoming scale exactly.
        return replace(out, scale=delta)

    def bootstrap_jitted(self, ct: Ciphertext) -> Ciphertext:
        """Staged sealed bootstrap: each stage of ``stages()`` is its own
        ``jit_sealed`` program (on the card a CUDA graph), made on first
        use and kept on this Bootstrapper, keyed inside by input signature.
        The entry normalisation runs eagerly, outside the programs, so
        every stage sees one signature per run. Threads take turns over the
        whole pipeline (the backend's ``_seal_lock``). A mesh position's
        bootstrapper (``on``) runs eagerly and refuses this. Each stage
        call is a ``boot.<stage>`` span, with device events on the card:
        a replay's stage times, and its op counts from the warm pass."""
        assert ct.k == 2
        if self.eager_only:
            raise ValueError("bootstrap_jitted: a mesh position's "
                             "bootstrapper (Bootstrapper.on) runs eagerly; "
                             "call bootstrap")
        delta = ct.scale
        cuda = ct.data.is_cuda
        xs = [self._normalize_entry(ct)]
        with self.B._seal_lock:
            jfs = getattr(self, "_staged_jit", None)
            if jfs is None:
                from ..nn.backend import jit_sealed
                jfs = []
                for i, ((_, fn), name) in enumerate(zip(self.stages(),
                                                        self.stage_spans)):
                    with telemetry.span(name, index=i, events=cuda):
                        jf = jit_sealed(self.B, fn, xs)
                        jfs.append(jf)
                        xs = jf(xs)
                self._staged_jit = jfs
            else:
                for i, (jf, name) in enumerate(zip(jfs, self.stage_spans)):
                    with telemetry.span(name, index=i, events=cuda):
                        xs = jf(xs)
        return replace(xs[0], scale=delta)

    def _mul_i(self, ct):
        """Multiply the slots by i (a plaintext constant vector)."""
        return self.B.mul_plain(ct, self._i_vec)

    def _mul_neg_i(self, ct):
        return self.B.mul_plain(ct, self._neg_i_vec)
