"""General slot-linear transforms with BSGS rotation scheduling.

The port's copy of ``fhe_gpt2_tpu/nn/linear.py`` (numpy and the backend
protocol of ``nn/backend.py``), unchanged but for the ``apply_lt`` span of
``utils/telemetry.py``.

TPU-first replacement for the reference's rotation-profligate packed matmuls
(MatrixMul.cpp row/col/attn-proj kernels do O(10^4..10^5) masked rotations per
768×768 projection; plain model plain_approx/matrix_mul.py:51-109). Any
plaintext-weighted linear map between packed ciphertext groups is
  out[dst] = Σ_ρ diag_{ρ,src,dst} ⊙ rot(in[src], ρ)
and is evaluated here with baby-step/giant-step decomposition
(ρ = j·g + i ⇒ out = Σ_j rot_{jg}(Σ_{i,src} rot_{-jg}(diag) ⊙ rot_i(in))),
bringing a 768×768 projection from ~10^5 rotations to ~2√s.

The same engine drives: tight-layout matmuls, head split/merge, format
repacking (the reference's pack_tight), and the bootstrap CoeffToSlot /
SlotToCoeff factors (boot/).

Specs are built host-side in numpy from sparse (dst, src, weight) triples —
layout math lives in nn/formats.py; this module is layout-agnostic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..utils import telemetry


@dataclass
class LTSpec:
    """Sparse slot-linear map between a group of ciphertexts.

    diagonals[(rho, src, dst)] = float mask m (length `slots`):
        out[dst] += m ⊙ rotate(in[src], rho)
    """

    slots: int
    n_src: int
    n_dst: int
    diagonals: dict
    name: str = ""

    @property
    def rotation_amounts(self) -> list[int]:
        return sorted({r for (r, _, _) in self.diagonals})

    def bsgs_plan(self, giant: int | None = None) -> "BsgsPlan":
        amounts = self.rotation_amounts
        if giant is None:
            giant = max(1, int(math.isqrt(max(self.slots // 2, 1))))
            # Heuristic: balance #babies vs #giants for this amount set.
            best, best_cost = giant, None
            for g in {giant // 2, giant, giant * 2, 16, 32, 64, 128, 256}:
                if g < 1:
                    continue
                babies = {a % g for a in amounts}
                giants = {a - a % g for a in amounts}
                cost = len(babies) + len(giants) * self.n_dst
                if best_cost is None or cost < best_cost:
                    best, best_cost = g, cost
            giant = best
        groups: dict = {}
        for (rho, src, dst), mask in self.diagonals.items():
            i, jg = rho % giant, rho - rho % giant
            # Pre-rotate the mask by -jg (host side) so the giant rotation
            # can be applied after accumulation.
            groups.setdefault(jg, {}).setdefault(dst, []).append(
                (i, src, np.roll(mask, jg)))
        return BsgsPlan(spec=self, giant=giant, groups=groups)


@dataclass
class BsgsPlan:
    spec: LTSpec
    giant: int
    # groups[jg][dst] = list of (i, src, premask)
    groups: dict

    @property
    def baby_amounts(self) -> list[int]:
        out = set()
        for g in self.groups.values():
            for terms in g.values():
                out |= {i for (i, _, _) in terms}
        return sorted(out)

    def masks(self) -> list:
        """Every premask of the plan."""
        return [m for g in self.groups.values() for terms in g.values()
                for (_, _, m) in terms]

    def num_rotations(self) -> int:
        return (len([a for a in self.baby_amounts if a]) +
                sum(1 for jg, g in self.groups.items() if jg for _ in g))


def lt_from_triples(slots: int, n_src: int, n_dst: int,
                    dst_ct, dst_slot, src_ct, src_slot, weight,
                    name: str = "") -> LTSpec:
    """Build a spec from parallel numpy arrays of matrix entries.

    out[dst_ct][dst_slot] += weight * in[src_ct][src_slot]
    """
    dst_ct = np.asarray(dst_ct, dtype=np.int64)
    dst_slot = np.asarray(dst_slot, dtype=np.int64)
    src_ct = np.asarray(src_ct, dtype=np.int64)
    src_slot = np.asarray(src_slot, dtype=np.int64)
    weight = np.asarray(weight, dtype=np.float64)
    rho = (src_slot - dst_slot) % slots
    key = ((rho * n_src + src_ct) * n_dst + dst_ct)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    diag: dict = {}
    # Split into runs with identical (rho, src, dst) and scatter each run's
    # weights into a mask indexed by dst_slot.
    boundaries = np.flatnonzero(np.diff(key_s)) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(key_s)]])
    for s0, e0 in zip(starts, ends):
        idx = order[s0:e0]
        r = int(rho[idx[0]])
        sc = int(src_ct[idx[0]])
        dc = int(dst_ct[idx[0]])
        mask = np.zeros(slots)
        np.add.at(mask, dst_slot[idx], weight[idx])
        k = (r, sc, dc)
        if k in diag:
            diag[k] = diag[k] + mask
        else:
            diag[k] = mask
    return LTSpec(slots=slots, n_src=n_src, n_dst=n_dst, diagonals=diag,
                  name=name)


# ---------------------------------------------------------------------------
# Evaluation (backend-generic)
# ---------------------------------------------------------------------------

@telemetry.traced("apply_lt")
def apply_lt(B, plan: BsgsPlan, xs, level_cost_note: str = ""):
    """Evaluate a planned LT. xs: list of backend values (len n_src).

    Consumes one multiplicative level (the diagonal masks). Rotation count =
    plan.num_rotations(); baby rotations are shared across sources and giant
    rotations across destination accumulators.
    """
    spec = plan.spec
    # Baby-rotated inputs: hoisted per source (one digit decomposition per
    # src covers every baby amount) when the backend supports it.
    baby_cache: dict = {}
    needed: dict = {}
    for per_dst in plan.groups.values():
        for terms in per_dst.values():
            for (i, src, _) in terms:
                needed.setdefault(src, set()).add(i)
    if hasattr(B, "lt_hoist_ext") and not getattr(B, "no_ext_hoist", False):
        # Double-hoisted path: baby rotations stay in the extended QP basis,
        # the masked accumulation runs there, and each destination pays ONE
        # mod-down instead of one per rotation (the per-rotation mod-down is
        # the NTT-dominated half of a key switch).
        ext = B.lt_hoist_ext(xs, {s: sorted(a) for s, a in needed.items()})
        out = [None] * spec.n_dst
        batched_giant = hasattr(B, "rotate_same_batched")
        for jg, per_dst in sorted(plan.groups.items()):
            dsts, accs = [], []
            for dst, terms in per_dst.items():
                acc = B.lt_mask_sum_ext(
                    [ext[(src, i)] for (i, src, _) in terms],
                    [m for (_, _, m) in terms])
                dsts.append(dst)
                accs.append(acc)
            if jg:
                # One batched keyswitch for every destination's giant step.
                if batched_giant:
                    accs = B.rotate_same_batched(accs, jg)
                else:
                    accs = [B.rotate(a, jg) for a in accs]
            for dst, acc in zip(dsts, accs):
                out[dst] = acc if out[dst] is None else B.add(out[dst], acc)
        return out
    if hasattr(B, "rotate_many"):
        for src, amounts in needed.items():
            amounts = sorted(amounts)
            outs = B.rotate_many(xs[src], amounts)
            for i, v in zip(amounts, outs):
                baby_cache[(src, i)] = v

    def baby(src, i):
        k = (src, i)
        if k not in baby_cache:
            baby_cache[k] = xs[src] if i == 0 else B.rotate(xs[src], i)
        return baby_cache[k]

    fused = hasattr(B, "mul_plain_many_sum")
    out = [None] * spec.n_dst
    for jg, per_dst in sorted(plan.groups.items()):
        for dst, terms in per_dst.items():
            if fused:
                acc = B.mul_plain_many_sum(
                    [baby(src, i) for (i, src, _) in terms],
                    [m for (_, _, m) in terms])
            else:
                acc = None
                for (i, src, premask) in terms:
                    t = B.mul_plain(baby(src, i), premask)
                    acc = t if acc is None else B.add(acc, t)
            if jg:
                acc = B.rotate(acc, jg)
            out[dst] = acc if out[dst] is None else B.add(out[dst], acc)
    return out


def apply_lt_unplanned(B, spec: LTSpec, xs):
    """Direct (no BSGS) evaluation — small specs and tests."""
    out = [None] * spec.n_dst
    for (rho, src, dst), mask in sorted(spec.diagonals.items()):
        x = xs[src] if rho == 0 else B.rotate(xs[src], rho)
        t = B.mul_plain(x, mask)
        out[dst] = t if out[dst] is None else B.add(out[dst], t)
    return out


def lt_matrix_oracle(spec: LTSpec, xs: np.ndarray) -> np.ndarray:
    """Dense numpy oracle for tests: apply the map literally."""
    s = spec.slots
    out = np.zeros((spec.n_dst, s))
    for (rho, src, dst), mask in spec.diagonals.items():
        out[dst] += mask * np.roll(xs[src], -rho)
    return out
