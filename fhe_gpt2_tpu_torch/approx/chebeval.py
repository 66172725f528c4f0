"""Depth-optimal homomorphic Chebyshev-series evaluation (BSGS + recursive
splitting).

The port's copy of ``fhe_gpt2_tpu/approx/chebeval.py`` (numpy and the
backend protocol of ``nn/backend.py``), unchanged.

Counterpart of the reference's boot::Polynomial::homomorphic_poly_evaluation
(common/Polynomial.cpp:256-430, balanced k·2^m product heap) and of the
minicomp evaluation trees (PolyUpdate.h). The plan is built host-side from
Chebyshev coefficients; evaluation walks the plan with backend ops, so the
same plan runs on the plaintext simulator and on ciphertexts.

Split rule: T_i = 2·T_m·T_{i-m} − T_{2m−i} for i ≥ m, giving
p = q·T_m + r with deg(q) = deg(p) − m and deg(r) < m; recursing on halved m
until the residual fits the baby-step basis T_0..T_k. Multiplicative depth is
O(log deg), total ct mults ≈ deg/2 + 2√deg.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class ChebPlanNode:
    # Either a leaf (coeffs over T_0..T_k) or q·T_m + r.
    leaf_coeffs: Optional[np.ndarray] = None
    m: int = 0
    q: Optional["ChebPlanNode"] = None
    r: Optional["ChebPlanNode"] = None


@dataclass
class ChebEvalPlan:
    coeffs: np.ndarray         # float64 Chebyshev coefficients (deg+1)
    lo: float
    hi: float
    k: int                     # baby-step count: basis T_1..T_k
    giants: list               # [2k, 4k, ...] powers needed
    root: ChebPlanNode

    @property
    def degree(self) -> int:
        return len(self.coeffs) - 1


def make_plan(coeffs, lo: float, hi: float, k: Optional[int] = None) -> ChebEvalPlan:
    c = np.asarray(coeffs, dtype=np.float64)
    n = len(c) - 1
    if k is None:
        k = max(1, 1 << int(round(math.log2(max(math.sqrt(n / 2), 1)))))
    # Giant steps: T_{2k}, T_{4k}, ... up to >= n/2
    giants = []
    m = 2 * k
    while m <= n:
        giants.append(m)
        m *= 2
    root = _split(c, k, giants)
    return ChebEvalPlan(coeffs=c, lo=float(lo), hi=float(hi), k=k,
                        giants=giants, root=root)


def _split(c: np.ndarray, k: int, giants: list) -> ChebPlanNode:
    n = len(c) - 1
    if n <= k:
        return ChebPlanNode(leaf_coeffs=c.copy())
    # Smallest available step m (from {k} ∪ giants) with m > n/2, so both
    # halves have degree < m and the identity T_i = 2·T_m·T_{i-m} − T_{|2m-i|}
    # keeps every residual index below m.
    m = next(s for s in [k] + giants if s > n / 2)
    q = np.zeros(n - m + 1)
    r = np.zeros(m)
    r[:] = c[:m]
    # i == m: c_m·T_m = (c_m·T_0)·T_m  →  q[0] += c_m
    q[0] += c[m]
    for i in range(m + 1, n + 1):
        # c_i·T_i = 2·c_i·T_m·T_{i-m} − c_i·T_{|2m-i|}
        q[i - m] += 2.0 * c[i]
        r[abs(2 * m - i)] -= c[i]
    return ChebPlanNode(m=m, q=_split(q, k, giants), r=_split(r, k, giants))


def eval_plan(B, plan: ChebEvalPlan, x, basis: Optional[dict] = None,
              target=None):
    """Evaluate p(x) on backend B. x is the *unmapped* value; the affine map
    to [-1,1] is applied here (t = (2x − hi − lo)/(hi − lo)).

    `target` (CKKS backends): exact output scale; defaults to the context
    scale, so the whole plan lands at Δ with zero scale-correction levels."""
    a = 2.0 / (plan.hi - plan.lo)
    b = -(plan.hi + plan.lo) / (plan.hi - plan.lo)
    t = B.add_const(B.mul_const(x, a), b)
    if basis is None:
        basis = {}
    basis[1] = t
    # Baby steps T_2..T_k via T_{2n} = 2T_n²−1 and T_{a+b} = 2T_aT_b − T_{a−b}.
    for i in range(2, plan.k + 1):
        basis[i] = _cheb_from(B, basis, i)
    for g in plan.giants:
        basis[g] = _cheb_from(B, basis, g)
    if target is None and B.scale_of(t) is not None:
        target = B.ctx.params.scale
    return _eval_node(B, plan.root, basis, target=target)


def _cheb_from(B, basis, i):
    if i in basis:
        return basis[i]
    if i % 2 == 0 and i // 2 in basis:
        h = basis[i // 2]
        out = B.add_const(B.mul_const(B.square(h), 2.0), -1.0)
    elif i == 3:
        # T3 = t·(4t²−3) = t·(2·T2 − 1): integer ×2 and add_const are exact
        # at any tracked scale, so no cross-scale subtraction is needed
        # (T3 = 2·T2·T1 − T1 would subtract T1 at a drifted product scale,
        # costing a scale-correction level on narrow-word engines).
        out = B.mul(basis[1],
                    B.add_const(B.mul_const(basis[2], 2.0), -1.0))
    else:
        # T_{a+b} = 2 T_a T_b − T_{a−b}; pick a = largest power in basis < i.
        a = max(k for k in basis if k < i)
        b = i - a
        if b not in basis:
            basis[b] = _cheb_from(B, basis, b)
        prod = B.mul_const(B.mul(basis[a], basis[b]), 2.0)
        if a - b == 0:
            out = B.add_const(prod, -1.0)
        else:
            if a - b not in basis:
                basis[a - b] = _cheb_from(B, basis, a - b)
            out = B.sub(prod, basis[a - b])
    basis[i] = out
    return out


def _node_level(node: ChebPlanNode, basis, g: int = 1) -> Optional[int]:
    """Static output level of a plan node on a level-tracking backend
    (None = constant-only node). Mirrors _eval_node's op sequence: leaf
    terms are one plain multiply below their basis element; products are
    one rescale (g limbs; pairs under composite scaling) below
    min(level(q), level(T_m)); adds mod-switch to the lower side."""
    if node.leaf_coeffs is not None:
        c = node.leaf_coeffs
        lv = [basis[i].level for i in range(1, len(c)) if abs(c[i]) >= 1e-300]
        return min(lv) - g if lv else None
    lq = _node_level(node.q, basis, g)
    lt = basis[node.m].level
    lqt = (lt if lq is None else min(lq, lt)) - g
    lr = _node_level(node.r, basis, g)
    return lqt if lr is None else min(lqt, lr)


def _eval_node(B, node: ChebPlanNode, basis, target=None):
    """Evaluate a plan node. `target`: desired exact output scale (CKKS
    backends only; None = untracked/plain backend). Leaf terms are plain
    multiplies, whose scale-targeted encoding lands at ANY requested scale
    for free. For an internal q·T_m + r node the product's scale is
    predicted from the statically known levels (q's output scale is chosen
    so that scale(q)·scale(T_m)/q_drop == target), and `r` then targets the
    product's actual scale — so every add matches exactly and no
    scale-correction multiplies (extra levels) are ever inserted, even on
    narrow-word engines where primes sit far from Δ."""
    if node.leaf_coeffs is not None:
        c = node.leaf_coeffs
        acc = None
        for i in range(1, len(c)):
            if abs(c[i]) < 1e-300:
                continue
            term = B.mul_const(basis[i], float(c[i]), out_scale=target)
            acc = term if acc is None else B.add(acc, term)
        if acc is None:
            # Constant-only leaf: represent as c0 directly on a zero value.
            return float(c[0]) if len(c) else 0.0
        if len(c) and abs(c[0]) > 0:
            acc = B.add_const(acc, float(c[0]))
        return acc
    tm = basis[node.m]
    exact = target is not None and B.scale_of(tm) is not None
    if exact:
        ctx = B.ctx
        lq = _node_level(node.q, basis, ctx.rescale_limbs)
        if lq is None:
            q = _eval_node(B, node.q, basis)           # plain float
            qt = B.mul_const(tm, q, out_scale=target)
        else:
            lmul = min(lq, tm.level)
            delta = ctx.params.scale
            tq = None
            if lmul - ctx.rescale_limbs >= ctx.base_limbs:
                q_drop = ctx.rescale_divisor(lmul)
                tq = target * q_drop / B.scale_of(tm)
            # Keep targets near Δ: a predicted multiply at the chain bottom
            # (q0 ≫ Δ-sized primes) — or a prediction invalidated by an
            # auto-bootstrap firing mid-plan — would otherwise push scale
            # labels far from Δ, and a ciphertext at k·Δ (k ≥ q0·eps/Δ)
            # cannot be bootstrapped (its message overflows the EvalMod
            # window). Out-of-range targets fall back to the corrective-add
            # path, which costs at most one level.
            if tq is None or not (delta / 8 <= tq <= delta * 8):
                tq = None
            q = _eval_node(B, node.q, basis, target=tq)
            if isinstance(q, float):
                qt = B.mul_const(tm, q, out_scale=target)
            else:
                qt = B.mul(q, tm)
    else:
        q = _eval_node(B, node.q, basis)
        if isinstance(q, float):
            qt = B.mul_const(tm, q, out_scale=target)
        else:
            qt = B.mul(q, tm)
    r = _eval_node(B, node.r, basis, target=B.scale_of(qt))
    if isinstance(r, float):
        return B.add_const(qt, r)
    return B.add(qt, r)


def eval_cheb_numpy(coeffs, lo, hi, x):
    """Clenshaw float64 oracle."""
    t = (2.0 * np.asarray(x) - hi - lo) / (hi - lo)
    b1 = np.zeros_like(t)
    b2 = np.zeros_like(t)
    for ck in np.asarray(coeffs)[:0:-1]:
        b1, b2 = 2.0 * t * b1 - b2 + ck, b1
    return t * b1 - b2 + coeffs[0]
