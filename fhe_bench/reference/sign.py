"""The composite minimax sign, worked out from its definition in NumPy.

Lee et al. (2021, "Minimax approximation of sign function by composite
polynomial for homomorphic comparison") approximate sign(x) on ±[eps, 1]
by p_k ∘ … ∘ p_1, each p_i the odd polynomial of degree d_i closest to 1
in the uniform norm on [a_i, b_i]: a_1 = eps, b_1 = 1, and each later
stage acts on the band the one before leaves, [1 − E_i, 1 + E_i]. The
configuration states eps, the degrees and the error the composite has to
reach; this module finds each stage by the Remez exchange in float64 (in
the Chebyshev basis of [−b_i, b_i], where the odd terms are well
conditioned) and nothing else: no coefficient table is read.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

GRID = 40001


def _odd_cheb(x: np.ndarray, b: float, m: int) -> np.ndarray:
    """[len(x), m] values of T_1, T_3, …, T_{2m−1} at x/b."""
    t = np.clip(x / b, -1.0, 1.0)
    th = np.arccos(t)
    return np.cos(np.outer(th, 2 * np.arange(m) + 1))


def _extrema(x: np.ndarray, e: np.ndarray) -> np.ndarray:
    """Indices of the local extrema of e on the grid x, ends included."""
    inner = np.flatnonzero((np.abs(e[1:-1]) >= np.abs(e[:-2]))
                           & (np.abs(e[1:-1]) >= np.abs(e[2:]))
                           & (np.sign(e[1:-1]) != 0)) + 1
    return np.unique(np.concatenate([[0], inner, [len(x) - 1]]))


def _alternate(idx: np.ndarray, e: np.ndarray, n: int) -> np.ndarray:
    """n extrema of alternating sign, the largest of each run of one
    sign, then the smaller end dropped until n are left."""
    keep = []
    for i in idx:
        if keep and np.sign(e[i]) == np.sign(e[keep[-1]]):
            if abs(e[i]) > abs(e[keep[-1]]):
                keep[-1] = i
        else:
            keep.append(i)
    while len(keep) > n:
        keep.pop(0 if abs(e[keep[0]]) < abs(e[keep[-1]]) else -1)
    return np.asarray(keep)


def odd_minimax(a: float, b: float, degree: int, iters: int = 60):
    """(coefficients of T_0 … T_degree on [−b, b], error E) of the odd
    polynomial of `degree` closest to 1 on [a, b]."""
    m = (degree + 1) // 2
    # A grid dense at both ends of [a, b] (where extrema crowd).
    g = 0.5 * (a + b) - 0.5 * (b - a) * np.cos(np.linspace(0, np.pi, GRID))
    A_grid = _odd_cheb(g, b, m)
    k = np.arange(m + 1)
    pts = 0.5 * (a + b) - 0.5 * (b - a) * np.cos(np.pi * k / m)
    E = 0.0
    for _ in range(iters):
        A = np.hstack([_odd_cheb(pts, b, m),
                       ((-1.0) ** k)[:, None]])
        sol = np.linalg.solve(A, np.ones(m + 1))
        c, E = sol[:m], sol[m]
        e = A_grid @ c - 1.0
        sel = _alternate(_extrema(g, e), e, m + 1)
        if len(sel) < m + 1:
            break
        # Refine each extremum: the vertex of the parabola through the
        # grid point and its neighbours.
        new = []
        for i in sel:
            lo, hi = max(i - 1, 0), min(i + 1, GRID - 1)
            if lo == i or hi == i:
                new.append(g[i])
                continue
            x0, x1, x2 = g[lo], g[i], g[hi]
            y0, y1, y2 = e[lo], e[i], e[hi]
            den = (x0 - x1) * (x0 - x2) * (x1 - x2)
            p2 = (x2 * (y1 - y0) + x1 * (y0 - y2) + x0 * (y2 - y1)) / den
            p1 = (x2 * x2 * (y0 - y1) + x1 * x1 * (y2 - y0)
                  + x0 * x0 * (y1 - y2)) / den
            new.append(min(max(-p1 / (2 * p2), x0), x2) if p2 else x1)
        pts_new = np.asarray(new)
        worst = np.abs(e).max()
        if np.allclose(pts_new, pts, rtol=0, atol=1e-15 * b) or \
                worst - abs(E) <= 1e-13 * abs(E):
            pts = pts_new
            break
        pts = pts_new
    full = np.zeros(degree + 1)
    full[1::2] = c
    e = A_grid @ c - 1.0
    return full, float(np.abs(e).max())


@lru_cache(maxsize=None)
def composite(eps: float, degrees: tuple) -> tuple:
    """((coefficients, lo, hi) per stage, final error) of the composite
    sign of `degrees` on ±[eps, 1]."""
    a, b = eps, 1.0
    stages, err = [], 1.0
    for d in degrees:
        c, err = odd_minimax(a, b, d)
        stages.append((c, -b, b))
        a, b = 1.0 - err, 1.0 + err
    return tuple(stages), err
