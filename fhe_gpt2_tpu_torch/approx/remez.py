"""Multi-interval Remez exchange at arbitrary precision (host, mpmath).

The port's copy of ``fhe_gpt2_tpu/approx/remez.py``: host code over mpmath
and numpy, unchanged. The bootstrap imports it only to make an EvalMod
polynomial that ``approx/_cache/`` lacks, so a run that reads the cache
needs no mpmath.

Counterpart of the reference's offline approximation machinery
(common/Remez.{h,cpp} ``boot::Remez`` and common/MinicompRemez.{h,cpp}
``minicomp::Remez``), replacing NTL/GMP 1000-bit arithmetic with mpmath.
Runs offline only (polynomial tables are generated once and cached).

Polynomials are represented in the Chebyshev basis of the bounding interval
[-b, b] (or [lo, hi] affinely mapped), which is also what the homomorphic
BSGS evaluator consumes (approx/chebeval.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from mpmath import mp, mpf, cos, acos, pi, sqrt


@dataclass
class ChebPoly:
    """p(x) = sum_k c_k T_k((2x - hi - lo) / (hi - lo)) on [lo, hi]."""

    coeffs: list      # mpf Chebyshev coefficients
    lo: object
    hi: object

    @property
    def degree(self) -> int:
        return len(self.coeffs) - 1

    def _map(self, x):
        return (2 * x - self.hi - self.lo) / (self.hi - self.lo)

    def __call__(self, x):
        """Clenshaw evaluation at mpf/float x."""
        t = self._map(mpf(x))
        b1, b2 = mpf(0), mpf(0)
        for c in reversed(self.coeffs[1:]):
            b1, b2 = 2 * t * b1 - b2 + c, b1
        return t * b1 - b2 + self.coeffs[0]

    def monomial_coeffs(self) -> list:
        """Coefficients in the monomial basis of the mapped variable t.

        (For diagnostics/tests; homomorphic evaluation stays in Chebyshev.)
        """
        n = len(self.coeffs)
        # T_k recurrence in monomial form.
        T = [[mpf(1)], [mpf(0), mpf(1)]]
        for k in range(2, n):
            prev, prev2 = T[k - 1], T[k - 2]
            cur = [mpf(0)] * (k + 1)
            for i, c in enumerate(prev):
                cur[i + 1] += 2 * c
            for i, c in enumerate(prev2):
                cur[i] -= c
            T.append(cur)
        out = [mpf(0)] * n
        for k, ck in enumerate(self.coeffs):
            for i, c in enumerate(T[k]):
                out[i] += ck * c
        return out


def _cheb_vals(k: int, t):
    """T_0..T_k at mapped point t (iterative)."""
    vals = [mpf(1)]
    if k >= 1:
        vals.append(t)
    for i in range(2, k + 1):
        vals.append(2 * t * vals[-1] - vals[-2])
    return vals


def _cheb_eval_np(coeffs: np.ndarray, lo: float, hi: float,
                  x: np.ndarray) -> np.ndarray:
    """Vectorized float64 Clenshaw (scan-phase evaluation)."""
    t = (2.0 * x - hi - lo) / (hi - lo)
    b1 = np.zeros_like(t)
    b2 = np.zeros_like(t)
    for c in coeffs[:0:-1]:
        b1, b2 = 2.0 * t * b1 - b2 + float(c), b1
    return t * b1 - b2 + float(coeffs[0])


def remez(func, intervals, degree: int, odd: bool = False,
          prec_dps: int = 120, max_iter: int = 60, scan: int = 3000,
          tol=None, hull=None, func_np=None):
    """Minimax polynomial approximation of `func` over a union of intervals.

    intervals: list of (lo, hi) pairs (floats or mpf), ascending, disjoint.
    odd: restrict to odd Chebyshev terms (T_1, T_3, ...) — used for sign-type
    targets; intervals should then cover only the positive side, oddness
    extends to the mirror image.

    func_np: optional numpy-vectorized version of `func`. When given, the
    extreme-search scan (the cost center: tens of thousands of evaluations
    per iteration) runs in float64 — the reference fans this phase out over
    std::thread (Remez.cpp:376-396); here it vectorizes — while the solve on
    the ~degree reference points stays at mpf precision. Located extrema are
    accurate to the scan grid, which equioscillates the error to ~1e-6
    relative: far below any approximation error this framework consumes.

    Returns (ChebPoly over the hull [lo_min, hi_max] — odd polys use the
    symmetric hull [-hi_max, hi_max] — and the max error achieved).

    Mirrors boot::Remez / minicomp::Remez generate_optimal_poly: solve on a
    reference set, locate error extrema by dense scan, exchange, iterate.
    """
    old_dps = mp.dps
    mp.dps = prec_dps
    try:
        ivs = [(mpf(a), mpf(b)) for a, b in intervals]
        # `hull` widens the Chebyshev basis domain beyond the approximation
        # intervals so downstream evaluation at out-of-segment points (e.g.
        # masked piecewise windows) never extrapolates the basis.
        if odd:
            hull_hi = mpf(hull[1]) if hull else ivs[-1][1]
            hull_lo = -hull_hi
            terms = [k for k in range(1, degree + 1, 2)]
        else:
            hull_lo = mpf(hull[0]) if hull else ivs[0][0]
            hull_hi = mpf(hull[1]) if hull else ivs[-1][1]
            terms = list(range(degree + 1))
        n = len(terms)
        npts = n + 1

        def mapped(x):
            return (2 * x - hull_hi - hull_lo) / (hull_hi - hull_lo)

        # Initial reference: Chebyshev-like nodes distributed over intervals
        # proportionally to length.
        total = sum(b - a for a, b in ivs)
        pts = []
        alloc = []
        for a, b in ivs:
            alloc.append(max(2, int(round(npts * float((b - a) / total)))))
        while sum(alloc) > npts:
            alloc[alloc.index(max(alloc))] -= 1
        while sum(alloc) < npts:
            alloc[alloc.index(min(alloc))] += 1
        for (a, b), m in zip(ivs, alloc):
            for i in range(m):
                theta = pi * (m - 1 - i + mpf(0.5)) / m
                pts.append(a + (b - a) * (cos(theta) + 1) / 2)
        pts = sorted(pts)[:npts]

        err = None
        for _ in range(max_iter):
            # Solve: sum_j c_j T_{terms[j]}(x_i) + (-1)^i E = f(x_i)
            A = []
            rhs = []
            for i, x in enumerate(pts):
                tv = _cheb_vals(terms[-1], mapped(x))
                A.append([tv[k] for k in terms] + [mpf(-1) ** i])
                rhs.append(func(x))
            sol = _solve(A, rhs)
            coeffs_sparse = sol[:-1]
            err = abs(sol[-1])
            full = [mpf(0)] * (degree + 1)
            for j, k in enumerate(terms):
                full[k] = coeffs_sparse[j]
            poly = ChebPoly(full, hull_lo, hull_hi)

            # Find extrema of the error by dense scan + local refinement.
            def pick_alternating(cand):
                """Alternating-sign extrema of maximal magnitude, trimmed
                to npts from the smaller-magnitude end."""
                picked = []
                for x, e in cand:
                    if not picked:
                        picked.append((x, e))
                    elif (e > 0) == (picked[-1][1] > 0):
                        if abs(e) > abs(picked[-1][1]):
                            picked[-1] = (x, e)
                    else:
                        picked.append((x, e))
                while len(picked) > npts:
                    if abs(picked[0][1]) < abs(picked[-1][1]):
                        picked.pop(0)
                    else:
                        picked.pop()
                return picked

            def scan_mpf():
                cand = []
                for a, b in ivs:
                    xs = [a + (b - a) * i / scan for i in range(scan + 1)]
                    es = [func(x) - poly(x) for x in xs]
                    for i in range(len(xs)):
                        if i == 0 or i == len(xs) - 1 or \
                           (es[i] - es[i - 1]) * (es[i + 1] - es[i]) <= 0:
                            cand.append((xs[i], es[i]))
                return cand

            picked = None
            used_np = False
            if func_np is not None:
                fc = to_float_coeffs(poly)
                flo, fhi = float(hull_lo), float(hull_hi)
                # Anything below the float64 evaluation noise of the error
                # curve is rounding chatter, not an extremum; letting it into
                # the alternation pick floods the exchange with noise points
                # in intervals where the fit is locally far better than
                # elsewhere (observed: middle intervals of the bootstrap
                # cosine), which degenerates the reference set.
                noise = 1e-13 * max(1.0, float(np.abs(fc).sum()))
                cand = []
                for a, b in ivs:
                    xs = np.linspace(float(a), float(b), scan + 1)
                    es = np.asarray(func_np(xs), dtype=np.float64) \
                        - _cheb_eval_np(fc, flo, fhi, xs)
                    d = np.diff(es)
                    turn = np.nonzero(d[:-1] * d[1:] <= 0)[0] + 1
                    idx = np.unique(np.concatenate(([0], turn,
                                                    [len(xs) - 1])))
                    keep = idx[np.abs(es[idx]) >= noise]
                    for i in keep:
                        cand.append((mpf(float(xs[i])), mpf(float(es[i]))))
                picked = pick_alternating(cand)
                used_np = len(picked) >= npts
                if not used_np:
                    picked = None   # below float64 resolution: mpf rescan
            if picked is None:
                picked = pick_alternating(scan_mpf())
            if len(picked) < npts:
                break  # converged/degenerate; keep current poly
            pts = [x for x, _ in picked]
            emax = max(abs(e) for _, e in picked)
            emin = min(abs(e) for _, e in picked)
            iter_tol = tol if tol is not None else (
                mpf("1e-6") if used_np else mpf(10) ** (-(prec_dps // 2)))
            if emax - emin < iter_tol * emax:
                err = emax
                break
        return poly, err
    finally:
        mp.dps = old_dps


def _solve(A, b):
    """Gaussian elimination with partial pivoting over mpf."""
    n = len(A)
    M = [row[:] + [b[i]] for i, row in enumerate(A)]
    for col in range(n):
        piv = max(range(col, n), key=lambda r: abs(M[r][col]))
        M[col], M[piv] = M[piv], M[col]
        d = M[col][col]
        for r in range(col + 1, n):
            f = M[r][col] / d
            for c in range(col, n + 1):
                M[r][c] -= f * M[col][c]
    x = [mpf(0)] * n
    for r in range(n - 1, -1, -1):
        s = M[r][n] - sum(M[r][c] * x[c] for c in range(r + 1, n))
        x[r] = s / M[r][r]
    return x


def to_float_coeffs(poly: ChebPoly) -> np.ndarray:
    return np.array([float(c) for c in poly.coeffs], dtype=np.float64)


def cheb_interp(func, lo: float, hi: float, degree: int) -> ChebPoly:
    """Chebyshev interpolation at Chebyshev nodes (float64, numpy).

    Near-minimax (within a small factor of the best approximation) for
    smooth functions — the fast path for high-degree fits where the full
    Remez exchange is overkill. `func` takes/returns numpy arrays.
    """
    n = degree + 1
    k = np.arange(n)
    t = np.cos(np.pi * (k + 0.5) / n)                    # nodes in [-1, 1]
    x = (hi + lo) / 2 + (hi - lo) / 2 * t
    f = np.asarray(func(x), dtype=np.float64)
    # c_j = (2 - δ_j0)/n · Σ_k f_k cos(j π (k+1/2)/n)
    j = k[:, None]
    c = (2.0 / n) * (f[None, :] * np.cos(np.pi * j * (k[None, :] + 0.5) / n)).sum(1)
    c[0] /= 2.0
    from mpmath import mpf
    return ChebPoly([mpf(float(v)) for v in c], mpf(lo), mpf(hi))
