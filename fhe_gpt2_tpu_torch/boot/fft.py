"""Factorized special-FFT matrices for bootstrap CoeffToSlot / SlotToCoeff.

The port's copy of ``fhe_gpt2_tpu/boot/fft.py`` (numpy), unchanged.

Counterpart of the reference's LT-coefficient machinery (Bootstrapper.cpp
genfftcoeff{,_3} :594-1909, generate_LT_coefficient_3 :1922, sfl/sflinv
factor application :2299-2585) rebuilt on this framework's slot convention.

Math. With slot j holding m(ζ^{e_j}), e_j = 5^j mod 2N (5-orbit, e ≡ 1 mod 4)
and y_k = c_k + i·c_{k+n} (n = N/2 slots), decode is z = E·y with
E[j,k] = ζ^{e_j·k}. E factors into log2(n) butterfly stages, each with three
diagonals at offsets {0, ±m}:

    stage(m):  out[j]   = in[j] + w_j·in[j+m]        (j mod 2m < m)
               out[j]   = in[j-m] + w_j·in[j]        (otherwise)
    w_j = ζ^{2^depth · e_{j mod 2m}}  with sign flip built into e.

The input ordering after all stages is bit-reversed in k — never
materialized: EvalMod is slotwise and StC applies the exact inverse stages in
reverse order, so the permutation cancels (same reason the reference's
3-factor sfl matrices never unscramble).

Stages are grouped into `factors` LT specs by sparse diagonal composition;
each factor costs one level and ~#diagonals BSGS rotations.
"""

from __future__ import annotations

import numpy as np

from ..nn.linear import LTSpec


def _stage_diagonals(n: int, depth: int, exp_of_slot: np.ndarray,
                     two_n: int, inverse: bool):
    """Diagonals {offset: complex[n]} for one butterfly stage.

    depth d couples j with j ± m where m = n / 2^(d+1); twiddle for the pair
    with base index jb (jb mod 2m < m) is ζ^{2^d·e_jb}... derived from the
    recursion in the module docstring. `inverse` gives the stage inverse
    (for the encode direction).
    """
    m = n >> (depth + 1)
    j = np.arange(n)
    lo = (j % (2 * m)) < m        # first half of each block pair
    # Twiddle: the block at this depth is a size-2m sub-transform at points
    # χ^{e_{j'}} (χ = ζ^{2^depth}, j' = j mod 2m); its split twiddle for the
    # output at block index j' is χ^{e_{j'}}, and e_{j'+m} exponentiates to
    # the negation of the pair-base twiddle automatically.
    def chi_pow(idx):
        e = exp_of_slot[idx] % two_n
        return np.exp(2j * np.pi * (((1 << depth) * e) % two_n) / two_n)

    w_own = chi_pow(j % (2 * m))   # χ^{e_{j mod 2m}}
    w_pair = chi_pow(j % m)        # χ^{e_{j mod m}} (the lo-partner twiddle)
    d0 = np.zeros(n, dtype=np.complex128)
    dp = np.zeros(n, dtype=np.complex128)   # offset +m
    dm = np.zeros(n, dtype=np.complex128)   # offset -m
    if not inverse:
        # out[lo] = in[j] + w_own·in[j+m];  out[hi] = in[j-m] + w_own·in[j]
        d0[lo] = 1.0
        dp[lo] = w_own[lo]
        d0[~lo] = w_own[~lo]
        dm[~lo] = 1.0
    else:
        # Inverse butterfly (w = w_pair): a = (o_lo + o_hi)/2 at lo;
        # b = (o_lo − o_hi)/(2w) at hi.
        d0[lo] = 0.5
        dp[lo] = 0.5
        d0[~lo] = -0.5 / w_pair[~lo]
        dm[~lo] = 0.5 / w_pair[~lo]
    out = {0: d0}
    # At the top stage m == n/2, so +m and −m coincide mod n: accumulate.
    for off, v in ((m % n, dp), ((-m) % n, dm)):
        if off in out:
            out[off] = out[off] + v
        else:
            out[off] = v
    return out


def _compose(a: dict, b: dict, n: int) -> dict:
    """Diagonal composition: (A·B) where out = A(B(in)).

    A-diag at offset p, B-diag at offset q: contributes at offset p+q with
    value a_p[j] · b_q[(j+p) mod n].
    """
    out: dict = {}
    for p, ap in a.items():
        for q, bq in b.items():
            r = (p + q) % n
            v = ap * np.roll(bq, -p)
            if r in out:
                out[r] = out[r] + v
            else:
                out[r] = v
    return out


def build_fft_factors(n: int, exp_of_slot: np.ndarray, two_n: int,
                      inverse: bool, num_factors: int,
                      scale_all: complex = 1.0) -> list[dict]:
    """Group the log2(n) stages into `num_factors` composed diagonal dicts.

    Forward (decode direction, coeffs→slots): stages applied deepest first.
    Inverse (encode direction, slots→coeffs): reversed inverse stages.
    Factors are returned in application order. `scale_all` multiplies into
    the first factor (e.g. 1/n normalizations, EvalMod range scaling).
    """
    logn = n.bit_length() - 1
    stages = list(range(logn))
    if not inverse:
        # decode: deepest (largest depth) stage touches smallest blocks and
        # is applied first.
        order = list(reversed(stages))
        mats = [_stage_diagonals(n, d, exp_of_slot, two_n, False) for d in order]
    else:
        order = stages
        mats = [_stage_diagonals(n, d, exp_of_slot, two_n, True) for d in order]
    # Group contiguous stages: later-applied stages compose on the left.
    groups = np.array_split(np.arange(logn), num_factors)
    factors = []
    for g in groups:
        acc = None
        for s in g:
            acc = mats[s] if acc is None else _compose(mats[s], acc, n)
        factors.append(acc)
    if scale_all != 1.0:
        factors[0] = {k: v * scale_all for k, v in factors[0].items()}
    return factors


def factor_to_ltspec(diagonals: dict, slots: int, name: str = "fft") -> LTSpec:
    """Wrap a single-ct diagonal dict as an LTSpec (complex masks)."""
    return LTSpec(slots=slots, n_src=1, n_dst=1,
                  diagonals={(int(r), 0, 0): v for r, v in diagonals.items()},
                  name=name)


def apply_factors_numpy(factors: list[dict], y: np.ndarray) -> np.ndarray:
    """Dense oracle: apply composed diagonal factors to a vector."""
    n = len(y)
    for f in factors:
        out = np.zeros(n, dtype=np.complex128)
        for r, v in f.items():
            out += v * np.roll(y, -r)
        y = out
    return y
