"""Plain NumPy reference of GPT-2 small's first LayerNorm as the encrypted
pipeline computes it.

GPT-2's LayerNorm (HF ``openai-community/gpt2``: layer_norm_epsilon 1e-5)
is γ·(x − μ)/√(σ² + ε) + β over each row of 768. The encrypted pipeline
computes it without a division or a square root: z = d·x − Σx, s = Σz²,
r ≈ 1/√(s + 1) by a Taylor seed of order 3 at a calibration point a and
then Newton steps y ← y·(1.5 − 0.5·(s + 1)·y²), and out = z·r·γ√d + β.
The departures from the published layer are the ones that formulation
makes: ε becomes 1/d³ on the variance (the +1 on s), and r is the Newton
iterate, not the exact root. The calibration point is 1.25 times the
largest row's s over the served inputs, worked out here again from them.
"""

from __future__ import annotations

import numpy as np

EPS = 1.0          # added to Σz² (the reference implementation's +1)
INIT_MARGIN = 1.25


def row_sums(x: np.ndarray) -> np.ndarray:
    """Σz² of each row, z = d·x − Σx."""
    d = x.shape[-1]
    z = d * x - x.sum(axis=-1, keepdims=True)
    return (z * z).sum(axis=-1)


def newton_init(rows: np.ndarray) -> float:
    """The Newton calibration point for rows [..., d] of LayerNorm inputs."""
    return INIT_MARGIN * float(row_sums(rows).max())


def layer_norm(x: np.ndarray, gamma: np.ndarray, beta: np.ndarray,
               init: float, iters: int) -> np.ndarray:
    """The pipeline's LayerNorm of rows x [seq, d], in float64."""
    d = x.shape[-1]
    z = d * x - x.sum(axis=-1, keepdims=True)
    s = (z * z).sum(axis=-1, keepdims=True) + EPS
    a = float(init)
    am1 = a - 1.0
    c = [am1 ** -0.5, -0.5 * am1 ** -1.5, 0.375 * am1 ** -2.5,
         (-1.875 / 6.0) * am1 ** -3.5]
    dx = s - a
    y = c[0] + c[1] * dx + c[2] * dx * dx + c[3] * dx * dx * dx
    for _ in range(iters):
        y = y * (1.5 - 0.5 * s * y * y)
    return z * y * (gamma * np.sqrt(d)) + beta


def strided_unpack(v: np.ndarray, rows: int, cols: int,
                   stride: int) -> np.ndarray:
    """Rows of `cols` values at `stride` slots apart, over the slot
    vectors v [n_cts, slots] (the fold layout: stride = 2·next_pow2(cols))."""
    v = np.atleast_2d(np.asarray(v))
    per_ct = v.shape[-1] // stride
    out = np.zeros((rows, cols))
    for r in range(rows):
        ct, k = divmod(r, per_ct)
        out[r] = v[ct, k * stride:k * stride + cols]
    return out

