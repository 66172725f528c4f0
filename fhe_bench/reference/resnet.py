"""Plain NumPy reference of the ResNet-20 blocks the benchmark serves.

ResNet-20 for CIFAR-10 (He et al. 2016, arXiv:1512.03385 §4.2) as the
encrypted pipeline of Lee et al. 2022 computes it: BatchNorm folded into
the convolution before it, every value stored divided by the ReLU bound B,
and ReLU(x) = x·(1 + sign(x))/2 with sign the composite minimax polynomial
the configuration states (its ``sign``: eps, degrees, error). That
polynomial is the departure from the published network; ``sign.py`` works
it out by the Remez exchange, and it is evaluated here by Clenshaw's
recurrence, in float64. Without a composite (``stages`` None) the ReLU is
the published max(x, 0), which makes the cells' inputs.

Nothing of the program is imported: this file works out again the folded
weights, the biases and the shortcut from the weight dictionary.
"""

from __future__ import annotations

import numpy as np

from . import sign

BN_EPS = 1e-5
WIDTHS = (16, 32, 64)


def sign_stages(spec: dict) -> tuple:
    """[(Chebyshev coefficients, lo, hi)] of the configuration's composite
    sign (``{"eps_log2", "err_log2", "degrees"}``), which has to reach its
    stated error."""
    stages, err = sign.composite(2.0 ** spec["eps_log2"],
                                 tuple(spec["degrees"]))
    if err > 2.0 ** spec["err_log2"]:
        raise ValueError(f"the sign composite {spec} reaches only {err}")
    return stages


def _cheb(c, lo, hi, x):
    t = (2.0 * x - (hi + lo)) / (hi - lo)
    b1 = np.zeros_like(t)
    b2 = np.zeros_like(t)
    for ck in c[:0:-1]:
        b1, b2 = 2.0 * t * b1 - b2 + ck, b1
    return t * b1 - b2 + c[0]


def relu(x: np.ndarray, stages) -> np.ndarray:
    """x·(1 + sign(x))/2 on normalized values (|x| <= 1); max(x, 0)
    without stages."""
    if stages is None:
        return np.maximum(x, 0.0)
    s = x
    for c, lo, hi in stages:
        s = _cheb(c, lo, hi, s)
    return x * (s * 0.5 + 0.5)


def conv2d(x: np.ndarray, w: np.ndarray, stride: int = 1) -> np.ndarray:
    """SAME-padded convolution. x: [ci, h, w]; w: [co, ci, kh, kw]."""
    co, ci, kh, kw = w.shape
    h, wd = x.shape[1:]
    xp = np.pad(x, ((0, 0), (kh // 2, kh // 2), (kw // 2, kw // 2)))
    out = np.zeros((co, h // stride, wd // stride), dtype=x.dtype)
    for dy in range(kh):
        for dx in range(kw):
            patch = xp[:, dy:dy + h:stride, dx:dx + wd:stride]
            out += np.einsum("oi,iyx->oyx", w[:, :, dy, dx], patch)
    return out


def conv_bn(w: dict, conv: str, bn: str, bound: float):
    """(weights, bias) of conv followed by BatchNorm, bias divided by B."""
    s = w[bn + "_weight"] / np.sqrt(w[bn + "_running_var"] + BN_EPS)
    wf = w[conv] * s[:, None, None, None]
    bf = w[bn + "_bias"] - w[bn + "_running_mean"] * s
    return wf, bf / bound


def block_layout(depth: int, index: int) -> tuple[int, int, int]:
    """(c_in, c_out, stride) of residual block `index` (0-based)."""
    n = (depth - 2) // 6
    stage = index // n
    cout = WIDTHS[stage]
    first = index % n == 0
    cin = WIDTHS[max(0, stage - 1)] if first else cout
    return cin, cout, (2 if stage > 0 and first else 1)


def stem(img: np.ndarray, w: dict, bound: float, stages) -> np.ndarray:
    """conv3x3(3→16) + BN + ReLU of an image, normalized by B."""
    wf, bf = conv_bn(w, "conv1", "bn1", bound)
    x = img / bound
    return relu(conv2d(x, wf) + bf[:, None, None], stages)


def block_pre(x: np.ndarray, w: dict, depth: int, index: int, bound: float,
              stages) -> np.ndarray:
    """Residual block `index` on normalized x up to its last ReLU:
    conv-BN-ReLU-conv-BN plus the identity shortcut (zero-padded and
    subsampled where the block down-samples, CIFAR option A)."""
    n = (depth - 2) // 6
    p = f"layer{index // n + 1}_{index % n}_"
    cin, cout, stride = block_layout(depth, index)
    w1, b1 = conv_bn(w, p + "conv1", p + "bn1", bound)
    w2, b2 = conv_bn(w, p + "conv2", p + "bn2", bound)
    h = relu(conv2d(x, w1, stride) + b1[:, None, None], stages)
    h = conv2d(h, w2) + b2[:, None, None]
    res = x[:, ::stride, ::stride]
    if cout != cin:
        pad = cout - cin
        res = np.pad(res, ((pad // 2, pad - pad // 2), (0, 0), (0, 0)))
    return h + res


def block(x: np.ndarray, w: dict, depth: int, index: int, bound: float,
          stages) -> np.ndarray:
    """Residual block `index` on normalized x, its last ReLU included."""
    return relu(block_pre(x, w, depth, index, bound, stages), stages)


def planar_pack(x: np.ndarray, slots: int) -> np.ndarray:
    """Channel-major planar packing (slot = c·H·W + y·W + x) into one slot
    vector, zero beyond the tensor."""
    flat = np.zeros(slots)
    flat[: x.size] = x.ravel()
    return flat


def planar_unpack(v: np.ndarray, shape: tuple) -> np.ndarray:
    size = int(np.prod(shape))
    return np.asarray(v).ravel()[:size].reshape(shape)
