"""Weights and inputs of the cells, made from the run's seed.

Both sides (the program and the plain reference) get the same arrays from
here. The ResNet weights follow the recipe of the port's synthetic
weights (convolutions N(0, 1)·scale/√c_in, BatchNorm γ ~ U(0.7, 1.3),
β, μ ~ N(0, 0.1), σ² ~ U(0.5, 1.5)); at a block scale of 0.24 and a ReLU
bound of 10 every normalized pre-ReLU value of ResNet-20 stays near or
below 0.65 on seeded images, inside the sign polynomial's domain. GPT-2's
embedding rows and LayerNorm parameters follow the port's synthetic GPT-2
(embeddings N(0, 0.05), γ ~ U(0.8, 1.2), β ~ N(0, 0.02)); an embedding row
is drawn from the seed and its token id, so a pool of token ids needs no
whole 50,257-row table.
"""

from __future__ import annotations

import numpy as np

WIDTHS = (16, 32, 64)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one purpose of one run: the seed and a stream tag."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *stream])


def resnet_weights(g: np.random.Generator, depth: int, n_classes: int,
                   block_scale: float) -> dict:
    """A ResNet-`depth` CIFAR weight dictionary in the reference layout
    (``conv1``, ``bn1_*``, ``layer{s}_{b}_conv{1,2}``, ``..._bn{1,2}_*``,
    ``linear_weight``, ``linear_bias``)."""
    n = (depth - 2) // 6
    w = {"conv1": g.standard_normal((16, 3, 3, 3)) * 0.25}

    def bn(p, c):
        w[f"{p}_weight"] = g.uniform(0.7, 1.3, c)
        w[f"{p}_bias"] = g.standard_normal(c) * 0.1
        w[f"{p}_running_mean"] = g.standard_normal(c) * 0.1
        w[f"{p}_running_var"] = g.uniform(0.5, 1.5, c)

    bn("bn1", 16)
    for s in range(1, 4):
        cw = WIDTHS[s - 1]
        cin = WIDTHS[max(0, s - 2)] if s > 1 else 16
        for b in range(n):
            p = f"layer{s}_{b}_"
            c1 = cin if b == 0 else cw
            w[p + "conv1"] = g.standard_normal((cw, c1, 3, 3)) * (
                block_scale / np.sqrt(c1))
            w[p + "conv2"] = g.standard_normal((cw, cw, 3, 3)) * (
                block_scale / np.sqrt(cw))
            bn(p + "bn1", cw)
            bn(p + "bn2", cw)
    w["linear_weight"] = g.standard_normal((n_classes, 64)) * 0.3
    w["linear_bias"] = g.standard_normal(n_classes) * 0.1
    return w


def images(g: np.random.Generator, count: int, shape) -> list:
    """Seeded images with pixels uniform in [-1, 1]."""
    return [g.uniform(-1.0, 1.0, tuple(shape)) for _ in range(count)]


def gpt2_ln(seed: int, d: int) -> tuple[np.ndarray, np.ndarray]:
    """(γ, β) of GPT-2's first LayerNorm."""
    g = rng(seed, 2, 0)
    return g.uniform(0.8, 1.2, d), g.normal(0.0, 0.02, d)


def embedding_rows(seed: int, ids: np.ndarray, d: int,
                   embed_std: float = 0.05) -> np.ndarray:
    """wte[ids] + wpe[:len(ids)] of a table drawn from the seed, row by
    row from (seed, token) and (seed, position)."""
    out = np.zeros((len(ids), d))
    for pos, tok in enumerate(ids):
        out[pos] = (rng(seed, 2, 1, int(tok)).normal(0.0, embed_std, d)
                    + rng(seed, 2, 2, pos).normal(0.0, embed_std, d))
    return out
