"""KV-cache slot augmentation for autoregressive decode.

Counterpart of the reference's optimize.cpp:3-39 (augment_value_row/col) and
the cache update in attentionLayer (layers.cpp:44-50): the cached K/V
activation ciphertexts are updated in place by masking out the slot row of
the new token and adding the freshly projected row.

In the diagonal-form attention (nn/layers.py) the cache holds K and V in the
standard activation layout, so augmentation is a single mask-multiply + add
per cache tensor; growing context is slot augmentation, not resharding
(SURVEY §5 long-context note).

The port's copy of ``fhe_gpt2_tpu/nn/kvcache.py``, unchanged.
"""

from __future__ import annotations

import numpy as np

from .layers import GPT2Shapes


_ROW_MASKS: dict = {}


def row_masks(sh: GPT2Shapes, row: int) -> tuple[np.ndarray, np.ndarray]:
    """(keep_mask, row_mask) over the act layout for one sequence row.
    Memoized: identity-stable arrays for the backend's encoding cache."""
    key = (sh, row)
    m = _ROW_MASKS.get(key)
    if m is None:
        keep = np.ones((sh.act.n_cts, sh.slots))
        sel = np.zeros((sh.act.n_cts, sh.slots))
        r = np.full(sh.hidden, row)
        c = np.arange(sh.hidden)
        ct, sl = sh.act.place(r, c)
        keep[ct, sl] = 0.0
        sel[ct, sl] = 1.0
        m = (keep, sel)
        _ROW_MASKS[key] = m
    return m


def augment(B, cache: list, new: list, sh: GPT2Shapes, row: int) -> list:
    """cache' = cache·(1 − row mask) + new·(row mask) — insert the new
    token's projected row into the cached K or V activation cts."""
    keep, sel = row_masks(sh, row)
    out = []
    for i, (c, n) in enumerate(zip(cache, new)):
        out.append(B.add(B.mul_plain(c, keep[i]), B.mul_plain(n, sel[i])))
    return out


# ---------------------------------------------------------------------------
# Incremental decode (the reference's intended KV-cache path: per-token
# projection + cache augmentation inside attentionLayer, layers.cpp:44-50)
# ---------------------------------------------------------------------------

from dataclasses import dataclass, field

_ACTIVE_MASKS: dict = {}


def active_mask(sh: GPT2Shapes, row: int) -> np.ndarray:
    """1 on data slots of rows ≤ row, 0 elsewhere (identity-stable for the
    backend's encoding cache)."""
    key = (sh, row)
    m = _ACTIVE_MASKS.get(key)
    if m is None:
        m = np.zeros((sh.act.n_cts, sh.slots))
        r = np.repeat(np.arange(row + 1), sh.hidden)
        c = np.tile(np.arange(sh.hidden), row + 1)
        ct, sl = sh.act.place(r, c)
        m[ct, sl] = 1.0
        _ACTIVE_MASKS[key] = m
    return m


@dataclass
class KVCaches:
    """Per-layer cached K/V activation ct lists (act layout)."""
    k: list = field(default_factory=list)    # [n_layers][n_cts]
    v: list = field(default_factory=list)

    @staticmethod
    def empty(B, sh: GPT2Shapes, n_layers: int) -> "KVCaches":
        z = np.zeros((sh.act.n_cts, sh.slots))

        def zeros():
            return [B.from_slots(z[i]) for i in range(sh.act.n_cts)]

        return KVCaches(k=[zeros() for _ in range(n_layers)],
                        v=[zeros() for _ in range(n_layers)])


def decode_block(B, xs, sh: GPT2Shapes, bp, caches: KVCaches, layer: int,
                 row: int):
    """One transformer block in incremental-decode mode: only the new token's
    row of xs is live; K/V are projected for the full ct, the `row` row is
    spliced into the layer cache, and attention reads K/V from the cache.

    Correctness leans on diagonal-form attention being row-local in the
    residual stream: junk at inactive rows never reaches active rows because
    attention targets come only from the (real) cached K/V rows."""
    from . import layers as L

    ap = bp.attn
    h = L.layer_norm(B, xs, sh, bp.ln1)
    k_new = L._apply_matmul(B, ap.k, h, ap.kb)
    v_new = L._apply_matmul(B, ap.v, h, ap.vb)
    caches.k[layer] = augment(B, caches.k[layer], k_new, sh, row)
    caches.v[layer] = augment(B, caches.v[layer], v_new, sh, row)
    a = L.attention(B, h, sh, ap, kv=(caches.k[layer], caches.v[layer]))
    # Keep inactive rows exactly zero: attention output at rows > row is
    # junk (their Q is LN-of-zero noise), and letting it into the residual
    # stream would blow the next block's Newton-rsqrt basin.
    am = active_mask(sh, row)
    a = [B.mul_plain(y, am[i]) for i, y in enumerate(a)]
    xs = [B.add(x, y) for x, y in zip(xs, a)]
    h = L.layer_norm(B, xs, sh, bp.ln2)
    m = L.mlp(B, h, sh, bp.mlp)
    m = [B.mul_plain(y, am[i]) for i, y in enumerate(m)]
    return [B.add(x, y) for x, y in zip(xs, m)]


def decode_step(B, plans, caches: KVCaches, x_row: np.ndarray, row: int):
    """Feed ONE token (embedded row vector x_row [hidden]) at position `row`
    through all blocks incrementally; returns the final-LN hidden row.

    The live-token activation ct is rebuilt host-side per step (cheap: one
    row); cached K/V stay encrypted across steps."""
    from . import layers as L

    sh = plans.sh
    act = np.zeros((sh.seq, sh.hidden))
    act[row] = x_row
    xs = [B.from_slots(v) for v in sh.act.pack(act)]
    for li, bp in enumerate(plans.blocks):
        xs = decode_block(B, xs, sh, bp, caches, li, row)
    xs = L.layer_norm(B, xs, sh, plans.ln_f)
    out = np.stack([B.to_slots(x) for x in xs])
    return sh.act.unpack(out)[row]
