"""The encrypted sessions the cells run on: the ones the port's own entry
points build.

A ResNet-20 session is ``run_resnet.build_session``'s and a GPT-2 session
``run_gpt2.build_session``'s, from the configuration's flags: the same
parameters, keys (the whole base-16 digit set under ``--digit-keys``),
backend and Bootstrapper a user's run holds. Each takes the plans its
plain forward records rotations from; the cells hand it plans of only
what they serve, so set-up builds no plan that no request runs:

* ResNet: ``build_resnet_plans`` over weights whose convolutions outside
  the served blocks keep one tap. A block's plans are built from its own
  weights and layouts alone, so a served block's plans are those of the
  whole network; a convolution of one tap has a plan of one diagonal.
* GPT-2: a model of no blocks whose final LayerNorm is the served one.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Session:
    """The port's session, its parsed flags and what set-up recorded."""

    a: object                   # the entry point's parsed flags
    ctx: object
    B: object
    keygen_s: float
    galois_keys: int
    info: dict = field(default_factory=dict)


def served_weights(w: dict, depth: int, blocks) -> dict:
    """`w` with every convolution outside residual `blocks` (0-based), the
    stem's and the classifier's reduced to one small tap: a plan of one
    diagonal (an all-zero map has no plan), and values that stay inside
    the sign's domain in the session's plain forward."""
    n = (depth - 2) // 6
    keep = tuple(f"layer{b // n + 1}_{b % n}_" for b in blocks)
    out = dict(w)
    for k, v in w.items():
        conv = k in ("conv1", "linear_weight") or (
            k.startswith("layer") and k[-6:-1] == "_conv")
        if conv and not k.startswith(keep):
            tap = np.zeros_like(v)
            tap[(0, 0) + tuple(d // 2 for d in v.shape[2:])] = 2.0 ** -10
            out[k] = tap
    return out


def resnet_session(flags: list, device: str, w: dict, depth: int,
                   blocks, img: np.ndarray, relu_bound: float):
    """(plans, Session): ``build_resnet_plans`` of the served `blocks`
    and ``run_resnet.build_session`` of `flags`."""
    import time

    from fhe_gpt2_tpu_torch import run_resnet
    from fhe_gpt2_tpu_torch.approx.minimax import dp_schedule
    from fhe_gpt2_tpu_torch.cnn import resnet as R
    from fhe_gpt2_tpu_torch.nn import kernels as K

    a = run_resnet.parse_args(list(flags) + (["--cpu"] if device == "cpu"
                                             else []))
    serr = a.sign_log2_err
    sign = K.SignPlans.from_composite(
        dp_schedule(target_err=2.0 ** serr, eps=2.0 ** (serr + 2)))
    t0 = time.perf_counter()
    rp = R.build_resnet_plans(served_weights(w, depth, blocks), depth,
                              2 ** (a.logn - 1), h=img.shape[1],
                              relu_bound=relu_bound, sign=sign)
    plans_s = time.perf_counter() - t0
    s = run_resnet.build_session(a, rp, img)
    return rp, Session(a=a, ctx=s.ctx, B=s.B, keygen_s=s.keygen_s,
                       galois_keys=s.galois_keys,
                       info={"plans_s": plans_s})


def gpt2_args(flags: list, device: str):
    """``run_gpt2``'s parsed `flags`: its composite chain with the
    decrypt/re-encrypt refresh."""
    from fhe_gpt2_tpu_torch import run_gpt2

    a = run_gpt2.parse_args(list(flags) + (["--cpu"] if device == "cpu"
                                           else []))
    if not a.composite or a.real_boot:
        raise ValueError("the GPT-2 cells run run_gpt2's composite chain "
                         "with its decrypt/re-encrypt refresh")
    return a


def gpt2_session(a, sh, ln, emb: np.ndarray) -> Session:
    """``run_gpt2.build_session`` of the parsed flags `a`, its rotations
    recorded from the LayerNorm plans `ln` over `emb`."""
    from fhe_gpt2_tpu_torch import run_gpt2
    from fhe_gpt2_tpu_torch.nn.model import GPT2ModelPlans

    m = run_gpt2.Model(sh=sh, weights={}, ids=None, emb=emb,
                       plans=GPT2ModelPlans(sh=sh, blocks=[], ln_f=ln),
                       knobs=None, want=None, plans_s=0.0)
    s = run_gpt2.build_session(a, m)
    return Session(a=a, ctx=s.ctx, B=s.B, keygen_s=s.keygen_s,
                   galois_keys=s.galois_keys)
