"""Encrypted ResNet-20/32/44/56/110 on CIFAR (the reference's flagship CNN
pipeline, cnn_ckks/.../cnn/infer_seal.cpp:251-584).

Structure: conv3x3(3→16) + BN + ReLU, then 3 stages of n residual blocks at
widths (16, 32, 64) with stride-2 transitions, global avgpool, FC(64→10).
n = (depth − 2) / 6 (20→3, 32→5, 44→7, 56→9, 110→18).

All linear pieces (conv+folded-BN, downsample, pool, FC) are LT specs; ReLU
is the composite-minimax sign kernel with B-boundary scaling
(ReLU_seal/minimax_ReLU_seal semantics, B=40); bootstraps interleave per the
level budget via backend.maybe_bootstrap.

The port's copy of ``fhe_gpt2_tpu/cnn/resnet.py``: the same plans, packing,
bootstrap placement and float oracle over the port's backends. The forward
runs eagerly, or, with jit=True, through the segment driver
(``_forward_jit``), whose segments are sealed programs (CUDA graphs on the
card, ``nn/backend.py`` ``jit_sealed``). ``synthetic_weights`` makes
reference-format weights from a numpy generator, for runs without the
pretrained files. Each eager segment is a ``segment.stem``/``.block``/
``.tail`` span of ``utils/telemetry.py`` (a sealed one is
``segment_runner``'s ``segment.<name>``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..nn import kernels as K
from ..nn.linear import apply_lt
from ..utils import telemetry
from .conv import PlanarLayout, avgpool_spec, bias_vector, conv2d_spec, \
    fc_spec, fold_bn


# Where the reference's pretrained weight folders (``resnet20_new/``, ...)
# are read from by default: a ``pretrained_parameters/`` folder at the root
# of the checkout. The repository does not ship them.
WEIGHTS_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "pretrained_parameters")


def load_reference_weights(depth: int = 20, dataset: str = "cifar10",
                           root: str = WEIGHTS_ROOT) -> dict:
    """Read the reference's per-layer text weight files
    (format documented in cnn_ckks README; reader parity with
    infer_seal.cpp:33-106 import_parameters_cifar10 and
    infer_seal.cpp:108-249 import_parameters_cifar100).

    dataset="cifar100" (resnet32 only, like the reference) uses learned
    1x1-conv + BN downsample shortcuts (option B) and a 64→100 classifier;
    CIFAR-10 nets use identity-with-zero-pad shortcuts (option A)."""
    if dataset == "cifar100":
        assert depth == 32, "reference ships CIFAR-100 weights for depth 32"
        d = os.path.join(root, "resnet32_cifar100")
        n_classes = 100
    else:
        d = os.path.join(root, f"resnet{depth}_new")
        n_classes = 10

    def arr(name, shape=None):
        v = np.loadtxt(os.path.join(d, name + ".txt"))
        return v.reshape(shape) if shape else v

    n = (depth - 2) // 6
    w = {}
    w["conv1"] = arr("conv1_weight", (16, 3, 3, 3))
    for k in ("weight", "bias", "running_mean", "running_var"):
        w[f"bn1_{k}"] = arr(f"bn1_{k}")
    widths = [16, 32, 64]
    for s in range(1, 4):
        cw = widths[s - 1]
        cin = widths[max(0, s - 2)] if s > 1 else 16
        for b in range(n):
            p = f"layer{s}_{b}_"
            c1_in = cin if b == 0 else cw
            w[p + "conv1"] = arr(p + "conv1_weight", (cw, c1_in, 3, 3))
            w[p + "conv2"] = arr(p + "conv2_weight", (cw, cw, 3, 3))
            for bn in ("bn1", "bn2"):
                for k in ("weight", "bias", "running_mean", "running_var"):
                    w[f"{p}{bn}_{k}"] = arr(f"{p}{bn}_{k}")
            if dataset == "cifar100" and s > 1 and b == 0:
                # Learned downsample: shortcut_0 = 1x1 stride-2 conv,
                # shortcut_1 = BN (import_parameters_cifar100 reads these
                # from layer{s}_0_shortcut_*).
                w[p + "shortcut_conv"] = arr(p + "shortcut_0_weight",
                                             (cw, c1_in, 1, 1))
                for k in ("weight", "bias", "running_mean", "running_var"):
                    w[f"{p}shortcut_bn_{k}"] = arr(f"{p}shortcut_1_{k}")
    w["linear_weight"] = arr("linear_weight", (n_classes, 64))
    w["linear_bias"] = arr("linear_bias")
    return w


@dataclass
class ResNetPlans:
    depth: int
    slots: int
    stem: tuple                    # (plan, bias_vec, layout_out)
    blocks: list                   # list of dicts per residual block
    pool: object
    fc: object
    fc_bias: np.ndarray
    relu_bound: float
    sign: K.SignPlans
    layouts: list
    normalized: bool = False
    relu_need: int = 0             # levels one ReLU consumes on this engine


def build_resnet_plans(weights: dict, depth: int, slots: int,
                       h: int = 32, relu_bound: float = 40.0,
                       sign: Optional[K.SignPlans] = None,
                       giant=None, normalize: bool = True) -> ResNetPlans:
    """`normalize=True` keeps every stored ciphertext value at true/B
    (B = relu_bound) — the reference's B-boundary invariant (ReLU_seal,
    cnn_seal.cpp:577-592): all linear maps commute with the 1/B factor,
    biases are pre-divided, sign sees [-1,1] directly, and — critically —
    values stay inside the bootstrap EvalMod window (|m| ≤ eps·q0/Δ), so
    real bootstraps can fire anywhere. Decoded logits are re-multiplied
    by B in logits_from_slots."""
    n = (depth - 2) // 6
    if sign is None:
        from ..approx.minimax import auto_schedule
        sign = K.SignPlans.from_composite(
            auto_schedule(target_err=2.0 ** -10, eps=2.0 ** -7))
    lay = PlanarLayout(3, h, h, slots)
    l16 = PlanarLayout(16, h, h, slots)
    bdiv = relu_bound if normalize else 1.0

    def conv_bn(wname, bnname, lin, lout, stride=1):
        cw = weights[wname]
        wf, bf = fold_bn(cw, np.zeros(cw.shape[0]),
                         weights[f"{bnname}_weight"], weights[f"{bnname}_bias"],
                         weights[f"{bnname}_running_mean"],
                         weights[f"{bnname}_running_var"])
        spec = conv2d_spec(wf, lin, lout, stride, name=wname)
        return spec.bsgs_plan(giant), bias_vector(lout, bf / bdiv)

    stem_plan, stem_bias = conv_bn("conv1", "bn1", lay, l16)
    blocks = []
    widths = [16, 32, 64]
    lin = l16
    for s in range(1, 4):
        cw = widths[s - 1]
        for b in range(n):
            stride = 2 if (s > 1 and b == 0) else 1
            hh = lin.h // stride
            lout = PlanarLayout(cw, hh, hh, slots)
            p = f"layer{s}_{b}_"
            plan1, bias1 = conv_bn(p + "conv1", p + "bn1", lin, lout, stride)
            plan2, bias2 = conv_bn(p + "conv2", p + "bn2", lout, lout, 1)
            short = None
            short_bias = None
            if p + "shortcut_conv" in weights:
                # Learned 1x1-conv + BN downsample (option B — the CIFAR-100
                # nets, import_parameters_cifar100).
                short, short_bias = conv_bn(p + "shortcut_conv",
                                            p + "shortcut_bn", lin, lout,
                                            stride)
            elif stride != 1 or lin.c != cw:
                # Identity-with-zero-pad shortcut (CIFAR ResNet option A):
                # subsample spatially, pad channels — a pure repack LT.
                eye = np.zeros((cw, lin.c, 1, 1))
                for c in range(min(lin.c, cw)):
                    eye[c + (cw - lin.c) // 2, c, 0, 0] = 1.0
                short = conv2d_spec(eye, lin, lout, stride,
                                    name=p + "short").bsgs_plan(giant)
            blocks.append(dict(plan1=plan1, bias1=bias1, plan2=plan2,
                               bias2=bias2, short=short,
                               short_bias=short_bias, lin=lin, lout=lout))
            lin = lout
    pool = avgpool_spec(lin, slots).bsgs_plan(giant)
    fcw = weights["linear_weight"].T        # [64, 10]
    fc = fc_spec(fcw, 64, slots).bsgs_plan(giant)
    return ResNetPlans(depth=depth, slots=slots,
                       stem=(stem_plan, stem_bias, l16), blocks=blocks,
                       pool=pool, fc=fc,
                       fc_bias=weights["linear_bias"] / bdiv,
                       relu_bound=relu_bound, sign=sign,
                       layouts=[lay, l16, lin], normalized=normalize,
                       relu_need=K.sign_depth(sign) + 2)


def pack_input(rp: ResNetPlans, img: np.ndarray) -> list:
    """Pack an input image in the plans' storage convention."""
    x = img / rp.relu_bound if rp.normalized else img
    return list(rp.layouts[0].pack(x))


def _relu(B, xs, rp: ResNetPlans):
    bound = 1.0 if rp.normalized else rp.relu_bound
    return [K.relu(B, x, rp.sign, bound=bound) for x in xs]


def forward_segments(B, rp: ResNetPlans, boot_between: bool = True) -> list:
    """The forward pass as a list of ct-list → ct-list callables: stem, one
    per residual block, and the pool/FC tail, run one after the other by
    ``forward``."""

    # Bootstrap placement (reference schedule, infer_seal.cpp:465-533:
    # conv → BN → bootstrap → ReLU): refresh right before each ReLU when the
    # remaining chain cannot cover the sign composite's measured depth plus
    # the following conv. No magic level numbers — rp.relu_need is computed
    # from the actual plans; backend auto-boot remains the safety net when
    # the post-bootstrap budget is shorter than one ReLU.
    need = rp.relu_need + 1

    def pre_relu(vs):
        if not boot_between:
            return vs
        return [B.maybe_bootstrap(v, need) for v in vs]

    @telemetry.traced("segment.stem")
    def stem(xs):
        plan, bias, _ = rp.stem
        xs = apply_lt(B, plan, xs)
        xs = [B.add_plain(x, bias[i]) for i, x in enumerate(xs)]
        return _relu(B, pre_relu(xs), rp)

    def block(xs, blk, bi):
        with telemetry.span("segment.block", index=bi):
            return _block(xs, blk)

    def _block(xs, blk):
        h = apply_lt(B, blk["plan1"], xs)
        h = [B.add_plain(v, blk["bias1"][i]) for i, v in enumerate(h)]
        h = _relu(B, pre_relu(h), rp)
        h = apply_lt(B, blk["plan2"], h)
        h = [B.add_plain(v, blk["bias2"][i]) for i, v in enumerate(h)]
        res = xs if blk["short"] is None else apply_lt(B, blk["short"], xs)
        if blk.get("short_bias") is not None:
            res = [B.add_plain(v, blk["short_bias"][i]) if v is not None
                   else None for i, v in enumerate(res)]
        # A None residual entry is a zero map output (option-A zero-pad
        # shortcut at multi-ct layouts: channel-pad destination cts with no
        # source diagonals).
        h = [a if b is None else B.add(a, b) for a, b in zip(h, res)]
        return _relu(B, pre_relu(h), rp)

    @telemetry.traced("segment.tail")
    def tail(xs):
        xs = apply_lt(B, rp.pool, xs)
        xs = apply_lt(B, rp.fc, xs)
        return [B.add_plain(xs[0], _fc_bias_vec(rp))]

    segs = [stem]
    segs += [lambda xs, blk=blk, bi=bi: block(xs, blk, bi)
             for bi, blk in enumerate(rp.blocks)]
    segs.append(tail)
    return segs


def forward(B, xs, rp: ResNetPlans, boot_between: bool = True, jit=False):
    """Encrypted ResNet forward. xs: planar-packed ct list (usually 1 ct).

    jit=True runs the segment driver (``_forward_jit``): fine-grained
    segments split at the bootstrap boundaries, each a sealed program (a
    CUDA graph on the card), with the bootstraps between them outside the
    programs through the Bootstrapper's staged sealed pipeline. Blocks of
    the same geometry rebind to the first's call (``rebind_sealed``), each
    with a program of its own."""
    if jit:
        return _forward_jit(B, xs, rp, boot_between)
    for s in forward_segments(B, rp, boot_between):
        xs = s(xs)
    return xs


def _forward_jit(B, xs, rp: ResNetPlans, boot_between: bool = True):
    from ..nn.backend import segment_runner

    need = rp.relu_need + 1
    run = segment_runner(B, "resnet", rp)

    def boot(vs, n=None):
        if not boot_between:
            return vs
        return [B.maybe_bootstrap(v, n if n is not None else need)
                for v in vs]

    def relu_fn(vs):
        return _relu(B, vs, rp)

    def stem_fn(vs):
        plan, bias, _ = rp.stem
        vs = apply_lt(B, plan, vs)
        return [B.add_plain(x, bias[i]) for i, x in enumerate(vs)]

    xs = run("stem", stem_fn, xs)
    xs = run("relu", relu_fn, boot(xs))
    for bi, blk in enumerate(rp.blocks):
        geo = (blk["lin"].c, blk["lout"].c, blk["short"] is not None)

        def conv1_fn(vs, blk=blk):
            h = apply_lt(B, blk["plan1"], vs)
            return [B.add_plain(v, blk["bias1"][i]) for i, v in enumerate(h)]

        h = run(("conv1", geo), conv1_fn, xs, part=bi)
        h = run("relu", relu_fn, boot(h))
        nh = len(h)

        def conv2_fn(both, blk=blk, nh=nh):
            h, res_in = both[:nh], both[nh:]
            v = apply_lt(B, blk["plan2"], h)
            v = [B.add_plain(t, blk["bias2"][i]) for i, t in enumerate(v)]
            res = (res_in if blk["short"] is None
                   else apply_lt(B, blk["short"], res_in))
            if blk.get("short_bias") is not None:
                res = [B.add_plain(t, blk["short_bias"][i]) if t is not None
                       else None for i, t in enumerate(res)]
            return [a if b is None else B.add(a, b) for a, b in zip(v, res)]

        h = run(("conv2", geo), conv2_fn, h + xs, part=bi)
        xs = run("relu", relu_fn, boot(h))

    def tail_fn(vs):
        vs = apply_lt(B, rp.pool, vs)
        vs = apply_lt(B, rp.fc, vs)
        return [B.add_plain(vs[0], _fc_bias_vec(rp))]

    return run("tail", tail_fn, boot(xs, 3))


def _fc_bias_vec(rp: ResNetPlans) -> np.ndarray:
    v = np.zeros(rp.slots)
    v[: len(rp.fc_bias)] = rp.fc_bias
    return v


def logits_from_slots(rp: ResNetPlans, slots_vec: np.ndarray) -> np.ndarray:
    out = np.asarray(slots_vec).ravel()[: len(rp.fc_bias)]
    return out * rp.relu_bound if rp.normalized else out


# Float oracle (host) -------------------------------------------------------

def _conv2d_np(x: np.ndarray, w: np.ndarray, stride: int = 1) -> np.ndarray:
    """SAME-padded conv oracle. x: [ci, h, w]; w: [co, ci, kh, kw]."""
    co, ci, kh, kw = w.shape
    h, wd = x.shape[1:]
    oh, ow = h // stride, wd // stride
    xp = np.pad(x, ((0, 0), (kh // 2, kh // 2), (kw // 2, kw // 2)))
    out = np.zeros((co, oh, ow))
    for dy in range(kh):
        for dx in range(kw):
            patch = xp[:, dy:dy + h:stride, dx:dx + wd:stride]
            out += np.einsum("oi,iyx->oyx", w[:, :, dy, dx], patch)
    return out


def forward_float(weights: dict, depth: int, img: np.ndarray) -> np.ndarray:
    """Numpy reference forward (exact ReLU) — the correctness oracle."""
    n = (depth - 2) // 6

    def bn(x, p):
        g, b = weights[p + "_weight"], weights[p + "_bias"]
        m, v = weights[p + "_running_mean"], weights[p + "_running_var"]
        s = g / np.sqrt(v + 1e-5)
        return x * s[:, None, None] + (b - m * s)[:, None, None]

    x = np.maximum(bn(_conv2d_np(img, weights["conv1"]), "bn1"), 0)
    widths = [16, 32, 64]
    for s in range(1, 4):
        cw = widths[s - 1]
        for b in range(n):
            stride = 2 if (s > 1 and b == 0) else 1
            p = f"layer{s}_{b}_"
            h = np.maximum(bn(_conv2d_np(x, weights[p + "conv1"], stride),
                              p + "bn1"), 0)
            h = bn(_conv2d_np(h, weights[p + "conv2"]), p + "bn2")
            if p + "shortcut_conv" in weights:
                res = bn(_conv2d_np(x, weights[p + "shortcut_conv"], stride),
                         p + "shortcut_bn")
            elif stride != 1 or x.shape[0] != cw:
                res = x[:, ::stride, ::stride]
                pad = cw - res.shape[0]
                res = np.pad(res, ((pad // 2, pad - pad // 2), (0, 0), (0, 0)))
            else:
                res = x
            x = np.maximum(h + res, 0)
    pooled = x.mean((1, 2))
    return pooled @ weights["linear_weight"].T + weights["linear_bias"]


def synthetic_weights(rng, depth: int, n_classes: int = 10,
                      block_scale: float = 0.4) -> dict:
    """Reference-format weight dict (the ``load_reference_weights`` layout)
    drawn from a numpy generator, with BN statistics that keep activations
    inside the ReLU bound: the generator of the JAX package's encrypted CNN
    tests, draw for draw. Block convs are drawn at block_scale/sqrt(c_in);
    0.4 is the tests' value, and full-size nets (depth 20 at 32x32) need
    about 0.24 to keep every normalized pre-ReLU input below 1."""
    n = (depth - 2) // 6
    w = {"conv1": rng.standard_normal((16, 3, 3, 3)) * 0.25}

    def bn(p, c):
        w[f"{p}_weight"] = rng.uniform(0.7, 1.3, c)
        w[f"{p}_bias"] = rng.standard_normal(c) * 0.1
        w[f"{p}_running_mean"] = rng.standard_normal(c) * 0.1
        w[f"{p}_running_var"] = rng.uniform(0.5, 1.5, c)

    bn("bn1", 16)
    widths = [16, 32, 64]
    for s in range(1, 4):
        cw = widths[s - 1]
        cin = widths[max(0, s - 2)] if s > 1 else 16
        for b in range(n):
            p = f"layer{s}_{b}_"
            c1_in = cin if b == 0 else cw
            w[p + "conv1"] = rng.standard_normal((cw, c1_in, 3, 3)) * (
                block_scale / np.sqrt(c1_in))
            w[p + "conv2"] = rng.standard_normal((cw, cw, 3, 3)) * (
                block_scale / np.sqrt(cw))
            bn(p + "bn1", cw)
            bn(p + "bn2", cw)
    w["linear_weight"] = rng.standard_normal((n_classes, 64)) * 0.3
    w["linear_bias"] = rng.standard_normal(n_classes) * 0.1
    return w
