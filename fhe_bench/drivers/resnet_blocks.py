"""Residual blocks of a served ResNet, one block per request.

Parameters (the traffic file): ``blocks``, the 0-based residual blocks
served in turn (segment ``1 + b`` of ``cnn/resnet.forward_segments``);
``pool_images``, the seeded images whose activations feed them;
``check_share``, the share of requests whose answer is compared.

Set-up draws the weights and the pool's images from the seed; each pool
entry is the activation of an image at a served block's input in the
published network (float64, ReLU as max(x, 0)). It builds the plans of
the served blocks and the session of the configuration's flags
(``session.resnet_session``), and finds the level and scale at which the
served schedule hands a block its input: every block and the stem end
with a bootstrap and a ReLU, so one bootstrap and one ReLU of a dummy
ciphertext give them, without the earlier segments. The pool is packed
and encrypted there. One warm-up request per block encodes its masks and
captures the bootstrap's graphs.

The check runs the block on the same input in the plain reference, whose
ReLU is the configuration's composite sign worked out anew
(``reference/sign.py``).
"""

from __future__ import annotations

import time

import numpy as np

from .. import inputs
from ..reference import resnet as ref
from ..session import resnet_session
from . import sync

UNIT = "block"


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 flags: list):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.flags = device, flags
        self.blocks = list(traffic["blocks"])

    def setup(self) -> None:
        from fhe_gpt2_tpu_torch.cnn import resnet as R
        from fhe_gpt2_tpu_torch.nn import kernels as K

        cfg, seed = self.cfg, self.seed
        depth, bound = cfg["depth"], cfg["relu_bound"]
        shape = tuple(cfg["image"])
        self.depth, self.bound = depth, bound
        self.w = inputs.resnet_weights(inputs.rng(seed, 1), depth,
                                       cfg["classes"], cfg["block_scale"])

        # The pool: each image's activation at each served block's input.
        t0 = time.perf_counter()
        imgs = inputs.images(inputs.rng(seed, 3), self.traffic["pool_images"],
                             shape)
        self.acts = {}
        for k, img in enumerate(imgs):
            x = ref.stem(img, self.w, bound, None)
            for b in range(max(self.blocks) + 1):
                if b in self.blocks:
                    self.acts[(k, b)] = x
                x = ref.block(x, self.w, depth, b, bound, None)
        pool_s = time.perf_counter() - t0

        rp, s = resnet_session(self.flags, self.device, self.w, depth,
                               self.blocks, imgs[0], bound)
        self.rp, self.ses = rp, s
        s.info["pool_s"] = pool_s
        B = s.B
        self.segs = R.forward_segments(B, rp)

        # The served block input: a bootstrap and a ReLU.
        dummy = inputs.rng(seed, 5).uniform(-0.5, 0.5, rp.slots)
        y = B.bootstrap(B.from_slots(dummy))
        z = K.relu(B, y, rp.sign, bound=1.0)
        self.level, self.scale = z.level, z.scale
        s.info["block_input_level"] = z.level
        self.pool = {key: self.encrypt(key) for key in self.acts}
        for b in self.blocks:
            self.run(0, b)
        sync(self.device)

    def packed(self, k: int, b: int) -> list:
        return [ref.planar_pack(self.acts[(k, b)], self.rp.slots)]

    def encrypt(self, key):
        B = self.ses.B
        [v] = self.packed(*key)
        return B.enc.encrypt(B.ev.make_plain(v, self.scale, self.level))

    def run(self, k: int, b: int):
        return self.segs[1 + b]([self.pool[(k, b)]])

    def request(self, i: int):
        b = self.blocks[i % len(self.blocks)]
        k = (i // len(self.blocks)) % self.traffic["pool_images"]
        out = self.run(k, b)
        sync(self.device)
        return (k, b), out

    def answers(self, kept: list) -> list:
        """The kept answers decrypted: [(key, slot vector)]."""
        return [(key, self.ses.B.to_slots(out[0])) for key, out in kept]

    def compare(self, answers: list) -> dict:
        """Over the answers' output tensors: the largest |answer −
        reference|, and the largest |mean(answer − reference)| over the
        outputs whose last ReLU's input lies in [eps, 2·eps] of the sign's
        domain, where a ReLU one precision step coarser departs from this
        one most and the bootstraps' noise averages out."""
        spec = self.cfg["sign"]
        stages = ref.sign_stages(spec)
        eps = 2.0 ** spec["eps_log2"]
        gap = band = 0.0
        for (k, b), v in answers:
            pre = ref.block_pre(self.acts[(k, b)], self.w, self.depth, b,
                                self.bound, stages)
            want = ref.relu(pre, stages)
            d = ref.planar_unpack(v, want.shape) - want
            gap = max(gap, float(np.abs(d).max()))
            edge = (pre >= eps) & (pre <= 2 * eps)
            if edge.any():
                band = max(band, abs(float(d[edge].mean())))
        return {"block_gap": gap, "relu_band_gap": band}
