"""The bootstrap stream of a served ResNet: one ``CkksBackend.bootstrap``
per request.

Parameters (the traffic file): ``pool``, the seeded ciphertexts served in
turn, each a slot vector uniform in ±``amplitude`` (inside the EvalMod
window, as every normalized value of the served model is);
``min_pairs_out``, the level pairs above the chain's base that a
bootstrap must leave (the served schedule's ReLU and the convolution
after it); ``check_share``, the share of requests whose answer is
compared.

The served schedule bootstraps right after a convolution whose input came
out of a ReLU that followed a bootstrap. Set-up finds that level as a
block does (one bootstrap and one ReLU of a dummy ciphertext), one
rescale unit below it, at the context scale the convolution leaves, and
encrypts the pool there. The session is ``session.resnet_session``'s,
with the plans of no block.
"""

from __future__ import annotations

import numpy as np

from .. import inputs
from ..reference import bootstrap as ref
from ..session import resnet_session
from . import sync

UNIT = "boot"


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 flags: list):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.flags = device, flags

    def setup(self) -> None:
        from fhe_gpt2_tpu_torch.nn import kernels as K

        seed, t, cfg = self.seed, self.traffic, self.cfg
        w = inputs.resnet_weights(inputs.rng(seed, 1), cfg["depth"],
                                  cfg["classes"], cfg["block_scale"])
        img = inputs.images(inputs.rng(seed, 3), 1, cfg["image"])[0]
        rp, s = resnet_session(self.flags, self.device, w, cfg["depth"], [],
                               img, cfg["relu_bound"])
        self.ses = s
        B, ctx, sign = s.B, s.ctx, rp.sign
        slots = ctx.params.slots
        g = inputs.rng(seed, 6)
        y = B.bootstrap(B.from_slots(g.uniform(-0.5, 0.5, slots)))
        z = K.relu(B, y, sign, bound=1.0)
        self.level = z.level - ctx.rescale_limbs
        s.info["bootstrap_level"] = self.level
        amp = t["amplitude"]
        self.values = [g.uniform(-amp, amp, slots) for _ in range(t["pool"])]
        self.pool = [B.from_slots(v, level=self.level) for v in self.values]
        self.request(0)

    def request(self, i: int):
        k = i % len(self.pool)
        out = self.ses.B.bootstrap(self.pool[k])
        sync(self.device)
        return k, out

    def answers(self, kept: list) -> list:
        """(key, (slot vector, level of the answer))."""
        return [(k, (self.ses.B.to_slots(out), out.level))
                for k, out in kept]

    def compare(self, answers: list) -> dict:
        """Mean and largest |answer − input| over every slot, and by how
        many level pairs the answers fall short of ``min_pairs_out`` above
        the composite chain's base pair."""
        need = self.traffic["min_pairs_out"]
        mean, worst, short = [], 0.0, 0
        for k, (v, level) in answers:
            err = np.abs(np.real(v) - ref.bootstrap(self.values[k]))
            mean.append(float(err.mean()))
            worst = max(worst, float(err.max()))
            short = max(short, need - (level // 2 - 1))
        return {"boot_mean_err": float(np.mean(mean)), "boot_max_err": worst,
                "boot_pairs_short": float(short)}
