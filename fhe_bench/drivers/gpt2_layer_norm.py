"""GPT-2's first LayerNorm, one LayerNorm over a sequence per request.

Parameters (the traffic file): ``seq``, the tokens per request;
``pool``, the seeded token sequences served in turn; ``check_share``, the
share of requests whose answer is compared.

Set-up builds only the LayerNorm's plans (``nn/layers.build_ln_plans``;
its Newton calibration point is 1.25 times the largest row's Σz² over the
pool, the rule of ``nn/model.rowmax_newton_inits``), the session of the
configuration's flags (``session.gpt2_session``: ``run_gpt2``'s, with its
whole digit key set), and the pool's embeddings encrypted at the chain
top, where a GPT-2 block's input arrives. One warm-up request runs the
LayerNorm and its refreshes.
"""

from __future__ import annotations

import numpy as np

from .. import inputs
from ..reference import gpt2_ln as ref
from ..session import gpt2_args, gpt2_session
from . import sync

UNIT = "sublayer"


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 flags: list):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.flags = device, flags

    def setup(self) -> None:
        from fhe_gpt2_tpu_torch.nn import layers as L

        cfg, seed, t = self.cfg, self.seed, self.traffic
        d, seq, pool = cfg["n_embd"], t["seq"], t["pool"]
        a = gpt2_args(self.flags, self.device)
        g = inputs.rng(seed, 4)
        self.ids = [g.integers(0, cfg["vocab_size"], seq) for _ in range(pool)]
        self.emb = [inputs.embedding_rows(seed, ids, d, cfg["embed_std"])
                    for ids in self.ids]
        self.gamma, self.beta = inputs.gpt2_ln(seed, d)
        self.init = ref.newton_init(np.concatenate(self.emb))
        self.iters = a.ln_iters
        self.sh = L.GPT2Shapes(slots=1 << (a.logn - 1), seq=seq, hidden=d,
                               heads=cfg["n_head"])
        self.ln = L.build_ln_plans(self.sh, self.gamma, self.beta,
                                   newton_init=self.init, iters=self.iters)
        self.layer_norm = L.layer_norm
        s = self.ses = gpt2_session(a, self.sh, self.ln, self.emb[0])
        B = s.B
        self.pool = [[B.from_slots(v) for v in self.sh.act.pack(e)]
                     for e in self.emb]
        self.request(0)

    def request(self, i: int):
        k = i % len(self.pool)
        out = self.layer_norm(self.ses.B, self.pool[k], self.sh, self.ln)
        sync(self.device)
        return k, out

    def answers(self, kept: list) -> list:
        return [(k, np.stack([self.ses.B.to_slots(o) for o in out]))
                for k, out in kept]

    def compare(self, answers: list) -> dict:
        """Largest |answer − reference| over the rows' data slots."""
        d = self.cfg["n_embd"]
        stride = 2 * (1 << (d - 1).bit_length())
        gap = 0.0
        for k, v in answers:
            want = ref.layer_norm(self.emb[k], self.gamma, self.beta,
                                  self.init, self.iters)
            got = ref.strided_unpack(v, len(self.emb[k]), d, stride)
            gap = max(gap, float(np.abs(got - want).max()))
        return {"ln_gap": gap}
