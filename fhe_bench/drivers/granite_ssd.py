"""Granite 4.0-H's Mamba-2 mixer core (layer 0), one sequence per request.

Parameters (the traffic file): ``seq``, the tokens per request; ``pool``,
the seeded sequences served in turn; ``check_share``, the share of
requests whose answer is compared.

A request runs ``nn/mamba.mixer_core`` from in_proj's encrypted outputs
(z, xBC, dt_raw) through the causal conv and SiLU, softplus, the decay
products, the SSD sum with its D skip, the gate and the gated RMSNorm to
out_proj's input, 16 × 4096 values. Set-up draws layer 0's mixer weights
and each sequence's embedding rows from the seed (the configuration's
``assumed`` recipe), computes in_proj's outputs in float64 from
RMSNorm(12·embedding) with the reference, builds the core's plans (the
gated norm's Newton seed calibrated on the pool, ``nn/granite``'s rule),
the session of the configuration's flags (``run_gpt2.build_session``:
the base-16 digit keys, the decrypt/re-encrypt refresh), and encrypts each
sequence's inputs at the level the mixer's refresh and in_proj leave
(``granite.core_input_level``: neither is run). Each sequence's SiLU and
softplus inputs are held to the fits' range (``granite.check_act_domain``)
first. One warm-up request runs the core with its refreshes.

The check: ``ssd_gap``, the largest |answer − reference| over the
answer's seq × inner values, against ``reference/granite.mixer_core``.
"""

from __future__ import annotations

import numpy as np

from .. import inputs
from ..reference import granite as ref
from ..session import Session
from . import sync

UNIT = "sublayer"
# The configuration's keys the model reads.
KEYS = ("hidden_size", "mamba_n_heads", "mamba_d_head", "mamba_d_state",
        "mamba_n_groups", "mamba_d_conv", "mamba_expand", "rms_norm_eps",
        "vocab_size", "embedding_multiplier")
MIXER = ("conv1d.weight", "conv1d.bias", "dt_bias", "A_log", "D",
         "norm.weight")


def layer0_weights(seed: int, cfg: dict) -> dict:
    """Layer 0's input RMSNorm and mixer weights, HF names, from the seed:
    in_proj N(0, 0.02), conv weights and biases U(±0.5), A_log =
    log(1..heads), D = 1, dt_bias = 1, norm weights U(0.8, 1.2)."""
    g = inputs.rng(seed, 16, 0)
    d, H, P = cfg["hidden_size"], cfg["mamba_n_heads"], cfg["mamba_d_head"]
    N = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    inner, kc = H * P, cfg["mamba_d_conv"]
    m = "layers.0.mamba."
    return {
        "layers.0.input_layernorm.weight": g.uniform(0.8, 1.2, d),
        m + "in_proj.weight": g.normal(0.0, 0.02, (2 * inner + 2 * N + H, d)),
        m + "conv1d.weight": g.uniform(-0.5, 0.5, (inner + 2 * N, 1, kc)),
        m + "conv1d.bias": g.uniform(-0.5, 0.5, inner + 2 * N),
        m + "dt_bias": np.ones(H),
        m + "A_log": np.log(np.arange(1, H + 1, dtype=float)),
        m + "D": np.ones(H),
        m + "norm.weight": g.uniform(0.8, 1.2, inner),
    }


def embedded(seed: int, ids, d: int, mult: float) -> np.ndarray:
    """Embedding rows N(0, 0.02), drawn from (seed, token), × mult."""
    return mult * np.stack([inputs.rng(seed, 16, 1, int(t)).normal(
        0.0, 0.02, d) for t in ids])


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 flags: list):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.flags = device, flags

    def core_inputs(self, emb: np.ndarray) -> tuple:
        """(z, xBC, dt_raw) of in_proj over RMSNorm(emb), float64."""
        import torch
        m = self.mcfg
        u = ref.rms_norm(torch.as_tensor(emb), ref.weight(
            self.w, "layers.0.input_layernorm.weight"), m["rms_norm_eps"])
        proj = u @ ref.weight(self.w, "layers.0.mamba.in_proj.weight").T
        return tuple(t.numpy() for t in ref.split_in_proj(proj, m))

    def setup(self) -> None:
        from fhe_gpt2_tpu_torch import run_granite
        from fhe_gpt2_tpu_torch.nn import granite as G
        from fhe_gpt2_tpu_torch.nn import mamba as Mb
        from fhe_gpt2_tpu_torch.reference import granite as port_ref
        from fhe_gpt2_tpu_torch.run_gpt2 import Model, build_session

        cfg, seed, t = self.cfg, self.seed, self.traffic
        a = run_granite.parse_args(list(self.flags) + (
            ["--cpu"] if self.device == "cpu" else []))
        if (not a.composite or not a.digit_keys
                or a.hidden != cfg["hidden_size"]):
            raise ValueError("the Granite cell runs the composite chain with "
                             "digit keys at the configuration's hidden_size")
        self.mcfg = m = {k: cfg[k] for k in KEYS}
        seq, pool = t["seq"], t["pool"]
        self.w = layer0_weights(seed, m)
        self.p = {k: self.w["layers.0.mamba." + k] for k in MIXER}
        g = inputs.rng(seed, 16, 2)
        ids = [g.integers(0, m["vocab_size"], seq) for _ in range(pool)]
        self.ins = [self.core_inputs(embedded(
            seed, i, m["hidden_size"], m["embedding_multiplier"]))
            for i in ids]
        for k, x in enumerate(self.ins):
            G.check_act_domain(f"sequence {k}", *G.core_act_inputs(*x, self.p))
        # The program's calibration: its gated norm's rows over the pool.
        gate = np.concatenate([
            (port_ref.gated_norm_input(*x, self.p, m) ** 2).sum(-1).numpy()
            for x in self.ins])
        self.sh = sh = G.mamba_shapes(m, 1 << (a.logn - 1), seq)
        self.plans = G.build_core_plans(
            sh, self.w, 0, m, gate, a.silu_degree, a.softplus_degree)
        self.core = Mb.mixer_core
        # Under the digit keys the session reads only the shapes.
        s = build_session(a, Model(sh=sh, weights=None, ids=None, emb=None,
                                   plans=None, knobs=None, want=None,
                                   plans_s=0.0))
        self.ses = Session(a=a, ctx=s.ctx, B=s.B, keygen_s=s.keygen_s,
                           galois_keys=s.galois_keys)
        B = s.B
        level = G.core_input_level(B)
        self.pool = [tuple(Mb.encrypt_groups(B, v, level)
                           for v in Mb.pack_core_inputs(sh, *x))
                     for x in self.ins]
        self.ses.info.update(core_input_level=level,
                             exp_squarings=self.plans.exp_r)
        self.request(0)

    def request(self, i: int):
        k = i % len(self.pool)
        out = self.core(self.ses.B, *self.pool[k], self.sh, self.plans)
        sync(self.device)
        return k, out

    def answers(self, kept: list) -> list:
        from fhe_gpt2_tpu_torch.nn import mamba as Mb
        B, sh = self.ses.B, self.sh
        out = []
        for k, v in kept:
            slots = np.stack([np.stack([
                B.to_slots(B.take_batch(v, (g, i))) for i in range(sh.n)])
                for g in range(2)])
            out.append((k, Mb.unpack_groups(sh, slots, sh.z_groups)))
        return out

    def compare(self, answers: list) -> dict:
        """Largest |answer − reference| over the seq × inner outputs."""
        gap = 0.0
        for k, got in answers:
            want = ref.mixer_core(*self.ins[k], self.p, self.mcfg).numpy()
            gap = max(gap, float(np.abs(got - want).max()))
        return {"ssd_gap": gap}
