"""Encrypted Granite 4.0-H inference driver on the port.

Builds the plans of a Granite 4.0-H model (HF ``granitemoehybrid``, dense:
Mamba-2 and grouped-query attention layers in the published
``layer_types`` order, SwiGLU MLPs) from synthetic HF-format weights
(``nn/granite.synthetic_weights``, numpy seed 0), embeds token ids from
seed 0 on the host (× embedding_multiplier), runs the layers and the
final RMSNorm encrypted (or on the plain simulator under --plain), and
prints the hidden state's largest gap to the float64 reference
(``reference/granite.py``) and the top-1 agreement of the tied logits
(÷ logits_scaling, on the host) as one JSON line.

    python -m fhe_gpt2_tpu_torch.run_granite --layers 6 --plain --cpu
    python -m fhe_gpt2_tpu_torch.run_granite --layers 1 --cpu --composite \\
        --logn 10 --levels 39

The chain flags are ``run_gpt2``'s, and the session is
``run_gpt2.build_session``'s (keys, the decrypt/re-encrypt refresh to the
chain top). --hidden sets the width (``nn/granite.small_config``; 2048 is
the published configuration, ``nn/granite.PUBLISHED``); --layers takes the
first layers of the published order (the 10-layer period is M×5, A, M×4).
--silu-degree and --softplus-degree set the activations' polynomials.
The synthetic embedding holds VOCAB rows, and token ids come from them.
--trace PATH is ``run_gpt2``'s. The published width of one Mamba-2 layer
on the 80-limb chain is

    python -m fhe_gpt2_tpu_torch.run_granite --layers 1 --hidden 2048 \\
        --composite --logn 15 --levels 39 --log-scale 54 --nsp 16 \\
        --digit-keys

(on an H100 790 s and a peak of 57 GB: ``tools/granite_layers.py`` runs
it through these functions and writes its numbers).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

# Rows of the synthetic embedding: the published 100352 at width 2048 would
# take 1.6 GB, and a run reads only its tokens' rows and their logits.
VOCAB = 997


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=64,
                    help="model width; 2048 is the published one")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--logn", type=int, default=12)
    ap.add_argument("--slots", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=39)
    ap.add_argument("--nsp", type=int, default=1,
                    help="special primes (hybrid key-switch digit size)")
    ap.add_argument("--composite", action="store_true",
                    help="run_gpt2's composite uint32 chain; without it "
                         "the u64 chain")
    ap.add_argument("--log-scale", type=int, default=54,
                    help="composite chain: Δ ≈ 2^log_scale")
    ap.add_argument("--digit-keys", action="store_true",
                    help="base-16 digit rotation key set instead of the "
                         "recorded steps")
    ap.add_argument("--silu-degree", type=int, default=56)
    ap.add_argument("--softplus-degree", type=int, default=48)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU; without it the driver needs a "
                         "CUDA card")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the port's spans and counters and a "
                         "torch.profiler device trace to PATH")
    # run_gpt2.build_session reads these; Granite runs neither.
    ap.set_defaults(real_boot=False, decode=0)
    return ap.parse_args(argv)


def allocator_setting() -> None:
    """The CUDA allocator's segments grow in place: the mixer core's
    batched values are GiB each, and between them a projection block's
    masks come and go (``granite.BlockMatmul``), which fragments fixed
    segments past the card's 80 GB at published widths. Call it before
    the first allocation on the card."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")


def model_config(a) -> dict:
    from .nn import granite as G
    if a.hidden == G.PUBLISHED["hidden_size"]:
        cfg = dict(G.PUBLISHED)
        cfg.update(num_hidden_layers=a.layers,
                   layer_types=G.PUBLISHED["layer_types"][:a.layers],
                   vocab_size=VOCAB)
        return cfg
    return G.small_config(a.hidden, a.layers, VOCAB)


def load_model(a):
    """Weights from numpy seed 0, token ids from seed 0, their embedding,
    the calibrated plans and the reference's last hidden state, as a
    ``run_gpt2.Model``."""
    import torch

    from .nn import granite as G
    from .reference import granite as R
    from .run_gpt2 import Model

    cfg = model_config(a)
    rng = np.random.default_rng(0)
    w = G.synthetic_weights(rng, cfg)
    ids = np.random.default_rng(0).integers(0, VOCAB, a.seq)
    slots = a.slots if a.plain else 1 << (a.logn - 1)
    t0 = time.time()
    emb = G.get(w, "embed_tokens.weight")[ids] * cfg["embedding_multiplier"]
    cal = G.calibrate(w, cfg, emb)
    gp = G.build_granite_plans(cfg, w, slots, a.seq, cal,
                               silu_degree=a.silu_degree,
                               softplus_degree=a.softplus_degree)
    plans_s = time.time() - t0
    want = R.forward(w, torch.as_tensor(emb), cfg).numpy()
    return Model(sh=gp.sh, weights=w, ids=ids, emb=emb, plans=gp,
                 knobs=None, want=want, plans_s=plans_s)


def build_session(a, m):
    """``run_gpt2.build_session`` with Granite's forward to record
    rotations from."""
    from .nn import granite as G
    from .run_gpt2 import build_session as session
    return session(a, m, forward=G.forward)


def encrypted_forward(ses, m) -> np.ndarray:
    """Encrypt the embedded activations, run every layer and the final
    RMSNorm on the session's backend, decrypt: [seq, hidden]."""
    from .nn import granite as G

    B, sh = ses.B, m.sh
    xs = [B.from_slots(v) for v in sh.act.pack(m.emb)]
    out = G.forward(B, xs, m.plans)
    return sh.act.unpack(np.stack([B.to_slots(o) for o in out]))


def main(argv=None):
    from .run_gpt2 import device_of

    allocator_setting()
    a = parse_args(argv)
    device_of(a)
    if not a.trace:
        return _main(a)
    from .utils import telemetry
    with telemetry.trace(a.trace) as summary:
        _main(a)
    print(json.dumps({"trace": a.trace,
                      "idle_by_span": summary["idle_by_span"][:10]}))


def _main(a):
    from .nn import granite as G
    from .nn.backend import PlainBackend
    from .reference import granite as R

    m = load_model(a)
    t0 = time.time()
    if a.plain:
        out = G.forward(PlainBackend(m.sh.slots), list(m.sh.act.pack(m.emb)),
                        m.plans)
        got = m.sh.act.unpack(np.stack(out))
    else:
        got = encrypted_forward(build_session(a, m), m)
    dt = time.time() - t0
    cfg = m.plans.cfg
    agree = float((R.logits(m.weights, got, cfg).argmax(-1)
                   == R.logits(m.weights, m.want, cfg).argmax(-1))
                  .double().mean())
    print(json.dumps({"layers": a.layers,
                      "layer_types": cfg["layer_types"],
                      "mode": "plain" if a.plain else "enc",
                      "seconds": round(dt, 2),
                      "max_err_vs_reference": float(np.abs(got - m.want)
                                                    .max()),
                      "top1_agreement": agree}))


if __name__ == "__main__":
    main()
