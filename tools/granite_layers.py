#!/usr/bin/env python3
"""Granite 4.0-H Micro's two layer kinds once each at published widths,
encrypted, against the float64 reference over the same 16 tokens, through
``run_granite``'s own functions.

    python3 tools/granite_layers.py [--which mamba,attention] \\
        [--out build/granite_layers.json] [--cpu --hidden 64 \\
        --logn 10 --levels 12 --nsp 4]

1. ``mamba``: the entry point's run of one layer (``run_granite --layers
   1``: ``load_model``, ``build_session``, ``encrypted_forward``): layer
   0, a Mamba-2 layer (RMSNorm, in_proj, the mixer core, out_proj, the
   residual, RMSNorm, the SwiGLU MLP, the residual), then the final
   RMSNorm.
2. ``attention``: layer 5's attention half-layer (RMSNorm, grouped-query
   attention with 32 query heads over 8 K/V heads and scale 1/64, the
   residual), from layer 5's plans alone
   (``granite.build_granite_plans(layers=[5])``) on the same session.

Both take the embedded tokens (× 12) of ``run_granite`` (weights and ids
from seed 0) as their input, on the session of ``run_granite``'s
published flags (logN = 15, 39 composite pairs at 2^54, 16 special
primes, digit keys, the decrypt/re-encrypt refresh). Writes, after each
phase, one JSON object to --out: the card's name and power limit, and
per phase the seconds, the peak device memory, the largest |answer −
reference| and the reference's largest value, and the refreshes it ran
with their levels (the recorder's ``refresh`` spans). Without --cpu it
needs the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

PUBLISHED_FLAGS = ["--seq", "16", "--hidden", "2048", "--composite",
                   "--logn", "15", "--levels", "39", "--log-scale", "54",
                   "--nsp", "16", "--digit-keys"]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--which", default="mamba,attention")
    ap.add_argument("--out", default=str(REPO / "build"
                                         / "granite_layers.json"))
    a, rest = ap.parse_known_args(argv)
    from fhe_gpt2_tpu_torch import run_granite
    run_granite.allocator_setting()
    import torch

    from fhe_gpt2_tpu_torch.nn import granite as G
    from fhe_gpt2_tpu_torch.reference import granite as R
    from fhe_gpt2_tpu_torch.utils import telemetry

    ga = run_granite.parse_args(PUBLISHED_FLAGS + rest + ["--layers", "1"])
    cuda = not ga.cpu
    out = {"card": card(), "flags": PUBLISHED_FLAGS + rest, "layers": {}}

    def save():
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out, indent=1) + "\n")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    m = run_granite.load_model(ga)
    out["plans_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ses = run_granite.build_session(ga, m)
    out["session_s"] = time.perf_counter() - t0
    B, sh = ses.B, m.sh
    save()

    def attention():
        ga6 = run_granite.parse_args(PUBLISHED_FLAGS + rest
                                     + ["--layers", "6"])
        cfg = run_granite.model_config(ga6)
        w = G.synthetic_weights(np.random.default_rng(0), cfg, layers=[5])
        gp = G.build_granite_plans(cfg, w, sh.slots, ga.seq, G.calibrate(
            w, cfg, m.emb, layers=[5]), layers=[5])
        xs = [B.from_slots(v) for v in sh.act.pack(m.emb)]
        sync()
        t = time.perf_counter()
        got = G.mixer_sublayer(B, xs, gp, gp.layers[0])
        sync()
        seconds = time.perf_counter() - t
        got = sh.act.unpack(np.stack([B.to_slots(o) for o in got]))
        return seconds, got, R.mixer_sublayer(torch.as_tensor(m.emb), w, 5,
                                              cfg).numpy()

    def mamba():
        sync()
        t = time.perf_counter()
        got = run_granite.encrypted_forward(ses, m)
        return time.perf_counter() - t, got, m.want

    runs = {"mamba": mamba, "attention": attention}
    for name in a.which.split(","):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        mark = telemetry.mark()
        with telemetry.enable(only=("refresh",)):
            seconds, got, want = runs[name]()
        levels = [s.level for s in telemetry.spans_since(mark)
                  if s.name == "refresh"]
        out["layers"][name] = {
            "seconds": seconds,
            "peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda
            else 0,
            "max_gap": float(np.abs(got - want).max()),
            "reference_max": float(np.abs(want).max()),
            "refreshes": len(levels), "refresh_levels": levels[:64]}
        print(json.dumps({name: out["layers"][name]}), flush=True)
        save()
        B.release_caches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
