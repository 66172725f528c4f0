#!/usr/bin/env python3
"""Time the two host routes of the port's mask encoder on this host.

    python3 tools/encode_routes.py [--logn 15] [--reps 20] [--masks 48346]

``core/embedding.encode_to_coeffs`` (the host half of every plaintext
encoding; ``Evaluator._encode`` reduces its coefficients on the device)
runs its transform in the native runtime when it is available and in numpy
otherwise. This tool times both routes, in turns, on the same slot vectors
(uniform and 0/1, Δ = 2^54 on a composite chain), checks that they give the
same coefficients, and scales the per-encoding difference to ``--masks``
encodings (the masks of one encrypted ResNet-20 image at full width). It
needs no card: the encoder runs on the host. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--logn", type=int, default=15)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--masks", type=int, default=48346)
    a = ap.parse_args()

    from fhe_gpt2_tpu_torch.core import embedding
    from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
    from fhe_gpt2_tpu_torch.runtime import native

    if not native.available():
        raise SystemExit("encode_routes: the native runtime does not build "
                         "or load here")
    ctx = CkksContext(CkksParams.create_composite(
        logn=a.logn, num_levels=2, log_scale=54, log_q0=59, num_special=2,
        hamming_weight=16), device="cpu")
    rng = np.random.default_rng(0)
    vectors = {"uniform": rng.uniform(-1, 1, ctx.params.slots),
               "zero_one": rng.integers(0, 2, ctx.params.slots) * 1.0}
    available = native.available

    def route(name):
        native.available = available if name == "native" else (lambda: False)

    out = {"logn": a.logn, "reps": a.reps, "host": platform.processor()
           or platform.machine(), "cpus": os.cpu_count(),
           "numpy": np.__version__, "library": str(native.library_path())}
    try:
        for kind, z in vectors.items():
            times = {"native": [], "numpy": []}
            coeffs = {}
            # In turns: numpy, native, native, numpy, ...
            for i in range(a.reps):
                order = ("numpy", "native") if i % 2 == 0 else \
                    ("native", "numpy")
                for name in order:
                    route(name)
                    t0 = time.perf_counter()
                    coeffs[name] = embedding.encode_to_coeffs(
                        z, ctx.params.scale, ctx)
                    times[name].append(time.perf_counter() - t0)
            same = bool(np.array_equal(coeffs["native"], coeffs["numpy"]))
            med = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
            out[kind] = {"native_ms": med["native"], "numpy_ms": med["numpy"],
                         "equal": same,
                         "saved_s_per_image": (med["numpy"] - med["native"])
                         * a.masks / 1e3}
    finally:
        native.available = available
    print(json.dumps(out))
    return 0 if all(out[k]["equal"] for k in vectors) else 1


if __name__ == "__main__":
    sys.exit(main())
