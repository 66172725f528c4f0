"""Run one cell of the port's benchmark once and print its result.

    python3 fhe_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>
    python -m fhe_bench.run ...            (the same)

The cells, their configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the root of the checkout. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` (and with ``--trace 1`` a ``breakdown``),
and last ``checks``: each number the output check compared, with its
limit. The same numbers are the last lines of standard error. Without a
CUDA card, or with fewer cards than the cell asks for, or with JAX or the
JAX package loaded, the run exits with a non-zero code and prints no
result. Every build and kernel cache stays inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
REPO = Path(__file__).resolve().parent.parent
# Run as a script, this file's folder heads sys.path, where its modules
# would shadow the standard library's (``inputs``, ``work``): the
# checkout's root takes its place.
if sys.path and Path(sys.path[0]).resolve() == REPO / "fhe_bench":
    sys.path[0] = str(REPO)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    # Fixed cache directories inside the checkout; a library that would
    # load JAX on its own is told not to.
    os.environ["TORCH_EXTENSIONS_DIR"] = (
        str(REPO / "build" / "torch_extensions"))
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    import torch

    import fhe_gpt2_tpu_torch  # noqa: F401  (the system under test)
    from fhe_bench import harness

    spec = harness.load_spec()
    w, _, _ = harness.cell(spec, a.workload)
    if not torch.cuda.is_available():
        print("fhe_bench: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < w["chips"]:
        print(f"fhe_bench: {a.workload} needs {w['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, checks, run, _ = harness.measure(
        a.workload, a.seed, a.seconds, bool(a.trace), spec=spec,
        t_start=T_START)
    bad = harness.forbidden_loaded()
    if bad:
        print("fhe_bench: JAX or the JAX package was loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    print("info " + json.dumps(run.info), file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
