"""The output check's control, and the readings its limits come from.

    python -m fhe_bench.control --workload <name> --seeds 11,12,13 \\
        --seconds 5

For each seed this runs the cell's set-up and a short window in one
process for the program as configured and then for each control, and
prints one JSON line with the numbers the check compares for each. The
traffic
mix's ``controls`` name them: flags of the program's own lower-precision
paths, added to the configuration's, each the step a change would take in
a precision the cell exercises (ResNet blocks: the ReLU's sign at error
2^-9 for 2^-10, and the EvalMod cosine at degree 31 for 59; the
bootstrap stream: the EvalMod cosine; the LayerNorm: the chain's scale
2^50 for 2^54).

A coefficient set that the port's cache (``approx/_cache/``) lacks is
read from ``fhe_bench/control/``, and written there on a miss: the
program's cache is never written.

The limits in ``fhe_bench/traffic/*.json`` lie between the largest number
of sound runs and the smallest of the control (``PERF.md`` gives both).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from contextlib import contextmanager
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _overlay(path_fn):
    """path_fn, sending a file the port's cache lacks to
    ``fhe_bench/control/``."""
    def path(*args, **kw):
        p = path_fn(*args, **kw)
        return p if os.path.exists(p) else str(HERE / "control"
                                               / os.path.basename(p))
    return path


@contextmanager
def control_coefficients():
    """The sign and EvalMod coefficient files, read from the port's cache
    or else from (and on a miss written to) ``fhe_bench/control/``."""
    from fhe_gpt2_tpu_torch.approx import minimax
    from fhe_gpt2_tpu_torch.boot import bootstrap
    saved = minimax._cache_path, bootstrap.evalmod_cache_path
    minimax._cache_path = _overlay(saved[0])
    bootstrap.evalmod_cache_path = _overlay(saved[1])
    try:
        yield
    finally:
        minimax._cache_path, bootstrap.evalmod_cache_path = saved


def readings(workload: str, seed: int, seconds: float, device: str = "cuda",
             spec: dict | None = None) -> dict:
    """The checked numbers of the program and of each of its controls on
    one seed: {"program": {...}, "controls": [{"flags", "numbers"}]}."""
    from . import harness
    spec = spec or harness.load_spec()
    _, cfg, traffic = harness.cell(spec, workload)
    res = harness.measure(workload, seed, seconds, False, device=device,
                          spec=spec)[0]
    out = {"workload": workload, "seed": seed, "correct": res["correct"],
           "program": {k: v["value"] for k, v in res["checks"].items()},
           "controls": []}
    for ctl in traffic["controls"]:
        flags = list(ctl["flags"])
        with control_coefficients():
            res = harness.measure(workload, seed, seconds, False,
                                  device=device, spec=spec,
                                  flags=list(cfg["flags"]) + flags)[0]
        out["controls"].append({"flags": flags, "numbers": {
            k: v["value"] for k, v in res["checks"].items()}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    a = ap.parse_args(argv)
    for seed in (int(s) for s in a.seeds.split(",")):
        try:
            out = readings(a.workload, seed, a.seconds)
        except Exception as e:  # a control that crashes has failed
            out = {"workload": a.workload, "seed": seed,
                   "crashed": f"{type(e).__name__}: {e}"[:500]}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
