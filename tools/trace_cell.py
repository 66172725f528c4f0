#!/usr/bin/env python3
"""Trace one benchmark cell with the port's own recorder, and time what the
recorder costs there.

    python3 tools/trace_cell.py --workload <cell> --seed <n> \\
        [--seconds 30] [--turns 4] [--trace-seconds 5] \\
        [--out build/traces/<cell>.json]

Builds the cell as ``fhe_bench`` does (its configuration, traffic mix,
driver and set-up), then runs closed-loop windows of ``--seconds`` on the
same requests:

1. ``--turns`` windows in turns with the recorder off and on
   (``utils/telemetry.enable()``, no profiler): off, on, on, off, ... Each
   gives seconds per request; the recorder's cost is the median on-window
   over the median off-window. The first (off) window also counts what the
   recorder holds after it, the ``torch.cuda.synchronize`` calls beyond
   the loop's own (one per request and one at the start) and the bytes
   printed: all must be 0.
2. one window of ``--trace-seconds`` under ``telemetry.trace(--out)``: the
   recorder and ``torch.profiler``'s CUDA activity, exported as one
   Chrome-trace JSON with the device's idle seconds summed by the innermost
   port span that holds each gap (``idle_by_span``), and the recorder's
   counters and span totals per request.

Needs the card (the harness's cells run on it); prints one JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def window(drv, seconds: float, first: int):
    """Closed-loop requests until `seconds` have passed: (requests,
    seconds per request, next request index)."""
    import torch
    torch.cuda.synchronize()
    i, t0 = first, time.perf_counter()
    while True:
        drv.request(i)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    dt = time.perf_counter() - t0
    return i - first, dt / (i - first), i


def quiet_window(drv, seconds: float, first: int):
    """``window`` with the recorder off, counting what it leaves: spans and
    counters recorded, synchronizes beyond the loop's own, bytes printed."""
    import torch

    from fhe_gpt2_tpu_torch.utils import telemetry
    assert not telemetry.recording()
    telemetry.reset()
    real, calls = torch.cuda.synchronize, [0]

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    printed = io.StringIO()
    torch.cuda.synchronize = counted
    try:
        with contextlib.redirect_stdout(printed):
            n, per, i = window(drv, seconds, first)
    finally:
        torch.cuda.synchronize = real
    snap = telemetry.snapshot()
    return n, per, i, {"spans": len(snap.spans),
                       "counters": len(snap.counters),
                       "extra_synchronizes": calls[0] - n - 1,
                       "printed_bytes": len(printed.getvalue())}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--trace-seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" /
                                             "torch_extensions")
    import torch

    from fhe_bench import drivers, harness
    from fhe_gpt2_tpu_torch.utils import telemetry

    if not torch.cuda.is_available():
        print("trace_cell: no CUDA device", file=sys.stderr)
        return 2
    out = Path(a.out or REPO / "build" / "traces" / f"{a.workload}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    spec = harness.load_spec()
    _, cfg, traffic = harness.cell(spec, a.workload)
    t0 = time.perf_counter()
    drv = drivers.load(traffic["driver"]).Driver(
        cfg, traffic, a.seed, "cuda", list(cfg["flags"]))
    drv.setup()
    res = {"workload": a.workload, "seed": a.seed, "card": card(),
           "setup_s": time.perf_counter() - t0, "turns": []}
    i = 0
    for k in range(a.turns):
        on = k % 4 in (1, 2)
        if on:
            telemetry.enable()
        if k == 0:
            n, per, i, res["off_window"] = quiet_window(drv, a.seconds, i)
        else:
            n, per, i = window(drv, a.seconds, i)
        if on:
            telemetry.disable()
        res["turns"].append({"recorder": on, "requests": n, "s": per})
    telemetry.reset()
    off = [t["s"] for t in res["turns"] if not t["recorder"]]
    on = [t["s"] for t in res["turns"] if t["recorder"]]
    if off and on:
        res["on_over_off"] = statistics.median(on) / statistics.median(off)
    with telemetry.trace(out) as summary:
        n, per, i = window(drv, a.trace_seconds, i)
    snap = telemetry.snapshot()
    host, device = {}, {}
    for s in snap.spans:
        host[s.name] = host.get(s.name, 0.0) + s.ms / n
        if s.device_ms is not None:
            device[s.name] = device.get(s.name, 0.0) + s.device_ms / n
    res["traced"] = {
        "requests": n, "s": per, "aligned": summary["aligned"],
        "idle_by_span": summary["idle_by_span"][:12],
        "counters_per_request": {k: v / n for k, v in sorted(
            snap.counters.items()) if not k.startswith("op.")},
        "ops_per_request": sum(v for k, v in snap.counters.items()
                               if k.startswith("op.")) / n,
        "host_ms_per_request": dict(sorted(host.items())),
        "device_ms_per_request": dict(sorted(device.items())),
        "spans": len(snap.spans), "dropped": snap.dropped}
    res["trace_file"] = str(out.relative_to(REPO)) if out.is_relative_to(
        REPO) else str(out)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
