#!/usr/bin/env python3
"""Split one benchmark cell's device time by evaluator op and by kernel kind.

    python3 tools/glue_by_op.py --workload <cell> --seed <n> \\
        [--requests 2] [--eager-boot] [--out build/traces/<cell>.glue.json]

Builds the cell as ``fhe_bench`` does (its configuration, traffic mix,
driver and set-up), runs one request to warm up, then ``--requests``
requests under ``torch.profiler`` (CPU and CUDA activity) with each
outermost evaluator op (the recorder's ``op.<name>`` spans) also a
``record_function`` range of that name. Every device kernel is charged to
the op whose host range holds the CUDA runtime call that launched it (its
correlation id), or to ``(outside ops)``; device ms per request are summed
by op and by kind: ``cluster`` (the four cluster kernels, what
``roofline.*`` reads), ``mac`` (``csrc/mac.cu``), ``dyadic``
(``csrc/dyadic.cu``) and ``glue`` (every other kernel: PyTorch's own).
``glue_ms.*`` reads ``mac`` + ``dyadic`` + ``glue``. ``--eager-boot`` runs
the backend's bootstraps eagerly (a graph replay's kernels have no
launching op, and are charged to ``(graph replays)`` otherwise).

Runs on any commit of the port that has the recorder's ``op.*`` spans (a
program without the dyadic kernel simply has no ``dyadic`` kind). Needs the card; prints one JSON line
with the card's name and power limit, and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

KINDS = {"cluster": ("ntt_fwd_kernel", "ntt_inv_kernel", "ks_fused_kernel",
                     "md_fused_kernel"),
         "mac": ("hoisted_mac_kernel", "add_lifted_kernel",
                 "masked_sum_kernel"),
         "dyadic": ("binary_kernel", "tensor_kernel", "sum_kernel")}


def kind_of(name: str) -> str:
    for kind, names in KINDS.items():
        if any(k in name for k in names):
            return kind
    return "glue"


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def split(prof, requests: int) -> dict:
    """{op: {kind: device ms a request}} of a finished profile, and the
    ten kernels that took most glue time outside the four kinds."""
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    ops: dict = {}              # thread -> sorted [(start, end, name)]
    launches: dict = {}         # correlation id -> (thread, host start)
    kernels = []
    for e in events:
        if e.device_type == cpu and e.name.startswith("op."):
            ops.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == cpu and e.name.startswith("cuda"):
            # The runtime calls (launches, copies, graph launches) share
            # their device work's correlation id.
            launches[e.id] = (e.thread, e.time_range.start, e.name)
        elif e.device_type == cuda and not getattr(e, "is_user_annotation",
                                                   False):
            kernels.append(e)
    for v in ops.values():
        v.sort()
    starts = {t: [s for s, _, _ in v] for t, v in ops.items()}
    table: dict = {}
    top: dict = {}
    for k in kernels:
        ms = k.time_range.elapsed_us() / 1e3 / requests
        where = "(outside ops)"
        launch = launches.get(k.id)
        if launch is None:
            where = "(no launch seen)"
        elif "Graph" in launch[2]:
            where = "(graph replays)"
        else:
            th, t0, _ = launch
            i = bisect.bisect_right(starts.get(th, []), t0) - 1
            if i >= 0 and ops[th][i][1] >= t0:
                where = ops[th][i][2]
        kind = kind_of(k.name)
        row = table.setdefault(where, {})
        row[kind] = row.get(kind, 0.0) + ms
        if kind == "glue":
            top[k.name[:90]] = top.get(k.name[:90], 0.0) + ms
    for row in table.values():
        row["glue_ms"] = sum(v for k, v in row.items() if k != "cluster")
    order = sorted(table.items(), key=lambda kv: -kv[1]["glue_ms"])
    return {"by_op": dict(order),
            "glue_ms": sum(r["glue_ms"] for r in table.values()),
            "top_glue_kernels": sorted(top.items(), key=lambda kv: -kv[1])[
                :10]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--eager-boot", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from fhe_bench import drivers, harness
    from fhe_gpt2_tpu_torch.utils import telemetry

    if not torch.cuda.is_available():
        print("glue_by_op: no CUDA device", file=sys.stderr)
        return 2
    out = Path(a.out or REPO / "build" / "traces" /
               f"{a.workload}.glue.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    spec = harness.load_spec()
    _, cfg, traffic = harness.cell(spec, a.workload)
    t0 = time.perf_counter()
    drv = drivers.load(traffic["driver"]).Driver(
        cfg, traffic, a.seed, "cuda", list(cfg["flags"]))
    drv.setup()
    setup_s = time.perf_counter() - t0
    boot = getattr(drv.ses.B, "boot", None) if a.eager_boot else None
    if boot is not None:
        boot.bootstrap_jitted = boot.bootstrap
    timed = telemetry._timed

    def labelled(t, name, level, fn, args, kw):
        if not name.startswith("op."):
            return timed(t, name, level, fn, args, kw)
        with record_function(name):
            return timed(t, name, level, fn, args, kw)

    telemetry._timed = labelled
    try:
        drv.request(0)
        torch.cuda.synchronize()
        telemetry.enable()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for i in range(1, 1 + a.requests):
                drv.request(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) / a.requests
        telemetry.disable()
    finally:
        telemetry._timed = timed
        if boot is not None:
            del boot.bootstrap_jitted
    res = {"workload": a.workload, "seed": a.seed, "card": card(),
           "setup_s": setup_s, "requests": a.requests,
           "eager_boot": bool(boot), "profiled_s_per_request": wall,
           **split(prof, a.requests)}
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
