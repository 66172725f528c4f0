"""One run of one cell: set-up, a measured window, the output check.

The cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``fhe_bench/configs/<name>.json``, found through ``configs[].file``) and
a traffic mix (``fhe_bench/traffic/<name>.json``), whose ``driver`` names
the request driver (``fhe_bench/drivers/<driver>.py``). The metrics the
cell reports are the ``end_to_end`` entries (``--trace 0``) or the
``per_layer`` entries (``--trace 1``) that list it, or list no cell; each
is read by ``fhe_bench/metrics/<name>.py``. A cell, a traffic mix or a
metric is added by adding files and entries; nothing here names one.

The window is a closed loop with one client: the next request is sent
when the last one has returned, with the card synchronized. It runs until
``seconds`` have passed and the request in flight then has completed, so
a rate is the whole window over whole requests. A share of the requests
(``check_share`` of the traffic mix, drawn from the seed) keeps its
answer; once the window has closed and the peak memory is read, those
answers are decrypted, the program's caches are dropped and the plain
reference judges them against the traffic mix's ``limits``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import drivers, inputs

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
TRAFFIC = HERE / "traffic"
FORBIDDEN = ("jax", "jaxlib", "flax", "fhe_gpt2_tpu")


def load_spec(path: Path = REPO / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) of a cell by name."""
    w = next((x for x in spec["workloads"] if x["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(x for x in spec["configs"] if x["name"] == w["config"])
    return (w, _json(REPO / c["file"]),
            _json(TRAFFIC / f"{w['traffic']}.json"))


def metrics_of(spec: dict, workload: str, trace: bool) -> list:
    """The metric entries the cell reports in a run of this kind."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The ``read`` function of ``fhe_bench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"fhe_bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclass
class Run:
    workload: str
    seed: int
    requests: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    latencies: list = field(default_factory=list)
    probe: object = None
    trace: object = None
    info: dict = field(default_factory=dict)


def measure(workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", spec: dict | None = None,
            flags: list | None = None, t_start: float | None = None):
    """Run the cell once: (result dict, checks [(name, value, limit)],
    Run, driver). ``flags`` replaces the configuration's driver flags (a
    lower-precision path of the program, for its control)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or load_spec()
    w, cfg, traffic = cell(spec, workload)
    mod = drivers.load(traffic["driver"])
    flags = list(cfg["flags"] if flags is None else flags)
    drv = mod.Driver(cfg, traffic, seed, device, flags)
    drv.setup()
    run = Run(workload, seed)
    run.setup_s = time.perf_counter() - t_start
    run.info.update(drv.ses.info, keygen_s=drv.ses.keygen_s,
                    galois_keys=drv.ses.galois_keys)

    def sync():
        drivers.sync(device)

    tracer = None
    if trace:
        from .probes import Probe
        run.probe = Probe(drv.ses, sync)
        run.probe.install()
        if drv.ses.B.boot is not None:
            B = drv.ses.B
            run.probe.record_bootstrap(B.from_slots(
                inputs.rng(seed, 7).uniform(-0.5, 0.5, B.slots)))
        if device != "cpu":
            from .devtrace import DeviceTrace
            tracer = DeviceTrace()
    keep = inputs.rng(seed, 8)
    share = traffic["check_share"]
    kept, last = [], None
    gc.collect()
    if tracer is not None:
        tracer.__enter__()
    t0 = time.perf_counter()
    try:
        while True:
            ts = time.perf_counter()
            last = drv.request(run.requests)
            t1 = time.perf_counter()
            run.latencies.append(t1 - ts)
            run.requests += 1
            if run.probe is not None:
                run.probe.spans.append(("request", ts, t1))
            if keep.random() < share:
                kept.append(last)
            if t1 - t0 >= seconds:
                break
    finally:
        if tracer is not None:
            tracer.__exit__(None, None, None)
    run.window_s = time.perf_counter() - t0
    q = np.percentile(run.latencies, [0, 50, 100])
    run.info.update(latency_min_med_max_s=[float(x) for x in q])
    if not kept:
        kept.append(last)

    peak = 0
    if device != "cpu":
        import torch
        peak = int(torch.cuda.max_memory_allocated())
    if run.probe is not None:
        run.probe.uninstall()
        if tracer is not None:
            run.trace = tracer.reduce(run.probe.spans)
            run.info.update(trace_events=run.trace.events,
                            trace_reduce_s=run.trace.reduce_s,
                            trace_aligned=run.trace.aligned)

    # The check: decrypt the kept answers, free the program's state, then
    # the reference.
    answers = drv.answers(kept)
    del kept, last
    drv.ses.B.release_caches()
    gc.collect()
    if device != "cpu":
        import torch
        torch.cuda.empty_cache()
    numbers = drv.compare(answers)
    limits = traffic["limits"]
    checks = [(k, numbers[k], limits[k]) for k in limits]
    correct = all(np.isfinite(v) and v <= lim for _, v, lim in checks)

    metrics = {}
    for m in metrics_of(spec, workload, trace):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": _device_name(device), "count": w["chips"],
           "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": run.requests,
              "failed": 0, "metrics": metrics, "device": dev}
    if run.trace is not None:
        tr = run.trace
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in checks}
    return result, checks, run, drv


def _device_name(device: str) -> str:
    if device == "cpu":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(0)
