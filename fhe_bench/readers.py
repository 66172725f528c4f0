"""What the metric files under ``fhe_bench/metrics/`` read from a run.

Each metric file holds ``read(run) -> float | None``; ``run`` is a
``harness.Run``. A reader that finds nothing to read returns None, and
the harness leaves that metric out of the result. Shares of a roofline or
of a peak are never given as 0: with no device time to divide by they are
None.
"""

from __future__ import annotations

import numpy as np


def per_request_s(run) -> float | None:
    """The window's seconds over the requests it completed."""
    return run.window_s / run.requests if run.requests else None


def p90_s(run) -> float | None:
    """The 90th percentile (linear) of every request latency in the
    window."""
    if not run.latencies:
        return None
    return float(np.percentile(run.latencies, 90))


def mfu(run) -> float | None:
    """A roofline share of the whole request under an mfu name: the least
    seconds the card needs for the window's homomorphic operations (bytes
    at the memory rate or 32-bit multiplies at the multiply rate, whichever
    binds; ``work.Work``), over the traced window, in %."""
    p, tr = run.probe, run.trace
    if p is None or tr is None or tr.busy_s <= 0 or p.work.ops == 0:
        return None
    return 100.0 * p.work.seconds() / tr.window_s


def roofline(run) -> float | None:
    """The four CUDA kernels' summed least time (from the shapes of their
    calls) over their summed device time in the trace, in %."""
    p, tr = run.probe, run.trace
    if p is None or tr is None:
        return None
    device = sum(tr.kernel_s.values())
    if device <= 0:
        return None
    return 100.0 * sum(k[1] for k in p.kernels.values()) / device


def glue_ms(run) -> float | None:
    """Device ms per request in everything but the four CUDA kernels."""
    tr = run.trace
    if tr is None or tr.busy_s <= 0 or not run.requests:
        return None
    return 1e3 * tr.other_s / run.requests


def idle(run) -> float | None:
    """The share of the traced window in which nothing ran on the card,
    in %."""
    tr = run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def count_per_request(run, name: str) -> float | None:
    if run.probe is None or not run.requests:
        return None
    return run.probe.counts[name] / run.requests


def ms_per_request(run, name: str) -> float | None:
    if run.probe is None or not run.requests:
        return None
    return 1e3 * run.probe.counts[name] / run.requests


def seconds_per_call(run, seconds: str, calls: str) -> float | None:
    if run.probe is None or not run.probe.counts[calls]:
        return None
    return run.probe.counts[seconds] / run.probe.counts[calls]
