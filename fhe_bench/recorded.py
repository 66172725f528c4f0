"""What the metric files read from the port's own recorder
(``fhe_gpt2_tpu_torch/utils/telemetry.py``).

The recorder is on while a ``torch.profiler`` session runs, so in a
``--trace 1`` run it holds the measured window and nothing of set-up; a
sealed program's replays add the op and key-switch counts of its warm
pass. One ``telemetry.snapshot()`` a run is taken, on the first read,
after the window has closed and the card has been synchronized. A reader
divides by ``run.requests`` and returns None where the recorder holds
nothing it reads: a program without the recorder (the snapshot function
is missing), a counter or span never recorded, or device ms on the CPU.
"""

from __future__ import annotations

_UNREAD = object()


def snapshot(run):
    """The recorder's snapshot, taken once per run; None without one."""
    snap = getattr(run, "_recorded", _UNREAD)
    if snap is _UNREAD:
        try:
            from fhe_gpt2_tpu_torch.utils import telemetry
        except ImportError:
            telemetry = None
        take = getattr(telemetry, "snapshot", None)
        snap = take() if take is not None else None
        run._recorded = snap
    return snap


def hit_share(run) -> float | None:
    """Mask lookups the backend's caches answered, in %."""
    s = snapshot(run)
    if s is None or not s.counters.get("mask.lookups"):
        return None
    return 100.0 * s.counters.get("mask.hits", 0) / s.counters["mask.lookups"]


def count_per_request(run, name: str) -> float | None:
    s = snapshot(run)
    if s is None or not run.requests or name not in s.counters:
        return None
    return s.counters[name] / run.requests


def host_ms_per_request(run, *prefixes) -> float | None:
    """Host ms per request in the spans whose names start with one of
    `prefixes`."""
    s = snapshot(run)
    if s is None or not run.requests:
        return None
    ms = s.host_ms(*prefixes)
    return None if ms is None else ms / run.requests


def host_ms_under_per_request(run, parent: str, *prefixes) -> float | None:
    """Host ms per request in the spans whose names start with one of
    `prefixes` and whose parent span is named `parent`."""
    s = snapshot(run)
    if s is None or not run.requests:
        return None
    ids = {sp.id for sp in s.spans if sp.name == parent}
    found = [sp.ms for sp in s.spans
             if sp.parent in ids and sp.name.startswith(prefixes)]
    return sum(found) / run.requests if found else None


def device_ms_per_request(run, *prefixes) -> float | None:
    """Device ms per request (the spans' CUDA events) in those spans."""
    s = snapshot(run)
    if s is None or not run.requests:
        return None
    ms = s.device_ms(*prefixes)
    return None if ms is None else ms / run.requests


BOOT_LT = ("boot.cts", "boot.stc")
BOOT_EVALMOD = ("boot.evalmod",)


def boot_rest_ms(run) -> float | None:
    """Device ms per request of the ``bootstrap`` spans outside their
    CoeffToSlot, SlotToCoeff and EvalMod stages: ModRaise and SubSum
    (prep), the real/imaginary split, the recombination and the entry."""
    whole = device_ms_per_request(run, "bootstrap")
    if whole is None:
        return None
    lt = device_ms_per_request(run, *BOOT_LT) or 0.0
    evalmod = device_ms_per_request(run, *BOOT_EVALMOD) or 0.0
    return whole - lt - evalmod
