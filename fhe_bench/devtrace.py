"""The device trace of a traced run's window, and its reduction.

``torch.profiler`` records the card's activity (CUDA activity only: the
host side comes from the probes' spans, which cost far less than the
profiler's per-operator events). A spin kernel launched right after a
synchronize marks a known host instant on the device clock, so device
times map onto the host clock; three small kernels before it pad the
trace's start, where the tracer has dropped events.

``reduce`` keeps the device events inside the window and gives: the
seconds in which something ran on the device (the union of the events'
intervals), the device seconds of the four CUDA kernels by kind and of
everything else, the ten device operations that took most time, and the
idle gaps summed by what the host was doing in each (the probe span that
holds its midpoint; "python" where none does).
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

SPIN_CYCLES = 100_000
KERNEL_NAMES = {"ntt_fwd": "ntt_fwd_kernel", "ntt_inv": "ntt_inv_kernel",
                "keyswitch": "ks_fused_kernel", "moddown": "md_fused_kernel"}
TOP = 10


@dataclass
class TraceData:
    window_s: float
    busy_s: float
    kernel_s: dict             # kind -> device seconds of the four kernels
    other_s: float             # device seconds of every other event
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    events: int = 0
    reduce_s: float = 0.0
    aligned: bool = True


class DeviceTrace:
    """A context manager around the window: ``t0``/``t1`` are its host
    edges, taken with the device synchronized."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        pad = torch.zeros(1, device="cuda")
        for _ in range(3):
            pad.add_(1)
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        return False

    def reduce(self, spans: list) -> TraceData:
        import torch
        start = time.perf_counter()
        cuda = torch.autograd.DeviceType.CUDA
        evs = [(e.time_range.start, e.time_range.elapsed_us(), e.name)
               for e in self.prof.events()
               if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)]
        evs.sort()
        marks = [ev for ev in evs if "spin_kernel" in ev[2]]
        aligned = bool(marks)
        off = marks[0][0] if marks else (evs[0][0] if evs else 0.0)
        t_mark = self.t_mark if marks else self.t0

        def host(us):
            return t_mark + (us - off) / 1e6

        lo, hi = self.t0, self.t1
        kernel_s = {k: 0.0 for k in KERNEL_NAMES}
        by_name: dict = {}
        other = 0.0
        intervals = []
        for us, dur, name in evs:
            a = host(us)
            b = a + dur / 1e6
            if b <= lo or a >= hi:
                continue
            a, b = max(a, lo), min(b, hi)
            intervals.append((a, b))
            d = b - a
            by_name[name] = by_name.get(name, 0.0) + d
            kind = next((k for k, kn in KERNEL_NAMES.items() if kn in name),
                        None)
            if kind is None:
                other += d
            else:
                kernel_s[kind] += d
        busy, gaps = 0.0, []
        cur_a = cur_b = None
        prev_end = lo
        for a, b in intervals:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                if a > prev_end:
                    gaps.append((prev_end, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
            prev_end = max(prev_end, cur_b)
        if cur_b is not None:
            busy += cur_b - cur_a
        if hi > prev_end:
            gaps.append((prev_end, hi))
        return TraceData(
            window_s=hi - lo, busy_s=busy, kernel_s=kernel_s,
            other_s=other,
            device_ops=[[n[:80], s] for n, s in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            idle_gaps=label_gaps(gaps, spans), events=len(evs),
            reduce_s=time.perf_counter() - start, aligned=aligned)


def label_gaps(gaps: list, spans: list) -> list:
    """[[label, seconds]] of the idle gaps summed by the span holding each
    gap's midpoint, the TOP largest. Spans are (name, t0, t1), disjoint
    but for a few nested ones, so the last four to start before the
    midpoint are the ones that can hold it."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    totals: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        label = "python"
        for name, s0, s1 in spans[max(0, i - 3):i + 1][::-1]:
            if s0 <= mid <= s1:
                label = name
                break
        totals[label] = totals.get(label, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:TOP]]
