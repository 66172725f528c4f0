"""Telemetry of the port: the span-and-counter recorder, and the level/op
proxy backend.

The recorder
------------
Sites inside the port record spans and counters here: the model drivers'
segments and layers, the LT engine's mask cache, the evaluator's ops and
key switches, the bootstrap and each of its stages, and the decrypt/
re-encrypt refresh. It records while ``enable()`` holds, or while a
``torch.profiler`` session is active (torch's ``_is_profiler_enabled``, the
flag its own ``record_function`` checks), and at no other time. Off, a site
costs one check of two module-level flags: it allocates, synchronizes and
prints nothing. ``enable(only=names)`` records those spans alone, with no
CUDA events and no counters (the ``run_resnet`` CLI's bootstrap times).

* A span (``Span``) holds its name, its start and end on
  ``time.perf_counter_ns`` (the host clock onto which ``export`` maps the
  device trace), its id, its parent's and its root's, its thread and a
  level or stage index. Parents come from a per-thread stack; a root is the
  outermost port span on its thread (a segment, a LayerNorm, a top-level
  bootstrap), and its id is the request's. A coarse span on the card (a
  bootstrap and each of its stages) records a pair of CUDA events on the
  current stream, which ``snapshot()`` resolves to device ms after the
  caller has synchronized. The ``bootstrap``, ``refresh`` and the
  encryption's last ``encrypt.device`` spans synchronize the card at their
  end (outside a sealed call). At most
  ``MAX_SPANS`` spans are kept; the rest are counted as dropped.
* Counters: ``mask.lookups``, ``mask.hits``, ``mask.evictions`` (the
  backend's mask cache), ``op.<name>@<level>`` (outermost evaluator ops, at
  the level of the ciphertext they were called on), ``ks`` (key switches
  and hoisted key products: each reads a key), ``ks.decompose`` (the
  hoisted rotations' shared digit decompositions), ``mac.calls`` (the
  hoisted key products and the LT engine's masked sums, ``core/tks.py``
  ``hoisted_mac``/``masked_sum``), ``mac.kernel`` (those of them that
  launched ``csrc/mac.cu``), ``dyadic.calls`` (the evaluator's
  coefficient-wise products, adds and batch sums, ``core/tdyadic.py``) and
  ``dyadic.kernel`` (those of them that launched ``csrc/dyadic.cu``).
* A sealed program (``nn/backend.py``) keeps the op, key-switch, MAC and
  dyadic counters of its warm pass (``collect``, which counts even with the recorder off)
  and each graph replay adds them (``add``): a replay calls no Python. A
  capture records nothing (``muted``).

``snapshot()`` returns what was recorded, with ``core/_cuda.LAUNCHES``
beside the counters; ``export(path, profile)`` writes one Chrome-trace JSON
of the spans and of a finished ``torch.profiler.profile``'s device events
on the same clock, with the device's idle gaps summed by the innermost
span that holds each (``idle_by_span``); ``trace(path)`` wraps a run in
the recorder and the profiler and exports it (the drivers' ``--trace``).

TelemetryBackend
----------------
The port's copy of ``fhe_gpt2_tpu/utils/telemetry.py``'s proxy (standard
library only). The reference threads a Decryptor through every kernel and
prints remaining level / scale / timing from *_print wrappers
(cnn_seal.cpp:101-283, PRINT_CIPHER util.h:33 — SURVEY §5 calls this out as
first-class need). Here it's a zero-intrusion wrapper: TelemetryBackend
proxies any backend, records per-op class counts, level consumption, scale
trajectory and wall time, and prints a summary table. No decryption
anywhere near the hot path.

On the card its seconds are host dispatch time, not device time: the
wrapper does not synchronize, and PyTorch returns from an op before the
card has run it. Device time comes from the recorder's events or from
torch.profiler.
"""

from __future__ import annotations

import bisect
import functools
import itertools
import json
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch.autograd.profiler as _prof

MAX_SPANS = 2_000_000
# The counters a sealed program's replay adds: its warm pass's ops, key
# switches, MACs and dyadic calls. A replay looks up no mask and encodes
# nothing.
REPLAYED = ("op.", "ks", "mac.", "dyadic.")
SPIN_CYCLES = 100_000          # the alignment marker's spin kernel

_enabled = 0                   # enable() depth
_only: dict = {}               # span name -> enable(only=...) depth
_live = 0                      # enable() depths + collect() calls running
_lock = threading.Lock()       # the depths, the thread list, the drops
_spans: list = []
_dropped = 0
_marks: list = []              # perf_counter_ns of each marker's spin kernel
_ids = itertools.count(1)
_tls = threading.local()
_threads: list = []            # every thread's _ThreadState


class _ThreadState:
    """One thread's open spans, op depth, mute depth, collectors and
    counters (merged by ``snapshot``; no lock on the hot path)."""

    def __init__(self):
        self.stack: list = []
        self.op_depth = 0
        self.mute = 0
        self.sinks: list = []
        self.ident = threading.get_ident()
        self.counts: dict = {}
        with _lock:
            _threads.append(self)


def _thread() -> _ThreadState:
    t = getattr(_tls, "s", None)
    if t is None:
        t = _tls.s = _ThreadState()
    return t


def recording() -> bool:
    """Whether the recorder is on: inside ``enable()`` or a profiler
    session."""
    return bool(_enabled) or _prof._is_profiler_enabled


# -- switching on ---------------------------------------------------------

class enable:
    """Turn the recorder on: as a context manager for its body, or as a
    plain call until ``disable()``. On a card it first places the alignment
    marker that ``export`` maps a profiler trace with: a spin kernel
    launched right after a synchronize, its host instant stamped.
    ``only``: record just the spans of these names (of ``span`` and
    ``traced``), without CUDA events, and no counter; no marker."""

    def __init__(self, only=None):
        global _enabled, _live
        self.only = tuple(only or ())
        with _lock:
            if self.only:
                for name in self.only:
                    _only[name] = _only.get(name, 0) + 1
            else:
                _enabled += 1
            _live += 1
        if not self.only:
            _place_marker()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        disable(self.only)
        return False


def disable(only=None) -> None:
    """Undo one ``enable()`` (one ``enable(only)`` given the same names)."""
    global _enabled, _live
    with _lock:
        if only:
            for name in only:
                if _only.get(name, 0) > 1:
                    _only[name] -= 1
                else:
                    _only.pop(name, None)
            _live -= 1
        elif _enabled:
            _enabled -= 1
            _live -= 1


def _place_marker() -> None:
    import torch
    if not torch.cuda.is_available():
        return
    # Small kernels first: a profiler trace can lose its first events.
    pad = torch.zeros(1, device="cuda")
    for _ in range(3):
        pad.add_(1)
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    torch.cuda._sleep(SPIN_CYCLES)
    torch.cuda.synchronize()
    _marks.append(t)


def reset() -> None:
    """Drop every span, counter and marker recorded so far."""
    global _dropped
    with _lock:
        _spans.clear()
        _marks.clear()
        _dropped = 0
        for t in _threads:
            t.counts.clear()


# -- spans ----------------------------------------------------------------
#
# A closed span is kept as a tuple (name, t0, t1, id, parent, root, thread,
# level, index, synced, device): tuples of numbers and strings cost the
# garbage collector nothing, where a kept object per op would be traversed
# by every full collection. ``device`` is the (start, end) CUDA event pair
# until ``snapshot()`` resolves it to ms. An open span is an (id, root)
# pair on its thread's stack.

class Span:
    """One recorded span, as ``snapshot()`` and ``spans_since`` give it.
    ``t0``/``t1``: perf_counter_ns; ``parent`` 0 for a root; ``device_ms``
    from its CUDA events (None without)."""

    __slots__ = ("name", "t0", "t1", "id", "parent", "root", "thread",
                 "level", "index", "synced", "device_ms")

    def __init__(self, name, t0=0, t1=0, id=0, parent=0, root=0, thread=0,
                 level=None, index=None, synced=False, device_ms=None):
        self.name, self.t0, self.t1 = name, t0, t1
        self.id, self.parent, self.root = id, parent, root
        self.thread, self.level, self.index = thread, level, index
        self.synced, self.device_ms = synced, device_ms

    @property
    def ms(self) -> float:
        """Host milliseconds."""
        return (self.t1 - self.t0) / 1e6


def _open(t):
    """Push a new span on thread state t's stack: (id, parent, root)."""
    i = next(_ids)
    stack = t.stack
    if stack:
        parent, root = stack[-1]
    else:
        parent, root = 0, i
    stack.append((i, root))
    return i, parent, root


def _close(t, rec) -> None:
    global _dropped
    t.stack.pop()
    if len(_spans) < MAX_SPANS:
        _spans.append(rec)
    else:
        with _lock:
            _dropped += 1


class _Recording:
    """The context manager of one span while the recorder is on."""

    __slots__ = ("name", "level", "index", "events", "sync", "t", "t0",
                 "ids")

    def __init__(self, name, level, index, events, sync):
        self.name, self.level, self.index = name, level, index
        self.events, self.sync = events, sync

    def __enter__(self):
        t = getattr(_tls, "s", None) or _thread()
        full = _enabled or _prof._is_profiler_enabled
        if t.mute or not (full or self.name in _only):
            self.t = None
            return self
        self.t = t
        self.ids = _open(t)
        if self.events and full:
            import torch
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            self.events = ev
        else:
            self.events = None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = self.t
        if t is None:
            return False
        if self.events is not None:
            self.events[1].record()
        if self.sync:
            import torch
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        i, parent, root = self.ids
        _close(t, (self.name, self.t0, t1, i, parent, root, t.ident,
                   self.level, self.index, bool(self.sync), self.events))
        return False


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str, level: int | None = None, index: int | None = None,
         events: bool = False, sync: bool = False):
    """A context manager recording one span while the recorder is on.
    ``events``: record a pair of CUDA events too (coarse spans on the card
    only); ``sync``: synchronize the card (where CUDA is in use) at the
    span's end, and mark the span ``synced``."""
    if not (_live or _prof._is_profiler_enabled):
        return _NULL
    return _Recording(name, level, index, events, sync)


def _timed(t, name, level, fn, args, kw):
    """fn(*args, **kw) inside a span of `name` on thread state t."""
    i, parent, root = _open(t)
    t0 = time.perf_counter_ns()
    try:
        return fn(*args, **kw)
    finally:
        _close(t, (name, t0, time.perf_counter_ns(), i, parent, root,
                   t.ident, level, None, False, None))


def traced(name: str):
    """Decorator: fn runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not (_live or _prof._is_profiler_enabled):
                return fn(*args, **kw)
            t = getattr(_tls, "s", None) or _thread()
            if t.mute or not (_enabled or _prof._is_profiler_enabled
                              or name in _only):
                return fn(*args, **kw)
            return _timed(t, name, None, fn, args, kw)
        return call
    return wrap


def op(name: str, level_arg: int = 1):
    """Decorator of an evaluator op: at the outermost op call on its thread
    a span ``op.<name>`` and a count ``op.<name>@<level>``, the level of
    args[level_arg] (a ciphertext's, or the int itself) on entry."""
    span_name, keys = f"op.{name}", {}

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not (_live or _prof._is_profiler_enabled):
                return fn(*args, **kw)
            t = getattr(_tls, "s", None) or _thread()
            full = _enabled or _prof._is_profiler_enabled
            if t.op_depth or t.mute or not (full or t.sinks):
                return fn(*args, **kw)
            a = args[level_arg] if len(args) > level_arg else None
            level = a if isinstance(a, int) else getattr(a, "level", None)
            key = keys.get(level)
            if key is None:
                key = keys[level] = f"{span_name}@{level}"
            t.op_depth += 1
            try:
                if full:
                    out = _timed(t, span_name, level, fn, args, kw)
                else:
                    out = fn(*args, **kw)
            finally:
                t.op_depth -= 1
            _count(t, key, 1)
            return out
        return call
    return wrap


# -- counters -------------------------------------------------------------

def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` (and to this thread's collectors)."""
    if not (_live or _prof._is_profiler_enabled):
        return
    _count(getattr(_tls, "s", None) or _thread(), name, n)


def _count(t, name, n) -> None:
    if t.mute:
        return
    if _enabled or _prof._is_profiler_enabled:
        c = t.counts
        c[name] = c.get(name, 0) + n
    for sink in t.sinks:
        sink[name] = sink.get(name, 0) + n


def add(counts: dict) -> None:
    """Add a dict of counts (a sealed program's, at each replay)."""
    if not (_live or _prof._is_profiler_enabled):
        return
    t = _thread()
    for name, n in counts.items():
        _count(t, name, n)


@contextmanager
def collect():
    """Count this thread's counters in the body into a dict, whether or not
    the recorder is on (a sealed program's warm pass); yields the dict."""
    global _live
    sink: dict = {}
    t = _thread()
    with _lock:
        _live += 1
    t.sinks.append(sink)
    try:
        yield sink
    finally:
        t.sinks.remove(sink)
        with _lock:
            _live -= 1


@contextmanager
def muted():
    """Record nothing on this thread in the body (a CUDA-graph capture:
    its ops run again later, and no event may be recorded into it)."""
    t = _thread()
    t.mute += 1
    try:
        yield
    finally:
        t.mute -= 1


# -- reading --------------------------------------------------------------

@dataclass
class Snapshot:
    """What the recorder holds: spans (device ms resolved), counters, the
    spans dropped, and ``core/_cuda.LAUNCHES``."""

    spans: list
    counters: dict
    dropped: int = 0
    launches: dict = field(default_factory=dict)

    def _named(self, prefixes):
        return [s for s in self.spans if s.name.startswith(prefixes)]

    def host_ms(self, *prefixes) -> float | None:
        """Host ms summed over the spans whose names start with one of
        `prefixes`; None when there is none."""
        found = self._named(prefixes)
        return sum(s.ms for s in found) if found else None

    def device_ms(self, *prefixes) -> float | None:
        """Device ms summed over those spans; None when none has events."""
        found = [s.device_ms for s in self._named(prefixes)
                 if s.device_ms is not None]
        return sum(found) if found else None


def snapshot() -> Snapshot:
    """A copy of what was recorded. Resolves the spans' CUDA events: call
    it after the work has been synchronized (it waits on each end event)."""
    from ..core import _cuda
    counters: dict = {}
    with _lock:
        n = len(_spans)
        dropped = _dropped
        for t in _threads:
            for k, c in list(t.counts.items()):
                counters[k] = counters.get(k, 0) + c
    for i in range(n):
        rec = _spans[i]
        if isinstance(rec[10], tuple):
            start, end = rec[10]
            end.synchronize()
            _spans[i] = rec[:10] + (start.elapsed_time(end),)
    with _cuda._LOCK:
        launches = dict(_cuda.LAUNCHES)
    return Snapshot(spans=[_span(r) for r in _spans[:n]],
                    counters=counters, dropped=dropped, launches=launches)


def _span(rec) -> Span:
    """The ``Span`` of a record, device ms None where ``snapshot()`` has
    not resolved its events."""
    return Span(*rec[:10], rec[10] if isinstance(rec[10], float) else None)


def mark() -> int:
    """A mark for ``spans_since``: every span opened after this call has a
    larger id (ids are never reused, ``reset()`` or not)."""
    return next(_ids)


def spans_since(mark: int) -> list:
    """``Span``s kept of those opened after `mark` (``mark()``)."""
    return [_span(r) for r in _spans if r[3] > mark]


def dropped() -> int:
    """Spans dropped since the last ``reset()`` (the buffer was full)."""
    return _dropped


def _device_events(profile):
    """[(start_us, dur_us, name)] of a finished profile's CUDA events, by
    start (the profiler's own clock)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    evs = [(e.time_range.start, e.time_range.elapsed_us(), e.name)
           for e in profile.events()
           if e.device_type == cuda
           and not getattr(e, "is_user_annotation", False)]
    evs.sort()
    return evs


def idle_by_span(spans: list, intervals: list, lo: int, hi: int) -> list:
    """[[name, seconds]] of the gaps in [lo, hi] (ns) that no device
    interval (ns, sorted by start) covers, summed by the innermost span
    holding each gap's midpoint ("python" where none does), largest
    first."""
    gaps, prev = [], lo
    for a, b in intervals:
        if a > prev:
            gaps.append((prev, min(a, hi)))
        prev = max(prev, b)
        if prev >= hi:
            break
    if prev < hi:
        gaps.append((prev, hi))
    by_start = sorted(spans, key=lambda s: s.t0)
    starts = [s.t0 for s in by_start]
    totals: dict = {}
    open_: list = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        if b <= a:
            continue
        mid = (a + b) // 2
        j = bisect.bisect_right(starts, mid)
        open_.extend(by_start[i:j])
        i = max(i, j)
        open_ = [s for s in open_ if s.t1 >= mid]
        label = max(open_, key=lambda s: s.t0).name if open_ else "python"
        totals[label] = totals.get(label, 0.0) + (b - a) / 1e9
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])]


def export(path, profile=None) -> dict:
    """Write one Chrome-trace JSON to `path`: a host track of the spans (one
    row per thread) and, given a finished ``torch.profiler.profile``, a
    device track of its CUDA events on the host clock (through the last
    marker ``enable()`` placed inside it), with ``idle_by_span`` (device
    idle seconds by the innermost span holding each gap), the counters and
    the spans dropped beside them. Returns that summary."""
    snap = snapshot()
    events = []
    for s in snap.spans:
        args = {"id": s.id, "parent": s.parent, "root": s.root}
        for k in ("level", "index", "device_ms"):
            v = getattr(s, k)
            if v is not None:
                args[k] = v
        events.append({"name": s.name, "ph": "X", "pid": "host",
                       "tid": s.thread, "ts": s.t0 / 1e3,
                       "dur": (s.t1 - s.t0) / 1e3, "args": args})
    idle, aligned = [], False
    if profile is not None:
        evs = _device_events(profile)
        spins = [e for e in evs if "spin_kernel" in e[2]]
        aligned = bool(spins and _marks)
        if evs:
            off = spins[-1][0] if aligned else evs[0][0]
            base = _marks[-1] if aligned else (
                min(s.t0 for s in snap.spans) if snap.spans else 0)
            intervals = []
            for us, dur, name in evs:
                a = base + int((us - off) * 1e3)
                intervals.append((a, a + int(dur * 1e3)))
                events.append({"name": name, "ph": "X", "pid": "device",
                               "tid": "cuda", "ts": a / 1e3, "dur": dur})
            if snap.spans:
                lo = min(s.t0 for s in snap.spans)
                hi = max(s.t1 for s in snap.spans)
                idle = idle_by_span(snap.spans, sorted(intervals), lo, hi)
    summary = {"idle_by_span": idle, "aligned": aligned,
               "counters": snap.counters, "launches": snap.launches,
               "spans": len(snap.spans), "dropped": snap.dropped}
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   **summary}, f)
    return summary


@contextmanager
def trace(path):
    """The recorder and ``torch.profiler`` (its CUDA activity on a card,
    its CPU activity without one) over the body, then ``export(path)``.
    Yields a dict that holds export's summary afterwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    card = torch.cuda.is_available()
    out: dict = {}
    with profile(activities=[ProfilerActivity.CUDA if card
                             else ProfilerActivity.CPU]) as prof:
        with enable():
            yield out
        if card:
            torch.cuda.synchronize()
    out.update(export(path, prof))


# ---------------------------------------------------------------------------
# TelemetryBackend
# ---------------------------------------------------------------------------

_TRACKED = (
    "add", "sub", "neg", "mul", "square", "mul_plain", "add_plain",
    "add_const", "mul_const", "rotate", "rotate_many", "conjugate", "rescale",
    "bootstrap", "maybe_bootstrap", "stack", "reduce_sum_batch",
)


@dataclass
class OpStats:
    count: int = 0
    seconds: float = 0.0
    levels_consumed: int = 0


class TelemetryBackend:
    """Proxy backend recording op counts, time, and level consumption."""

    def __init__(self, inner):
        self._inner = inner
        self.stats: dict = defaultdict(OpStats)
        self.events: list = []

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in _TRACKED or not callable(attr):
            return attr

        def wrapped(*args, **kw):
            lvl_in = self._level_of(args[0]) if args else None
            t0 = time.perf_counter()
            out = attr(*args, **kw)
            dt = time.perf_counter() - t0
            st = self.stats[name]
            st.count += 1
            st.seconds += dt
            lvl_out = self._level_of(out)
            if lvl_in is not None and lvl_out is not None and lvl_out < lvl_in:
                st.levels_consumed += lvl_in - lvl_out
            self.events.append((name, lvl_in, lvl_out, dt))
            return out

        return wrapped

    def _level_of(self, v):
        try:
            return int(self._inner.level(v))
        except Exception:
            return None

    # -- reporting ----------------------------------------------------------

    def report(self) -> str:
        lines = [f"{'op':<16}{'count':>8}{'time_s':>10}{'levels':>8}"]
        total_t = 0.0
        for name, st in sorted(self.stats.items(),
                               key=lambda kv: -kv[1].seconds):
            lines.append(f"{name:<16}{st.count:>8}{st.seconds:>10.3f}"
                         f"{st.levels_consumed:>8}")
            total_t += st.seconds
        lines.append(f"{'TOTAL':<16}{sum(s.count for s in self.stats.values()):>8}"
                     f"{total_t:>10.3f}")
        return "\n".join(lines)

    def level_trajectory(self) -> list:
        """(op, level_out) sequence — the reference's 'remaining level' log."""
        return [(n, lo) for (n, _, lo, _) in self.events if lo is not None]

    def reset(self):
        self.stats.clear()
        self.events.clear()
