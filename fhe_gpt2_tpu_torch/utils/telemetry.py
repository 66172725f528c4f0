"""Level/scale/op telemetry — the FHE analogue of a memory profiler.

The port's copy of ``fhe_gpt2_tpu/utils/telemetry.py`` (standard library
only). The reference threads a Decryptor through every kernel and prints
remaining level / scale / timing from *_print wrappers (cnn_seal.cpp:101-283,
PRINT_CIPHER util.h:33 — SURVEY §5 calls this out as first-class need).
Here it's a zero-intrusion wrapper: TelemetryBackend proxies any backend,
records per-op class counts, level consumption, scale trajectory and wall
time, and prints a summary table. No decryption anywhere near the hot path.

On the card the seconds are host dispatch time, not device time: the
wrapper does not synchronize, and PyTorch returns from an op before the
card has run it. Time device work with CUDA events or torch.profiler.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass


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
