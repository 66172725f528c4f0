"""mac_kernel.boot: The share of the hoisted key products and masked sums
of a bootstrap request that launched the MAC kernel: the port's counter
``mac.kernel`` over ``mac.calls`` (each sealed replay adds its warm
pass's), in %. None where the port has no such counters."""

from fhe_bench import recorded


def read(run):
    s = recorded.snapshot(run)
    if s is None or not s.counters.get("mac.calls"):
        return None
    return 100.0 * s.counters.get("mac.kernel", 0) / s.counters["mac.calls"]
