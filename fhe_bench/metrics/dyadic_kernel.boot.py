"""dyadic_kernel.boot: The share of the evaluator's coefficient-wise calls
(tensor products, products, adds) of a bootstrap request that launched the
dyadic kernel: the port's counter ``dyadic.kernel`` over ``dyadic.calls``
(each sealed replay adds its warm pass's), in %. None where the port has no
such counters."""

from fhe_bench import recorded


def read(run):
    s = recorded.snapshot(run)
    if s is None or not s.counters.get("dyadic.calls"):
        return None
    return 100.0 * s.counters.get("dyadic.kernel", 0) / s.counters[
        "dyadic.calls"]
