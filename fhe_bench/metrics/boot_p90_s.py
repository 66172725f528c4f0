"""boot_p90_s: The 90th percentile of every bootstrap latency in the
window."""

from fhe_bench import readers


def read(run):
    return readers.p90_s(run)
