"""boot_s: Seconds per bootstrap: the window over the bootstraps it
completed."""

from fhe_bench import readers


def read(run):
    return readers.per_request_s(run)
