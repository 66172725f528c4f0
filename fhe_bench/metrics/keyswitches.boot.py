"""keyswitches.boot: Key switches and hoisted key products (each reads a key;
the port's counter ``ks``, added by each sealed replay from its warm pass)
per bootstrap request."""

from fhe_bench import recorded


def read(run):
    return recorded.count_per_request(run, "ks")
