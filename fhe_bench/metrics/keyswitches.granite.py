"""keyswitches.granite: Key switches and hoisted key products (each reads a
key; the port's counter ``ks``) per Granite 4.0-H mixer core."""

from fhe_bench import recorded


def read(run):
    return recorded.count_per_request(run, "ks")
