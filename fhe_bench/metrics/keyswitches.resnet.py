"""keyswitches.resnet: Key switches and hoisted key products (each reads a key;
the port's counter ``ks``, replayed bootstraps included) per ResNet block."""

from fhe_bench import recorded


def read(run):
    return recorded.count_per_request(run, "ks")
