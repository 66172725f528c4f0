"""encodes.resnet: Mask encodings (misses of the backend's mask cache) per
ResNet block."""

from fhe_bench import readers


def read(run):
    return readers.count_per_request(run, "encodes")
