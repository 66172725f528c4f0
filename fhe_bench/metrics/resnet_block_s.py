"""resnet_block_s: Seconds per ResNet-20 residual block: the window over
the blocks it completed."""

from fhe_bench import readers


def read(run):
    return readers.per_request_s(run)
