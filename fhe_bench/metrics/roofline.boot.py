"""roofline.boot: The four CUDA kernels' least time over their device time,
in the traced window of a bootstrap requests (``readers.roofline``)."""

from fhe_bench import readers


def read(run):
    return readers.roofline(run)
