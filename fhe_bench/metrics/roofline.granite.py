"""roofline.granite: The four CUDA kernels' least time over their device time,
in the traced window of Granite mixer-core requests (``readers.roofline``).
"""

from fhe_bench import readers


def read(run):
    return readers.roofline(run)
