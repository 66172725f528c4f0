"""roofline.resnet: The four CUDA kernels' least time over their device
time, in the traced window of a ResNet block requests
(``readers.roofline``)."""

from fhe_bench import readers


def read(run):
    return readers.roofline(run)
