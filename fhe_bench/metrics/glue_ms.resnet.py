"""glue_ms.resnet: Device ms per request (a ResNet block) in everything but
the four CUDA kernels: the int64 torch glue between them."""

from fhe_bench import readers


def read(run):
    return readers.glue_ms(run)
