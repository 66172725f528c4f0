"""glue_ms.boot: Device ms per request (a bootstrap) in everything but the
four CUDA kernels: the int64 torch glue between them."""

from fhe_bench import readers


def read(run):
    return readers.glue_ms(run)
