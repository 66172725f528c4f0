"""glue_ms.granite: Device ms per request (a Granite 4.0-H mixer core) in
everything but the four CUDA kernels: the int64 torch glue between them."""

from fhe_bench import readers


def read(run):
    return readers.glue_ms(run)
