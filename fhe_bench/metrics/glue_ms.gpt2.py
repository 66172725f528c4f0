"""glue_ms.gpt2: Device ms per request (a GPT-2 LayerNorm) in everything
but the four CUDA kernels: the int64 torch glue between them."""

from fhe_bench import readers


def read(run):
    return readers.glue_ms(run)
