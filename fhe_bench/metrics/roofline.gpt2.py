"""roofline.gpt2: The four CUDA kernels' least time over their device time,
in the traced window of a GPT-2 LayerNorm requests
(``readers.roofline``)."""

from fhe_bench import readers


def read(run):
    return readers.roofline(run)
