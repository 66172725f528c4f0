"""boot_evalmod_ms.boot: Device ms per bootstrap in its EvalMod stage (the CUDA
events of the port's ``boot.evalmod`` span)."""

from fhe_bench import recorded


def read(run):
    return recorded.device_ms_per_request(run, *recorded.BOOT_EVALMOD)
