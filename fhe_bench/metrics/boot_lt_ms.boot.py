"""boot_lt_ms.boot: Device ms per bootstrap in its CoeffToSlot and SlotToCoeff
stages (the CUDA events of the port's ``boot.cts*`` and ``boot.stc*``
spans)."""

from fhe_bench import recorded


def read(run):
    return recorded.device_ms_per_request(run, *recorded.BOOT_LT)
