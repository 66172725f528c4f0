"""boot_rest_ms.boot: Device ms per bootstrap outside its CoeffToSlot,
SlotToCoeff and EvalMod stages: ModRaise and SubSum, the split, the
recombination and the entry (the port's ``bootstrap`` span's CUDA events
less those of its ``boot.cts*``, ``boot.stc*`` and ``boot.evalmod``)."""

from fhe_bench import recorded


def read(run):
    return recorded.boot_rest_ms(run)
