"""mfu.granite: A roofline share of the whole request (a Granite 4.0-H mixer
core) under an mfu name: the least seconds its homomorphic operations need
on the card over the traced window (``readers.mfu``)."""

from fhe_bench import readers


def read(run):
    return readers.mfu(run)
