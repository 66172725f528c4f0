"""idle.granite: The share of the traced window (Granite mixer-core requests)
in which nothing ran on the card."""

from fhe_bench import readers


def read(run):
    return readers.idle(run)
