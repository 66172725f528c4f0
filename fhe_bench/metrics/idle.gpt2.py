"""idle.gpt2: The share of the traced window (a GPT-2 LayerNorm requests)
in which nothing ran on the card."""

from fhe_bench import readers


def read(run):
    return readers.idle(run)
