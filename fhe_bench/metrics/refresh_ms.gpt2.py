"""refresh_ms.gpt2: Host ms in refreshes per GPT-2 LayerNorm, the card
synchronized at both edges of each."""

from fhe_bench import readers


def read(run):
    return readers.ms_per_request(run, "refresh_s")
