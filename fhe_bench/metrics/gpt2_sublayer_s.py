"""gpt2_sublayer_s: Seconds per GPT-2 sub-layer request: the window over
the requests it completed."""

from fhe_bench import readers


def read(run):
    return readers.per_request_s(run)
