"""refreshes.gpt2: Decrypt/re-encrypt refreshes (``fake_bootstrap``) per
GPT-2 LayerNorm."""

from fhe_bench import readers


def read(run):
    return readers.count_per_request(run, "refreshes")
