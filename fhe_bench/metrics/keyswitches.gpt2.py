"""keyswitches.gpt2: Key switches and hoisted key products (each reads a key;
the port's counter ``ks``) per GPT-2 LayerNorm."""

from fhe_bench import recorded


def read(run):
    return recorded.count_per_request(run, "ks")
