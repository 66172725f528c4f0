"""mask_hit.gpt2: The share of the mask lookups in a GPT-2 LayerNorm that the
backend's caches answered (the port's counters ``mask.hits`` over
``mask.lookups``), in %."""

from fhe_bench import recorded


def read(run):
    return recorded.hit_share(run)
