"""mask_hit.granite: The share of the mask lookups in a Granite 4.0-H mixer
core that the backend's caches answered (the port's counters ``mask.hits``
over ``mask.lookups``), in %."""

from fhe_bench import recorded


def read(run):
    return recorded.hit_share(run)
