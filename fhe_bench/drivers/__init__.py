"""Request drivers: one general generator per kind of traffic.

A traffic mix (``fhe_bench/traffic/<name>.json``) names its driver and
holds the parameters the driver reads; the driver builds the cell's
session, its pool of encrypted inputs and its warm-up from the
configuration and the seed, then serves one request per ``request`` call.
"""

from __future__ import annotations

import importlib


def load(name: str):
    """The driver module ``fhe_bench.drivers.<name>``."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad driver name {name!r}")
    return importlib.import_module(f"fhe_bench.drivers.{name}")


def sync(device: str) -> None:
    if device != "cpu":
        import torch
        torch.cuda.synchronize()
