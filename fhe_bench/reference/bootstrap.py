"""Plain reference of a CKKS bootstrap: the identity on the slot values.

A bootstrap raises a ciphertext's modulus and leaves its message as it was,
up to the approximation error of its EvalMod polynomial and the noise of
the operations; the reference of the values it returns is the values it was
given.
"""

from __future__ import annotations

import numpy as np


def bootstrap(values: np.ndarray) -> np.ndarray:
    return np.asarray(values, dtype=np.float64)
