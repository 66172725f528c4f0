"""Move state between the JAX package and the port.

The JAX package holds residues as uint32 arrays (uint32 chains) or uint64
arrays (u64 chains); the port holds them as int32 or int64 tensors with the
same bits. These helpers take the JAX package's state as numpy arrays and
plain ints (the caller converts with ``np.asarray``; nothing here imports
JAX) and build the port's objects on a device, and ``to_numpy`` goes back.
With them both packages can be driven from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.evaluator import Ciphertext, Plaintext
from .core.keys import GaloisKeys, KSwitchKey, SecretKey
from .core.modmath import to_numpy_word

_SIGNED = {np.dtype(np.uint32): np.int32, np.dtype(np.uint64): np.int64}


def _tensor(data, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(data))
    if a.dtype not in _SIGNED:
        raise TypeError(f"expected uint32 or uint64 residues, got {a.dtype}")
    return torch.from_numpy(a.view(_SIGNED[a.dtype]).copy()).to(device)


def secret_from_reference(ntt: np.ndarray, coeffs, device="cuda") -> SecretKey:
    """SecretKey from its NTT form [L+k, N] and ternary coefficients [N]."""
    return SecretKey(ntt=_tensor(ntt, device),
                     coeffs=np.asarray(coeffs, dtype=np.int64))


def kswitch_key_from_reference(data: np.ndarray, device="cuda") -> KSwitchKey:
    """KSwitchKey from its data [D, 2, L+k, N]."""
    return KSwitchKey(data=_tensor(data, device))


def galois_keys_from_reference(keys: dict, device="cuda") -> GaloisKeys:
    """GaloisKeys from {galois_elt: data [D, 2, L+k, N]}."""
    return GaloisKeys(keys={int(e): kswitch_key_from_reference(d, device)
                            for e, d in keys.items()})


def ciphertext_from_reference(data: np.ndarray, scale: float,
                              device="cuda") -> Ciphertext:
    """Ciphertext from its data [k, *batch, l, N] (NTT form)."""
    return Ciphertext(data=_tensor(data, device), scale=float(scale))


def plaintext_from_reference(data: np.ndarray, scale: float,
                             device="cuda") -> Plaintext:
    """Plaintext from its data [l, N] (NTT form)."""
    return Plaintext(data=_tensor(data, device), scale=float(scale))


def to_numpy(x) -> np.ndarray:
    """A port tensor, or an object holding one in ``.data``/``.ntt``, as the
    JAX package's numpy array: uint32 for int32 words, uint64 for int64."""
    if not isinstance(x, torch.Tensor):
        x = x.ntt if isinstance(x, SecretKey) else x.data
    return to_numpy_word(x)
