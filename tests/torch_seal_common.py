"""SEAL's bit-exact vectors on the port: the loader and the session that
tests/test_torch_u64_seal.py (CPU), tests/test_torch_cuda.py and
chip_smoke.py (card) hold the port's u64 engine against.

tests/data/seal_vectors.bin (N=8192; moduli of 50, 40 and 40 bits plus a
50-bit special prime; sparse secret h=64) holds SEAL's coefficient-domain
dumps of its keys, a fresh ciphertext, its square+relin+rescale and its
rotation by one, extracted from the vendored modified SEAL 3.6.6. The
session takes SEAL's keys into NTT form with the port's own tables, so the
port's evaluator ops run on them and their results compare back in the
coefficient domain. The loader is a copy of tests/test_seal_vectors.py's
(name, ndim, dims and u64 data records). Imports no JAX.
"""

import os
import struct

import numpy as np
import torch

from fhe_gpt2_tpu_torch.core import ntt as nttmod
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Ciphertext, Decryptor, Evaluator
from fhe_gpt2_tpu_torch.core.keys import GaloisKeys, KSwitchKey, SecretKey
from fhe_gpt2_tpu_torch.core.modmath import to_numpy_word, word_tensor

VEC = os.path.join(os.path.dirname(__file__), "data", "seal_vectors.bin")


def load_vectors(path):
    out = {}
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (nl,) = struct.unpack_from("<I", data, off)
        off += 4
        name = data[off:off + nl].decode()
        off += nl
        (nd,) = struct.unpack_from("<I", data, off)
        off += 4
        dims = struct.unpack_from(f"<{nd}Q", data, off)
        off += 8 * nd
        total = int(np.prod(dims))
        arr = np.frombuffer(data, dtype="<u8", count=total, offset=off)
        off += 8 * total
        out[name] = arr.reshape(dims)
    return out


def seal_session(device):
    """(vectors, ctx, evaluator, decryptor, load_ct, L) of SEAL's keys on
    the port, on `device`."""
    v = load_vectors(VEC)
    mods = [int(m) for m in v["moduli_all"]]
    params = CkksParams(n=8192, moduli=tuple(mods[:-1]),
                        special=(mods[-1],), scale=2.0 ** 40,
                        hamming_weight=64, sparse_slots=0)
    ctx = CkksContext(params, device=device)

    def to_ntt(arr, limbs):
        return nttmod.ntt(word_tensor(arr, ctx.device, word=ctx.word),
                          ctx.tables(limbs))

    key_limbs = tuple(range(len(mods)))
    sk = SecretKey(ntt=to_ntt(v["secret"], key_limbs), coeffs=None)

    def load_ksk(prefix):
        D = int(v[f"{prefix}_digits"][0])
        return KSwitchKey(data=torch.stack([
            torch.stack([to_ntt(v[f"{prefix}_d{i}_c{j}"], key_limbs)
                         for j in range(2)]) for i in range(D)]))

    gk = GaloisKeys()
    gk.keys[int(v["galois_elt_step1"][0])] = load_ksk("galois1")
    ev = Evaluator(ctx, relin_key=load_ksk("relin"), galois_keys=gk)
    L = len(mods) - 1

    def load_ct(prefix, limbs):
        cs = torch.stack([to_ntt(v[f"{prefix}_c{j}"], tuple(range(limbs)))
                          for j in range(2)])
        scale = float(np.frombuffer(v[f"{prefix}_scale"].tobytes(),
                                    dtype=np.float64)[0])
        return Ciphertext(cs, scale)

    return v, ctx, ev, Decryptor(ctx, sk), load_ct, L


def to_coeff(ctx, data, limbs):
    return to_numpy_word(nttmod.intt(data.contiguous(),
                                     ctx.tables(tuple(range(limbs)))))
