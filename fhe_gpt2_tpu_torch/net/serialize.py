"""Serialization for ciphertexts, keys, and parameters.

The port's copy of ``fhe_gpt2_tpu/net/serialize.py``, on the same wire
format: a magic, the lengths, a JSON header and a little-endian payload,
zlib-compressed at level 6 through the native runtime (else the zlib
module). A blob written by either package loads in the other.

The port holds residues as int32 words (uint32 chains) or int64 words (u64
chains). A blob states the JAX package's dtype over the same bytes:
tensors are copied to the host and written as ``"uint32"`` or
``"uint64"``, and a payload is read back into the tensor dtype with the
same bits. A blob with no dtype is ``"uint64"``, as in the JAX loaders.

The loaders take ``device=None``, which the JAX loaders do not: the tensors
go where ``core.context.resolve_device`` says, the card unless the caller
names another device.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np
import torch

from ..core.context import CkksParams, resolve_device
from ..core.evaluator import Ciphertext, expand_uniform
from ..core.keys import GaloisKeys, KSwitchKey
from ..core.modmath import to_numpy_word
from ..runtime import native

MAGIC = b"CKTP"
# Wire dtype -> (numpy word, tensor view of its bits).
_WORDS = {"uint32": (np.uint32, np.int32), "uint64": (np.uint64, np.int64)}


def _compress(b: bytes) -> bytes:
    return native.compress(b) if native.available() else zlib.compress(b)


def _decompress(b: bytes, n: int) -> bytes:
    return native.decompress(b, n) if native.available() else zlib.decompress(b)


def _pack(header: dict, payload: bytes) -> bytes:
    h = json.dumps(header).encode()
    comp = _compress(payload)
    return MAGIC + struct.pack("<III", len(h), len(comp), len(payload)) + h + comp


def _unpack(blob: bytes) -> tuple[dict, bytes]:
    if blob[:4] != MAGIC:
        raise ValueError("bad magic")
    hlen, clen, rlen = struct.unpack("<III", blob[4:16])
    header = json.loads(blob[16:16 + hlen].decode())
    payload = _decompress(blob[16 + hlen:16 + hlen + clen], rlen)
    return header, payload


def _words(t: torch.Tensor) -> tuple[list, bytes, str]:
    """(shape, bytes, wire dtype) of a word tensor: int32 words are written
    as uint32, int64 words as uint64."""
    arr = to_numpy_word(t)
    return list(arr.shape), arr.tobytes(), arr.dtype.name


def _tensor(h: dict, payload: bytes, shape, device) -> torch.Tensor:
    dtype = h.get("dtype", "uint64")
    if dtype not in _WORDS:
        raise ValueError(f"{dtype} residues: a blob holds uint32 or uint64")
    word, signed = _WORDS[dtype]
    arr = np.frombuffer(payload, dtype=word).view(signed)
    return torch.from_numpy(arr.reshape(shape).copy()).to(
        resolve_device(device))


def _expect(h: dict, kind: str) -> None:
    if h["kind"] != kind:
        raise ValueError(f"expected a {kind!r} blob, got {h['kind']!r}")


def dump_ciphertext(ct: Ciphertext) -> bytes:
    shape, data, dtype = _words(ct.data)
    return _pack({"kind": "ct", "scale": ct.scale, "shape": shape,
                  "dtype": dtype}, data)


def load_ciphertext(blob: bytes, device=None) -> Ciphertext:
    h, payload = _unpack(blob)
    _expect(h, "ct")
    return Ciphertext(_tensor(h, payload, h["shape"], device), h["scale"])


def dump_ciphertext_seeded(ct: Ciphertext, seed: bytes) -> bytes:
    """Seeded fresh-ciphertext form (serialization.cpp seeded save): only c0
    travels; c1 is regenerated from the 32-byte SHAKE seed at load. Halves
    the wire size of fresh symmetric ciphertexts (before zlib)."""
    if ct.k != 2:
        raise ValueError("the seeded form is for fresh (k=2) ciphertexts")
    _, data, dtype = _words(ct.data[0])
    return _pack({"kind": "ct_seeded", "scale": ct.scale,
                  "shape": list(ct.data.shape), "dtype": dtype,
                  "seed": seed.hex()}, data)


def load_ciphertext_seeded(blob: bytes, ctx) -> Ciphertext:
    """Onto ctx.device: c0 from the blob, c1 expanded from its seed."""
    h, payload = _unpack(blob)
    _expect(h, "ct_seeded")
    shape = h["shape"]
    c0 = _tensor(h, payload, shape[1:], ctx.device)
    mods = [ctx.all_moduli[i] for i in range(shape[-2])]
    c1 = expand_uniform(bytes.fromhex(h["seed"]), ctx.n, mods, ctx.word)
    c1 = torch.from_numpy(c1.view(_WORDS[c1.dtype.name][1])).to(ctx.device)
    return Ciphertext(torch.stack([c0, c1]), h["scale"])


def dump_kswitch_key(k: KSwitchKey) -> bytes:
    shape, data, dtype = _words(k.data)
    return _pack({"kind": "ksk", "shape": shape, "dtype": dtype}, data)


def load_kswitch_key(blob: bytes, device=None) -> KSwitchKey:
    h, payload = _unpack(blob)
    _expect(h, "ksk")
    return KSwitchKey(_tensor(h, payload, h["shape"], device))


def dump_galois_elt(elt: int, k: KSwitchKey) -> bytes:
    """One Galois key as its own frame (streaming upload granularity)."""
    shape, data, dtype = _words(k.data)
    return _pack({"kind": "gal_elt", "elt": int(elt), "shape": shape,
                  "dtype": dtype}, data)


def load_galois_elt(blob: bytes, device=None) -> tuple[int, KSwitchKey]:
    h, payload = _unpack(blob)
    _expect(h, "gal_elt")
    return h["elt"], KSwitchKey(_tensor(h, payload, h["shape"], device))


def peek_kind(blob: bytes) -> str:
    if blob[:4] != MAGIC:
        raise ValueError("bad magic")
    hlen, _, _ = struct.unpack("<III", blob[4:16])
    return json.loads(blob[16:16 + hlen].decode())["kind"]


def dump_galois_keys(gk: GaloisKeys) -> bytes:
    elts = sorted(gk.keys)
    blobs = [dump_kswitch_key(gk.keys[e]) for e in elts]
    header = {"kind": "galois", "elts": elts, "sizes": [len(b) for b in blobs]}
    return _pack(header, b"".join(blobs))


def load_galois_keys(blob: bytes, device=None) -> GaloisKeys:
    h, payload = _unpack(blob)
    _expect(h, "galois")
    gk = GaloisKeys()
    off = 0
    for e, sz in zip(h["elts"], h["sizes"]):
        gk.keys[e] = load_kswitch_key(payload[off:off + sz], device)
        off += sz
    return gk


def dump_params(p: CkksParams) -> bytes:
    return _pack({"kind": "params", "n": p.n, "moduli": list(p.moduli),
                  "special": list(p.special), "scale": p.scale,
                  "hamming_weight": p.hamming_weight,
                  "sparse_slots": p.sparse_slots,
                  "rescale_limbs": p.rescale_limbs,
                  "base_limbs": p.base_limbs}, b"")


def load_params(blob: bytes) -> CkksParams:
    h, _ = _unpack(blob)
    _expect(h, "params")
    return CkksParams(n=h["n"], moduli=tuple(h["moduli"]),
                      special=tuple(h["special"]), scale=h["scale"],
                      hamming_weight=h["hamming_weight"],
                      sparse_slots=h["sparse_slots"],
                      rescale_limbs=h.get("rescale_limbs", 1),
                      base_limbs=h.get("base_limbs", 1))
