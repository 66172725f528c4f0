#!/usr/bin/env python3
"""Rate of the wire format's zlib level 6 on one key frame's residues.

    python3 tools/zlib_rate.py [--threads 8]

Makes the payload of one Galois-key frame of the served ResNet-20 chain
(5 digits x 2 x 96 key limbs x 32768 words, uniform residues below each
key limb's modulus, from numpy seed 0) and times zlib level 6 on it, as
``net/serialize.py`` compresses it: the native runtime's compress and
decompress on one thread, the zlib module's compress on one thread, and
``--threads`` native compressions of the same payload at once (ctypes
releases the interpreter lock). Needs no card. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=8)
    a = ap.parse_args()

    from fhe_gpt2_tpu_torch.core.context import CkksParams
    from fhe_gpt2_tpu_torch.runtime import native

    if not native.available():
        raise SystemExit("zlib_rate: the native runtime does not build or "
                         "load here")
    p = CkksParams.create_composite(logn=15, num_levels=39, log_scale=54,
                                    log_q0=59, log_special=31,
                                    num_special=16, hamming_weight=192)
    mods = list(p.moduli) + list(p.special)
    rng = np.random.default_rng(0)
    payload = np.stack([np.stack([rng.integers(0, q, p.n, dtype=np.uint64)
                                  .astype(np.uint32) for q in mods])
                        for _ in range(5 * 2)]).tobytes()
    out = {"bytes": len(payload), "threads": a.threads}

    t0 = time.perf_counter()
    blob = native.compress(payload)
    out["native_compress_mb_s"] = len(payload) / (time.perf_counter() - t0) / 1e6
    out["ratio"] = len(blob) / len(payload)
    t0 = time.perf_counter()
    back = native.decompress(blob, len(payload))
    out["native_decompress_mb_s"] = (len(payload)
                                     / (time.perf_counter() - t0) / 1e6)
    t0 = time.perf_counter()
    same = zlib.compress(payload, 6)
    out["zlib_module_compress_mb_s"] = (len(payload)
                                        / (time.perf_counter() - t0) / 1e6)
    out["same_bytes"] = same == blob and back == payload
    with ThreadPoolExecutor(a.threads) as ex:
        t0 = time.perf_counter()
        blobs = list(ex.map(lambda _: native.compress(payload),
                            range(a.threads)))
        dt = time.perf_counter() - t0
    out["threaded_compress_mb_s"] = a.threads * len(payload) / dt / 1e6
    out["same_bytes"] = out["same_bytes"] and all(b == blob for b in blobs)
    print(json.dumps(out))
    return 0 if out["same_bytes"] else 1


if __name__ == "__main__":
    sys.exit(main())
