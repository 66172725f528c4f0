"""Shared set-up of the port's network tests (tests/test_torch_net.py,
tests/test_torch_service.py).

``build`` makes both packages on one chain: by default a uint32 chain
(logN=9, three scale primes, the shape of the chain tests/test_net.py runs
on the JAX package's u64 engine), or ``U64_CHAIN``, that u64 chain itself:
the JAX context, keys (seed 2: relinearization and the Galois keys of
``steps``), encryptor (seed 3), decryptor and backend, and the port's
context, evaluator, decryptor and backend on the CPU over the same keys,
carried across. Both backends are a server's: no encryptor and no
decryptor, so nothing refreshes by decrypting. The JAX evaluator encodes
through ``torch_port_common.fast_encoding``.
"""

import numpy as np

from fhe_gpt2_tpu.core.evaluator import Decryptor as JDecryptor
from torch_port_common import (CPU, JCkksBackend, JContext, JEncryptor,
                               JEvaluator, JKeyGenerator, JParams,
                               CkksBackend, CkksContext, CkksParams,
                               Decryptor, Evaluator, carry, fast_encoding,
                               ref_plain)

CHAIN = dict(logn=9, log_q0=29, log_scale=25, num_levels=3, log_special=31,
             num_special=2, hamming_weight=16)
# tests/test_net.py's own chain, on the u64 engine (tests/test_torch_u64_net.py).
U64_CHAIN = dict(logn=9, log_q0=50, log_scale=40, num_levels=3,
                 log_special=51, hamming_weight=16)


def build(steps=(1,), chain=CHAIN):
    jp = JParams.create(**chain)
    jctx = JContext(jp)
    kg = JKeyGenerator(jctx, seed=2)
    jev = fast_encoding(JEvaluator(jctx, relin_key=kg.relin_key(),
                                   galois_keys=kg.galois_keys(list(steps))))
    jenc = JEncryptor(jctx, secret=kg.secret, seed=3)
    jdec = JDecryptor(jctx, kg.secret)
    jB = JCkksBackend(ctx=jctx, ev=jev)
    ctx = CkksContext(CkksParams.create(**chain), device=CPU)
    ev = Evaluator(
        ctx,
        relin_key=carry.kswitch_key_from_reference(
            np.asarray(jev.relin_key.data), CPU),
        galois_keys=carry.galois_keys_from_reference(
            {e: np.asarray(k.data) for e, k in jev.galois_keys.keys.items()},
            CPU))
    secret = carry.secret_from_reference(np.asarray(kg.secret.ntt),
                                         np.asarray(kg.secret.coeffs), CPU)
    dec = Decryptor(ctx, secret)
    B = CkksBackend(ctx=ctx, ev=ev)
    return dict(jp=jp, jctx=jctx, kg=kg, jev=jev, jenc=jenc, jdec=jdec,
                jB=jB, p=ctx.params, ctx=ctx, ev=ev, dec=dec, B=B,
                secret=secret)


def encrypt(s, values, level=None):
    """A JAX encryption of slot values at ``level`` (default: the top)."""
    jctx = s["jctx"]
    return s["jenc"].encrypt(ref_plain(jctx, values, jctx.params.scale,
                                       range(level or jctx.L)))
