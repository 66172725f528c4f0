"""Shared set-up of the port's mesh tests (tests/test_torch_mesh*.py).

``mesh_pair`` builds tests/test_mesh.py's ``setup`` on both packages: the
logN=9 chain of 6 levels (q0 of 50 bits, 40-bit scale primes, one 51-bit
special prime, so the u64 engine), JAX keys from seed 7 (relinearization,
Galois steps 1 and 3) carried into the port with ``carry.py``, and a batch
of 4 ciphertexts of seed-9 slots at level 6 that the JAX package encrypts
(seed 8) and the port carries. The JAX mesh splits a sharded axis evenly,
so the batch and the limbs are multiples of the mesh's axes. ``jax_on_mesh`` runs a JAX step as tests/test_mesh.py
does, under the JAX package's ``make_mesh``/``shard_ciphertext``;
``port_on_mesh`` runs a port step on a mesh of repeated CPU devices through
``MeshEvaluator`` and gathers it.
"""

import jax
import numpy as np
import torch

from fhe_gpt2_tpu.core.context import CkksContext as JContext
from fhe_gpt2_tpu.core.context import CkksParams as JParams
from fhe_gpt2_tpu.core.evaluator import Decryptor as JDecryptor
from fhe_gpt2_tpu.core.evaluator import Encryptor as JEncryptor
from fhe_gpt2_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_gpt2_tpu.core.evaluator import stack_cts as jstack_cts
from fhe_gpt2_tpu.core.keys import KeyGenerator as JKeyGenerator
from fhe_gpt2_tpu.parallel.mesh import make_mesh as jmake_mesh
from fhe_gpt2_tpu.parallel.mesh import shard_ciphertext as jshard_ciphertext

from fhe_gpt2_tpu_torch import carry
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Evaluator
from fhe_gpt2_tpu_torch.parallel.mesh import MeshEvaluator, \
    gather_ciphertext, make_mesh, shard_ciphertext

from torch_port_common import CPU, ref_plain

LOGN = 9
LEVELS = 6
N_BATCH = 4
DEVICES = [torch.device(CPU)] * 8


def carry_keys(relin, gk):
    """The port's copies of JAX relinearization and Galois keys."""
    return (relin and carry.kswitch_key_from_reference(np.asarray(relin.data),
                                                       CPU),
            gk and carry.galois_keys_from_reference(
                {e: np.asarray(k.data) for e, k in gk.keys.items()}, CPU))


def mesh_pair(params_kw=None, composite=False, steps=(1, 3),
              n_batch=N_BATCH, level=None):
    """Both packages on one chain (tests/test_mesh.py's ``setup`` by
    default; ``create_composite(**params_kw)`` where composite):
    {"ref": JAX objects, "got": the port's}, each with ctx, ev
    (relinearization and Galois `steps` keys), dec, kg (JAX) and ct (a
    batch of n_batch ciphertexts at `level`, default the chain top), and
    "zs", the slot values."""
    kw = params_kw or dict(logn=LOGN, log_q0=50, log_scale=40,
                           num_levels=LEVELS, log_special=51,
                           hamming_weight=32)
    jctx = JContext((JParams.create_composite if composite
                     else JParams.create)(**kw))
    kg = JKeyGenerator(jctx, seed=7)
    relin, gk = kg.relin_key(), kg.galois_keys(steps=list(steps))
    jev = JEvaluator(jctx, relin_key=relin, galois_keys=gk)
    enc = JEncryptor(jctx, secret=kg.secret, seed=8)
    level = level or jctx.L
    rng = np.random.default_rng(9)
    zs = rng.uniform(-1, 1, (n_batch, jctx.params.slots))
    jct = jstack_cts([enc.encrypt(ref_plain(jctx, z, jctx.params.scale,
                                            range(level))) for z in zs])
    ctx = CkksContext((CkksParams.create_composite if composite
                       else CkksParams.create)(**kw), device=CPU)
    prelin, pgk = carry_keys(relin, gk)
    secret = carry.secret_from_reference(np.asarray(kg.secret.ntt),
                                         kg.secret.coeffs, CPU)
    return {"zs": zs,
            "ref": dict(ctx=jctx, ev=jev, kg=kg, dec=JDecryptor(jctx, kg.secret),
                        ct=jct),
            "got": dict(ctx=ctx, ev=Evaluator(ctx, relin_key=prelin,
                                              galois_keys=pgk),
                        dec=Decryptor(ctx, secret),
                        ct=carry.ciphertext_from_reference(
                            np.asarray(jct.data), jct.scale, CPU))}


def jax_on_mesh(step, jct, n_data, n_limb) -> np.ndarray:
    """tests/test_mesh.py's run: jit(step) of the ciphertext words placed
    by the JAX package's shard_ciphertext on its (data, limb) mesh."""
    mesh = jmake_mesh(n_data=n_data, n_limb=n_limb)
    sct = jshard_ciphertext(jct, mesh)
    with mesh:
        got = jax.jit(step)(sct.data)
        jax.block_until_ready(got)
    return np.asarray(got)


def port_on_mesh(step, ev, ct, n_data, n_limb, on=None):
    """The port's step(ev, ct) (or step(on[i], ct)) on a (data, limb) mesh
    of repeated CPU devices, gathered."""
    mesh = make_mesh(n_data, n_limb, DEVICES)
    mev = MeshEvaluator(mesh, ev.ctx, relin_key=ev.relin_key,
                        galois_keys=ev.galois_keys)
    out = mev.run(step, shard_ciphertext(ct, mesh),
                  on=on(mev) if on else None)
    return gather_ciphertext(out)
