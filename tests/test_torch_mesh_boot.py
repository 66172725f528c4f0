"""A full bootstrap of a 2-ciphertext batch on the port's (data=2 x
limb=2) mesh of CPU devices, one CkksBackend and Bootstrapper per position,
against the JAX package under its own mesh: tests/test_mesh.py's
test_sharded_bootstrap_bitwise, ``slow`` as it is (the JAX bootstrap takes
minutes on a CPU host)."""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from fhe_gpt2_tpu.boot.bootstrap import Bootstrapper as JBootstrapper
from fhe_gpt2_tpu.boot.bootstrap import make_evalmod as jmake_evalmod
from fhe_gpt2_tpu.core.context import CkksContext as JContext
from fhe_gpt2_tpu.core.context import CkksParams as JParams
from fhe_gpt2_tpu.core.evaluator import Ciphertext as JCiphertext
from fhe_gpt2_tpu.core.evaluator import Encryptor as JEncryptor
from fhe_gpt2_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_gpt2_tpu.core.evaluator import stack_cts as jstack_cts
from fhe_gpt2_tpu.core.keys import KeyGenerator as JKeyGenerator
from fhe_gpt2_tpu.nn.backend import CkksBackend as JCkksBackend
from fhe_gpt2_tpu.parallel.mesh import make_mesh as jmake_mesh

from fhe_gpt2_tpu_torch import carry
from fhe_gpt2_tpu_torch.boot.bootstrap import Bootstrapper, make_evalmod
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Ciphertext, Decryptor, \
    Evaluator
from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
from fhe_gpt2_tpu_torch.parallel.mesh import MeshEvaluator, \
    gather_ciphertext, make_mesh, shard_ciphertext

from torch_mesh_common import DEVICES, carry_keys
from torch_port_common import CPU, ref_plain, single_torch_thread  # noqa: F401

NS = 64
PARAMS = dict(logn=10, log_q0=45, log_scale=40, num_levels=22,
              log_special=51, hamming_weight=16, sparse_slots=NS)
EVALMOD = dict(K=12, eps=2 ** -5, degree=45, arcsin_degree=3, prec_dps=60)


@pytest.mark.slow
def test_sharded_bootstrap_bitwise():
    """Entry at level 1 (one limb, so one limb position holds none);
    ModRaise re-expands to the full chain on each position's limbs. The
    gathered words equal the JAX package's under its mesh, and the first
    slot vector decrypts within tests/test_mesh.py's bound."""
    jctx = JContext(JParams.create(**PARAMS))
    kg = JKeyGenerator(jctx, seed=3)
    enc = JEncryptor(jctx, secret=kg.secret, seed=4)
    jev = JEvaluator(jctx, relin_key=kg.relin_key())
    jB = JCkksBackend(ctx=jctx, ev=jev, enc=enc, dec=None, default_level=22)
    jboot = JBootstrapper(jB, num_slots=NS, evalmod=jmake_evalmod(**EVALMOD))
    jev.galois_keys = kg.galois_keys(steps=jboot.required_steps(),
                                     conjugate=True)
    zs = np.random.default_rng(5).uniform(-1, 1, (2, NS))
    jct = jstack_cts([enc.encrypt(ref_plain(jctx, z, jctx.params.scale,
                                            range(1))) for z in zs])
    jmesh = jmake_mesh(n_data=2, n_limb=2)
    sct = JCiphertext(jax.device_put(
        jct.data, NamedSharding(jmesh, P(None, "data", None, None))),
        jct.scale)
    with jmesh:
        jout = jboot.bootstrap(sct)
        jax.block_until_ready(jout.data)
    want = np.asarray(jout.data)

    ctx = CkksContext(CkksParams.create(**PARAMS), device=CPU)
    relin, gk = carry_keys(jev.relin_key, jev.galois_keys)
    ev = Evaluator(ctx, relin_key=relin, galois_keys=gk)
    boot = Bootstrapper(CkksBackend(ctx=ctx, ev=ev, default_level=22),
                        num_slots=NS, evalmod=make_evalmod(**EVALMOD))
    assert boot.required_steps() == jboot.required_steps()
    mesh = make_mesh(2, 2, DEVICES)
    mev = MeshEvaluator(mesh, ctx, relin_key=relin, galois_keys=gk)
    ct = carry.ciphertext_from_reference(np.asarray(jct.data), jct.scale, CPU)
    out = gather_ciphertext(mev.run(
        lambda b, c: b.bootstrap(c), shard_ciphertext(ct, mesh),
        on=[boot.on(CkksBackend(ctx=e.ctx, ev=e, default_level=22))
            for e in mev.evaluators]))
    assert out.scale == jout.scale
    assert np.array_equal(carry.to_numpy(out), want), \
        "sharded bootstrap differs"
    dec = Decryptor(ctx, carry.secret_from_reference(
        np.asarray(kg.secret.ntt), kg.secret.coeffs, CPU))
    back = np.real(dec.decrypt(Ciphertext(out.data[:, 0], out.scale),
                               num_slots=NS))
    assert np.abs(back - zs[0]).mean() < 1e-2
