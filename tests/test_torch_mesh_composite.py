"""The composite-scaling chain (pair rescale through the mod-down, uint32
words) on the port's (data=4 x limb=2) mesh of CPU devices, against the
JAX package under its own mesh: tests/test_mesh.py's
test_limb_sharded_composite_engine_bitwise."""

import numpy as np

from fhe_gpt2_tpu.core.evaluator import Ciphertext as JCiphertext

from fhe_gpt2_tpu_torch import carry

from torch_mesh_common import jax_on_mesh, mesh_pair, port_on_mesh
from torch_port_common import single_torch_thread  # noqa: F401


def test_limb_sharded_composite_engine_bitwise():
    """mult+relin+pair-rescale+rotate: the gathered words equal the JAX
    package's under its mesh and the port's single-device run."""
    pair = mesh_pair(dict(logn=9, num_levels=4, log_special=31,
                          num_special=2, hamming_weight=16),
                     composite=True, steps=(1,))
    ref, got = pair["ref"], pair["got"]
    assert got["ctx"].word_bits == 32 and got["ctx"].rescale_limbs == 2
    jev, scale = ref["ev"], ref["ct"].scale

    def jstep(data):
        c = JCiphertext(data, scale)
        return jev.rotate(jev.rescale(jev.multiply(c, c)), 1).data

    def step(ev, c):
        return ev.rotate(ev.rescale(ev.multiply(c, c)), 1)

    want = jax_on_mesh(jstep, ref["ct"], 4, 2)
    out = port_on_mesh(step, got["ev"], got["ct"], 4, 2)
    assert out.level == got["ctx"].L - 2
    assert np.array_equal(carry.to_numpy(out), want)
    assert np.array_equal(carry.to_numpy(out),
                          carry.to_numpy(step(got["ev"], got["ct"])))
