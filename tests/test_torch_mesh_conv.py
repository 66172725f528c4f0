"""An encrypted conv2d LT (the CNN hot layer) on the port's (data=4 x
limb=2) mesh of CPU devices, one CkksBackend per position, against the
JAX package under its own mesh: tests/test_mesh.py's
test_sharded_conv_layer_bitwise."""

import numpy as np
import pytest

from fhe_gpt2_tpu.cnn.conv import PlanarLayout as JPlanarLayout
from fhe_gpt2_tpu.cnn.conv import conv2d_spec as jconv2d_spec
from fhe_gpt2_tpu.core.evaluator import Ciphertext as JCiphertext
from fhe_gpt2_tpu.core.keys import KeyGenerator as JKeyGenerator
from fhe_gpt2_tpu.nn.backend import CkksBackend as JCkksBackend
from fhe_gpt2_tpu.nn.backend import RecordingBackend as JRecordingBackend
from fhe_gpt2_tpu.nn.linear import apply_lt as japply_lt

from fhe_gpt2_tpu_torch import carry
from fhe_gpt2_tpu_torch.cnn.conv import PlanarLayout, conv2d_spec
from fhe_gpt2_tpu_torch.core.evaluator import Evaluator
from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
from fhe_gpt2_tpu_torch.nn.linear import apply_lt

from torch_mesh_common import LEVELS, carry_keys, jax_on_mesh, mesh_pair, \
    port_on_mesh
from torch_port_common import single_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    return mesh_pair(level=LEVELS)


def test_sharded_conv_layer_bitwise(setup):
    """conv2d (3 -> 4 channels, 8x8, 3x3) over a 4-image ciphertext batch:
    the gathered words equal the JAX package's under its mesh."""
    ref, got = setup["ref"], setup["got"]
    jctx, slots = ref["ctx"], ref["ctx"].params.slots
    w = np.random.default_rng(11).standard_normal((4, 3, 3, 3)) * 0.2
    jplan = jconv2d_spec(w, JPlanarLayout(3, 8, 8, slots),
                         JPlanarLayout(4, 8, 8, slots), 1,
                         name="meshconv").bsgs_plan()
    plan = conv2d_spec(w, PlanarLayout(3, 8, 8, slots),
                       PlanarLayout(4, 8, 8, slots), 1,
                       name="meshconv").bsgs_plan()
    rec = JRecordingBackend(slots)
    japply_lt(rec, jplan, [np.zeros(slots)])
    gk = JKeyGenerator(jctx, seed=7).galois_keys(
        steps=sorted(set(rec.key_steps()) | {1, 3}), conjugate=True)
    jev = ref["ev"].__class__(jctx, relin_key=ref["ev"].relin_key,
                              galois_keys=gk)
    jB = JCkksBackend(ctx=jctx, ev=jev, dec=ref["dec"], default_level=LEVELS)
    scale = ref["ct"].scale

    def jstep(data):
        [y] = japply_lt(jB, jplan, [JCiphertext(data, scale)])
        return y.data

    want = jax_on_mesh(jstep, ref["ct"], 4, 2)
    _, pgk = carry_keys(None, gk)
    ev = Evaluator(got["ctx"], relin_key=got["ev"].relin_key, galois_keys=pgk)
    out = port_on_mesh(
        lambda B, c: apply_lt(B, plan, [c])[0], ev, got["ct"], 4, 2,
        on=lambda mev: [CkksBackend(ctx=e.ctx, ev=e, default_level=LEVELS)
                        for e in mev.evaluators])
    assert np.array_equal(carry.to_numpy(out), want), "sharded conv differs"
