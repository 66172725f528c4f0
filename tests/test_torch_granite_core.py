"""The port's encrypted Mamba-2 mixer core (nn/mamba.py on the CkksBackend)
held against the float64 reference (``reference/granite.mixer_core``) at a
small width, from in_proj's outputs of a seeded layer 0.

Tolerances (answers of magnitude ~4): the plain simulator within 5e-8 and
the encrypted run within 1e-7. The gap is the program's approximations:
SiLU and softplus fits of error ~7e-10, carried through the SSD sum's
weights (C·B·dt up to ~10) and the gated norm's 1/rms, and the Newton
rsqrt (4.1e-9 seen); the encrypted run adds CKKS noise at Δ ≈ 2^54 (under
1e-10 here). SiLU and softplus at degree 24
(errors 1.4e-4 and 1.4e-5) fail the first bound by far.
"""

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu_torch.nn import granite as G
from fhe_gpt2_tpu_torch.nn import mamba as Mb
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend, RecordingBackend
from fhe_gpt2_tpu_torch.reference import granite as R

from torch_granite_common import CFG, SEQ, SLOTS, backend, case, \
    decrypt_all, two_torch_threads  # noqa: F401

PLAIN_TOL = 5e-8
ENC_TOL = 1e-7


@pytest.fixture(scope="module")
def core():
    """(shapes, a function making plans, packed inputs, the reference's
    answer)."""
    w, x = case(0)
    cal = G.calibrate(w, CFG, x, layers=[0])
    sh = G.mamba_shapes(CFG, SLOTS, SEQ)
    u = R.rms_norm(torch.as_tensor(x), R.weight(
        w, "layers.0.input_layernorm.weight"), CFG["rms_norm_eps"])
    proj = u @ R.weight(w, "layers.0.mamba.in_proj.weight").T
    ins = [t.numpy() for t in R.split_in_proj(proj, CFG)]
    p = {k: R.weight(w, "layers.0.mamba." + k) for k in (
        "conv1d.weight", "conv1d.bias", "dt_bias", "A_log", "D",
        "norm.weight")}
    want = R.mixer_core(*ins, p, CFG).numpy()

    def plans(**kw):
        return G.build_core_plans(sh, w, 0, CFG, cal.gate[0], **kw)
    return sh, plans, Mb.pack_core_inputs(sh, *ins), want


def run_plain(B, sh, mp, packed):
    out = Mb.mixer_core(B, *(B.from_slots(v) for v in packed), sh, mp)
    return Mb.unpack_groups(sh, np.asarray(out), sh.z_groups)


def test_plain(core):
    sh, plans, packed, want = core
    got = run_plain(PlainBackend(SLOTS), sh, plans(), packed)
    assert np.abs(got - want).max() < PLAIN_TOL


def test_lower_degree_fails(core):
    sh, plans, packed, want = core
    got = run_plain(PlainBackend(SLOTS), sh,
                    plans(silu_degree=24, softplus_degree=24), packed)
    assert np.abs(got - want).max() > 10 * PLAIN_TOL


def test_encrypted(core):
    sh, plans, packed, want = core
    mp = plans()
    rec = RecordingBackend(SLOTS)
    run_plain(rec, sh, mp, packed)
    B = backend(rec.key_steps())
    level = G.core_input_level(B)
    assert level == B.ctx.L - B.ctx.rescale_limbs
    out = Mb.mixer_core(B, *(Mb.encrypt_groups(B, v, level)
                             for v in packed), sh, mp)
    got = Mb.unpack_groups(sh, decrypt_all(B, out), sh.z_groups)
    assert np.abs(got - want).max() < ENC_TOL


def test_masks_are_plan_arrays(core):
    """Every mask the core multiplies by is an array of its plans (the
    backend's cache keys masks by identity, so a mask made per call would
    miss on every request)."""
    sh, plans, packed, _ = core
    mp = plans()
    held = {id(v) for v in vars(mp).values() if isinstance(v, np.ndarray)}
    held |= {id(mp.norm.weight)}
    seen = []

    class Watch(PlainBackend):
        def mul_plain(self, a, v, out_scale=None):
            seen.append(id(v))
            return super().mul_plain(a, v, out_scale)

        def add_plain(self, a, v):
            seen.append(id(v))
            return super().add_plain(a, v)

    run_plain(Watch(SLOTS), sh, mp, packed)
    assert seen and set(seen) <= held
