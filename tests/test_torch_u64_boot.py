"""The port's bootstrap on the u64 engine (int64 words, CPU) held against
the JAX package's u64 bootstrap, at tests/test_bootstrap.py::
test_full_bootstrap's parameters (logN=10, 22 levels, q0 of 45 bits,
Δ=2^40, h=16, 64 sparse slots; EvalMod K=12 / degree 45 from each
package's cache; tests/torch_u64_common.py).

Exact (``array_equal`` words, equal scales): the plans, ModRaise (the
single-base ``_mod_raise_core``), prep and the first CoeffToSlot factor,
each on the same carried ciphertext (EvalMod, in two halves:
tests/test_torch_u64_boot_evalmod*.py). The JAX side's mod-downs sum one
float32 term (one special prime), so their order cannot differ. The
port's whole bootstrap decrypts within test_full_bootstrap's bounds (mean
< 1e-2, max < 5e-2, output level >= 4); the whole bootstrap against the
JAX package's is slow (the JAX bootstrap alone takes minutes on a CPU
host).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fhe_gpt2_tpu_torch import carry
from fhe_gpt2_tpu_torch.boot.bootstrap import mod_raise

import test_torch_boot as TB
import torch_port_common as common
from torch_port_common import single_torch_thread  # noqa: F401
from torch_u64_common import BOOT_NS, build_boot

MEAN_BOUND, MAX_BOUND = 1e-2, 5e-2      # tests/test_bootstrap.py:72-73


@pytest.fixture(scope="module")
def both():
    ref, got = build_boot("ref"), build_boot("got")
    jctx, jev, jenc = ref[:3]
    z = np.random.default_rng(5).uniform(-1, 1, BOOT_NS)
    jct = jenc.encrypt(common.ref_plain(jctx, z, jctx.params.scale,
                                        range(1)))
    return {"ref": ref, "port": got, "z": z, "jct": jct}


def test_u64_bootstrap_plans_equal_reference(both):
    jboot, boot = both["ref"][4], both["port"][4]
    assert boot.ctx.dtype == torch.int64
    assert boot.required_steps() == jboot.required_steps()
    for plan, jplan in ((boot.em.cos_plan, jboot.em.cos_plan),
                        (boot.em.arcsin_plan, jboot.em.arcsin_plan)):
        assert np.array_equal(plan.coeffs, jplan.coeffs)


def test_u64_mod_raise_equals_reference(both):
    """ModRaise of random residues mod q0 [2, 1, N] (uint64)."""
    jctx, ctx = both["ref"][0], both["port"][0]
    rng = np.random.default_rng(11)
    data = rng.integers(0, ctx.moduli[0], (2, 1, ctx.n), dtype=np.uint64)
    want = np.asarray(TB._ref_mod_raise(jctx, jnp.asarray(data)))
    got = mod_raise(ctx, carry.ciphertext_from_reference(data, 1.0,
                                                         common.CPU))
    assert got.data.dtype == torch.int64
    assert got.scale == float(jctx.q0_int)
    assert np.array_equal(carry.to_numpy(got), want)


@pytest.mark.parametrize("name", ["prep", "cts0"])
def test_u64_stage_equals_reference(both, name):
    """prep on the normalised entry; the first CoeffToSlot factor on a
    fresh encryption at the full chain."""
    jctx, jenc, jboot = both["ref"][0], both["ref"][2], both["ref"][4]
    boot = both["port"][4]
    if name == "prep":
        jx = jboot._normalize_entry(both["jct"])
        common.assert_same(boot._normalize_entry(common.to_port(
            both["jct"])), jx, "normalize")
    else:
        jx = common.stage_input(jctx, jenc, jctx.L)
    [ref] = common.stage_fns(jboot)[name]([jx])
    [got] = common.stage_fns(boot)[name]([common.to_port(jx)])
    common.assert_same(got, ref, name)


def test_u64_port_bootstrap_decrypts_within_bounds(both):
    """The port's whole u64 bootstrap from its own encryption: the
    exhausted chain back up to level >= 4, within test_full_bootstrap's
    bounds."""
    ctx, ev, enc, dec, boot = both["port"]
    z = both["z"]
    ct = enc.encrypt(ev.make_plain(z, ctx.params.scale, 1))
    assert ct.level == 1 and ct.data.dtype == torch.int64
    out = boot.bootstrap(ct)
    assert out.level >= 4, out.level
    err = np.abs(np.real(dec.decrypt(out, num_slots=BOOT_NS)) - z)
    assert err.mean() < MEAN_BOUND, err.mean()
    assert err.max() < MAX_BOUND, err.max()


@pytest.mark.slow
def test_u64_whole_bootstrap_equals_reference(both):
    """The whole u64 bootstrap of one carried ciphertext, word for word."""
    ref = both["ref"][4].bootstrap(both["jct"])
    got = both["port"][4].bootstrap(common.to_port(both["jct"]))
    common.assert_same(got, ref, "bootstrap")
