"""The port's bootstrap (CPU, plain versions) held against the JAX package.

Tolerance: every comparison with the JAX package is exact (``array_equal``
words and equal scales); only the decrypt checks have bounds, those of
tests/test_composite.py's full bootstrap (mean < 5e-4, max < 2e-3). The
JAX side runs its CPU path, whose key-switch and rescale mod-downs are
``_mod_down_core``; with two special primes (and the composite pair) the
float32 overflow estimate sums two terms, so its order cannot differ from
the port's.

Stage by stage: ModRaise on both uint32 chains and prep (ModRaise +
SubSum) here; the first CoeffToSlot factor in tests/test_torch_boot_cts.py,
split and recombine in tests/test_torch_boot_stages.py and the first
SlotToCoeff factor in tests/test_torch_boot_stc.py. The port's whole
bootstrap decrypts within the bounds here; the whole bootstrap against the
JAX package's is marked slow (the JAX package alone takes minutes on a CPU
host, as its own test_composite_full_bootstrap does).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from fhe_gpt2_tpu.boot.bootstrap import _mod_raise_core as j_mod_raise_core
from fhe_gpt2_tpu.boot.bootstrap import _mod_raise_core2 as j_mod_raise_core2
from fhe_gpt2_tpu.core.context import CkksContext as JContext
from fhe_gpt2_tpu.core.context import CkksParams as JParams
from fhe_gpt2_tpu.core.modmath import barrett_ratio, shoup as jshoup

from fhe_gpt2_tpu_torch import carry
from fhe_gpt2_tpu_torch.boot.bootstrap import mod_raise
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Ciphertext

import torch_port_common as common
from torch_port_common import single_torch_thread  # noqa: F401

MEAN_BOUND, MAX_BOUND = 5e-4, 2e-3     # tests/test_composite.py:108-109


@pytest.fixture(scope="module")
def both():
    jctx, jev, jenc, jboot = common.build_reference()
    z, jct = common.entry(jev, jenc, jctx)
    return {"port": common.build_port(), "ref": (jctx, jev, jenc, jboot),
            "z": z, "jct": jct}


def _ref_mod_raise(ctx, data):
    """The JAX package's ModRaise on data[k, base, N], with the constants its
    prep stage builds (fhe_gpt2_tpu/boot/bootstrap.py:268-297)."""
    Q0, L = ctx.q0_int, ctx.L
    t_full = ctx.tables(L)
    q0_img = jnp.asarray(ctx.const_residues(Q0, tuple(range(L))))
    if ctx.base_limbs == 1:
        return j_mod_raise_core(data, ctx.tables((0,)), t_full, q0_img,
                                jnp.asarray(np.array(Q0 >> 1, dtype=ctx.word)))
    q0a, q0b = ctx.moduli[0], ctx.moduli[1]
    inv_a = pow(q0a, -1, q0b)
    w = ctx.word_bits
    consts = (
        np.array(q0a, dtype=np.uint64), np.array(q0b, dtype=ctx.word),
        np.array(inv_a, dtype=ctx.word),
        np.array(jshoup(inv_a, q0b, w), dtype=ctx.word),
        np.array(barrett_ratio(q0b, w)[1], dtype=ctx.word),
        np.array(Q0 >> 1, dtype=np.uint64),
        np.array([[q] for q in ctx.moduli[:L]], dtype=np.uint64),
        np.array([[barrett_ratio(q, 64)[1]] for q in ctx.moduli[:L]],
                 dtype=np.uint64))
    return j_mod_raise_core2(data, ctx.tables((0, 1)), t_full, q0_img, consts)


@pytest.mark.parametrize("chain", ["single", "composite"])
def test_mod_raise_equals_reference(chain):
    """ModRaise of random base-level residues [2, base, N] at logN=11."""
    if chain == "single":
        kw = dict(logn=11, log_q0=29, log_scale=25, num_levels=4,
                  log_special=31, num_special=2, hamming_weight=16)
        jp, p = JParams.create(**kw), CkksParams.create(**kw)
    else:
        kw = dict(logn=11, num_levels=3, num_special=2, hamming_weight=16)
        jp, p = JParams.create_composite(**kw), CkksParams.create_composite(**kw)
    jctx, ctx = JContext(jp), CkksContext(p, device=common.CPU)
    rng = np.random.default_rng(11)
    data = np.stack([np.stack([rng.integers(0, q, ctx.n).astype(np.uint32)
                               for q in ctx.moduli[:ctx.base_limbs]])
                     for _ in range(2)])
    want = np.asarray(_ref_mod_raise(jctx, jnp.asarray(data)))
    got = mod_raise(ctx, carry.ciphertext_from_reference(data, 1.0,
                                                         common.CPU))
    assert got.scale == float(jctx.q0_int)
    assert np.array_equal(carry.to_numpy(got), want)


def test_bootstrap_tables_equal_reference(both):
    """Plans, required steps and the EvalMod plans the two packages build."""
    jboot = both["ref"][3]
    boot = both["port"][4]
    assert boot.required_steps() == jboot.required_steps()
    assert boot.subsum_steps == jboot.subsum_steps
    for p, jp in zip(boot.cts_plans + boot.stc_plans,
                     jboot.cts_plans + jboot.stc_plans):
        assert p.giant == jp.giant and p.baby_amounts == jp.baby_amounts
        assert sorted(p.groups) == sorted(jp.groups)
        for jg, per_dst in jp.groups.items():
            for dst, terms in per_dst.items():
                mine = p.groups[jg][dst]
                assert [(i, s) for i, s, _ in mine] == \
                    [(i, s) for i, s, _ in terms]
                for (_, _, m), (_, _, jm) in zip(mine, terms):
                    assert np.array_equal(m, jm)
    for plan, jplan in ((boot.em.cos_plan, jboot.em.cos_plan),
                        (boot.em.arcsin_plan, jboot.em.arcsin_plan)):
        assert np.array_equal(plan.coeffs, jplan.coeffs)
        assert (plan.lo, plan.hi, plan.k, plan.giants) == \
            (jplan.lo, jplan.hi, jplan.k, jplan.giants)


@pytest.mark.parametrize("name", ["prep"])
def test_stage_equals_reference(both, name):
    """The stage function of each package on the same carried ciphertext,
    the normalised entry (the first CoeffToSlot factor:
    tests/test_torch_boot_cts.py)."""
    jboot = both["ref"][3]
    boot = both["port"][4]
    jfns, fns = common.stage_fns(jboot), common.stage_fns(boot)
    jx = jboot._normalize_entry(both["jct"])
    common.assert_same(boot._normalize_entry(common.to_port(both["jct"])),
                       jx, "normalize")
    [ref] = jfns[name]([jx])
    [got] = fns[name]([common.to_port(jx)])
    common.assert_same(got, ref, name)


def test_port_bootstrap_decrypts_within_bounds(both):
    """The port's whole bootstrap, from its own encryption of the same
    values: back up the chain and within the composite bounds."""
    ctx, ev, enc, dec, boot = both["port"]
    z = both["z"]
    ct = enc.encrypt(ev.make_plain(z, ctx.params.scale, ctx.base_limbs))
    out = boot.bootstrap(ct)
    assert [name for name, _ in boot.stages()] == [
        "prep", "cts0", "cts1", "split", "evalmod", "recombine", "stc0",
        "stc1"]
    assert out.level >= ctx.base_limbs + 2 * ctx.rescale_limbs, out.level
    assert out.scale == ct.scale and out.batch == ()
    err = np.abs(np.real(dec.decrypt(out, num_slots=common.NS)) - z)
    assert err.mean() < MEAN_BOUND, err.mean()
    assert err.max() < MAX_BOUND, err.max()


@pytest.mark.slow
def test_whole_bootstrap_equals_reference(both):
    """The whole bootstrap of one carried ciphertext, word for word."""
    jboot = both["ref"][3]
    boot = both["port"][4]
    ref = jboot.bootstrap(both["jct"])
    got = boot.bootstrap(common.to_port(both["jct"]))
    assert isinstance(got, Ciphertext)
    common.assert_same(got, ref, "bootstrap")
