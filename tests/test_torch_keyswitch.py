"""The port's key switch and mod-down (plain versions, CPU) held against the
JAX package: the Pallas kernels in interpret mode and the split XLA cores.

Comparison rules:
  * key switch: ``array_equal`` to ``tks.fused_switch_key(interpret=True)``
    and to ``_decompose_core`` + ``_ks_mac_core`` (all modular ops are
    canonical, so any correct path gives the same words);
  * mod-down vs ``tks.fused_mod_down(interpret=True)``: ``array_equal``,
    since both sum the float32 overflow estimate sequentially, i = 0..k-1;
  * mod-down vs ``_mod_down_core``: the residue rule of
    tests/test_fused_ks.py — equal, or off by exactly one unit of P^-1 mod
    q_j where the float32 estimate sits on a floor boundary, because
    ``_mod_down_core`` sums with ``jnp.sum``.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from fhe_gpt2_tpu.core import tks as jtks
from fhe_gpt2_tpu.core.context import CkksContext as JContext
from fhe_gpt2_tpu.core.context import CkksParams as JParams
from fhe_gpt2_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_gpt2_tpu.core.evaluator import _decompose_core, _ks_mac_core, \
    _mod_down_core
from fhe_gpt2_tpu.core.evaluator import _drop_last_core as _jdrop_last_core
from fhe_gpt2_tpu.core.keys import KeyGenerator as JKeyGenerator
from fhe_gpt2_tpu.core.keys import KSwitchKey as JKSwitchKey

from fhe_gpt2_tpu_torch import carry
from fhe_gpt2_tpu_torch.core import tks
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import _drop_last_core
from fhe_gpt2_tpu_torch.core.modmath import word_tensor

CPU = "cpu"


@pytest.fixture(scope="module", params=["single", "composite"])
def setup(request):
    if request.param == "single":
        kw = dict(logn=11, log_q0=29, log_scale=25, num_levels=3,
                  log_special=31, num_special=2, hamming_weight=16)
        ref_p, got_p = JParams.create(**kw), CkksParams.create(**kw)
    else:
        kw = dict(logn=11, num_levels=1, num_special=2, hamming_weight=16)
        ref_p, got_p = JParams.create_composite(**kw), \
            CkksParams.create_composite(**kw)
    jctx = JContext(ref_p)
    ctx = CkksContext(got_p, device=CPU)
    relin = np.asarray(JKeyGenerator(jctx, seed=3).relin_key().data)
    return jctx, ctx, relin


def _rand(ctx, mods, batch, seed):
    rng = np.random.default_rng(seed)
    m = int(np.prod(batch)) if batch else 1
    x = np.stack([np.stack([rng.integers(0, q, ctx.n).astype(np.uint32)
                            for q in mods]) for _ in range(m)])
    return x.reshape(*batch, len(mods), ctx.n)


@pytest.mark.parametrize("level_from_top,batch", [(0, ()), (2, ()), (1, (2,))])
def test_switch_key_equals_reference(setup, level_from_top, batch):
    jctx, ctx, relin = setup
    level = ctx.L - level_from_top
    c = _rand(ctx, ctx.moduli[:level], batch, seed=level)
    jev = JEvaluator(jctx)
    kt, bcts, own, D = jev._ks_structs(level)
    kd = jev._slice_key(JKSwitchKey(data=jnp.asarray(relin)), level, D)
    split = np.asarray(_ks_mac_core(
        _decompose_core(jnp.asarray(c), kt, jctx.tables(level), bcts, own),
        kd, kt))
    fused = np.asarray(jtks.fused_switch_key(
        jnp.asarray(c), kd, jctx.tables(level), kt,
        jctx.fused_ks_tables(level), interpret=True))
    key = carry.kswitch_key_from_reference(relin, device=CPU)
    ft = ctx.fused_ks_tables(level)
    got = carry.to_numpy(tks.fused_switch_key(
        word_tensor(c, CPU), key.sliced(ctx.key_limbs(level), ft.D),
        ctx.tables(level), ctx.tables(ctx.key_limbs(level)), ft))
    assert got.shape == split.shape == (2, *batch, level + ctx.k_sp, ctx.n)
    assert np.array_equal(got, split)
    assert np.array_equal(got, fused)


def _residue_rule(got, ref, mods, inv_p):
    """Equal, or differing by exactly ±P^-1 mod q_j (one unit)."""
    for row, q in enumerate(mods):
        d = got[..., row, :].astype(np.int64) - ref[..., row, :].astype(np.int64)
        d %= q
        ip = int(inv_p[row, 0])
        assert np.isin(d, [0, ip, q - ip]).all(), row


@pytest.mark.parametrize("which", ["special", "rescale"])
def test_mod_down_equals_reference(setup, which):
    """The key-switch mod-down by P on both chains; the rescale on each
    chain: the composite pair goes through the mod-down kernel, the
    single-prime drop through ``_drop_last_core`` (``array_equal``)."""
    jctx, ctx, _ = setup
    level = ctx.L
    if which == "rescale" and ctx.rescale_limbs == 1:
        x = _rand(ctx, ctx.moduli[:level], (2,), seed=6)
        want = np.asarray(_jdrop_last_core(
            jnp.asarray(x), jctx.tables(level - 1), jctx.tables((level - 1,)),
            jctx.drop_last_tables(level)))
        got = carry.to_numpy(_drop_last_core(
            word_tensor(x, CPU), ctx.tables(level - 1),
            ctx.tables((level - 1,)), ctx.drop_last_tables(level)))
        assert np.array_equal(got, want)
        return
    pair = which == "rescale"
    if pair:
        k = ctx.rescale_limbs
        out_l = level - k
        drop = tuple(range(out_l, level))
        mods = ctx.moduli[:level]
        jmdt, jft = jctx.rescale_pair_tables(level), \
            jctx.fused_md_tables(level, pair=True)
        ft = ctx.fused_md_tables(level, pair=True)
    else:
        out_l = level
        drop = tuple(ctx.L + i for i in range(ctx.k_sp))
        mods = ctx.moduli[:level] + ctx.special
        jmdt, jft = jctx.mod_down_onestep_tables(level), \
            jctx.fused_md_tables(level)
        ft = ctx.fused_md_tables(level)
    x = _rand(ctx, mods, (2,), seed=5)
    core = np.asarray(_mod_down_core(jnp.asarray(x), jctx.tables(drop),
                                     jctx.tables(out_l), jmdt))
    fused = np.asarray(jtks.fused_mod_down(
        jnp.asarray(x), jctx.tables(drop), jctx.tables(out_l), jft,
        interpret=True))
    got = carry.to_numpy(tks.fused_mod_down(
        word_tensor(x, CPU), ctx.tables(drop), ctx.tables(out_l), ft))
    assert got.shape == fused.shape == (2, out_l, ctx.n)
    assert np.array_equal(got, fused)
    _residue_rule(got, core, mods[:out_l], np.asarray(jmdt.inv_p))
