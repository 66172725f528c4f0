"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor fhe_gpt2_tpu, so it runs on a machine that has only PyTorch
(``tests/conftest.py`` configures JAX, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

All comparisons are ``torch.equal``: the kernels and the plain versions
return canonical residues, and the mod-down's float32 estimate is summed in
the same order on both sides.
"""

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu_torch.core import ntt as nttmod
from fhe_gpt2_tpu_torch.core import primes, tks, tntt
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Encryptor, Evaluator
from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
from fhe_gpt2_tpu_torch.core.modmath import word_tensor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _residues(rng, moduli, lead, n, device):
    x = np.stack([rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
                  .astype(np.uint32) for q in moduli], axis=-2)
    return word_tensor(x, device)


@pytest.mark.parametrize("logn", [11, 15, 16])
def test_ntt_kernels_equal_plain(cuda, logn):
    """Forward and inverse over every segment size, which moves the split
    between global-memory stages and shared-memory stages."""
    n = 1 << logn
    mods = primes.gen_primes_balanced(25, 3, 2 * n)
    t = nttmod.make_ntt_tables(mods, n, cuda)
    x = _residues(np.random.default_rng(logn), mods, (2,), n, cuda)
    want = nttmod._ntt_stages(x, t)
    assert torch.equal(nttmod._intt_stages(want, t), x)
    for s in range(1, min(logn, tntt.MAX_SEG_LOG) + 1):
        assert torch.equal(tntt.ntt_forward(x, t, seg_log=s), want), s
        assert torch.equal(tntt.ntt_inverse(want, t, seg_log=s), x), s
    assert torch.equal(nttmod.ntt(x, t), want)
    assert torch.equal(nttmod.intt(want, t), x)


def _ctx(cuda, composite, logn=12):
    if composite:
        p = CkksParams.create_composite(logn=logn, num_levels=2, num_special=3,
                                        hamming_weight=32)
    else:
        p = CkksParams.create(logn=logn, log_q0=29, log_scale=25, num_levels=5,
                              log_special=31, num_special=2, hamming_weight=32)
    return CkksContext(p, device=cuda)


_CTX = {}


def _cached_ctx(cuda, composite, logn):
    if (composite, logn) not in _CTX:
        _CTX[composite, logn] = _ctx(cuda, composite, logn)
    return _CTX[composite, logn]


def _forced(logns):
    """(logN, C) for every cluster size the kernels take at each logN, and
    C = None (the size ``cluster_for`` picks)."""
    return [(lg, c) for lg in logns for c in (None, *tks.cluster_sizes(lg))]


# Levels 1, 3 and 5 end in a narrow digit (alpha = 2); 2 and 4 do not.
@pytest.mark.parametrize("logn,cluster", _forced((11, 15, 16)))
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_keyswitch_kernel_equals_plain(cuda, logn, cluster, level, lead):
    ctx = _cached_ctx(cuda, False, logn)
    ft = ctx.fused_ks_tables(level)
    lt, kt = ctx.tables(level), ctx.tables(ctx.key_limbs(level))
    rng = np.random.default_rng(level)
    c = _residues(rng, ctx.moduli[:level], lead, ctx.n, cuda)
    kdata = _residues(rng, kt.moduli, (2, ft.D), ctx.n, cuda)
    got = tks.fused_switch_key(c, kdata, lt, kt, ft, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(got, tks.switch_key_plain(c, kdata, lt, kt, ft))


@pytest.mark.parametrize("logn,cluster", _forced((11, 15, 16)))
@pytest.mark.parametrize("composite,pair", [(False, False), (True, False),
                                            (True, True)])
@pytest.mark.parametrize("lead", [(), (2,), (3, 2)])
def test_moddown_kernel_equals_plain(cuda, logn, cluster, composite, pair,
                                     lead):
    ctx = _cached_ctx(cuda, composite, logn)
    level = ctx.L
    if pair:
        drop = tuple(range(level - 2, level))
        out_l, mods = level - 2, ctx.moduli[:level]
    else:
        drop = tuple(ctx.L + i for i in range(ctx.k_sp))
        out_l, mods = level, ctx.moduli[:level] + ctx.special
    ft = ctx.fused_md_tables(level, pair=pair)
    x = _residues(np.random.default_rng(5), mods, lead, ctx.n, cuda)
    args = (ctx.tables(drop), ctx.tables(out_l), ft)
    got = tks.fused_mod_down(x, *args, cluster=cluster)
    torch.cuda.synchronize()
    assert got.shape == (*lead, out_l, ctx.n)
    assert torch.equal(got, tks.mod_down_plain(x, *args))


def test_wrappers_launch_one_kernel_after_the_intt(cuda):
    """One fused_switch_key call is the iNTT's launches plus one kernel; one
    fused_mod_down call is a copy, the iNTT's launches and one kernel."""
    from torch.profiler import ProfilerActivity, profile
    ctx = _cached_ctx(cuda, False, 15)
    level = ctx.L
    ft = ctx.fused_ks_tables(level)
    lt, kt = ctx.tables(level), ctx.tables(ctx.key_limbs(level))
    rng = np.random.default_rng(0)
    c = _residues(rng, ctx.moduli[:level], (), ctx.n, cuda)
    kdata = _residues(rng, kt.moduli, (2, ft.D), ctx.n, cuda)
    sp = ctx.tables(tuple(ctx.L + i for i in range(ctx.k_sp)))
    x = _residues(rng, ctx.moduli[:level] + ctx.special, (2,), ctx.n, cuda)
    fmd = ctx.fused_md_tables(level)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count

    def intt_launches(rows):
        return 1 + ctx.logn - tntt.seg_log_for(ctx.logn, rows, sms)

    for fn, want in (
            (lambda: tks.fused_switch_key(c, kdata, lt, kt, ft),
             intt_launches(level) + 1),
            (lambda: tks.fused_mod_down(x, sp, ctx.tables(level), fmd),
             1 + intt_launches(2 * ctx.k_sp) + 1)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = torch.autograd.DeviceType.CUDA
        got = sum(e.count for e in prof.key_averages() if e.device_type == dev)
        assert got == want


@pytest.mark.parametrize("composite", [False, True])
def test_main_path_on_card_equals_cpu(cuda, composite):
    """Keygen, encrypt, multiply+relin, rescale, rotate (two hops) and
    conjugate on the card give the same words as the same calls on the CPU
    (the plain versions), and decrypt within the error budget."""
    outs = {}
    for dev in ("cpu", cuda):
        ctx = _ctx(dev, composite)
        kg = KeyGenerator(ctx, seed=3)
        ev = Evaluator(ctx, relin_key=kg.relin_key(),
                       galois_keys=kg.galois_keys(steps=[1, 2], conjugate=True))
        x = np.random.default_rng(1).uniform(-1, 1, ctx.params.slots)
        ct = Encryptor(ctx, secret=kg.secret, seed=4).encrypt(
            ev.make_plain(x, ctx.params.scale, ctx.L))
        mul = ev.multiply(ct, ct)
        res = {"encrypt": ct, "mul_relin": mul, "rescale": ev.rescale(mul),
               "rotate3": ev.rotate(ct, 3), "conjugate": ev.conjugate(ct)}
        dec = Decryptor(ctx, kg.secret)
        want = {"encrypt": x, "mul_relin": x * x, "rescale": x * x,
                "rotate3": np.roll(x, -3), "conjugate": x}
        # Budget at Δ = 2^25: a key switch adds ~1e-8 of error at Δ = 2^40,
        # so ~3e-4 here (rotate3 decrypts to 1.2e-4 at these seeds).
        for k, v in res.items():
            assert np.max(np.abs(dec.decrypt(v) - want[k])) < 1e-3, k
        outs[str(dev)] = {k: v.data.cpu() for k, v in res.items()}
    for k, v in outs["cpu"].items():
        assert torch.equal(outs["cuda"][k], v), k
