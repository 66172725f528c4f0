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
from fhe_gpt2_tpu_torch.core import _cuda, primes, tks, tntt
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


def _forced(logns):
    """(logN, C) for every cluster size the kernels take at each logN, and
    C = None (the size ``cluster_for`` picks)."""
    return [(lg, c) for lg in logns for c in (None, *tntt.cluster_sizes(lg))]


_NTT_TABLES = {}


def _ntt_tables(cuda, logn, limbs=42):
    """NTT tables of `limbs` 25-bit primes at N = 2^logn, made once."""
    if logn not in _NTT_TABLES:
        n = 1 << logn
        _NTT_TABLES[logn] = nttmod.make_ntt_tables(
            primes.gen_primes_balanced(25, limbs, 2 * n), n, cuda)
    return _NTT_TABLES[logn]


# Row counts of the main path: one limb (the rescale's last limb), the
# composite pair, the special limbs [2, 8], the level [22], the rescale's
# [2, 21] as 42 rows; and batched leads.
@pytest.mark.parametrize("logn,cluster", _forced((11, 15, 16)))
@pytest.mark.parametrize("lead,limbs", [((), 1), ((), 2), ((), 16), ((), 22),
                                        ((), 42), ((2,), 8), ((2, 3), 4)])
def test_ntt_kernels_equal_plain(cuda, logn, cluster, lead, limbs):
    """Forward and inverse at every cluster size, one launch each."""
    t = _ntt_tables(cuda, logn).slice(list(range(limbs)))
    x = _residues(np.random.default_rng(logn + limbs), t.moduli, lead,
                  t.n, cuda)
    want = nttmod._ntt_stages(x, t)
    assert torch.equal(nttmod._intt_stages(want, t), x)
    before = dict(_cuda.LAUNCHES)
    assert torch.equal(tntt.ntt_forward(x, t, cluster=cluster), want)
    assert torch.equal(tntt.ntt_inverse(want, t, cluster=cluster), x)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["ntt_fwd"] == before["ntt_fwd"] + 1
    assert _cuda.LAUNCHES["ntt_inv"] == before["ntt_inv"] + 1
    if cluster is None:
        assert torch.equal(nttmod.ntt(x, t), want)
        assert torch.equal(nttmod.intt(want, t), x)


@pytest.mark.parametrize("logn,cluster", _forced((11, 15, 16)))
@pytest.mark.parametrize("lead,a,limbs", [((2,), 6, 2), ((2,), 7, 1),
                                          ((3, 2), 0, 3), ((2, 1), 5, 3)])
def test_ntt_kernels_read_limb_slices_in_place(cuda, logn, cluster, lead, a,
                                               limbs):
    """The limbs [a, a+L) of a contiguous [..., 8, N] tensor, passed as a
    view, give what the contiguous copy gives."""
    full_t = _ntt_tables(cuda, logn)
    full = _residues(np.random.default_rng(a), full_t.moduli[:8], lead,
                     full_t.n, cuda)
    xs = full[..., a:a + limbs, :]
    assert not xs.is_contiguous()
    t = full_t.slice(list(range(a, a + limbs)))
    got_f = tntt.ntt_forward(xs, t, cluster=cluster)
    got_i = tntt.ntt_inverse(xs, t, cluster=cluster)
    assert got_f.is_contiguous() and got_f.shape == xs.shape
    assert torch.equal(got_f, nttmod._ntt_stages(xs.contiguous(), t))
    assert torch.equal(got_i, nttmod._intt_stages(xs.contiguous(), t))


def test_ntt_wrappers_refuse_other_layouts(cuda):
    """A non-contiguous operand that is no limb slice raises."""
    t = _ntt_tables(cuda, 11).slice([0, 1])
    rng = np.random.default_rng(0)
    x = _residues(rng, t.moduli, (2,), t.n, cuda)
    y = _residues(rng, t.moduli, (3, 2), t.n, cuda)
    for bad in (x.transpose(0, 1), y.transpose(0, 1), x[:1].expand(3, 2, t.n)):
        for fn in (tntt.ntt_forward, tntt.ntt_inverse):
            with pytest.raises(ValueError):
                fn(bad, t)


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
    """One NTT or iNTT call is one device kernel; one fused_switch_key call
    is the iNTT and one kernel, and so is one fused_mod_down call (its
    dropped limbs are read in place, with no copy)."""
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
    last = ctx.tables((level - 1,))
    for fn, want in (
            (lambda: tntt.ntt_forward(c, lt), 1),
            (lambda: tntt.ntt_inverse(c, lt), 1),
            (lambda: tntt.ntt_inverse(x[..., level:, :], sp), 1),
            (lambda: tntt.ntt_inverse(c[..., -1:, :], last), 1),
            (lambda: tks.fused_switch_key(c, kdata, lt, kt, ft), 2),
            (lambda: tks.fused_mod_down(x, sp, ctx.tables(level), fmd), 2)):
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
