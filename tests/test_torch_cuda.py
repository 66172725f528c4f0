"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor fhe_gpt2_tpu, so it runs on a machine that has only PyTorch
(``tests/conftest.py`` configures JAX, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

All comparisons are ``torch.equal``: the kernels and the plain versions
return canonical residues, and the mod-down's float32 estimate is summed in
the same order on both sides.
"""

import contextlib

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu_torch.core import ntt as nttmod
from fhe_gpt2_tpu_torch.core import _cuda, primes, tdyadic, tks, tntt
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Encryptor, Evaluator
from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
from fhe_gpt2_tpu_torch.core.modmath import word_tensor

pytestmark = pytest.mark.cuda

# The four cluster kernels' launch counts: a run that makes no hoisted key
# product and no masked sum launches no csrc/mac.cu entry, and one with no
# coefficient-wise op no csrc/dyadic.cu entry.
FOUR = ("ntt_fwd", "ntt_inv", "keyswitch", "moddown")


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


# ---------------------------------------------------------------------------
# Hoisted rotations, ModRaise and the bootstrap on the card
# ---------------------------------------------------------------------------

HOIST_KEYS = [1, 2, 5]
HOIST_STEPS = [0, 1, 3, 5]        # 3 = 2 + 1: the multi-hop branches


def _hoist_run(dev, logn, stacked):
    """Keys, a (stacked) ciphertext and the hoisted paths' outputs on one
    device, on a composite chain (6 limbs, 3 special primes)."""
    from fhe_gpt2_tpu_torch.boot.bootstrap import mod_raise
    from fhe_gpt2_tpu_torch.core.evaluator import stack_cts
    ctx = _ctx(dev, True, logn)
    kg = KeyGenerator(ctx, seed=3)
    ev = Evaluator(ctx, relin_key=kg.relin_key(),
                   galois_keys=kg.galois_keys(HOIST_KEYS, conjugate=True))
    enc = Encryptor(ctx, secret=kg.secret, seed=4)
    rng = np.random.default_rng(1)
    xs = [rng.uniform(-1, 1, ctx.params.slots) for _ in range(2)]
    cts = [enc.encrypt(ev.make_plain(x, ctx.params.scale, ctx.L)) for x in xs]
    ct = stack_cts(cts) if stacked else cts[0]
    exts = ev.hoisted_rotations_ext(ct, HOIST_STEPS)
    base = ev.mod_switch_to(ct, ctx.base_limbs)
    out = {"ext": exts,
           "mod_down_ext": [ev.mod_down_ext(e, ct.level, ct.scale).data
                            for e in exts],
           "rotate_hoisted": [r.data for r in ev.rotate_hoisted(ct,
                                                                HOIST_STEPS)],
           "mod_raise": [mod_raise(ctx, base).data]}
    return out, (ctx, kg, ev, ct, xs)


@pytest.mark.parametrize("logn", [11, 15])
@pytest.mark.parametrize("stacked", [False, True])
def test_hoisted_paths_and_mod_raise_on_card_equal_cpu(cuda, logn, stacked):
    """hoisted_rotations_ext, mod_down_ext, rotate_hoisted and ModRaise on
    the card give the CPU route's words; the rotations decrypt."""
    got, (ctx, kg, ev, ct, xs) = _hoist_run(cuda, logn, stacked)
    want, _ = _hoist_run("cpu", logn, stacked)
    for name in want:
        for i, (g, w) in enumerate(zip(got[name], want[name])):
            assert torch.equal(g.cpu(), w), (name, i)
    dec = Decryptor(ctx, kg.secret)
    from fhe_gpt2_tpu_torch.core.evaluator import Ciphertext
    for s, r in zip(HOIST_STEPS, got["rotate_hoisted"]):
        c = Ciphertext(r[:, 0] if stacked else r, ct.scale)
        assert np.max(np.abs(dec.decrypt(c) - np.roll(xs[0], -s))) < 1e-6, s


def test_hoisted_decomposition_runs_on_the_ntt_kernels(cuda):
    """On CUDA tensors the shared decomposition takes one iNTT and one NTT
    kernel launch and no key-switch kernel; the extended-basis rotations
    add two MAC launches each and no other kernel, and each mod_down_ext is
    one mod-down call."""
    ctx = _cached_ctx(cuda, True, 15)
    kg = KeyGenerator(ctx, seed=3)
    ev = Evaluator(ctx, galois_keys=kg.galois_keys([1, 5]))
    ct = Encryptor(ctx, secret=kg.secret, seed=4).encrypt(
        ev.make_plain(np.ones(4), ctx.params.scale, ctx.L))
    torch.cuda.synchronize()
    before = dict(_cuda.LAUNCHES)
    kt, tpoly, D = ev._decompose(ct)
    torch.cuda.synchronize()
    assert tpoly.is_cuda and tpoly.shape == (D, ctx.L + ctx.k_sp, ctx.n)
    d = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
    assert d == {"ntt_fwd": 1, "ntt_inv": 1, "keyswitch": 0, "moddown": 0,
                 "mac": 0, "dyadic": 0}
    before = dict(_cuda.LAUNCHES)
    exts = ev.hoisted_rotations_ext(ct, [1, 5])
    d = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
    # Each rotation: its key product (hoisted_mac) and the lifted c0
    # (add_lifted), both in csrc/mac.cu.
    assert d == {"ntt_fwd": 1, "ntt_inv": 1, "keyswitch": 0, "moddown": 0,
                 "mac": 4, "dyadic": 0}
    before = dict(_cuda.LAUNCHES)
    for e in exts:
        ev.mod_down_ext(e, ct.level, ct.scale)
    d = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
    # Each mod-down call is its iNTT of the special limbs and md_fused.
    assert d == {"ntt_fwd": 0, "ntt_inv": 2, "keyswitch": 0, "moddown": 2,
                 "mac": 0, "dyadic": 0}


def _bootstrap_run(dev):
    """A whole bootstrap at logN=11 (composite, 46 limbs, 64 sparse slots,
    EvalMod K=12 / degree 45 from the port's cache) on one device."""
    from fhe_gpt2_tpu_torch.boot.bootstrap import Bootstrapper, make_evalmod
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
    ns = 64
    params = CkksParams.create_composite(
        logn=11, num_levels=22, log_scale=50, log_q0=55, log_special=31,
        num_special=2, hamming_weight=16, sparse_slots=ns)
    ctx = CkksContext(params, device=dev)
    kg = KeyGenerator(ctx, seed=3)
    ev = Evaluator(ctx, relin_key=kg.relin_key())
    enc = Encryptor(ctx, secret=kg.secret, seed=4)
    B = CkksBackend(ctx=ctx, ev=ev, enc=enc, default_level=ctx.L)
    eps = params.scale / ctx.q0_float
    boot = Bootstrapper(B, num_slots=ns, evalmod=make_evalmod(
        K=12, eps=max(eps * 1.05, 2 ** -5), degree=45, arcsin_degree=3,
        prec_dps=60))
    ev.galois_keys = kg.galois_keys(boot.required_steps(), conjugate=True)
    z = np.random.default_rng(5).uniform(-1, 1, ns)
    ct = enc.encrypt(ev.make_plain(z, params.scale, ctx.base_limbs))
    return boot.bootstrap(ct), z, Decryptor(ctx, kg.secret), ctx


def test_bootstrap_on_card_within_bounds_and_equal_cpu(cuda):
    """Mean < 5e-4, max < 2e-3 (tests/test_composite.py's bounds), back up
    the chain, every kernel launched, and the CPU route's words."""
    _cuda.reset_launches()
    out, z, dec, ctx = _bootstrap_run(cuda)
    torch.cuda.synchronize()
    assert all(v > 0 for v in _cuda.LAUNCHES.values()), _cuda.LAUNCHES
    assert out.level >= ctx.base_limbs + 2 * ctx.rescale_limbs
    err = np.abs(np.real(dec.decrypt(out, num_slots=64)) - z)
    assert err.mean() < 5e-4 and err.max() < 2e-3, (err.mean(), err.max())
    want = _bootstrap_run("cpu")[0]
    assert out.scale == want.scale
    assert torch.equal(out.data.cpu(), want.data)


# ---------------------------------------------------------------------------
# The ResNet slice: its chain's kernel shapes, ReLU and a residual block
# ---------------------------------------------------------------------------

def _resnet_chain(dev, logn):
    """The ResNet run's composite chain: 39 level pairs = 80 limbs and 16
    special primes (5 digits, 96 key limbs at the top)."""
    return CkksContext(CkksParams.create_composite(
        logn=logn, num_levels=39, log_scale=54, log_q0=59, log_special=31,
        num_special=16, hamming_weight=32), device=dev)


@pytest.mark.parametrize("logn,cluster", _forced((11, 15)))
@pytest.mark.parametrize("level", [80, 34, 16])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_keyswitch_kernel_at_16_special_primes_equals_plain(cuda, logn,
                                                           cluster, level,
                                                           lead):
    """The key switch at 80 limbs / 5 digits / 96 key limbs, and lower on
    the chain (3 digits with a narrow last one, 1 digit)."""
    key = ("resnet", logn)
    if key not in _CTX:
        _CTX[key] = _resnet_chain(cuda, logn)
    ctx = _CTX[key]
    ft = ctx.fused_ks_tables(level)
    assert ft.D == -(-level // 16)
    lt, kt = ctx.tables(level), ctx.tables(ctx.key_limbs(level))
    rng = np.random.default_rng(level)
    c = _residues(rng, ctx.moduli[:level], lead, ctx.n, cuda)
    kdata = _residues(rng, kt.moduli, (2, ft.D), ctx.n, cuda)
    got = tks.fused_switch_key(c, kdata, lt, kt, ft, cluster=cluster)
    torch.cuda.synchronize()
    assert got.shape == (2, *lead, level + 16, ctx.n)
    assert torch.equal(got, tks.switch_key_plain(c, kdata, lt, kt, ft))


@pytest.mark.parametrize("logn,cluster", _forced((11, 15)))
@pytest.mark.parametrize("level,pair", [(80, False), (20, False), (80, True),
                                        (6, True)])
@pytest.mark.parametrize("lead", [(2,), (2, 2)])
def test_moddown_kernel_at_16_special_primes_equals_plain(cuda, logn,
                                                         cluster, level, pair,
                                                         lead):
    """The key-switch mod-down with k=16 (its float32 estimate sums 16
    terms) and the pair rescale, on the ResNet chain."""
    key = ("resnet", logn)
    if key not in _CTX:
        _CTX[key] = _resnet_chain(cuda, logn)
    ctx = _CTX[key]
    if pair:
        drop = (level - 2, level - 1)
        out_l, mods = level - 2, ctx.moduli[:level]
    else:
        drop = tuple(ctx.L + i for i in range(ctx.k_sp))
        out_l, mods = level, ctx.moduli[:level] + ctx.special
    ft = ctx.fused_md_tables(level, pair=pair)
    assert ft.k == (2 if pair else 16)
    x = _residues(np.random.default_rng(level), mods, lead, ctx.n, cuda)
    args = (ctx.tables(drop), ctx.tables(out_l), ft)
    got = tks.fused_mod_down(x, *args, cluster=cluster)
    torch.cuda.synchronize()
    assert got.shape == (*lead, out_l, ctx.n)
    assert torch.equal(got, tks.mod_down_plain(x, *args))


def _relu_run(dev):
    """One ReLU (composite sign [7, 15]) on a CkksBackend at logN=11 on a
    5-level uint32 chain, refreshed by decrypt/re-encrypt at the floor."""
    from fhe_gpt2_tpu_torch.approx.minimax import sign_composite
    from fhe_gpt2_tpu_torch.nn import kernels as K
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
    ctx = CkksContext(CkksParams.create(
        logn=11, log_q0=29, log_scale=25, num_levels=5, log_special=31,
        num_special=2, hamming_weight=16), device=dev)
    kg = KeyGenerator(ctx, seed=1)
    B = CkksBackend(ctx=ctx, ev=Evaluator(ctx, relin_key=kg.relin_key()),
                    enc=Encryptor(ctx, secret=kg.secret, seed=2),
                    dec=Decryptor(ctx, kg.secret), default_level=ctx.L)
    sp = K.SignPlans.from_composite(sign_composite(7, 2.0 ** -7,
                                                   degrees=[7, 15]))
    x = np.random.default_rng(5).uniform(-1, 1, ctx.params.slots)
    return K.relu(B, B.from_slots(x), sp)


def test_relu_on_card_equals_cpu(cuda):
    _cuda.reset_launches()
    got = _relu_run(cuda)
    torch.cuda.synchronize()
    assert all(_cuda.LAUNCHES[k] > 0 for k in FOUR), _cuda.LAUNCHES
    want = _relu_run("cpu")
    assert got.scale == want.scale
    assert torch.equal(got.data.cpu(), want.data)


def _resnet_block_run(dev):
    """The first residual block of a ResNet-8 (4x4 images, synthetic
    weights, sign [7, 15]) at logN=11 on a 12-level uint32 chain, from an
    encryption of the plain stem output, with the decrypt/re-encrypt
    refresh before each ReLU. Returns the block's output and the plain
    block's."""
    from fhe_gpt2_tpu_torch.approx.minimax import sign_composite
    from fhe_gpt2_tpu_torch.cnn import resnet as R
    from fhe_gpt2_tpu_torch.nn import kernels as K
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend, PlainBackend, \
        RecordingBackend
    rng = np.random.default_rng(0)
    weights = R.synthetic_weights(rng, 8)
    img = rng.uniform(-1, 1, (3, 4, 4))
    sp = K.SignPlans.from_composite(sign_composite(7, 2.0 ** -7,
                                                   degrees=[7, 15]))
    rp = R.build_resnet_plans(weights, 8, 1024, h=4, relu_bound=10.0, sign=sp)
    rec = RecordingBackend(1024)
    R.forward(rec, R.pack_input(rp, img), rp, boot_between=False)
    ctx = CkksContext(CkksParams.create(
        logn=11, log_q0=29, log_scale=25, num_levels=12, log_special=31,
        num_special=3, hamming_weight=16), device=dev)
    kg = KeyGenerator(ctx, seed=1)
    ev = Evaluator(ctx, relin_key=kg.relin_key(),
                   galois_keys=kg.galois_keys(rec.key_steps(), conjugate=True))
    B = CkksBackend(ctx=ctx, ev=ev, enc=Encryptor(ctx, secret=kg.secret,
                                                  seed=2),
                    dec=Decryptor(ctx, kg.secret), default_level=ctx.L)
    pB = PlainBackend(1024)
    stem = R.forward_segments(pB, rp)[0](R.pack_input(rp, img))
    out = R.forward_segments(B, rp)[1]([B.from_slots(v) for v in stem])
    return out[0], B, R.forward_segments(pB, rp)[1](stem)[0]


def test_resnet_block_on_card_equals_cpu(cuda):
    """conv, refresh, ReLU, conv, add, refresh, ReLU on the card: the CPU
    route's words, and the plain block's values within 0.1."""
    _cuda.reset_launches()
    got, B, want = _resnet_block_run(cuda)
    torch.cuda.synchronize()
    assert all(v > 0 for v in _cuda.LAUNCHES.values()), _cuda.LAUNCHES
    ref = _resnet_block_run("cpu")[0]
    assert got.scale == ref.scale
    assert torch.equal(got.data.cpu(), ref.data)
    assert np.abs(B.to_slots(got) - want).max() < 0.1


# ---------------------------------------------------------------------------
# The GPT-2 slice: the Δ batch's kernel shapes and a toy-width block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(32,), (16, 2)])
def test_keyswitch_kernel_at_the_delta_batch_equals_plain(cuda, lead):
    """The key switch over attention's Δ batch (16 diagonals of 2
    ciphertexts at GPT-2 small's width) at 80 limbs / 5 digits / 96 key
    limbs, on the GPT-2 phase's chain at logN=15."""
    key = ("resnet", 15)
    if key not in _CTX:
        _CTX[key] = _resnet_chain(cuda, 15)
    ctx = _CTX[key]
    ft = ctx.fused_ks_tables(80)
    lt, kt = ctx.tables(80), ctx.tables(ctx.key_limbs(80))
    rng = np.random.default_rng(32)
    c = _residues(rng, ctx.moduli[:80], lead, ctx.n, cuda)
    kdata = _residues(rng, kt.moduli, (2, ft.D), ctx.n, cuda)
    got = tks.fused_switch_key(c, kdata, lt, kt, ft)
    torch.cuda.synchronize()
    assert got.shape == (2, *lead, 96, ctx.n)
    assert torch.equal(got, tks.switch_key_plain(c, kdata, lt, kt, ft))


@pytest.mark.parametrize("lead", [(2, 32), (2, 16, 2)])
def test_moddown_kernel_at_the_delta_batch_equals_plain(cuda, lead):
    """The k=16 key-switch mod-down over the Δ batch, [2, 32, 96, N] ->
    [2, 32, 80, N], on the GPT-2 phase's chain at logN=15."""
    key = ("resnet", 15)
    if key not in _CTX:
        _CTX[key] = _resnet_chain(cuda, 15)
    ctx = _CTX[key]
    drop = tuple(ctx.L + i for i in range(ctx.k_sp))
    ft = ctx.fused_md_tables(80)
    assert ft.k == 16
    x = _residues(np.random.default_rng(33), ctx.moduli[:80] + ctx.special,
                  lead, ctx.n, cuda)
    args = (ctx.tables(drop), ctx.tables(80), ft)
    got = tks.fused_mod_down(x, *args)
    torch.cuda.synchronize()
    assert got.shape == (*lead, 80, ctx.n)
    assert torch.equal(got, tks.mod_down_plain(x, *args))


# run_gpt2's flags for a toy-width GPT-2 block (32 wide, 4 heads, seq 16:
# two ciphertexts at logN=10) on a short composite chain, with the
# decrypt/re-encrypt refresh to the chain top.
GPT2_TOY = ["--layers", "1", "--composite", "--logn", "10", "--levels", "10",
            "--nsp", "4", "--ln-iters", "4", "--weights", "synthetic",
            "--newton-inits", "rowmax"]


def _gpt2_block_run(dev):
    """One GPT-2 block and ln_f through run_gpt2's load_model and
    build_session on ``dev``: the output ciphertexts, the backend and the
    plain run's hidden state."""
    from fhe_gpt2_tpu_torch import run_gpt2
    from fhe_gpt2_tpu_torch.nn import model as M
    a = run_gpt2.parse_args(GPT2_TOY + (["--cpu"] if dev == "cpu" else []))
    m = run_gpt2.load_model(a)
    ses = run_gpt2.build_session(a, m)
    xs = [ses.B.from_slots(v) for v in m.sh.act.pack(m.emb)]
    return M.forward(ses.B, xs, m.plans), ses.B, m, run_gpt2.plain_forward(m)


def test_gpt2_block_on_card_equals_cpu(cuda):
    """LayerNorm, attention over the Δ batch, MLP and ln_f on the card, with
    their refreshes: the CPU route's words, and the plain run's hidden
    state within 1e-3."""
    _cuda.reset_launches()
    got, B, m, plain = _gpt2_block_run(cuda)
    torch.cuda.synchronize()
    assert all(v > 0 for v in _cuda.LAUNCHES.values()), _cuda.LAUNCHES
    ref = _gpt2_block_run("cpu")[0]
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.scale == r.scale
        assert torch.equal(g.data.cpu(), r.data)
    hidden = m.sh.act.unpack(np.stack([B.to_slots(o) for o in got]))
    assert np.abs(hidden - plain).max() < 1e-3


# ---------------------------------------------------------------------------
# Sealed calls: CUDA-graph capture and replay (nn/backend.py jit_sealed)
# ---------------------------------------------------------------------------

def _sealed_unit(dev):
    """The unit op (multiply, relinearize, rotate by 1, rescale: all four
    kernels) on the 5-level uint32 chain at logN=12, its backend and an
    encryptor."""
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
    ctx = _cached_ctx(dev, False, 12)
    kg = KeyGenerator(ctx, seed=1)
    ev = Evaluator(ctx, relin_key=kg.relin_key(),
                   galois_keys=kg.galois_keys([1], conjugate=False))
    enc = Encryptor(ctx, secret=kg.secret, seed=2)
    B = CkksBackend(ctx=ctx, ev=ev, enc=enc, dec=Decryptor(ctx, kg.secret),
                    default_level=ctx.L)

    def unit(a, b):
        return ev.rescale(ev.rotate(ev.multiply(a, b), 1))

    def fresh(seed):
        z = np.random.default_rng(seed).uniform(-1, 1, ctx.params.slots)
        return enc.encrypt(ev.make_plain(z, ctx.params.scale, ctx.L))
    return B, unit, fresh


def _same_ct(got, want):
    assert (got.scale, got.level) == (want.scale, want.level)
    assert torch.equal(got.data, want.data)


def test_sealed_unit_op_replays_equal_eager(cuda):
    """jit_sealed's warm pass and capture launch every kernel (twice what
    one eager call launches); replays launch through the graph only (the
    wrappers' counts stay put) and equal the eager call, on the same
    inputs, on new ones, and after another replay (outputs are copies)."""
    from fhe_gpt2_tpu_torch.nn.backend import jit_sealed
    B, unit, fresh = _sealed_unit(cuda)
    x, y = fresh(1), fresh(2)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    want = unit(x, y)
    torch.cuda.synchronize()
    once = dict(_cuda.LAUNCHES)
    assert all(once[k] > 0 for k in FOUR), once
    _cuda.reset_launches()
    call = jit_sealed(B, unit, x, y)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES == {k: 2 * v for k, v in once.items()}
    [prog] = call.programs.values()
    assert prog.graph is not None and prog.seal.sealed
    _same_ct(call(x, y), want)                 # the warm pass's output
    x2, y2 = fresh(3), fresh(4)
    torch.cuda.synchronize()
    before = dict(_cuda.LAUNCHES)
    r1 = call(x, y)
    r2 = call(x2, y2)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES == before
    _same_ct(r1, want)
    _same_ct(r2, unit(x2, y2))
    low = [B.ev.mod_switch_to(c, c.level - 1) for c in (x, y)]
    _same_ct(call(*low), unit(*low))           # a new signature: warm pass
    _same_ct(call(*low), unit(*low))           # and its own graph
    assert len(call.programs) == 2


def _sealed_boot(dev):
    """A bootstrapper at logN=11 / 46 limbs, its backend, two entry
    ciphertexts and their eager bootstraps."""
    from fhe_gpt2_tpu_torch.boot.bootstrap import Bootstrapper, make_evalmod
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
    ns = 64
    params = CkksParams.create_composite(
        logn=11, num_levels=22, log_scale=50, log_q0=55, log_special=31,
        num_special=2, hamming_weight=16, sparse_slots=ns)
    ctx = CkksContext(params, device=dev)
    kg = KeyGenerator(ctx, seed=3)
    ev = Evaluator(ctx, relin_key=kg.relin_key())
    enc = Encryptor(ctx, secret=kg.secret, seed=4)
    B = CkksBackend(ctx=ctx, ev=ev, enc=enc, default_level=ctx.L)
    eps = params.scale / ctx.q0_float
    boot = Bootstrapper(B, num_slots=ns, evalmod=make_evalmod(
        K=12, eps=max(eps * 1.05, 2 ** -5), degree=45, arcsin_degree=3,
        prec_dps=60))
    ev.galois_keys = kg.galois_keys(boot.required_steps(), conjugate=True)
    cts = [enc.encrypt(ev.make_plain(
        np.random.default_rng(s).uniform(-1, 1, ns), params.scale,
        ctx.base_limbs)) for s in (5, 6)]
    return B, boot, cts, [boot.bootstrap(c) for c in cts]


def test_sealed_bootstrap_stages_replay_equal_eager(cuda):
    """bootstrap_jitted (each stage a graph) at logN=11 / 46 limbs: the
    warm pass, a replay and a replay on another ciphertext equal the eager
    bootstrap; CkksBackend.bootstrap takes it for a ciphertext on the
    card."""
    from fhe_gpt2_tpu_torch.nn.backend import graph_pool_bytes
    B, boot, cts, want = _sealed_boot(cuda)
    _same_ct(boot.bootstrap_jitted(cts[0]), want[0])
    assert all(p.graph is not None for c in boot._staged_jit
               for p in c.programs.values())
    assert graph_pool_bytes(B) > 0
    before = dict(_cuda.LAUNCHES)
    _same_ct(boot.bootstrap_jitted(cts[0]), want[0])
    _same_ct(boot.bootstrap_jitted(cts[1]), want[1])
    B.boot = boot
    _same_ct(B.bootstrap(cts[1]), want[1])
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES == before
    assert all(len(c.programs) == 1 for c in boot._staged_jit)


def test_sealed_bootstrap_from_two_threads(cuda):
    """Two threads (the service's workers share one backend) bootstrap two
    ciphertexts through CkksBackend.bootstrap at once, three times each,
    the stages' first calls (warm passes and captures) included, one of
    them on a stream of its own: every result is torch.equal to its eager
    bootstrap."""
    import threading
    B, boot, cts, want = _sealed_boot(cuda)
    B.boot = boot
    got = [[], []]
    errors = []
    start = threading.Barrier(2)

    def work(i):
        try:
            stream = torch.cuda.Stream() if i else torch.cuda.current_stream()
            with torch.cuda.stream(stream):
                start.wait()
                for _ in range(3):
                    got[i].append(B.bootstrap(cts[i]))
            stream.synchronize()
        except BaseException as e:      # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    torch.cuda.synchronize()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not errors, errors
    torch.cuda.synchronize()
    for i in (0, 1):
        assert len(got[i]) == 3
        for g in got[i]:
            _same_ct(g, want[i])
    assert all(len(c.programs) == 1 for c in boot._staged_jit)


def test_rebind_captures_a_graph_of_its_own(cuda):
    """Two matmuls of one structure (different weights) plus a constant:
    a rebound call, with the base's constant or another, captures a graph
    of its own over its own masks; calls in turn equal the eager runs."""
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend, RecordingBackend, \
        jit_sealed, rebind_sealed
    from fhe_gpt2_tpu_torch.nn.formats import TightLayout, matmul_spec
    from fhe_gpt2_tpu_torch.nn.linear import apply_lt
    ctx = _cached_ctx(cuda, False, 12)
    slots = ctx.params.slots
    rng = np.random.default_rng(4)
    lay = TightLayout(8, 12, slots)
    plans = [matmul_spec(rng.standard_normal((12, 12)) * 0.3, lay)
             .bsgs_plan() for _ in range(2)]
    xs_p = list(lay.pack(rng.standard_normal((8, 12)) * 0.5))
    rec = RecordingBackend(slots)
    for p in plans:
        apply_lt(rec, p, xs_p)
    kg = KeyGenerator(ctx, seed=5)
    ev = Evaluator(ctx, relin_key=kg.relin_key(),
                   galois_keys=kg.galois_keys(rec.key_steps()))
    B = CkksBackend(ctx=ctx, ev=ev, enc=Encryptor(ctx, secret=kg.secret,
                                                  seed=6),
                    default_level=ctx.L)
    xs = [B.from_slots(v) for v in xs_p]

    def fn(plan, c):
        return lambda vs: [B.add_const(o, c) for o in apply_lt(B, plan, vs)]

    base = jit_sealed(B, fn(plans[0], 0.25), xs, seq_keys=True)
    same = rebind_sealed(base, fn(plans[1], 0.25), xs)
    other = rebind_sealed(base, fn(plans[1], 0.5), xs)
    progs = [p for c in (base, same, other) for p in c.programs.values()]
    assert len(progs) == 3
    assert len({id(p.graph.graph) for p in progs}) == 3
    wants = [fn(plans[0], 0.25)(xs), fn(plans[1], 0.25)(xs),
             fn(plans[1], 0.5)(xs)]
    for _ in range(2):
        for c, want in zip((base, same, other), wants):
            [got] = c(list(xs))
            _same_ct(got, want[0])


def test_host_copy_inside_a_capture_raises(cuda):
    """A function that copies from the host runs in the warm pass, and its
    capture raises: nothing falls back to eager. The card goes on working
    after."""
    from fhe_gpt2_tpu_torch.core.evaluator import Ciphertext
    from fhe_gpt2_tpu_torch.nn.backend import jit_sealed
    B, unit, fresh = _sealed_unit(cuda)
    x = fresh(1)

    def h2d(a):
        one = torch.ones(1, dtype=a.data.dtype).to(a.data.device)
        return Ciphertext(a.data + one, a.scale, a.level)

    def d2h(a):
        a.data.cpu()
        return a

    for fn in (h2d, d2h):
        with pytest.raises(RuntimeError):
            jit_sealed(B, fn, x)
    torch.cuda.synchronize()
    y = fresh(2)
    call = jit_sealed(B, unit, x, x)
    _same_ct(call(x, y), unit(x, y))


# ---------------------------------------------------------------------------
# The serving slice: the wire format onto the card, the native encoder on the
# card's host, and the service's handlers on the card
# ---------------------------------------------------------------------------

def _served_session(dev):
    """Keys, a ciphertext and its Galois steps at logN=11 (uint32, 3
    levels) on one device."""
    ctx = CkksContext(CkksParams.create(
        logn=11, log_q0=29, log_scale=25, num_levels=3, log_special=31,
        num_special=2, hamming_weight=16), device=dev)
    kg = KeyGenerator(ctx, seed=2)
    ev = Evaluator(ctx, relin_key=kg.relin_key(),
                   galois_keys=kg.galois_keys([1, 5], conjugate=True))
    enc = Encryptor(ctx, secret=kg.secret, seed=3)
    z = np.random.default_rng(1).uniform(-1, 1, ctx.params.slots)
    return ctx, ev, enc.encrypt(ev.make_plain(z, ctx.params.scale, ctx.L)), \
        Decryptor(ctx, kg.secret), z


def test_serialize_roundtrips_onto_the_card(cuda):
    """Blobs of card tensors load onto the card and onto the CPU with the
    same words; the seeded form re-expands on the card."""
    from fhe_gpt2_tpu_torch.net import serialize as S
    ctx, ev, ct, dec, z = _served_session(cuda)
    blob = S.dump_ciphertext(ct)
    for dev in (None, cuda, "cpu"):
        back = S.load_ciphertext(blob, dev)
        assert back.data.device.type == ("cpu" if dev == "cpu" else "cuda")
        assert back.scale == ct.scale
        assert torch.equal(back.data.cpu(), ct.data.cpu())
    rk = S.load_kswitch_key(S.dump_kswitch_key(ev.relin_key), cuda)
    assert rk.data.is_cuda and torch.equal(rk.data, ev.relin_key.data)
    gk = S.load_galois_keys(S.dump_galois_keys(ev.galois_keys), cuda)
    assert set(gk.keys) == set(ev.galois_keys.keys)
    for e, k in gk.keys.items():
        assert torch.equal(k.data, ev.galois_keys.keys[e].data)
    elt = sorted(ev.galois_keys.keys)[0]
    e, k = S.load_galois_elt(S.dump_galois_elt(elt, ev.galois_keys[elt]),
                             cuda)
    assert e == elt and torch.equal(k.data, ev.galois_keys[elt].data)
    assert S.load_params(S.dump_params(ctx.params)) == ctx.params
    enc = Encryptor(ctx, secret=dec.secret, seed=4)
    sct, seed = enc.encrypt_symmetric_seeded(ev.make_plain(
        z, ctx.params.scale, ctx.L))
    back = S.load_ciphertext_seeded(S.dump_ciphertext_seeded(sct, seed), ctx)
    assert back.data.is_cuda and torch.equal(back.data, sct.data)
    assert np.abs(np.real(dec.decrypt(back)) - z).max() < 1e-3


@pytest.mark.parametrize("kind", ["uniform", "zero_one"])
def test_native_encoder_on_the_card_host_equals_numpy(cuda, kind,
                                                      monkeypatch):
    """On the card's host the native transform gives numpy's coefficients
    at logN=15, Δ = 2^54; the residues the card reduces are the same, and
    the decodes agree."""
    from fhe_gpt2_tpu_torch.core import embedding
    from fhe_gpt2_tpu_torch.runtime import native
    assert native.available()
    ctx = CkksContext(CkksParams.create_composite(
        logn=15, num_levels=2, log_scale=54, log_q0=59, num_special=2,
        hamming_weight=16), device=cuda)
    rng = np.random.default_rng(6)
    z = (rng.uniform(-1, 1, ctx.params.slots) if kind == "uniform"
         else rng.integers(0, 2, ctx.params.slots) * 1.0)
    t = ctx.tables(ctx.L)
    ev = Evaluator(ctx)
    got = ev._encode(z, ctx.params.scale, t)
    res = got.cpu().numpy().view(np.uint32)
    dec_native = embedding.decode(res, ctx.params.scale, ctx,
                                  tuple(range(ctx.L)))
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        want = ev._encode(z, ctx.params.scale, t)
        dec_numpy = embedding.decode(res, ctx.params.scale, ctx,
                                     tuple(range(ctx.L)))
    assert torch.equal(got, want)
    assert np.abs(dec_native - dec_numpy).max() < 1e-12
    assert np.abs(dec_native - z).max() < 1e-9


def test_service_handlers_on_the_card_equal_cpu(cuda):
    """The server's handlers on the card and on the CPU, fed the same
    frames: the same answer words, on the server's own device."""
    from fhe_gpt2_tpu_torch.net import serialize as S
    from fhe_gpt2_tpu_torch.net.service import SecureInferenceServer
    ctx, ev, ct, dec, z = _served_session(cuda)
    frames = [S.dump_params(ctx.params), S.dump_kswitch_key(ev.relin_key)]
    frames += [S.dump_galois_elt(e, k)
               for e, k in sorted(ev.galois_keys.keys.items())]

    def model(B, c):
        assert B.enc is None and B.dec is None
        return B.add(B.square(c), B.rotate(c, 5))

    answers = {}
    for dev in (cuda, "cpu"):
        server = SecureInferenceServer(model_fn=model, device=dev)
        assert server._init_session_stream(iter(frames), None) == b"ok"
        [blob] = server._evaluate_stream(iter([S.dump_ciphertext(ct)]), None)
        assert server._state["backend"].ctx.device.type == \
            torch.device(dev).type
        answers[str(dev)] = S.load_ciphertext(blob, "cpu")
    a, b = answers.values()
    assert a.scale == b.scale and torch.equal(a.data, b.data)
    got = np.real(dec.decrypt(S.load_ciphertext(S.dump_ciphertext(a), cuda)))
    assert np.abs(got - (z * z + np.roll(z, -5))).max() < 1e-2


# ---------------------------------------------------------------------------
# The u64 engine on the card: int64 words on plain PyTorch ops, no kernel
# ---------------------------------------------------------------------------

def _u64_run(dev, logn):
    """NTT/iNTT and modular products of random words, then keygen, encrypt,
    multiply+relin (a key switch), rescale and rotate on test_params(logn,
    4) on one device."""
    from fhe_gpt2_tpu_torch.core.context import test_params
    from fhe_gpt2_tpu_torch.core.modmath import mul_mod, mul_mod_shoup
    ctx = CkksContext(test_params(logn, 4), device=dev)
    t = ctx.tables(ctx.L)
    rng = np.random.default_rng(logn)
    x = word_tensor(np.stack([rng.integers(0, q, size=(2, ctx.n),
                                           dtype=np.uint64)
                              for q in t.moduli], axis=-2), dev,
                    word=np.uint64)
    fwd = nttmod.ntt(x, t)
    out = {"ntt": fwd, "intt": nttmod.intt(fwd, t),
           "mul_mod": mul_mod(x, fwd, t.q, t.ratio0, t.ratio1),
           "mul_mod_shoup": mul_mod_shoup(x, t.roots[:, 5:6],
                                          t.roots_shoup[:, 5:6], t.q)}
    kg = KeyGenerator(ctx, seed=3)
    ev = Evaluator(ctx, relin_key=kg.relin_key(),
                   galois_keys=kg.galois_keys(steps=[1]))
    z = np.random.default_rng(1).uniform(-1, 1, ctx.params.slots)
    ct = Encryptor(ctx, secret=kg.secret, seed=4).encrypt(
        ev.make_plain(z, ctx.params.scale, ctx.L))
    mul = ev.multiply(ct, ct)
    out.update(encrypt=ct.data, mul_relin=mul.data,
               rescale=ev.rescale(mul).data, rotate1=ev.rotate(ct, 1).data)
    dec = Decryptor(ctx, kg.secret)
    res = ev.rescale(mul)
    for k, o, want in (("rescale", res, z * z),
                       ("rotate1", ev.rotate(ct, 1), np.roll(z, -1))):
        assert np.abs(dec.decrypt(o) - want).max() < 1e-5, k
    return out


@pytest.mark.parametrize("logn", [12, 16])
def test_u64_route_on_card_equals_cpu_and_launches_no_kernel(cuda, logn):
    """The u64 route on CUDA tensors gives the CPU route's words for the
    NTT, iNTT, mul_mod, mul_mod_shoup, a key switch, a rescale and a
    rotation, and no int64 operand reaches a kernel."""
    before = dict(_cuda.LAUNCHES)
    got = _u64_run(cuda, logn)
    torch.cuda.synchronize()
    assert dict(_cuda.LAUNCHES) == before
    want = _u64_run("cpu", logn)
    for k, v in want.items():
        assert got[k].is_cuda and got[k].dtype == torch.int64, k
        assert torch.equal(got[k].cpu(), v), k


def test_kernels_refuse_int64_operands(cuda):
    """A wrong route fails loudly: the kernels' operand check takes int32
    only."""
    x = torch.zeros((1, 2048), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        _cuda.check_operand(x, "x")


def test_seal_vectors_on_card(cuda):
    """SEAL's square+relin+rescale and rotate-by-1, on the card, equal to
    SEAL's coefficient dumps word for word."""
    from torch_seal_common import seal_session, to_coeff
    before = dict(_cuda.LAUNCHES)
    v, ctx, ev, dec, load_ct, L = seal_session(cuda)
    ct = load_ct("ct_in", L)
    sq = ev.rescale(ev.square(ct))
    rot = ev.rotate(ct, 1)
    assert sq.data.is_cuda and sq.data.dtype == torch.int64
    assert np.array_equal(to_coeff(ctx, sq.data, L - 1),
                          np.stack([v["ct_sq_c0"], v["ct_sq_c1"]]))
    assert np.array_equal(dec.decrypt_to_rns(sq), v["plain_sq"])
    assert np.array_equal(to_coeff(ctx, rot.data, L),
                          np.stack([v["ct_rot_c0"], v["ct_rot_c1"]]))
    assert np.array_equal(dec.decrypt_to_rns(rot), v["plain_rot"])
    torch.cuda.synchronize()
    assert dict(_cuda.LAUNCHES) == before


# -- The mesh (parallel/): a position's key rows, the row map, the operand's
# device ----------------------------------------------------------------------

def _view(ctx, cuda, n_limb, pos):
    from fhe_gpt2_tpu_torch.parallel.limbs import LimbView, tables_on
    return LimbView(ctx, cuda, pos, n_limb,
                    (tables_on(ctx.ntt_all, cuda), {}, {}))


# (limb axis, position, level): full and narrow digits, and a position
# that holds no data limb at its level (the empty data block).
_BLOCKS = [(2, 0, 5), (2, 1, 5), (3, 2, 4), (2, 1, 1), (4, 3, 2)]


@pytest.mark.parametrize("logn,cluster", _forced((11, 15, 16)))
@pytest.mark.parametrize("n_limb,pos,level", _BLOCKS)
@pytest.mark.parametrize("lead", [(), (2,)])
def test_keyswitch_kernel_on_a_row_block_equals_plain(cuda, logn, cluster,
                                                      n_limb, pos, level,
                                                      lead):
    """ks_fused on one position's key rows (the row map): equal to the
    plain version with the same map, and to those rows of the whole
    switch."""
    ctx = _cached_ctx(cuda, False, logn)
    view = _view(ctx, cuda, n_limb, pos)
    rows = view.key_limbs(level)
    vft, ft = view.fused_ks_tables(level), ctx.fused_ks_tables(level)
    lt, kt = ctx.tables(level), ctx.tables(ctx.key_limbs(level))
    rng = np.random.default_rng(level + 7 * pos)
    c = _residues(rng, ctx.moduli[:level], lead, ctx.n, cuda)
    kfull = _residues(rng, kt.moduli, (2, ft.D), ctx.n, cuda)
    idx = torch.tensor([ctx.key_limbs(level).index(j) for j in rows],
                       device=cuda)
    kdata = kfull.index_select(2, idx).contiguous()
    before = _cuda.LAUNCHES["keyswitch"]
    got = tks.fused_switch_key(c, kdata, lt, view.tables(rows), vft,
                               cluster=cluster)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["keyswitch"] == before + 1
    assert got.shape == (2, *lead, len(rows), ctx.n)
    assert torch.equal(got, tks.switch_key_plain(c, kdata, lt,
                                                 view.tables(rows), vft))
    whole = tks.fused_switch_key(c, kfull, lt, kt, ft, cluster=cluster)
    assert torch.equal(got, whole.index_select(-2, idx))


@pytest.mark.parametrize("logn,cluster", _forced((11, 15, 16)))
@pytest.mark.parametrize("n_limb,pos,level", _BLOCKS)
@pytest.mark.parametrize("lead", [(2,), (3, 2)])
def test_moddown_kernel_on_a_position_rows_equals_plain(cuda, logn, cluster,
                                                        n_limb, pos, level,
                                                        lead):
    """md_fused on one position's output rows (its tables sliced to them):
    equal to the plain version and to those rows of the whole mod-down; an
    empty block gives [.., 0, N] and launches nothing."""
    ctx = _cached_ctx(cuda, False, logn)
    view = _view(ctx, cuda, n_limb, pos)
    sp = tuple(ctx.L + i for i in range(ctx.k_sp))
    x = _residues(np.random.default_rng(level), ctx.moduli[:level]
                  + ctx.special, lead, ctx.n, cuda)
    keep = list(view.data_limbs(level))
    xb = x.index_select(-2, torch.tensor(keep + list(range(level, level
                                                          + ctx.k_sp)),
                                         device=cuda)).contiguous()
    args = (ctx.tables(sp), view.tables(level), view.fused_md_tables(level))
    before = _cuda.LAUNCHES["moddown"]
    got = tks.fused_mod_down(xb, *args, cluster=cluster)
    torch.cuda.synchronize()
    assert got.shape == (*lead, len(keep), ctx.n)
    assert _cuda.LAUNCHES["moddown"] == before + (1 if keep else 0)
    assert torch.equal(got, tks.mod_down_plain(xb, *args))
    whole = tks.fused_mod_down(x, ctx.tables(sp), ctx.tables(level),
                               ctx.fused_md_tables(level), cluster=cluster)
    assert torch.equal(got, whole[..., keep, :])


def test_one_device_passes_the_identity_row_map(cuda):
    """A whole context's key rows are the chain's own: the map is the
    identity at every level, no splice is taken, and the kernel's words
    are the plain version's (the key switch of the previous releases)."""
    ctx = _cached_ctx(cuda, False, 15)
    for level in range(1, ctx.L + 1):
        ft = ctx.fused_ks_tables(level)
        assert ft.splice is None
        assert torch.equal(ft.rows.cpu(), torch.arange(level + ctx.k_sp,
                                                       dtype=torch.int32))
    level = ctx.L
    ft = ctx.fused_ks_tables(level)
    lt, kt = ctx.tables(level), ctx.tables(ctx.key_limbs(level))
    rng = np.random.default_rng(3)
    c = _residues(rng, ctx.moduli[:level], (2,), ctx.n, cuda)
    kdata = _residues(rng, kt.moduli, (2, ft.D), ctx.n, cuda)
    assert torch.equal(tks.fused_switch_key(c, kdata, lt, kt, ft),
                       tks.switch_key_plain(c, kdata, lt, kt, ft))


def _mesh_step(ev, c):
    m = ev.multiply(c, c)
    return [m, ev.rescale(m), ev.rotate(c, 3), ev.conjugate(c)]


def _mesh_run(cuda, devices, composite=False):
    """_mesh_step on a mesh of `devices` (data rows x 2 limb positions) at
    logN=12, gathered, beside the single-device run on `cuda`."""
    from fhe_gpt2_tpu_torch.core.evaluator import stack_cts
    from fhe_gpt2_tpu_torch.parallel.mesh import MeshEvaluator, \
        gather_ciphertext, make_mesh, shard_ciphertext
    ctx = _cached_ctx(cuda, composite, 12)
    kg = KeyGenerator(ctx, seed=1)
    ev = Evaluator(ctx, relin_key=kg.relin_key(),
                   galois_keys=kg.galois_keys([1, 2], conjugate=True))
    enc = Encryptor(ctx, secret=kg.secret, seed=2)
    zs = np.random.default_rng(4).uniform(-1, 1, (2, ctx.params.slots))
    ct = stack_cts([enc.encrypt(ev.make_plain(z, ctx.params.scale, ctx.L))
                    for z in zs])
    mesh = make_mesh(len(devices) // 2, 2, devices)
    mev = MeshEvaluator(mesh, ctx, relin_key=ev.relin_key,
                        galois_keys=ev.galois_keys)
    _cuda.reset_launches()
    outs = mev.run(_mesh_step, shard_ciphertext(ct, mesh))
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    return ([gather_ciphertext(o, cuda) for o in outs],
            _mesh_step(ev, ct), launches)


@pytest.mark.parametrize("composite", [False, True])
def test_mesh_on_one_card_equals_single_device(cuda, composite):
    """A data=2 x limb=2 mesh of one card (four positions, four streams):
    multiply+relin, rescale, rotate and conjugate gathered equal to the
    single-device Evaluator, every kernel of the path launched (the
    composite chain's pair rescale takes the mod-down, not the forward
    NTT)."""
    got, want, launches = _mesh_run(cuda, [cuda] * 4, composite)
    for g, w in zip(got, want):
        assert g.level == w.level and g.scale == w.scale
        assert torch.equal(g.data, w.data)
    path = [k for k in FOUR if not (composite and k == "ntt_fwd")]
    assert all(launches[k] > 0 for k in path + ["dyadic"]), launches


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_context_and_launches_on_a_second_card(two_cards):
    """CkksContext(device='cuda:1') builds every table there, and the
    kernels launch on the operand's card while cuda:0 is current: the
    words equal the CPU route's."""
    dev = two_cards[1]
    ctx = _ctx(dev, False, 12)
    level = ctx.L
    tabs = [ctx.ntt_all, ctx.tables(level), ctx.fused_ks_tables(level),
            ctx.fused_md_tables(level), ctx.fused_md_tables(level).mdt,
            ctx.drop_last_tables(level)]
    for t in tabs:
        for v in vars(t).values():
            if isinstance(v, torch.Tensor):
                assert v.device == dev, (type(t).__name__, v.device)
    kg = KeyGenerator(ctx, seed=1)
    ev = Evaluator(ctx, relin_key=kg.relin_key(),
                   galois_keys=kg.galois_keys([1], conjugate=True))
    enc = Encryptor(ctx, secret=kg.secret, seed=2)
    z = np.random.default_rng(3).uniform(-1, 1, ctx.params.slots)
    ct = enc.encrypt(ev.make_plain(z, ctx.params.scale, level))
    cpu = torch.device("cpu")
    cctx = CkksContext(ctx.params, device=cpu)
    from fhe_gpt2_tpu_torch.core.keys import GaloisKeys, KSwitchKey
    cev = Evaluator(cctx, relin_key=KSwitchKey(ev.relin_key.data.cpu()),
                    galois_keys=GaloisKeys(keys={
                        e: KSwitchKey(k.data.cpu())
                        for e, k in ev.galois_keys.keys.items()}))
    from fhe_gpt2_tpu_torch.core.evaluator import Ciphertext
    cct = Ciphertext(ct.data.cpu(), ct.scale)
    with torch.cuda.device(two_cards[0]):
        got = [ev.rescale(ev.multiply(ct, ct)), ev.rotate(ct, 1)]
        torch.cuda.synchronize(dev)
    want = [cev.rescale(cev.multiply(cct, cct)), cev.rotate(cct, 1)]
    for g, w in zip(got, want):
        assert g.data.device == dev
        assert torch.equal(g.data.cpu(), w.data)


def test_mesh_over_two_cards_equals_single_device(two_cards):
    """A limb axis over cuda:0 and cuda:1 (events across cards, peer
    copies): the gathered words equal the single-device run's."""
    got, want, launches = _mesh_run(two_cards[0], two_cards)
    for g, w in zip(got, want):
        assert torch.equal(g.data, w.data)
    assert all(launches[k] > 0 for k in FOUR), launches


# ---------------------------------------------------------------------------
# The MAC kernels (csrc/mac.cu): hoisted key products, the lifted c0, masked
# sums
# ---------------------------------------------------------------------------

def _mac_tables(cuda, logn, rows):
    """NTT tables of `rows` 30-bit primes at N = 2^logn."""
    n = 1 << logn
    return nttmod.make_ntt_tables(primes.gen_primes_balanced(30, rows, 2 * n),
                                  n, cuda)


def _offset(x, words):
    """x's words in a new allocation starting `words` words past a 16-byte
    boundary (words=1: the kernels' 4-byte route)."""
    buf = torch.empty(x.numel() + words, dtype=x.dtype, device=x.device)
    y = buf[words:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("logn", [11, 15, 16])
@pytest.mark.parametrize("D,lead", [(1, ()), (5, ()), (3, (2,))])
@pytest.mark.parametrize("perm_kind", ["galois", "any"])
def test_hoisted_mac_kernel_equals_plain(cuda, logn, D, lead, perm_kind):
    """hoisted_mac at 96 key rows (the bootstrap's top), a batch, one and
    five digits; a Galois permutation (the staged gather) and any
    permutation (entries outside the staged block read from device
    memory)."""
    t = _mac_tables(cuda, logn, 96 if logn == 15 else 7)
    J, n = t.q.shape[0], t.n
    rng = np.random.default_rng(logn + D)
    tp = _residues(rng, t.moduli, lead + (D,), n, cuda)
    key = _residues(rng, t.moduli, (2, D), n, cuda)
    perm = torch.from_numpy(nttmod.galois_ntt_permutation(
        n, pow(5, 77, 2 * n)).astype(np.int64)).to(cuda)
    if perm_kind == "any":
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(3)
                              ).to(cuda)
    before = _cuda.LAUNCHES["mac"]
    got = tks.hoisted_mac(tp, key, perm, t)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["mac"] == before + 1
    assert got.shape == (2, *lead, J, n)
    assert torch.equal(got, tks.hoisted_mac_plain(tp, key, perm, t))


@pytest.mark.parametrize("lead", [(), (2,)])
def test_add_lifted_kernel_equals_plain(cuda, lead):
    """The c0 epilogue at logN=15 over 96 key rows, 80 of them data rows:
    in place on the card, the plain version's words."""
    t = _mac_tables(cuda, 15, 96)
    n, r = t.n, 80
    rng = np.random.default_rng(80 + len(lead))
    acc = _residues(rng, t.moduli, (2,) + lead, n, cuda)
    c0 = _residues(rng, t.moduli[:r], lead, n, cuda)
    P = (1 << 31) * 12345 + 7
    p = word_tensor(np.array([P % q for q in t.moduli], dtype=np.uint64)
                    [:, None], cuda)
    ps = word_tensor(np.array([((P % q) << 32) // q for q in t.moduli],
                              dtype=np.uint64)[:, None], cuda)
    perm = torch.from_numpy(nttmod.galois_ntt_permutation(
        n, pow(5, 300, 2 * n)).astype(np.int64)).to(cuda)
    want = tks.add_lifted_plain(acc, c0, perm, p, ps, t.q[:r])
    got = tks.add_lifted(acc, c0, perm, p, ps, t.q[:r])
    torch.cuda.synchronize()
    assert got.data_ptr() == acc.data_ptr()
    assert torch.equal(got, want)


@pytest.mark.parametrize("T", [1, 8, 9, 63])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_masked_sum_kernel_equals_plain(cuda, T, lead):
    """masked_sum at logN=15 over 96 rows: T terms, in launches of up to
    MAC_CHUNK, among them components of a stacked batch (``e[:, bi]``), row
    slices of wider words and the last two components of three."""
    t = _mac_tables(cuda, 15, 96)
    J, n = t.q.shape[0], t.n
    rng = np.random.default_rng(T + len(lead))
    stacked = _residues(rng, t.moduli, (2, 3) + lead, n, cuda)
    wide = _residues(rng, t.moduli + t.moduli[:4], (2,) + lead, n, cuda)
    vals = []
    for i in range(T):
        kind = i % 4
        if kind == 0:
            vals.append(_residues(rng, t.moduli, (2,) + lead, n, cuda))
        elif kind == 1:
            vals.append(stacked[:, i % 3])
        elif kind == 2:
            vals.append(wide[..., :J, :])
        else:
            vals.append(_residues(rng, t.moduli, (3,) + lead, n, cuda)[1:])
    pts = [_residues(rng, t.moduli, (), n, cuda) for _ in range(T)]
    before = _cuda.LAUNCHES["mac"]
    got = tks.masked_sum(vals, pts, t)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["mac"] == before + 1
    assert got.shape == (2, *lead, J, n)
    assert torch.equal(got, tks.masked_sum_plain(vals, pts, t))


def test_mac_kernels_raise_off_the_16_byte_grid(cuda):
    """The kernels move words 16 bytes at a time: an operand whose data
    starts 4 bytes past a boundary is refused, not read."""
    t = _mac_tables(cuda, 11, 7)
    n, r = t.n, 4
    rng = np.random.default_rng(4)
    tp = _residues(rng, t.moduli, (2,), n, cuda)
    key = _residues(rng, t.moduli, (2, 2), n, cuda)
    perm = torch.arange(n, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        tks.hoisted_mac(_offset(tp, 1), key, perm, t)
    acc = tks.hoisted_mac(tp, key, perm, t)
    c0 = _residues(rng, t.moduli[:r], (), n, cuda)
    with pytest.raises(ValueError, match="16-byte"):
        tks.add_lifted(acc, _offset(c0, 1), perm, t.q, t.q, t.q[:r])
    v = _residues(rng, t.moduli, (2,), n, cuda)
    with pytest.raises(ValueError, match="16-byte"):
        tks.masked_sum([v, _offset(v, 1)], [c0[:1].expand(7, n)] * 2, t)


def test_mac_kernels_in_a_cuda_graph_equal_plain(cuda):
    """hoisted_mac, add_lifted and a two-launch masked sum captured in one
    torch.cuda.graph: each replay, on inputs rewritten in place, gives the
    plain versions' words (the masked sum's terms reach the kernel by
    value, so a replay reads the captured pointers)."""
    t = _mac_tables(cuda, 15, 96)
    J, n, r = t.q.shape[0], t.n, 80
    rng = np.random.default_rng(5)
    tp = _residues(rng, t.moduli, (5,), n, cuda)
    key = _residues(rng, t.moduli, (2, 5), n, cuda)
    c0 = _residues(rng, t.moduli[:r], (), n, cuda)
    vals = [_residues(rng, t.moduli, (2,), n, cuda) for _ in range(9)]
    pts = [_residues(rng, t.moduli, (), n, cuda) for _ in range(9)]
    p = word_tensor(np.array([(1 << 40) % q for q in t.moduli],
                             dtype=np.uint64)[:, None], cuda)
    ps = word_tensor(np.array([(((1 << 40) % q) << 32) // q
                               for q in t.moduli], dtype=np.uint64)[:, None],
                     cuda)
    perm = torch.from_numpy(nttmod.galois_ntt_permutation(
        n, pow(5, 9, 2 * n)).astype(np.int64)).to(cuda)

    def step():
        acc = tks.hoisted_mac(tp, key, perm, t)
        return tks.add_lifted(acc, c0, perm, p, ps, t.q[:r]), \
            tks.masked_sum(vals, pts, t)

    def plain():
        acc = tks.hoisted_mac_plain(tp, key, perm, t)
        return tks.add_lifted_plain(acc, c0, perm, p, ps, t.q[:r]), \
            tks.masked_sum_plain(vals, pts, t)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()                                    # warm up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for seed in (6, 7):
        g = np.random.default_rng(seed)
        for x, mods, lead in [(tp, t.moduli, (5,)), (c0, t.moduli[:r], ()),
                              (vals[8], t.moduli, (2,)), (pts[0], t.moduli,
                                                          ())]:
            x.copy_(_residues(g, mods, lead, n, cuda))
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, plain()):
            assert torch.equal(got, want)


# run_resnet's flags of the ResNet-20 cells (fhe_bench/configs/
# resnet20-cifar10.json): logN 15, 80 limbs, 16 special primes, base-16
# digit keys, Bootstrapper(3, 3).
CELL_FLAGS = ["--composite", "--log-scale", "54", "--real-boot", "--levels",
              "39", "--nsp", "16", "--digit-keys", "--boot-factors", "3",
              "--start-level", "18", "--headroom", "0"]


@pytest.fixture(scope="module")
def cell_boot():
    """The served ResNet's Bootstrapper at its chain on the card, with
    run_resnet's keys (relinearization, the 48 digit keys, conjugation),
    and one ciphertext at the chain's base."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    from fhe_gpt2_tpu_torch import run_resnet
    from fhe_gpt2_tpu_torch.core.keys import digit_steps
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
    a = run_resnet.parse_args(CELL_FLAGS)
    ctx = CkksContext(run_resnet.make_params(a), device="cuda")
    kg = KeyGenerator(ctx, seed=1)
    ev = Evaluator(ctx, relin_key=kg.relin_key())
    enc = Encryptor(ctx, secret=kg.secret, seed=2)
    B = CkksBackend(ctx=ctx, ev=ev, enc=enc, dec=None, default_level=ctx.L)
    B.boot = run_resnet.make_bootstrapper(a, B)
    ev.galois_keys = kg.galois_keys(
        steps=digit_steps(ctx.params.slots, base=16), conjugate=True)
    z = np.random.default_rng(9).uniform(-1, 1, ctx.params.slots)
    ct = enc.encrypt(ev.make_plain(z, ctx.params.scale, ctx.base_limbs))
    yield B, ct, Decryptor(ctx, kg.secret), z
    B.release_caches()
    torch.cuda.empty_cache()


def test_mac_kernels_equal_plain_at_the_cell_bootstrap_shapes(cell_boot):
    """One eager bootstrap of the served ResNet with the three MAC wrappers
    recording: the first call at each operand signature is held
    torch.equal to its plain version on the same inputs. The shapes
    include CoeffToSlot's hoisted products at 94 and 92 key rows and 5
    digits (its first factor, at 96, has no baby rotation) and masked sums
    of 1 and 8 terms."""
    B, ct, _, _ = cell_boot
    held = {"hoisted_mac": set(), "add_lifted": set(), "masked_sum": set()}
    real = {k: getattr(tks, k) for k in held}
    plain = {k: getattr(tks, k + "_plain") for k in held}

    def recorder(name):
        def call(*args):
            x = args[0]
            sig = ((tuple(x[0].shape), len(x), tuple(v.stride() for v in x))
                   if name == "masked_sum" else (tuple(x.shape), x.stride()))
            if sig in held[name]:
                return real[name](*args)
            held[name].add(sig)
            want = plain[name](*([x.clone()] + list(args[1:]))
                               if name == "add_lifted" else args)
            got = real[name](*args)
            assert torch.equal(got, want), (name, sig)
            return got
        return call

    try:
        for k in held:
            setattr(tks, k, recorder(k))
        B.boot.bootstrap(ct)
        torch.cuda.synchronize()
    finally:
        for k, f in real.items():
            setattr(tks, k, f)
    digits_rows = {s[0][-3:-1] for s in held["hoisted_mac"]}
    assert {(5, 94), (5, 92)} <= digits_rows, sorted(digits_rows)
    terms = {s[1] for s in held["masked_sum"]}
    assert {1, 8} <= terms, sorted(terms)
    assert held["add_lifted"]


def test_sealed_bootstrap_at_the_cell_chain_equals_plain_macs(cell_boot,
                                                             monkeypatch):
    """A sealed bootstrap (every stage a CUDA-graph replay, the MAC kernels
    inside the graphs) at the served ResNet's chain gives the words of the
    same bootstrap run eagerly with the plain MAC versions patched in, and
    counts every MAC call as a kernel launch."""
    from fhe_gpt2_tpu_torch.utils import telemetry
    B, ct, dec, z = cell_boot
    boot = B.boot
    boot.bootstrap_jitted(ct)            # warm passes and captures
    with telemetry.enable():
        got = boot.bootstrap_jitted(ct)  # replays
        torch.cuda.synchronize()
    c = telemetry.snapshot().counters
    telemetry.reset()
    assert c["mac.calls"] == c["mac.kernel"] > 0, c
    for k in ("hoisted_mac", "add_lifted", "masked_sum"):
        monkeypatch.setattr(tks, k, getattr(tks, k + "_plain"))
    want = boot.bootstrap(ct)
    assert got.scale == want.scale and got.level == want.level
    assert torch.equal(got.data, want.data)
    err = np.abs(np.real(dec.decrypt(got)) - z)
    assert err.mean() < 1e-3, err.mean()


# ---------------------------------------------------------------------------
# The dyadic kernels (csrc/dyadic.cu): the evaluator's tensor products,
# products, adds and batch sums
# ---------------------------------------------------------------------------

DYADIC = ("tensor_product", "mul_mod", "add_mod", "sub_mod", "neg_mod",
          "mod_sum")


def _dyadic_cases(t, lead, rng, lazy=False):
    """(name, kernel call, plain call) of every layout the evaluator gives
    the wrappers, on ciphertexts [2, *lead, l, N] of the rows of t."""
    cuda = t.q.device
    l, n = t.q.shape[0], t.n

    def w(mods, lead_):
        x = np.stack([rng.integers(0, (2 if lazy else 1) * q, size=lead_ + (n,),
                                   dtype=np.uint64).astype(np.uint32)
                      for q in mods], axis=-2)
        return word_tensor(x, cuda)

    a, b, a3 = w(t.moduli, (2, *lead)), w(t.moduli, (2, *lead)), \
        w(t.moduli, (3, *lead))
    p, pb = w(t.moduli, ()), w(t.moduli, lead)
    s3, pd = w(t.moduli, (2, *lead, 3)), w(t.moduli, (*lead, 1))
    s6, pd2 = w(t.moduli, (2, *lead, 2, 2)), w(t.moduli, (*lead, 1, 2))
    one = w(t.moduli, (2,))
    big = w(t.moduli + t.moduli[:4], (2, *lead))[..., :l, :]
    c = word_tensor(np.array([rng.integers(0, q) for q in t.moduli],
                             dtype=np.uint64)[:, None], cuda)
    T = tdyadic
    cases = [
        ("tensor", (T.tensor_product, a, b)),
        ("square", (T.tensor_product, a, a)),
        ("tensor_views", (T.tensor_product, big, a3[:2])),
        ("tensor_broadcast", (T.tensor_product, a, one)),
        ("mul", (T.mul_mod, a, b)), ("mul_plain", (T.mul_mod, a, p)),
        ("mul_mask_batch", (T.mul_mod, a, pb)),
        ("mul_mask_delta", (T.mul_mod, s3, pd)),
        ("mul_mask_groups", (T.mul_mod, s6, pd2)),
        ("mul_const", (T.mul_mod, big, c)),
        ("add", (T.add_mod, a, big)), ("add_relin", (T.add_mod, a3[:2], b)),
        ("sub", (T.sub_mod, a, b)), ("neg", (T.neg_mod, a3)),
        ("add_plain_rest", (T.add_mod, a[0], p), {"rest": a[1:]}),
        ("add_galois_rest", (T.add_mod, big[0], b[0]), {"rest": b[1:]}),
        ("sub_const_rest", (T.sub_mod, a3[0], c), {"rest": a3[1:]})]
    if lead:
        cases.append(("sum", (T.mod_sum, a), {"axis": 1}))
    out = []
    for name, (fn, *args), *kw in cases:
        kw = dict(kw[0]) if kw else {}
        plain = getattr(tdyadic, fn.__name__ + "_plain")
        out.append((name, lambda fn=fn, args=args, kw=kw: fn(*args, t, **kw),
                    lambda plain=plain, args=args, kw=kw: plain(*args, t,
                                                                **kw)))
    return out


@pytest.mark.parametrize("logn", [11, 15, 16])
@pytest.mark.parametrize("lead", [(), (2,), (2, 8)])
@pytest.mark.parametrize("lazy", [False, True])
def test_dyadic_kernels_equal_plain(cuda, logn, lead, lazy):
    """Every dyadic entry at every layout the evaluator gives it (rows of
    their own, a plaintext or a batched mask broadcast, a per-limb
    constant, limb-prefix views, component slices, a ciphertext's other
    components copied through, a batch sum) torch.equal to its plain
    version, on canonical words and on lazy ones in [0, 2q), each one
    launch."""
    t = nttmod.make_ntt_tables(primes.gen_primes_balanced(
        29, 22 if logn == 15 else 5, 2 << logn), 1 << logn, cuda)
    rng = np.random.default_rng(logn + len(lead) + lazy)
    for name, fn, plain in _dyadic_cases(t, lead, rng, lazy):
        before = _cuda.LAUNCHES["dyadic"]
        got = fn()
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["dyadic"] == before + 1, name
        want = plain()
        assert got.shape == want.shape and torch.equal(got, want), name


def test_dyadic_kernels_at_the_granite_batch(cuda):
    """The Granite cell's batches (2 x 128 ciphertexts of 50 limbs at
    N = 2^15): the tensor product, a constant product, c0 added with the
    other component copied, and the sum over the 128."""
    t = nttmod.make_ntt_tables(primes.gen_primes_balanced(
        27, 50, 1 << 16), 1 << 15, cuda)
    rng = np.random.default_rng(128)
    cases = {name: (fn, plain) for name, fn, plain
             in _dyadic_cases(t, (128,), rng)}
    for name in ("tensor", "square", "mul_const", "add_plain_rest", "sum"):
        fn, plain = cases[name]
        got = fn()
        want = plain()
        assert torch.equal(got, want), name
        del got, want
        torch.cuda.empty_cache()


def test_dyadic_kernels_refuse_other_layouts(cuda):
    """Rows off the 16-byte grid, strided words and batches that do not
    merge into two groups raise, and nothing launches."""
    t = _mac_tables(cuda, 11, 5)
    rng = np.random.default_rng(6)
    a = _residues(rng, t.moduli, (2, 3), t.n, cuda)
    before = _cuda.LAUNCHES["dyadic"]
    with pytest.raises(ValueError, match="16-byte"):
        tdyadic.mul_mod(_offset(a, 1), a, t)
    with pytest.raises(ValueError, match="16-byte"):
        tdyadic.tensor_product(a, _offset(a, 2), t)
    x = _residues(rng, t.moduli, (2, 3, 4, 5, 6), t.n, cuda)
    with pytest.raises(ValueError, match="4 strided groups"):
        tdyadic.add_mod(x.permute(0, 4, 3, 2, 1, 5, 6),
                        x.permute(0, 4, 3, 2, 1, 5, 6).contiguous(), t)
    with pytest.raises(ValueError):
        tdyadic.mod_sum(x.transpose(0, 2), t, axis=1)
    assert _cuda.LAUNCHES["dyadic"] == before


def test_dyadic_kernels_in_a_cuda_graph_equal_plain(cuda):
    """A tensor product, a constant product, a c0 add with its copy and a
    batch sum captured in one torch.cuda.graph: each replay, on inputs
    rewritten in place, gives the plain versions' words."""
    t = _mac_tables(cuda, 15, 24)
    n = t.n
    rng = np.random.default_rng(8)
    a = _residues(rng, t.moduli, (2, 4), n, cuda)
    b = _residues(rng, t.moduli, (2, 4), n, cuda)
    p = _residues(rng, t.moduli, (), n, cuda)
    c = word_tensor(np.array([7 + i for i in range(24)], dtype=np.uint64)
                    [:, None], cuda)

    def step(T):
        return (T.tensor_product(a, b, t), T.mul_mod(a, c, t),
                T.add_mod(a[0], p, t, rest=a[1:]), T.mod_sum(a, t, axis=1))

    class Plain:
        pass

    plain = Plain()
    for k in DYADIC:
        setattr(plain, k, getattr(tdyadic, k + "_plain"))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(tdyadic)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step(tdyadic)
    for seed in (9, 10):
        g = np.random.default_rng(seed)
        a.copy_(_residues(g, t.moduli, (2, 4), n, cuda))
        p.copy_(_residues(g, t.moduli, (), n, cuda))
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, step(plain)):
            assert torch.equal(got, want)


@contextlib.contextmanager
def _dyadic_held():
    """The dyadic wrappers replaced by recorders: the first call of each
    operand signature is also computed by the plain version on the same
    inputs and held torch.equal to it. Yields {wrapper: signatures}."""
    held = {k: set() for k in DYADIC}
    real = {k: getattr(tdyadic, k) for k in DYADIC}
    plain = {k: getattr(tdyadic, k + "_plain") for k in DYADIC}

    def sig(args, kw):
        return tuple((tuple(x.shape), x.stride())
                     if isinstance(x, torch.Tensor) else
                     len(x.moduli) if hasattr(x, "moduli") else x
                     for x in (*args, *kw.values())) + tuple(kw)

    def recorder(name):
        def call(*args, **kw):
            s = sig(args, kw)
            got = real[name](*args, **kw)
            if s not in held[name]:
                held[name].add(s)
                want = plain[name](*args, **kw)
                assert torch.equal(got, want), (name, s)
            return got
        return call

    try:
        for k in DYADIC:
            setattr(tdyadic, k, recorder(k))
        yield held
    finally:
        for k, f in real.items():
            setattr(tdyadic, k, f)


def test_dyadic_kernels_equal_plain_at_the_cell_bootstrap_shapes(cell_boot):
    """One eager bootstrap of the served ResNet with the dyadic wrappers
    recording: every signature held torch.equal to its plain version
    (EvalMod's products and squares, the constant products and adds, the
    lifted c0 of the unrotated baby step, the c0 adds of the rotations)."""
    B, ct, _, _ = cell_boot
    with _dyadic_held() as held:
        B.boot.bootstrap(ct)
        torch.cuda.synchronize()
    for k in ("tensor_product", "mul_mod", "add_mod"):
        assert held[k], (k, held)


def test_sealed_bootstrap_at_the_cell_chain_equals_plain_dyadic(cell_boot,
                                                               monkeypatch):
    """A sealed bootstrap (the dyadic kernels inside the graphs) at the
    served ResNet's chain gives the words of the same bootstrap run eagerly
    with the plain dyadic versions patched in, and counts every dyadic
    call as a kernel launch."""
    from fhe_gpt2_tpu_torch.utils import telemetry
    B, ct, dec, z = cell_boot
    boot = B.boot
    boot.bootstrap_jitted(ct)            # warm passes and captures
    with telemetry.enable():
        got = boot.bootstrap_jitted(ct)  # replays
        torch.cuda.synchronize()
    c = telemetry.snapshot().counters
    telemetry.reset()
    assert c["dyadic.calls"] == c["dyadic.kernel"] > 0, c
    for k in DYADIC:
        monkeypatch.setattr(tdyadic, k, getattr(tdyadic, k + "_plain"))
    want = boot.bootstrap(ct)
    assert got.scale == want.scale and got.level == want.level
    assert torch.equal(got.data, want.data)
    err = np.abs(np.real(dec.decrypt(got)) - z)
    assert err.mean() < 1e-3, err.mean()


def test_dyadic_kernels_equal_plain_in_a_gpt2_block(cuda):
    """A toy GPT-2 block (its LayerNorms, the attention over the Δ batch
    and the MLP) with the dyadic wrappers recording: every signature held
    to its plain version, the batch sums among them."""
    with _dyadic_held() as held:
        _gpt2_block_run(cuda)
        torch.cuda.synchronize()
    for k in ("tensor_product", "mul_mod", "add_mod", "mod_sum"):
        assert held[k], (k, held)


def test_dyadic_kernels_equal_plain_in_a_tiny_granite_core(cuda, tmp_path):
    """One request of the granite4h.ssd16 driver at a tiny width (hidden
    64, 8 tokens, logN = 10, 10 pairs) with the dyadic wrappers recording:
    the conv and SSD sums over Δ, the decay products and the gated norm's
    ops held to their plain versions."""
    import json

    from fhe_bench import drivers, harness
    spec = harness.load_spec()
    _, cfg, traffic = harness.cell(spec, "granite4h.ssd16")
    cfg = dict(cfg, hidden_size=64, mamba_n_heads=16, mamba_d_head=8,
               mamba_d_state=8, vocab_size=997)
    flags = ["--seq", "8", "--hidden", "64", "--composite", "--logn", "10",
             "--levels", "10", "--log-scale", "54", "--nsp", "4",
             "--digit-keys"]
    traffic = dict(json.loads(json.dumps(traffic)), seq=8, pool=2)
    drv = drivers.load(traffic["driver"]).Driver(cfg, traffic, 3000000019,
                                                 "cuda", flags)
    drv.setup()
    with _dyadic_held() as held:
        drv.request(0)
        torch.cuda.synchronize()
    for k in ("tensor_product", "mul_mod", "add_mod", "mod_sum"):
        assert held[k], (k, held)
