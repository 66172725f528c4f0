"""The port's NTT wrappers on the CPU: the cluster geometry the NTT kernels
launch with (pure Python, ``tntt.cluster_for`` at the main path's row
counts), the layouts the kernels read in place (``tntt.lead_stride``), the
cluster sizes the wrappers refuse, and the plain versions of a limb slice
held bit for bit against the JAX package's four-step Pallas kernels in
interpret mode.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fhe_gpt2_tpu.core import ntt as jntt
from fhe_gpt2_tpu.core import tntt as jtntt

from fhe_gpt2_tpu_torch.carry import to_numpy
from fhe_gpt2_tpu_torch.core import ntt as nttmod
from fhe_gpt2_tpu_torch.core import primes, tks, tntt
from fhe_gpt2_tpu_torch.core.context import CkksParams
from fhe_gpt2_tpu_torch.core.modmath import word_tensor

CPU = "cpu"
H100_SMS = 132
# Rows of one (i)NTT call on the main path: the rescale's last limb, the
# composite pair, the special limbs [2, 8], the level [22], the rescale's
# [2, 21], the mod-down's [2, 22], and a batch.
NTT_ROWS = (1, 2, 16, 22, 42, 44, 132)


def _cost(logn, rows, c, sms=H100_SMS):
    """(waves, words per thread) of one NTT launch of `rows` rows at C."""
    w = (1 << logn) // c // tntt.cluster_threads(logn, c)
    return -(-rows * c // (sms * tntt.ctas_per_sm(w))), w


@pytest.mark.parametrize("rows", NTT_ROWS)
@pytest.mark.parametrize("logn", range(11, 17))
def test_ntt_cluster_for_picks_a_size_the_kernels_take(logn, rows):
    sizes = tntt.cluster_sizes(logn)
    c = tntt.cluster_for(logn, rows, H100_SMS)
    assert c in sizes and c & (c - 1) == 0 and c <= tntt.MAX_CLUSTER
    threads = tntt.cluster_threads(logn, c)
    assert ((1 << logn) // c) % threads == 0
    assert (1 << logn) // c // threads in (2, 4, 8, 16)
    best = min(w * waves for waves, w in (_cost(logn, rows, o) for o in sizes))
    waves, w = _cost(logn, rows, c)
    assert waves * w == best


def test_ntt_cluster_at_the_main_shapes():
    """logN = 15: C = 4 puts 16 words on each of 512 threads and one CTA on
    an SM; C = 8 puts 8 words and two CTAs on an SM, so it is one wave of
    half the work per thread for every main-path row count."""
    assert tntt.cluster_sizes(15) == (4, 8)
    assert _cost(15, 22, 4) == (1, 16) and _cost(15, 22, 8) == (1, 8)
    assert 22 * 8 <= H100_SMS * tntt.ctas_per_sm(8)         # 176 CTAs
    for rows in (22, 16, 42, 2):
        assert tntt.cluster_for(15, rows, H100_SMS) == 8, rows
    assert _cost(15, 42, 8) == (2, 8) and _cost(15, 42, 4) == (2, 16)
    # logN = 16 has only C = 8 (a 256 KB limb fits no CTA, nor four).
    assert tntt.cluster_sizes(16) == (8,)


def test_geometry_names_stay_importable_from_tks():
    for name in ("cluster_sizes", "cluster_threads", "ctas_per_sm",
                 "cluster_for", "_sms", "MAX_CLUSTER", "CLUSTER_THREADS"):
        assert getattr(tks, name) is getattr(tntt, name), name


@pytest.mark.parametrize("logn,cluster", [(11, 3), (11, 16), (16, 4)])
def test_ntt_wrappers_refuse_a_cluster_size_the_kernels_lack(logn, cluster):
    n = 1 << logn
    t = nttmod.make_ntt_tables([primes.gen_primes(25, 1, 2 * n)[0]], n,
                               device=CPU)
    x = torch.zeros((2, 1, n), dtype=torch.int32)
    for fn in (tntt.ntt_forward, tntt.ntt_inverse):
        with pytest.raises(ValueError, match="cluster"):
            fn(x, t, cluster=cluster)
    ok = tntt.cluster_sizes(logn)[-1]
    assert torch.equal(tntt.ntt_forward(x, t, cluster=ok), x)


def _full(shape):
    return torch.zeros(shape, dtype=torch.int32)


# (operand, the L' the kernels read it with)
_VIEWS = {
    "contiguous": (lambda: _full((2, 3, 64)), 3),
    "one row": (lambda: _full((5, 64))[1:3], 2),
    "last limb": (lambda: _full((2, 6, 64))[..., -1:, :], 6),
    "dropped limbs": (lambda: _full((3, 2, 30, 64))[..., 22:, :], 30),
    "size-1 lead": (lambda: _full((1, 2, 8, 64))[:, :, 2:5], 8),
    "leading limbs": (lambda: _full((2, 8, 64))[:, :3], 8),
}


@pytest.mark.parametrize("view", sorted(_VIEWS))
def test_lead_stride_of_limb_slices(view):
    make, lp = _VIEWS[view]
    x = make()
    assert tntt.lead_stride(x) == lp
    # Row (m, j) is limb m*L' + j after x's first word.
    base = x.storage_offset()
    *lead, L, n = x.shape
    idx = torch.arange(x.untyped_storage().nbytes() // 4).reshape(-1)
    got = idx.as_strided(x.shape, x.stride(), base)
    rows = got.reshape(-1, L, n)
    for m in range(rows.shape[0]):
        for j in range(L):
            assert int(rows[m, j, 0]) == base + (m * lp + j) * n


@pytest.mark.parametrize("bad", ["limbs transposed", "lead transposed",
                                 "broadcast lead", "strided words",
                                 "strided limbs"])
def test_lead_stride_refuses_other_layouts(bad):
    x = {"limbs transposed": lambda: _full((3, 2, 64)).transpose(0, 1),
         "lead transposed": lambda: _full((3, 2, 2, 64)).transpose(0, 1),
         "broadcast lead": lambda: _full((1, 2, 64)).expand(3, 2, 64),
         "strided words": lambda: _full((2, 2, 128))[..., ::2],
         "strided limbs": lambda: _full((2, 6, 64))[:, ::2]}[bad]()
    assert not x.is_contiguous()
    with pytest.raises(ValueError, match="limb slice"):
        tntt.lead_stride(x)


_CHAINS = {
    "w32": lambda: CkksParams.create(logn=11, log_q0=29, log_scale=25,
                                     num_levels=5, log_special=31,
                                     num_special=2),
    "composite": lambda: CkksParams.create_composite(logn=11, num_levels=3,
                                                     num_special=3),
}


@pytest.fixture(scope="module", params=sorted(_CHAINS))
def chain_tables(request):
    p = _CHAINS[request.param]()
    mods = list(p.moduli) + list(p.special)
    return (len(p.moduli), jntt.make_ntt_tables(mods, p.n, fourstep=True),
            nttmod.make_ntt_tables(mods, p.n, device=CPU))


@pytest.mark.parametrize("part", ["last limb", "special limbs", "middle"])
def test_ntt_of_a_limb_slice_equals_fourstep(chain_tables, part):
    """ntt_forward / ntt_inverse of the limbs [a, a+L) of a contiguous
    [2, L', N] tensor, given as a view, equal the Pallas four-step kernels
    (interpret mode) on the same limbs."""
    l, ref, got = chain_tables
    total = len(got.moduli)
    a, L = {"last limb": (l - 1, 1), "special limbs": (l, total - l),
            "middle": (1, 2)}[part]
    idx = list(range(a, a + L))
    rng = np.random.default_rng(a * 10 + L)
    full = np.stack([rng.integers(0, q, size=(2, got.n), dtype=np.uint64)
                     .astype(np.uint32) for q in got.moduli], axis=-2)
    xs = word_tensor(full, CPU)[..., a:a + L, :]
    assert not xs.is_contiguous()
    sub_ref, sub_got = ref.slice(idx), got.slice(idx)
    want_f = np.asarray(jtntt.fourstep_ntt(jnp.asarray(full[..., a:a + L, :]),
                                           sub_ref.fs, interpret=True))
    want_i = np.asarray(jtntt.fourstep_intt(jnp.asarray(full[..., a:a + L, :]),
                                            sub_ref.fs, interpret=True))
    assert np.array_equal(to_numpy(tntt.ntt_forward(xs, sub_got)), want_f)
    assert np.array_equal(to_numpy(tntt.ntt_inverse(xs, sub_got)), want_i)
    assert np.array_equal(to_numpy(tntt.ntt_inverse(
        word_tensor(want_f, CPU), sub_got)), full[..., a:a + L, :])
