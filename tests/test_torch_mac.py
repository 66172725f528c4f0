"""The multiply-accumulate wrappers of ``core/tks.py`` (``hoisted_mac``,
``add_lifted``, ``masked_sum``) on the CPU, where they take their plain
versions: held against the torch ops the LT engine ran before them
(``index_select`` + ``_ks_mac_core``, the P·c0 lift by ``mul_mod_shoup``,
``add_mod``, ``cat`` and ``stack``), against sums of exact products in
numpy, and against the JAX package's ``_ks_mac_core`` and stacked
``mul_mod`` + ``mod_sum``. Tolerance: exact (every comparison is on the
words). The kernels run only on the card (tests/test_torch_cuda.py); here
the Galois permutation's block structure, which their gather relies on, is
checked at every ring size the card runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_gpt2_tpu.core import evaluator as jev
from fhe_gpt2_tpu.core import modmath as jmm
from fhe_gpt2_tpu.core import ntt as jntt
from fhe_gpt2_tpu_torch.core import _cuda, primes, tks
from fhe_gpt2_tpu_torch.core import ntt as nttmod
from fhe_gpt2_tpu_torch.core.modmath import add_mod, mul_mod_shoup, shoup, \
    word_tensor
from fhe_gpt2_tpu_torch.nn import backend as NB
from fhe_gpt2_tpu_torch.utils import telemetry

N = 256
J = 5                 # rows: 3 data rows, then 2 special rows
R = 3


@pytest.fixture(scope="module")
def chain():
    """30-bit NTT primes (the products of the largest words pass 2**59),
    both packages' tables of them."""
    moduli = primes.gen_primes_balanced(30, J, 2 * N)
    return (moduli, nttmod.make_ntt_tables(moduli, N, "cpu"),
            jntt.make_ntt_tables(moduli, N))


def _words(rng, moduli, lead, n=N, top=False):
    """Residues [*lead, len(moduli), n] as uint64 numpy; top: the largest
    word q-1 in every other slot."""
    x = np.stack([rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
                  for q in moduli], axis=-2)
    if top:
        qs = np.array(moduli, dtype=np.uint64)[:, None]
        x[..., ::2] = (qs - 1) * np.ones_like(x[..., ::2])
    return x


def _u32(x):
    return word_tensor(x, "cpu")


def _ref_sum(terms, moduli):
    """Σ a·b mod q over (a, b) uint64 pairs [..., J, n], each product
    reduced before the sum (products < 2**62, sums of < 2**32 of them)."""
    qs = np.array(moduli, dtype=np.uint64)[:, None]
    acc = sum((a * b) % qs for a, b in terms)
    return acc % qs


def _perm(elt, n=N):
    return torch.from_numpy(
        nttmod.galois_ntt_permutation(n, elt).astype(np.int64))


def _counts():
    c = telemetry.snapshot().counters
    return c.get("mac.calls", 0), c.get("mac.kernel", 0)


@pytest.mark.parametrize("D", [1, 3, 5])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_hoisted_mac_plain_route(chain, D, lead):
    """tks.hoisted_mac on the CPU = the gather + _ks_mac_core it replaced,
    the exact sum, and the JAX _ks_mac_core; counted as a call, not as a
    kernel launch."""
    moduli, t, jt = chain
    rng = np.random.default_rng(D + len(lead))
    tp = _words(rng, moduli, lead + (D,), top=True)
    key = _words(rng, moduli, (2, D), top=True)
    elt = pow(5, 3, 2 * N)
    perm = _perm(elt)
    telemetry.reset()
    launched = _cuda.LAUNCHES["mac"]
    with telemetry.enable():
        got = tks.hoisted_mac(_u32(tp), _u32(key), perm, t)
    assert _counts() == (1, 0) and _cuda.LAUNCHES["mac"] == launched
    telemetry.reset()
    assert got.shape == (2, *lead, J, N)
    before = tks._ks_mac_core(_u32(tp).index_select(-1, perm), _u32(key), t)
    assert torch.equal(got, before)
    tpp = tp[..., perm.numpy()]
    kb = key.reshape(2, *(1,) * len(lead), D, J, N)
    want = np.stack([_ref_sum([(tpp[..., d, :, :], kb[c][..., d, :, :])
                               for d in range(D)], moduli)
                     for c in range(2)])
    assert np.array_equal(got.numpy().view(np.uint32), want.astype(np.uint32))
    jgot = jev._ks_mac_core(jnp.asarray(tpp.astype(np.uint32)),
                            jnp.asarray(key.astype(np.uint32)), jt)
    assert np.array_equal(np.asarray(jgot), want.astype(np.uint32))


@pytest.mark.parametrize("lead", [(), (2,)])
def test_add_lifted_plain_route(chain, lead):
    """The c0 epilogue: P·c0 permuted, added to the data rows of the first
    component; the special rows and the second component as they were."""
    moduli, t, _ = chain
    rng = np.random.default_rng(7 + len(lead))
    acc = _words(rng, moduli, (2,) + lead, top=True)
    c0 = _words(rng, moduli[:R], lead, top=True)
    P = 2 ** 61 + 1
    p_res = [P % q for q in moduli]
    p = _u32(np.array(p_res, dtype=np.uint64)[:, None])
    ps = _u32(np.array([shoup(v, q) for v, q in zip(p_res, moduli)],
                       dtype=np.uint64)[:, None])
    q = t.q[:R]
    perm = _perm(2 * N - 1)
    got = tks.add_lifted(_u32(acc), _u32(c0), perm, p, ps, q)
    a = _u32(acc)
    pc0 = mul_mod_shoup(_u32(c0).index_select(-1, perm), p[:R], ps[:R], q)
    before = torch.stack([torch.cat([add_mod(a[0][..., :R, :], pc0, q),
                                     a[0][..., R:, :]], dim=-2), a[1]])
    assert torch.equal(got, before)
    qs = np.array(moduli[:R], dtype=np.uint64)[:, None]
    lift = (c0[..., perm.numpy()] * np.array(p_res[:R], dtype=np.uint64)[:, None]) % qs
    want = acc.copy()
    want[0][..., :R, :] = (acc[0][..., :R, :] + lift) % qs
    assert np.array_equal(got.numpy().view(np.uint32), want.astype(np.uint32))


@pytest.mark.parametrize("T", [1, 8, 9, 63])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_masked_sum_plain_route(chain, T, lead):
    """Σ values[t]·masks[t]: tks.masked_sum and the backend's _masked_sum
    on the CPU = the exact sum and the JAX package's stacked mul_mod +
    mod_sum, over terms among which are strided views: components of a
    stacked batch (``e[:, bi]``, as ``lt_hoist_ext`` hands them on) and
    row slices of wider words (``mul_plain_many_sum``'s)."""
    moduli, t, jt = chain
    rng = np.random.default_rng(T + 100 * len(lead))
    stacked = _words(rng, moduli, (2, 4) + lead, top=True)   # [2, 4, *B, J, N]
    wide = _words(rng, moduli + moduli[:2], (2,) + lead)       # J + 2 rows
    vals, terms = [], []
    st, wt = _u32(stacked), _u32(wide)
    for i in range(T):
        kind = i % 3
        if kind == 0:
            v = _words(rng, moduli, (2,) + lead, top=i % 2 == 0)
            vals.append(_u32(v))
        elif kind == 1:
            v = stacked[:, i % 4]
            vals.append(st[:, i % 4])
        else:
            v = wide[..., :J, :]
            vals.append(wt[..., :J, :])
        terms.append(v)
    masks = [_words(rng, moduli, (), top=i % 2 == 1) for i in range(T)]
    pts = [_u32(m) for m in masks]
    assert all(v.is_contiguous() for v in vals) == (T == 1)
    got = tks.masked_sum(vals, pts, t)
    assert got.shape == (2, *lead, J, N)
    assert torch.equal(NB._masked_sum(vals, pts, t), got)
    want = _ref_sum(list(zip(terms, masks)), moduli)
    assert np.array_equal(got.numpy().view(np.uint32), want.astype(np.uint32))
    jv = jnp.stack([jnp.asarray(v.astype(np.uint32)) for v in terms], axis=1)
    jp = jnp.stack([jnp.asarray(m.astype(np.uint32)) for m in masks])
    jp = jp.reshape(T, *(1,) * len(lead), J, N)
    jgot = jev.mod_sum(jmm.mul_mod(jv, jp, jt.q, jt.ratio0, jt.ratio1), jt.q,
                       jt.ratio1, axis=1)
    assert np.array_equal(np.asarray(jgot), want.astype(np.uint32))


def test_u64_words_keep_the_torch_route():
    """int64 words (the u64 engine) run the torch ops of each wrapper on
    any device: exact against Python-int sums, counted as calls and never
    as kernel launches."""
    n = 64
    moduli = primes.gen_primes_balanced(55, 3, 2 * n)
    t = nttmod.make_ntt_tables(moduli, n, "cpu")
    assert t.q.dtype == torch.int64
    rng = np.random.default_rng(64)

    def words(lead):
        """Residues [*lead, 3, n] as Python ints, the largest word q-1 in
        slot 0."""
        x = np.stack([rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
                      for q in moduli], axis=-2)
        x[..., 0] = np.array(moduli, dtype=np.uint64) - 1
        return x.astype(object)

    def tensor(x):
        return word_tensor(x.astype(np.uint64), "cpu", word=np.uint64)

    qs = np.array(moduli, dtype=object)[:, None]
    D = 3
    tp, key = words((D,)), words((2, D))
    perm = _perm(5, n)
    telemetry.reset()
    launched = _cuda.LAUNCHES["mac"]
    with telemetry.enable():
        got = tks.hoisted_mac(tensor(tp), tensor(key), perm, t)
        vals = [words((2,)) for _ in range(9)]
        masks = [words((1,))[0] for _ in range(9)]
        ms = tks.masked_sum([tensor(v) for v in vals],
                            [tensor(m) for m in masks], t)
    assert _counts() == (2, 0) and _cuda.LAUNCHES["mac"] == launched
    telemetry.reset()
    tpp = tp[..., perm.numpy()]
    want = np.stack([sum(tpp[d] * key[c, d] for d in range(D)) % qs
                     for c in range(2)])
    assert np.array_equal(got.numpy().view(np.uint64), want.astype(np.uint64))
    want = sum(v * m for v, m in zip(vals, masks)) % qs
    assert np.array_equal(ms.numpy().view(np.uint64), want.astype(np.uint64))


@pytest.mark.parametrize("logn", [11, 12, 13, 14, 15, 16])
def test_galois_maps_aligned_blocks_onto_aligned_blocks(logn):
    """The MAC kernel's gather stages one source block of B = 8·threads
    words per output block: every automorphism the port rotates or
    conjugates by maps each aligned block of B NTT slots onto one aligned
    block (the kernel reads an entry outside it from device memory, so
    this is its speed, not its exactness)."""
    n = 1 << logn
    B = 8 * tks._mac_threads(n)
    for elt in (5, pow(5, 7, 2 * n), pow(5, 1234, 2 * n), pow(5, n // 2 - 1, 2 * n),
                2 * n - 1):
        perm = nttmod.galois_ntt_permutation(n, elt).astype(np.int64)
        blocks = perm.reshape(-1, B) // B
        assert (blocks == blocks[:, :1]).all(), elt
        assert sorted(blocks[:, 0]) == list(range(n // B)), elt
