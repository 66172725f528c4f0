"""The cluster key switch and mod-down on the CPU: their launch geometry
(pure Python, ``tks.cluster_sizes`` / ``cluster_threads`` / ``cluster_for``
/ ``ctas_per_sm``, the last held to the kernels' launch bound in the
sources) and the table words their kernels read, held bit for bit against the JAX
package's ``FusedKsTables`` / ``FusedMdTables`` fields.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu.core import context as jcontext
from fhe_gpt2_tpu.core.context import CkksContext as JContext
from fhe_gpt2_tpu.core.context import CkksParams as JParams

from fhe_gpt2_tpu_torch.carry import to_numpy
from fhe_gpt2_tpu_torch.core import context as tcontext, tks
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams

CPU = "cpu"
SMEM_PER_BLOCK = 232448      # bytes of shared memory one H100 block may use
H100_SMS = 132
# Clusters per launch on the main path: the key switch's J = 30 key limbs at
# batch 1 and 2, the mod-down's [2, 22] and [3, 2, 22] output limbs, the
# composite pair's [2, 8], and the small chains of the tests.
MAIN_CLUSTERS = (1, 2, 6, 7, 8, 16, 30, 44, 60, 132, 264)


@pytest.mark.parametrize("logn", range(11, 17))
def test_cluster_sizes_fit_one_cta(logn):
    sizes = tks.cluster_sizes(logn)
    assert sizes and all(c in (1, 2, 4, 8) for c in sizes)
    for c in sizes:
        words = (1 << logn) // c
        threads = tks.cluster_threads(logn, c)
        assert words * 4 <= SMEM_PER_BLOCK
        assert 0 < threads <= tks.CLUSTER_THREADS and threads % 32 == 0
        assert words % threads == 0
        assert words // threads in (2, 4, 8, 16)


@pytest.mark.parametrize("logn", range(11, 17))
@pytest.mark.parametrize("sms", [H100_SMS, 114, 1])
def test_cluster_for_picks_a_size_the_kernels_take(logn, sms):
    sizes = tks.cluster_sizes(logn)
    for clusters in MAIN_CLUSTERS:
        c = tks.cluster_for(logn, clusters, sms)
        assert c in sizes and c & (c - 1) == 0 and c <= tks.MAX_CLUSTER

        def cost(cc):   # waves of CTAs x words per thread (cluster_for)
            w = (1 << logn) // cc // tks.cluster_threads(logn, cc)
            return -(-clusters * cc // (sms * tks.ctas_per_sm(w))) * w
        assert all(cost(c) <= cost(o) for o in sizes)


_CSRC = Path(tks.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("words", [2, 4, 8, 16])
def test_ctas_per_sm_matches_the_kernels_launch_bound(words):
    # cluster_for's occupancy is the kernels' __launch_bounds__ minimum,
    # defined once in the header as `W <= a ? b : c`.
    src = (_CSRC / "ntt_cluster.cuh").read_text()
    m = re.search(r"constexpr int cluster_ctas_per_sm\(int W\) \{ "
                  r"return W <= (\d+) \? (\d+) : (\d+); \}", src)
    assert m, "cluster_ctas_per_sm not found in ntt_cluster.cuh"
    most, lo, hi = map(int, m.groups())
    assert tks.ctas_per_sm(words) == (lo if words <= most else hi)
    assert tks.ctas_per_sm(words) * tks.CLUSTER_THREADS <= 2048


@pytest.mark.parametrize("source", ["ntt.cu", "keyswitch.cu", "moddown.cu"])
def test_cluster_kernels_take_the_shared_launch_bound(source):
    src = (_CSRC / source).read_text()
    assert re.search(r"__launch_bounds__\(kClusterThreads, "
                     r"cluster_ctas_per_sm\(W\)\)", src), source
    assert "__launch_bounds__" not in src.replace(
        "__launch_bounds__(kClusterThreads, cluster_ctas_per_sm(W))", "")


def test_cluster_geometry_at_the_main_shapes():
    # A limb of 2^16 words does not fit one CTA's shared memory.
    assert min(tks.cluster_sizes(16)) >= 2
    # logN=15: the key switch (J=30 at M=1 and 2) and the mod-down ([2, 22])
    # take clusters of 8 CTAs of 512 threads with 8 words each, two per SM.
    for clusters in (30, 60, 44):
        assert tks.cluster_for(15, clusters, H100_SMS) == 8
    assert tks.cluster_threads(15, 8) == tks.CLUSTER_THREADS
    assert (1 << 15) // 8 // tks.CLUSTER_THREADS == 8
    with pytest.raises(ValueError):
        tks.cluster_sizes(17)


def _rand(mods, lead, n, seed):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
                  .astype(np.uint32) for q in mods], axis=-2)
    return torch.from_numpy(x.view(np.int32))


@pytest.mark.parametrize("cluster", [3, 16])
def test_wrappers_refuse_a_cluster_size_the_kernels_lack(cluster):
    ctx = CkksContext(tcontext.test_params_w32(logn=10, levels=2), device=CPU)
    lv = ctx.L
    ft = ctx.fused_ks_tables(lv)
    kt = ctx.tables(ctx.key_limbs(lv))
    c = _rand(ctx.moduli[:lv], (), ctx.n, 1)
    kdata = _rand(kt.moduli, (2, ft.D), ctx.n, 2)
    with pytest.raises(ValueError, match="cluster"):
        tks.fused_switch_key(c, kdata, ctx.tables(lv), kt, ft, cluster=cluster)
    x = _rand(ctx.moduli[:lv] + ctx.special, (2,), ctx.n, 3)
    md = (ctx.tables(tuple(ctx.L + i for i in range(ctx.k_sp))),
          ctx.tables(lv), ctx.fused_md_tables(lv))
    with pytest.raises(ValueError, match="cluster"):
        tks.fused_mod_down(x, *md, cluster=cluster)
    # A size the kernels take is accepted; on the CPU it is the plain version.
    ok = tks.cluster_sizes(ctx.logn)[-1]
    assert torch.equal(tks.fused_mod_down(x, *md, cluster=ok),
                       tks.mod_down_plain(x, *md))


@pytest.fixture(scope="module", params=["w32", "composite"])
def chains(request):
    if request.param == "w32":
        ref_p, got_p = jcontext.test_params_w32(), tcontext.test_params_w32()
    else:
        kw = dict(logn=11, num_levels=3, num_special=3, hamming_weight=16)
        ref_p, got_p = JParams.create_composite(**kw), \
            CkksParams.create_composite(**kw)
    return JContext(ref_p), CkksContext(got_p, device=CPU)


def _bits(a) -> np.ndarray:
    """The 32-bit words of a table, raveled, whatever their dtype."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint32).ravel() if a.dtype.itemsize == 4 else a.ravel()


def _shoup(w, q) -> np.ndarray:
    """floor(w * 2^32 / q) as uint32, from uint32 words and moduli."""
    w, q = w.astype(np.uint64), np.broadcast_to(q, w.shape).astype(np.uint64)
    return ((w << np.uint64(32)) // q).astype(np.uint32)


def test_ks_kernel_words_equal_reference(chains):
    ref, got = chains
    for lv in range(1, got.L + 1):
        fr, fg = ref.fused_ks_tables(lv), got.fused_ks_tables(lv)
        assert (fr.D, fr.A) == (fg.D, fg.A), lv
        assert fg.gather.dtype == torch.int32 and fg.own.dtype == torch.int32
        assert np.asarray(fr.gather).dtype == np.int32
        for f in ("own", "gather", "pw", "inv_punc", "inv_punc_shoup", "src_q"):
            assert np.array_equal(_bits(np.asarray(getattr(fr, f))),
                                  _bits(to_numpy(getattr(fg, f)))), (lv, f)
        # The kernel's own words: Shoup of pw[d, j, a] for q_j, and the
        # Montgomery words of q_j (-q^-1 mod 2^32, 2^32 mod q, its Shoup).
        q = np.asarray(fr.q3).reshape(1, -1, 1)
        assert np.array_equal(_shoup(np.asarray(fr.pw), q),
                              to_numpy(fg.pw_shoup)), lv
        q = q.ravel().astype(np.uint64)
        qneg, r32, r32s = to_numpy(fg.mont).astype(np.uint64)
        assert np.all((q * qneg) % (1 << 32) == (1 << 32) - 1), lv
        assert np.array_equal(r32, (1 << 32) % q), lv
        assert np.array_equal(r32s, _shoup(r32, q)), lv


# The words md_fused reads: (port ModDownTables path, JAX FusedMdTables field).
_MD_WORDS = (("half_p", "half_p"), ("bct.inv_punc", "inv_punc"),
             ("bct.inv_punc_shoup", "inv_punc_shoup"), ("bct.src_q", "src_q"),
             ("bct.punc_mod_dst", "punc"), ("p_invf", "pinvf"),
             ("p_mod_q", "pmodq"), ("half_q", "halfq"), ("inv_p", "invp"),
             ("inv_p_shoup", "invps"))


def _field(obj, path):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def test_md_kernel_words_equal_reference(chains):
    ref, got = chains
    cases = [(lv, False) for lv in range(1, got.L + 1)]
    if got.rescale_limbs > 1:
        cases += [(lv, True) for lv in range(got.rescale_limbs + 1, got.L + 1)]
    for lv, pair in cases:
        fr, fg = ref.fused_md_tables(lv, pair=pair), \
            got.fused_md_tables(lv, pair=pair)
        assert (fg.k, fg.l) == np.asarray(fr.punc).shape, (lv, pair)
        assert fg.mdt.p_invf.dtype == torch.float32
        for mine, theirs in _MD_WORDS:
            want = np.asarray(getattr(fr, theirs))
            have = _field(fg.mdt, mine)
            have = have.numpy() if have.dtype == torch.float32 \
                else to_numpy(have)
            assert np.array_equal(_bits(want), _bits(have)), (lv, pair, mine)
        # The kernel's own words: Shoup of punc[i, j] and of P mod q_j.
        q = np.asarray(fr.q3).reshape(1, -1)
        assert np.array_equal(_shoup(np.asarray(fr.punc), q),
                              to_numpy(fg.punc_shoup)), (lv, pair)
        assert np.array_equal(_shoup(np.asarray(fr.pmodq).reshape(-1, 1),
                                     q.reshape(-1, 1)),
                              to_numpy(fg.p_mod_q_shoup)), (lv, pair)
