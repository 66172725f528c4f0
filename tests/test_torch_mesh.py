"""The port's (data, limb) mesh (fhe_gpt2_tpu_torch/parallel/) on repeated
CPU devices, against the JAX package under its own mesh
(fhe_gpt2_tpu/parallel/mesh.py), case for case with tests/test_mesh.py,
and the port's own mesh cases: a u64 test_params chain, positions that hold
no data limb, the key switch and mod-down on a position's rows, the mesh
shapes and a failing position.

Every comparison is exact: the mesh runs the port's own program with its
collectives written out, so the gathered words are the single-device words
and the JAX package's.
"""

import threading
import time

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu.core.context import test_params as jtest_params
from fhe_gpt2_tpu.core.evaluator import Ciphertext as JCiphertext

from fhe_gpt2_tpu_torch import carry
from fhe_gpt2_tpu_torch.core import tks
from fhe_gpt2_tpu_torch.core import context as tcontext
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Ciphertext, Encryptor, \
    Evaluator
from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
from fhe_gpt2_tpu_torch.parallel.limbs import LimbView, limb_key, tables_on
from fhe_gpt2_tpu_torch.parallel.mesh import MeshEvaluator, ct_sharding, \
    gather_ciphertext, make_mesh, replicated, shard_ciphertext

from torch_mesh_common import DEVICES, LEVELS, N_BATCH, jax_on_mesh, \
    mesh_pair, port_on_mesh
from torch_port_common import CPU, single_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    return mesh_pair(level=LEVELS)


def _jstep(ev, scale):
    """tests/test_mesh.py's step."""
    def step(data):
        c = JCiphertext(data, scale)
        m = ev.rescale(ev.multiply(c, c))
        r = ev.rotate(m, 1)
        return ev.add(r, ev.rotate(m, 3)).data
    return step


def _step(ev, c):
    """The same step on the port."""
    m = ev.rescale(ev.multiply(c, c))
    return ev.add(ev.rotate(m, 1), ev.rotate(m, 3))


def test_limb_sharded_keyswitch_matches_single_device(setup):
    """mult+relin+rescale+rotations on a (data=4 x limb=2) mesh: the
    gathered words are the JAX package's under its mesh and the port's
    single-device run."""
    ref, got = setup["ref"], setup["got"]
    want = jax_on_mesh(_jstep(ref["ev"], ref["ct"].scale), ref["ct"],
                       4, 2)
    out = port_on_mesh(_step, got["ev"], got["ct"], 4, 2)
    assert out.level == LEVELS - 1
    assert np.array_equal(carry.to_numpy(out), want), "SPMD result differs"
    assert torch.equal(out.data, _step(got["ev"], got["ct"]).data)


def test_data_sharded_batch_forward_decrypts_correctly(setup):
    """The data axis is pure DP (data=4 x limb=1): the JAX package's words
    under its mesh, and every batch element's decrypt within 1e-6 of the
    plaintext oracle."""
    ref, got = setup["ref"], setup["got"]
    want = jax_on_mesh(_jstep(ref["ev"], ref["ct"].scale), ref["ct"],
                       4, 1)
    out = port_on_mesh(_step, got["ev"], got["ct"], 4, 1)
    assert np.array_equal(carry.to_numpy(out), want)
    ctx = got["ctx"]
    assert out.scale == got["ct"].scale ** 2 / ctx.moduli[LEVELS - 1]
    for b in range(N_BATCH):
        back = np.real(got["dec"].decrypt(Ciphertext(out.data[:, b],
                                                     out.scale)))
        z = setup["zs"][b]
        expect = np.roll(z * z, -1) + np.roll(z * z, -3)
        assert np.abs(back - expect).max() < 1e-6, b


@pytest.mark.parametrize("n_data,n_limb", [(1, 2), (2, 2)])
def test_u64_test_params_chain_on_a_limb_axis(n_data, n_limb):
    """The u64 engine at test_params(10, 4) (51-bit special prime):
    mult+relin+rescale+rotate on a limb axis of 2, the JAX package's words
    under its mesh."""
    kw = dict(logn=10, log_q0=50, log_scale=40, num_levels=4,
              log_special=51, hamming_weight=16)
    assert tcontext.test_params(10, 4) == CkksParams.create(**kw)
    assert jtest_params(10, 4).moduli == tcontext.test_params(10, 4).moduli
    pair = mesh_pair(kw, steps=(1,), n_batch=2, level=4)
    ref, got = pair["ref"], pair["got"]
    assert got["ctx"].word_bits == 64

    def jstep(data):
        c = JCiphertext(data, ref["ct"].scale)
        return ref["ev"].rotate(ref["ev"].rescale(
            ref["ev"].multiply(c, c)), 1).data

    def step(ev, c):
        return ev.rotate(ev.rescale(ev.multiply(c, c)), 1)

    want = jax_on_mesh(jstep, ref["ct"], n_data, n_limb)
    out = port_on_mesh(step, got["ev"], got["ct"], n_data, n_limb)
    assert np.array_equal(carry.to_numpy(out), want)


@pytest.fixture(scope="module")
def w32():
    """A uint32 chain (two special primes) with the port's own keys."""
    ctx = CkksContext(tcontext.test_params_w32(10, 6), device=CPU)
    kg = KeyGenerator(ctx, seed=3)
    ev = Evaluator(ctx, relin_key=kg.relin_key(),
                   galois_keys=kg.galois_keys([1], conjugate=True))
    enc = Encryptor(ctx, secret=kg.secret, seed=4)
    z = np.random.default_rng(5).uniform(-1, 1, ctx.params.slots)
    return ctx, ev, enc, z


@pytest.mark.parametrize("n_limb,level", [(2, 1), (3, 2), (4, 3), (3, 5)])
def test_positions_without_a_data_limb(w32, n_limb, level):
    """Below the limb axis' width some positions hold no data limb: their
    key switch writes only the special rows, their mod-downs and NTTs give
    [.., 0, N] without a launch, and the gathered multiply+relin, rotate,
    conjugate and rescale are the single-device words."""
    ctx, ev, enc, z = w32
    ct = enc.encrypt(ev.make_plain(z, ctx.params.scale, level))

    def step(ev, c):
        m = ev.multiply(c, c)
        outs = [m, ev.rotate(c, 1), ev.conjugate(c)]
        if c.level > ctx.base_limbs:
            outs.append(ev.rescale(m))
        return outs

    mesh = make_mesh(1, n_limb, DEVICES)
    mev = MeshEvaluator(mesh, ctx, relin_key=ev.relin_key,
                        galois_keys=ev.galois_keys)
    sct = shard_ciphertext(ct, mesh)
    assert [s.data.shape[-2] for s in sct.shards] == [
        len(range(p, level, n_limb)) for p in range(n_limb)]
    outs = mev.run(step, sct)
    for got, want in zip(outs, step(ev, ct)):
        g = gather_ciphertext(got)
        assert g.level == want.level and g.scale == want.scale
        assert torch.equal(g.data, want.data)


@pytest.mark.parametrize("chain", ["w32", "u64"])
@pytest.mark.parametrize("n_limb,pos,level", [
    (2, 0, 6), (2, 1, 6), (3, 2, 5), (2, 1, 1), (4, 3, 2)])
def test_row_block_key_switch_and_mod_down_equal_the_full_rows(
        chain, n_limb, pos, level):
    """On a position's key rows (its data limbs, then the specials), the
    plain key switch with the row map equals those rows of the full switch,
    and the mod-down on its output rows equals those rows of the full
    mod-down (an empty data block included)."""
    params = (tcontext.test_params_w32(10, 6) if chain == "w32"
              else tcontext.test_params(10, 6))
    ctx = CkksContext(params, device=CPU)
    view = LimbView(ctx, torch.device(CPU), pos, n_limb,
                    (tables_on(ctx.ntt_all, torch.device(CPU)), {}, {}))
    rows = view.key_limbs(level)
    assert rows == tuple(range(pos, level, n_limb)) + tuple(
        ctx.L + i for i in range(ctx.k_sp))
    ft, vft = ctx.fused_ks_tables(level), view.fused_ks_tables(level)
    assert ft.splice is None and torch.equal(
        ft.rows, torch.arange(level + ctx.k_sp, dtype=torch.int32))
    assert vft.rows.tolist() == [j if j < ctx.L else level + j - ctx.L
                                 for j in rows]
    rng = np.random.default_rng(level + n_limb)
    kg = KeyGenerator(ctx, seed=2)
    key = kg.relin_key()
    vkey = limb_key(key, view.key_limbs(ctx.L), torch.device(CPU))
    c = Encryptor(ctx, secret=kg.secret, seed=3).encrypt(
        Evaluator(ctx).make_plain(rng.uniform(-1, 1, ctx.params.slots),
                                  ctx.params.scale, level)).data[1]
    full = tks.switch_key_plain(c, key.sliced(ctx.key_limbs(level), ft.D),
                                ctx.tables(level),
                                ctx.tables(ctx.key_limbs(level)), ft)
    block = tks.switch_key_plain(c, vkey.sliced(rows, vft.D),
                                 ctx.tables(level), view.tables(rows), vft)
    idx = torch.tensor([ctx.key_limbs(level).index(j) for j in rows])
    assert torch.equal(block, full.index_select(-2, idx))
    md = tks.fused_mod_down(full, ctx.tables(tuple(ctx.key_limbs(level)[
        level:])), ctx.tables(level), ctx.fused_md_tables(level))
    vmd = tks.fused_mod_down(block, view.tables(rows[-ctx.k_sp:]),
                             view.tables(level), view.fused_md_tables(level))
    keep = torch.tensor(view.data_limbs(level), dtype=torch.long)
    assert vmd.shape[-2] == len(keep)
    assert torch.equal(vmd, md.index_select(-2, keep))


def test_make_mesh_shapes_and_layouts(monkeypatch):
    """make_mesh keeps the JAX assertion, repeats devices, and without a
    card devices=None raises; shard/gather round-trips in both layouts."""
    mesh = make_mesh(4, 2, DEVICES)
    assert mesh.shape == {"data": 4, "limb": 2}
    assert mesh.positions()[3][:2] == (1, 1)
    assert make_mesh(devices=DEVICES).shape == {"data": 1, "limb": 1}
    with pytest.raises(AssertionError):
        make_mesh(3, 3, DEVICES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 1)
    x = torch.arange(2 * 4 * 5 * 8, dtype=torch.int64).reshape(2, 4, 5, 8)
    ct = Ciphertext(x, 3.0)
    for layout in (ct_sharding(mesh, 1), replicated(mesh)):
        sct = shard_ciphertext(ct, mesh, layout)
        assert torch.equal(gather_ciphertext(sct).data, x)
    sct = shard_ciphertext(ct, mesh)
    assert sct.shards[3].data.shape == (2, 1, 2, 8)      # batch 1, limbs 1, 3
    assert torch.equal(sct.shards[3].data, x[:, 1:2, 1::2])


@pytest.mark.parametrize("fault", ["raise", "late"])
def test_a_failing_position_fails_the_call_without_a_hang(w32, fault):
    """A position that raises aborts the others' exchanges at once and its
    exception reaches the caller; a position that never reaches an
    exchange fails the call after the barrier timeout. No thread is left
    running."""
    ctx, ev, enc, z = w32
    ct = enc.encrypt(ev.make_plain(z, ctx.params.scale, 4))
    mesh = make_mesh(2, 2, DEVICES)
    mev = MeshEvaluator(mesh, ctx, relin_key=ev.relin_key,
                        galois_keys=ev.galois_keys, timeout=2.0)
    bad = mev.evaluators[3]

    def step(ev, c):
        if ev is bad:
            if fault == "raise":
                raise ValueError("position 3 failed")
            time.sleep(4.0)
        return ev.rotate(c, 1)

    before = threading.active_count()
    t0 = time.perf_counter()
    with pytest.raises(ValueError if fault == "raise"
                       else threading.BrokenBarrierError):
        mev.run(step, shard_ciphertext(ct, mesh))
    assert time.perf_counter() - t0 < (2.0 if fault == "raise" else 8.0)
    assert threading.active_count() == before
    # The mesh runs again after a failure.
    out = mev.run(lambda ev, c: ev.rotate(c, 1), shard_ciphertext(ct, mesh))
    assert torch.equal(gather_ciphertext(out).data, ev.rotate(ct, 1).data)


def test_positions_share_host_encodings_and_count_launches_exactly(w32):
    """Under contention (more threads than cores, a short switch
    interval): every position's encoding of the same slot vector takes one
    host rounding, and the launch counter loses no increment."""
    import sys
    from fhe_gpt2_tpu_torch.core import _cuda
    from fhe_gpt2_tpu_torch.parallel.mesh import HostCoeffs
    ctx, ev, _, z = w32
    mesh = make_mesh(4, 2, DEVICES)
    mev = MeshEvaluator(mesh, ctx)
    calls = []
    coeffs = mev.coeffs
    real = coeffs.get

    def counted(values, scale, make):
        return real(values, scale, lambda: calls.append(1) or make())

    coeffs.get = counted
    out = mev.run(lambda e, v: e.make_plain(v, ctx.params.scale, 5).data, z)
    assert len(calls) == 1
    for e, data in zip(mev.evaluators, out):
        want = ev.make_plain(z, ctx.params.scale, 5).data
        assert torch.equal(data, want[list(e.ctx.data_limbs(5))])
    shared, wrong = HostCoeffs(size=4), []
    before = dict(_cuda.LAUNCHES)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for j in range(200):
                _cuda.count("ntt_fwd")
                k = (i + j) % 8         # more keys than entries: evictions
                if shared.get(z, float(k), lambda: k) != k:
                    wrong.append((i, j))
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert _cuda.LAUNCHES["ntt_fwd"] == before["ntt_fwd"] + 32 * 200
    _cuda.LAUNCHES["ntt_fwd"] = before["ntt_fwd"]
    assert not wrong
