"""Shared set-up of the port's GPT-2 tests
(tests/test_torch_gpt2_*.py, tests/test_torch_run_gpt2.py).

``SH`` is tests/test_layers.py's shape (1024 slots, seq 16, hidden 32, 4
heads) on both packages. ``block_case`` draws activations and one block's
weights as tests/test_layers.py does; ``both_block_plans`` builds
both packages' plans from the same arrays, and the ``same_*`` helpers hold a
port plan to the JAX package's field by field, exactly.

``encrypted_backends`` builds both packages' CkksBackend on one composite
uint32 chain at logN=10 with 6 level pairs (keys and encryptions from the
same seeds, the
decrypt/re-encrypt refresh to the chain top), short enough that a
LayerNorm, an attention or an MLP refreshes on the way. The JAX evaluator
encodes through ``torch_port_common.fast_encoding``.
"""

import numpy as np

from fhe_gpt2_tpu.nn import layers as jL

from fhe_gpt2_tpu_torch.nn import layers as L

SH = L.GPT2Shapes(slots=1024, seq=16, hidden=32, heads=4)
JSH = jL.GPT2Shapes(slots=1024, seq=16, hidden=32, heads=4)


def rand_w(rng, d1, d2, scale=0.3):
    return rng.standard_normal((d1, d2)) * scale / np.sqrt(d1)


def block_case(seed: int, a_scale: float = 0.5) -> tuple:
    """(activations A [seq, hidden], one block's weights), drawn from
    ``default_rng(seed)`` in the order of tests/test_layers.py: A, then the
    attention weights and biases (the attention tests' draw), then the
    LayerNorm and MLP weights (test_block's)."""
    d = SH.hidden
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((SH.seq, d)) * a_scale
    w = {}
    for n in ("wq", "wk", "wv", "wo"):
        w[n] = rand_w(rng, d, d, 1.0)
    for n in ("bq", "bk", "bv", "bo"):
        w[n] = rng.standard_normal(d) * 0.05
    w["g1"], w["be1"] = np.ones(d), np.zeros(d)
    w["g2"], w["be2"] = rng.uniform(0.8, 1.2, d), rng.standard_normal(d) * 0.02
    w["w1"] = rand_w(rng, d, 4 * d, 1.0)
    w["b1"] = rng.standard_normal(4 * d) * 0.05
    w["w2"] = rand_w(rng, 4 * d, d, 1.0)
    w["b2"] = rng.standard_normal(d) * 0.05
    return A, w


def ss_of(M, d: int = SH.hidden) -> float:
    z = d * (M - M.mean(-1, keepdims=True))
    return float((z ** 2).sum(-1).mean())


def attn_args(w: dict) -> tuple:
    return tuple(w[n] for n in ("wq", "bq", "wk", "bk", "wv", "bv", "wo",
                                "bo"))


def both_block_plans(w: dict, init1: float, init2: float,
                     iters: int = 16, eps: float = 1e-4,
                     **attn_knobs) -> tuple:
    """(port BlockPlans, JAX BlockPlans) from the same weights, knobs set
    alike on both attention plans."""
    out = []
    for mod, sh in ((L, SH), (jL, JSH)):
        ap = mod.build_attn_plans(sh, *attn_args(w))
        for k, v in attn_knobs.items():
            setattr(ap, k, v)
        out.append(mod.BlockPlans(
            ln1=mod.build_ln_plans(sh, w["g1"], w["be1"], newton_init=init1,
                                   iters=iters, eps=eps),
            attn=ap,
            ln2=mod.build_ln_plans(sh, w["g2"], w["be2"], newton_init=init2,
                                   iters=iters, eps=eps),
            mlp=mod.build_mlp_plans(sh, w["w1"], w["b1"], w["w2"], w["b2"])))
    return tuple(out)


def same_array(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=True), what


def same_spec(spec, jspec):
    assert (spec.slots, spec.n_src, spec.n_dst, spec.name) == \
        (jspec.slots, jspec.n_src, jspec.n_dst, jspec.name)
    assert sorted(spec.diagonals) == sorted(jspec.diagonals), spec.name
    for k in spec.diagonals:
        same_array(spec.diagonals[k], jspec.diagonals[k], (spec.name, k))


def same_plan(plan, jplan):
    same_spec(plan.spec, jplan.spec)
    assert plan.giant == jplan.giant
    assert sorted(plan.groups) == sorted(jplan.groups)
    for jg in plan.groups:
        g, jgg = plan.groups[jg], jplan.groups[jg]
        assert sorted(g) == sorted(jgg)
        for dst in g:
            assert len(g[dst]) == len(jgg[dst])
            for (i, s, m), (ji, js, jm) in zip(g[dst], jgg[dst]):
                assert (i, s) == (ji, js)
                same_array(m, jm, (plan.spec.name, jg, dst, i))


ATTN_ARRAYS = ("qb", "kb", "vb", "ob", "causal_zero", "keep_row",
               "spill_row", "seg_starts")
ATTN_SCALARS = ("exp_r", "inv_iters", "smax_gamma", "inv_prescale",
                "max_bound", "softmax_mode")


def same_attn_plans(ap, jap):
    for n in ("q", "k", "v", "o"):
        same_plan(getattr(ap, n), getattr(jap, n))
    for n in ATTN_ARRAYS:
        same_array(getattr(ap, n), getattr(jap, n), n)
    for n in ATTN_SCALARS:
        assert getattr(ap, n) == getattr(jap, n), n
    for n in ("consmax_beta", "consmax_gamma"):
        a, b = getattr(ap, n), getattr(jap, n)
        assert (a is None) == (b is None), n
        if a is not None:
            same_array(a, b, n)


def same_ln_plans(ln, jln):
    for n in ("gamma_sqrt_d", "beta", "data_mask"):
        same_array(getattr(ln, n), getattr(jln, n), n)
    assert (ln.newton_init, ln.newton_iters, ln.eps) == \
        (jln.newton_init, jln.newton_iters, jln.eps)


def same_mlp_plans(mp, jmp):
    for rows, jrows in ((mp.fc1, jmp.fc1), (mp.fc2, jmp.fc2)):
        assert len(rows) == len(jrows)
        for row, jrow in zip(rows, jrows):
            assert len(row) == len(jrow)
            for p, jp in zip(row, jrow):
                same_plan(p, jp)
    assert len(mp.b1) == len(jmp.b1)
    for a, b in zip(mp.b1, jmp.b1):
        same_array(a, b, "b1")
    same_array(mp.b2, jmp.b2, "b2")
    assert (mp.gelu_bound, mp.gelu_degree) == (jmp.gelu_bound,
                                               jmp.gelu_degree)


def same_block_plans(bp, jbp):
    same_ln_plans(bp.ln1, jbp.ln1)
    same_attn_plans(bp.attn, jbp.attn)
    same_ln_plans(bp.ln2, jbp.ln2)
    same_mlp_plans(bp.mlp, jbp.mlp)


def same_values(got: list, want: list, what=""):
    """Two lists of plain-backend values (port, JAX): exactly equal."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        same_array(g, w, f"{what} value {i}")


# -- the encrypted block of tests/test_torch_gpt2_{ln,attn,mlp}_encrypted.py

ENC_LOGN = 10
ENC_SLOTS = 1 << (ENC_LOGN - 1)
ENC_SH = L.GPT2Shapes(slots=ENC_SLOTS, seq=16, hidden=32, heads=4)
ENC_JSH = jL.GPT2Shapes(slots=ENC_SLOTS, seq=16, hidden=32, heads=4)
# Composite uint32 chain: 6 level pairs above the base, 4 special primes.
# Every level is a new operand shape for the JAX package's eager ops, so a
# short chain keeps its compiles few.
ENC_CHAIN = dict(logn=ENC_LOGN, num_levels=6, log_scale=50, log_q0=55,
                 log_special=31, num_special=4, hamming_weight=16)


def encrypted_backends(key_steps, **chain):
    """(port CkksBackend, JAX CkksBackend) on ENC_CHAIN (updated by
    ``chain``), keys
    from seed 1 (relinearization, the Galois steps ``key_steps`` and
    conjugation), encryptions from seed 2, the decrypt/re-encrypt refresh
    to the chain top at the default floor (3 pairs)."""
    from fhe_gpt2_tpu.core.context import CkksContext as JContext
    from fhe_gpt2_tpu.core.context import CkksParams as JParams
    from fhe_gpt2_tpu.core.evaluator import Decryptor as JDecryptor
    from fhe_gpt2_tpu.core.evaluator import Encryptor as JEncryptor
    from fhe_gpt2_tpu.core.evaluator import Evaluator as JEvaluator
    from fhe_gpt2_tpu.core.keys import KeyGenerator as JKeyGenerator
    from fhe_gpt2_tpu.nn.backend import CkksBackend as JCkksBackend

    from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
    from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Encryptor, \
        Evaluator
    from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend

    from torch_port_common import fast_encoding

    kw = dict(ENC_CHAIN, **chain)
    out = []
    for C, KG, EV, ENC, DEC, BK in (
            (CkksContext(CkksParams.create_composite(**kw), device="cpu"),
             KeyGenerator, Evaluator, Encryptor, Decryptor, CkksBackend),
            (JContext(JParams.create_composite(**kw)), JKeyGenerator,
             JEvaluator, JEncryptor, JDecryptor, JCkksBackend)):
        kg = KG(C, seed=1)
        ev = EV(C, relin_key=kg.relin_key(),
                galois_keys=kg.galois_keys(sorted(key_steps),
                                           conjugate=True))
        if BK is JCkksBackend:
            fast_encoding(ev)
        out.append(BK(ctx=C, ev=ev, enc=ENC(C, secret=kg.secret, seed=2),
                      dec=DEC(C, kg.secret), default_level=C.L))
    return tuple(out)


def decrypt_all(B, ct) -> np.ndarray:
    """Slot values of a ciphertext with any number of batch axes."""
    if ct.data.ndim <= 3:
        return B.to_slots(ct)
    return np.stack([decrypt_all(B, c) for c in B.unstack(ct)])


def count_refreshes(B) -> list:
    """Wrap B.bootstrap to append the level of every refresh to the
    returned list."""
    seen = []
    inner = B.bootstrap

    def counted(v, **kw):
        seen.append(v.level)
        return inner(v, **kw)

    B.bootstrap = counted
    return seen


# -- attention in three stages (tests/test_torch_gpt2_attn{,_softmax,_back}_
# encrypted.py)
#
# The JAX package runs an encrypted attention op by op, compiling every op
# at every new level and batch shape: about 4 minutes on a CPU host on a
# cold compile cache. Each stage takes about a third of that.

def attention_qkv(L, B, xs, ap):
    """``attention``'s Q, K and V projections (softmax "smax", all Δ at
    once), with L the port's or the JAX package's ``nn.layers``: each
    stacked over the activation's ciphertexts."""
    return tuple(B.stack(L._apply_matmul(B, p, xs, b))
                 for p, b in ((ap.q, ap.qb), (ap.k, ap.kb), (ap.v, ap.vb)))


def attention_softmax(L, K, B, q, k, sh, ap):
    """The Δ-batched scores, exp, the causal mask and the row sums, with K
    the package's ``nn.kernels``. Returns (e [S, n], denom [n])."""
    kpos, kneg = L._row_shift_stacks(B, k, sh)
    kd = L._gather_deltas(B, ap, sh, kpos, kneg, sh.act.n_cts, 0, sh.seq)
    s = K.fold_sum(B, B.mul(q, kd), sh.dh)
    s = K.replicate(B, B.mul_plain(s, ap.seg_starts), 1, sh.dh)
    _, _, causal, _ = ap.chunk_arrays(0, sh.seq)
    sc = B.add_const(s, -ap.smax_gamma)
    e = B.mul_plain(K.exp(B, sc, r=ap.exp_r), causal)
    return e, B.reduce_sum_batch(e, 0)


def attention_back(L, K, B, e, denom, v, sh, ap):
    """The Goldschmidt inverse of the row sums, S·V over the Δ batch and
    the output projection. Returns the output act-layout values."""
    inv = K.goldschmidt_inverse(
        B, B.add_const(B.mul_const(denom, 0.0), ap.inv_prescale),
        B.mul_const(denom, ap.inv_prescale), ap.inv_iters)
    vpos, vneg = L._row_shift_stacks(B, v, sh)
    vd = L._gather_deltas(B, ap, sh, vpos, vneg, sh.act.n_cts, 0, sh.seq)
    out = B.reduce_sum_batch(B.mul(B.mul(e, inv), vd), 0)
    return L._apply_matmul(B, ap.o, B.unstack(out), ap.ob)


def encrypt_value(B, x, level):
    """A plain [..., slots] value as one (batched) ciphertext at level."""
    if x.ndim == 1:
        return B.from_slots(x, level=level)
    return B.stack([encrypt_value(B, r, level) for r in x])


# -- the MLP in two stages (tests/test_torch_gpt2_mlp{,_fc2}_encrypted.py)

def mlp_fc1(L, K, B, xs, sh, mp):
    """``mlp``'s first stage, with L and K the port's or the JAX package's
    ``nn.layers`` and ``nn.kernels``: per output column group, fc1 summed
    over the input groups, its bias and the GELU."""
    groups = []
    for co in range(sh.mlp_ratio):
        acc = None
        for ko in range(len(mp.fc1)):
            y = L.apply_lt(B, mp.fc1[ko][co], xs)
            acc = y if acc is None else [B.add(a, b) for a, b in zip(acc, y)]
        acc = [B.add_plain(a, mp.b1[co][i]) for i, a in enumerate(acc)]
        groups.append([K.gelu(B, a, mp.gelu_bound, mp.gelu_degree)
                       for a in acc])
    return groups


def mlp_fc2(L, B, groups, sh, mp):
    """The second stage: fc2 summed over the column groups, and its
    bias."""
    out = None
    for ko in range(sh.mlp_ratio):
        y = L.apply_lt(B, mp.fc2[ko][0], groups[ko])
        out = y if out is None else [B.add(a, b) for a, b in zip(out, y)]
    return [B.add_plain(o, mp.b2[i]) for i, o in enumerate(out)]
