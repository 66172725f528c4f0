"""The evaluator's coefficient-wise arithmetic (``core/tdyadic.py``) on the
CPU, where the wrappers take their plain versions: held against the
``core/modmath.py`` expressions the evaluator ran before them, against exact
numpy arithmetic, and, for ``Evaluator.multiply``/``relinearize`` and the
plain and constant ops, against the JAX package at logN = 11.

``csrc/dyadic.cu`` runs only on the card (``tests/test_torch_cuda.py``).
Here its addressing is held instead: the wrappers' kernel route runs on CPU
tensors with the launch replaced by ``_emulate``, which reads the host
words the kernel would get and computes what the kernel computes, in
numpy, through views of the same memory (the same pointers and strides,
the same 32-bit add and subtract formulas, the same Barrett reduction by
the tables' ratio words). Tolerance: exact (every comparison is on the
words).
"""

import ctypes
import struct

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu.core.context import CkksContext as JContext
from fhe_gpt2_tpu.core.context import CkksParams as JParams
from fhe_gpt2_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_gpt2_tpu.core.evaluator import Encryptor as JEncryptor
from fhe_gpt2_tpu.core.keys import KeyGenerator as JKeyGenerator
from fhe_gpt2_tpu_torch import carry
from fhe_gpt2_tpu_torch.core import _cuda, modmath, primes, tdyadic
from fhe_gpt2_tpu_torch.core import ntt as nttmod
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Ciphertext, Encryptor, \
    Evaluator
from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
from fhe_gpt2_tpu_torch.utils import telemetry

N = 256
L = 5
BATCHES = [1, 8, 128]
M32 = (1 << 32) - 1


@pytest.fixture(scope="module")
def t32():
    """29-bit NTT primes: lazy words in [0, 2q) still fit a signed int32."""
    return nttmod.make_ntt_tables(primes.gen_primes_balanced(29, L, 2 * N),
                                  N, "cpu")


def _words(rng, moduli, lead, n=N, lazy=False):
    """Residues [*lead, len(moduli), n] as uint64 numpy, in [0, q) or, lazy,
    in [0, 2q); the largest word in every eighth slot."""
    top = [2 * q - 1 if lazy else q - 1 for q in moduli]
    x = np.stack([rng.integers(0, h + 1, size=lead + (n,), dtype=np.uint64)
                  for h in top], axis=-2)
    x[..., ::8] = np.array(top, dtype=np.uint64)[:, None]
    return x


def _t(x):
    return modmath.word_tensor(x, "cpu")


def _np(x):
    return modmath.to_numpy_word(x).astype(np.uint64)


def _qs(t):
    return np.array(t.moduli, dtype=np.uint64)[:, None]


def _counts():
    c = telemetry.snapshot().counters
    return c.get("dyadic.calls", 0), c.get("dyadic.kernel", 0)


# ---------------------------------------------------------------------------
# The plain route: today's modmath expressions, exact arithmetic, counters
# ---------------------------------------------------------------------------

def _case(op, B, t, rng):
    """(wrapper call, the modmath expression the evaluator ran, the exact
    numpy words) of one op on a batch of B ciphertexts."""
    q = t.q
    a_np = _words(rng, t.moduli, (2, B))
    b_np = _words(rng, t.moduli, (2, B))
    p_np = _words(rng, t.moduli, ())
    c_np = np.array([rng.integers(0, m) for m in t.moduli],
                    dtype=np.uint64)[:, None]
    a, b, p, c = _t(a_np), _t(b_np), _t(p_np), _t(c_np)
    qs = _qs(t)

    def mm(x, y):
        return modmath.mul_mod(x, y, q, t.ratio0, t.ratio1)

    if op in ("tensor", "square"):
        y, y_np = (a, a_np) if op == "square" else (b, b_np)
        today = torch.stack([mm(a[0], y[0]),
                             modmath.add_mod(mm(a[0], y[1]), mm(a[1], y[0]),
                                             q),
                             mm(a[1], y[1])])
        exact = np.stack([a_np[0] * y_np[0] % qs,
                          (a_np[0] * y_np[1] + a_np[1] * y_np[0]) % qs,
                          a_np[1] * y_np[1] % qs])
        return lambda: tdyadic.tensor_product(a, y, t), today, exact
    if op == "mul":
        return (lambda: tdyadic.mul_mod(a, b, t), mm(a, b),
                a_np * b_np % qs)
    if op == "mul_plain":
        return (lambda: tdyadic.mul_mod(a, p, t), mm(a, p),
                a_np * p_np % qs)
    if op == "mul_const":
        return (lambda: tdyadic.mul_mod(a, c, t), mm(a, c),
                a_np * c_np % qs)
    if op == "add":
        return (lambda: tdyadic.add_mod(a, b, t), modmath.add_mod(a, b, q),
                (a_np + b_np) % qs)
    if op == "sub":
        return (lambda: tdyadic.sub_mod(a, b, t), modmath.sub_mod(a, b, q),
                (a_np + qs - b_np) % qs)
    if op == "neg":
        return (lambda: tdyadic.neg_mod(a, t), modmath.neg_mod(a, q),
                (qs - a_np) % qs)
    if op == "add_plain_rest":
        today = torch.cat([modmath.add_mod(a[0], p, q)[None], a[1:]])
        exact = np.concatenate([((a_np[0] + p_np) % qs)[None], a_np[1:]])
        return (lambda: tdyadic.add_mod(a[0], p, t, rest=a[1:]), today,
                exact)
    if op == "sub_const_rest":
        today = torch.cat([modmath.sub_mod(a[0], c, q)[None], a[1:]])
        exact = np.concatenate([((a_np[0] + qs - c_np) % qs)[None],
                                a_np[1:]])
        return (lambda: tdyadic.sub_mod(a[0], c, t, rest=a[1:]), today,
                exact)
    assert op == "sum"
    return (lambda: tdyadic.mod_sum(a, t, axis=1),
            modmath.mod_sum(a, q, axis=1), a_np.sum(axis=1) % qs)


OPS = ["tensor", "square", "mul", "mul_plain", "mul_const", "add", "sub",
       "neg", "add_plain_rest", "sub_const_rest", "sum"]


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("op", OPS)
def test_plain_route_is_the_modmath_expression_and_exact(t32, op, B):
    """On the CPU each wrapper gives the words of the modmath expression the
    evaluator ran and of exact arithmetic, counted as a call and not as a
    kernel launch."""
    fn, today, exact = _case(op, B, t32, np.random.default_rng(B))
    before = dict(_cuda.LAUNCHES)
    telemetry.reset()
    with telemetry.enable():
        got = fn()
    assert _counts() == (1, 0)
    telemetry.reset()
    assert dict(_cuda.LAUNCHES) == before
    assert torch.equal(got, today)
    assert np.array_equal(_np(got), exact)


def test_u64_route_is_the_modmath_expression_and_exact():
    """int64 words (the u64 engine, 60-bit moduli) take the plain versions:
    the Barrett and Shoup products of core/modmath.py, equal to exact
    Python-int arithmetic."""
    t = nttmod.make_ntt_tables(primes.gen_primes_balanced(60, 3, 2 * N), N,
                               "cpu")
    assert t.q.dtype == torch.int64
    rng = np.random.default_rng(64)
    qs = [int(m) for m in t.moduli]

    def rand(lead):
        return np.stack([np.array([int(v) for v in rng.integers(
            0, m, size=int(np.prod(lead, dtype=np.int64)) * N,
            dtype=np.uint64)], dtype=object).reshape(lead + (N,))
            for m in qs], axis=-2)

    def tens(x):
        return modmath.word_tensor(x.astype(np.uint64), "cpu",
                                   word=np.uint64)

    def back(x):
        return modmath.to_numpy_u64(x).astype(object)

    qcol = np.array(qs, dtype=object)[:, None]
    a_o, b_o, p_o = rand((2, 3)), rand((2, 3)), rand(())
    a, b, p = tens(a_o), tens(b_o), tens(p_o)
    w = [(1 << 61) % m for m in qs]
    c = modmath.word_tensor(np.array(w, dtype=np.uint64)[:, None], "cpu",
                            word=np.uint64)
    cs = modmath.word_tensor(np.array([modmath.shoup(x, m, 64)
                                       for x, m in zip(w, qs)],
                                      dtype=np.uint64)[:, None], "cpu",
                             word=np.uint64)
    got = tdyadic.tensor_product(a, b, t)
    assert np.array_equal(back(got), np.stack([
        a_o[0] * b_o[0] % qcol, (a_o[0] * b_o[1] + a_o[1] * b_o[0]) % qcol,
        a_o[1] * b_o[1] % qcol]))
    assert torch.equal(got, tdyadic.tensor_product_plain(a, b, t))
    assert np.array_equal(back(tdyadic.mul_mod(a, p, t)), a_o * p_o % qcol)
    lifted = tdyadic.mul_mod(a, c, t, cs)
    assert torch.equal(lifted, modmath.mul_mod_shoup(a, c, cs, t.q))
    assert np.array_equal(back(lifted),
                          a_o * np.array(w, dtype=object)[:, None] % qcol)
    assert np.array_equal(back(tdyadic.add_mod(a[0], p, t, rest=a[1:])),
                          np.concatenate([((a_o[0] + p_o) % qcol)[None],
                                          a_o[1:]]))
    assert np.array_equal(back(tdyadic.sub_mod(a, b, t)),
                          (a_o - b_o) % qcol)
    assert np.array_equal(back(tdyadic.neg_mod(a, t)), (-a_o) % qcol)
    assert np.array_equal(back(tdyadic.mod_sum(a, t, axis=1)),
                          a_o.sum(axis=1) % qcol)


# ---------------------------------------------------------------------------
# The kernel route's words, emulated on the CPU
# ---------------------------------------------------------------------------

def _view(ptr, shape, strides):
    """A numpy view of the uint32 words at address ptr with these word
    strides: the kernel's addressing."""
    extent = 1 + sum((s - 1) * st for s, st in zip(shape, strides) if s)
    buf = (ctypes.c_uint32 * extent).from_address(ptr)
    return np.lib.stride_tricks.as_strided(
        np.frombuffer(buf, dtype=np.uint32), shape,
        [4 * st for st in strides])


def _dense(shape):
    """Word strides of a contiguous tensor of this shape."""
    return tuple(int(np.prod(shape[i + 1:], dtype=np.int64))
                 for i in range(len(shape)))


def _mulhi64(a, b):
    """floor(a·b / 2**64) of uint64 arrays, in 32-bit halves."""
    m = np.uint64(M32)
    s = np.uint64(32)
    al, ah, bl, bh = a & m, a >> s, b & m, b >> s
    ll, hl, lh, hh = al * bl, ah * bl, al * bh, ah * bh
    cross = (ll >> s) + (hl & m) + lh
    return hh + (hl >> s) + (cross >> s)


def _reduce64(acc, q, ratio):
    """modarith.cuh's reduce64, word for word."""
    with np.errstate(over="ignore"):
        r = acc - _mulhi64(acc, ratio) * q
    return np.where(r >= q, r - q, r).astype(np.uint32)


def _rows_of(tptr, l):
    q = _view(tptr[0], (l, 1), (1, 0)).astype(np.uint64)
    ratio = ((_view(tptr[2], (l, 1), (1, 0)).astype(np.uint64)
              << np.uint64(32)) | _view(tptr[1], (l, 1), (1, 0)))
    return q, ratio


def _emulate(fn, words, *args, dev):
    """What csrc/dyadic.cu's entry `fn` writes, from its host words (the
    launch checks of grid_of included)."""
    w = list(struct.unpack(f"{len(words) // 8}q", words))
    threads = args[-1]
    assert dev.type == "cpu"
    if fn == "dyadic_binary":
        op, const = args[0], args[1]
        G, o = tdyadic.GROUPS, tdyadic.GROUPS + 2
        a, b, r = w[:o], w[o:2 * o], w[2 * o:3 * o]
        rc, out, *tq = w[3 * o:3 * o + 5]
        K, M, (l, n) = w[3 * o + 5], w[3 * o + 6:3 * o + 6 + G], w[-2:]
        q, ratio = _rows_of(tq, l)
        y = _view(out, (K, *M, l, n), _dense((K, *M, l, n)))
        if K > 1:
            y[1:] = _view(r[0], (K - 1, *M, l, n), (rc, *r[1:], 1))
        x = _view(a[0], (*M, l, n), (*a[1:], 1))
        q32 = q.astype(np.uint32)
        with np.errstate(over="ignore"):
            if op == tdyadic.NEG:
                y[0] = np.where(x == 0, np.uint32(0), q32 - x)
            else:
                b = _view(b[0], (*M, l, 1 if const else n),
                          (*b[1:], 0 if const else 1))
                if op == tdyadic.MUL:
                    y[0] = _reduce64(x.astype(np.uint64) * b, q, ratio)
                elif op == tdyadic.ADD:
                    s = x - (q32 - b)
                    y[0] = np.where(s.view(np.int32) < 0, s + q32, s)
                else:
                    d = x - b
                    y[0] = np.where(d.view(np.int32) < 0, d + q32, d)
    elif fn == "dyadic_tensor":
        square = args[0]
        G, o = tdyadic.GROUPS, tdyadic.GROUPS + 2
        a, ac, b = w[:o], w[o], w[o + 1:2 * o + 1]
        bc, out, *tq = w[2 * o + 1:2 * o + 6]
        M, (l, n) = w[2 * o + 6:2 * o + 6 + G], w[-2:]
        q, ratio = _rows_of(tq, l)
        a = _view(a[0], (2, *M, l, n), (ac, *a[1:], 1)).astype(np.uint64)
        b = a if square else _view(b[0], (2, *M, l, n),
                                   (bc, *b[1:], 1)).astype(np.uint64)
        y = _view(out, (3, *M, l, n), _dense((3, *M, l, n)))
        y[0] = _reduce64(a[0] * b[0], q, ratio)
        y[1] = _reduce64(a[0] * b[1] + a[1] * b[0], q, ratio)
        y[2] = _reduce64(a[1] * b[1], q, ratio)
    else:
        assert fn == "dyadic_sum"
        xp, so, ss, sr, S, out, *rest = w
        tq, (O, R, l, n) = rest[:3], rest[3:]
        q, ratio = _rows_of(tq, l)
        x = _view(xp, (O, S, R, n), (so, ss, sr, 1)).astype(np.uint64)
        y = _view(out, (O, R, n), (R * n, n, 1))
        s = x.sum(axis=1)
        y[...] = _reduce64(s, np.tile(q, (R // l, 1)),
                           np.tile(ratio, (R // l, 1)))
    assert 0 < threads <= tdyadic.THREADS and n % (tdyadic.WORDS * threads) == 0
    _cuda.count("dyadic")
    telemetry.count("dyadic.kernel")


@pytest.fixture
def kernel_route(monkeypatch):
    """The wrappers' kernel route on CPU int32 tensors, each launch
    emulated."""
    monkeypatch.setattr(tdyadic, "_plain_route",
                        lambda x: x.dtype == torch.int64)
    monkeypatch.setattr(tdyadic, "_launch", _emulate)


def _layouts(t, B, lazy):
    """(name, kernel call, plain call) of every layout the evaluator gives
    the wrappers, at batch B."""
    rng = np.random.default_rng(17 + B + lazy)
    wide = t.moduli + t.moduli[:3]

    def w(mods, lead):
        return _t(_words(rng, mods, lead, lazy=lazy))

    a, b = w(t.moduli, (2, B)), w(t.moduli, (2, B))
    a3 = w(t.moduli, (3, B))
    p, pb = w(t.moduli, ()), w(t.moduli, (B,))
    big = w(wide, (2, B))[..., :L, :]             # a limb-prefix view
    one = w(t.moduli, (2,))                       # an unbatched ciphertext
    c = _t(np.array([rng.integers(0, m) for m in t.moduli],
                    dtype=np.uint64)[:, None])
    cwide = _t(np.array([rng.integers(0, m) for m in wide],
                        dtype=np.uint64)[:, None])[:L]
    s5 = w(t.moduli, (2, B, 3))
    pd = w(t.moduli, (B, 1))                      # a mask over Δ, not rows
    s6 = w(t.moduli, (2, B, 2, 2))
    pd2 = w(t.moduli, (B, 1, 2))                  # four batch groups
    T, D = tdyadic, tdyadic
    return [
        ("tensor", lambda: T.tensor_product(a, b, t),
         lambda: D.tensor_product_plain(a, b, t)),
        ("square", lambda: T.tensor_product(a, a, t),
         lambda: D.tensor_product_plain(a, a, t)),
        ("tensor_views", lambda: T.tensor_product(big, a3[:2], t),
         lambda: D.tensor_product_plain(big, a3[:2], t)),
        ("tensor_broadcast", lambda: T.tensor_product(a, one, t),
         lambda: D.tensor_product_plain(a, one, t)),
        ("mul", lambda: T.mul_mod(a, b, t),
         lambda: D.mul_mod_plain(a, b, t)),
        ("mul_plain", lambda: T.mul_mod(a, p, t),
         lambda: D.mul_mod_plain(a, p, t)),
        ("mul_mask_batch", lambda: T.mul_mod(a, pb, t),
         lambda: D.mul_mod_plain(a, pb, t)),
        ("mul_mask_delta", lambda: T.mul_mod(s5, pd, t),
         lambda: D.mul_mod_plain(s5, pd, t)),
        ("mul_mask_groups", lambda: T.mul_mod(s6, pd2, t),
         lambda: D.mul_mod_plain(s6, pd2, t)),
        ("mul_const", lambda: T.mul_mod(big, cwide, t),
         lambda: D.mul_mod_plain(big, cwide, t)),
        ("add", lambda: T.add_mod(a, big, t),
         lambda: D.add_mod_plain(a, big, t)),
        ("add_relin", lambda: T.add_mod(a3[:2], b, t),
         lambda: D.add_mod_plain(a3[:2], b, t)),
        ("sub", lambda: T.sub_mod(a, b, t),
         lambda: D.sub_mod_plain(a, b, t)),
        ("neg", lambda: T.neg_mod(a3, t), lambda: D.neg_mod_plain(a3, t)),
        ("add_plain_rest", lambda: T.add_mod(a[0], p, t, rest=a[1:]),
         lambda: D.add_mod_plain(a[0], p, t, rest=a[1:])),
        ("add_galois_rest", lambda: T.add_mod(big[0], b[0], t, rest=b[1:]),
         lambda: D.add_mod_plain(big[0], b[0], t, rest=b[1:])),
        ("sub_const_rest", lambda: T.sub_mod(a3[0], c, t, rest=a3[1:]),
         lambda: D.sub_mod_plain(a3[0], c, t, rest=a3[1:])),
        ("sum", lambda: T.mod_sum(a, t, axis=1),
         lambda: D.mod_sum_plain(a, t, axis=1)),
        ("sum_inner", lambda: T.mod_sum(s5, t, axis=1),
         lambda: D.mod_sum_plain(s5, t, axis=1)),
        ("sum_last_batch", lambda: T.mod_sum(s5, t, axis=2),
         lambda: D.mod_sum_plain(s5, t, axis=2)),
        ("sum_view", lambda: T.mod_sum(big, t, axis=1),
         lambda: D.mod_sum_plain(big, t, axis=1)),
    ]


LAYOUTS = [name for name, _, _ in _layouts(nttmod.make_ntt_tables(
    primes.gen_primes_balanced(29, L, 2 * N), N, "cpu"), 1, False)]


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_words_equal_plain_at_each_layout(t32, kernel_route, layout,
                                                 B, lazy):
    """The kernel route's words (emulated from the words it would launch
    with) equal the plain version's at every layout, batch 1, 8 and 128,
    on canonical inputs and on lazy ones in [0, 2q)."""
    [(_, fn, plain)] = [c for c in _layouts(t32, B, lazy) if c[0] == layout]
    before = _cuda.LAUNCHES["dyadic"]
    got = fn()
    assert _cuda.LAUNCHES["dyadic"] == before + 1
    want = plain()
    assert got.is_contiguous() and got.shape == want.shape
    assert torch.equal(got, want)


def _offset(x, words):
    buf = torch.empty(x.numel() + words, dtype=x.dtype)
    y = buf[words:].view(x.shape)
    y.copy_(x)
    return y


def test_kernel_route_refuses_other_layouts(t32, kernel_route):
    """What the kernel does not take raises, and nothing launches: rows off
    the 16-byte grid, words that are not contiguous, batches that do not
    merge into two groups, a constant with a batch, other dtypes, a
    table of another level, the limb axis as a summed axis."""
    rng = np.random.default_rng(3)
    a = _t(_words(rng, t32.moduli, (2, 4)))
    before = _cuda.LAUNCHES["dyadic"]
    with pytest.raises(ValueError, match="16-byte"):
        tdyadic.mul_mod(_offset(a, 1), a, t32)
    strided = torch.zeros((2, 4, L, 2 * N), dtype=torch.int32)[..., ::2]
    with pytest.raises(ValueError, match="contiguous words"):
        tdyadic.add_mod(a, strided, t32)
    x = _t(_words(rng, t32.moduli, (2, 3, 4, 5, 6)))
    with pytest.raises(ValueError, match="4 strided groups"):
        tdyadic.add_mod(x.permute(0, 4, 3, 2, 1, 5, 6),
                        x.permute(0, 4, 3, 2, 1, 5, 6).contiguous(),
                        t32)
    cb = _t(np.ones((4, L, 1), dtype=np.uint64))
    with pytest.raises(ValueError):
        tdyadic.mul_mod(a, cb, t32)
    with pytest.raises(TypeError):
        tdyadic.add_mod(a, a.long(), t32)
    with pytest.raises(ValueError, match="tables"):
        tdyadic.neg_mod(a[..., :L - 1, :], t32)
    with pytest.raises(ValueError, match="batch axis"):
        tdyadic.mod_sum(a, t32, axis=-2)
    with pytest.raises(ValueError, match="rest"):
        tdyadic.add_mod(a[0], a[1], t32, rest=a[:1, :2])
    assert _cuda.LAUNCHES["dyadic"] == before


def test_evaluator_counts_every_call(t32):
    """Evaluator.multiply, relinearize, add_plain and the backend's batch
    sum on the CPU: every wrapper call counted as ``dyadic.calls``, none as
    ``dyadic.kernel``, and no launch."""
    params = CkksParams.create_composite(logn=10, num_levels=2,
                                         num_special=2, hamming_weight=16)
    ctx = CkksContext(params, device="cpu")
    kg = KeyGenerator(ctx, seed=1)
    ev = Evaluator(ctx, relin_key=kg.relin_key())
    enc = Encryptor(ctx, secret=kg.secret, seed=2)
    x = np.random.default_rng(0).uniform(-1, 1, ctx.params.slots)
    pt = ev.make_plain(x, params.scale, ctx.L)
    ct = enc.encrypt(pt)
    B = CkksBackend(ctx=ctx, ev=ev, enc=enc, default_level=ctx.L)
    before = dict(_cuda.LAUNCHES)
    telemetry.reset()
    with telemetry.enable():
        m = ev.multiply(ct, ct)                 # tensor product, relin add
        ev.add_plain(ct, pt)
        B.reduce_sum_batch(Ciphertext(torch.stack([m.data] * 3, dim=1),
                                      m.scale, m.level))
    assert _counts() == (4, 0)
    telemetry.reset()
    assert dict(_cuda.LAUNCHES) == before


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both():
    """Both packages' evaluators on the logN = 11 composite chain with the
    same relinearization key, and one ciphertext pair and plaintext."""
    kw = dict(logn=11, num_levels=1, num_special=2, hamming_weight=16)
    jctx = JContext(JParams.create_composite(**kw))
    ctx = CkksContext(CkksParams.create_composite(**kw), device="cpu")
    out = {}
    rng = np.random.default_rng(11)
    x, y = (rng.uniform(-1, 1, ctx.params.slots) for _ in range(2))
    for side, C, KG, EV, ENC in (
            ("ref", jctx, JKeyGenerator, JEvaluator, JEncryptor),
            ("got", ctx, KeyGenerator, Evaluator, Encryptor)):
        kg = KG(C, seed=3)
        ev = EV(C, relin_key=kg.relin_key())
        if side == "ref":
            pts = [ev.make_plain(v, C.params.scale, C.L) for v in (x, y)]
            out["pts"] = pts
        else:
            pts = [carry.plaintext_from_reference(
                np.asarray(p.data), p.scale, device="cpu")
                for p in out["pts"]]
        e = ENC(C, secret=kg.secret, seed=4)
        out[side] = (ev, e.encrypt(pts[0]), e.encrypt(pts[1]), pts[1])
    return out


def _jax_words(x):
    return np.asarray(x.data if hasattr(x, "data") else x)


@pytest.mark.parametrize("op", ["multiply", "square", "relinearize",
                                "mul_plain", "add_plain", "sub_plain",
                                "add_const", "mul_const_int", "add", "sub",
                                "negate"])
def test_evaluator_ops_equal_jax(both, op):
    """The port's evaluator, its arithmetic through core/tdyadic.py, gives
    the JAX package's words at logN = 11 (composite, 2 pairs)."""
    res = {}
    for side in ("ref", "got"):
        ev, a, b, p = both[side]
        if op == "multiply":
            r = ev.multiply(a, b, relin=False)
        elif op == "square":
            r = ev.square(a, relin=False)
        elif op == "relinearize":
            r = ev.relinearize(ev.multiply(a, b, relin=False))
        elif op in ("mul_plain", "add_plain", "sub_plain"):
            r = getattr(ev, op)(a, p)
        elif op == "add_const":
            r = ev.add_const(a, 0.375)
        elif op == "mul_const_int":
            r = ev.mul_const_int(a, 123457)
        elif op in ("add", "sub"):
            r = getattr(ev, op)(a, b)
        else:
            r = ev.negate(a)
        res[side] = (r.scale, r.level, _jax_words(r) if side == "ref"
                     else carry.to_numpy(r.data))
    (rs, rl, rw), (gs, gl, gw) = res["ref"], res["got"]
    assert (rs, rl) == (gs, gl)
    assert rw.shape == gw.shape and np.array_equal(rw, gw), (
        f"{op}: {np.count_nonzero(rw != gw)} words differ")
