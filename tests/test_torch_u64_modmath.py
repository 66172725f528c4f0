"""The port's 64-bit modular arithmetic (int64 words) against Python ints
and the JAX package's u64 ``modmath``.

No int64 op may wrap: the operands are pinned at the edges (0, 1, q-1,
2**61-1 where it is below q) for moduli of 30 to 61 bits, and hypothesis
draws the rest. Every canonical op equals Python's exact result and the
JAX u64 op on the same words; the lazy Shoup product equals the JAX lazy
product word for word (both words).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from fhe_gpt2_tpu.core import modmath as J
from fhe_gpt2_tpu.core.evaluator import mod_sum as jmod_sum
from fhe_gpt2_tpu_torch.core import modmath as M

BITS = [30, 40, 50, 51, 60, 61]
W = 16                     # operand width: one JAX compile per op


def _prime_like(bits: int, rng) -> int:
    """An odd modulus of exactly `bits` bits (primality is not needed)."""
    return int(rng.integers(1 << (bits - 1), 1 << bits, dtype=np.uint64)) | 1


def _operands(q: int, rng) -> list[int]:
    edge = [0, 1, q - 1, q - 2, q // 2]
    if (1 << 61) - 1 < q:
        edge.append((1 << 61) - 1)
    rest = [int(v) for v in rng.integers(0, q, W - len(edge), dtype=np.uint64)]
    return edge + rest


def _t(vals) -> torch.Tensor:
    return M.word_tensor(vals, "cpu", word=np.uint64)


def _consts(q: int):
    r0, r1 = M.barrett_ratio(q, 64)
    return _t([q]), _t([r0]), _t([r1])


def _py(t: torch.Tensor) -> list[int]:
    return [int(v) for v in M.to_numpy_u64(t)]


@pytest.mark.parametrize("bits", BITS)
def test_u64_ops_equal_python_and_jax(bits):
    rng = np.random.default_rng(bits)
    q = _prime_like(bits, rng)
    a_l = _operands(q, rng)
    b_l = a_l[::-1]
    a, b = _t(a_l), _t(b_l)
    Q, R0, R1 = _consts(q)
    ja, jb = jnp.asarray(np.array(a_l, np.uint64)), jnp.asarray(
        np.array(b_l, np.uint64))
    jq = jnp.asarray(np.array([q], np.uint64))
    jr0, jr1 = (jnp.asarray(np.array([r], np.uint64))
                for r in M.barrett_ratio(q, 64))

    def same(got, want_py, want_jax, what):
        assert _py(got) == want_py, what
        assert np.array_equal(M.to_numpy_u64(got), np.asarray(want_jax)), what

    same(M.mul_mod(a, b, Q, R0, R1), [x * y % q for x, y in zip(a_l, b_l)],
         J.mul_mod(ja, jb, jq, jr0, jr1), "mul_mod")
    same(M.add_mod(a, b, Q), [(x + y) % q for x, y in zip(a_l, b_l)],
         J.add_mod(ja, jb, jq), "add_mod")
    same(M.sub_mod(a, b, Q), [(x - y) % q for x, y in zip(a_l, b_l)],
         J.sub_mod(ja, jb, jq), "sub_mod")
    same(M.neg_mod(a, Q), [-x % q for x in a_l], J.neg_mod(ja, jq), "neg_mod")
    for w in (1, q - 1, b_l[-1]):
        ws = M.shoup(w, q, 64)
        jw, jws = (jnp.asarray(np.array([v], np.uint64)) for v in (w, ws))
        same(M.mul_mod_shoup(a, _t([w]), _t([ws]), Q),
             [x * w % q for x in a_l],
             J.mul_mod_shoup(ja, jw, jws, jq), f"mul_mod_shoup w={w}")
        lazy = M.mul_mod_shoup_lazy(a, _t([w]), _t([ws]), Q)
        assert all(v < 2 * q and v % q == x * w % q
                   for v, x in zip(_py(lazy), a_l))
        assert np.array_equal(M.to_numpy_u64(lazy), np.asarray(
            J.mul_mod_shoup_lazy(ja, jw, jws, jq))), "mul_mod_shoup_lazy"
    big = [(x << (62 - bits)) + y for x, y in zip(a_l, b_l)]   # < 2^63
    same(M.barrett_reduce(_t(big), Q), [v % q for v in big],
         J.barrett_reduce(jnp.asarray(np.array(big, np.uint64)), jq, jr1),
         "barrett_reduce")
    # A double-width value below q·2^62: the port's pair is base 2^62, the
    # JAX pair base 2^64; both reduce the same number.
    wide = [x * y for x, y in zip(a_l, b_l)]
    got = M.barrett_reduce_wide(_t([v >> 62 for v in wide]),
                                _t([v & ((1 << 62) - 1) for v in wide]),
                                Q, R0, R1)
    same(got, [v % q for v in wide], J.barrett_reduce_wide(
        jnp.asarray(np.array([v >> 64 for v in wide], np.uint64)),
        jnp.asarray(np.array([v & ((1 << 64) - 1) for v in wide], np.uint64)),
        jq, jr0, jr1), "barrett_reduce_wide")


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("terms", [1, 2, 7, 36])
def test_u64_mod_sum_equals_python_and_jax(bits, terms):
    """The tree of add_mod (residues up to 2^61 cannot share a raw int64
    sum) against Python's sum and the JAX grouped Barrett fold."""
    rng = np.random.default_rng(terms * 100 + bits)
    q = _prime_like(bits, rng)
    x = np.stack([np.array(_operands(q, rng), np.uint64)
                  for _ in range(terms)])
    Q = _t([q])
    got = M.mod_sum(_t(x), Q, axis=0)
    want = [sum(int(v) for v in col) % q for col in x.T]
    assert _py(got) == want
    jr1 = jnp.asarray(np.array([M.barrett_ratio(q, 64)[1]], np.uint64))
    assert np.array_equal(M.to_numpy_u64(got), np.asarray(jmod_sum(
        jnp.asarray(x), jnp.asarray(np.array([q], np.uint64)), jr1, axis=0)))


def test_u32_lazy_and_wide_equal_jax():
    """The int32 word's counterparts of the lazy Shoup product and the wide
    Barrett reduction, against the JAX u32 ops."""
    rng = np.random.default_rng(5)
    q = (1 << 31) - 1
    a_l = _operands(q, rng)
    a = M.word_tensor(a_l, "cpu")
    ja = jnp.asarray(np.array(a_l, np.uint32))
    jq = jnp.asarray(np.array([q], np.uint32))
    w = q - 3
    ws = M.shoup(w, q, 32)
    got = M.mul_mod_shoup_lazy(a, M.word_tensor([w], "cpu"),
                               M.word_tensor([ws], "cpu"),
                               M.word_tensor([q], "cpu"))
    want = J.mul_mod_shoup_lazy(ja, jnp.asarray(np.array([w], np.uint32)),
                                jnp.asarray(np.array([ws], np.uint32)), jq)
    assert np.array_equal(M.to_numpy_u32(got), np.asarray(want))
    hi, lo = [x % q for x in a_l], a_l[::-1]
    r0, r1 = M.barrett_ratio(q, 32)
    got = M.barrett_reduce_wide(M.word_tensor(hi, "cpu"),
                                M.word_tensor(lo, "cpu"),
                                M.word_tensor([q], "cpu"), None, None)
    want = J.barrett_reduce_wide(
        jnp.asarray(np.array(hi, np.uint32)),
        jnp.asarray(np.array(lo, np.uint32)), jq,
        jnp.asarray(np.array([r0], np.uint32)),
        jnp.asarray(np.array([r1], np.uint32)))
    assert np.array_equal(M.to_numpy_u32(got), np.asarray(want))
    assert [int(v) for v in M.to_numpy_u32(got)] == [
        (h << 32 | l) % q for h, l in zip(hi, lo)]


def test_lazy_group_keeps_int64_sums_below_2_63():
    assert M.lazy_group(torch.int64) == 2
    assert 2 * (M.MAX_MODULUS - 1) < 1 << 63
    assert M.lazy_group(torch.int32) * ((1 << 31) - 1) < 1 << 63


def test_word_tensor_keeps_uint64_bits():
    vals = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    t = M.word_tensor(vals, "cpu", word=np.uint64)
    assert t.dtype == torch.int64
    assert [int(v) for v in M.to_numpy_word(t)] == vals
    assert M.word_tensor([5], "cpu").dtype == torch.int32


def test_mul_mod_needs_the_ratio_words_on_int64():
    with pytest.raises(ValueError, match="Barrett"):
        M.mul_mod(_t([3]), _t([4]), _t([7]))


_Q = st.sampled_from(BITS).flatmap(
    lambda b: st.integers(1 << (b - 1), (1 << b) - 1).map(lambda q: q | 1))


@settings(max_examples=300, deadline=None)
@given(data=st.data())
def test_u64_products_equal_python_ints(data):
    q = data.draw(_Q)
    vals = st.lists(st.integers(0, q - 1), min_size=W, max_size=W)
    a_l, b_l = data.draw(vals), data.draw(vals)
    w = data.draw(st.integers(0, q - 1))
    Q, R0, R1 = _consts(q)
    a, b = _t(a_l), _t(b_l)
    assert _py(M.mul_mod(a, b, Q, R0, R1)) == [
        x * y % q for x, y in zip(a_l, b_l)]
    assert _py(M.mul_mod_shoup(a, _t([w]), _t([M.shoup(w, q, 64)]), Q)) == [
        x * w % q for x in a_l]
    hi, lo = M.mulwide(a, b)
    assert [h << 62 | l for h, l in zip(_py(hi), _py(lo))] == [
        x * y for x, y in zip(a_l, b_l)]
    assert _py(M.mod_sum(torch.stack([a, b, a]), Q)) == [
        (2 * x + y) % q for x, y in zip(a_l, b_l)]
