"""The port's CKKS backend on the u64 engine (int64 words, CPU) against the
JAX package's, after tests/test_encrypted_nn.py: the masked sums (whose
int64 sum of products would overflow for 62-bit residues, so the port folds
them with ``add_mod``), one encrypted BSGS linear transform (double-hoisted
and single-hoisted), on a u64 chain at logN=10
(q0 of 50 bits, 40-bit scale primes, a 51-bit special prime, h=32; keys
from seed 5, encryptions from seed 6, as the JAX test's).

Tolerance: exact (``array_equal`` words, equal scales); the decrypts are
held to the JAX test's bound (1e-4 against the plain run). The encrypted
LayerNorm is in tests/test_torch_u64_nn_ln.py.
"""

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu.nn import linear as jlinear
from fhe_gpt2_tpu.nn.backend import CkksBackend as JCkksBackend
from fhe_gpt2_tpu.nn.formats import TightLayout as JTightLayout
from fhe_gpt2_tpu.nn.formats import matmul_spec as jmatmul_spec
from fhe_gpt2_tpu_torch.core.modmath import word_tensor
from fhe_gpt2_tpu_torch.nn import backend, linear
from fhe_gpt2_tpu_torch.nn.backend import CkksBackend, PlainBackend, \
    RecordingBackend
from fhe_gpt2_tpu_torch.nn.formats import TightLayout, matmul_spec

from torch_port_common import (CPU, JContext, JEncryptor, JEvaluator,
                               JKeyGenerator, JParams, CkksContext,
                               CkksParams, Decryptor, Encryptor, Evaluator,
                               KeyGenerator, fast_encoding, same_cts,
                               single_torch_thread)  # noqa: F401

LOGN = 10
SLOTS = 1 << (LOGN - 1)
CHAIN = dict(logn=LOGN, log_q0=50, log_scale=40, num_levels=22,
             log_special=51, hamming_weight=32)


def backends(steps, levels=22):
    """(port CkksBackend, JAX CkksBackend) on CHAIN cut to `levels`."""
    from fhe_gpt2_tpu.core.evaluator import Decryptor as JDecryptor
    kw = dict(CHAIN, num_levels=levels)
    out = []
    for C, KG, EV, ENC, DEC, BK in (
            (CkksContext(CkksParams.create(**kw), device=CPU), KeyGenerator,
             Evaluator, Encryptor, Decryptor, CkksBackend),
            (JContext(JParams.create(**kw)), JKeyGenerator, JEvaluator,
             JEncryptor, JDecryptor, JCkksBackend)):
        kg = KG(C, seed=5)
        ev = EV(C, relin_key=kg.relin_key(),
                galois_keys=kg.galois_keys(steps=sorted(steps)))
        if BK is JCkksBackend:
            fast_encoding(ev)
        out.append(BK(ctx=C, ev=ev, enc=ENC(C, secret=kg.secret, seed=6),
                      dec=DEC(C, kg.secret), default_level=levels))
    assert out[0].ctx.dtype == torch.int64
    return tuple(out)


def test_u64_masked_sum_of_largest_words_equals_python():
    """Σ_t v_t·p_t mod q with every word q-1 on 60- and 61-bit limbs: the
    products' int64 sum would pass 2^63 at the second term."""
    from fhe_gpt2_tpu_torch.core import ntt as nttmod, primes
    n = 16
    mods = primes.gen_primes(60, 1, 2 * n) + primes.gen_primes(61, 1, 2 * n)
    t = nttmod.make_ntt_tables(mods, n, CPU)
    top = np.array([[q - 1] * n for q in mods], dtype=np.uint64)
    terms = 11                     # more than MAC_CHUNK: two chunks
    vals = [word_tensor(np.stack([top, top]), CPU, word=np.uint64)
            for _ in range(terms)]
    pts = [word_tensor(top, CPU, word=np.uint64) for _ in range(terms)]
    got = backend._masked_sum(vals, pts, t)
    assert got.dtype == torch.int64 and got.shape == (2, 2, n)
    for li, q in enumerate(mods):
        assert (got[:, li] == terms % q).all()


@pytest.mark.parametrize("no_ext_hoist", [False, True])
def test_u64_encrypted_matmul_equals_reference(no_ext_hoist):
    """One BSGS matmul (8 x 12 by 12 x 12): the double-hoisted path's masked
    sums in the QP basis (``lt_mask_sum_ext``) and the single-hoisted
    path's (``mul_plain_many_sum``)."""
    rng = np.random.default_rng(0)
    rows, d = 8, 12
    lay, jlay = TightLayout(rows, d, SLOTS), JTightLayout(rows, d, SLOTS)
    A = rng.standard_normal((rows, d)) * 0.5
    W = rng.standard_normal((d, d)) * 0.3
    plan, jplan = matmul_spec(W, lay).bsgs_plan(), \
        jmatmul_spec(W, jlay).bsgs_plan()
    rec = RecordingBackend(SLOTS)
    xs_p = list(lay.pack(A))
    linear.apply_lt(rec, plan, xs_p)
    B, jB = backends(rec.key_steps(), levels=4)
    B.no_ext_hoist = jB.no_ext_hoist = no_ext_hoist
    xs, jxs = [B.from_slots(v) for v in xs_p], [jB.from_slots(v)
                                                for v in xs_p]
    same_cts(xs, jxs, "inputs")
    out = linear.apply_lt(B, plan, xs)
    same_cts(out, jlinear.apply_lt(jB, jplan, jxs), "matmul")
    got = np.stack([B.to_slots(o) for o in out])
    want = np.stack(linear.apply_lt(PlainBackend(SLOTS), plan, xs_p))
    assert np.abs(got - want).max() < 1e-4
