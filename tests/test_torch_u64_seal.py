"""The port against the vendored modified SEAL 3.6.6, bit for bit: the four
checks of tests/test_seal_vectors.py (Galois element convention, decode,
square+relin+rescale, rotate by one) on the port's u64 engine on the CPU.
The vectors and the session are in tests/torch_seal_common.py.
"""

import numpy as np
import pytest
import torch

from torch_port_common import single_torch_thread  # noqa: F401
from torch_seal_common import seal_session, to_coeff


@pytest.fixture(scope="module")
def seal():
    return seal_session("cpu")


def test_galois_elt_convention(seal):
    v, ctx, *_ = seal
    assert ctx.word == np.uint64
    assert ctx.galois_elt_from_step(1) == int(v["galois_elt_step1"][0])


def test_decode_matches_encoded_values(seal):
    """The port's decode of SEAL's fresh ciphertext recovers the encoded
    vector."""
    v, ctx, ev, dec, load_ct, L = seal
    z = dec.decrypt(load_ct("ct_in", L))
    want = np.sin(0.001 * np.arange(ctx.params.slots))
    assert np.abs(np.real(z) - want).max() < 1e-6


def test_square_relin_rescale_bit_exact(seal):
    """The port's square+relin+rescale on SEAL's ciphertext with SEAL's
    relin key reproduces SEAL's output ciphertext bit for bit
    (coefficient domain), and so does its decryption."""
    v, ctx, ev, dec, load_ct, L = seal
    out = ev.rescale(ev.square(load_ct("ct_in", L)))
    assert out.data.dtype == torch.int64
    got = to_coeff(ctx, out.data, L - 1)
    want = np.stack([v["ct_sq_c0"], v["ct_sq_c1"]])
    assert np.array_equal(got, want), "square+relin+rescale differs from SEAL"
    assert np.array_equal(dec.decrypt_to_rns(out), v["plain_sq"])


def test_rotate_bit_exact(seal):
    v, ctx, ev, dec, load_ct, L = seal
    out = ev.rotate(load_ct("ct_in", L), 1)
    got = to_coeff(ctx, out.data, L)
    want = np.stack([v["ct_rot_c0"], v["ct_rot_c1"]])
    assert np.array_equal(got, want), "rotation differs from SEAL"
    assert np.array_equal(dec.decrypt_to_rns(out), v["plain_rot"])
