"""The port's wire format and secure-inference service on the u64 engine
(int64 words, ``"uint64"`` blobs) against the JAX package on the CPU, on
tests/test_net.py's own chain (logN=9, q0 of 50 bits, 40-bit scale primes,
a 51-bit special prime; tests/torch_net_common.py).

``carry`` moves uint64 state both ways, and every blob kind crosses
between the packages both ways ``array_equal``, as the uint32 blobs do in
tests/test_torch_net.py, whose case helpers this file reuses. The gRPC
cases need grpcio.
"""

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu.net import serialize as JS
from fhe_gpt2_tpu_torch.net import serialize as S
from fhe_gpt2_tpu_torch.net import service

import test_torch_net as N
from torch_net_common import U64_CHAIN, build, encrypt
from torch_port_common import (CPU, assert_same, carry, ref_plain,
                               single_torch_thread, to_port)  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    s = build(steps=[1], chain=U64_CHAIN)
    assert s["ctx"].dtype == torch.int64
    return s


def test_carry_moves_uint64_state_both_ways(setup):
    s = setup
    z = np.random.default_rng(0).uniform(-1, 1, s["ctx"].params.slots)
    jct = encrypt(s, z)
    assert np.asarray(jct.data).dtype == np.uint64
    ct = to_port(jct)
    assert ct.data.dtype == torch.int64
    back = carry.to_numpy(ct)
    assert back.dtype == np.uint64 and np.array_equal(back,
                                                      np.asarray(jct.data))
    assert carry.to_numpy(s["secret"]).dtype == np.uint64
    with pytest.raises(TypeError, match="uint32 or uint64"):
        carry.ciphertext_from_reference(np.zeros((2, 3, 8), np.int64), 1.0,
                                        CPU)
    assert np.allclose(s["dec"].decrypt(ct), z, atol=1e-6)


def test_u64_serialize_roundtrips(setup):
    s = setup
    z = np.random.default_rng(1).uniform(-1, 1, s["ctx"].params.slots)
    ct = to_port(encrypt(s, z))
    blob = S.dump_ciphertext(ct)
    assert S._unpack(blob)[0]["dtype"] == "uint64"
    ct2 = S.load_ciphertext(blob, CPU)
    assert ct2.scale == ct.scale and ct2.data.dtype == torch.int64
    assert np.array_equal(carry.to_numpy(ct2), carry.to_numpy(ct))
    assert np.allclose(s["dec"].decrypt(ct2), z, atol=1e-6)
    assert S.load_params(S.dump_params(s["p"])) == s["p"]
    rk = s["ev"].relin_key
    rk2 = S.load_kswitch_key(S.dump_kswitch_key(rk), CPU)
    assert np.array_equal(carry.to_numpy(rk2), carry.to_numpy(rk))


@pytest.mark.parametrize("kind", ["ct", "ksk", "galois", "gal_elt",
                                  "params"])
def test_u64_blobs_cross_packages(setup, kind):
    jblob, blob, port_loads, jax_loads = N._objects(setup)[kind]
    assert S.peek_kind(jblob) == JS.peek_kind(blob) == kind
    port_loads(jblob)
    jax_loads(blob)
    got, jgot, ref = S._unpack(blob), JS._unpack(blob), JS._unpack(jblob)
    assert got[0] == jgot[0] == ref[0]
    if kind == "galois":
        got, jgot, ref = (N._frames(u[0], u[1]) for u in (got, jgot, ref))
    assert got == jgot == ref


def test_u64_seeded_ciphertext_crosses(setup):
    s = setup
    jctx, ctx = s["jctx"], s["ctx"]
    x = np.random.default_rng(0).uniform(-1, 1, jctx.params.slots)
    jct, seed = s["jenc"].encrypt_symmetric_seeded(
        ref_plain(jctx, x, jctx.params.scale, range(jctx.L)))
    jblob = JS.dump_ciphertext_seeded(jct, seed)
    blob = S.dump_ciphertext_seeded(to_port(jct), seed)
    assert S._unpack(blob) == JS._unpack(jblob)
    back = S.load_ciphertext_seeded(jblob, ctx)
    assert back.data.dtype == torch.int64
    assert_same(back, jct, "seeded, port load")
    assert_same(back, JS.load_ciphertext_seeded(blob, jctx), "seeded, JAX load")
    assert np.abs(np.real(s["dec"].decrypt(back)) - x).max() < 1e-6


def model(B, ct):
    """Encrypted x² + rotate(x, 1) (tests/test_net.py's model)."""
    return B.add(B.square(ct), B.rotate(ct, 1))


def test_u64_grpc_loopback(setup):
    """The port's server on the u64 chain: streamed key upload and answers
    equal to the JAX evaluator's."""
    pytest.importorskip("grpc")
    s = setup
    zs = [np.random.default_rng(i).uniform(-1, 1, s["ctx"].params.slots)
          for i in (3, 4)]
    jcts = [encrypt(s, z) for z in zs]
    server = service.SecureInferenceServer(model_fn=model, port=0,
                                           device=CPU).start()
    try:
        client = service.SecureInferenceClient(f"localhost:{server.port}",
                                               device=CPU)
        client.init_session_stream(s["p"], relin_key=s["ev"].relin_key,
                                   galois_keys=s["ev"].galois_keys)
        outs = client.evaluate_stream([to_port(c) for c in jcts])
    finally:
        server.stop()
    for out, jct, z in zip(outs, jcts, zs):
        assert_same(out, model(s["jB"], jct), "served answer")
        assert np.allclose(s["dec"].decrypt(out), z * z + np.roll(z, -1),
                           atol=1e-3)
