"""The port's wire format (fhe_gpt2_tpu_torch/net/serialize.py) and PIR
(net/pir.py) against the JAX package on the CPU, case by case after
tests/test_net.py, on a uint32 chain (tests/torch_net_common.py).

Blobs cross between the packages both ways: a JAX blob loads into the port
and a port blob into the JAX package with the same words, and both sides
read the same header and payload from either. The PIR answers are
``array_equal`` to the JAX package's on carried keys and queries.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fhe_gpt2_tpu.core.evaluator import Ciphertext as JCiphertext
from fhe_gpt2_tpu.net import pir as jpir
from fhe_gpt2_tpu.net import serialize as JS
from fhe_gpt2_tpu.nn.backend import PlainBackend as JPlainBackend

from fhe_gpt2_tpu_torch.core.keys import GaloisKeys
from fhe_gpt2_tpu_torch.net import pir
from fhe_gpt2_tpu_torch.net import serialize as S
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend

from torch_net_common import build, encrypt
from torch_port_common import (CPU, assert_same, carry, ref_plain,
                               single_torch_thread, to_port)  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    return build(steps=[1])


def _same_key(got, ref):
    assert np.array_equal(carry.to_numpy(got), np.asarray(ref.data))


def test_serialize_roundtrips(setup):
    """The port's own blobs load back into the port (test_net's round
    trips)."""
    s = setup
    z = np.random.default_rng(0).uniform(-1, 1, s["ctx"].params.slots)
    ct = to_port(encrypt(s, z))
    ct2 = S.load_ciphertext(S.dump_ciphertext(ct), CPU)
    assert ct2.scale == ct.scale
    assert np.array_equal(carry.to_numpy(ct2), carry.to_numpy(ct))
    assert np.allclose(s["dec"].decrypt(ct2), z, atol=1e-5)
    assert S.load_params(S.dump_params(s["p"])) == s["p"]
    rk = s["ev"].relin_key
    rk2 = S.load_kswitch_key(S.dump_kswitch_key(rk), CPU)
    assert np.array_equal(carry.to_numpy(rk2), carry.to_numpy(rk))
    gk2 = S.load_galois_keys(S.dump_galois_keys(s["ev"].galois_keys), CPU)
    assert set(gk2.keys) == set(s["ev"].galois_keys.keys)
    for e, k in gk2.keys.items():
        assert np.array_equal(carry.to_numpy(k),
                              carry.to_numpy(s["ev"].galois_keys.keys[e]))


def _objects(s):
    """{kind: (JAX blob, port blob, check(loaded port obj), check(loaded
    JAX obj))} for every blob kind, the port's objects carried from the
    JAX package's."""
    z = np.random.default_rng(1).uniform(-1, 1, s["jctx"].params.slots)
    jct = encrypt(s, z)
    ct = to_port(jct)
    jrk, rk = s["jev"].relin_key, s["ev"].relin_key
    jgk, gk = s["jev"].galois_keys, s["ev"].galois_keys
    elt = sorted(jgk.keys)[0]
    # The port's parameter set is built by the port; the JAX package's by
    # the JAX package: equal fields, so equal headers.
    return {
        "ct": (JS.dump_ciphertext(jct), S.dump_ciphertext(ct),
               lambda b: assert_same(S.load_ciphertext(b, CPU), jct, "ct"),
               lambda b: assert_same(ct, JS.load_ciphertext(b), "ct")),
        "ksk": (JS.dump_kswitch_key(jrk), S.dump_kswitch_key(rk),
                lambda b: _same_key(S.load_kswitch_key(b, CPU), jrk),
                lambda b: _same_key(rk, JS.load_kswitch_key(b))),
        "galois": (JS.dump_galois_keys(jgk), S.dump_galois_keys(gk),
                   lambda b: [_same_key(k, jgk.keys[e]) for e, k in
                              S.load_galois_keys(b, CPU).keys.items()],
                   lambda b: [_same_key(gk.keys[e], k) for e, k in
                              JS.load_galois_keys(b).keys.items()]),
        "gal_elt": (JS.dump_galois_elt(elt, jgk.keys[elt]),
                    S.dump_galois_elt(elt, gk.keys[elt]),
                    lambda b: _same_key(S.load_galois_elt(b, CPU)[1],
                                        jgk.keys[elt]),
                    lambda b: _same_key(gk.keys[elt],
                                        JS.load_galois_elt(b)[1])),
        "params": (JS.dump_params(s["jp"]), S.dump_params(s["p"]),
                   lambda b: _check(S.load_params(b) == s["p"]),
                   lambda b: _check(JS.load_params(b) == s["jp"])),
    }


def _check(ok):
    assert ok


@pytest.mark.parametrize("kind", ["ct", "ksk", "galois", "gal_elt",
                                  "params"])
def test_blobs_cross_packages(setup, kind):
    jblob, blob, port_loads, jax_loads = _objects(setup)[kind]
    assert S.peek_kind(jblob) == JS.peek_kind(blob) == kind
    port_loads(jblob)
    jax_loads(blob)
    # The same header and payload on both sides, whichever side reads. A
    # Galois-keys payload holds compressed frames: compare each frame's.
    got, jgot, ref = S._unpack(blob), JS._unpack(blob), JS._unpack(jblob)
    assert got[0] == jgot[0] == ref[0]
    if kind == "galois":
        got, jgot, ref = (_frames(u[0], u[1]) for u in (got, jgot, ref))
    assert got == jgot == ref


def _frames(h, payload) -> list:
    out, off = [], 0
    for size in h["sizes"]:
        out.append(JS._unpack(payload[off:off + size]))
        off += size
    return out


def test_seeded_ciphertext_crosses(setup):
    """The seeded form: half the payload, and the c1 re-expanded from the
    seed by either package gives the same ciphertext."""
    s = setup
    jctx, ctx = s["jctx"], s["ctx"]
    x = np.random.default_rng(0).uniform(-1, 1, jctx.params.slots)
    jct, seed = s["jenc"].encrypt_symmetric_seeded(
        ref_plain(jctx, x, jctx.params.scale, range(jctx.L)))
    jblob = JS.dump_ciphertext_seeded(jct, seed)
    blob = S.dump_ciphertext_seeded(to_port(jct), seed)
    assert len(blob) < 0.6 * len(S.dump_ciphertext(to_port(jct)))
    assert S._unpack(blob) == JS._unpack(jblob)
    back = S.load_ciphertext_seeded(jblob, ctx)
    assert_same(back, jct, "seeded, port load")
    assert_same(back, JS.load_ciphertext_seeded(blob, jctx), "seeded, JAX load")
    assert np.abs(np.real(s["dec"].decrypt(back)) - x).max() < 1e-5


@pytest.mark.parametrize("header", [{"dtype": "uint64"}, {}])
def test_uint64_blob_raises(header):
    """A u64-engine blob (or one without a dtype, which the JAX loaders
    read as uint64) loads into int64 words with the same bits, now that the
    port has the u64 engine; a blob of any other dtype raises."""
    arr = np.arange(2 * 3 * 512, dtype=np.uint64).reshape(2, 3, 512) << 40
    blob = JS._pack({"kind": "ct", "scale": 1.0, "shape": list(arr.shape),
                     **header}, arr.tobytes())
    ct = S.load_ciphertext(blob, CPU)
    assert ct.data.dtype == torch.int64
    assert np.array_equal(carry.to_numpy(ct), arr)
    key = np.full((1, 2, 5, 512), (1 << 63) + 7, dtype=np.uint64)
    ksk = JS._pack({"kind": "ksk", "shape": [1, 2, 5, 512], **header},
                   key.tobytes())
    assert np.array_equal(carry.to_numpy(S.load_kswitch_key(ksk, CPU)), key)
    # A JAX u64 ciphertext, as the JAX package writes it.
    jblob = JS.dump_ciphertext(JCiphertext(jnp.asarray(arr), 1.0))
    assert np.array_equal(carry.to_numpy(S.load_ciphertext(jblob, CPU)), arr)
    bad = JS._pack({"kind": "ct", "scale": 1.0, "shape": list(arr.shape),
                    "dtype": "int16"}, arr.astype(np.int16).tobytes())
    with pytest.raises(ValueError, match="int16"):
        S.load_ciphertext(bad, CPU)


def _keys_for(s, steps):
    """The JAX and port evaluators' Galois keys extended to ``steps``
    (JAX keys from the same generator, carried)."""
    jgk = s["kg"].galois_keys(steps=list(steps))
    s["jev"].galois_keys = jgk
    s["ev"].galois_keys = carry.galois_keys_from_reference(
        {e: np.asarray(k.data) for e, k in jgk.keys.items()}, CPU)


def test_pir_embedding_lookup(setup):
    """Encrypted one-hot -> embedding row: the vocabulary spans 3
    ciphertexts of 256 slots; plain answers exact, encrypted answers the
    JAX package's words."""
    s = setup
    slots = s["ctx"].params.slots
    V, d, tok = 600, 32, 123
    table = np.random.default_rng(7).standard_normal((V, d))
    srv = pir.EmbeddingPIRServer(table, slots)
    jsrv = jpir.EmbeddingPIRServer(table, slots)
    assert srv.required_steps() == jsrv.required_steps()
    q = pir.make_query(tok, V, slots)
    assert np.array_equal(q, jpir.make_query(tok, V, slots))
    out_p = srv.answer(PlainBackend(slots), list(q))
    assert np.array_equal(out_p, jsrv.answer(JPlainBackend(slots), list(q)))
    assert np.array_equal(np.asarray(out_p).ravel()[:d], table[tok])
    _keys_for(s, srv.required_steps())
    jq = [encrypt(s, row) for row in q]
    want = jsrv.answer(s["jB"], jq)
    got = srv.answer(s["B"], [to_port(c) for c in jq])
    assert_same(got, want, "PIR answer")
    assert np.abs(s["dec"].decrypt(got).real[:d] - table[tok]).max() < 1e-3


def test_batch_pir_encrypted(setup):
    """Vectorized BatchPIR: 6 lookups in one round over cuckoo-hashed
    buckets; plain answers exact, encrypted answers the JAX package's
    words."""
    s = setup
    slots = s["ctx"].params.slots
    vocab, d, batch = 120, 8, 6
    table = np.random.default_rng(3).standard_normal((vocab, d))
    srv = pir.BatchPIRServer(table, slots, batch_size=batch)
    jsrv = jpir.BatchPIRServer(table, slots, batch_size=batch)
    cli = pir.BatchPIRClient(vocab, slots, batch, d)
    jcli = jpir.BatchPIRClient(vocab, slots, batch, d)
    assert srv.st == cli.st == jsrv.st and srv.n_cts == cli.n_cts
    assert srv.required_steps() == jsrv.required_steps()
    tokens = [3, 77, 31, 119, 0, 64]
    q, asg = cli.make_queries(tokens)
    jq, jasg = jcli.make_queries(tokens)
    assert np.array_equal(q, jq) and asg == jasg
    assert len({asg[t] for t in tokens}) == batch
    plain = np.stack(srv.answer(PlainBackend(slots), list(q))).reshape(
        -1, slots)
    assert np.array_equal(cli.extract(plain, asg, tokens), table[tokens])
    _keys_for(s, srv.required_steps())
    jcts = [encrypt(s, row) for row in q]
    want = jsrv.answer(s["jB"], jcts)
    got = srv.answer(s["B"], [to_port(c) for c in jcts])
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"BatchPIR answer {i}")
    ans = np.stack([s["dec"].decrypt(a).real for a in got])
    assert np.abs(cli.extract(ans, asg, tokens) - table[tokens]).max() < 1e-3


def test_galois_keys_blob_holds_frames(setup):
    """A Galois-keys blob is frames of ksk blobs, in element order, that
    either package reads."""
    gk = setup["ev"].galois_keys
    h, payload = S._unpack(S.dump_galois_keys(gk))
    assert h["elts"] == sorted(gk.keys)
    off = 0
    for e, size in zip(h["elts"], h["sizes"]):
        frame = payload[off:off + size]
        assert JS.peek_kind(frame) == "ksk"
        _same_key(gk.keys[e], JS.load_kswitch_key(frame))
        off += size
    assert off == len(payload)
    assert isinstance(S.load_galois_keys(S.dump_galois_keys(GaloisKeys()),
                                         CPU), GaloisKeys)
