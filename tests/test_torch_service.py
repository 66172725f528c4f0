"""The port's secure-inference service (fhe_gpt2_tpu_torch/net/service.py)
and telemetry (utils/telemetry.py) against the JAX package on the CPU, after
tests/test_net.py's gRPC cases and tests/test_aux.py's telemetry case.

The port's server runs on ``device="cpu"`` over a loopback gRPC channel;
its answers are ``array_equal`` to the JAX evaluator's on the same inputs,
and a JAX client talking to the port's server loads the JAX server's
answer. The server holds no secret: its backend has no encryptor and no
decryptor.
"""

import numpy as np
import pytest

from fhe_gpt2_tpu.net import service as jservice
from fhe_gpt2_tpu.nn import layers as jL
from fhe_gpt2_tpu.nn.backend import PlainBackend as JPlainBackend
from fhe_gpt2_tpu.utils.telemetry import TelemetryBackend as JTelemetry

from fhe_gpt2_tpu_torch.net import service
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend
from fhe_gpt2_tpu_torch.utils.telemetry import TelemetryBackend

from torch_net_common import build, encrypt
from torch_port_common import (CPU, assert_same, single_torch_thread,
                               to_port)  # noqa: F401


def model(B, ct):
    """Encrypted x² + rotate(x, 1) (tests/test_net.py's model)."""
    return B.add(B.square(ct), B.rotate(ct, 1))


@pytest.fixture(scope="module")
def setup():
    s = build(steps=[1])
    rng = np.random.default_rng(2)
    zs = [rng.uniform(-1, 1, s["ctx"].params.slots) for _ in range(3)]
    jcts = [encrypt(s, z) for z in zs]
    s["zs"], s["jcts"] = zs, jcts
    s["want"] = [model(s["jB"], c) for c in jcts]
    return s


def _serve(s):
    pytest.importorskip("grpc")
    seen = {}

    def fn(B, ct):
        seen["backend"] = B
        return model(B, ct)

    return service.SecureInferenceServer(model_fn=fn, port=0,
                                         device=CPU).start(), seen


def test_grpc_loopback(setup):
    s = setup
    server, seen = _serve(s)
    try:
        client = service.SecureInferenceClient(f"localhost:{server.port}",
                                               device=CPU)
        client.init_session(s["p"], relin_key=s["ev"].relin_key,
                            galois_keys=s["ev"].galois_keys)
        out = client.evaluate(to_port(s["jcts"][0]))
    finally:
        server.stop()
    B = seen["backend"]
    assert B.enc is None and B.dec is None and B.ctx.device.type == "cpu"
    assert_same(out, s["want"][0], "served answer")
    z = s["zs"][0]
    assert np.allclose(s["dec"].decrypt(out), z * z + np.roll(z, -1),
                       atol=1e-3)


def test_grpc_streaming_loopback(setup):
    """Streaming key upload and the bidirectional evaluate loop."""
    s = setup
    server, _ = _serve(s)
    try:
        client = service.SecureInferenceClient(f"localhost:{server.port}",
                                               device=CPU)
        client.init_session_stream(s["p"], relin_key=s["ev"].relin_key,
                                   galois_keys=s["ev"].galois_keys)
        outs = client.evaluate_stream([to_port(c) for c in s["jcts"]])
    finally:
        server.stop()
    assert len(outs) == 3
    for i, (out, want, z) in enumerate(zip(outs, s["want"], s["zs"])):
        assert_same(out, want, f"streamed answer {i}")
        assert np.allclose(s["dec"].decrypt(out), z * z + np.roll(z, -1),
                           atol=1e-3)


def test_handlers_without_grpc(setup):
    """The handler methods take the frames in process, as a transport
    without gRPC feeds them."""
    from fhe_gpt2_tpu_torch.net import serialize as S
    s = setup
    server = service.SecureInferenceServer(model_fn=model, device=CPU)
    frames = [S.dump_params(s["p"]), S.dump_kswitch_key(s["ev"].relin_key)]
    frames += [S.dump_galois_elt(e, k)
               for e, k in sorted(s["ev"].galois_keys.keys.items())]
    assert server._init_session_stream(iter(frames), None) == b"ok"
    [blob] = server._evaluate_stream(
        iter([S.dump_ciphertext(to_port(s["jcts"][1]))]), None)
    assert_same(S.load_ciphertext(blob, CPU), s["want"][1], "in process")
    with pytest.raises(ValueError, match="params"):
        server._init_session_stream(iter(frames[1:]), None)


def test_jax_client_against_port_server(setup):
    """The JAX client uploads its keys to the port's server and loads the
    answer the JAX server gives."""
    pytest.importorskip("grpc")
    s = setup
    jev = s["jev"]
    answers = []
    for srv in (jservice.SecureInferenceServer(model_fn=model, port=0),
                service.SecureInferenceServer(model_fn=model, port=0,
                                              device=CPU)):
        srv.start()
        try:
            client = jservice.SecureInferenceClient(f"localhost:{srv.port}")
            client.init_session_stream(s["jp"], relin_key=jev.relin_key,
                                       galois_keys=jev.galois_keys)
            answers.append(client.evaluate(s["jcts"][2]))
        finally:
            srv.stop()
    jax_answer, port_answer = answers
    assert port_answer.scale == jax_answer.scale
    assert np.array_equal(np.asarray(port_answer.data),
                          np.asarray(jax_answer.data))
    assert_same(to_port(port_answer), s["want"][2], "JAX client")


SH = jL.GPT2Shapes(slots=512, seq=8, hidden=16, heads=2)


def test_telemetry_wrapper():
    """tests/test_aux.py's case on the port, with the JAX wrapper's counts
    beside it."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(SH.slots)
    counts = []
    for T, P in ((TelemetryBackend, PlainBackend),
                 (JTelemetry, JPlainBackend)):
        B = T(P(SH.slots))
        y = B.mul(B.add(x, x), B.rotate(x, 4))
        _ = B.square(y)
        rep = B.report()
        assert B.stats["add"].count == 1
        assert B.stats["rotate"].count == 1
        assert B.stats["mul"].count == 1
        assert "rotate" in rep and "TOTAL" in rep
        assert len(B.level_trajectory()) == 4
        counts.append({k: v.count for k, v in B.stats.items()})
    assert counts[0] == counts[1]


def test_telemetry_counts_levels(setup):
    """On the encrypted backend the wrapper records the levels the model
    consumes: one rescale unit for the square."""
    s = setup
    B = TelemetryBackend(s["B"])
    out = model(B, to_port(s["jcts"][0]))
    assert_same(out, s["want"][0], "through the telemetry wrapper")
    assert B.stats["square"].levels_consumed == s["ctx"].rescale_limbs
    assert B.level_trajectory()[-1] == ("add", out.level)
    B.reset()
    assert not B.stats and not B.events
