"""Secure-inference gRPC service: client keeps the secret key, the server
evaluates on ciphertexts.

The port's copy of ``fhe_gpt2_tpu/net/service.py`` (counterpart of the
reference's SecureInference service, protos/secure_inference.proto:6-18,
network/secure_inference_server.cc:24-214, client .cc): InitSession uploads
params + evaluation keys, Evaluate streams ciphertexts through a
server-registered encrypted model function. Messages are the framed blobs
of ``net/serialize.py``, the JAX package's wire format, over raw-bytes gRPC
methods (generic handlers — no codegen dependency) under the same service
and method names, with the reference's large message caps; a JAX client can
talk to a port server and the reverse.

Differences from the JAX module:
  * ``SecureInferenceServer`` and ``SecureInferenceClient`` take
    ``device=None``: the server's context, keys and ciphertexts, and the
    client's answers, go where ``core.context.resolve_device`` says (the
    card unless the caller names another device; with no card and no device
    it raises). The JAX server builds its context on JAX's default device.
  * The JAX ``_init_session`` imports jax and never uses it; this one does
    not (the JAX file keeps its import).

``grpc`` is imported inside the functions that need it, so the module
imports where grpcio is not installed; the handler methods
(``_init_session_stream``, ``_evaluate_stream``, ...) take the frames
without it.
"""

from __future__ import annotations

import os
import struct
from collections import deque
from concurrent import futures
from dataclasses import dataclass, field
from typing import Callable

from ..core.context import resolve_device
from . import serialize as S

_SERVICE = "fhegpt2tpu.SecureInference"
_MAX_MSG = 1_500_000_000   # the reference's 1.42 GB caps (server.cc:202-203)


def _bytes_io(f):
    import grpc
    return grpc.unary_unary_rpc_method_handler(
        f, request_deserializer=lambda b: b, response_serializer=lambda b: b)


@dataclass
class SecureInferenceServer:
    """Evaluator-side server. `model_fn(backend, ct) -> ct` is the encrypted
    computation run per Evaluate call (registered host-side). It holds no
    secret: the backend it passes has no encryptor and no decryptor."""

    model_fn: Callable
    port: int = 50051
    device: object = None
    _state: dict = field(default_factory=dict)

    def _open(self, params, relin, galois) -> None:
        from ..core.context import CkksContext
        from ..core.evaluator import Evaluator
        from ..nn.backend import CkksBackend
        cctx = CkksContext(params, device=self.device)
        ev = Evaluator(cctx, relin_key=relin, galois_keys=galois)
        self._state["backend"] = CkksBackend(ctx=cctx, ev=ev)

    def _init_session(self, request: bytes, ctx) -> bytes:
        dev = resolve_device(self.device)
        off = 0
        blobs = []
        while off < len(request):
            hlen, clen, _ = struct.unpack("<III", request[off + 4:off + 16])
            size = 16 + hlen + clen
            blobs.append(request[off:off + size])
            off += size
        params = S.load_params(blobs[0])
        relin = S.load_kswitch_key(blobs[1], dev) if len(blobs) > 1 else None
        galois = S.load_galois_keys(blobs[2], dev) if len(blobs) > 2 else None
        self._open(params, relin, galois)
        return b"ok"

    def _evaluate(self, request: bytes, ctx) -> bytes:
        B = self._state["backend"]
        ct = S.load_ciphertext(request, B.ctx.device)
        out = self.model_fn(B, ct)
        return S.dump_ciphertext(out)

    def _init_session_stream(self, request_iter, ctx) -> bytes:
        """Client-streaming key upload: one framed blob per message (params,
        relin ksk, individual Galois keys) — GB-scale key material never
        materializes as a single gRPC message (the reference's streaming
        upload concern, secure_inference_server.cc:94-177)."""
        from ..core.keys import GaloisKeys
        dev = resolve_device(self.device)
        params = relin = None
        gk = GaloisKeys()
        for blob in request_iter:
            kind = S.peek_kind(blob)
            if kind == "params":
                params = S.load_params(blob)
            elif kind == "ksk":
                relin = S.load_kswitch_key(blob, dev)
            elif kind == "gal_elt":
                elt, k = S.load_galois_elt(blob, dev)
                gk.keys[elt] = k
        if params is None:
            raise ValueError("the key stream must include params")
        self._open(params, relin, gk if gk.keys else None)
        return b"ok"

    def _evaluate_stream(self, request_iter, ctx):
        """Bidirectional evaluate loop — the RepackAndSend counterpart
        (secure_inference_server.cc:94-177): each inbound ciphertext is
        evaluated and the result streamed back immediately."""
        B = self._state["backend"]
        for blob in request_iter:
            out = self.model_fn(B, S.load_ciphertext(blob, B.ctx.device))
            yield S.dump_ciphertext(out)

    def start(self):
        import grpc

        def _stream_in(f):
            return grpc.stream_unary_rpc_method_handler(
                f, request_deserializer=lambda b: b,
                response_serializer=lambda b: b)

        def _stream_bidi(f):
            return grpc.stream_stream_rpc_method_handler(
                f, request_deserializer=lambda b: b,
                response_serializer=lambda b: b)

        handlers = {
            "InitSession": _bytes_io(self._init_session),
            "InitSessionStream": _stream_in(self._init_session_stream),
            "Evaluate": _bytes_io(self._evaluate),
            "EvaluateStream": _stream_bidi(self._evaluate_stream),
        }
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=4),
            options=[("grpc.max_receive_message_length", _MAX_MSG),
                     ("grpc.max_send_message_length", _MAX_MSG)])
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),))
        self.port = self._server.add_insecure_port(f"[::]:{self.port}")
        self._server.start()
        return self

    def stop(self):
        self._server.stop(None)


class SecureInferenceClient:
    """Key-owner side: builds keys locally, uploads only evaluation keys.
    Answers load onto ``device`` (``resolve_device``)."""

    def __init__(self, address: str, device=None):
        import grpc
        self.device = device
        self._chan = grpc.insecure_channel(
            address,
            options=[("grpc.max_receive_message_length", _MAX_MSG),
                     ("grpc.max_send_message_length", _MAX_MSG)])
        self._init = self._chan.unary_unary(
            f"/{_SERVICE}/InitSession",
            request_serializer=lambda b: b, response_deserializer=lambda b: b)
        self._init_stream = self._chan.stream_unary(
            f"/{_SERVICE}/InitSessionStream",
            request_serializer=lambda b: b, response_deserializer=lambda b: b)
        self._eval = self._chan.unary_unary(
            f"/{_SERVICE}/Evaluate",
            request_serializer=lambda b: b, response_deserializer=lambda b: b)
        self._eval_stream = self._chan.stream_stream(
            f"/{_SERVICE}/EvaluateStream",
            request_serializer=lambda b: b, response_deserializer=lambda b: b)

    def init_session(self, params, relin_key=None, galois_keys=None) -> None:
        msg = S.dump_params(params)
        if relin_key is not None:
            msg += S.dump_kswitch_key(relin_key)
        if galois_keys is not None:
            msg += S.dump_galois_keys(galois_keys)
        if self._init(msg) != b"ok":
            raise RuntimeError("InitSession was refused")

    def init_session_stream(self, params, relin_key=None,
                            galois_keys=None) -> None:
        """Streaming key upload: one bounded message per key component,
        sent in order. The frames are serialized (zlib, which releases the
        interpreter lock) on a pool of one thread per core, at most two per
        thread ahead of the stream: the bytes are the sequential ones."""
        jobs = [lambda: S.dump_params(params)]
        if relin_key is not None:
            jobs.append(lambda: S.dump_kswitch_key(relin_key))
        if galois_keys is not None:
            jobs += [lambda e=e: S.dump_galois_elt(e, galois_keys.keys[e])
                     for e in sorted(galois_keys.keys)]

        def gen():
            workers = os.cpu_count() or 1
            with futures.ThreadPoolExecutor(workers) as pool:
                ahead = deque()
                for job in jobs:
                    ahead.append(pool.submit(job))
                    if len(ahead) > 2 * workers:
                        yield ahead.popleft().result()
                while ahead:
                    yield ahead.popleft().result()
        if self._init_stream(gen()) != b"ok":
            raise RuntimeError("InitSessionStream was refused")

    def evaluate(self, ct):
        return S.load_ciphertext(self._eval(S.dump_ciphertext(ct)),
                                 self.device)

    def evaluate_stream(self, cts: list) -> list:
        """Pipeline many ciphertexts through the bidi evaluate loop."""
        resp = self._eval_stream(S.dump_ciphertext(c) for c in cts)
        return [S.load_ciphertext(b, self.device) for b in resp]
