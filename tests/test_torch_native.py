"""The port's native host runtime (fhe_gpt2_tpu_torch/runtime/native.py)
and the native route of its encoder, held against the JAX package's
runtime and encoder and against the port's own numpy route on the CPU.

The numpy route is forced through ``native.available``, the switch point
``embedding.encode_to_coeffs`` and ``decode`` read. Residues are compared
with ``array_equal``.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu.core import embedding as jembedding
from fhe_gpt2_tpu.core.context import CkksContext as JContext
from fhe_gpt2_tpu.core.context import CkksParams as JParams
from fhe_gpt2_tpu.runtime import native as jnative

from fhe_gpt2_tpu_torch.core import embedding
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Evaluator
from fhe_gpt2_tpu_torch.core.modmath import to_numpy_u32
from fhe_gpt2_tpu_torch.runtime import native

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]
# The JAX package's runtime directory as committed: the port builds its own
# library elsewhere and writes nothing there.
JAX_NATIVE = {
    "Makefile":
        "d3d49d4fa958e1e1e1fc91e70befc70ca8767f2231ef4c560ef60e4aa4978368",
    "ckksrt.cpp":
        "3b0ade02fc83bd75b70046addba0e9a4a9c49d5e13c4a247007564306491b207",
    "libckksrt.so":
        "4732b0db7fe42f8ab44cd66d0d3a6873356779f5eb6f081bc509bd7f9b7bdb61",
}
CHAINS = {
    # logN 11, one prime per level (w32), Δ = 2^25.
    "w32_logn11": ("create", dict(logn=11, log_q0=29, log_scale=25,
                                  num_levels=3, log_special=31,
                                  num_special=2, hamming_weight=16)),
    # logN 15, composite, Δ = 2^54: a coefficient's ulp is 4.
    "composite_logn15": ("create_composite",
                         dict(logn=15, num_levels=2, log_scale=54, log_q0=59,
                              num_special=2, hamming_weight=16)),
}


def _jax_native_files() -> dict:
    d = REPO / "fhe_gpt2_tpu" / "runtime" / "native"
    return {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
            for f in d.iterdir()}


@pytest.fixture(scope="module", params=sorted(CHAINS))
def chain(request):
    make, kw = CHAINS[request.param]
    jctx = JContext(getattr(JParams, make)(**kw))
    ctx = CkksContext(getattr(CkksParams, make)(**kw), device=CPU)
    return request.param, jctx, ctx


def _slots(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(5)
    if kind == "uniform":
        return rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
    return rng.integers(0, 2, n).astype(np.float64)


def test_native_builds_outside_the_jax_package():
    assert _jax_native_files() == JAX_NATIVE
    assert native.available()
    path = native.build()
    assert path == native.library_path() and path.exists()
    assert path.parent.parent == REPO / "build" / "native"
    assert _jax_native_files() == JAX_NATIVE


@pytest.mark.parametrize("kind", ["uniform", "zero_one"])
def test_encode_routes_equal_reference(chain, kind, monkeypatch):
    """Port native, port numpy and the JAX encoder give the same residues
    over every limb, and the port's decode equals the JAX decode."""
    name, jctx, ctx = chain
    z = _slots(kind, ctx.params.slots)
    scale = ctx.params.scale
    limbs = tuple(range(ctx.L))
    t = ctx.tables(limbs)
    ev = Evaluator(ctx)
    native_res = to_numpy_u32(ev._encode(z, scale, t))
    native_coeffs = embedding.encode_to_coeffs(z, scale, ctx)
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        numpy_coeffs = embedding.encode_to_coeffs(z, scale, ctx)
        numpy_res = to_numpy_u32(ev._encode(z, scale, t))
    ref = np.asarray(jembedding.encode(z, scale, jctx, limbs))
    assert np.array_equal(native_coeffs, numpy_coeffs), (
        f"{name}: {np.count_nonzero(native_coeffs != numpy_coeffs)} "
        "coefficients differ between the routes")
    assert np.array_equal(native_res, numpy_res)
    assert np.array_equal(native_res, ref)
    got = embedding.decode(native_res, scale, ctx, limbs)
    want = jembedding.decode(ref, scale, jctx, limbs)
    assert np.array_equal(got, want)
    # Rounding each of the n coefficients moves a slot by at most n/2/scale;
    # the float64 transforms add about 1e-11 at Δ = 2^54.
    assert np.abs(got - z).max() < ctx.n / 2 / scale + 1e-9


def test_decode_routes_agree(chain, monkeypatch):
    """The numpy CRT route decodes the native route's residues to within
    float rounding of the native one."""
    _, _, ctx = chain
    z = _slots("uniform", ctx.params.slots)
    limbs = tuple(range(ctx.L))
    res = to_numpy_u32(Evaluator(ctx)._encode(z, ctx.params.scale,
                                              ctx.tables(limbs)))
    got = embedding.decode(res, ctx.params.scale, ctx, limbs)
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        want = embedding.decode(res, ctx.params.scale, ctx, limbs)
    assert np.abs(got - want).max() < 1e-12


def test_encode_evals_to_rns_equals_reference(chain):
    _, jctx, ctx = chain
    rng = np.random.default_rng(2)
    evals = rng.uniform(-2 ** 40, 2 ** 40, ctx.n) + 0j
    mods = list(ctx.moduli)
    assert np.array_equal(native.encode_evals_to_rns(evals, mods),
                          jnative.encode_evals_to_rns(evals, mods))


def test_crt_compose_takes_int32_words(chain):
    _, jctx, ctx = chain
    rng = np.random.default_rng(3)
    res = np.stack([rng.integers(0, q, ctx.n, dtype=np.uint64)
                    .astype(np.uint32) for q in ctx.moduli])
    want = jnative.crt_compose(res, list(ctx.moduli), 2.0 ** 20)
    assert np.array_equal(native.crt_compose(res, list(ctx.moduli), 2.0 ** 20),
                          want)
    words = torch.from_numpy(res.view(np.int32)).numpy()
    assert np.array_equal(native.crt_compose(words, list(ctx.moduli),
                                             2.0 ** 20), want)


def test_compress_roundtrip_across_packages():
    rng = np.random.default_rng(2)
    data = (rng.integers(0, 255, 100000, dtype=np.uint8).tobytes()
            + b"\0" * 50000)
    blob = native.compress(data)
    assert len(blob) < len(data)
    assert native.decompress(blob, len(data)) == data
    assert jnative.decompress(blob, len(data)) == data
    assert native.decompress(jnative.compress(data), len(data)) == data
    assert native.decompress(native.compress(b""), 0) == b""
    with pytest.raises(ValueError):
        native.decompress(blob, len(data) + 1)
