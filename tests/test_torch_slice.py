"""The port's main path as a whole, held against the JAX package on the CPU,
on both uint32 chains (single-prime and composite) at logN=11.

With the same keygen seed the secret, public, relinearization and Galois
keys are ``array_equal``; with the same encryptor seed and the JAX
package's plaintext (carried over), the ciphertexts after encrypt,
multiply+relin, rescale, rotate (one hop and two hops) and conjugate are
``array_equal`` too. The JAX side runs its CPU path, whose key-switch
mod-down is ``_mod_down_core`` (``jnp.sum``); at these seeds no float32
estimate sits on a floor boundary, so no coefficient falls under the
one-unit residue rule of tests/test_torch_keyswitch.py.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fhe_gpt2_tpu.core import embedding as jemb
from fhe_gpt2_tpu.core import ntt as jntt
from fhe_gpt2_tpu.core.context import CkksContext as JContext
from fhe_gpt2_tpu.core.context import CkksParams as JParams
from fhe_gpt2_tpu.core.evaluator import Ciphertext as JCiphertext
from fhe_gpt2_tpu.core.evaluator import Plaintext as JPlaintext
from fhe_gpt2_tpu.core.evaluator import Decryptor as JDecryptor
from fhe_gpt2_tpu.core.evaluator import Encryptor as JEncryptor
from fhe_gpt2_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_gpt2_tpu.core.keys import KeyGenerator as JKeyGenerator

from fhe_gpt2_tpu_torch import carry
from fhe_gpt2_tpu_torch.core import embedding as temb
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Encryptor, Evaluator
from fhe_gpt2_tpu_torch.core.keys import KeyGenerator

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = [1, 2]
# Error budget of the w32 engine at Δ = 2^25, logN=11 (as in
# tests/test_fused_ks.py): < 1e-4 after multiply+rescale or a rotation.
BUDGET = 1e-4


@pytest.fixture(scope="module", params=["single", "composite"])
def run(request):
    """Drive both packages through the main path once; keep every state."""
    if request.param == "single":
        kw = dict(logn=11, log_q0=29, log_scale=25, num_levels=3,
                  log_special=31, num_special=2, hamming_weight=16)
        ref_p, got_p = JParams.create(**kw), CkksParams.create(**kw)
    else:
        kw = dict(logn=11, num_levels=1, num_special=2, hamming_weight=16)
        ref_p, got_p = JParams.create_composite(**kw), \
            CkksParams.create_composite(**kw)
    jctx, ctx = JContext(ref_p), CkksContext(got_p, device=CPU)
    x = np.random.default_rng(1).uniform(-1, 1, ctx.params.slots)
    out = {"x": x, "ctx": ctx, "jctx": jctx}
    for side, C, KG, EV, ENC, DEC in (
            ("ref", jctx, JKeyGenerator, JEvaluator, JEncryptor, JDecryptor),
            ("got", ctx, KeyGenerator, Evaluator, Encryptor, Decryptor)):
        kg = KG(C, seed=3)
        relin = kg.relin_key()
        gk = kg.galois_keys(steps=STEPS, conjugate=True)
        pk = kg.public_key()
        ev = EV(C, relin_key=relin, galois_keys=gk)
        if side == "ref":
            pt = ev.make_plain(x, C.params.scale, C.L)
            pt_low = ev.make_plain(x, C.params.scale, C.L - 1)
            out["pt"], out["pt_low"] = pt, pt_low
        else:
            pt = carry.plaintext_from_reference(
                np.asarray(out["pt"].data), out["pt"].scale, device=CPU)
            pt_low = carry.plaintext_from_reference(
                np.asarray(out["pt_low"].data), out["pt_low"].scale, device=CPU)
        ct = ENC(C, secret=kg.secret, seed=4).encrypt(pt)
        mul = ev.multiply(ct, ct)
        r = {
            "secret": kg.secret.ntt, "relin": relin.data, "pk": pk.data,
            "encrypt": ct.data, "mul_relin": mul.data,
            "rescale": ev.rescale(mul).data,
            "rotate1": ev.rotate(ct, 1).data,
            "rotate3": ev.rotate(ct, 3).data,
            "conjugate": ev.conjugate(ct).data,
            "pk_encrypt": ENC(C, public=pk, seed=5).encrypt(pt_low).data,
        }
        for elt, key in gk.keys.items():
            r[f"galois{elt}"] = key.data
        r["_obj"] = (kg, ev, DEC(C, kg.secret), ct, mul)
        out[side] = r
    return out


def _u32(v):
    return np.asarray(v) if not isinstance(v, torch.Tensor) else carry.to_numpy(v)


@pytest.mark.parametrize("name", [
    "secret", "relin", "pk", "galois5", "galois25", "galois4095",
    "encrypt", "pk_encrypt", "mul_relin", "rescale", "rotate1", "rotate3",
    "conjugate"])
def test_slice_equals_reference(run, name):
    ref, got = _u32(run["ref"][name]), _u32(run["got"][name])
    assert ref.shape == got.shape
    assert np.array_equal(ref, got), (
        f"{name}: {np.count_nonzero(ref != got)} words differ")


def test_port_decrypts_within_budget(run):
    x = run["x"]
    kg, ev, dec, ct, mul = run["got"]["_obj"]
    assert np.max(np.abs(dec.decrypt(ct) - x)) < BUDGET
    assert np.max(np.abs(dec.decrypt(ev.rescale(mul)) - x * x)) < BUDGET
    assert np.max(np.abs(dec.decrypt(mul) - x * x)) < BUDGET
    assert np.max(np.abs(dec.decrypt(ev.rotate(ct, 3)) - np.roll(x, -3))) < BUDGET
    assert np.max(np.abs(dec.decrypt(ev.conjugate(ct)) - x)) < BUDGET
    np.testing.assert_allclose(ev.decode_plain(ev.make_plain(x, 2.0 ** 25, 2)),
                               x, atol=1e-5)


def test_port_encoding_equals_reference(run):
    """make_plain equals the JAX numpy encoding (coeffs_to_rns of
    encode_to_coeffs) followed by the JAX stage-loop NTT."""
    ctx, jctx, x = run["ctx"], run["jctx"], run["x"]
    scale = ctx.params.scale
    res = jemb.coeffs_to_rns(jemb.encode_to_coeffs(x, scale, jctx), jctx,
                             tuple(range(jctx.L)))
    want = np.asarray(jntt._ntt_stages(jnp.asarray(res), jctx.tables(jctx.L)))
    ev = run["got"]["_obj"][1]
    assert np.array_equal(carry.to_numpy(ev.make_plain(x, scale, ctx.L)), want)


def test_embedding_equals_reference(run):
    """The numpy encode/decode path, function by function (both sides are
    float64 numpy in the same order, so equality is exact)."""
    ctx, jctx, x = run["ctx"], run["jctx"], run["x"]
    limbs = tuple(range(ctx.L))
    scale = ctx.params.scale
    z = x + 0.25j * x[::-1]
    v = np.random.default_rng(2).normal(size=ctx.n) * (1 + 1j)
    for f in ("eval_transform", "coeff_transform"):
        assert np.array_equal(getattr(temb, f)(v), getattr(jemb, f)(v)), f
    coeffs = temb.encode_to_coeffs(z, scale, ctx)
    assert np.array_equal(coeffs, jemb.encode_to_coeffs(z, scale, jctx))
    res = temb.coeffs_to_rns(coeffs, ctx, limbs)
    assert np.array_equal(res, jemb.coeffs_to_rns(coeffs, jctx, limbs))
    centered = jemb.rns_to_centered_ints(res, jctx, limbs)
    assert np.array_equal(temb.rns_to_centered_ints(res, ctx, limbs), centered)
    want = jemb.eval_transform(centered.astype(np.float64) / scale)[
        jctx.slot_to_index]
    assert np.array_equal(temb.decode(res, scale, ctx, limbs), want)
    sparse = want.reshape(-1, 64).mean(axis=0)
    assert np.array_equal(temb.decode(res, scale, ctx, limbs, 64), sparse)


def _jplain(jctx, values, scale, level):
    """A JAX-package plaintext through its numpy encoding path."""
    res = jemb.coeffs_to_rns(jemb.encode_to_coeffs(values, scale, jctx), jctx,
                             tuple(range(level)))
    return JPlaintext(jntt._ntt_stages(jnp.asarray(res), jctx.tables(level)),
                      scale)


EV_OPS = {
    "add": lambda ev, a, b, p, v: ev.add(a, b),
    "sub": lambda ev, a, b, p, v: ev.sub(a, b),
    "negate": lambda ev, a, b, p, v: ev.negate(a),
    "add_plain": lambda ev, a, b, p, v: ev.add_plain(a, p),
    "sub_plain": lambda ev, a, b, p, v: ev.sub_plain(a, p),
    "add_const": lambda ev, a, b, p, v: ev.add_const(a, 0.375),
    "mul_const_int": lambda ev, a, b, p, v: ev.mul_const_int(a, -7),
    "mul_const": lambda ev, a, b, p, v: ev.mul_const(a, -0.3),
    "mul_plain": lambda ev, a, b, p, v: ev.mul_plain(a, p),
    "mul_vector": lambda ev, a, b, p, v: ev.mul_vector(a, v),
    "square": lambda ev, a, b, p, v: ev.square(a),
    "mod_switch_to": lambda ev, a, b, p, v: ev.mod_switch_to(a, a.level - 1),
}


@pytest.mark.parametrize("op", sorted(EV_OPS))
def test_evaluator_op_equals_reference(run, op):
    """Each remaining evaluator op on ciphertexts and plaintexts carried over
    from the JAX package gives the same words and scale. The JAX side of
    mul_vector encodes through its numpy path (its make_plain may take the
    native runtime)."""
    ctx, jctx, x = run["ctx"], run["jctx"], run["x"]
    scale = ctx.params.scale
    jev, ev = run["ref"]["_obj"][1], run["got"]["_obj"][1]
    ja = JCiphertext(run["ref"]["encrypt"], scale)
    jb = JCiphertext(run["ref"]["conjugate"], scale)
    jp = run["pt"]
    vec = x[::-1].copy()
    if op == "mul_vector":
        ref = jev.mul_plain(ja, _jplain(jctx, vec, scale, jctx.L))
    else:
        ref = EV_OPS[op](jev, ja, jb, jp, vec)
    got = EV_OPS[op](
        ev, carry.ciphertext_from_reference(np.asarray(ja.data), scale, CPU),
        carry.ciphertext_from_reference(np.asarray(jb.data), scale, CPU),
        carry.plaintext_from_reference(np.asarray(jp.data), jp.scale, CPU),
        vec)
    assert got.scale == ref.scale
    assert np.array_equal(carry.to_numpy(got), np.asarray(ref.data))


def test_carry_drives_port_from_reference_keys(run):
    """A port evaluator and decryptor built from the JAX package's keys
    (carry.py) rotate and decrypt a carried ciphertext as the JAX side
    does."""
    ctx, x = run["ctx"], run["x"]
    jkg, jev = run["ref"]["_obj"][:2]
    secret = carry.secret_from_reference(np.asarray(jkg.secret.ntt),
                                         jkg.secret.coeffs, CPU)
    assert np.array_equal(carry.to_numpy(secret), np.asarray(jkg.secret.ntt))
    gk = carry.galois_keys_from_reference(
        {e: np.asarray(k.data) for e, k in jev.galois_keys.keys.items()}, CPU)
    relin = carry.kswitch_key_from_reference(
        np.asarray(jev.relin_key.data), CPU)
    ev = Evaluator(ctx, relin_key=relin, galois_keys=gk)
    ct = carry.ciphertext_from_reference(np.asarray(run["ref"]["encrypt"]),
                                         ctx.params.scale, CPU)
    rot = ev.rotate(ct, 3)
    assert np.array_equal(carry.to_numpy(rot), np.asarray(run["ref"]["rotate3"]))
    got = Decryptor(ctx, secret).decrypt(rot)
    assert np.max(np.abs(got - np.roll(x, -3))) < BUDGET


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, pulls in jax or
    fhe_gpt2_tpu: neither at import nor in any import statement."""
    code = (
        "import sys, pkgutil, importlib, fhe_gpt2_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fhe_gpt2_tpu' or m.startswith('fhe_gpt2_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in
        os.walk(os.path.join(REPO, "fhe_gpt2_tpu_torch")) for f in fs
        if f.endswith(".py")]
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "fhe_gpt2_tpu"), (path, name)


def test_context_without_card_raises(monkeypatch):
    """With no card and no device, the context raises; it never drops to
    the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = CkksParams.create(logn=11, log_q0=29, log_scale=25,
                               num_levels=2, log_special=31)
    with pytest.raises(RuntimeError):
        CkksContext(params)
    with pytest.raises(RuntimeError):
        CkksContext(params, device="cuda")
