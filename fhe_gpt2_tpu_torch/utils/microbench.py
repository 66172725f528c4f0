"""Microbenchmark registry with exact correctness checks.

The port's counterpart of ``fhe_gpt2_tpu/utils/microbench.py`` (itself the
counterpart of the reference's run/microbenchmark.cpp registry): each entry
builds a real context on the u64 chain of the JAX registry (log_q0=50,
log_scale=40, special 51), runs its op eagerly, times it and verifies the
decrypted result against a plaintext oracle. The JAX registry times jitted
programs; the port has no program cache, so a step here is the eager op
chain. On the card a step is timed with CUDA events around a warm run
(the device's time of the enqueued work, synchronized); on the CPU with
``time.perf_counter``.

Usage: python -m fhe_gpt2_tpu_torch.utils.microbench <name> [--logn 12]
           [--levels 12] [--iters 5] [--cpu]
       python -m fhe_gpt2_tpu_torch.utils.microbench list

The card is used unless --cpu asks for the CPU; without a card and without
--cpu the context raises. One JSON line per run, the JAX registry's keys
plus the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _setup(a, levels, hamming=32, steps=(), conj=False, seed=0):
    from ..core.context import CkksContext, CkksParams
    from ..core.evaluator import Decryptor, Encryptor, Evaluator
    from ..core.keys import KeyGenerator
    from ..nn.backend import CkksBackend
    params = CkksParams.create(logn=a.logn, log_q0=50, log_scale=40,
                               num_levels=levels, log_special=51,
                               hamming_weight=hamming)
    ctx = CkksContext(params, device=a.device)
    kg = KeyGenerator(ctx, seed=seed)
    ev = Evaluator(ctx, relin_key=kg.relin_key(),
                   galois_keys=kg.galois_keys(steps=list(steps),
                                              conjugate=conj))
    enc = Encryptor(ctx, secret=kg.secret, seed=seed + 1)
    dec = Decryptor(ctx, kg.secret)
    B = CkksBackend(ctx=ctx, ev=ev, enc=enc, dec=dec, default_level=levels)
    return params, ctx, ev, enc, dec, B


class _Clock:
    """Seconds of work on the run's device: CUDA events around the work,
    then a synchronize (card), or the host clock (CPU)."""

    def __init__(self, device: str):
        import torch
        self.torch = torch
        self.cuda = device != "cpu"

    def __call__(self, fn, iters: int = 1):
        torch = self.torch
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            return (time.perf_counter() - t0) / iters, out
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters, out


def _time(a, fn, iters):
    """One warm-up call, then seconds per call over `iters` calls."""
    fn()
    return _Clock(a.device)(fn, iters)


def bench_mult_relin(a):
    from ..core.evaluator import Ciphertext
    params, ctx, ev, enc, dec, B = _setup(a, a.levels)
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, ctx.params.slots)
    ct = enc.encrypt(ev.make_plain(z, params.scale, a.levels))

    def step():
        return ev.multiply(ct, ct).data

    dt, out = _time(a, step, a.iters)
    got = dec.decrypt(ev.rescale(Ciphertext(out, params.scale ** 2)))
    return dt, bool(np.allclose(got, z * z, atol=1e-3))


def bench_rotate(a):
    params, ctx, ev, enc, dec, B = _setup(a, a.levels, steps=[1])
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, ctx.params.slots)
    ct = enc.encrypt(ev.make_plain(z, params.scale, a.levels))
    dt, out = _time(a, lambda: ev.rotate(ct, 1), a.iters)
    got = dec.decrypt(out)
    return dt, bool(np.allclose(got, np.roll(z, -1), atol=1e-3))


def bench_ntt(a):
    from ..core import ntt as nttmod
    from ..core.modmath import to_numpy_word, word_tensor
    params, ctx, *_ = _setup(a, a.levels)
    t = ctx.tables(a.levels)
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, q, ctx.n, dtype=np.uint64)
                  for q in ctx.moduli[:a.levels]])
    xd = word_tensor(x, ctx.device, word=ctx.word)
    dt, out = _time(a, lambda: nttmod.ntt(xd, t), a.iters)
    back = to_numpy_word(nttmod.intt(out, t))
    return dt, bool((back == x).all())


def bench_matmul_lt(a):
    from ..nn.backend import RecordingBackend
    from ..nn.formats import TightLayout, matmul_spec
    from ..nn.linear import apply_lt
    rng = np.random.default_rng(0)
    rows, d = 16, 32
    slots = 1 << (a.logn - 1)
    lay = TightLayout(rows, d, slots)
    A = rng.standard_normal((rows, d)) * 0.3
    W = rng.standard_normal((d, d)) * 0.3
    plan = matmul_spec(W, lay).bsgs_plan()
    rec = RecordingBackend(slots)
    apply_lt(rec, plan, list(lay.pack(A)))
    params, ctx, ev, enc, dec, B = _setup(a, a.levels,
                                          steps=rec.key_steps())
    xs = [B.from_slots(v) for v in lay.pack(A)]
    dt, out = _Clock(a.device)(lambda: apply_lt(B, plan, xs))
    got = lay.unpack(np.stack([B.to_slots(o) for o in out]))
    return dt, bool(np.allclose(got, A @ W, atol=1e-3))


def bench_layernorm(a):
    from ..nn import layers as L
    from ..nn.backend import PlainBackend, RecordingBackend
    rng = np.random.default_rng(0)
    slots = 1 << (a.logn - 1)
    sh = L.GPT2Shapes(slots=slots, seq=8, hidden=16, heads=4)
    A = rng.standard_normal((sh.seq, sh.hidden))
    z = sh.hidden * (A - A.mean(-1, keepdims=True))
    ln = L.build_ln_plans(sh, np.ones(sh.hidden), np.zeros(sh.hidden),
                          newton_init=(z ** 2).sum(-1).mean(), iters=3,
                          eps=1e-4)
    xs_p = list(sh.act.pack(A))
    rec = RecordingBackend(slots)
    L.layer_norm(rec, xs_p, sh, ln)
    params, ctx, ev, enc, dec, B = _setup(a, max(a.levels, 18),
                                          steps=rec.key_steps())
    xs = [B.from_slots(v) for v in xs_p]
    dt, out = _Clock(a.device)(lambda: L.layer_norm(B, xs, sh, ln))
    got = sh.act.unpack(np.stack([B.to_slots(o) for o in out]))
    want = sh.act.unpack(np.stack(L.layer_norm(
        PlainBackend(slots), xs_p, sh, ln)))
    return dt, bool(np.abs(got - want).max() < 1e-2)


def bench_bootstrap(a):
    from ..boot.bootstrap import Bootstrapper, make_evalmod
    from ..core.keys import KeyGenerator
    params, ctx, ev, enc, dec, B = _setup(a, max(a.levels, 22), hamming=16)
    ns = min(64, ctx.params.slots)
    em = make_evalmod(K=12, eps=2 ** -5, degree=45, arcsin_degree=3,
                      prec_dps=60)
    boot = Bootstrapper(B, num_slots=ns, evalmod=em)
    kg = KeyGenerator(ctx, seed=0)  # same seed as _setup -> same secret
    ev.galois_keys = kg.galois_keys(steps=boot.required_steps(),
                                    conjugate=True)
    rng = np.random.default_rng(1)
    z = rng.uniform(-1, 1, ns)
    ct = enc.encrypt(ev.make_plain(z, params.scale, 1))
    dt, out = _Clock(a.device)(lambda: boot.bootstrap(ct))
    back = np.real(dec.decrypt(out, num_slots=ns))
    return dt, bool(np.abs(back - z).mean() < 2e-2)


REGISTRY = {
    "mult_relin": bench_mult_relin,
    "rotate": bench_rotate,
    "ntt": bench_ntt,
    "matmul_lt": bench_matmul_lt,
    "layernorm": bench_layernorm,
    "bootstrap": bench_bootstrap,
}


def device_name(device: str) -> str:
    import torch
    return "cpu" if device == "cpu" else torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", choices=[*REGISTRY, "list"])
    ap.add_argument("--logn", type=int, default=12)
    ap.add_argument("--levels", type=int, default=12)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch versions); "
                         "without it the run needs a CUDA card")
    a = ap.parse_args(argv)
    if a.name == "list":
        print("\n".join(REGISTRY))
        return 0
    from ..core.context import resolve_device
    a.device = str(resolve_device("cpu" if a.cpu else None))
    dt, ok = REGISTRY[a.name](a)
    print(json.dumps({"bench": a.name, "logn": a.logn, "levels": a.levels,
                      "seconds": round(dt, 5), "correct": ok,
                      "device": device_name(a.device)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
