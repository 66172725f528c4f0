#!/usr/bin/env python3
"""Chip smoke run of fhe_gpt2_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--out result.json]

Phases (any failed check exits non-zero and prints no result):
  1. build   compile csrc/*.cu with nvcc (one process per source, in
             parallel) and print the build seconds;
  2. kernels each hand-written kernel against its plain PyTorch version on
             the same CUDA inputs (numpy seed), with torch.equal, at the
             main-path shapes (the NTTs also on limb slices read in place),
             at N = 2048 and 65536, and with a batched leading dim, at every
             cluster size the kernels take (forced) and the one cluster_for
             picks, with the device ms of each size at the main shapes, and
             with the device kernels of one wrapper call counted by the
             profiler (1 per NTT; the iNTT plus one for the key switch and
             the mod-down); kernel and plain ms by CUDA events;
  3. main    the production uint32 chain (logN=15, 22 limbs, alpha=8
             special primes, h=192): keygen (relin, Galois steps 1/2/4/8 and
             conjugation, public key), then requests that encode, encrypt,
             multiply+relin, rescale, rotate by 5 (hops 4+1) and conjugate,
             each decrypted and held against numpy; one request encrypts
             with the public key. Launch counts are zeroed just before and
             read just after; every kernel must have run;
  4. composite create_composite(logN=15, 4 levels, 3 specials) through
             multiply+relin+rescale (the mod-down kernel's pair path);
  5. rate    ct-mult+relin ops/s as a dependent chain at phase 3's shape,
             and mult+relin+rescale ops/s, by CUDA events; then the device
             time, kernel launches and top kernels of one ct-mult+relin and
             of one mult+relin+rescale from torch.profiler, and the device's
             idle share;
  6. report  one JSON line of kernels, the card's name and power limit, and
             the last line {"ok": true, "device": {...}}.

It imports the port only, never jax or fhe_gpt2_tpu. Without a CUDA device,
or without the package beside it, it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

MEM_RATE = 3.35e12        # H100 SXM HBM3 bytes/s (data sheet)
MUL_RATE = 33.5e12        # 32-bit multiply instructions/s: the fp32 FMA
                          # issue rate (67 TFLOP/s / 2), an upper bound on
                          # the card's int32 multiply rate
SHOUP_MULS, BARRETT_MULS = 3, 7   # 32-bit multiplies per modular product
ERR_BOUND_W32 = 1e-3      # decrypt max abs error at scale 2^25 (phase 3)
ERR_BOUND_COMPOSITE = 1e-6  # at scale 2^50 (phase 4)
NUM_LEVELS = 22           # scale primes; bench.py encrypts at this many limbs
REQUESTS = 4              # phase 3: the last one encrypts by public key
ITERS = 20                # phase 5: length of the dependent chain

REPLACES = {
    "ntt_fwd": "fhe_gpt2_tpu/core/tntt.py:250",
    "ntt_inv": "fhe_gpt2_tpu/core/tntt.py:266",
    "keyswitch": "fhe_gpt2_tpu/core/tks.py:262",
    "moddown": "fhe_gpt2_tpu/core/tks.py:157",
}
SOURCES = {
    "ntt_fwd": "fhe_gpt2_tpu_torch/csrc/ntt.cu",
    "ntt_inv": "fhe_gpt2_tpu_torch/csrc/ntt.cu",
    "keyswitch": "fhe_gpt2_tpu_torch/csrc/keyswitch.cu",
    "moddown": "fhe_gpt2_tpu_torch/csrc/moddown.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Timer:
    """Mean ms per call of fn by CUDA events, after warm-up."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters


def profile_chain(torch, fn, reps: int) -> dict:
    """Device time per call of fn, kernel launches per call and the top
    kernels by device time, from torch.profiler over reps calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kern)
    check(busy_us > 0, "torch.profiler recorded no device time")
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"device_ms": busy_us / 1e3 / reps,
            "launches": sum(e.count for e in kern) / reps,
            "top": [(e.key[:70], e.self_device_time_total / 1e3 / reps,
                     e.count / reps) for e in top]}


def kernels_per_call(torch, fn) -> int:
    """Device kernels one call of fn launches, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.count for e in prof.key_averages() if e.device_type == cuda)


def bound(nbytes: float, muls: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / MEM_RATE, muls / MUL_RATE
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ntt_cost(rows: int, L: int, n: int) -> tuple[float, float]:
    """Bytes (rows in and out, twiddle + Shoup table of L limbs) and
    multiplies of one (i)NTT of rows x n words."""
    logn = n.bit_length() - 1
    return 4.0 * (2 * rows * n + 2 * L * n), rows * (n // 2) * logn * SHOUP_MULS


def residues(torch, rng, moduli, lead, n, word_tensor):
    x = np.stack([rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
                  .astype(np.uint32) for q in moduli], axis=-2)
    return word_tensor(x, "cuda")


def run() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); nothing was run")
    import fhe_gpt2_tpu_torch
    pkg = Path(fhe_gpt2_tpu_torch.__file__).resolve().parent
    check(pkg.parent == Path(__file__).resolve().parent,
          f"fhe_gpt2_tpu_torch imported from {pkg}, not from this checkout")
    from fhe_gpt2_tpu_torch.core import _cuda, tks, ntt as nttmod
    from fhe_gpt2_tpu_torch.core import tntt
    from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
    from fhe_gpt2_tpu_torch.core.evaluator import (
        Ciphertext, Decryptor, Encryptor, Evaluator)
    from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
    from fhe_gpt2_tpu_torch.core.modmath import word_tensor
    from fhe_gpt2_tpu_torch.core import primes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = Timer(torch)
    result = {"phases": {}}
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.build()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s ({', '.join(_cuda.SOURCES)})")
    result["build_s"] = build_s

    # -- 2. kernels against their plain versions ----------------------------
    t0 = time.perf_counter()
    params = CkksParams.create(logn=15, log_q0=29, log_scale=25,
                               num_levels=NUM_LEVELS, log_special=31, num_special=8,
                               hamming_weight=192)
    ctx = CkksContext(params)
    cparams = CkksParams.create_composite(logn=15, num_levels=4,
                                          num_special=3, hamming_weight=192)
    cctx = CkksContext(cparams)
    n, L = ctx.n, NUM_LEVELS
    log(f"contexts: {time.perf_counter() - t0:.1f} s  main level {L} of "
        f"{ctx.L}, k={ctx.k_sp}, digits={ctx.num_digits(L)}, key limbs "
        f"{len(ctx.key_limbs(L))}; composite L={cctx.L} k={cctx.k_sp}")
    rng = np.random.default_rng(7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kern = {k: {"max_abs_err": 0} for k in REPLACES}

    def timed(name, fn, plain, iters, plain_iters):
        # ms: CUDA events over a loop of calls, which includes the host's
        # launch gaps; device_ms: the card's own kernel time per call.
        kern[name]["ms"] = timer(fn, iters=iters)
        kern[name]["plain_ms"] = timer(plain, iters=plain_iters)
        kern[name]["device_ms"] = profile_chain(torch, fn, 10)["device_ms"]

    def same(name, got, want, what):
        check(got.shape == want.shape, f"{name} {what}: shape {tuple(got.shape)}"
              f" vs {tuple(want.shape)}")
        err = int((got.long() - want.long()).abs().max().item())
        kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"], err)
        check(torch.equal(got, want), f"{name} {what}: kernel != plain "
              f"(max abs err {err})")

    # NTT pair: the main-path shapes (the level [22,N], the key-switch
    # [1,3,30,N], the special limbs [2,8,N] and the rescale's last limb
    # [2,1,N], both read in place from [2,30,N] and [2,22,N]), batched, and
    # N=2048/65536, each at every cluster size and the one cluster_for picks.
    t22 = ctx.tables(L)
    tkey = ctx.tables(ctx.key_limbs(L))
    sp_idx = tuple(ctx.L + i for i in range(ctx.k_sp))
    tsp = ctx.tables(sp_idx)
    xs = residues(torch, rng, ctx.moduli[:L] + ctx.special, (2,), n,
                  word_tensor)
    x22b = residues(torch, rng, ctx.moduli[:L], (2,), n, word_tensor)
    cases = [("main [22,N]", residues(torch, rng, ctx.moduli[:L], (), n,
                                       word_tensor), t22),
             ("keyswitch [1,3,30,N]", residues(torch, rng, tkey.moduli, (1, 3),
                                               n, word_tensor), tkey),
             ("specials [2,8,N] of [2,30,N]", xs[..., L:, :], tsp),
             ("last limb [2,1,N] of [2,22,N]", x22b[..., -1:, :],
              ctx.tables((L - 1,))),
             ("batched [2,3,22,N]", residues(torch, rng, ctx.moduli[:L], (2, 3), n,
                                             word_tensor), t22)]
    for logn in (11, 16):
        nn = 1 << logn
        mods = primes.gen_primes_balanced(25, 3, 2 * nn)
        tt = nttmod.make_ntt_tables(mods, nn, "cuda")
        cases.append((f"N={nn} [2,3,N]",
                      residues(torch, rng, mods, (2,), nn, word_tensor), tt))
    for what, x, t in cases:
        want = nttmod._ntt_stages(x, t)
        want_i = nttmod._intt_stages(x, t)
        for cl in (None, *tntt.cluster_sizes(t.logn)):
            same("ntt_fwd", tntt.ntt_forward(x, t, cluster=cl), want,
                 f"{what} cluster {cl}")
            same("ntt_inv", tntt.ntt_inverse(x, t, cluster=cl), want_i,
                 f"{what} cluster {cl}")
            same("ntt_inv", tntt.ntt_inverse(want, t, cluster=cl),
                 x.contiguous(), f"{what} cluster {cl} roundtrip")
    x = cases[0][1]
    fw = tntt.ntt_forward(x, t22)
    xsp = cases[2][1]
    for name, fn, plain, arg in (
            ("ntt_fwd", tntt.ntt_forward, nttmod._ntt_stages, x),
            ("ntt_inv", tntt.ntt_inverse, nttmod._intt_stages, fw)):
        timed(name, lambda: fn(arg, t22), lambda: plain(arg, t22), 50, 5)
        kern[name]["bound_ms"], kern[name]["bound_by"] = bound(
            *ntt_cost(L, L, n))
        kern[name]["cluster"] = tntt.cluster_for(ctx.logn, L, sms)
        kern[name]["device_ms_by_cluster"] = {
            f"{shape} C={cl}": profile_chain(
                torch, lambda: fn(a, t, cluster=cl), 10)["device_ms"]
            for shape, a, t in (("[22,N]", arg, t22), ("[2,8,N]", xsp, tsp))
            for cl in tntt.cluster_sizes(ctx.logn)}
        got = max(kernels_per_call(torch, lambda: fn(a, t))
                  for a, t in ((arg, t22), (xsp, tsp), (cases[3][1],
                                                        cases[3][2])))
        check(got == 1, f"{name}: {got} device kernels per call, want 1")
        kern[name]["kernels_per_call"] = got

    # Key switch at the relinearize shape (l=22, D=3, A=8, J=30), batched
    # M=2, at the size cluster_for picks and at every size the kernel takes;
    # then logN 11 and 16 at levels 5 (narrow last digit) and 4.
    ft = ctx.fused_ks_tables(L)
    J = len(ctx.key_limbs(L))
    kdata = residues(torch, rng, tkey.moduli, (2, ft.D), n, word_tensor)
    for lead in ((), (2,)):
        c = residues(torch, rng, ctx.moduli[:L], lead, n, word_tensor)
        want = tks.switch_key_plain(c, kdata, t22, tkey, ft)
        for cl in (None, *tks.cluster_sizes(ctx.logn)):
            same("keyswitch", tks.fused_switch_key(c, kdata, t22, tkey, ft,
                                                   cluster=cl),
                 want, f"lead {lead} cluster {cl}")
    small = {}
    for logn in (11, 16):
        small[logn] = sctx = CkksContext(CkksParams.create(
            logn=logn, log_q0=29, log_scale=25, num_levels=5, log_special=31,
            num_special=2, hamming_weight=32))
        for lv in (5, 4):
            sft = sctx.fused_ks_tables(lv)
            slt, skt = sctx.tables(lv), sctx.tables(sctx.key_limbs(lv))
            skd = residues(torch, rng, skt.moduli, (2, sft.D), sctx.n,
                           word_tensor)
            for lead in ((), (2,)):
                c = residues(torch, rng, sctx.moduli[:lv], lead, sctx.n,
                             word_tensor)
                want = tks.switch_key_plain(c, skd, slt, skt, sft)
                for cl in tks.cluster_sizes(logn):
                    same("keyswitch", tks.fused_switch_key(
                        c, skd, slt, skt, sft, cluster=cl), want,
                        f"logN {logn} level {lv} lead {lead} cluster {cl}")
    c = residues(torch, rng, ctx.moduli[:L], (), n, word_tensor)
    timed("keyswitch", lambda: tks.fused_switch_key(c, kdata, t22, tkey, ft),
          lambda: tks.switch_key_plain(c, kdata, t22, tkey, ft), 20, 3)
    got = kernels_per_call(torch, lambda: tks.fused_switch_key(
        c, kdata, t22, tkey, ft))
    check(got == 2, f"keyswitch: {got} device kernels per call, want the "
          f"iNTT and ks_fused")
    kern["keyswitch"]["kernels_per_call"] = got
    kern["keyswitch"]["cluster"] = tks.cluster_for(ctx.logn, J, sms)
    kern["keyswitch"]["device_ms_by_cluster"] = {
        cl: profile_chain(torch, lambda: tks.fused_switch_key(
            c, kdata, t22, tkey, ft, cluster=cl), 10)["device_ms"]
        for cl in tks.cluster_sizes(ctx.logn)}
    b_i, m_i = ntt_cost(L, L, n)                         # iNTT of c
    b_f, m_f = ntt_cost(ft.D * J, J, n)                  # NTT of t
    words_io = L * n + 2 * ft.D * J * n + 2 * J * n      # c, key, out
    muls = (m_i + m_f + ft.D * ft.A * n * SHOUP_MULS
            + (ft.D * J * ft.A + 2 * ft.D * J) * n * BARRETT_MULS)
    kern["keyswitch"]["bound_ms"], kern["keyswitch"]["bound_by"] = bound(
        4.0 * words_io + (b_i - 8.0 * L * n) + (b_f - 8.0 * ft.D * J * n),
        muls)

    # Mod-down: key-switch shape [2, 30, N] -> [2, 22, N], batched [3, 2],
    # the composite pair, each at every cluster size; then logN 11 and 16.
    fmd = ctx.fused_md_tables(L)
    xb = residues(torch, rng, ctx.moduli[:L] + ctx.special, (3, 2), n,
                  word_tensor)
    cl_ = cctx.L
    cpair = cctx.fused_md_tables(cl_, pair=True)
    cargs = (cctx.tables(tuple(range(cl_ - 2, cl_))), cctx.tables(cl_ - 2),
             cpair)
    xc = residues(torch, rng, cctx.moduli, (2,), n, word_tensor)
    md_cases = [("keyswitch [2,30,N]", xs, (tsp, t22, fmd)),
                ("batched [3,2,30,N]", xb, (tsp, t22, fmd)),
                ("composite pair [2,10,N]", xc, cargs)]
    for logn, sctx in small.items():
        sdrop = tuple(sctx.L + i for i in range(sctx.k_sp))
        md_cases.append((f"logN {logn} [2,7,N]", residues(
            torch, rng, sctx.moduli + sctx.special, (2,), sctx.n, word_tensor),
            (sctx.tables(sdrop), sctx.tables(sctx.L),
             sctx.fused_md_tables(sctx.L))))
        pctx = CkksContext(CkksParams.create_composite(
            logn=logn, num_levels=2, num_special=3, hamming_weight=32))
        md_cases.append((f"logN {logn} composite pair [2,6,N]", residues(
            torch, rng, pctx.moduli, (2,), pctx.n, word_tensor),
            (pctx.tables((pctx.L - 2, pctx.L - 1)), pctx.tables(pctx.L - 2),
             pctx.fused_md_tables(pctx.L, pair=True))))
    for what, x, args in md_cases:
        want = tks.mod_down_plain(x, *args)
        for cl in (None, *tks.cluster_sizes(args[1].logn)):
            same("moddown", tks.fused_mod_down(x, *args, cluster=cl), want,
                 f"{what} cluster {cl}")
    timed("moddown", lambda: tks.fused_mod_down(xs, tsp, t22, fmd),
          lambda: tks.mod_down_plain(xs, tsp, t22, fmd), 20, 3)
    got = kernels_per_call(torch, lambda: tks.fused_mod_down(xs, tsp, t22,
                                                             fmd))
    check(got == 2, f"moddown: {got} device kernels per call, want the iNTT "
          f"of the dropped limbs read in place and md_fused")
    kern["moddown"]["kernels_per_call"] = got
    kern["moddown"]["cluster"] = tks.cluster_for(ctx.logn, 2 * L, sms)
    kern["moddown"]["device_ms_by_cluster"] = {
        cl: profile_chain(torch, lambda: tks.fused_mod_down(
            xs, tsp, t22, fmd, cluster=cl), 10)["device_ms"]
        for cl in tks.cluster_sizes(ctx.logn)}
    k = ctx.k_sp
    b_i, m_i = ntt_cost(2 * k, k, n)
    b_f, m_f = ntt_cost(2 * L, L, n)
    muls = (m_i + m_f + 2 * k * n * SHOUP_MULS
            + 2 * L * n * (k + 1) * BARRETT_MULS + 2 * L * n * SHOUP_MULS)
    kern["moddown"]["bound_ms"], kern["moddown"]["bound_by"] = bound(
        4.0 * (2 * (L + k) * n + 2 * L * n) + (b_i - 8.0 * 2 * k * n)
        + (b_f - 8.0 * 2 * L * n), muls)
    for name in REPLACES:
        log(f"kernel {name}: equal to plain; {kern[name]['ms']:.4f} ms "
            f"(device {kern[name]['device_ms']:.4f} ms, plain "
            f"{kern[name]['plain_ms']:.3f} ms, bound "
            f"{kern[name]['bound_ms']:.4f} ms by {kern[name]['bound_by']})")
    for name in REPLACES:
        k = kern[name]
        log(f"  {name}: {k['kernels_per_call']} device kernels per call; "
            f"cluster {k['cluster']} picked; device ms by cluster size "
            + ", ".join(f"C={c}: {v:.4f}"
                        for c, v in k["device_ms_by_cluster"].items()))

    # -- 3. main path at production width ------------------------------------
    t0 = time.perf_counter()
    kg = KeyGenerator(ctx, seed=1)
    relin = kg.relin_key()
    gk = kg.galois_keys(steps=[1, 2, 4, 8], conjugate=True)
    pk = kg.public_key()
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    ev = Evaluator(ctx, relin_key=relin, galois_keys=gk)
    enc = Encryptor(ctx, secret=kg.secret, seed=2)
    enc_pk = Encryptor(ctx, public=pk, seed=3)
    dec = Decryptor(ctx, kg.secret)
    check(ev._hops(5) == [4, 1], f"rotate 5 hops {ev._hops(5)}")
    drng = np.random.default_rng(0)
    errs = {}
    _cuda.reset_launches()
    t0 = time.perf_counter()
    for r in range(REQUESTS):
        z = drng.uniform(-1, 1, ctx.params.slots)
        pt = ev.make_plain(z, params.scale, L)
        e = enc_pk if r == REQUESTS - 1 else enc
        ct = e.encrypt(pt)
        mul = ev.multiply(ct, ct)
        outs = {"encrypt": (ct, z), "mul_relin": (mul, z * z),
                "rescale": (ev.rescale(mul), z * z),
                "rotate5": (ev.rotate(ct, 5), np.roll(z, -5)),
                "conjugate": (ev.conjugate(ct), z)}
        for what, (o, want) in outs.items():
            got = dec.decrypt(o)
            check(got.shape == want.shape and np.isfinite(got).all(),
                  f"request {r} {what}: bad output")
            err = float(np.max(np.abs(got - want)))
            key = ("pk_" if e is enc_pk else "") + what
            errs[key] = max(errs.get(key, 0.0), err)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    log(f"main path: keygen {keygen_s:.1f} s, {REQUESTS} requests "
        f"{main_s:.1f} s; launches {launches}")
    for what, err in sorted(errs.items()):
        log(f"  decrypt {what}: max abs err {err:.3e} (bound {ERR_BOUND_W32})")
        check(err <= ERR_BOUND_W32, f"main path {what}: error {err}")
    for name in REPLACES:
        check(launches[name] > 0, f"kernel {name} not launched on the main path")
        kern[name]["launches"] = launches[name]
    result["phases"]["main"] = {"keygen_s": keygen_s, "requests": REQUESTS,
                                "seconds": main_s, "max_abs_err": errs,
                                "launches": launches}

    # -- 4. composite chain ----------------------------------------------------
    ckg = KeyGenerator(cctx, seed=1)
    cev = Evaluator(cctx, relin_key=ckg.relin_key())
    cenc = Encryptor(cctx, secret=ckg.secret, seed=2)
    cdec = Decryptor(cctx, ckg.secret)
    z = drng.uniform(-1, 1, cctx.params.slots)
    cct = cenc.encrypt(cev.make_plain(z, cparams.scale, cctx.L))
    _cuda.reset_launches()
    cres = cev.rescale(cev.multiply(cct, cct))
    torch.cuda.synchronize()
    claunch = dict(_cuda.LAUNCHES)
    got = cdec.decrypt(cres)
    cerr = float(np.max(np.abs(got - z * z)))
    log(f"composite: level {cct.level} -> {cres.level}, max abs err "
        f"{cerr:.3e} (bound {ERR_BOUND_COMPOSITE}); launches {claunch}")
    check(np.isfinite(got).all() and cerr <= ERR_BOUND_COMPOSITE,
          f"composite error {cerr}")
    check(cres.level == cctx.L - 2 and claunch["moddown"] >= 2,
          "composite rescale did not take the pair mod-down")
    result["phases"]["composite"] = {"max_abs_err": cerr, "launches": claunch}

    # -- 5. rate ----------------------------------------------------------------
    z = drng.uniform(-1, 1, ctx.params.slots)
    ct = enc.encrypt(ev.make_plain(z, params.scale, L))
    state = {"data": ct.data}

    def mult_relin():
        c = Ciphertext(state["data"], params.scale)
        state["data"] = ev.multiply(c, c).data

    ms = timer(mult_relin, iters=ITERS, warmup=3)
    ms_rs = timer(lambda: ev.rescale(ev.multiply(ct, ct)), iters=ITERS,
                  warmup=3)
    ms_mul = timer(lambda: ev.multiply(ct, ct, relin=False), iters=ITERS)
    log(f"rate: ct-mult+relin {1e3 / ms:.2f} ops/s ({ms:.3f} ms/op, dependent "
        f"chain of {ITERS}, logN=15 L=22 alpha=8)")
    log(f"rate: ct-mult+relin+rescale {1e3 / ms_rs:.2f} ops/s ({ms_rs:.3f} ms/op)")
    log(f"breakdown (ms): dyadic multiply {ms_mul:.3f}, key switch "
        f"{kern['keyswitch']['ms']:.3f}, mod-down [2,30,N] "
        f"{kern['moddown']['ms']:.3f}")
    result["rate"] = {"mult_relin_ops_s": 1e3 / ms, "mult_relin_ms": ms,
                      "mult_relin_rescale_ops_s": 1e3 / ms_rs,
                      "mult_relin_rescale_ms": ms_rs, "dyadic_ms": ms_mul}
    prof = profile_chain(torch, mult_relin, reps=10)
    prof["idle_share"] = idle = 1.0 - prof["device_ms"] / ms
    log(f"profile: ct-mult+relin device time {prof['device_ms']:.3f} ms "
        f"of {ms:.3f} ms per op (device idle {100 * idle:.1f}%), "
        f"{prof['launches']:.0f} kernel launches per op")
    for name, kms, cnt in prof["top"]:
        log(f"  {kms:.4f} ms  x{cnt:.0f}  {name}")
    result["profile"] = prof
    prof_rs = profile_chain(torch, lambda: ev.rescale(ev.multiply(ct, ct)),
                            reps=10)
    log(f"profile: ct-mult+relin+rescale device time "
        f"{prof_rs['device_ms']:.3f} ms per op, "
        f"{prof_rs['launches']:.0f} kernel launches per op")
    for name, kms, cnt in prof_rs["top"]:
        log(f"  {kms:.4f} ms  x{cnt:.0f}  {name}")
    result["profile_rescale"] = prof_rs

    # -- 6. report ----------------------------------------------------------------
    rows = []
    for name in REPLACES:
        k = kern[name]
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": k["launches"],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None,
                     "device_ms": k["device_ms"]})
    result["kernels"] = rows
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the results here")
    args = ap.parse_args()
    try:
        result = run()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    import torch
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    result["card"] = smi
    result["device"] = device
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"kernels": result["kernels"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
