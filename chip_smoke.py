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
             the mod-down); kernel and plain ms by CUDA events; then the
             MAC kernel (csrc/mac.cu: hoisted key product, lifted c0,
             masked sum) against its plain versions at the served ResNet
             bootstrap's widths, with its ms, device ms and bound there
             (``mac_kernels``); then the dyadic kernel (csrc/dyadic.cu:
             tensor product, products, adds with a ciphertext's other
             components copied, batch sums) against its plain versions at
             the bootstrap's widths and at a 128-ciphertext Granite batch,
             with ms, device ms, bound and the wrapper's host us beside the
             plain version's at gpt2s.ln1's shapes (``dyadic_kernels``);
             from phase 6 on, hold_path_to_plain holds the MAC kernel's
             three wrappers and the dyadic kernel's six as it holds the
             four kernels;
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
  6. bootstrap  the composite chain of `bench.py --metric bootstrap
             --composite` (logN=15, 22 level pairs = 46 limbs, alpha=8
             special primes, h=192, 8192 sparse slots; EvalMod K=25, degree
             59 from the port's cache; CtS and StC in 2 factors each) through
             CkksBackend -> Bootstrapper -> galois_keys(required_steps) ->
             bootstrap: one ciphertext of uniform(-1, 1) slots at the base
             level, decrypted (mean abs error < 1e-3, output level >= base +
             2 pairs), every kernel launched (counts zeroed just before and
             read just after); ModRaise, one hoisted_rotations_ext set (the
             first CtS plan's baby steps) and one rotate_hoisted set on the
             card torch.equal to the same calls on a CPU copy of the context
             and keys (the plain route); every kernel torch.equal to its
             plain version at each distinct shape the bootstrap gives it
             (among them the key switch at 46 limbs / 6 digits / 54 key
             limbs, the stacked key switches of EvalMod and the stacked
             pair rescale);
             then seconds per bootstrap by CUDA
             events (one warm-up, median of 3), wall and device ms per
             stage, device ms, kernels, top kernels and idle share from
             torch.profiler, launches of each kernel per bootstrap and peak
             memory;
  7. resnet  ResNet-20 at full width (16/32/64 channels, one 3x32x32 image
             in one ciphertext of 16384 slots, synthetic weights from numpy
             seed 0) served by the secure-inference service on the
             composite chain of 39 level pairs = 80 limbs with 16 special
             primes (5 digits, 96 key limbs): first the native runtime is
             built and its encoder held equal to the numpy route; the client
             (context, keys from seed 1 with 48 base-16 digit keys and
             conjugation, encryptor seed 2, decryptor) uploads params, relin
             key and one frame per Galois key through init_session_stream,
             drops its evaluation keys, encrypts the packed image and sends
             it through evaluate; the server (SecureInferenceServer, over
             loopback gRPC; the phase needs grpcio) builds its context and
             backend from the frames alone, with no encryptor or decryptor,
             and on its first call the Bootstrapper (CtS and StC in 3
             factors) from the uploaded keys, then runs the forward. Checks:
             the plain run's pre-ReLU inputs inside the sign's domain and
             its argmax the float oracle's; the decrypted logits' argmax
             the float oracle's and the plain run's, within 0.1 of the plain
             logits;
             every refresh the one before a ReLU, leaving at the
             post-bootstrap level (each through the staged sealed
             bootstrap: CUDA graphs captured on the first, replayed after;
             phase 11 (c)); launch counts zeroed just before the
             request and read just after its answer, every kernel launched;
             every kernel torch.equal to its plain version at each shape of
             one residual block and its two bootstraps (run eagerly: a
             replay calls no wrapper) on the server's backend; then the
             transport, the upload's frames, bytes (raw
             and on the wire) and seconds (the wall time; client
             serialization, on a thread per core, and server load, each
             summed over its frames), the request's round trip and bytes,
             seconds per image (model_fn), bootstraps and their seconds, the
             block's device ms, kernels and idle share from torch.profiler,
             and peak memory;
  7b. pir    EmbeddingPIRServer over the first 1024 rows of GPT-2 small's
             synthetic wte (seed 0) at its full width 768, on a logN=11
             uint32 chain (1024 slots, one query ciphertext), served on the
             card and on the CPU: three token queries through
             evaluate_stream, each answer within 1e-3 of its table row and
             torch.equal to the CPU route's; every kernel launched;
  8. gpt2    one GPT-2 block and ln_f at GPT-2 small's width (768 wide, 12
             heads, seq 16: two ciphertexts of 16384 slots; synthetic
             weights from numpy seed 0) encrypted through run_gpt2's
             parse_args, load_model, build_session and encrypted_forward on
             the ResNet phase's 80-limb chain at h=64, with base-16 digit
             keys and the driver's decrypt/re-encrypt refresh to the chain
             top: the plain run's top-1 the float oracle's (forward_float)
             and within 0.01 of it; the decrypted hidden state within
             ERR_BOUND_GPT2 of the plain run with the same logits top-1;
             every refresh input below 2^62/Δ, the refreshes printed by call
             site; launch counts zeroed just before and read just after,
             every kernel launched by the block; every kernel torch.equal to
             its plain version at each shape of one attention (the Δ batch
             of 32 ciphertexts); then seconds per block, mask encodings,
             launches per block, the attention's device ms, kernels and idle
             share from torch.profiler, and peak memory;
  9. u64     the u64 engine (int64 words, plain PyTorch ops on the card; it
             has no kernel): SEAL's vectors (tests/data/seal_vectors.bin)
             through the port on the card, square+relin+rescale and
             rotate-by-1 equal to SEAL's coefficient dumps word for word;
             the reference's GPT-2 regime gpt2_params() (logN=16, 36 limbs,
             one 60-bit special prime, h=192): keygen (relin, Galois steps
             1/4 and conjugation, public key), then requests as phase 3's
             (the second by public key), every tensor on the card, each
             output within ERR_BOUND_U64, and the four kernels launched no
             time (counts zeroed just before, read just after); then ms per
             multiply+relin, rescale and rotate and of the NTT and iNTT at
             [36, N] and [36, 37, N] (CUDA events, median of 3), device ms,
             kernels, top kernels and idle share of one multiply+relin from
             torch.profiler, keygen seconds and peak memory; one request
             (multiply+relin+rescale+rotate) at test_params(12, 6)
             torch.equal to the CPU route with keys from the same seeds;
             a u64 bootstrap at test_full_bootstrap's parameters (logN=10,
             22 levels, q0 45 bits, Δ=2^40, h=16, 64 slots, EvalMod K=12 /
             degree 45 from the port's cache) within that test's bounds
             (mean < 1e-2, max < 5e-2), output level >= 4, and its seconds;
  10. mesh   the port's (data, limb) mesh (parallel/mesh.py) on a virtual
             data=2 x limb=2 mesh of this card (["cuda:0"] * 4, a thread and
             stream per position), run right after phase 6 on phase 3's and
             phase 6's contexts and keys (no new keygen): (a) phase 3's
             chain, a batch of 2 through multiply+relin, rescale, rotate by
             5 (hops 4+1) and conjugate, the gathered words torch.equal to
             the single-device Evaluator's, every kernel launched (counts
             zeroed just before, read just after), the key bytes of every
             position beside the single-device keys', every kernel torch.equal
             to its plain version at each row-block shape the mesh gives it,
             and the key switch on one position's key rows (the row map)
             timed beside its plain version and its bound; (b) phase 6's
             bootstrap of a batch of 2 (its ciphertext and one more) on the
             same mesh shape, one CkksBackend and Bootstrapper per
             position, torch.equal to the single-device bootstrap of the
             batch and within ERR_BOUND_BOOT, launches per mesh bootstrap,
             seconds per mesh and per single-device bootstrap (CUDA
             events, median of 3) and peak memory: a virtual mesh measures
             the mesh's overhead, not scaling; (c) where the machine has
             two cards, step (a) on a limb axis over cuda:0 and cuda:1,
             torch.equal to the single-device run (else a line says it was
             not run);
  11. sealed the sealed-program layer (nn/backend.py jit_sealed: CUDA
             graphs), run right after phase 10: (a) phase 5's ct-mult+relin
             sealed: warm pass and capture seconds (and the wrappers'
             launches in them), replays torch.equal to the eager op on the
             same and on new inputs, ms per sealed call beside the eager
             op's (CUDA events, in one call), the replay's device ms, idle
             share and port kernels from torch.profiler (a replay calls no
             wrapper: the trace's kernel names show the graph ran them);
             (b) phase 6's bootstrap through bootstrap_jitted: the first
             call's warm passes and captures, replays torch.equal to the
             eager bootstrap, mean abs error < ERR_BOUND_BOOT, seconds per
             sealed bootstrap beside the eager one's (median of 3 each, in
             turns), the replay's device ms, the graph pool's bytes, the
             bytes the sealed stages hold and peak memory; (c) phase 7's
             bootstraps go through bootstrap_jitted (CkksBackend.bootstrap
             on the card): its first and steady seconds, and the mask bytes
             each ResNet-20 segment would hold sealed, against the card's
             free memory; (d) after phase 9, run_resnet --jit on
             tests/test_resnet_composite_boot.py's mini ResNet (depth 8,
             4x4, logN=10, 39 pairs, real bootstraps) for two images drawn
             with a plain top-2 logit margin above 2 * ERR_BOUND_RESNET,
             each logit argmax the plain run's and within ERR_BOUND_RESNET
             of it, the second making no new program (every segment and
             bootstrap stage a replay), then one encryption through every
             graph held torch.equal to the same driver with plain segments
             and eager bootstraps; run_gpt2 --jit --boot-need 30 on a
             2-layer toy GPT-2 (32 wide, logN=10, 40 pairs), two forwards
             within ERR_BOUND_SEALED_GPT2 of the plain run, one encryption
             replayed and held torch.equal to the plain-segment run, and
             what a graph shared between the layers' MLPs would cost;
  12. report one JSON line of kernels (the four, then the MAC kernel's
             row: its launches per phase, and the hoisted key product's
             numbers beside those of each entry), the card's name and
             power limit, and
             the last line {"ok": true, "device": {...}}.

It imports the port only, never jax or fhe_gpt2_tpu. Without a CUDA device,
or without the package beside it, it exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager
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
BOOT_SLOTS = 8192         # phase 6: sparse slots (bench.py's bootstrap)
ERR_BOUND_BOOT = 1e-3     # phase 6: mean abs error after bootstrap (the
                          # production bound of test_bootstrap_production.py)
RESNET_DEPTH = 20         # phase 7: ResNet-20 at full width
RESNET_SLOTS = 16384      # 16 x 32 x 32: one ciphertext per tensor
RESNET_LEVELS = 39        # level pairs: 80 limbs
# run_resnet's flags for the bootstrapped composite run: the level-exact
# schedule of tests/test_resnet_composite_boot.py at logN=15 (encrypt at the
# post-bootstrap level, 18 pairs), with no auto-refresh floor: a ReLU leaves
# 2 level pairs, so each conv's giant-step rotations run one pair above the
# base, where headroom 2 would refresh before every one of them. The scale
# is 2^54 (Q0 2^59): at 2^50 the 39 pairs exhaust the primes = 1 mod 2^16
# near 2^25, the top pairs' products fall to 0.64·Δ and the bootstrap's
# output is noise (tools/bootstrap_levels.py).
RESNET_ARGS = ["--composite", "--log-scale", "54", "--real-boot",
               "--levels", str(RESNET_LEVELS), "--nsp", "16", "--digit-keys",
               "--boot-factors", "3", "--start-level", "18", "--headroom",
               "0", "--sign-log2-err", "-10"]
ERR_BOUND_RESNET = 0.1    # phase 7: max |encrypted - plain| logit (the bound
                          # of tests/test_resnet_composite_boot.py)
PIR_LOGN = 11             # phase 7b: the smallest N the NTT kernels take
PIR_ROWS, PIR_WIDTH = 1024, 768   # the first rows of GPT-2 small's wte
PIR_TOKENS = [7, 500, 1023]
ERR_BOUND_PIR = 1e-3      # phase 7b: max |answer - table row|
# run_gpt2's flags for phase 8: one GPT-2 block and ln_f at GPT-2 small's
# width (768 wide, 12 heads, seq 16: two ciphertexts of 16384 slots) on the
# ResNet phase's 80-limb chain at h=64, base-16 digit keys, synthetic weights
# (numpy seed 0), LayerNorm Newton seeds at 1.25x the float forward's largest
# row, and the driver's own refresh: decrypt/re-encrypt to the chain top at
# the backend's floor (3 level pairs). 13 Newton iterations, not the
# driver's 12: the count sets where the refreshes land, and on this chain
# (tools/gpt2_refreshes.py --logn 15) 6 and 9 refresh Σz²-scale values no
# encoding holds, and 10-12 run the exp ladder's squarings where the
# rescale primes drift its scale until the causal mask after it cannot be
# encoded; 13 (and 7) do neither, and 13 refreshes least.
GPT2_ARGS = ["--layers", "1", "--seq", "16", "--hidden", "768", "--heads",
             "12", "--composite", "--logn", "15", "--levels", "39",
             "--log-scale", "54", "--nsp", "16", "--digit-keys", "--weights",
             "synthetic", "--newton-inits", "rowmax", "--ln-iters", "13"]
ERR_BOUND_GPT2_FLOAT = 0.01   # phase 8: max |plain - float oracle| hidden
ERR_BOUND_GPT2 = 1e-4     # phase 8: max |encrypted - plain| hidden (PERF.md,
                          # the prediction written before the first card run)
U64_REQUESTS = 2          # phase 9: the second one encrypts by public key
ERR_BOUND_U64 = 1e-6      # phase 9: decrypt max abs error at Δ=2^46 (the JAX
                          # budgets imply ~1e-9; a broken op gives O(1))
U64_EQUAL = (12, 6)       # phase 9: test_params(logN, levels) held card = CPU
# phase 9's u64 bootstrap: tests/test_bootstrap.py::test_full_bootstrap's
# parameters (q0/Δ = 2^5 as the reference regime) and its bounds.
U64_BOOT = dict(logn=10, log_q0=45, log_scale=40, num_levels=22,
                log_special=51, hamming_weight=16, sparse_slots=64)
ERR_BOUND_U64_BOOT = (1e-2, 5e-2)   # mean, max abs error

# phase 10: a virtual (data=2, limb=2) mesh of one card.
MESH_DEVICES = ["cuda:0"] * 4
REPLACES = {
    "ntt_fwd": "fhe_gpt2_tpu/core/tntt.py:250",
    "ntt_inv": "fhe_gpt2_tpu/core/tntt.py:266",
    "keyswitch": "fhe_gpt2_tpu/core/tks.py:262",
    "moddown": "fhe_gpt2_tpu/core/tks.py:157",
}
SPIN_CYCLES = 100_000     # profile_chain's marker kernel (~0.05 ms)
TRACE_ATTEMPTS = 3        # profile_chain: traces taken before a lost event
                          # (an incomplete trace) fails the run
PLAIN_CHUNK_BYTES = 1 << 27   # hold_path_to_plain: larger outputs are held
                              # row by row (the plain key switch widens its
                              # 788 MB output over the GPT-2 Δ batch at 80
                              # limbs to 7.5 GiB int64 products)
# The device kernel each wrapper launches once per call it counts.
KERNEL_NAMES = {
    "ntt_fwd": "ntt_fwd_kernel",
    "ntt_inv": "ntt_inv_kernel",
    "keyswitch": "ks_fused_kernel",
    "moddown": "md_fused_kernel",
}
SOURCES = {
    "ntt_fwd": "fhe_gpt2_tpu_torch/csrc/ntt.cu",
    "ntt_inv": "fhe_gpt2_tpu_torch/csrc/ntt.cu",
    "keyswitch": "fhe_gpt2_tpu_torch/csrc/keyswitch.cu",
    "moddown": "fhe_gpt2_tpu_torch/csrc/moddown.cu",
}
# The MAC kernel (csrc/mac.cu, no TPU counterpart): its three wrappers, held
# to their plain versions under these names; its launches count under
# _cuda.LAUNCHES["mac"].
MAC_SOURCE = "fhe_gpt2_tpu_torch/csrc/mac.cu"
MAC_WRAPPERS = ("hoisted_mac", "add_lifted", "masked_sum")
# The dyadic kernel (csrc/dyadic.cu, no TPU counterpart): its six wrappers
# (core/tdyadic.py), held to their plain versions under these names; its
# launches count under _cuda.LAUNCHES["dyadic"].
DYADIC_SOURCE = "fhe_gpt2_tpu_torch/csrc/dyadic.cu"
DYADIC_WRAPPERS = ("tensor_product", "mul_mod", "add_mod", "sub_mod",
                   "neg_mod", "mod_sum")


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


def profile_chain(torch, fn, reps: int, warm: bool = True,
                  pad=None, expected=None) -> dict:
    """Device time per call of fn, device kernels per call and the top
    kernels by device time, from torch.profiler over reps calls, after one
    warm-up call (warm=False: the caller has just run fn). A trace must
    hold the spin kernel that marks the counted calls and as many of the
    port's kernels as the wrappers launched in those calls
    (``_cuda.LAUNCHES``), or, where fn replays CUDA graphs (whose kernels
    no wrapper launches), ``expected`` of each per call: a trace that lost
    events would understate the device time. An incomplete trace is taken
    again, up to TRACE_ATTEMPTS traces in all; then the run fails. ``pad``
    (default: fn) is called at the start of each trace, before the counted
    calls."""
    if warm:
        fn()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        kern, traced, launched, lost = _trace(torch, fn, reps, pad,
                                              expected)
        if not lost:
            break
        log(f"  torch.profiler: {lost} (trace {attempt} of "
            f"{TRACE_ATTEMPTS})")
    check(not lost, f"torch.profiler: {lost} in {TRACE_ATTEMPTS} traces")
    by_name: dict = {}
    for e in kern:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    busy_us = sum(us for us, _ in by_name.values())
    check(busy_us > 0, "torch.profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"device_ms": busy_us / 1e3 / reps,
            "launches": len(kern) / reps,
            "port_launches": {k: v / reps for k, v in traced.items()},
            "top": [(name[:70], us / 1e3 / reps, count / reps)
                    for name, (us, count) in top]}


def _trace(torch, fn, reps: int, pad, expected=None):
    """One torch.profiler trace of pad (default fn), the spin marker and
    reps calls of fn: (device events after the marker, the port's kernels
    among them, the wrappers' launches in the counted calls or reps times
    ``expected``, what the trace lost: "" when it is complete)."""
    from torch.profiler import ProfilerActivity, profile
    from fhe_gpt2_tpu_torch.core import _cuda
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # The tracer can drop the first device events of a trace (on the
        # H100 it dropped up to six kernels, the first after a long
        # untraced run, and at times the marker itself): sixteen small
        # kernels and one more call of fn (or pad) pad the start, and a
        # spin kernel marks where the counted calls begin.
        x = torch.zeros(1, device="cuda")
        for _ in range(16):
            x.add_(1)
        (pad or fn)()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        before = dict(_cuda.LAUNCHES)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        launched = {k: _cuda.LAUNCHES[k] - before[k] for k in KERNEL_NAMES}
    if expected is not None:
        launched = {k: expected[k] * reps for k in KERNEL_NAMES}
    # Device work: CUDA events but user annotations (the profiler's own
    # ProfilerStep* range), in the order they ran.
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e for e in prof.events() if e.device_type == cuda
                     and not getattr(e, "is_user_annotation", False)
                     and not e.name.startswith("ProfilerStep")),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    if len(marks) != 1:
        return [], {}, launched, (f"traced {len(marks)} spin kernels where "
                                  f"one marks the counted calls")
    kern = events[marks[0] + 1:]
    traced = {k: sum(name in e.name for e in kern)
              for k, name in KERNEL_NAMES.items()}
    if traced != launched:
        for e in events[:400]:
            log(f"  traced: {e.time_range.start:.1f} us "
                f"{e.time_range.elapsed_us():.1f} us {e.name[:100]}")
        return kern, traced, launched, (
            f"traced {traced} of the port's kernels where the wrappers "
            f"launched {launched}: the trace is incomplete")
    return kern, traced, launched, ""


def kernels_per_call(torch, fn) -> int:
    """Device kernels one call of fn launches, from torch.profiler."""
    return round(profile_chain(torch, fn, 1)["launches"])


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

    t_script = time.perf_counter()
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
    kern = {k: {"max_abs_err": 0}
            for k in (*REPLACES, *MAC_WRAPPERS, *DYADIC_WRAPPERS)}

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
    mac = mac_kernels(torch, timer, same, rng, sms)
    dyadic = dyadic_kernels(torch, timer, same, rng)
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

    # -- 6. bootstrap --------------------------------------------------------------
    boot, boot_state = bootstrap_phase(torch, timer, same)
    result["phases"]["bootstrap"] = boot
    for name in REPLACES:
        kern[name]["launches_per_bootstrap"] = boot["launches"][name]

    # -- 10. mesh (on phase 3's and phase 6's contexts and keys) ---------------
    result["phases"]["mesh"] = mesh = mesh_phase(
        torch, timer, same, kern, dict(ctx=ctx, ev=ev, enc=enc), boot_state)
    for name in REPLACES:
        kern[name]["launches_mesh_step"] = mesh["step_launches"][name]
        kern[name]["launches_per_mesh_bootstrap"] = mesh["boot_launches"][name]

    # -- 11. sealed (a, b: phase 5's unit op and phase 6's bootstrap) -------
    result["phases"]["sealed"] = sealed = sealed_phase(
        torch, timer, dict(ctx=ctx, ev=ev, enc=enc), boot_state)
    for name in REPLACES:
        kern[name]["launches_sealed_capture"] = \
            sealed["unit"]["capture_launches"][name]
        kern[name]["replay_kernels_unit"] = \
            sealed["unit"]["replay_profile"]["port_launches"][name]
        kern[name]["replay_kernels_bootstrap"] = \
            sealed["bootstrap"]["replay_profile"]["port_launches"][name]
    del boot_state
    gc.collect()
    torch.cuda.empty_cache()

    # -- 7. resnet -------------------------------------------------------------
    result["phases"]["resnet"] = net = resnet_phase(torch, timer, same)
    for name in REPLACES:
        kern[name]["launches_per_resnet_image"] = net["launches"][name]

    result["phases"]["pir"] = pir = pir_phase(torch)
    for name in REPLACES:
        kern[name]["launches_per_pir_request"] = pir["launches"][name]

    # -- 8. gpt2 ---------------------------------------------------------------
    result["phases"]["gpt2"] = gpt = gpt2_phase(torch, same)
    for name in REPLACES:
        kern[name]["launches_per_gpt2_block"] = gpt["block_launches"][name]

    # -- 9. u64 ----------------------------------------------------------------
    result["phases"]["u64"] = u64 = u64_phase(torch, timer)
    for name in REPLACES:
        kern[name]["launches_u64"] = u64["launches"][name]

    # -- 11. sealed (d: the segment drivers) ---------------------------------
    sealed["drivers"] = sealed_drivers_phase(torch)

    # -- 12. report ---------------------------------------------------------------
    rows = []
    for name in REPLACES:
        k = kern[name]
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": k["launches"],
                     "launches_per_bootstrap": k["launches_per_bootstrap"],
                     "launches_per_resnet_image":
                         k["launches_per_resnet_image"],
                     "launches_per_pir_request":
                         k["launches_per_pir_request"],
                     "launches_per_gpt2_block": k["launches_per_gpt2_block"],
                     "launches_u64": k["launches_u64"],
                     "launches_mesh_step": k["launches_mesh_step"],
                     "launches_per_mesh_bootstrap":
                         k["launches_per_mesh_bootstrap"],
                     "launches_sealed_capture": k["launches_sealed_capture"],
                     "replay_kernels_unit": k["replay_kernels_unit"],
                     "replay_kernels_bootstrap":
                         k["replay_kernels_bootstrap"],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None,
                     "device_ms": k["device_ms"]})
    ph = result["phases"]
    mac_launches = {
        "launches": ph["main"]["launches"]["mac"],
        "launches_per_bootstrap": boot["launches"]["mac"],
        "launches_per_resnet_image": net["launches"]["mac"],
        "launches_per_pir_request": pir["launches"]["mac"],
        "launches_per_gpt2_block": gpt["block_launches"]["mac"],
        "launches_u64": u64["launches"]["mac"],
        "launches_mesh_step": mesh["step_launches"]["mac"],
        "launches_per_mesh_bootstrap": mesh["boot_launches"]["mac"],
        "launches_sealed_capture": sealed["unit"]["capture_launches"]["mac"]}
    rows.append({"name": "mac", "route": "cuda", "source": MAC_SOURCE,
                 "replaces": None, **mac_launches,
                 "replay_kernels_unit": None,
                 "replay_kernels_bootstrap": None,
                 "max_abs_err": max(kern[w]["max_abs_err"]
                                    for w in MAC_WRAPPERS),
                 "ms": mac["hoisted_mac"]["ms"],
                 "plain_ms": mac["hoisted_mac"]["plain_ms"],
                 "bound_ms": mac["hoisted_mac"]["bound_ms"],
                 "bound_by": mac["hoisted_mac"]["bound_by"],
                 "library_ms": None,
                 "device_ms": mac["hoisted_mac"]["device_ms"],
                 "entries": mac})
    dy = dyadic["tensor_product"]
    rows.append({"name": "dyadic", "route": "cuda", "source": DYADIC_SOURCE,
                 "replaces": None,
                 "launches": ph["main"]["launches"]["dyadic"],
                 "launches_per_bootstrap": boot["launches"]["dyadic"],
                 "launches_per_resnet_image": net["launches"]["dyadic"],
                 "launches_per_pir_request": pir["launches"]["dyadic"],
                 "launches_per_gpt2_block": gpt["block_launches"]["dyadic"],
                 "launches_u64": u64["launches"]["dyadic"],
                 "launches_mesh_step": mesh["step_launches"]["dyadic"],
                 "launches_per_mesh_bootstrap":
                     mesh["boot_launches"]["dyadic"],
                 "launches_sealed_capture":
                     sealed["unit"]["capture_launches"]["dyadic"],
                 "replay_kernels_unit": None,
                 "replay_kernels_bootstrap": None,
                 "max_abs_err": max(kern[w]["max_abs_err"]
                                    for w in DYADIC_WRAPPERS),
                 "ms": dy["ms"], "plain_ms": dy["plain_ms"],
                 "bound_ms": dy["bound_ms"], "bound_by": dy["bound_by"],
                 "library_ms": None, "device_ms": dy["device_ms"],
                 "entries": dyadic})
    result["kernels"] = rows
    result["script_s"] = time.perf_counter() - t_script
    log(f"chip_smoke: {result['script_s']:.1f} s from the first import of "
        f"the port to the report")
    return result


def mac_kernels(torch, timer, same, rng, sms) -> dict:
    """Phase 2's MAC kernel (csrc/mac.cu): each wrapper torch.equal to its
    plain version at the served ResNet bootstrap's widths (logN=15, 96 key
    rows: CoeffToSlot's hoisted key product over 5 digits, the lifted c0 on
    80 data rows, masked sums of 1, 8 and 9 terms), with and without a
    batch of 2, on a Galois permutation and on any permutation; then at the
    unbatched shapes ms (CUDA events), device ms (torch.profiler), device
    kernels per call, plain ms and the bound. Returns {wrapper: numbers}."""
    from fhe_gpt2_tpu_torch.core import ntt as nttmod, primes, tks
    from fhe_gpt2_tpu_torch.core.modmath import word_tensor
    n, J, D, r = 1 << 15, 96, 5, 80
    t = nttmod.make_ntt_tables(primes.gen_primes_balanced(30, J, 2 * n), n,
                               "cuda")

    def words(mods, lead):
        return residues(torch, rng, mods, lead, n, word_tensor)

    def perm_of(p):
        return torch.from_numpy(np.asarray(p, dtype=np.int64)).to("cuda")

    galois = perm_of(nttmod.galois_ntt_permutation(n, pow(5, 1023, 2 * n)))
    anyperm = perm_of(rng.permutation(n))
    P = (1 << 31) * 4099 + 5
    p = word_tensor(np.array([P % q for q in t.moduli], dtype=np.uint64)
                    [:, None], "cuda")
    ps = word_tensor(np.array([((P % q) << 32) // q for q in t.moduli],
                              dtype=np.uint64)[:, None], "cuda")
    qr = t.q[:r]
    key = words(t.moduli, (2, D))
    for lead in ((), (2,)):
        tp = words(t.moduli, lead + (D,))
        for perm, what in ((galois, "Galois"), (anyperm, "any permutation")):
            same("hoisted_mac", tks.hoisted_mac(tp, key, perm, t),
                 tks.hoisted_mac_plain(tp, key, perm, t),
                 f"lead {lead} {what}")
        acc, c0 = words(t.moduli, (2,) + lead), words(t.moduli[:r], lead)
        want = tks.add_lifted_plain(acc, c0, galois, p, ps, qr)
        same("add_lifted", tks.add_lifted(acc, c0, galois, p, ps, qr), want,
             f"lead {lead}")
        for T in (1, 8, 9):
            vals = [words(t.moduli, (2,) + lead) for _ in range(T)]
            pts = [words(t.moduli, ()) for _ in range(T)]
            same("masked_sum", tks.masked_sum(vals, pts, t),
                 tks.masked_sum_plain(vals, pts, t), f"lead {lead} T {T}")
    tp, c0 = words(t.moduli, (D,)), words(t.moduli[:r], ())
    acc = tks.hoisted_mac(tp, key, galois, t)
    vals = [words(t.moduli, (2,)) for _ in range(8)]
    pts = [words(t.moduli, ()) for _ in range(8)]
    # Bytes: each operand word read once, each output word written once (the
    # lifted c0's output rows read and written); multiplies: two 32-bit ones
    # per 64-bit product, five per output word's reduction.
    cases = {
        "hoisted_mac": (
            f"tpoly [{D},{J},N], key [2,{D},{J},N]",
            lambda: tks.hoisted_mac(tp, key, galois, t),
            lambda: tks.hoisted_mac_plain(tp, key, galois, t),
            4.0 * (3 * D * J * n + 2 * J * n) + 8.0 * n,
            4 * D * J * n + 10 * J * n),
        "add_lifted": (
            f"c0 [{r},N] into [2,{J},N]",
            lambda: tks.add_lifted(acc, c0, galois, p, ps, qr),
            lambda: tks.add_lifted_plain(acc, c0, galois, p, ps, qr),
            4.0 * 3 * r * n + 8.0 * n, r * n * SHOUP_MULS),
        "masked_sum": (
            f"8 terms [2,{J},N], masks [{J},N]",
            lambda: tks.masked_sum(vals, pts, t),
            lambda: tks.masked_sum_plain(vals, pts, t),
            4.0 * (8 * 3 * J * n + 2 * J * n), 4 * 8 * J * n + 10 * J * n)}
    out = {}
    for name, (shape, fn, plain, nbytes, muls) in cases.items():
        k = out[name] = {"shape": shape, "ms": timer(fn, iters=20),
                         "plain_ms": timer(plain, iters=3),
                         "device_ms": profile_chain(torch, fn, 10)[
                             "device_ms"],
                         "kernels_per_call": kernels_per_call(torch, fn)}
        k["bound_ms"], k["bound_by"] = bound(nbytes, muls)
        check(k["kernels_per_call"] == 1,
              f"{name}: {k['kernels_per_call']} device kernels per call")
        log(f"kernel mac {name} ({shape}): equal to plain; {k['ms']:.4f} ms "
            f"(device {k['device_ms']:.4f} ms, plain {k['plain_ms']:.3f} ms,"
            f" bound {k['bound_ms']:.4f} ms by {k['bound_by']})")
    return out


def dyadic_kernels(torch, timer, same, rng) -> dict:
    """Phase 2's dyadic kernel (csrc/dyadic.cu): each wrapper torch.equal to
    its plain version at the served ResNet bootstrap's widths (logN=15,
    one ciphertext at 48 rows) and at the Granite cell's batch (2 x 128
    ciphertexts at 50 rows), on canonical and on lazy words in [0, 2q);
    then at the Granite batch ms (CUDA events), device ms (torch.profiler),
    device kernels per call, plain ms and the bound; and at gpt2s.ln1's
    shapes (2 ciphertexts at 80 rows) the host us of a wrapper call beside
    the plain version's (enqueue time: the card is not waited on). Returns
    {entry: numbers}."""
    from fhe_gpt2_tpu_torch.core import ntt as nttmod, primes, tdyadic as T
    from fhe_gpt2_tpu_torch.core.modmath import word_tensor
    n = 1 << 15

    def tables(rows):
        return nttmod.make_ntt_tables(
            primes.gen_primes_balanced(27, rows, 2 * n), n, "cuda")

    def words(t, lead, lazy=False):
        mods = [(2 if lazy else 1) * q for q in t.moduli]
        return residues(torch, rng, mods, lead, n, word_tensor)

    def const(t):
        return word_tensor(np.array([rng.integers(0, q) for q in t.moduli],
                                    dtype=np.uint64)[:, None], "cuda")

    def cases(t, lead, lazy=False):
        """{entry: (wrapper, call, plain call, bytes, multiplies)} on
        ciphertexts [2, *lead, l, N]: P words a component, a plaintext or
        a constant of l rows. Bytes: each operand word read once, each
        output word written once; multiplies: two 32-bit ones per 64-bit
        product, five per reduction."""
        a, b = words(t, (2, *lead), lazy), words(t, (2, *lead), lazy)
        p, c = words(t, ()), const(t)
        P = a[0].numel()
        ln = p.numel()
        out = {
            "tensor_product": ("tensor_product",
                               lambda: T.tensor_product(a, b, t),
                               lambda: T.tensor_product_plain(a, b, t),
                               4.0 * 7 * P, 23 * P),
            "square": ("tensor_product", lambda: T.tensor_product(a, a, t),
                       lambda: T.tensor_product_plain(a, a, t),
                       4.0 * 5 * P, 21 * P),
            "mul_plain": ("mul_mod", lambda: T.mul_mod(a, p, t),
                          lambda: T.mul_mod_plain(a, p, t),
                          4.0 * (4 * P + ln), 14 * P),
            "mul_const": ("mul_mod", lambda: T.mul_mod(a, c, t),
                          lambda: T.mul_mod_plain(a, c, t),
                          4.0 * 4 * P, 14 * P),
            "add_plain": ("add_mod",
                          lambda: T.add_mod(a[0], p, t, rest=a[1:]),
                          lambda: T.add_mod_plain(a[0], p, t, rest=a[1:]),
                          4.0 * (4 * P + ln), 0),
            "add": ("add_mod", lambda: T.add_mod(a, b, t),
                    lambda: T.add_mod_plain(a, b, t), 4.0 * 6 * P, 0),
            "sub": ("sub_mod", lambda: T.sub_mod(a, b, t),
                    lambda: T.sub_mod_plain(a, b, t), 4.0 * 6 * P, 0),
            "neg": ("neg_mod", lambda: T.neg_mod(a, t),
                    lambda: T.neg_mod_plain(a, t), 4.0 * 4 * P, 0)}
        if lead:
            m = P // ln                      # the summed axis
            out["mod_sum"] = ("mod_sum", lambda: T.mod_sum(a, t, axis=1),
                              lambda: T.mod_sum_plain(a, t, axis=1),
                              4.0 * (2 * P + 2 * P // m), 10 * P // m)
        return out

    t48, t50, t80 = tables(48), tables(50), tables(80)
    for t, lead, label in ((t48, (), "bootstrap [2,48,N]"),
                           (t50, (128,), "Granite [2,128,50,N]")):
        for lazy in (False, True):
            for name, (w, fn, plain, _, _) in cases(t, lead, lazy).items():
                same(w, fn(), plain(), f"{label} {name}"
                     + (" lazy" if lazy else ""))
                torch.cuda.empty_cache()
    out = {}
    for name, (w, fn, plain, nbytes, muls) in cases(t50, (128,)).items():
        prof = profile_chain(torch, fn, 10)
        k = out[name] = {"shape": "[2,128,50,N]", "ms": timer(fn, iters=10),
                         "plain_ms": timer(plain, iters=2),
                         "device_ms": prof["device_ms"],
                         "kernels_per_call": round(prof["launches"])}
        k["bound_ms"], k["bound_by"] = bound(nbytes, muls)
        check(k["kernels_per_call"] == 1,
              f"dyadic {name}: {k['kernels_per_call']} device kernels a call")
        torch.cuda.empty_cache()

    def host_us(fn, calls=30):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / calls * 1e6

    small = cases(t80, (2,))
    for name, k in out.items():
        _, fn, plain, _, _ = small[name]
        k["host_us"], k["plain_host_us"] = host_us(fn), host_us(plain)
        log(f"kernel dyadic {name} ([2,128,50,N]): equal to plain; "
            f"{k['ms']:.4f} ms (device {k['device_ms']:.4f} ms, plain "
            f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}); host {k['host_us']:.1f} us a call at "
            f"[2,2,80,N] (plain {k['plain_host_us']:.1f} us)")
    return out


def hold_path_to_plain(run, same) -> dict:
    """Call run() once with the four kernel wrappers, the MAC kernel's
    three and the dyadic kernel's six replaced, wherever the port's modules
    hold them, by recorders: the first call of each distinct operand shape,
    layout and table set is also computed by the wrapper's plain version on
    the same inputs and held to it with same(name, got, want, what).
    Returns {kernel: [signature, ...]} of the shapes held; a signature is
    (operand shape, operand strides, key shape or None, the number of limbs
    divided out or None), and a dyadic wrapper's the shapes and strides of
    its tensor arguments and its other arguments."""
    import torch

    from fhe_gpt2_tpu_torch.core import ntt as nttmod, tdyadic, tks, tntt

    def ntt_sig(x, t):
        return (tuple(x.shape), x.stride(), None, None), id(t)

    def ks_sig(c, kdata, lt, kt, ft):
        return (tuple(c.shape), c.stride(), tuple(kdata.shape), None), id(ft)

    def md_sig(x, t_sp, t_q, ft):
        return (tuple(x.shape), x.stride(), None, ft.k), id(ft)

    def mac_sig(x, kdata, perm, kt):
        return (tuple(x.shape), x.stride(), tuple(kdata.shape), None), id(kt)

    def lift_sig(acc, c0, perm, p, ps, q):
        return (tuple(acc.shape), c0.stride(), None, q.shape[0]), id(q)

    def sum_sig(values, pts, t):
        return ((tuple(values[0].shape),
                 tuple(v.stride() for v in values), None, len(values)),
                id(t))

    def dyadic_sig(*args, **kw):
        return (tuple((tuple(x.shape), x.stride())
                      if isinstance(x, torch.Tensor) else x
                      for x in (*args, *kw.values())
                      if not hasattr(x, "moduli")) + tuple(kw),
                id(next(x for x in args if hasattr(x, "moduli"))))

    wrappers = {"ntt_fwd": (tntt.ntt_forward, nttmod._ntt_stages, ntt_sig),
                "ntt_inv": (tntt.ntt_inverse, nttmod._intt_stages, ntt_sig),
                "keyswitch": (tks.fused_switch_key, tks.switch_key_plain,
                              ks_sig),
                "moddown": (tks.fused_mod_down, tks.mod_down_plain, md_sig),
                "hoisted_mac": (tks.hoisted_mac, tks.hoisted_mac_plain,
                                mac_sig),
                "add_lifted": (tks.add_lifted, tks.add_lifted_plain,
                               lift_sig),
                "masked_sum": (tks.masked_sum, tks.masked_sum_plain,
                               sum_sig),
                **{w: (getattr(tdyadic, w), getattr(tdyadic, w + "_plain"),
                       dyadic_sig) for w in DYADIC_WRAPPERS}}
    held: dict = {name: {} for name in wrappers}

    def hold(name, out, plain, args, what):
        """out against plain(*args); an operand with a batch axis and more
        than PLAIN_CHUNK_BYTES of output is held row by row along its first
        batch axis (the plain versions widen to int64, and treat batch rows
        independently, so the rows are the whole comparison)."""
        x = args[0]
        ia = 1 if name == "moddown" else 0        # x's first batch axis
        oa = 0 if name.startswith("ntt") else 1    # out's
        if name == "hoisted_mac":
            ia = 0 if x.dim() > 3 else None         # its digit axis is not
        if (name == "masked_sum" or ia is None or x.dim() - 2 - ia < 1
                or out.numel() * out.element_size() <= PLAIN_CHUNK_BYTES):
            same(name, out, plain(*args), what)
            return
        for i in range(x.shape[ia]):
            same(name, out.select(oa, i), plain(x.select(ia, i), *args[1:]),
                 f"{what} row {i}")

    def recorder(name, wrapper, plain, sig):
        def call(*args, **kw):
            dyadic = name in DYADIC_WRAPPERS
            s, tables = sig(*args, **kw) if dyadic else sig(*args)
            new = (s, tables) not in held[name]
            if new and name == "add_lifted":
                # In place on the card: the plain version reads the operand
                # as it was.
                want = plain(args[0].clone(), *args[1:])
            out = wrapper(*args, **kw)
            if new:
                held[name][s, tables] = s
                if name == "add_lifted":
                    same(name, out, want, f"path {s[:3]}")
                elif dyadic:
                    same(name, out, plain(*args, **kw), f"path {s[:3]}")
                else:
                    hold(name, out, plain, args, f"path {s[:3]}")
            return out
        return call

    mods = [m for k, m in list(sys.modules.items())
            if k.startswith("fhe_gpt2_tpu_torch") and m is not None]
    patched = []
    for name, (wrapper, plain, sig) in wrappers.items():
        rec = recorder(name, wrapper, plain, sig)
        for m in mods:
            for attr, v in list(vars(m).items()):
                if v is wrapper:
                    setattr(m, attr, rec)
                    patched.append((m, attr, wrapper))
    try:
        run()
    finally:
        for m, attr, wrapper in patched:
            setattr(m, attr, wrapper)
    return {name: list(h.values()) for name, h in held.items()}


class RefreshLog:
    """Records every refresh a CkksBackend makes (its ``bootstrap``, which
    the level floor calls) where the refresh decrypts, as the decrypt/
    re-encrypt refresh does: the call site as the chain of frames in
    ``nn/layers.py`` and ``nn/kernels.py``, the input's level, its batch
    shape and its largest |slot|, read from the refresh's own decrypts of
    it through ``dec``."""

    SITE_FILES = ("nn/layers.py", "nn/kernels.py")

    def __init__(self, B, dec):
        self.rows: list = []
        open_rows: list = []
        inner_boot, inner_dec = B.bootstrap, dec.decrypt

        def decrypt(ct, *args, **kw):
            out = inner_dec(ct, *args, **kw)
            if open_rows:
                open_rows[-1]["max_abs"] = max(
                    open_rows[-1]["max_abs"],
                    float(np.abs(np.real(out)).max()))
            return out

        def logged(v, **kw):
            row = {"site": self.site(), "level": v.level,
                   "batch": list(v.data.shape[1:-2]), "max_abs": 0.0}
            self.rows.append(row)
            open_rows.append(row)
            try:
                return inner_boot(v, **kw)
            finally:
                open_rows.pop()

        dec.decrypt = decrypt
        B.bootstrap = logged

    @classmethod
    def site(cls) -> str:
        """The caller's frames in nn/layers.py and nn/kernels.py, outermost
        first: the site a backend op (or the refresh it asks for) is called
        from."""
        return " > ".join(
            f"{Path(f.filename).name}:{f.lineno} {f.name}"
            for f in traceback.extract_stack()
            if f.filename.replace("\\", "/").endswith(cls.SITE_FILES))

    def by_site(self) -> dict:
        """{site: {"count", "levels", "batches", "max_abs"}} in call order."""
        out: dict = {}
        for r in self.rows:
            s = out.setdefault(r["site"], {"count": 0, "levels": [],
                                           "batches": [], "max_abs": 0.0})
            s["count"] += 1
            for key, v in (("levels", r["level"]), ("batches", r["batch"])):
                if v not in s[key]:
                    s[key].append(v)
            s["max_abs"] = max(s["max_abs"], r["max_abs"])
        return out

    def lines(self) -> list:
        return [f"{s['count']:3d} x {site}: levels {s['levels']}, batch "
                f"{s['batches']}, max |slot| {s['max_abs']:.4g}"
                for site, s in self.by_site().items()]


def bootstrap_phase(torch, timer, same) -> dict:
    """Phase 6: the bootstrap path at bench.py's composite bootstrap shape.
    Returns (its results, the context, keys, Bootstrapper, ciphertext and
    launches per bootstrap that phases 10 and 11 reuse)."""
    from fhe_gpt2_tpu_torch.boot.bootstrap import Bootstrapper, \
        evalmod_cache_path, make_evalmod, mod_raise
    from fhe_gpt2_tpu_torch.core import _cuda
    from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
    from fhe_gpt2_tpu_torch.core.evaluator import Ciphertext, Decryptor, \
        Encryptor, Evaluator
    from fhe_gpt2_tpu_torch.core.keys import GaloisKeys, KeyGenerator, \
        KSwitchKey
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = CkksParams.create_composite(
        logn=15, num_levels=NUM_LEVELS, log_scale=50, log_q0=55,
        log_special=31, num_special=8, hamming_weight=192,
        sparse_slots=BOOT_SLOTS)
    ctx = CkksContext(params)
    kg = KeyGenerator(ctx, seed=1)
    ev = Evaluator(ctx, relin_key=kg.relin_key())
    enc = Encryptor(ctx, secret=kg.secret, seed=2)
    dec = Decryptor(ctx, kg.secret)
    # No decryptor on the backend: nothing can fall back to a decrypt/
    # re-encrypt refresh.
    B = CkksBackend(ctx=ctx, ev=ev, enc=enc, dec=None, default_level=ctx.L)
    eps = params.scale / ctx.q0_float
    em_kw = dict(K=25, eps=max(eps * 1.05, 2 ** -5), degree=59,
                 arcsin_degree=3, prec_dps=80)
    cache = evalmod_cache_path(num_double=2, **em_kw)
    check(Path(cache).exists(), f"EvalMod coefficients missing: {cache}")
    boot = Bootstrapper(B, num_slots=BOOT_SLOTS, evalmod=make_evalmod(**em_kw))
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    steps = boot.required_steps()
    ev.galois_keys = kg.galois_keys(steps, conjugate=True)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    log(f"bootstrap: logN=15, {ctx.L} limbs (base {ctx.base_limbs}), "
        f"k={ctx.k_sp}, {ctx.num_digits(ctx.L)} digits, {BOOT_SLOTS} slots; "
        f"build+plan {plan_s:.1f} s, keygen {keygen_s:.1f} s "
        f"({len(ev.galois_keys.keys)} Galois keys incl. conjugation)")

    z = np.random.default_rng(11).uniform(-1, 1, BOOT_SLOTS)
    ct = enc.encrypt(ev.make_plain(z, params.scale, ctx.base_limbs))
    # The counted run: launch counts zeroed just before, read just after.
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    out = boot.bootstrap(ct)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first_launches = dict(_cuda.LAUNCHES)
    back = np.real(dec.decrypt(out, num_slots=BOOT_SLOTS))
    check(back.shape == z.shape and np.isfinite(back).all(),
          "bootstrap: bad output")
    err = np.abs(back - z)
    log(f"bootstrap: level {ct.level} -> {out.level}, mean abs err "
        f"{err.mean():.3e} (bound {ERR_BOUND_BOOT}), max {err.max():.3e}; "
        f"first run {first_s:.2f} s (mask encoding included); launches "
        f"{first_launches}")
    check(err.mean() < ERR_BOUND_BOOT, f"bootstrap mean error {err.mean()}")
    check(out.level >= ctx.base_limbs + 2 * ctx.rescale_limbs,
          f"bootstrap output level {out.level}")
    for name in REPLACES:
        check(first_launches[name] > 0,
              f"kernel {name} not launched by the bootstrap")

    # The card against the plain route: ModRaise, one hoisted_rotations_ext
    # set (the first CtS plan's baby steps) and one rotate_hoisted set, on
    # a CPU copy of the context and keys.
    t0 = time.perf_counter()
    babies = list(boot.cts_plans[0].baby_amounts)
    cctx = CkksContext(params, device="cpu")
    cev = Evaluator(cctx, galois_keys=GaloisKeys(keys={
        e: KSwitchKey(data=k.data.cpu()) for e, k in ev.galois_keys.keys.items()
        if e in {ctx.galois_elt_from_step(s) for s in babies if s}}))
    base = boot._normalize_entry(ct)
    raised = mod_raise(ctx, base)
    check(torch.equal(raised.data.cpu(), mod_raise(
        cctx, Ciphertext(base.data.cpu(), base.scale)).data),
        "ModRaise on the card != the CPU route")
    [x] = dict(boot.stages())["prep"]([base])
    xc = Ciphertext(x.data.cpu(), x.scale)
    for what, fn in (
            ("hoisted_rotations_ext",
             lambda e, c: e.hoisted_rotations_ext(c, babies)),
            ("rotate_hoisted",
             lambda e, c: [v.data for v in e.rotate_hoisted(c, babies)])):
        got, want = fn(ev, x), fn(cev, xc)
        check(len(got) == len(want) and all(
            torch.equal(g.cpu(), w) for g, w in zip(got, want)),
            f"{what} on the card != the CPU route")
    equal_s = time.perf_counter() - t0
    log(f"bootstrap: ModRaise [2,{ctx.L},N], hoisted_rotations_ext and "
        f"rotate_hoisted (steps {babies}) at level {x.level} torch.equal to "
        f"the CPU route ({equal_s:.1f} s)")
    del cctx, cev, xc

    # Every kernel against its plain version at each shape the bootstrap
    # gives it: one more bootstrap, each new shape also run plain.
    t0 = time.perf_counter()
    shapes = hold_path_to_plain(lambda: boot.bootstrap(ct), same)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    top_key = (2, ctx.num_digits(ctx.L), ctx.L + ctx.k_sp, ctx.n)
    check(any(s[2] == top_key for s in shapes["keyswitch"]),
          f"no key switch at the top level's key shape {top_key}")
    check(any(len(s[0]) >= 3 for s in shapes["keyswitch"]),
          "no stacked key switch")
    check(any(s[3] == 2 and len(s[0]) >= 4 for s in shapes["moddown"]),
          "no stacked pair rescale")
    log(f"bootstrap: every kernel torch.equal to its plain version at each "
        f"shape of the path ({plain_s:.1f} s): "
        + ", ".join(f"{k} {len(v)} shapes" for k, v in shapes.items()))
    log("  key switch c / key: " + ", ".join(
        f"{list(s[0][:-1])}/{list(s[2][1:3])}" for s in shapes["keyswitch"]))
    log("  mod-down x / k: " + ", ".join(
        f"{list(s[0][:-1])}/{s[3]}" for s in shapes["moddown"]))

    # Timed runs: one warm-up, then the median of 3 by CUDA events.
    boot.bootstrap(ct)
    runs = []
    for _ in range(3):
        runs.append(timer(lambda: boot.bootstrap(ct), iters=1, warmup=0))
    boot_ms = float(np.median(runs))
    torch.cuda.synchronize()
    _cuda.reset_launches()
    boot.bootstrap(ct)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    # Per stage, as bootstrap() runs them: wall ms of one call, then the
    # device ms of the same call from the profiler.
    stage_ms: dict = {}
    stage_device_ms: dict = {}
    xs = [boot._normalize_entry(ct)]
    for name, fn in boot.stages():
        t0 = time.perf_counter()
        ys = fn(xs)
        torch.cuda.synchronize()
        stage_ms[name] = (time.perf_counter() - t0) * 1e3
        stage_device_ms[name] = profile_chain(
            torch, lambda fn=fn, xs=xs: fn(xs), reps=1)["device_ms"]
        xs = ys
    prof = profile_chain(torch, lambda: boot.bootstrap(ct), reps=1)
    prof["idle_share"] = 1.0 - prof["device_ms"] / boot_ms
    peak = torch.cuda.max_memory_allocated()
    log(f"bootstrap: {boot_ms / 1e3:.3f} s per bootstrap (CUDA events, "
        f"median of {[round(r, 1) for r in runs]} ms); device time "
        f"{prof['device_ms']:.1f} ms (device idle "
        f"{100 * prof['idle_share']:.1f}%), {prof['launches']:.0f} device "
        f"kernels per bootstrap; launches per bootstrap {launches}; peak "
        f"memory {peak / 2 ** 30:.2f} GiB")
    log("  per stage, wall ms / device ms: " + ", ".join(
        f"{k} {v:.1f} / {stage_device_ms[k]:.1f}"
        for k, v in stage_ms.items()))
    for name, kms, cnt in prof["top"]:
        log(f"  {kms:.3f} ms  x{cnt:.0f}  {name}")
    return {"limbs": ctx.L, "slots": BOOT_SLOTS, "plan_s": plan_s,
            "keygen_s": keygen_s, "galois_keys": len(ev.galois_keys.keys),
            "first_s": first_s, "ms_runs": runs, "ms": boot_ms,
            "stage_ms": stage_ms, "stage_device_ms": stage_device_ms,
            "mean_abs_err": float(err.mean()), "max_abs_err": float(err.max()),
            "level_in": ct.level, "level_out": out.level,
            "launches_first": first_launches, "launches": launches,
            "profile": prof, "peak_bytes": peak, "equal_s": equal_s,
            "path_shapes": {k: len(v) for k, v in shapes.items()},
            "path_plain_s": plain_s}, dict(ctx=ctx, ev=ev, enc=enc, dec=dec,
                                          boot=boot, ct=ct, z=z,
                                          launches=launches)


def key_bytes(ev) -> int:
    """Bytes of an evaluator's relinearization and Galois key rows."""
    return sum(k.data.numel() * k.data.element_size()
               for k in [ev.relin_key, *ev.galois_keys.keys.values()])


def mesh_phase(torch, timer, same, kern, unit, boot_state,
               devices=MESH_DEVICES) -> dict:
    """Phase 10: the (data, limb) mesh on phase 3's chain (unit: its ctx,
    ev with its keys, enc) and phase 6's bootstrap (boot_state), each on a
    data=2 x limb=2 mesh of `devices`; then, where there are two cards, a
    limb axis over both. Adds the row-block key switch's times to
    kern["keyswitch"]."""
    from fhe_gpt2_tpu_torch.core import _cuda, tks
    from fhe_gpt2_tpu_torch.core.evaluator import Ciphertext, stack_cts
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
    from fhe_gpt2_tpu_torch.parallel.mesh import MeshEvaluator, \
        gather_ciphertext, make_mesh, shard_ciphertext

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    out: dict = {"devices": [str(d) for d in devices]}

    # (a) The unit op on phase 3's chain.
    ctx, ev, enc = unit["ctx"], unit["ev"], unit["enc"]
    L, n = NUM_LEVELS, ctx.n
    mesh = make_mesh(2, 2, devices)
    t0 = time.perf_counter()
    mev = MeshEvaluator(mesh, ctx, relin_key=ev.relin_key,
                        galois_keys=ev.galois_keys)
    torch.cuda.synchronize()
    out["key_slice_s"] = time.perf_counter() - t0
    zs = np.random.default_rng(21).uniform(-1, 1, (2, ctx.params.slots))
    ct = stack_cts([enc.encrypt(ev.make_plain(z, ctx.params.scale, L))
                    for z in zs])
    names = ("mul_relin", "rescale", "rotate5", "conjugate")

    def step(e, c):
        m = e.multiply(c, c)
        return [m, e.rescale(m), e.rotate(c, 5), e.conjugate(c)]

    def held_equal(outs, want, what):
        for name, got, w in zip(names, outs, want):
            g = gather_ciphertext(got)
            check(g.level == w.level and g.scale == w.scale
                  and torch.equal(g.data, w.data),
                  f"mesh {what} {name}: != the single-device Evaluator")

    want = step(ev, ct)
    sct = shard_ciphertext(ct, mesh)
    mev.run(step, sct)                 # first run: tables and kernels
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    outs = mev.run(step, sct)
    torch.cuda.synchronize()
    out["step_s"] = time.perf_counter() - t0
    out["step_launches"] = launches = dict(_cuda.LAUNCHES)
    held_equal(outs, want, "(a)")
    for name in REPLACES:
        check(launches[name] > 0, f"kernel {name} not launched by the mesh")
    single_bytes = key_bytes(ev)
    out["key_bytes"] = [key_bytes(e) for e in mev.evaluators]
    out["single_key_bytes"] = single_bytes
    rows = [len(e.ctx.key_limbs(ctx.L)) for e in mev.evaluators]
    log(f"mesh (a): data=2 x limb=2 on {devices}, logN={ctx.logn}, level "
        f"{L}, batch 2: multiply+relin, rescale, rotate 5, conjugate torch.equal to the "
        f"single-device Evaluator; {out['step_s']:.3f} s; launches "
        f"{launches}; key slicing {out['key_slice_s']:.1f} s")
    log("  key bytes per position (rows of " + f"{ctx.L + ctx.k_sp}): "
        + ", ".join(f"{b / 2 ** 20:.1f} MiB ({r} rows, {b / single_bytes:.3f})"
                    for b, r in zip(out["key_bytes"], rows))
        + f"; single device {single_bytes / 2 ** 20:.1f} MiB")
    t0 = time.perf_counter()
    shapes = hold_path_to_plain(lambda: mev.run(step, sct), same)
    torch.cuda.synchronize()
    out["path_plain_s"] = time.perf_counter() - t0
    out["path_shapes"] = {k: len(v) for k, v in shapes.items()}
    block = [s for s in shapes["keyswitch"] if s[2][2] < L + ctx.k_sp]
    check(block, "no key switch on a row block")
    log(f"mesh (a): every kernel torch.equal to its plain version at each "
        f"shape of the mesh step ({out['path_plain_s']:.1f} s): "
        + ", ".join(f"{k} {len(v)} shapes" for k, v in shapes.items())
        + "; key switch c / key rows: " + ", ".join(
            f"{list(s[0][:-1])}/{s[2][2]}" for s in shapes["keyswitch"]))

    # The key switch on position 0's key rows at level L (the row map).
    e0 = mev.evaluators[0]
    vft = e0.ctx.fused_ks_tables(L)
    vrows = e0.ctx.key_limbs(L)
    vkey = e0.relin_key.sliced(vrows, vft.D)
    lt, kt = ctx.tables(L), e0.ctx.tables(vrows)
    c = ct.data[1, 0].contiguous()          # c1 of the first ciphertext
    J = len(vrows)
    rb = {"rows": J,
          "ms": timer(lambda: tks.fused_switch_key(c, vkey, lt, kt, vft),
                      iters=20),
          "plain_ms": timer(lambda: tks.switch_key_plain(c, vkey, lt, kt,
                                                         vft), iters=3)}
    same("keyswitch", tks.fused_switch_key(c, vkey, lt, kt, vft),
         tks.switch_key_plain(c, vkey, lt, kt, vft), f"row block {J}")
    b_i, m_i = ntt_cost(L, L, n)                         # iNTT of c
    b_f, m_f = ntt_cost(vft.D * J, J, n)                 # NTT of t
    words_io = L * n + 2 * vft.D * J * n + 2 * J * n     # c, key rows, out
    muls = (m_i + m_f + vft.D * vft.A * n * SHOUP_MULS
            + (vft.D * J * vft.A + 2 * vft.D * J) * n * BARRETT_MULS)
    rb["bound_ms"], rb["bound_by"] = bound(
        4.0 * words_io + (b_i - 8.0 * L * n) + (b_f - 8.0 * vft.D * J * n),
        muls)
    kern["keyswitch"]["row_block"] = out["row_block"] = rb
    log(f"mesh (a): key switch on {J} of {L + ctx.k_sp} key rows: "
        f"{rb['ms']:.4f} ms (plain {rb['plain_ms']:.3f} ms, bound "
        f"{rb['bound_ms']:.4f} ms by {rb['bound_by']})")
    del mev, outs, shapes

    # (b) Phase 6's bootstrap of a batch of 2.
    bctx, bev, boot = boot_state["ctx"], boot_state["ev"], boot_state["boot"]
    benc, bdec = boot_state["enc"], boot_state["dec"]
    z2 = np.random.default_rng(12).uniform(-1, 1, BOOT_SLOTS)
    bct = stack_cts([boot_state["ct"], benc.encrypt(bev.make_plain(
        z2, bctx.params.scale, bctx.base_limbs))])
    t0 = time.perf_counter()
    bmev = MeshEvaluator(make_mesh(2, 2, devices), bctx,
                         relin_key=bev.relin_key, galois_keys=bev.galois_keys)
    torch.cuda.synchronize()
    out["boot_key_slice_s"] = time.perf_counter() - t0
    boots = [boot.on(CkksBackend(ctx=e.ctx, ev=e, default_level=bctx.L))
             for e in bmev.evaluators]
    bsct = shard_ciphertext(bct, bmev.mesh)

    def mesh_boot():
        return bmev.run(lambda b, x: b.bootstrap(x), bsct, on=boots)

    bwant = boot.bootstrap(bct)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = gather_ciphertext(mesh_boot())
    torch.cuda.synchronize()
    out["boot_first_s"] = time.perf_counter() - t0
    check(got.level == bwant.level and got.scale == bwant.scale
          and torch.equal(got.data, bwant.data),
          "mesh bootstrap != the single-device bootstrap")
    errs = []
    for i, z in enumerate((boot_state["z"], z2)):
        back = np.real(bdec.decrypt(Ciphertext(got.data[:, i], got.scale),
                                    num_slots=BOOT_SLOTS))
        check(back.shape == z.shape and np.isfinite(back).all(),
              "mesh bootstrap: bad output")
        errs.append(float(np.abs(back - z).mean()))
        check(errs[-1] < ERR_BOUND_BOOT, f"mesh bootstrap mean error {errs}")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    mesh_boot()
    torch.cuda.synchronize()
    out["boot_launches"] = blaunch = dict(_cuda.LAUNCHES)
    for name in REPLACES:
        check(blaunch[name] > 0,
              f"kernel {name} not launched by the mesh bootstrap")
    runs = [timer(mesh_boot, iters=1, warmup=0) for _ in range(3)]
    single = [timer(lambda: boot.bootstrap(bct), iters=1, warmup=0)
              for _ in range(3)]
    out.update(boot_ms_runs=runs, boot_ms=float(np.median(runs)),
               single_boot_ms_runs=single,
               single_boot_ms=float(np.median(single)),
               boot_mean_abs_err=errs,
               boot_key_bytes=[key_bytes(e) for e in bmev.evaluators],
               boot_single_key_bytes=key_bytes(bev))
    brows = [len(e.ctx.key_limbs(bctx.L)) for e in bmev.evaluators]
    log(f"mesh (b): bootstrap of a batch of 2 on data=2 x limb=2, "
        f"logN={bctx.logn}, {bctx.L} limbs: torch.equal to the single-device bootstrap, mean "
        f"abs err {errs[0]:.3e}, {errs[1]:.3e} (bound {ERR_BOUND_BOOT}); "
        f"first run {out['boot_first_s']:.2f} s; {out['boot_ms'] / 1e3:.3f} s "
        f"per mesh bootstrap (CUDA events, median of "
        f"{[round(r, 1) for r in runs]} ms) against "
        f"{out['single_boot_ms'] / 1e3:.3f} s single-device (median of "
        f"{[round(r, 1) for r in single]} ms); launches per mesh bootstrap "
        f"{blaunch}")
    log("  key bytes per position (rows of "
        + f"{bctx.L + bctx.k_sp}): "
        + ", ".join(f"{b / 2 ** 30:.2f} GiB ({r} rows)"
                    for b, r in zip(out["boot_key_bytes"], brows))
        + f"; single device {out['boot_single_key_bytes'] / 2 ** 30:.2f} GiB;"
        f" key slicing {out['boot_key_slice_s']:.1f} s")
    del bmev, boots, got, bwant

    # (c) A limb axis over two cards.
    if torch.cuda.device_count() >= 2:
        two = make_mesh(1, 2, ["cuda:0", "cuda:1"])
        tmev = MeshEvaluator(two, ctx, relin_key=ev.relin_key,
                             galois_keys=ev.galois_keys)
        held_equal(tmev.run(step, shard_ciphertext(ct, two)), want, "(c)")
        out["two_cards"] = True
        log("mesh (c): limb=2 over cuda:0 and cuda:1: torch.equal to the "
            "single-device Evaluator")
        del tmev
    else:
        out["two_cards"] = False
        log(f"mesh (c): {torch.cuda.device_count()} card(s) on this machine: "
            f"the two-card limb axis was not run")
    torch.cuda.synchronize()
    out["peak_bytes"] = peak = torch.cuda.max_memory_allocated()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh: peak memory {peak / 2 ** 30:.2f} GiB; phase "
        f"{out['phase_s']:.1f} s")
    return out


def resnet_plain(depth: int = RESNET_DEPTH, h: int = 32,
                 slots: int = RESNET_SLOTS) -> dict:
    """The "resnet" phase's model on the host: ResNet-`depth` at full width
    (16/32/64 channels, a 3x32x32 image, 16384 slots) with synthetic
    reference-format weights (numpy seed 0, block convs at 0.24/sqrt(c_in))
    and the image of ``run_resnet --seed 0``; its plans (ReLU bound 10, sign
    ``dp_schedule(2^-10, 2^-8)``), the float oracle's logits, the plain
    (slot-exact, no crypto) logits and the largest normalized pre-ReLU input
    of the plain run, which must stay inside the sign's domain."""
    from fhe_gpt2_tpu_torch.approx.minimax import dp_schedule
    from fhe_gpt2_tpu_torch.cnn import resnet as R
    from fhe_gpt2_tpu_torch.nn import kernels as K
    from fhe_gpt2_tpu_torch.nn.backend import PlainBackend

    weights = R.synthetic_weights(np.random.default_rng(0), depth,
                                  block_scale=0.24)
    img = np.random.default_rng(0).uniform(-1, 1, (3, h, h))
    t0 = time.perf_counter()
    sign = K.SignPlans.from_composite(dp_schedule(2.0 ** -10, 2.0 ** -8))
    rp = R.build_resnet_plans(weights, depth, slots, h=h, relu_bound=10.0,
                              sign=sign)
    plans_s = time.perf_counter() - t0
    pre_relu = []
    relu = R._relu

    def watched_relu(B, xs, rp_):
        pre_relu.append(max(float(np.abs(x).max()) for x in xs))
        return relu(B, xs, rp_)

    R._relu = watched_relu
    try:
        out = R.forward(PlainBackend(slots), R.pack_input(rp, img), rp,
                        boot_between=False)
    finally:
        R._relu = relu
    def masks(*plans):
        return sum(len(v) for p in plans if p is not None
                   for group in p.groups.values() for v in group.values())

    seg_masks = ([masks(rp.stem[0])]
                 + [masks(b["plan1"], b["plan2"], b["short"])
                    for b in rp.blocks] + [masks(rp.pool, rp.fc)])
    return {"rp": rp, "img": img, "plans_s": plans_s, "masks": seg_masks,
            "want": R.forward_float(weights, depth, img),
            "plain": R.logits_from_slots(rp, out[0]),
            "pre_relu_max": max(pre_relu), "relus": len(pre_relu)}


class WireLog:
    """Records every serialize call of the port (``net/serialize.py``'s
    dump_* and load_* functions) in the order they run, with its seconds,
    the raw bytes (header and uncompressed payload) and the wire bytes of
    the blob it writes or reads: the client's and the server's halves of an
    upload or a request, in one process."""

    def __init__(self):
        from fhe_gpt2_tpu_torch.net import serialize as S
        self.S = S
        self.rows: list = []
        self._saved = {}
        for name in dir(S):
            if name.startswith(("dump_", "load_")):
                self._saved[name] = getattr(S, name)
                setattr(S, name, self._wrap(name, self._saved[name]))

    def _wrap(self, name, fn):
        import struct

        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            dt = time.perf_counter() - t0
            blob = out if name.startswith("dump_") else args[0]
            hlen, clen, rlen = struct.unpack("<III", blob[4:16])
            self.rows.append({"fn": name, "s": dt, "raw": 16 + hlen + rlen,
                              "wire": len(blob)})
            return out
        return call

    def restore(self) -> None:
        for name, fn in self._saved.items():
            setattr(self.S, name, fn)

    def take(self) -> list:
        rows, self.rows = self.rows, []
        return rows

    @staticmethod
    def sums(rows, prefix: str) -> dict:
        """Calls, seconds, raw and wire bytes of the rows whose function
        starts with prefix."""
        sel = [r for r in rows if r["fn"].startswith(prefix)]
        return {"calls": len(sel), "s": sum(r["s"] for r in sel),
                "raw": sum(r["raw"] for r in sel),
                "wire": sum(r["wire"] for r in sel)}


def serve(model_fn, device=None):
    """(server, client) of the secure-inference service over loopback gRPC;
    the server is started and listens on a free port."""
    from fhe_gpt2_tpu_torch.net.service import SecureInferenceClient, \
        SecureInferenceServer
    server = SecureInferenceServer(model_fn=model_fn, port=0,
                                   device=device).start()
    return server, SecureInferenceClient(f"localhost:{server.port}",
                                         device=device)


def native_check() -> dict:
    """The native runtime on this host: built, loaded, and its encoder
    equal word for word to the numpy route at logN=15, Δ = 2^54 (uniform
    and 0/1 slot vectors)."""
    from fhe_gpt2_tpu_torch.core import embedding
    from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
    from fhe_gpt2_tpu_torch.runtime import native
    t0 = time.perf_counter()
    path = native.build()
    build_s = time.perf_counter() - t0
    check(native.available(), f"native runtime {path} does not load")
    ctx = CkksContext(CkksParams.create_composite(
        logn=15, num_levels=2, log_scale=54, log_q0=59, num_special=2,
        hamming_weight=16), device="cpu")
    rng = np.random.default_rng(4)
    for what, z in (("uniform", rng.uniform(-1, 1, ctx.params.slots)),
                    ("0/1", rng.integers(0, 2, ctx.params.slots) * 1.0)):
        got = embedding.encode_to_coeffs(z, ctx.params.scale, ctx)
        available = native.available
        native.available = lambda: False
        try:
            want = embedding.encode_to_coeffs(z, ctx.params.scale, ctx)
        finally:
            native.available = available
        check(np.array_equal(got, want), f"native encode ({what}) != the "
              f"numpy route in {np.count_nonzero(got != want)} coefficients")
    log(f"native runtime: {path} (build {build_s:.1f} s); its encoder equal "
        f"to the numpy route at logN=15, Δ=2^54")
    return {"path": str(path), "build_s": build_s}


def resnet_phase(torch, timer, same) -> dict:
    """Phase 7: one encrypted image through ResNet-RESNET_DEPTH with real
    bootstraps on the 80-limb composite chain, served by the secure-
    inference service (see the module docstring)."""
    from fhe_gpt2_tpu_torch import run_resnet
    from fhe_gpt2_tpu_torch.cnn import resnet as R
    from fhe_gpt2_tpu_torch.core import _cuda
    from fhe_gpt2_tpu_torch.core.context import CkksContext
    from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Encryptor, \
        Evaluator
    from fhe_gpt2_tpu_torch.core.keys import KeyGenerator, digit_steps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    nat = native_check()
    net = resnet_plain()
    rp, img = net["rp"], net["img"]
    n_relus = 1 + 2 * len(rp.blocks)
    log(f"resnet: ResNet-{rp.depth} at full width, {len(rp.blocks)} "
        f"blocks, {rp.slots} slots; plans {net['plans_s']:.1f} s; plain "
        f"run: max normalized pre-ReLU input {net['pre_relu_max']:.4f} over "
        f"{net['relus']} ReLUs (bound 0.9), argmax {np.argmax(net['plain'])}"
        f" (float oracle {np.argmax(net['want'])}), max |plain - float| "
        f"{np.abs(net['plain'] - net['want']).max():.2e}")
    log(f"resnet: {sum(net['masks'])} masks per image, by segment (stem, "
        f"blocks, tail): {net['masks']}")
    check(rp.relu_need == 16, f"relu_need {rp.relu_need}, the schedule "
          f"assumes 16")
    check(net["relus"] == n_relus and net["pre_relu_max"] < 0.9,
          f"plain run: pre-ReLU max {net['pre_relu_max']} over "
          f"{net['relus']} ReLUs")
    check(np.argmax(net["plain"]) == np.argmax(net["want"]),
          "plain argmax != the float oracle's")

    # The client: the key owner's half of run_resnet.build_session.
    a = run_resnet.parse_args(RESNET_ARGS)
    device = run_resnet.device_of(a)
    t0 = time.perf_counter()
    ctx = CkksContext(run_resnet.make_params(a), device=device)
    kg = KeyGenerator(ctx, seed=1)
    relin = kg.relin_key()
    enc = Encryptor(ctx, secret=kg.secret, seed=2)
    dec = Decryptor(ctx, kg.secret)
    gk = kg.galois_keys(steps=digit_steps(ctx.params.slots, base=16),
                        conjugate=True)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    n_keys = len(gk.keys)
    check(ctx.L == 80 and ctx.k_sp == 16 and ctx.num_digits(ctx.L) == 5
          and len(ctx.key_limbs(ctx.L)) == 96,
          f"chain: {ctx.L} limbs, k={ctx.k_sp}")
    log(f"resnet: logN={ctx.logn}, {ctx.L} limbs (base {ctx.base_limbs}), "
        f"k={ctx.k_sp}, {ctx.num_digits(ctx.L)} digits, "
        f"{len(ctx.key_limbs(ctx.L))} key limbs; client keygen "
        f"{keygen_s:.1f} s ({n_keys} Galois keys incl. conjugation)")

    # The server: its context, evaluator and backend come from the uploaded
    # frames alone. On its first call model_fn builds the Bootstrapper from
    # the uploaded keys; it counts and times every refresh the forward asks
    # for (the one before each ReLU, or an auto-refresh at the level floor).
    served = {"boots": [], "boot_s": [], "calls": 0, "mask_bytes": {}}
    where = {"planned": False, "segment": None, "boot": False}

    def model_fn(B, ct):
        served["calls"] += 1
        if B.boot is None:
            check(B.enc is None and B.dec is None,
                  "the server's backend holds an encryptor or a decryptor")
            t0 = time.perf_counter()
            B.min_level_headroom = a.headroom
            B.boot = run_resnet.make_bootstrapper(a, B)
            served["boot_plan_s"] = time.perf_counter() - t0
            inner_boot, inner_maybe = B.bootstrap, B.maybe_bootstrap

            def counting_boot(v, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                where["boot"] = True
                try:
                    out = inner_boot(v, **kw)
                finally:
                    where["boot"] = False
                torch.cuda.synchronize()
                served["boot_s"].append(time.perf_counter() - t0)
                served["boots"].append((where["planned"], where["segment"],
                                        v.level, out.level))
                return out

            def planned_boot(v, need):
                where["planned"] = True
                try:
                    return inner_maybe(v, need)
                finally:
                    where["planned"] = False

            B.bootstrap, B.maybe_bootstrap = counting_boot, planned_boot

            # The bytes of every mask the segments encode (the bootstraps'
            # own aside): what a sealed segment would hold resident.
            def sized(encode):
                def f(*args):
                    pt = encode(*args)
                    if not where["boot"]:
                        mb = served["mask_bytes"]
                        mb[where["segment"]] = (mb.get(where["segment"], 0)
                                                + pt.data.numel()
                                                * pt.data.element_size())
                    return pt
                return f
            B.ev.make_plain = sized(B.ev.make_plain)
            B.ev.make_plain_ext = sized(B.ev.make_plain_ext)
        segs = R.forward_segments(B, rp)
        xs = [ct]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg_s = []
        for i, seg in enumerate(segs):
            where["segment"] = i
            ts = time.perf_counter()
            xs = seg(xs)
            if i == 0:
                served["stem_out"] = xs
            torch.cuda.synchronize()
            seg_s.append(time.perf_counter() - ts)
        served.update(image_s=time.perf_counter() - t0, seg_s=seg_s,
                      segs=segs, B=B)
        return xs[0]

    wire = WireLog()
    try:
        server, client = serve(model_fn, device)
        try:
            import grpc
            way = f"loopback gRPC, grpcio {grpc.__version__}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            client.init_session_stream(ctx.params, relin_key=relin,
                                       galois_keys=gk)
            torch.cuda.synchronize()
            upload_s = time.perf_counter() - t0
            up = wire.take()
            del relin, gk               # the client keeps only its secret
            gc.collect()
            torch.cuda.empty_cache()
            ct = enc.encrypt(Evaluator(ctx).make_plain(
                R.pack_input(rp, img)[0], ctx.params.scale,
                run_resnet.input_level(a, ctx)))
            wire.take()
            # The counted run: launch counts zeroed just before the request,
            # read just after its answer has arrived.
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            out = client.evaluate(ct)
            torch.cuda.synchronize()
            request_s = time.perf_counter() - t0
            launches = dict(_cuda.LAUNCHES)
            req = wire.take()
        finally:
            server.stop()
    finally:
        wire.restore()
    ups = {k: WireLog.sums(up, k) for k in ("dump_", "load_")}
    frames = ups["dump_"]["calls"]
    # The client serializes frames on a thread per core, ahead of the
    # stream, while the server loads the ones that arrived: the seconds of
    # each side are summed over their frames (thread time, which overlaps).
    check(frames == 2 + n_keys and ups["load_"]["calls"] == frames,
          f"upload: {frames} frames written, {ups['load_']['calls']} read")
    sB = served["B"]
    check(served["calls"] == 1 and sB.enc is None and sB.dec is None
          and len(sB.ev.galois_keys.keys) == n_keys
          and sB.ev.relin_key is not None,
          "the server's session is not the uploaded keys alone")
    reqs = {k: WireLog.sums(req, k) for k in ("dump_ciphertext",
                                              "load_ciphertext")}
    check(reqs["dump_ciphertext"]["calls"] == 2
          and reqs["load_ciphertext"]["calls"] == 2,
          f"request: {len(req)} serialize calls")
    response_bytes = req[-1]["wire"]
    log(f"resnet served ({way}): upload {frames} frames (params, relin, "
        f"{n_keys} Galois), {ups['dump_']['raw'] / 1e9:.3f} GB raw, "
        f"{ups['dump_']['wire'] / 1e9:.3f} GB on the wire, "
        f"{upload_s:.1f} s: client serialization {ups['dump_']['s']:.1f} s "
        f"summed over its frames (on {os.cpu_count()} threads), server load "
        f"{ups['load_']['s']:.1f} s summed (overlapping both)")
    log(f"resnet served: request round trip {request_s:.1f} s, model_fn "
        f"{served['image_s']:.1f} s (+ Bootstrapper plans "
        f"{served['boot_plan_s']:.1f} s on the first call); request "
        f"{req[0]['wire'] / 1e6:.2f} MB, response {response_bytes / 1e6:.2f}"
        f" MB on the wire; serialize s {[round(r['s'], 3) for r in req]}")

    image_s, seg_s = served["image_s"], served["seg_s"]
    boot_s = list(served["boot_s"])
    image_boots = list(served["boots"])
    got = R.logits_from_slots(rp, np.real(dec.decrypt(out)))
    err = float(np.abs(got - net["plain"]).max())
    post = ctx.base_limbs + (RESNET_LEVELS - 21) * ctx.rescale_limbs
    n_cts = max([1] + [b["lout"].n_cts for b in rp.blocks])
    log(f"resnet: {image_s:.1f} s per image (1 image, the first: mask "
        f"encodings included); segments (s): "
        + ", ".join(f"{v:.1f}" for v in seg_s))
    log(f"resnet: {len(image_boots)} bootstraps per image ({sum(p for p, *_ in image_boots)}"
        f" before ReLUs, {n_relus} ReLUs, {n_cts} cts at most), first "
        f"{boot_s[0]:.2f} s, steady {np.median(boot_s[1:]):.3f} s (median; min "
        f"{min(boot_s[1:]):.3f}, max {max(boot_s[1:]):.3f}); levels in -> "
        f"out: {sorted({(i, o) for *_, i, o in image_boots})}")
    log(f"resnet: logits argmax {np.argmax(got)} (plain "
        f"{np.argmax(net['plain'])}, float oracle {np.argmax(net['want'])}),"
        f" max |encrypted - plain| {err:.3e} (bound {ERR_BOUND_RESNET}); "
        f"launches per request {launches}")
    check(got.shape == net["plain"].shape and np.isfinite(got).all(),
          "resnet: bad logits")
    check(np.argmax(got) == np.argmax(net["want"]) == np.argmax(net["plain"]),
          "resnet: encrypted argmax != the float oracle's or the plain run's")
    check(err < ERR_BOUND_RESNET, f"resnet: logit error {err}")
    check(all(o == post for *_, o in image_boots),
          f"resnet: a refresh left below level {post}: {image_boots}")
    check(len(image_boots) <= (n_relus + 1) * max(n_cts, 2),
          f"resnet: {len(image_boots)} bootstraps for {n_relus} ReLUs")
    check(all(p for p, *_ in image_boots),
          f"resnet: an auto-bootstrap inside a segment: {image_boots}")
    for name in REPLACES:
        check(launches[name] > 0, f"kernel {name} not launched by the ResNet")

    # The bootstraps took bootstrap_jitted: the first made each stage's
    # graph (warm pass and capture), the others replayed them.
    stage_progs = [p for c in sB.boot._staged_jit
                   for p in c.programs.values()]
    log(f"resnet: sealed bootstraps: first {boot_s[0]:.2f} s (warm passes "
        f"{sum(p.warm_s for p in stage_progs):.2f} s, captures "
        f"{sum(p.capture_s for p in stage_progs):.2f} s of "
        f"{len(stage_progs)} stage graphs), steady "
        f"{np.median(boot_s[1:]):.3f} s (median of {len(boot_s) - 1} "
        f"replayed)")
    # What sealing each segment would hold resident: its masks' bytes.
    free, total = torch.cuda.mem_get_info()
    mask_bytes = [served["mask_bytes"].get(i, 0) for i in range(len(seg_s))]
    log(f"resnet: mask bytes per segment (stem, blocks, tail), GiB: "
        + ", ".join(f"{b / 2 ** 30:.2f}" for b in mask_bytes)
        + f"; largest {max(mask_bytes) / 2 ** 30:.2f} GiB, all "
        f"{sum(mask_bytes) / 2 ** 30:.2f} GiB, against {free / 2 ** 30:.1f}"
        f" GiB free of {total / 2 ** 30:.1f} GiB on the card")

    # Every kernel against its plain version at each shape that one
    # residual block (conv, refresh, ReLU, conv, add, refresh, ReLU) and its
    # two bootstraps give it on the server's backend. A graph replay calls
    # no wrapper, so here, and for the block's profile, the two bootstraps
    # run eagerly.
    segs, stem_out = served["segs"], served["stem_out"]
    t0 = time.perf_counter()
    with eager_bootstraps(sB.boot):
        shapes = hold_path_to_plain(lambda: segs[1](stem_out), same)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    log(f"resnet: one block and its bootstraps, every kernel torch.equal to "
        f"its plain version at each shape ({plain_s:.1f} s): "
        + ", ".join(f"{k} {len(v)} shapes" for k, v in shapes.items()))
    log("  key switch c / key: " + ", ".join(
        f"{list(s[0][:-1])}/{list(s[2][1:3])}" for s in shapes["keyswitch"]))
    log("  mod-down x / k: " + ", ".join(
        f"{list(s[0][:-1])}/{s[3]}" for s in shapes["moddown"]))
    top = max(s[0][-2] for s in shapes["keyswitch"])
    check(any(s[2][1] == ctx.num_digits(top) == 5 and s[2][2] == top + 16
              for s in shapes["keyswitch"] if s[0][-2] == top),
          f"no 5-digit key switch at the top level {top}")
    check(any(s[3] == ctx.k_sp for s in shapes["moddown"]),
          f"no mod-down with k={ctx.k_sp}")
    check(any(s[3] == 2 for s in shapes["moddown"]), "no pair rescale")

    # One residual block: wall ms by CUDA events, device ms, kernels and the
    # idle share from torch.profiler.
    with eager_bootstraps(sB.boot):
        block_ms = timer(lambda: segs[1](stem_out), iters=1, warmup=0)
        prof = profile_chain(torch, lambda: segs[1](stem_out), reps=1)
    prof["ms"] = block_ms
    prof["idle_share"] = 1.0 - prof["device_ms"] / block_ms
    peak = torch.cuda.max_memory_allocated()
    total_s = time.perf_counter() - t_phase
    log(f"resnet: one residual block {block_ms:.1f} ms, device "
        f"{prof['device_ms']:.1f} ms (device idle "
        f"{100 * prof['idle_share']:.1f}%), {prof['launches']:.0f} device "
        f"kernels, port kernels {prof['port_launches']}; peak memory "
        f"{peak / 2 ** 30:.2f} GiB; phase {total_s:.1f} s")
    for name, kms, cnt in prof["top"]:
        log(f"  {kms:.3f} ms  x{cnt:.0f}  {name}")
    return {"depth": rp.depth, "limbs": ctx.L, "plans_s": net["plans_s"],
            "native": nat, "transport": way, "keygen_s": keygen_s,
            "galois_keys": n_keys, "upload_frames": frames,
            "upload_raw_bytes": ups["dump_"]["raw"],
            "upload_wire_bytes": ups["dump_"]["wire"], "upload_s": upload_s,
            "upload_serialize_s": ups["dump_"]["s"],
            "upload_load_s": ups["load_"]["s"],
            "request_s": request_s, "request_bytes": req[0]["wire"],
            "response_bytes": response_bytes,
            "request_serialize_s": [r["s"] for r in req],
            "boot_plan_s": served["boot_plan_s"], "image_s": image_s,
            "segment_s": seg_s, "masks": net["masks"],
            "bootstraps": len(image_boots), "boot_s": boot_s,
            "boot_first_s": boot_s[0],
            "boot_steady_s": float(np.median(boot_s[1:])),
            "boot_capture_s": sum(p.capture_s for p in stage_progs),
            "mask_bytes": mask_bytes,
            "boots": image_boots, "logits": got.tolist(),
            "plain": net["plain"].tolist(), "want": net["want"].tolist(),
            "max_abs_err": err, "launches": launches,
            "path_shapes": {k: len(v) for k, v in shapes.items()},
            "path_plain_s": plain_s, "block_profile": prof,
            "peak_bytes": peak, "phase_s": total_s}


def pir_phase(torch) -> dict:
    """Phase 7b: private embedding lookup of GPT-2 small's synthetic wte
    (first PIR_ROWS rows, full width) served on the card, against the same
    service on the CPU (see the module docstring)."""
    from fhe_gpt2_tpu_torch.core import _cuda
    from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams
    from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Encryptor, \
        Evaluator
    from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
    from fhe_gpt2_tpu_torch.net.pir import EmbeddingPIRServer, make_query
    from fhe_gpt2_tpu_torch.nn.model import synthetic_weights
    from fhe_gpt2_tpu_torch.run_gpt2 import GPT2_POSITIONS, GPT2_VOCAB

    t_phase = time.perf_counter()
    wte = synthetic_weights(np.random.default_rng(0), 0, PIR_WIDTH, 12,
                            GPT2_VOCAB, GPT2_POSITIONS)[
                                "transformer.wte.weight"]
    table = wte[:PIR_ROWS]
    params = CkksParams.create(logn=PIR_LOGN, log_q0=29, log_scale=25,
                               num_levels=3, log_special=31, num_special=2,
                               hamming_weight=64)
    ctx = CkksContext(params)
    slots = ctx.params.slots
    check(slots == PIR_ROWS, f"{slots} slots for {PIR_ROWS} rows")
    t0 = time.perf_counter()
    srv = EmbeddingPIRServer(table, slots)
    plan_s = time.perf_counter() - t0
    kg = KeyGenerator(ctx, seed=1)
    relin = kg.relin_key()
    gk = kg.galois_keys(steps=srv.required_steps())
    enc = Encryptor(ctx, secret=kg.secret, seed=2)
    dec = Decryptor(ctx, kg.secret)
    ev = Evaluator(ctx)
    queries = [enc.encrypt(ev.make_plain(make_query(tok, PIR_ROWS, slots)[0],
                                         params.scale, ctx.L))
               for tok in PIR_TOKENS]
    answers = {}
    for device in ("cuda", "cpu"):
        server, client = serve(lambda B, ct: srv.answer(B, [ct]), device)
        try:
            client.init_session_stream(params, relin_key=relin,
                                       galois_keys=gk)
            if device == "cuda":
                torch.cuda.synchronize()
                _cuda.reset_launches()
            t0 = time.perf_counter()
            answers[device] = client.evaluate_stream(queries)
            if device == "cuda":
                torch.cuda.synchronize()
                launches = dict(_cuda.LAUNCHES)
            answers[device + "_s"] = time.perf_counter() - t0
        finally:
            server.stop()
    errs = []
    for tok, c, p in zip(PIR_TOKENS, answers["cuda"], answers["cpu"]):
        check(c.data.is_cuda and not p.data.is_cuda, "answers on the wrong "
              "devices")
        check(c.scale == p.scale and torch.equal(c.data.cpu(), p.data),
              f"PIR answer for token {tok}: the card's != the CPU route's")
        row = np.real(dec.decrypt(c))[:PIR_WIDTH]
        check(row.shape == (PIR_WIDTH,) and np.isfinite(row).all(),
              "PIR: bad answer")
        errs.append(float(np.abs(row - table[tok]).max()))
    log(f"pir: {PIR_ROWS} rows x {PIR_WIDTH} of GPT-2 small's synthetic wte, "
        f"logN={ctx.logn} ({slots} slots, one query ciphertext), "
        f"{len(srv.required_steps())} rotation keys, plan "
        f"{plan_s:.1f} s; tokens {PIR_TOKENS} through evaluate_stream: "
        f"card {answers['cuda_s']:.2f} s, CPU route {answers['cpu_s']:.2f} s "
        f"(answers torch.equal); max |row - table| {max(errs):.2e} (bound "
        f"{ERR_BOUND_PIR}); launches {launches}")
    check(max(errs) < ERR_BOUND_PIR, f"PIR error {errs}")
    for name in REPLACES:
        check(launches[name] > 0, f"kernel {name} not launched by the PIR")
    return {"rows": PIR_ROWS, "width": PIR_WIDTH, "logn": ctx.logn,
            "tokens": PIR_TOKENS, "keys": len(srv.required_steps()),
            "plan_s": plan_s, "card_s": answers["cuda_s"],
            "cpu_s": answers["cpu_s"], "max_abs_err": errs,
            "launches": launches, "phase_s": time.perf_counter() - t_phase}


def plan_masks(*plans) -> int:
    """Plaintext masks of BSGS plans (one encoding each at every level a
    plan runs at)."""
    return sum(len(v) for p in plans for group in p.groups.values()
               for v in group.values())


def gpt2_plain(args=None) -> dict:
    """The "gpt2" phase's model on the host, through run_gpt2's own
    functions (parse_args, load_model, plain_forward) with GPT2_ARGS: the
    synthetic weights, the token ids, the calibrated plans, the plain
    (slot-exact, no crypto) hidden state against the float oracle
    (max |error| and logits top-1 agreement), each LayerNorm's largest row
    Σz² over its Newton seed, and the masks of the block's matmuls."""
    from fhe_gpt2_tpu_torch import run_gpt2
    from fhe_gpt2_tpu_torch.nn import model as M

    a = run_gpt2.parse_args(GPT2_ARGS if args is None else args)
    t0 = time.perf_counter()
    m = run_gpt2.load_model(a)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = run_gpt2.plain_forward(m)
    plain_s = time.perf_counter() - t0
    sums = M.ln_input_sums(m.weights, m.ids, a.layers, a.heads)
    lns = [ln for bp in m.plans.blocks for ln in (bp.ln1, bp.ln2)]
    rows = [r for pair in sums[:-1] for r in pair] + [sums[-1][0]]
    top1 = float((M.logits(m.plans, plain).argmax(-1)
                  == M.logits(m.plans, m.want).argmax(-1)).mean())
    return {"a": a, "model": m, "plain": plain, "load_s": load_s,
            "plain_s": plain_s,
            "max_err_float": float(np.abs(plain - m.want).max()),
            "top1": top1,
            "ln_sums": [(float(r.min()), float(r.max())) for r in rows],
            "ln_inits": [ln.newton_init for ln in lns + [m.plans.ln_f]],
            "ln_row_ratio": [float(r.max()) / ln.newton_init
                             for r, ln in zip(rows, lns + [m.plans.ln_f])],
            "masks": plan_masks(*[p for bp in m.plans.blocks for p in (
                bp.attn.q, bp.attn.k, bp.attn.v, bp.attn.o,
                *[q for row in bp.mlp.fc1 + bp.mlp.fc2 for q in row])])}


def gpt2_phase(torch, same) -> dict:
    """Phase 8: one GPT-2 block and ln_f at GPT-2 small's width, encrypted
    through run_gpt2 (see the module docstring)."""
    from fhe_gpt2_tpu_torch import run_gpt2
    from fhe_gpt2_tpu_torch.core import _cuda
    from fhe_gpt2_tpu_torch.nn import layers as L
    from fhe_gpt2_tpu_torch.nn import model as M

    # The earlier phases' contexts, keys and mask caches sit in reference
    # cycles (a backend and its Bootstrapper): collect them first.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    net = gpt2_plain()
    a, m = net["a"], net["model"]
    sh = m.sh
    log(f"gpt2: {a.layers} block + ln_f, hidden {sh.hidden}, {sh.heads} "
        f"heads, seq {sh.seq}, {sh.slots} slots, {sh.act.n_cts} "
        f"ciphertexts per activation; knobs {m.knobs}; plans "
        f"{m.plans_s:.1f} s ({net['masks']} matmul masks), plain run "
        f"{net['plain_s']:.1f} s: max |plain - float oracle| "
        f"{net['max_err_float']:.3e} (bound {ERR_BOUND_GPT2_FLOAT}), top-1 "
        f"agreement {net['top1']}")
    log("gpt2: LayerNorm input row Σz² (min, max) / Newton seed: " + ", ".join(
        f"{lo:.3e}-{hi:.3e} / {init:.3e}" for (lo, hi), init in
        zip(net["ln_sums"], net["ln_inits"])))
    check(net["top1"] == 1.0 and net["max_err_float"] < ERR_BOUND_GPT2_FLOAT,
          f"gpt2 plain run against the float oracle: top-1 {net['top1']}, "
          f"max error {net['max_err_float']}")
    check(all(r < 1 for r in net["ln_row_ratio"]),
          f"a LayerNorm row above its Newton seed: {net['ln_row_ratio']}")

    t0 = time.perf_counter()
    ses = run_gpt2.build_session(a, m)
    setup_s = time.perf_counter() - t0
    ctx, B = ses.ctx, ses.B
    check(ctx.L == 80 and ctx.k_sp == 16 and ctx.num_digits(ctx.L) == 5,
          f"chain: {ctx.L} limbs, k={ctx.k_sp}")
    check(B.boot is None and B.dec is not None and B.default_level == ctx.L,
          "gpt2: the refresh is not the driver's decrypt/re-encrypt to the "
          "chain top")
    limit = 2.0 ** 62 / ctx.params.scale
    log(f"gpt2: logN={ctx.logn}, {ctx.L} limbs, k={ctx.k_sp}, floor "
        f"{B.min_level_headroom} level pairs, refresh decrypt/re-encrypt to "
        f"{B.default_level} limbs; keygen {ses.keygen_s:.1f} s "
        f"({ses.galois_keys} Galois keys incl. conjugation; {setup_s:.1f} s "
        f"with the rotation recording)")

    # The counted run: launch counts zeroed just before, read just after.
    # Wrappers record the first attention's input and wall seconds, the
    # launches of the block alone, and the encodings.
    rlog = RefreshLog(B, ses.dec)
    ev = B.ev
    encodings = [0]
    for name in ("make_plain", "make_plain_ext"):
        def counted(*args, inner=getattr(ev, name), **kw):
            encodings[0] += 1
            return inner(*args, **kw)
        setattr(ev, name, counted)
    seen: dict = {}
    attention, block = L.attention, L.block

    def timed_attention(B_, xs, sh_, ap, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = attention(B_, xs, sh_, ap, **kw)
        torch.cuda.synchronize()
        seen.setdefault("attn", (xs, ap, time.perf_counter() - t0))
        return out

    def counted_block(*args):
        out = block(*args)
        torch.cuda.synchronize()
        seen.setdefault("block_launches", dict(_cuda.LAUNCHES))
        seen.setdefault("block_s", time.perf_counter() - t0_fwd)
        return out

    L.attention, L.block = timed_attention, counted_block
    try:
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0_fwd = time.perf_counter()
        got = run_gpt2.encrypted_forward(ses, m)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0_fwd
        launches = dict(_cuda.LAUNCHES)
    finally:
        L.attention, L.block = attention, block
    # Every refreshed ciphertext and the two inputs are encoded once too.
    refreshes = rlog.by_site()
    refreshed = sum(int(np.prod(r["batch"])) for r in rlog.rows)
    masks = encodings[0] - refreshed - len(m.sh.act.pack(m.emb))
    block_s = seen["block_s"]
    plain = net["plain"]
    err = float(np.abs(got - plain).max())
    top1 = float((M.logits(m.plans, got).argmax(-1)
                  == M.logits(m.plans, plain).argmax(-1)).mean())
    largest = max(r["max_abs"] for r in rlog.rows)
    log(f"gpt2: {block_s:.1f} s per encrypted block (encrypting the input, "
        f"the first block of a key set: mask encodings included), forward "
        f"with ln_f and the decrypt {forward_s:.1f} s;"
        f" {masks} mask encodings; max |encrypted - plain| {err:.3e} (bound "
        f"{ERR_BOUND_GPT2}), logits top-1 agreement with the plain run "
        f"{top1}")
    log(f"gpt2: {len(rlog.rows)} refreshes (\"refresh\": "
        f"\"decrypt/re-encrypt\"), largest input |slot| {largest:.4g} "
        f"(limit 2^62/Δ = {limit:.4g}), by call site:")
    for line in rlog.lines():
        log("  " + line)
    log(f"gpt2: launches per block {seen['block_launches']}, per forward "
        f"{launches}")
    check(got.shape == plain.shape and np.isfinite(got).all(),
          "gpt2: bad hidden state")
    check(err < ERR_BOUND_GPT2, f"gpt2: max |encrypted - plain| {err}")
    check(top1 == 1.0, f"gpt2: logits top-1 {top1} against the plain run")
    check(len(rlog.rows) > 0 and largest < limit,
          f"gpt2: refresh inputs up to {largest}, limit {limit}")
    for name in REPLACES:
        check(seen["block_launches"][name] > 0,
              f"kernel {name} not launched by the GPT-2 block")

    # Every kernel against its plain version at each shape one attention
    # gives it (the Δ batch: key switches and mod-downs of 32 ciphertexts).
    # The masks and key slices cached by the forward make room for the plain
    # versions' int64 transients.
    xs, ap, attn_s = seen["attn"]
    B.release_caches()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shapes = hold_path_to_plain(lambda: attention(B, xs, sh, ap), same)
    torch.cuda.synchronize()
    hold_s = time.perf_counter() - t0
    log(f"gpt2: one attention, every kernel torch.equal to its plain "
        f"version at each shape ({hold_s:.1f} s): "
        + ", ".join(f"{k} {len(v)} shapes" for k, v in shapes.items()))
    log("  key switch c / key: " + ", ".join(
        f"{list(s[0][:-1])}/{list(s[2][1:3])}" for s in shapes["keyswitch"]))
    log("  mod-down x / k: " + ", ".join(
        f"{list(s[0][:-1])}/{s[3]}" for s in shapes["moddown"]))
    check(any(int(np.prod(s[0][:-2])) == 2 * sh.seq
              for s in shapes["keyswitch"]),
          f"no key switch over the Δ batch of {2 * sh.seq} ciphertexts")
    check(any(s[3] == ctx.k_sp and int(np.prod(s[0][1:-2])) == 2 * sh.seq
              for s in shapes["moddown"]),
          f"no k={ctx.k_sp} mod-down over the Δ batch")

    # The same attention under torch.profiler: device ms, kernels and the
    # card's idle share against its wall time in the counted run.
    # An attention at this width takes over a minute, mostly encoding its
    # masks on the host: the trace is padded with 64 small kernels, not a
    # second attention.
    x0 = torch.zeros(1, device="cuda")
    prof = profile_chain(torch, lambda: attention(B, xs, sh, ap), reps=1,
                         warm=False, pad=lambda: [x0 + i for i in range(64)])
    prof["ms"] = attn_s * 1e3
    prof["idle_share"] = 1.0 - prof["device_ms"] / prof["ms"]
    peak = torch.cuda.max_memory_allocated()
    total_s = time.perf_counter() - t_phase
    log(f"gpt2: one attention {attn_s:.1f} s in the counted run, device "
        f"{prof['device_ms']:.1f} ms (device idle "
        f"{100 * prof['idle_share']:.1f}%), {prof['launches']:.0f} device "
        f"kernels, port kernels {prof['port_launches']}; peak memory "
        f"{peak / 2 ** 30:.2f} GiB; phase {total_s:.1f} s")
    for name, kms, cnt in prof["top"]:
        log(f"  {kms:.3f} ms  x{cnt:.0f}  {name}")
    return {"hidden": sh.hidden, "heads": sh.heads, "seq": sh.seq,
            "limbs": ctx.L, "plans_s": m.plans_s, "keygen_s": ses.keygen_s,
            "setup_s": setup_s, "galois_keys": ses.galois_keys,
            "masks": net["masks"], "mask_encodings": masks,
            "block_s": block_s, "forward_s": forward_s,
            "refresh": "decrypt/re-encrypt",
            "refreshes": refreshes, "max_abs_err": err, "top1": top1,
            "max_err_float": net["max_err_float"], "top1_float": net["top1"],
            "ln_sums": net["ln_sums"], "ln_inits": net["ln_inits"],
            "block_launches": seen["block_launches"], "launches": launches,
            "path_shapes": {k: len(v) for k, v in shapes.items()},
            "path_plain_s": hold_s, "attn_profile": prof, "peak_bytes": peak,
            "phase_s": total_s}


def median_ms(torch, timer, fn) -> tuple[float, list]:
    """Median of 3 single calls by CUDA events, after one warm-up call."""
    fn()
    runs = [timer(fn, iters=1, warmup=0) for _ in range(3)]
    return float(np.median(runs)), runs


def u64_phase(torch, timer) -> dict:
    """Phase 9: the u64 engine on the card (int64 words, no kernel)."""
    from fhe_gpt2_tpu_torch.boot.bootstrap import Bootstrapper, \
        evalmod_cache_path, make_evalmod
    from fhe_gpt2_tpu_torch.core import _cuda, ntt as nttmod
    from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams, \
        gpt2_params, test_params
    from fhe_gpt2_tpu_torch.core.evaluator import Decryptor, Encryptor, \
        Evaluator
    from fhe_gpt2_tpu_torch.core.keys import KeyGenerator
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_seal_common import seal_session, to_coeff

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    _cuda.reset_launches()

    # SEAL's vectors on the card.
    v, sctx, sev, sdec, load_ct, sL = seal_session("cuda")
    ct = load_ct("ct_in", sL)
    sq = sev.rescale(sev.square(ct))
    rot = sev.rotate(ct, 1)
    check(sq.data.is_cuda and sq.data.dtype == torch.int64,
          "SEAL: the square is not an int64 tensor on the card")
    check(np.array_equal(to_coeff(sctx, sq.data, sL - 1),
                         np.stack([v["ct_sq_c0"], v["ct_sq_c1"]])),
          "SEAL: square+relin+rescale on the card differs from SEAL")
    check(np.array_equal(sdec.decrypt_to_rns(sq), v["plain_sq"]),
          "SEAL: decryption of the square differs from SEAL")
    check(np.array_equal(to_coeff(sctx, rot.data, sL),
                         np.stack([v["ct_rot_c0"], v["ct_rot_c1"]])),
          "SEAL: rotate by 1 on the card differs from SEAL")
    check(np.array_equal(sdec.decrypt_to_rns(rot), v["plain_rot"]),
          "SEAL: decryption of the rotation differs from SEAL")
    log(f"u64: SEAL vectors (N={sctx.n}, {sL}+1 limbs) square+relin+rescale "
        f"and rotate-by-1 on the card equal to SEAL's dumps word for word")
    del v, sctx, sev, sdec, load_ct, ct, sq, rot

    # The unit op at the reference's GPT-2 regime.
    t0 = time.perf_counter()
    params = gpt2_params()
    ctx = CkksContext(params)
    L = ctx.L
    ctx_s = time.perf_counter() - t0
    check(ctx.dtype == torch.int64 and ctx.ntt_all.q.is_cuda,
          "gpt2_params: the context is not int64 on the card")
    t0 = time.perf_counter()
    kg = KeyGenerator(ctx, seed=1)
    relin = kg.relin_key()
    gk = kg.galois_keys(steps=[1, 4], conjugate=True)
    pk = kg.public_key()
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    key_bytes = relin.data.numel() * relin.data.element_size()
    ev = Evaluator(ctx, relin_key=relin, galois_keys=gk)
    enc = Encryptor(ctx, secret=kg.secret, seed=2)
    enc_pk = Encryptor(ctx, public=pk, seed=3)
    dec = Decryptor(ctx, kg.secret)
    check(ev._hops(5) == [4, 1], f"rotate 5 hops {ev._hops(5)}")
    log(f"u64: gpt2_params logN={ctx.logn}, {L} limbs + {ctx.k_sp} special "
        f"({ctx.num_digits(L)} digits), h={params.hamming_weight}; context "
        f"{ctx_s:.1f} s, keygen {keygen_s:.1f} s (relin, "
        f"{len(gk.keys)} Galois, public; a key is "
        f"{list(relin.data.shape)} int64 = {key_bytes / 2 ** 30:.2f} GiB)")
    drng = np.random.default_rng(0)
    errs = {}
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    for r in range(U64_REQUESTS):
        z = drng.uniform(-1, 1, ctx.params.slots)
        e = enc_pk if r == U64_REQUESTS - 1 else enc
        ct = e.encrypt(ev.make_plain(z, params.scale, L))
        mul = ev.multiply(ct, ct)
        outs = {"encrypt": (ct, z), "mul_relin": (mul, z * z),
                "rescale": (ev.rescale(mul), z * z),
                "rotate5": (ev.rotate(ct, 5), np.roll(z, -5)),
                "conjugate": (ev.conjugate(ct), z)}
        for what, (o, want) in outs.items():
            check(o.data.is_cuda and o.data.dtype == torch.int64,
                  f"u64 request {r} {what}: not an int64 tensor on the card")
            got = dec.decrypt(o)
            check(got.shape == want.shape and np.isfinite(got).all(),
                  f"u64 request {r} {what}: bad output")
            key = ("pk_" if e is enc_pk else "") + what
            errs[key] = max(errs.get(key, 0.0),
                            float(np.max(np.abs(got - want))))
    torch.cuda.synchronize()
    req_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    log(f"u64: {U64_REQUESTS} requests {req_s:.1f} s; kernel launches "
        f"{launches}")
    for what, err in sorted(errs.items()):
        log(f"  decrypt {what}: max abs err {err:.3e} (bound {ERR_BOUND_U64})")
        check(err <= ERR_BOUND_U64, f"u64 {what}: error {err}")
    check(all(n == 0 for n in launches.values()),
          f"the u64 route launched a kernel: {launches}")

    ms = {}
    ms["mul_relin"], runs = median_ms(torch, timer,
                                      lambda: ev.multiply(ct, ct))
    mul = ev.multiply(ct, ct)
    ms["rescale"], _ = median_ms(torch, timer, lambda: ev.rescale(mul))
    ms["rotate1"], _ = median_ms(torch, timer, lambda: ev.rotate(ct, 1))
    t_key = ctx.tables(ctx.key_limbs(L))
    x1 = ct.data[1].contiguous()                                # [L, N]
    x2 = x1[None].expand(L, L, ctx.n).contiguous()
    x2 = torch.cat([x2, x2[:, :1]], dim=1)                     # [L, L+1, N]
    for name, x, t in ((f"ntt_{L}", x1, ctx.tables(L)),
                       (f"ntt_{L}x{L + 1}", x2, t_key)):
        ms[name], _ = median_ms(torch, timer, lambda: nttmod.ntt(x, t))
        ms["i" + name], _ = median_ms(torch, timer,
                                      lambda: nttmod.intt(x, t))
    del x2
    prof = profile_chain(torch, lambda: ev.multiply(ct, ct), reps=1)
    prof["idle_share"] = 1.0 - prof["device_ms"] / ms["mul_relin"]
    peak = torch.cuda.max_memory_allocated()
    log(f"u64: ms (CUDA events, median of 3): " + ", ".join(
        f"{k} {v:.1f}" for k, v in ms.items())
        + f"; multiply+relin runs {[round(r, 1) for r in runs]}")
    log(f"u64: profile multiply+relin: device {prof['device_ms']:.1f} ms of "
        f"{ms['mul_relin']:.1f} ms (device idle "
        f"{100 * prof['idle_share']:.1f}%), {prof['launches']:.0f} torch "
        f"kernels; peak memory {peak / 2 ** 30:.2f} GiB")
    for name, kms, cnt in prof["top"]:
        log(f"  {kms:.3f} ms  x{cnt:.0f}  {name}")
    del ev, enc, enc_pk, dec, kg, relin, gk, pk, ct, mul, outs, t_key, x1
    gc.collect()
    torch.cuda.empty_cache()

    # The card route against the CPU route at test_params(12, 6).
    t0 = time.perf_counter()
    p_eq = test_params(*U64_EQUAL)
    sides = {}
    for dev in ("cuda", "cpu"):
        c = CkksContext(p_eq, device=dev)
        k = KeyGenerator(c, seed=5)
        e = Evaluator(c, relin_key=k.relin_key(),
                      galois_keys=k.galois_keys([1]))
        z = np.random.default_rng(6).uniform(-1, 1, c.params.slots)
        x = Encryptor(c, secret=k.secret, seed=7).encrypt(
            e.make_plain(z, p_eq.scale, c.L))
        sides[dev] = e.rotate(e.rescale(e.multiply(x, x)), 1).data
    check(sides["cuda"].is_cuda and torch.equal(sides["cuda"].cpu(),
                                                sides["cpu"]),
          "u64: multiply+relin+rescale+rotate on the card != the CPU route")
    equal_s = time.perf_counter() - t0
    log(f"u64: test_params{U64_EQUAL} multiply+relin+rescale+rotate on the "
        f"card torch.equal to the CPU route ({equal_s:.1f} s)")

    # A u64 bootstrap at test_full_bootstrap's parameters.
    t0 = time.perf_counter()
    bparams = CkksParams.create(**U64_BOOT)
    bctx = CkksContext(bparams)
    bkg = KeyGenerator(bctx, seed=3)
    bev = Evaluator(bctx, relin_key=bkg.relin_key())
    benc = Encryptor(bctx, secret=bkg.secret, seed=4)
    bdec = Decryptor(bctx, bkg.secret)
    B = CkksBackend(ctx=bctx, ev=bev, enc=benc, dec=None,
                    default_level=bctx.L)
    eps = bparams.scale / bctx.q0_float
    em_kw = dict(K=12, eps=max(eps * 1.05, 2 ** -5), degree=45,
                 arcsin_degree=3, prec_dps=60)
    cache = evalmod_cache_path(num_double=2, **em_kw)
    check(Path(cache).exists(), f"EvalMod coefficients missing: {cache}")
    ns = U64_BOOT["sparse_slots"]
    boot = Bootstrapper(B, num_slots=ns, evalmod=make_evalmod(**em_kw))
    bev.galois_keys = bkg.galois_keys(steps=boot.required_steps(),
                                      conjugate=True)
    torch.cuda.synchronize()
    boot_setup_s = time.perf_counter() - t0
    z = np.random.default_rng(5).uniform(-1, 1, ns)
    bct = benc.encrypt(bev.make_plain(z, bparams.scale, 1))
    _cuda.reset_launches()
    t0 = time.perf_counter()
    out = boot.bootstrap(bct)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    check(all(n == 0 for n in _cuda.LAUNCHES.values()),
          f"the u64 bootstrap launched a kernel: {dict(_cuda.LAUNCHES)}")
    back = np.real(bdec.decrypt(out, num_slots=ns))
    check(back.shape == z.shape and np.isfinite(back).all(),
          "u64 bootstrap: bad output")
    berr = np.abs(back - z)
    log(f"u64: bootstrap logN={bctx.logn}, {bctx.L} limbs, {ns} slots: level "
        f"{bct.level} -> {out.level}, mean abs err {berr.mean():.3e}, max "
        f"{berr.max():.3e} (bounds {ERR_BOUND_U64_BOOT}); {boot_s:.2f} s "
        f"(first run, masks encoded), set-up and keygen {boot_setup_s:.1f} s")
    check(berr.mean() < ERR_BOUND_U64_BOOT[0]
          and berr.max() < ERR_BOUND_U64_BOOT[1],
          f"u64 bootstrap error mean {berr.mean()} max {berr.max()}")
    check(out.level >= 4, f"u64 bootstrap output level {out.level}")
    phase_s = time.perf_counter() - t_phase
    log(f"u64: phase {phase_s:.1f} s")
    return {"limbs": L, "keygen_s": keygen_s, "context_s": ctx_s,
            "requests": U64_REQUESTS, "requests_s": req_s,
            "max_abs_err": errs, "launches": launches, "ms": ms,
            "mul_relin_runs": runs, "profile": prof, "peak_bytes": peak,
            "equal_s": equal_s, "boot_s": boot_s,
            "boot_setup_s": boot_setup_s,
            "boot_mean_abs_err": float(berr.mean()),
            "boot_max_abs_err": float(berr.max()), "boot_level": out.level,
            "phase_s": phase_s}



# -- 11. sealed ---------------------------------------------------------------

@contextmanager
def eager_bootstraps(boot):
    """Run the body with `boot` bootstrapping eagerly (its bootstrap_jitted
    replaced by bootstrap): a graph replay calls no wrapper, so what holds
    each kernel to its plain version, or counts its launches beside the
    profiler, takes the bootstraps eagerly."""
    boot.bootstrap_jitted = boot.bootstrap
    try:
        yield
    finally:
        del boot.bootstrap_jitted


def sealed_phase(torch, timer, unit, boot_state) -> dict:
    """Phase 11 (a, b): the unit op (phase 5's ct-mult+relin at logN=15,
    22 limbs) and phase 6's staged bootstrap as sealed programs (CUDA
    graphs), each beside its eager run in this call."""
    from fhe_gpt2_tpu_torch.core import _cuda
    from fhe_gpt2_tpu_torch.core.evaluator import Ciphertext
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend, graph_pool_bytes, \
        jit_sealed

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    ctx, ev, enc = unit["ctx"], unit["ev"], unit["enc"]
    B = CkksBackend(ctx=ctx, ev=ev, enc=enc, default_level=ctx.L)
    drng = np.random.default_rng(21)

    def fresh():
        z = drng.uniform(-1, 1, ctx.params.slots)
        return enc.encrypt(ev.make_plain(z, ctx.params.scale, NUM_LEVELS))

    def op(c):
        return ev.multiply(c, c)

    # (a) the unit op.
    ct = fresh()
    want = op(ct)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    call = jit_sealed(B, op, ct)
    torch.cuda.synchronize()
    seal_s = time.perf_counter() - t0
    capture_launches = dict(_cuda.LAUNCHES)
    [prog] = call.programs.values()
    check(prog.graph is not None, "unit op: no graph captured")
    same_ct = Ciphertext(ct.data, ct.scale, ct.level)
    got = call(same_ct)
    check(torch.equal(got.data, want.data) and got.scale == want.scale,
          "unit op: replay != eager")
    ct2 = fresh()
    got2 = call(ct2)
    check(torch.equal(got2.data, op(ct2).data),
          "unit op: replay on new inputs != eager")
    check(torch.equal(got.data, want.data), "unit op: a replay overwrote "
          "the output of the one before")
    torch.cuda.synchronize()
    before = dict(_cuda.LAUNCHES)
    sealed_ms = timer(lambda: call(same_ct), iters=ITERS, warmup=3)
    check(_cuda.LAUNCHES == before, "unit op: a replay called a wrapper")
    eager_ms = timer(lambda: op(ct), iters=ITERS, warmup=3)
    sealed_ms2 = timer(lambda: call(same_ct), iters=ITERS, warmup=0)
    # The replay's trace holds the kernels the warm pass launched (half
    # of the warm pass's and the capture's).
    rprof = profile_chain(torch, lambda: call(same_ct), reps=10, expected={
        k: v // 2 for k, v in capture_launches.items()})
    log(f"sealed unit op (ct-mult+relin, logN=15, {NUM_LEVELS} limbs): "
        f"warm pass {prog.warm_s:.3f} s + capture {prog.capture_s:.3f} s "
        f"({seal_s:.3f} s in all; wrapper launches in them "
        f"{capture_launches}); replay torch.equal to eager, also on new "
        f"inputs; {sealed_ms:.3f} / {sealed_ms2:.3f} ms per sealed call "
        f"(input copy, replay, output copy) against {eager_ms:.3f} ms "
        f"eager (CUDA events, {ITERS} calls, same call); replay device "
        f"{rprof['device_ms']:.3f} ms (idle "
        f"{100 * (1 - rprof['device_ms'] / sealed_ms):.1f}%), "
        f"{rprof['launches']:.0f} kernels per call, port kernels "
        f"{rprof['port_launches']}")
    for name, kms, cnt in rprof["top"]:
        log(f"  {kms:.4f} ms  x{cnt:.0f}  {name}")
    out = {"unit": {"warm_s": prog.warm_s, "capture_s": prog.capture_s,
                    "seal_s": seal_s, "capture_launches": capture_launches,
                    "sealed_ms": [sealed_ms, sealed_ms2],
                    "eager_ms": eager_ms, "replay_profile": rprof}}

    # (b) the staged bootstrap at phase 6's shape.
    boot, bct, dec, z = (boot_state[k] for k in ("boot", "ct", "dec", "z"))
    bB = boot.B
    want = boot.bootstrap(bct)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    first = boot.bootstrap_jitted(bct)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    stages = [p for c in boot._staged_jit for p in c.programs.values()]
    check(all(p.graph is not None for p in stages),
          "bootstrap: a stage without a graph")
    capture_s = sum(p.capture_s for p in stages)
    warm_s = sum(p.warm_s for p in stages)
    pool = graph_pool_bytes(bB)
    held = torch.cuda.memory_allocated() - mem0
    check(torch.equal(first.data, want.data), "bootstrap: warm pass != eager")
    got = boot.bootstrap_jitted(bct)
    check(torch.equal(got.data, want.data) and got.scale == want.scale
          and got.level == want.level, "bootstrap: replay != eager")
    err = np.abs(np.real(dec.decrypt(got, num_slots=BOOT_SLOTS)) - z)
    check(err.mean() < ERR_BOUND_BOOT, f"sealed bootstrap mean error "
          f"{err.mean()}")
    eager_s, sealed_s = [], []
    for _ in range(3):
        eager_s.append(timer(lambda: boot.bootstrap(bct), iters=1,
                             warmup=0) / 1e3)
        sealed_s.append(timer(lambda: boot.bootstrap_jitted(bct), iters=1,
                              warmup=0) / 1e3)
    # A replay runs the eager bootstrap's kernels (phase 6 counted them).
    bprof = profile_chain(torch, lambda: boot.bootstrap_jitted(bct), reps=1,
                          expected=boot_state["launches"])
    sealed_med = float(np.median(sealed_s))
    peak = torch.cuda.max_memory_allocated()
    free, total = torch.cuda.mem_get_info()
    log(f"sealed bootstrap (logN=15, {boot.ctx.L} limbs, {BOOT_SLOTS} "
        f"slots, {len(stages)} stage graphs): first call {first_s:.2f} s "
        f"(warm passes {warm_s:.2f} s, captures {capture_s:.2f} s); replay "
        f"torch.equal to eager, mean abs err {err.mean():.3e} (bound "
        f"{ERR_BOUND_BOOT}); {sealed_med:.4f} s per sealed bootstrap "
        f"(median of {[round(v, 4) for v in sealed_s]}) against "
        f"{float(np.median(eager_s)):.4f} s eager (median of "
        f"{[round(v, 4) for v in eager_s]}; CUDA events, in turns); replay "
        f"device {bprof['device_ms']:.1f} ms (idle "
        f"{100 * (1 - bprof['device_ms'] / 1e3 / sealed_med):.1f}%), "
        f"{bprof['launches']:.0f} kernels; graph pool "
        f"{pool / 2 ** 30:.3f} GiB, tensors the sealed stages hold "
        f"{held / 2 ** 30:.3f} GiB, peak {peak / 2 ** 30:.2f} GiB, free "
        f"{free / 2 ** 30:.1f} of {total / 2 ** 30:.1f} GiB")
    for name, kms, cnt in bprof["top"]:
        log(f"  {kms:.3f} ms  x{cnt:.0f}  {name}")
    out["bootstrap"] = {
        "stages": len(stages), "first_s": first_s, "warm_s": warm_s,
        "capture_s": capture_s, "sealed_s": sealed_s, "eager_s": eager_s,
        "mean_abs_err": float(err.mean()), "graph_pool_bytes": pool,
        "held_bytes": held, "peak_bytes": peak, "replay_profile": bprof}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


ERR_BOUND_SEALED_GPT2 = 1e-8  # phase 11: 2 toy layers at Δ=2^50, 4 Newton
                              # steps (5.25e-11 and 7.91e-11 on the H100)
SEALED_RESNET_ARGS = [
    # tests/test_resnet_composite_boot.py's schedule: the composite chain
    # of 39 pairs at logN=10, h=16, 4 specials, K=25 / degree 59 EvalMod,
    # CtS/StC in 3 factors, inputs at 18 pairs, auto-refresh floor 2.
    "--composite", "--logn", "10", "--levels", "39", "--log-scale", "50",
    "--nsp", "4", "--hamming", "16", "--real-boot", "--digit-keys",
    "--boot-factors", "3", "--start-level", "18", "--headroom", "2",
    "--sign-log2-err", "-10", "--jit"]
SEALED_GPT2_ARGS = [
    # The CPU tests' toy GPT-2 (32 wide, 4 heads, seq 16, 4 Newton steps)
    # with 2 layers; every segment's input refreshed with boot_need pairs
    # or fewer left, which a segment (attention: 26 pairs) fits in.
    "--layers", "2", "--composite", "--logn", "10", "--levels", "40",
    "--nsp", "4", "--ln-iters", "4", "--weights", "synthetic",
    "--newton-inits", "rowmax", "--jit", "--boot-need", "30"]


def segment_programs(a) -> list:
    """The sealed programs of run_resnet --jit's session so far."""
    ses = getattr(a, "_session", None)
    if ses is None:
        return []
    return [p for _, calls, _ in ses.B._segments.values()
            for c in calls.values() for p in c.programs.values()]


@contextmanager
def plain_segments():
    """Run the body with the segment drivers' segments as plain calls (no
    sealed program): the eager run of the same driver, with the same
    refreshes between segments."""
    from fhe_gpt2_tpu_torch.nn import backend as NB
    saved = NB.segment_runner
    NB.segment_runner = lambda B, kind, model: (
        lambda name, fn, vs, part=None: fn(vs))
    try:
        yield
    finally:
        NB.segment_runner = saved


def equal_cts(got, want) -> bool:
    """Two lists of ciphertexts: equal scales, levels and words."""
    import torch
    return len(got) == len(want) and all(
        g.scale == w.scale and g.level == w.level
        and torch.equal(g.data, w.data) for g, w in zip(got, want))


def event_ms(torch, fn, reps: int = 20) -> float:
    """Mean ms of fn over reps calls, by CUDA events."""
    fn()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def rebound_graph_cost(torch, B, calls) -> dict:
    """What sharing one graph between GPT-2 layer 0's MLP and layer 1's
    (rebind_sealed's JAX counterpart) would cost and save, on layer 1's
    program: the mask bytes a switch would copy into the graph's mask
    tensors and the ms that copy takes (one copy per tensor, CUDA events),
    beside the graph's replay ms, its capture seconds and the pool bytes a
    graph adds (one more capture of the program, its replay held
    torch.equal to the program's own graph on the same inputs, then
    dropped)."""
    from fhe_gpt2_tpu_torch.nn.backend import graph_pool_bytes
    [c] = [c for (name, part, _), c in calls.items()
           if (name, part) == ("mlp", 1)]
    [prog] = c.programs.values()
    gr = prog.graph
    masks = [p.data for p in list(prog.seal.plains.values())
             + list(prog.seal.encodes.values())]
    mask_bytes = sum(t.numel() * t.element_size() for t in masks)
    into = [t.clone() for t in masks]

    def load():
        for dst, src in zip(into, masks):
            dst.copy_(src)

    load_ms = event_ms(torch, load)
    del into
    replay_ms = event_ms(torch, gr.graph.replay)
    want = [t.clone() for t in gr.static_out]
    pool0 = graph_pool_bytes(B)
    t0 = time.perf_counter()
    again = c._capture(prog, [t.clone() for t in gr.static_in])
    torch.cuda.synchronize()
    again_capture_s = time.perf_counter() - t0
    again_pool = graph_pool_bytes(B) - pool0
    again.graph.replay()
    check(all(torch.equal(a, b) for a, b in zip(again.static_out, want)),
          "mlp1: a second capture's replay != the first's")
    del again
    gc.collect()
    return {"segment": "mlp1", "mask_bytes": mask_bytes, "load_ms": load_ms,
            "replay_ms": replay_ms, "capture_s": prog.capture_s,
            "again_capture_s": again_capture_s, "pool_bytes": again_pool}


def sealed_drivers_phase(torch) -> dict:
    """Phase 11 (d): the segment drivers on the card. run_resnet --jit on
    tests/test_resnet_composite_boot.py's mini ResNet (depth 8, 4x4) with
    real bootstraps, two images (the second replays every graph), then one
    image encrypted once and run twice, all graphs replayed and the same
    driver with plain segments and eager bootstraps, torch.equal; run_gpt2
    --jit --boot-need on a 2-layer toy GPT-2, two forwards, then one
    encryption run replayed and eagerly, torch.equal, and what sharing a
    graph between its layers' MLPs would cost (rebound_graph_cost)."""
    from fhe_gpt2_tpu_torch import run_gpt2, run_resnet
    from fhe_gpt2_tpu_torch.approx.minimax import dp_schedule
    from fhe_gpt2_tpu_torch.cnn import resnet as R
    from fhe_gpt2_tpu_torch.core import _cuda
    from fhe_gpt2_tpu_torch.nn import kernels as K
    from fhe_gpt2_tpu_torch.nn import model as M
    from fhe_gpt2_tpu_torch.nn.backend import PlainBackend, graph_pool_bytes
    from fhe_gpt2_tpu_torch.utils import telemetry

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    weights = R.synthetic_weights(rng, 8)
    sign = K.SignPlans.from_composite(dp_schedule(2.0 ** -10, 2.0 ** -8))
    rp = R.build_resnet_plans(weights, 8, 512, h=4, relu_bound=10.0,
                              sign=sign)
    # The first two images drawn whose plain top-2 logit margin exceeds
    # twice ERR_BOUND_RESNET, so that each argmax is held to the plain
    # run's: at a smaller margin the logits' error (~1e-2 here) may swap
    # the top two, which is noise, not a fault.
    imgs, plains = [], []
    for _ in range(32):
        img = rng.uniform(-1, 1, (3, 4, 4))
        plain = R.logits_from_slots(rp, R.forward(
            PlainBackend(rp.slots), R.pack_input(rp, img), rp,
            boot_between=False)[0])
        top2 = np.sort(plain)[-2:]
        if top2[1] - top2[0] > 2 * ERR_BOUND_RESNET:
            imgs.append(img)
            plains.append(plain)
            if len(imgs) == 2:
                break
    check(len(imgs) == 2, "resnet --jit: no two images with a margin")
    a = run_resnet.parse_args(SEALED_RESNET_ARGS)
    rows = []
    for i, (img, plain) in enumerate(zip(imgs, plains)):
        n_prog = len(segment_programs(a))
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        # The recorder's bootstrap spans give the session's boot_times, as
        # in the run_resnet CLI.
        with telemetry.enable(only=("bootstrap",)):
            [got] = run_resnet._run_encrypted(a, rp, [img])
        torch.cuda.synchronize()
        image_s = time.perf_counter() - t0
        ses = a._session
        progs = segment_programs(a)
        boots = [p for c in ses.B.boot._staged_jit
                 for p in c.programs.values()]
        err = float(np.abs(got - plain).max())
        top2 = np.sort(plain)[-2:]
        rows.append({"image_s": image_s, "boot_s": list(ses.boot_times),
                     "warm_s": sum(p.warm_s for p in progs + boots),
                     "programs": len(progs), "new_programs":
                     len(progs) - n_prog, "boot_programs": len(boots),
                     "capture_s": sum(p.capture_s for p in progs + boots),
                     "launches": dict(_cuda.LAUNCHES), "err": err,
                     "margin": float(top2[1] - top2[0])})
        ses.clear_boot_times()
        check(np.isfinite(got).all() and err < ERR_BOUND_RESNET,
              f"resnet --jit image {i}: |got - plain| {err}")
        check(np.argmax(got) == np.argmax(plain),
              f"resnet --jit image {i}: argmax {np.argmax(got)} != plain "
              f"{np.argmax(plain)}")
        log(f"run_resnet --jit (mini ResNet-8, 4x4, logN=10, 39 pairs, real "
            f"bootstraps) image {i}: {image_s:.2f} s, {len(rows[-1]['boot_s'])}"
            f" bootstraps ({', '.join(f'{v:.3f}' for v in rows[-1]['boot_s'])}"
            f" s), {len(progs)} segment programs ({rows[-1]['new_programs']} "
            f"new), "
            f"{len(boots)} bootstrap stage graphs, warm passes "
            f"{rows[-1]['warm_s']:.2f} s and captures "
            f"{rows[-1]['capture_s']:.2f} s in all so far; |logits - plain| "
            f"{err:.3e}, argmax {np.argmax(got)} (plain {np.argmax(plain)}, "
            f"top-2 margin {rows[-1]['margin']:.3e}); wrapper launches "
            f"{rows[-1]['launches']}")
    check(rows[1]["new_programs"] == 0, "resnet --jit: the second image made "
          "new programs")
    # One encryption, every graph replayed, against the same driver run
    # eagerly (plain segments, eager bootstraps): the same words.
    B = a._session.B
    xs = [B.from_slots(v) for v in R.pack_input(rp, imgs[0])]
    n_prog = len(segment_programs(a))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = R.forward(B, list(xs), rp, jit=True)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    check(len(segment_programs(a)) == n_prog, "resnet --jit: the replayed "
          "forward made new programs")
    with plain_segments(), eager_bootstraps(B.boot):
        t0 = time.perf_counter()
        eag = R.forward(B, list(xs), rp, jit=True)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
    check(equal_cts(rep, eag), "resnet --jit: the replayed forward != the "
          "same driver run eagerly")
    resnet_equal = {"replay_s": replay_s, "eager_s": eager_s}
    log(f"run_resnet --jit: one encryption through every graph ({replay_s:.2f}"
        f" s) torch.equal to the same driver with plain segments and eager "
        f"bootstraps ({eager_s:.2f} s)")
    pool = graph_pool_bytes(B)
    del a._session, B, xs, rep, eag
    gc.collect()

    # GPT-2: two forwards through one session, then one encryption replayed
    # and run eagerly.
    g = run_gpt2.parse_args(SEALED_GPT2_ARGS)
    m = run_gpt2.load_model(g)
    ses = run_gpt2.build_session(g, m)
    plain = run_gpt2.plain_forward(m)
    grows = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden = run_gpt2.encrypted_forward(ses, m, jit=True,
                                            boot_need=g.boot_need)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        err = float(np.abs(hidden - plain).max())
        grows.append({"forward_s": fwd_s, "err": err})
        check(np.isfinite(hidden).all() and err < ERR_BOUND_SEALED_GPT2,
              f"gpt2 --jit forward {i}: |hidden - plain| {err}")
    B = ses.B
    xs = [B.from_slots(v) for v in m.sh.act.pack(m.emb)]
    state = B.enc.rng.bit_generator.state

    def forward():
        # The refreshes re-encrypt: each run draws the same randomness.
        B.enc.rng.bit_generator.state = state
        return M.forward(B, list(xs), m.plans, jit=True,
                         boot_need=g.boot_need)

    calls = list(B._segments.values())[0][1]
    n_prog = sum(len(c.programs) for c in calls.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = forward()
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    check(sum(len(c.programs) for c in calls.values()) == n_prog,
          "gpt2 --jit: the replayed forward made new programs")
    with plain_segments():
        t0 = time.perf_counter()
        eag = forward()
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
    check(equal_cts(rep, eag), "gpt2 --jit: the replayed forward != the "
          "same driver run eagerly")
    gpt2_equal = {"replay_s": replay_s, "eager_s": eager_s}
    cost = rebound_graph_cost(torch, B, calls)
    log(f"run_gpt2 --jit --boot-need {g.boot_need} (2 layers, 32 wide, "
        f"logN=10, {g.levels} pairs): forwards "
        + ", ".join(f"{r['forward_s']:.2f}" for r in grows) + " s, |hidden - "
        f"plain| " + ", ".join(f"{r['err']:.2e}" for r in grows)
        + f" (bound {ERR_BOUND_SEALED_GPT2}); one encryption through every "
        f"graph ({replay_s:.3f} s) torch.equal to the same driver with plain "
        f"segments ({eager_s:.3f} s); {len(calls)} segment graphs")
    log(f"layer 1's MLP graph: a shared graph would copy its "
        f"{cost['mask_bytes'] / 2 ** 20:.2f} MiB of masks on each switch, "
        f"{cost['load_ms']:.4f} ms, beside a replay of "
        f"{cost['replay_ms']:.4f} ms, and keep the base's masks twice; a "
        f"graph of its own took {cost['capture_s']:.3f} s to capture "
        f"({cost['again_capture_s']:.3f} s again, adding "
        f"{cost['pool_bytes'] / 2 ** 20:.1f} MiB of pool; its replay "
        f"torch.equal to the first's)")
    gpool = graph_pool_bytes(ses.B)
    del ses, B, xs, rep, eag
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    phase_s = time.perf_counter() - t_phase
    log(f"sealed drivers: graph pools {pool / 2 ** 20:.1f} MiB (ResNet) and "
        f"{gpool / 2 ** 20:.1f} MiB (GPT-2); peak {peak / 2 ** 30:.2f} GiB; "
        f"phase {phase_s:.1f} s")
    return {"resnet": rows, "resnet_equal": resnet_equal,
            "resnet_pool_bytes": pool, "gpt2": grows,
            "gpt2_equal": gpt2_equal, "rebound_graph": cost,
            "gpt2_pool_bytes": gpool, "peak_bytes": peak, "phase_s": phase_s}


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
