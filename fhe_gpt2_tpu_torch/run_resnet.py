"""Encrypted ResNet CIFAR inference driver on the port.

The port's counterpart of ``fhe_gpt2_tpu/run_resnet.py`` (itself the
counterpart of the reference's run/run_cnn.cpp + infer_seal.cpp driver):
loads the reference's pretrained weights, encrypts images, runs the
encrypted forward and prints one JSON line per image and a summary line.

    python -m fhe_gpt2_tpu_torch.run_resnet --depth 20 --images 1 [--plain]
           [--logn 15] [--levels 20] [--cpu]

The flags are the JAX driver's, except that --cpu asks for the CPU device
(without it the driver runs on the CUDA card, and raises when there is
none) and --log-scale sets the composite chain's scale (the JAX driver's
50 is the default). --jit runs the segment driver: each forward segment a
sealed program (a CUDA graph on the card, captured on the first image and
replayed on the next ones, which reuse the first image's keys and
backend), the bootstraps between segments through the staged sealed
pipeline. --plain runs the slot-exact simulator (no crypto), the fast path
for algorithm validation. An encrypted run records the port's bootstrap
spans (``utils/telemetry.py``, ``enable(only=("bootstrap",))``: no other
span, no counter, no CUDA event): the summary's ``boot_seconds_*`` are
their host walls, each ended with the card synchronized. --trace PATH
turns the whole recorder and ``torch.profiler`` on over the run instead
and writes the spans and the device trace to PATH as one Chrome-trace JSON
(``telemetry.trace``), with the device's idle seconds by the innermost span
beside them. The ResNet-20
bootstrapped run on the composite chain is

    python -m fhe_gpt2_tpu_torch.run_resnet --composite --log-scale 54 \\
        --real-boot --levels 39 --nsp 16 --digit-keys --boot-factors 3 \\
        --start-level 18 --headroom 0 --sign-log2-err -10
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from dataclasses import dataclass

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depth", type=int, default=20,
                    choices=[20, 32, 44, 56, 110])
    ap.add_argument("--dataset", default="cifar10",
                    choices=["cifar10", "cifar100"],
                    help="cifar100 = resnet32_cifar100 weights (option-B "
                         "learned downsample shortcuts, 100-way FC)")
    ap.add_argument("--images", type=int, default=1)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--logn", type=int, default=15)
    ap.add_argument("--levels", type=int, default=None,
                    help="modulus-chain levels (default 20; 30 with "
                         "--real-boot)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nsp", type=int, default=None,
                    help="special primes (hybrid key-switch digit size); "
                         "default 1 (u64) / 3 (w32, composite)")
    ap.add_argument("--word", type=int, default=64, choices=[32, 64],
                    help="engine word size. 32 = uint32 moduli (25-bit "
                         "scale, the CUDA kernels); 64 = u64 moduli (51-bit "
                         "q0, 46-bit scale, the reference's regime; int64 "
                         "PyTorch ops, no kernel)")
    ap.add_argument("--composite", action="store_true",
                    help="uint32 engine with composite two-prime scaling "
                         "(Δ = q·q′ ≈ 2^50, Q0 ≈ 2^55). --levels counts "
                         "logical levels (pairs).")
    ap.add_argument("--log-scale", type=int, default=50,
                    help="composite chain: Δ ≈ 2^log_scale, Q0 ≈ "
                         "2^(log_scale+5). At logN=15 a 39-pair chain at 50 "
                         "runs out of NTT-friendly primes near 2^25: its top "
                         "pairs drift to 0.64·Δ and the bootstrap fails; at "
                         "54 every pair is within 0.04 bits of Δ")
    ap.add_argument("--hamming", type=int, default=192,
                    help="sparse secret weight (reference: 192)")
    ap.add_argument("--boot-K", type=int, default=25,
                    help="EvalMod integer window (reference: 25 for h=192)")
    ap.add_argument("--boot-degree", type=int, default=59,
                    help="EvalMod cosine degree (reference: 59)")
    ap.add_argument("--sign-log2-err", type=float, default=None,
                    help="composite-sign target error, log2 (default: -12 "
                         "u64 and composite / -6 w32)")
    ap.add_argument("--jit", action="store_true",
                    help="segment driver: each forward segment a sealed "
                         "program (a CUDA graph on the card), bootstraps "
                         "between segments staged the same way")
    ap.add_argument("--real-boot", action="store_true",
                    help="use the real CKKS bootstrap between blocks "
                         "(default: the decrypt/re-encrypt level reset)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch versions of the "
                         "kernels); without it the driver needs a CUDA card")
    ap.add_argument("--data-slots", type=int, default=0,
                    help="logical slot count for the CNN packing (< ring "
                         "slots): data and masks replicate cyclically over "
                         "the ring and the bootstrap runs sparse at this "
                         "count. ResNet tensors need only 16384 slots.")
    ap.add_argument("--digit-keys", action="store_true",
                    help="generate the base-16 digit rotation key set (~48 "
                         "keys) instead of one key per recorded amount; "
                         "rotations decompose into <=4 hops")
    ap.add_argument("--boot-factors", type=int, default=2,
                    help="CtS/StC factorization depth (3 = fewer masks, "
                         "2 more levels consumed)")
    ap.add_argument("--start-level", type=int, default=0,
                    help="encrypt inputs at this LOGICAL level instead of "
                         "the chain top: (levels - bootstrap depth) runs "
                         "the stem ReLU at the level of every "
                         "post-bootstrap ReLU")
    ap.add_argument("--headroom", type=int, default=None,
                    help="auto-bootstrap level floor in logical levels "
                         "(backend min_level_headroom; default 3)")
    ap.add_argument("--no-ext-hoist", action="store_true",
                    help="single-hoisted LT path (a mod-down per baby "
                         "rotation)")
    ap.add_argument("--batch-images", action="store_true",
                    help="stack all --images on the ciphertext batch axis "
                         "and run ONE batched forward")
    ap.add_argument("--out", default=None,
                    help="append per-image result JSON lines to this file")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the port's spans and counters and a "
                         "torch.profiler device trace of the run to PATH "
                         "(Chrome-trace JSON, utils/telemetry.trace)")
    a = ap.parse_args(argv)
    if a.nsp is None:
        a.nsp = 3 if (a.word == 32 or a.composite) else 1
    if a.levels is None:
        a.levels = 30 if a.real_boot else 20
    return a


def device_of(a) -> str:
    """The run's device: the CPU on --cpu, else the card (the context
    raises when there is none; nothing drops to the CPU on its own)."""
    from .core.context import resolve_device
    return str(resolve_device("cpu" if a.cpu else None))


def main(argv=None):
    a = parse_args(argv)
    device_of(a)
    from .utils import telemetry

    if a.trace:
        with telemetry.trace(a.trace) as summary:
            _main(a)
        print(json.dumps({"trace": a.trace,
                          "idle_by_span": summary["idle_by_span"][:10]}))
    elif a.plain:
        _main(a)
    else:
        # The bootstrap spans alone, for the summary's boot_seconds_*.
        with telemetry.enable(only=("bootstrap",)):
            _main(a)


def _main(a):
    from .approx.minimax import dp_schedule
    from .cnn import resnet as R
    from .nn import kernels as K
    from .nn.backend import PlainBackend

    t0 = time.time()
    weights = R.load_reference_weights(a.depth, a.dataset)
    slots = (1 << (a.logn - 1)) if not a.plain else 16384
    if a.data_slots:
        assert a.data_slots <= slots and slots % a.data_slots == 0
        slots = a.data_slots
    serr = a.sign_log2_err or (
        -6.0 if (a.word == 32 and not a.composite) else -12.0)
    sign = K.SignPlans.from_composite(
        dp_schedule(target_err=2.0 ** serr, eps=2.0 ** (serr + 2)))
    rp = R.build_resnet_plans(weights, a.depth, slots, sign=sign)
    print(f"# plans built in {time.time()-t0:.1f}s "
          f"({len(rp.blocks)} blocks, slots={slots})")

    rng = np.random.default_rng(a.seed)
    # Random inputs exercise the full pipeline and are compared against
    # the float oracle (the reference snapshot has no CIFAR test images).
    imgs = [rng.uniform(-1, 1, (3, 32, 32)) for _ in range(a.images)]
    wants = [R.forward_float(weights, a.depth, img) for img in imgs]
    results = []
    if a.plain:
        B = PlainBackend(slots)
        for i, img in enumerate(imgs):
            t0 = time.time()
            out = R.forward(B, R.pack_input(rp, img), rp, boot_between=False)
            got = R.logits_from_slots(rp, out[0])
            results.append(_result(i, got, wants[i], time.time() - t0))
            print(json.dumps(results[-1]))
    elif a.batch_images:
        t0 = time.time()
        logits = _run_encrypted(a, rp, imgs)
        dt = (time.time() - t0) / len(imgs)
        for i, (got, want) in enumerate(zip(logits, wants)):
            results.append(_result(i, got, want, dt))
            print(json.dumps(results[-1]))
    else:
        for i, img in enumerate(imgs):
            t0 = time.time()
            [got] = _run_encrypted(a, rp, [img])
            results.append(_result(i, got, wants[i], time.time() - t0))
            print(json.dumps(results[-1]))
    n_ok = sum(r["match"] for r in results)
    summary = dict(depth=a.depth, dataset=a.dataset, images=a.images,
                   logn=a.logn, levels=a.levels, word=a.word,
                   composite=bool(a.composite), nsp=a.nsp,
                   real_boot=a.real_boot, jit=a.jit,
                   batch_images=bool(a.batch_images),
                   oracle_agreement=n_ok / len(results),
                   seconds_per_image=round(
                       sum(r["seconds"] for r in results) / len(results), 2))
    ses = getattr(a, "_boot_session", None)
    bt = ses.boot_times if ses is not None else None
    if bt:
        summary.update(
            n_bootstraps=len(bt),
            boot_seconds_first=round(bt[0], 2),
            boot_seconds_min=round(min(bt), 3),
            boot_seconds_mean_steady=round(
                sum(bt[1:]) / (len(bt) - 1), 3)
            if len(bt) > 1 else round(bt[0], 3))
    print(json.dumps(summary))
    if a.out:
        with open(a.out, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
            f.write(json.dumps(summary) + "\n")


def _result(i, got, want, dt):
    return dict(image=i, seconds=round(dt, 2), label=int(np.argmax(got)),
                oracle_label=int(np.argmax(want)),
                match=bool(np.argmax(got) == np.argmax(want)),
                logit_mae=round(float(np.abs(got - want).mean()), 5))


def _log(msg):
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", flush=True)


@dataclass
class Session:
    """What the encrypted run is built on: the context, the key generator,
    the backend (with its Bootstrapper under --real-boot), the decryptor
    and the set-up seconds."""

    ctx: object
    kg: object
    B: object
    dec: object
    keygen_s: float
    galois_keys: int
    # The recorder's mark and the thread from which ``boot_times`` reads.
    boot_mark: int = 0
    boot_thread: int = 0

    @property
    def boot_times(self) -> list:
        """``boot_seconds`` of the bootstraps this session's thread ran
        since the session was built (or ``clear_boot_times``)."""
        return boot_seconds(self.boot_mark, self.boot_thread)

    def clear_boot_times(self) -> None:
        from .utils import telemetry
        self.boot_mark = telemetry.mark()
        self.boot_thread = threading.get_ident()


def boot_seconds(mark: int, thread: int) -> list:
    """Host seconds of each bootstrap that thread `thread` ran after
    `mark` (``telemetry.mark()``), each ended with the card synchronized:
    the recorder's ``bootstrap`` spans outside sealed calls
    (``utils/telemetry.py``; ``enable(only=("bootstrap",))`` records them
    alone). Empty while the recorder is off; raises if it dropped spans,
    which may have been bootstraps."""
    from .utils import telemetry
    if telemetry.dropped():
        raise RuntimeError(f"the recorder dropped {telemetry.dropped()} "
                           "spans: bootstrap times would be short")
    return [s.ms / 1e3 for s in telemetry.spans_since(mark)
            if s.name == "bootstrap" and s.synced and s.thread == thread]


def make_params(a):
    """The CKKS parameter set of the flags (composite, w32 or u64)."""
    from .core.context import CkksParams
    ss = a.data_slots if a.data_slots else 0
    if a.composite:
        return CkksParams.create_composite(
            logn=a.logn, num_levels=a.levels, log_scale=a.log_scale,
            log_q0=a.log_scale + 5,
            log_special=31, num_special=a.nsp, hamming_weight=a.hamming,
            sparse_slots=ss)
    if a.word == 32:
        return CkksParams.create(
            logn=a.logn, log_q0=29, log_scale=25, num_levels=a.levels,
            log_special=31, num_special=a.nsp, hamming_weight=a.hamming,
            sparse_slots=ss)
    return CkksParams.create(
        logn=a.logn, log_q0=51, log_scale=46, num_levels=a.levels,
        log_special=51, num_special=a.nsp, hamming_weight=a.hamming,
        sparse_slots=ss)


def input_level(a, ctx) -> int:
    """The limbs the inputs are encrypted at: the chain top, or
    --start-level logical levels above the bootstrap base."""
    if a.start_level:
        return ctx.base_limbs + a.start_level * ctx.rescale_limbs
    return len(ctx.params.moduli) if a.composite else a.levels


def make_bootstrapper(a, B):
    """The real Bootstrapper of the flags over backend B. The EvalMod
    window: eps is the actual Δ/q0 of the parameter set; K covers the
    ModRaise overshoot of the h-sparse secret (infer_seal.cpp:287-322: K=25
    for h=192)."""
    from .boot.bootstrap import Bootstrapper, make_evalmod
    eps = B.ctx.params.scale / B.ctx.q0_float
    em = make_evalmod(K=a.boot_K, eps=max(eps * 1.05, 2 ** -5),
                      degree=a.boot_degree, arcsin_degree=3, prec_dps=80)
    return Bootstrapper(B, evalmod=em, cts_factors=a.boot_factors,
                        stc_factors=a.boot_factors)


def build_session(a, rp, img) -> Session:
    """Context, keys, backend and Bootstrapper of an encrypted run, on the
    device of ``device_of(a)``. The rotation set is recorded from one
    plain forward of ``img``."""
    import torch

    from .cnn import resnet as R
    from .core.context import CkksContext
    from .core.evaluator import Decryptor, Encryptor, Evaluator
    from .core.keys import KeyGenerator
    from .nn.backend import CkksBackend, RecordingBackend

    device = device_of(a)
    rec = RecordingBackend(rp.slots)
    R.forward(rec, R.pack_input(rp, img), rp, boot_between=False)
    _log("rotation recording done")
    params = make_params(a)
    ctx = CkksContext(params, device=device)
    _log(f"context built: {ctx.L} limbs + {ctx.k_sp} special on {device}")
    lvl = input_level(a, ctx)
    t_keys = time.time()
    kg = KeyGenerator(ctx, seed=1)
    ev = Evaluator(ctx, relin_key=kg.relin_key())
    enc = Encryptor(ctx, secret=kg.secret, seed=2)
    dec = Decryptor(ctx, kg.secret)
    B = CkksBackend(ctx=ctx, ev=ev, enc=enc, dec=dec, default_level=lvl,
                    no_ext_hoist=bool(a.no_ext_hoist))
    if a.headroom is not None:
        B.min_level_headroom = a.headroom
    _log("relin key done")
    steps = set(rec.key_steps())
    if a.real_boot:
        B.boot = make_bootstrapper(a, B)
        steps.update(B.boot.required_steps())
    if a.digit_keys:
        # Base-16 digit set only: every rotation, model and bootstrap,
        # decomposes into <=4 hops.
        from .core.keys import digit_steps
        steps = set(digit_steps(ctx.params.slots, base=16))
    t0 = time.time()
    ev.galois_keys = kg.galois_keys(steps=sorted(steps), conjugate=True)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    _log(f"galois keygen done: {len(steps)} keys in {time.time()-t0:.0f}s")
    s = Session(ctx=ctx, kg=kg, B=B, dec=dec,
                keygen_s=time.time() - t_keys,
                galois_keys=len(ev.galois_keys.keys))
    s.clear_boot_times()
    return s


def _run_encrypted(a, rp, imgs):
    """Encrypted forward over `imgs` (stacked on the ct batch axis when
    len > 1). Returns per-image logits. Under --jit the session (keys,
    backend and with it the sealed programs) is built once and kept on
    `a` for the next images."""
    from .cnn import resnet as R

    s = getattr(a, "_session", None) if a.jit else None
    if s is None:
        s = build_session(a, rp, imgs[0])
        if a.jit:
            a._session = s
    a._boot_session = s
    B = s.B
    packed = [R.pack_input(rp, img) for img in imgs]     # [n_img][n_cts]
    if len(imgs) == 1:
        xs = [B.from_slots(v) for v in packed[0]]
    else:
        xs = [B.from_slots(np.stack([p[i] for p in packed]))
              for i in range(len(packed[0]))]
    out = R.forward(B, xs, rp, jit=a.jit)
    slots_out = B.to_slots(out[0])
    if len(imgs) == 1:
        return [R.logits_from_slots(rp, slots_out)]
    return [R.logits_from_slots(rp, slots_out[i]) for i in range(len(imgs))]


if __name__ == "__main__":
    main()
