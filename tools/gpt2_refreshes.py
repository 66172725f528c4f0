#!/usr/bin/env python3
"""Refreshes of the port's eager GPT-2 forward, by call site.

    python3 tools/gpt2_refreshes.py [--hidden 32] [--heads 4] [--seq 16]
        [--logn 10] [--targets top 18] [--ln-iters 13 ...]
        [--headroom 3 ...] [--cpu]

Runs one GPT-2 block and ln_f (run_gpt2 --weights synthetic --newton-inits
rowmax, seed 0) encrypted through run_gpt2.build_session with the flags of
the card's "gpt2" phase (chip_smoke.GPT2_ARGS: 39 level pairs, Δ = 2^54, 16
special primes, base-16 digit keys) at a toy width, with the depth knobs
(exp_r, inv_iters) that calibrate_attn_knobs gives at GPT-2 small's width
(768 wide, 12 heads, the same seed), so that levels are spent as at full
width. At --logn 15 the chain's primes, and with them the scales each
rescale leaves, are the card phase's too; at a smaller ring they are not.
The width must fill the rows of its ciphertexts: at --logn 15 and seq 16,
--hidden 512 (one ciphertext).

For every LayerNorm iteration count (--ln-iters), refresh floor in level
pairs (--headroom) and refresh target it prints the refreshes by call site
in nn/layers.py and nn/kernels.py: the count, the input levels and batch
shapes, and the input's largest |slot|, beside 2^62/Δ, the largest |slot|
the decrypt/re-encrypt refresh can encode; the largest scale an encoding
took; and the error against the plain run, or where the run failed (a mask
whose scale a chain of squarings drifted past what an encoding holds).
Targets:

  top  the driver's own refresh, decrypt/re-encrypt to the chain top;
  P    a stand-in for a real bootstrap (rotations at the floor refresh
       too), decrypt/re-encrypt to P level pairs above the base (a
       bootstrap on this chain leaves 18).

A refresh input too large to encode is encoded divided by 2^s and
multiplied back by the integer 2^s, so that the run goes on and every site
is seen; the driver's own refresh raises there. --ln-iters defaults to
the phase's count, --headroom to the backend's 3. It runs on the card
unless --cpu is given.
"""

from __future__ import annotations

import argparse
import itertools
import math
import sys
import time
import traceback
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))



def phase_args(**width) -> list:
    """chip_smoke.GPT2_ARGS (the card's "gpt2" phase) with the flags in
    ``width`` (hidden, heads, seq, logn, ln_iters) replaced."""
    from chip_smoke import GPT2_ARGS
    args = list(GPT2_ARGS)
    for k, v in width.items():
        flag = "--" + k.replace("_", "-")
        args[args.index(flag) + 1] = str(v)
    return args


def full_width_depth_knobs(seq: int) -> tuple[int, int]:
    """(exp_r, inv_iters) of calibrate_attn_knobs on the synthetic GPT-2 at
    768 wide with 12 heads (numpy seed 0), one layer."""
    from fhe_gpt2_tpu_torch import run_gpt2
    from fhe_gpt2_tpu_torch.nn import layers as L
    from fhe_gpt2_tpu_torch.nn import model as M
    from fhe_gpt2_tpu_torch.nn.calibrate import calibrate_attn_knobs

    w = M.synthetic_weights(np.random.default_rng(0), 1, 768, 12,
                            run_gpt2.GPT2_VOCAB, run_gpt2.GPT2_POSITIONS)
    ids = np.random.default_rng(0).integers(0, run_gpt2.GPT2_VOCAB, seq)
    sh = L.GPT2Shapes(slots=16384, seq=seq, hidden=768, heads=12)
    emb = M.embed(M.build_gpt2_plans(sh, w, 0), ids)
    k = calibrate_attn_knobs(sh, w, 1, emb)
    return k.exp_r, k.inv_iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--logn", type=int, default=10)
    ap.add_argument("--targets", nargs="+", default=["top", "18"])
    ap.add_argument("--ln-iters", type=int, nargs="+", default=None,
                    help="LayerNorm Newton iterations (default: the "
                         "phase's)")
    ap.add_argument("--headroom", type=int, nargs="+", default=[3],
                    help="refresh floor in level pairs above the base")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    if a.ln_iters is None:
        from chip_smoke import GPT2_ARGS
        a.ln_iters = [int(GPT2_ARGS[GPT2_ARGS.index("--ln-iters") + 1])]

    from chip_smoke import RefreshLog
    from fhe_gpt2_tpu_torch import run_gpt2
    from fhe_gpt2_tpu_torch.core.evaluator import fake_bootstrap, \
        stack_cts, unstack_cts
    from fhe_gpt2_tpu_torch.nn import backend

    exp_r, inv_iters = full_width_depth_knobs(a.seq)
    print(f"# depth knobs of the 768-wide model: exp_r {exp_r}, inv_iters "
          f"{inv_iters}", flush=True)
    args = run_gpt2.parse_args(
        phase_args(hidden=a.hidden, heads=a.heads, seq=a.seq, logn=a.logn)
        + (["--cpu"] if a.cpu else []))
    m = run_gpt2.load_model(args)
    for bp in m.plans.blocks:
        bp.attn.exp_r, bp.attn.inv_iters = exp_r, inv_iters
    lns = [ln for bp in m.plans.blocks for ln in (bp.ln1, bp.ln2)]
    lns.append(m.plans.ln_f)
    ses = run_gpt2.build_session(args, m)
    B, ctx, dec = ses.B, ses.ctx, ses.dec
    ev, enc = B.ev, B.enc
    limit = 2.0 ** 62 / ctx.params.scale
    scales = []
    for name in ("make_plain", "make_plain_ext"):
        def counted(values, scale, level, inner=getattr(ev, name)):
            scales.append(scale)
            return inner(values, scale, level)
        setattr(ev, name, counted)
    bootstrap, decrypt = B.bootstrap, dec.decrypt
    for ln_iters, headroom, target in itertools.product(
            a.ln_iters, a.headroom, a.targets):
        for ln in lns:
            ln.newton_iters = ln_iters
        plain = run_gpt2.plain_forward(m)
        # Each run starts from empty caches: its own masks and key slices.
        B.release_caches()
        lvl = ctx.L if target == "top" else (
            ctx.base_limbs + int(target) * ctx.rescale_limbs)

        def refresh(ct, *args, **kw):
            """Decrypt/re-encrypt at lvl; a value too large to encode is
            encoded divided by 2^s and multiplied back by 2^s."""
            if ct.batch:
                return stack_cts([refresh(c) for c in unstack_cts(ct)])
            try:
                return fake_bootstrap(ct, dec, enc, ev, lvl)
            except ValueError:
                v = np.real(dec.decrypt(ct))
                s = max(1, math.ceil(math.log2(2 * np.abs(v).max() / limit)))
                pt = ev.make_plain(v / 2 ** s, ct.scale, lvl)
                return ev.mul_const_int(enc.encrypt_symmetric(pt), 2 ** s)

        class StandIn:
            def bootstrap(self, ct, **kw):
                return refresh(ct)

        # "top": the driver's refresh (CkksBackend.bootstrap without a
        # Bootstrapper), made able to go on past a value it cannot encode.
        # P pairs: a real bootstrap's place in the backend, where rotations
        # at the floor refresh too.
        backend.fake_bootstrap = refresh
        B.boot = None if target == "top" else StandIn()
        B.min_level_headroom = headroom
        B.bootstrap, dec.decrypt = bootstrap, decrypt
        log = RefreshLog(B, dec)
        scales.clear()
        t0 = time.time()
        try:
            got = run_gpt2.encrypted_forward(ses, m)
            outcome = (f"max |encrypted - plain| "
                       f"{np.abs(got - plain).max():.3e}")
        except ValueError as e:
            # A mask the encoder cannot hold: the scale a squaring chain
            # drifted to puts its coefficients past 2^62.
            where = " > ".join(
                f"{Path(f.filename).name}:{f.lineno} {f.name}"
                for f in traceback.extract_tb(e.__traceback__)
                if f.filename.replace("\\", "/").endswith(
                    RefreshLog.SITE_FILES))
            outcome = f"FAILED at {where}: {e}"
        finally:
            backend.fake_bootstrap = fake_bootstrap
        dt = time.time() - t0
        over = [r for r in log.rows if r["max_abs"] >= limit]
        print(f"GPT-2 block + ln_f, hidden {a.hidden}, {a.heads} heads, seq "
              f"{a.seq}, logN={a.logn}, {ctx.L} limbs, Δ=2^"
              f"{math.log2(ctx.params.scale):.0f}, ln_iters {ln_iters}, "
              f"floor {headroom} pairs, refresh to "
              f"{'the top' if target == 'top' else target + ' pairs'}: "
              f"{len(log.rows)} refreshes, {len(over)} of them at or above "
              f"2^62/Δ = {limit:.4g} (largest input |slot| "
              f"{max((r['max_abs'] for r in log.rows), default=0):.4g}); "
              f"largest encoding scale 2^{math.log2(max(scales)):.1f}; "
              f"{outcome}; {dt:.0f} s", flush=True)
        for line in log.lines():
            print("  " + line, flush=True)
    B.bootstrap, dec.decrypt = bootstrap, decrypt


if __name__ == "__main__":
    main()
