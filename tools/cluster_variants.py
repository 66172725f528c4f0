#!/usr/bin/env python3
"""Time variants of the cluster kernels (NTT, key switch, mod-down) on one card.

    python3 tools/cluster_variants.py

Each variant is a set of text substitutions applied to a copy of
``fhe_gpt2_tpu_torch/csrc`` (``base`` is the sources as they are; ``noNTT``
skips the cluster NTT and iNTT, so it times the loads, the stores, the
kernel's other arithmetic and its closing barrier alone; ``notw`` takes
every twiddle of the cluster NTT and iNTT from one table word, so the
twiddle loads leave and the barriers stay; ``gather0`` has the key switch's
conversion read one source limb for every term, which L1 holds; ``nokey``
skips its key loads). Every substitution must match the sources, or the
tool stops: a variant never silently equals ``base``. Every variant is
built with nvcc (``-Xptxas -v``, whose register counts are printed) into
``build/variants/<name>/``, and its C entries are called with the wrappers'
own argument lists (``tntt.ntt_args``, ``tks.ks_fused_args`` /
``md_fused_args``) at the main-path shapes (logN=15, level 22, alpha=8: the
forward and inverse NTT of [22, N] and of the special limbs [2, 8, N] read
in place from [2, 30, N]; the key switch of one ciphertext limb set to J=30
key limbs; the mod-down of [2, 30, N] to [2, 22, N]) at every cluster size
the kernels take. Times are device microseconds per call from CUDA events
over 30 calls queued behind a sleep kernel, so host launch gaps do not
count. ``base`` must equal the plain version (``torch.equal``); the other
variants print whether they do.
"""
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fhe_gpt2_tpu_torch.core import _cuda, tks, tntt  # noqa: E402
from fhe_gpt2_tpu_torch.core import ntt as nttmod  # noqa: E402
from fhe_gpt2_tpu_torch.core.context import CkksContext, CkksParams  # noqa: E402
from fhe_gpt2_tpu_torch.core.modmath import word_tensor  # noqa: E402

OUT = ROOT / "build" / "variants"
VARIANTS = {
    "base": [],
    "noNTT": [("cluster_ntt_fwd<W, LC>(", "if (0) cluster_ntt_fwd<W, LC>("),
              ("cluster_ntt_inv<W, LC>(", "if (0) cluster_ntt_inv<W, LC>(")],
    "notw": [("__ldg(rt + tw0 + blk), ws = __ldg(rts + tw0 + blk);",
              "__ldg(rt + 1), ws = __ldg(rts + 1);")],
    "gather0": [("(long long)gather[d * A + a] * n, y);", "0 * n, y);")],
    "nokey": [("load_words<W>(kp, y);", ""),
              ("load_words<W>(kp + key_c, y);", "")],
}


def build() -> dict[str, dict]:
    """Write and compile every variant; returns {variant: {lib: CDLL}}."""
    procs = []
    for v, subs in VARIANTS.items():
        d = OUT / v
        d.mkdir(parents=True, exist_ok=True)
        texts = {f.name: f.read_text() for f in _cuda.CSRC.glob("*.cu*")}
        for a, b in subs:
            hits = [name for name, s in texts.items() if a in s]
            if not hits:
                raise SystemExit(f"variant {v}: {a!r} matches no source")
            for name in hits:
                texts[name] = texts[name].replace(a, b)
        for name, s in texts.items():
            (d / name).write_text(s)
        for name in _cuda.SOURCES:
            cmd = _cuda.nvcc_command(d / f"{name}.cu", d / f"lib{name}.so")
            procs.append((v, name, subprocess.Popen(
                [*cmd, "-Xptxas", "-v"], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    libs: dict[str, dict] = {v: {} for v in VARIANTS}
    for v, name, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(out[-3000:])
        regs = re.findall(r"\d([a-z_]+)_kernelILi(\d+)ELi(\d+)E.*?\n.*?"
                          r"(\d+) bytes stack.*?\n.*?Used (\d+) registers",
                          out, re.S)
        print(f"build {v}/{name}: registers (stack bytes) "
              + " ".join(f"{k} W={w},C={1 << int(lc)}: {r} ({s})"
                         for k, w, lc, s, r in sorted(regs)), flush=True)
        libs[v][name] = _cuda.load(OUT / v / f"lib{name}.so", name)
    return libs


def device_us(fn, reps: int = 30) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(3_000_000)      # every launch queues behind it
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps * 1e3


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("cluster_variants: no CUDA device")
    libs = build()
    rng = np.random.default_rng(0)
    params = CkksParams.create(logn=15, log_q0=29, log_scale=25, num_levels=22,
                               log_special=31, num_special=8, hamming_weight=192)
    ctx = CkksContext(params)
    L, n = 22, ctx.n

    def res(mods, lead):
        x = np.stack([rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
                      .astype(np.uint32) for q in mods], axis=-2)
        return word_tensor(x, "cuda")

    ft = ctx.fused_ks_tables(L)
    lt, kt = ctx.tables(L), ctx.tables(ctx.key_limbs(L))
    J = kt.q.shape[0]
    c = res(ctx.moduli[:L], ())
    kdata = res(kt.moduli, (2, ft.D))
    cc = tntt.ntt_inverse(c, lt)
    want = tks.switch_key_plain(c, kdata, lt, kt, ft)
    fmd = ctx.fused_md_tables(L)
    tsp = ctx.tables(tuple(ctx.L + i for i in range(ctx.k_sp)))
    xs = res(ctx.moduli[:L] + ctx.special, (2,))
    a = tntt.ntt_inverse(xs[..., L:, :], tsp)
    mwant = tks.mod_down_plain(xs, tsp, lt, fmd)
    # (name, operand, tables, inverse, plain result)
    ntts = [(f"{d} {shape}", x, t, inv,
             (nttmod._intt_stages if inv else nttmod._ntt_stages)(x, t))
            for shape, x, t in (("[22,N]", c, lt),
                                ("[2,8,N]", xs[..., L:, :], tsp))
            for d, inv in (("ntt", False), ("intt", True))]

    for v in VARIANTS:
        for C in tks.cluster_sizes(ctx.logn):
            T, lc = tks.cluster_threads(ctx.logn, C), C.bit_length() - 1
            out = torch.empty((2, 1, J, n), dtype=torch.int32, device="cuda")
            mout = torch.empty((2, L, n), dtype=torch.int32, device="cuda")
            ks_args = tks.ks_fused_args(cc, c, kdata, kt, ft, out, lc, T)
            md_args = tks.md_fused_args(a, xs, lt, fmd, mout, lc, T)
            t_ks = device_us(lambda: _cuda.call(
                "keyswitch", "ks_fused", *ks_args, cdll=libs[v]["keyswitch"]))
            t_md = device_us(lambda: _cuda.call(
                "moddown", "md_fused", *md_args, cdll=libs[v]["moddown"]))
            eq_ks = torch.equal(out.reshape(want.shape), want)
            eq_md = torch.equal(mout, mwant)
            line = [f"key switch {t_ks:.1f} us (equal {eq_ks})",
                    f"mod-down {t_md:.1f} us (equal {eq_md})"]
            equal = eq_ks and eq_md
            for what, x, t, inv, nwant in ntts:
                nout = torch.empty(x.shape, dtype=torch.int32, device="cuda")
                args = tntt.ntt_args(x, t, nout, inv, lc, T)
                entry = "ntt_inverse" if inv else "ntt_forward"
                t_n = device_us(lambda: _cuda.call("ntt", entry, *args,
                                                   cdll=libs[v]["ntt"]))
                eq = torch.equal(nout, nwant)
                equal = equal and eq
                line.append(f"{what} {t_n:.1f} us (equal {eq})")
            print(f"{v:7s} C={C} T={T} W={n // C // T}: " + ", ".join(line),
                  flush=True)
            if v == "base" and not equal:
                raise SystemExit("cluster_variants: base differs from plain")


if __name__ == "__main__":
    t0 = time.time()
    main()
    print(f"done in {time.time() - t0:.0f} s")
