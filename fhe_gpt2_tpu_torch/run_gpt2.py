"""Encrypted GPT-2 inference driver on the port.

The port's counterpart of ``fhe_gpt2_tpu/run_gpt2.py`` (itself the
counterpart of the reference's run/infer_gpt2.cpp): builds the model plans
from GPT-2 weights, embeds tokens, runs the transformer blocks and the final
LayerNorm, and prints the hidden state's fidelity against a float oracle as
one JSON line.

    python -m fhe_gpt2_tpu_torch.run_gpt2 --layers 2 --plain --cpu
    python -m fhe_gpt2_tpu_torch.run_gpt2 --layers 1 --logn 12 --composite

The flags are the JAX driver's, except that --cpu asks for the CPU device
(without it the driver runs on the CUDA card, and raises when there is
none), and three flags choose inputs that the JAX driver fixes: --log-scale
sets the composite chain's scale (the JAX driver's 50 is the default),
--weights synthetic draws GPT-2-small-format
weights from numpy seed 0 and takes the float64 oracle ``forward_float``
(no ``transformers`` needed; the default ``hf`` builds HF's randomly
initialized GPT-2 as the JAX driver does), and --newton-inits rowmax seeds
each LayerNorm's Newton rsqrt at 1.25 times the float forward's largest row
in place of the mean (the default). --jit runs the segment driver (four
sealed programs per block, CUDA graphs on the card, each layer with its
own), and --boot-need N
refreshes, outside the programs, each segment input with N logical levels
or fewer left. --trace PATH turns the port's recorder
(``utils/telemetry.py``) and ``torch.profiler`` on over the run and writes
the spans, counters and device trace to PATH as one Chrome-trace JSON, with
the device's idle seconds by the innermost span beside them. One block at
GPT-2 small's width on the
80-limb composite chain, with the decrypt/re-encrypt refresh, is

    python -m fhe_gpt2_tpu_torch.run_gpt2 --layers 1 --hidden 768 \\
        --heads 12 --composite --logn 15 --levels 39 --log-scale 54 \\
        --nsp 16 --digit-keys --weights synthetic --newton-inits rowmax \\
        --ln-iters 13

(13 Newton iterations: the count sets where the refreshes land, and with
the default 12 the exp ladder runs where the scale drifts past what the
mask after it can be encoded at; tools/gpt2_refreshes.py shows where each
refresh lands.)
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass

import numpy as np

# --weights synthetic: GPT-2's vocabulary and context length.
GPT2_VOCAB, GPT2_POSITIONS = 50257, 1024


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--logn", type=int, default=12)
    ap.add_argument("--slots", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=40)
    ap.add_argument("--nsp", type=int, default=1,
                    help="special primes (hybrid key-switch digit size)")
    ap.add_argument("--composite", action="store_true",
                    help="uint32 engine with composite two-prime scaling "
                         "(Δ = q·q′ ≈ 2^log_scale); --levels counts pairs. "
                         "Without it the chain is u64 (50-bit q0, 40-bit "
                         "scale; int64 PyTorch ops, no kernel)")
    ap.add_argument("--log-scale", type=int, default=50,
                    help="composite chain: Δ ≈ 2^log_scale, Q0 ≈ "
                         "2^(log_scale+5)")
    ap.add_argument("--real-boot", action="store_true",
                    help="use the real CKKS bootstrap as the refresh "
                         "(default: decrypt/re-encrypt to the chain top)")
    ap.add_argument("--jit", action="store_true",
                    help="segment driver: four sealed programs per block "
                         "(LN1/attn/LN2/MLP; CUDA graphs on the card), "
                         "layers with equal constants sharing one")
    ap.add_argument("--boot-need", type=int, default=0,
                    help="logical levels of headroom demanded before each "
                         "segment under --jit (maybe_bootstrap); 0 = no "
                         "between-segment refreshes")
    ap.add_argument("--ln-iters", type=int, default=12,
                    help="LayerNorm Newton rsqrt iterations")
    ap.add_argument("--digit-keys", action="store_true",
                    help="base-16 digit rotation key set instead of exact "
                         "per-step keys")
    ap.add_argument("--decode", type=int, default=0, metavar="N",
                    help="after the forward, run N autoregressive KV-cache "
                         "decode steps and report per-step seconds + row "
                         "parity vs the forward pass")
    ap.add_argument("--weights", default="hf", choices=["hf", "synthetic"],
                    help="hf: HF's randomly initialized GPT-2 (torch seed "
                         "0; needs transformers), oracle GPT2Model. "
                         "synthetic: model.synthetic_weights (numpy seed 0, "
                         "GPT-2's vocabulary and positions), oracle "
                         "model.forward_float")
    ap.add_argument("--newton-inits", default="mean",
                    choices=["mean", "rowmax"],
                    help="LayerNorm Newton seeds: mean = "
                         "calibrate_newton_inits (mean Σz² over rows); "
                         "rowmax = 1.25 x the largest row's Σz² in the float "
                         "forward (model.rowmax_newton_inits)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch versions of the "
                         "kernels); without it the driver needs a CUDA card")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the port's spans and counters and a "
                         "torch.profiler device trace of the run to PATH "
                         "(Chrome-trace JSON, utils/telemetry.trace)")
    return ap.parse_args(argv)


def device_of(a) -> str:
    """The run's device: the CPU on --cpu, else the card (the context
    raises when there is none; nothing drops to the CPU on its own)."""
    from .core.context import resolve_device
    return str(resolve_device("cpu" if a.cpu else None))


@dataclass
class Model:
    """What a run computes on: the shapes, the weights, the token ids and
    their embedding, the calibrated plans, the oracle's last hidden state
    and the seconds the plans took."""

    sh: object
    weights: dict
    ids: np.ndarray
    emb: np.ndarray
    plans: object
    knobs: object
    want: np.ndarray
    plans_s: float


def load_model(a) -> Model:
    """Weights (--weights), token ids from numpy seed 0, the calibrated
    plans (attention knobs from the plain activations, Newton seeds by
    --newton-inits) and the oracle's last hidden state."""
    from .nn import layers as L
    from .nn import model as M
    from .nn.calibrate import calibrate_attn_knobs

    if a.weights == "hf":
        import torch
        from transformers import GPT2Config, GPT2LMHeadModel

        torch.manual_seed(0)
        cfg = GPT2Config(vocab_size=997, n_positions=max(a.seq, 16),
                         n_embd=a.hidden, n_layer=a.layers, n_head=a.heads)
        net = GPT2LMHeadModel(cfg).double().eval()
        weights = dict(net.state_dict())
        vocab = cfg.vocab_size
    else:
        weights = M.synthetic_weights(np.random.default_rng(0), a.layers,
                                      a.hidden, a.heads, GPT2_VOCAB,
                                      GPT2_POSITIONS)
        vocab = GPT2_VOCAB
    slots = a.slots if a.plain else (1 << (a.logn - 1))
    sh = L.GPT2Shapes(slots=slots, seq=a.seq, hidden=a.hidden, heads=a.heads)

    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, a.seq)
    t0 = time.time()
    emb = M.embed(M.build_gpt2_plans(sh, weights, 0), ids)
    if a.newton_inits == "rowmax":
        inits = M.rowmax_newton_inits(weights, ids, a.layers, a.heads)
    else:
        inits = M.calibrate_newton_inits(sh, weights, a.layers, emb)
    knobs = calibrate_attn_knobs(sh, weights, a.layers, emb[: a.seq])
    print(f"# calibrated knobs: {knobs}")
    plans = M.build_gpt2_plans(
        sh, weights, a.layers, newton_inits=inits,
        attn_overrides=knobs.as_overrides(), ln_iters=a.ln_iters)
    plans_s = time.time() - t0

    if a.weights == "hf":
        with torch.no_grad():
            want = net.transformer(
                torch.tensor(ids[None])).last_hidden_state[0].numpy()
    else:
        want = M.forward_float(weights, ids, a.layers, a.heads)
    return Model(sh=sh, weights=weights, ids=ids, emb=emb, plans=plans,
                 knobs=knobs, want=want, plans_s=plans_s)


def main(argv=None):
    a = parse_args(argv)
    device_of(a)
    if not a.trace:
        return _main(a)
    from .utils import telemetry
    with telemetry.trace(a.trace) as summary:
        _main(a)
    print(json.dumps({"trace": a.trace,
                      "idle_by_span": summary["idle_by_span"][:10]}))


def _main(a):
    from .nn import model as M
    from .nn.backend import PlainBackend

    m = load_model(a)
    sh, plans = m.sh, m.plans
    t0 = time.time()
    if a.plain:
        B = PlainBackend(sh.slots)
        got = plain_forward(m)
    else:
        ses = build_session(a, m)
        B = ses.B
        got = encrypted_forward(ses, m, jit=a.jit, boot_need=a.boot_need)
    dt = time.time() - t0
    err = float(np.abs(got - m.want).max())
    agree = float((M.logits(plans, got).argmax(-1)
                   == M.logits(plans, m.want).argmax(-1)).mean())
    print(json.dumps({"layers": a.layers, "mode": "plain" if a.plain else "enc",
                      "seconds": round(dt, 2), "max_err_vs_torch": err,
                      "top1_agreement": agree}))
    if a.decode:
        from .nn import kvcache as KV
        caches = KV.KVCaches.empty(B, sh, len(plans.blocks))
        for t in range(min(a.decode, a.seq)):
            t0 = time.time()
            row = KV.decode_step(B, plans, caches, m.emb[t], t)
            print(json.dumps({
                "decode_step": t, "seconds": round(time.time() - t0, 2),
                "row_err_vs_forward": float(np.abs(row - got[t]).max())}))


def plain_forward(m: Model) -> np.ndarray:
    """The slot-exact plain run (no crypto): the last hidden state."""
    from .nn import model as M
    from .nn.backend import PlainBackend

    out = M.forward(PlainBackend(m.sh.slots), list(m.sh.act.pack(m.emb)),
                    m.plans)
    return m.sh.act.unpack(np.stack(out))


@dataclass
class Session:
    """What the encrypted run is built on: the context, the key generator,
    the backend (with its Bootstrapper under --real-boot, else the decrypt/
    re-encrypt refresh), the decryptor and the set-up seconds."""

    ctx: object
    kg: object
    B: object
    dec: object
    keygen_s: float
    galois_keys: int


def build_session(a, m: Model, forward=None) -> Session:
    """Context, keys and backend of an encrypted run, on the device of
    ``device_of(a)``. The rotation set is recorded from one plain forward
    (and the decode steps under --decode), or is the base-16 digit set
    under --digit-keys (and nothing is recorded). `forward(B, xs, plans)`
    is the model's forward the rotations are recorded from (default
    GPT-2's, ``nn/model.forward``)."""
    import torch

    from .core.context import CkksContext, CkksParams
    from .core.evaluator import Decryptor, Encryptor, Evaluator
    from .core.keys import KeyGenerator
    from .nn import model as M
    from .nn.backend import CkksBackend, RecordingBackend

    device = device_of(a)
    sh, plans = m.sh, m.plans
    steps = set()
    if not a.digit_keys:
        rec = RecordingBackend(sh.slots)
        (forward or M.forward)(rec, list(sh.act.pack(m.emb)), plans)
        steps = set(rec.key_steps())
    if a.composite:
        params = CkksParams.create_composite(
            logn=a.logn, num_levels=a.levels, log_scale=a.log_scale,
            log_q0=a.log_scale + 5, log_special=31,
            num_special=max(a.nsp, 3), hamming_weight=64)
    else:
        params = CkksParams.create(
            logn=a.logn, log_q0=50, log_scale=40, num_levels=a.levels,
            log_special=51, num_special=a.nsp, hamming_weight=64)
    ctx = CkksContext(params, device=device)
    levels = len(params.moduli) if a.composite else a.levels
    assert ctx.params.slots == sh.slots
    t_keys = time.time()
    kg = KeyGenerator(ctx, seed=1)
    ev = Evaluator(ctx, relin_key=kg.relin_key())
    enc = Encryptor(ctx, secret=kg.secret, seed=2)
    dec = Decryptor(ctx, kg.secret)
    B = CkksBackend(ctx=ctx, ev=ev, enc=enc, dec=dec, default_level=levels)
    if a.real_boot:
        from .boot.bootstrap import Bootstrapper, make_evalmod
        eps = params.scale / ctx.q0_float
        # Production window on the composite engine (K=25/deg59, the
        # h=192 reference window); the small K=12/deg45 window otherwise.
        if a.composite:
            em = make_evalmod(K=25, eps=max(eps * 1.05, 2 ** -5), degree=59,
                              arcsin_degree=3, prec_dps=80)
        else:
            em = make_evalmod(K=12, eps=max(eps * 1.05, 2 ** -5), degree=45,
                              arcsin_degree=3, prec_dps=60)
        B.boot = Bootstrapper(B, evalmod=em)
        steps.update(B.boot.required_steps())
    if a.decode:
        from .nn import kvcache as KV
        rec = RecordingBackend(sh.slots)
        rc = KV.KVCaches.empty(rec, sh, len(plans.blocks))
        for t in range(min(a.decode, a.seq)):
            KV.decode_step(rec, plans, rc, m.emb[t], t)
        steps.update(rec.key_steps())
    if a.digit_keys:
        from .core.keys import digit_steps
        steps = set(digit_steps(ctx.params.slots, base=16))
    ev.galois_keys = kg.galois_keys(steps=sorted(steps), conjugate=True)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    return Session(ctx=ctx, kg=kg, B=B, dec=dec,
                   keygen_s=time.time() - t_keys,
                   galois_keys=len(ev.galois_keys.keys))


def encrypted_forward(ses: Session, m: Model, jit: bool = False,
                      boot_need: int = 0) -> np.ndarray:
    """Encrypt the embedded activations, run the forward on the session's
    backend (the segment driver under jit, with boot_need) and decrypt: the
    last hidden state [seq, hidden]."""
    from .nn import model as M

    B, sh = ses.B, m.sh
    xs = [B.from_slots(v) for v in sh.act.pack(m.emb)]
    out = M.forward(B, xs, m.plans, jit=jit, boot_need=boot_need)
    return sh.act.unpack(np.stack([B.to_slots(o) for o in out]))


if __name__ == "__main__":
    main()
