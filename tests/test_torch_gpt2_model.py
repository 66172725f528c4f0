"""The port's GPT-2 model (nn/model.py) and calibration (nn/calibrate.py)
held against the JAX package's on the plain simulator, and its float64
oracle against ``transformers``.

Tolerance: exact against the JAX package (the same numpy code, and the same
torch ops in ``train_consmax``): plans, inits, knobs, trained ConsMax β/γ
and the plain forward are equal. ``forward_float`` is within 1e-9 of HF's
``GPT2Model`` in float64 on the same weights (HF's random init and
``synthetic_weights``).
"""

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu.nn import calibrate as jC
from fhe_gpt2_tpu.nn import model as jM
from fhe_gpt2_tpu.nn.backend import PlainBackend as JPlainBackend

from fhe_gpt2_tpu_torch.nn import calibrate as C
from fhe_gpt2_tpu_torch.nn import model as M
from fhe_gpt2_tpu_torch.nn.backend import PlainBackend

from torch_gpt2_common import JSH, SH, same_array, same_block_plans, \
    same_ln_plans, same_values

LAYERS, VOCAB = 2, 97


@pytest.fixture(scope="module")
def hf():
    """tests/test_gpt2_model.py's tiny GPT-2 (HF random init, torch seed
    0): the torch model and its state dict."""
    from transformers import GPT2Config, GPT2LMHeadModel
    torch.manual_seed(0)
    cfg = GPT2Config(vocab_size=VOCAB, n_positions=16, n_embd=32,
                     n_layer=LAYERS, n_head=4, resid_pdrop=0.0,
                     embd_pdrop=0.0, attn_pdrop=0.0)
    net = GPT2LMHeadModel(cfg).double().eval()
    return net, dict(net.state_dict())


def _synthetic():
    return M.synthetic_weights(np.random.default_rng(0), LAYERS, 32, 4,
                               VOCAB, 16)


@pytest.fixture(scope="module", params=["hf", "synthetic"])
def weights(request, hf):
    return hf[1] if request.param == "hf" else _synthetic()


IDS = np.arange(16) % VOCAB


def _emb(weights):
    return M.embed(M.build_gpt2_plans(SH, weights, 0), IDS)


def test_calibration_equals_reference(weights):
    emb = _emb(weights)
    assert np.array_equal(emb, jM.embed(jM.build_gpt2_plans(JSH, weights, 0),
                                        IDS))
    inits = M.calibrate_newton_inits(SH, weights, LAYERS, emb)
    assert inits == jM.calibrate_newton_inits(JSH, weights, LAYERS, emb)
    knobs = C.calibrate_attn_knobs(SH, weights, LAYERS, emb)
    assert knobs.as_overrides() == jC.calibrate_attn_knobs(
        JSH, weights, LAYERS, emb).as_overrides()


def _both_plans(weights, **kw):
    emb = _emb(weights)
    inits = M.calibrate_newton_inits(SH, weights, LAYERS, emb)
    knobs = C.calibrate_attn_knobs(SH, weights, LAYERS, emb).as_overrides()
    return emb, [mod.build_gpt2_plans(sh, weights, LAYERS,
                                      newton_inits=inits,
                                      attn_overrides=knobs, **kw)
                 for mod, sh in ((M, SH), (jM, JSH))]


def test_plans_and_plain_forward_equal_reference(weights):
    emb, (plans, jplans) = _both_plans(weights, ln_iters=8)
    for bp, jbp in zip(plans.blocks, jplans.blocks):
        same_block_plans(bp, jbp)
    same_ln_plans(plans.ln_f, jplans.ln_f)
    same_array(plans.wte, jplans.wte)
    same_array(plans.wpe, jplans.wpe)
    out = M.forward(PlainBackend(SH.slots), list(SH.act.pack(emb)), plans)
    jout = jM.forward(JPlainBackend(JSH.slots), list(JSH.act.pack(emb)),
                      jplans)
    for g, w in zip(out, jout):
        same_array(g, w)
    got = SH.act.unpack(np.stack(out))
    same_array(M.logits(plans, got), jM.logits(jplans, got))


def test_fit_consmax_gamma_equals_reference():
    s = np.random.default_rng(0).normal(3.0, 1.0, (64, 16))
    assert C.fit_consmax_gamma(s) == jC.fit_consmax_gamma(s)
    assert C.fit_consmax_gamma(s, lo=0.0, hi=10.0, iters=20) == \
        jC.fit_consmax_gamma(s, lo=0.0, hi=10.0, iters=20)


def test_train_consmax_equals_reference(hf):
    weights = hf[1]
    emb = _emb(weights)
    betas, gammas = C.train_consmax(SH, weights, LAYERS, emb, iters=40)
    jbetas, jgammas = jC.train_consmax(JSH, weights, LAYERS, emb, iters=40)
    assert len(betas) == LAYERS and betas[0].shape == (SH.heads,)
    for a, b in zip(betas + gammas, jbetas + jgammas):
        same_array(a, b)
    # The trained β/γ drive the consmax plans on both packages alike.
    over = dict(softmax_mode="consmax", consmax_beta=betas,
                consmax_gamma=gammas, exp_r=8)
    plans = M.build_gpt2_plans(SH, weights, LAYERS, attn_overrides=over)
    jplans = jM.build_gpt2_plans(JSH, weights, LAYERS, attn_overrides=over)
    for bp, jbp in zip(plans.blocks, jplans.blocks):
        same_block_plans(bp, jbp)


def test_forward_jit_and_boot_need_equal_reference(hf):
    """The segment driver (jit=True; with boot_need, a maybe_bootstrap
    before each segment) on the plain simulator, where a refresh is the
    identity and a segment runs as it is: the JAX package's eager forward,
    value for value, and the port's own eager forward."""
    _, (plans, jplans) = _both_plans(hf[1])
    xs = list(SH.act.pack(_emb(hf[1])))
    jout = jM.forward(JPlainBackend(JSH.slots), list(xs), jplans)
    out = M.forward(PlainBackend(SH.slots), list(xs), plans)
    same_values(out, jout, "eager")
    for need in (0, 1):
        got = M.forward(PlainBackend(SH.slots), list(xs), plans, jit=True,
                        boot_need=need)
        same_values(got, jout, f"jit, boot_need={need}")


def _hf_model(weights):
    """HF's GPT2Model in float64 holding ``weights``."""
    from transformers import GPT2Config, GPT2Model
    wte = np.asarray(weights["transformer.wte.weight"])
    wpe = np.asarray(weights["transformer.wpe.weight"])
    cfg = GPT2Config(vocab_size=wte.shape[0], n_positions=wpe.shape[0],
                     n_embd=wte.shape[1], n_layer=LAYERS, n_head=4)
    net = GPT2Model(cfg).double().eval()
    state = {k[len("transformer."):]: torch.as_tensor(np.asarray(v))
             for k, v in weights.items() if k.startswith("transformer.")}
    missing, unexpected = net.load_state_dict(state, strict=False)
    assert not unexpected and all(".attn." in k for k in missing), missing
    return net


def test_forward_float_equals_transformers(weights):
    net = _hf_model(weights)
    with torch.no_grad():
        want = net(torch.tensor(IDS[None])).last_hidden_state[0].numpy()
    got = M.forward_float(weights, IDS, LAYERS, 4)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-9


def test_synthetic_weights_have_every_key_and_shape(hf):
    """Every key and shape of HF's GPT2LMHeadModel state dict that
    build_gpt2_plans reads (all but the attention mask buffers and the tied
    LM head), drawn at GPT-2's init scale (the embeddings at 0.05)."""
    w = _synthetic()
    want = {k: tuple(v.shape) for k, v in hf[1].items()
            if not k.endswith((".attn.bias", ".attn.masked_bias"))
            and k != "lm_head.weight"}
    assert {k: v.shape for k, v in w.items()} == want
    big = M.synthetic_weights(np.random.default_rng(1), 1, 768, 12, 50257,
                              1024)
    p = "transformer.h.0."
    for k, std in (("transformer.wte.weight", 0.05),
                   (p + "attn.c_attn.weight", 0.02),
                   (p + "attn.c_proj.weight", 0.02 / np.sqrt(24)),
                   (p + "mlp.c_proj.weight", 0.02 / np.sqrt(24)),
                   (p + "mlp.c_fc.bias", 0.02)):
        assert abs(big[k].std() / std - 1) < 0.05, k
    g = big[p + "ln_1.weight"]
    assert g.min() >= 0.8 and g.max() <= 1.2 and abs(g.mean() - 1) < 0.02
    # Both packages build their plans from it.
    plans = M.build_gpt2_plans(SH, w, LAYERS)
    jplans = jM.build_gpt2_plans(JSH, w, LAYERS)
    for bp, jbp in zip(plans.blocks, jplans.blocks):
        same_block_plans(bp, jbp)


def test_mean_newton_inits_diverge_on_both_packages():
    """Reference behaviour, not a port fault: calibrate_newton_inits seeds
    each LayerNorm's Newton rsqrt at the MEAN of Σz² over rows, and the
    Taylor seed goes negative above about three times its centre, so a row
    far above the mean diverges. One token's embedding scaled by 4 puts its
    row at 5.5x the mean: both packages give the same non-finite hidden
    state. Seeds at 1.25x the largest row (rowmax_newton_inits) converge
    and track the float oracle."""
    w = M.synthetic_weights(np.random.default_rng(0), 1, 32, 4, VOCAB, 16)
    w["transformer.wte.weight"][5] *= 4.0
    emb = _emb(w)
    want = M.forward_float(w, IDS, 1, 4)
    knobs = C.calibrate_attn_knobs(SH, w, 1, emb).as_overrides()
    mean = M.calibrate_newton_inits(SH, w, 1, emb)
    assert mean == jM.calibrate_newton_inits(JSH, w, 1, emb)
    rowmax = M.rowmax_newton_inits(w, IDS, 1, 4)
    outs = {}
    with np.errstate(all="ignore"):
        for name, inits in (("mean", mean), ("rowmax", rowmax)):
            got = [SH.act.unpack(np.stack(mod.forward(
                B(SH.slots), list(SH.act.pack(emb)), mod.build_gpt2_plans(
                    sh, w, 1, newton_inits=inits, attn_overrides=knobs))))
                for mod, sh, B in ((M, SH, PlainBackend),
                                   (jM, JSH, JPlainBackend))]
            same_array(*got, name)
            outs[name] = got[0]
    assert not np.isfinite(outs["mean"]).all()
    assert np.isfinite(outs["rowmax"]).all()
    assert np.abs(outs["rowmax"] - want).max() < 0.05
    assert (M.logits(M.build_gpt2_plans(SH, w, 0), outs["rowmax"]).argmax(-1)
            == (want @ w["transformer.wte.weight"].T).argmax(-1)).all()


def test_rowmax_inits_cover_every_row(weights):
    taps = M.ln_input_sums(weights, IDS, LAYERS, 4)
    inits = M.rowmax_newton_inits(weights, IDS, LAYERS, 4)
    assert len(inits) == LAYERS + 1
    for (a, b), (i1, i2) in zip(taps, inits):
        assert i1 == 1.25 * a.max() and i2 == 1.25 * b.max()
