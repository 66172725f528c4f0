"""The port's ResNet driver (fhe_gpt2_tpu_torch/run_resnet.py) held against
the JAX package's on the plain simulator, with the weight loader of both
patched to the same synthetic weights.

Tolerance: exact (the same plans and the same float64 ops give the same
logits). The weights are the ResNet-20 draw of the card's encrypted run
(seed 0, block convs at 0.24/sqrt(c_in)). The drivers draw 32x32 images;
here both run on the top-left 8x8 corner of each (plans, packing and the
float oracle patched alike), which keeps the plans small on the CPU.
"""

import functools
import json
import sys

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu import run_resnet as jrun
from fhe_gpt2_tpu.cnn import resnet as jR

from fhe_gpt2_tpu_torch import run_resnet as run
from fhe_gpt2_tpu_torch.cnn import resnet as R

from torch_port_common import single_torch_thread  # noqa: F401

WEIGHTS = dict(seed=0, block_scale=0.24)
SIDE = 8                      # image side the drivers run at here


def _weights():
    return R.synthetic_weights(np.random.default_rng(WEIGHTS["seed"]), 20,
                               block_scale=WEIGHTS["block_scale"])


def _small_images(monkeypatch, mod):
    """Run a driver's plans, packing and float oracle at SIDE x SIDE."""
    monkeypatch.setattr(mod, "load_reference_weights",
                        lambda depth, dataset: _weights())
    monkeypatch.setattr(mod, "build_resnet_plans", functools.partial(
        mod.build_resnet_plans, h=SIDE))
    pack, oracle = mod.pack_input, mod.forward_float
    monkeypatch.setattr(mod, "pack_input", lambda rp, img: pack(
        rp, img[:, :SIDE, :SIDE]))
    monkeypatch.setattr(mod, "forward_float", lambda w, depth, img: oracle(
        w, depth, img[:, :SIDE, :SIDE]))


def test_plain_driver_equals_reference(monkeypatch, capsys):
    for mod in (R, jR):
        _small_images(monkeypatch, mod)
    logits = {}
    pre_relu = []
    for mod, key in ((run, "got"), (jrun, "ref")):
        inner = mod._result

        def rec(i, got, want, dt, inner=inner, key=key):
            logits[key] = (got, want)
            return inner(i, got, want, dt)
        monkeypatch.setattr(mod, "_result", rec)
    relu = R._relu

    def rec_relu(B, xs, rp):
        pre_relu.append(max(float(np.abs(x).max()) for x in xs))
        return relu(B, xs, rp)
    monkeypatch.setattr(R, "_relu", rec_relu)
    run.main(["--plain", "--cpu", "--sign-log2-err", "-10"])
    got_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["run_resnet", "--plain",
                                      "--sign-log2-err", "-10"])
    jrun.main()
    ref_lines = capsys.readouterr().out.splitlines()
    got, want = logits["got"]
    assert np.array_equal(got, logits["ref"][0])
    assert np.array_equal(want, logits["ref"][1])
    assert np.argmax(got) == np.argmax(want)
    # The driver's ReLU bound is 40: inputs below 40·2^-8 sit in the sign's
    # dead zone.
    assert np.abs(got - want).max() < 0.05
    assert len(pre_relu) == 19 and max(pre_relu) < 0.9
    # The same per-image and summary lines, apart from the seconds.
    rows = [[json.loads(x) for x in lines if x.startswith("{")]
            for lines in (got_lines, ref_lines)]
    assert len(rows[0]) == len(rows[1]) == 2
    for a, b in zip(*rows):
        for d in (a, b):
            d.pop("seconds", None)
            d.pop("seconds_per_image", None)
        assert a == b
    assert rows[0][0]["match"] is True


def test_driver_flags():
    """The JAX driver's flags, --jit among them, and --log-scale (the JAX
    driver's 50 by default); --cpu asks for the CPU."""
    import chip_smoke

    a = run.parse_args(chip_smoke.RESNET_ARGS + ["--cpu"])
    assert (a.composite, a.log_scale, a.real_boot, a.levels, a.nsp,
            a.digit_keys, a.boot_factors, a.start_level, a.headroom) == \
        (True, 54, True, 39, 16, True, 3, 18, 0)
    assert run.parse_args([]).log_scale == 50
    assert run.device_of(a) == "cpu"
    assert run.parse_args(["--composite"]).nsp == 3
    assert run.parse_args(["--real-boot"]).levels == 30
    assert run.parse_args(["--jit"]).jit and not a.jit
    with pytest.raises(SystemExit):
        run.parse_args(["--jit", "1"])


def test_driver_without_card_raises(monkeypatch):
    """Without --cpu the driver needs a card: with none it raises before
    doing anything, and never drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        run.main(["--plain"])


def test_chip_smoke_resnet_plain_at_small_size():
    """chip_smoke.resnet_plain, the host half of the card's "resnet" phase
    (the card runs it at 32x32 and 16384 slots), at 8x8 and 1024 slots:
    the same weights and ReLU plans (bound 10, sign dp_schedule(2^-10,
    2^-8)), every normalized pre-ReLU input below 0.9, inside the sign's
    domain, and the plain argmax the float oracle's."""
    import chip_smoke

    net = chip_smoke.resnet_plain(h=SIDE, slots=1024)
    assert net["rp"].relu_need == 16 and net["relus"] == 19
    assert net["pre_relu_max"] < 0.9
    assert np.argmax(net["plain"]) == np.argmax(net["want"])
    assert np.abs(net["plain"] - net["want"]).max() < 0.01


def test_u64_default_session_on_the_crop(monkeypatch):
    """The default flags (--word 64, no --composite) on the CPU: the JAX
    driver's u64 chain (q0 51 bits, 46-bit scale, 51-bit special, one
    special prime), and a session on the 8x8 crop's plans (1024 slots,
    logN=11, 4 levels, digit keys) that encrypts the packed image into
    int64 words and decrypts it back."""
    from fhe_gpt2_tpu.core.context import CkksParams as JParams
    a = run.parse_args(["--cpu", "--logn", "11", "--levels", "4",
                        "--digit-keys"])
    assert (a.word, a.composite, a.nsp) == (64, False, 1)
    params = run.make_params(a)
    want = JParams.create(logn=11, log_q0=51, log_scale=46, num_levels=4,
                          log_special=51, num_special=1, hamming_weight=192)
    assert vars(params) == vars(want)
    # The driver's sign at --sign-log2-err -10 (its cache file is there).
    from fhe_gpt2_tpu_torch.approx.minimax import dp_schedule
    from fhe_gpt2_tpu_torch.nn import kernels as K
    sign = K.SignPlans.from_composite(dp_schedule(target_err=2.0 ** -10,
                                                  eps=2.0 ** -8))
    rp = R.build_resnet_plans(_weights(), 20, 1024, h=SIDE, sign=sign)
    img = np.random.default_rng(0).uniform(-1, 1, (3, SIDE, SIDE))
    ses = run.build_session(a, rp, img)
    assert ses.ctx.dtype == torch.int64 and ses.ctx.device.type == "cpu"
    packed = R.pack_input(rp, img)
    cts = [ses.B.from_slots(v) for v in packed]
    assert all(c.data.dtype == torch.int64 for c in cts)
    assert cts[0].level == run.input_level(a, ses.ctx) == 4
    back = np.stack([ses.B.to_slots(c) for c in cts])
    assert np.abs(back - np.stack(packed)).max() < 1e-6


def test_u64_help_names_the_engine():
    """--word's help describes both words; nothing says the port lacks
    the u64 engine."""
    import io
    from contextlib import redirect_stdout
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(SystemExit):
        run.parse_args(["--help"])
    text = " ".join(buf.getvalue().split())
    assert "64 = u64 moduli" in text and "does not have" not in text
