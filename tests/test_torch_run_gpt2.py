"""The port's GPT-2 driver (fhe_gpt2_tpu_torch/run_gpt2.py) held against the
JAX package's on the plain simulator, and its synthetic-weight path without
``transformers``.

Tolerance: exact. Both drivers build the same HF weights (torch seed 0),
plans and calibration and run the same float64 ops, so they print the same
JSON numbers, apart from the seconds.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fhe_gpt2_tpu import run_gpt2 as jrun

from fhe_gpt2_tpu_torch import run_gpt2 as run

from torch_port_common import single_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _json_lines(text):
    rows = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    for r in rows:
        r.pop("seconds", None)
    return rows


def test_plain_driver_equals_reference(monkeypatch, capsys):
    """--plain at the drivers' default tiny shape (2 layers, 32 wide, 4
    heads, seq 16), with two KV-cache decode steps."""
    run.main(["--plain", "--cpu", "--decode", "2"])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["run_gpt2", "--plain", "--decode",
                                      "2"])
    jrun.main()
    want = capsys.readouterr().out
    assert [x for x in got.splitlines() if x.startswith("# calibrated")] == \
        [x for x in want.splitlines() if x.startswith("# calibrated")]
    rows = _json_lines(got)
    assert len(rows) == 3 and rows == _json_lines(want)
    assert rows[0]["mode"] == "plain" and rows[0]["top1_agreement"] >= 0.9


def test_synthetic_weights_need_no_transformers():
    """--weights synthetic runs where importing transformers fails, and
    --weights hf then raises: the flag chooses the weights, never a failed
    import."""
    code = (
        "import sys\n"
        "sys.modules['transformers'] = None\n"
        "from fhe_gpt2_tpu_torch import run_gpt2\n"
        "run_gpt2.main(['--plain', '--cpu', '--layers', '1', '--weights',"
        " 'synthetic', '--newton-inits', 'rowmax'])\n"
        "try:\n"
        "    run_gpt2.main(['--plain', '--cpu', '--layers', '1'])\n"
        "except ImportError:\n"
        "    print('hf needs transformers')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    [row] = _json_lines(r.stdout)
    assert row["mode"] == "plain" and row["top1_agreement"] == 1.0
    assert row["max_err_vs_torch"] < 0.05
    assert r.stdout.strip().endswith("hf needs transformers")


def test_driver_flags():
    """The JAX driver's flags, --jit and --boot-need among them, and
    --log-scale (the JAX driver's 50 by default), --weights (hf by
    default) and --newton-inits (mean by default)."""
    import chip_smoke

    a = run.parse_args(chip_smoke.GPT2_ARGS + ["--cpu"])
    assert (a.layers, a.seq, a.hidden, a.heads, a.composite, a.logn,
            a.levels, a.log_scale, a.nsp, a.digit_keys, a.weights,
            a.newton_inits, a.ln_iters, a.real_boot, a.boot_need) == \
        (1, 16, 768, 12, True, 15, 39, 54, 16, True, "synthetic", "rowmax",
         13, False, 0)
    d = run.parse_args([])
    assert (d.log_scale, d.weights, d.newton_inits, d.ln_iters) == \
        (50, "hf", "mean", 12)
    assert run.device_of(a) == "cpu"
    j = run.parse_args(["--jit", "--boot-need", "3"])
    assert (j.jit, j.boot_need, a.jit) == (True, 3, False)
    for bad in (["--boot-need", "x"], ["--weights", "gpt2"]):
        with pytest.raises(SystemExit):
            run.parse_args(bad)


def test_driver_without_card_raises(monkeypatch):
    """Without --cpu the driver needs a card: with none it raises before
    doing anything, and never drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        run.main(["--plain"])


def test_chip_smoke_gpt2_plain_at_small_size():
    """chip_smoke.gpt2_plain, the host half of the card's "gpt2" phase (the
    card runs it at GPT-2 small's width, 768 wide and 12 heads, at 16384
    slots), at 32 wide with 4 heads and 1024 slots: the plain run against
    the float oracle, every LayerNorm's rowmax seed above each of its rows,
    and the masks the block's matmuls encode."""
    import chip_smoke

    args = [x for x in chip_smoke.GPT2_ARGS]
    args[args.index("--hidden") + 1] = "32"
    args[args.index("--heads") + 1] = "4"
    args[args.index("--logn") + 1] = "11"
    net = chip_smoke.gpt2_plain(args + ["--cpu"])
    assert net["top1"] == 1.0 and net["max_err_float"] < 0.05
    assert all(r < 0.8 + 1e-9 for r in net["ln_row_ratio"])
    sh = net["model"].sh
    assert (sh.slots, sh.act.n_cts) == (1024, 1)
    # 12 matmuls of 2·32 − 1 diagonals on one ciphertext.
    assert net["masks"] == 12 * 63
    assert np.isfinite(net["plain"]).all()


def test_u64_default_session_at_the_tiny_shape():
    """Without --composite the chain is the JAX driver's u64 one (q0 50
    bits, 40-bit scale, 51-bit special, h=64): a session at the drivers'
    default tiny shape (1 layer, 32 wide, 4 heads, 1024 slots) on the
    CPU, 8 levels, whose encryption of the embedded activations is int64
    words and decrypts back. (One encrypted block on this chain takes
    minutes on a CPU host: the card runs the u64 engine, chip_smoke.py
    phase 9.)"""
    from fhe_gpt2_tpu.core.context import CkksParams as JParams
    a = run.parse_args(["--cpu", "--layers", "1", "--logn", "11",
                        "--levels", "8", "--weights", "synthetic"])
    assert not a.composite and a.nsp == 1
    m = run.load_model(a)
    ses = run.build_session(a, m)
    want = JParams.create(logn=11, log_q0=50, log_scale=40, num_levels=8,
                          log_special=51, num_special=1, hamming_weight=64)
    assert vars(ses.ctx.params) == vars(want)
    assert ses.ctx.dtype == torch.int64
    packed = m.sh.act.pack(m.emb)
    cts = [ses.B.from_slots(v) for v in packed]
    assert all(c.data.dtype == torch.int64 for c in cts)
    back = np.stack([ses.B.to_slots(c) for c in cts])
    assert np.abs(back - np.stack(packed)).max() < 1e-6
