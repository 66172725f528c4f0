"""Tiny dry runs of every cell on the CPU (the kernels' plain versions),
the output check's faults and its controls.

A tiny run keeps each cell's driver, traffic kind and check and shrinks
what the CPU cannot hold: logN = 10 chains (the composite chain of the
port's sealed-driver tests, 39 or 40 pairs), a 4x4 image, GPT-2 at 32
wide, one pool entry and one block per request kind. Each fault breaks
the program underneath the timed path and must turn ``correct`` false;
each control must read three times the program's number or more.

    python -m pytest fhe_bench -q -p no:cacheprovider -n 4
"""

import json

import numpy as np
import pytest

from fhe_bench import control, harness

TINY_RESNET = ["--composite", "--logn", "10", "--levels", "39",
               "--log-scale", "50", "--nsp", "4", "--hamming", "16",
               "--real-boot", "--digit-keys", "--boot-factors", "3",
               "--start-level", "18", "--headroom", "0",
               "--sign-log2-err", "-10"]
TINY_GPT2 = ["--layers", "1", "--seq", "16", "--hidden", "32", "--heads",
             "4", "--composite", "--logn", "10", "--levels", "40",
             "--log-scale", "54", "--nsp", "4", "--digit-keys", "--weights",
             "synthetic", "--newton-inits", "rowmax", "--ln-iters", "13"]
TINY_TRAFFIC = {"stage1": {"blocks": [0], "pool_images": 1},
                "ln1_seq16": {"pool": 2},
                "boot_stream": {"pool": 1}}
SEED = 3000000017
CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A BENCHMARK.json spec whose configurations and traffic mixes are
    the tiny ones, the harness pointed at them."""
    spec = harness.load_spec()
    for c in spec["configs"]:
        cfg = json.loads((harness.REPO / c["file"]).read_text())
        if cfg["name"] == "gpt2-small":
            cfg.update(n_embd=32, n_head=4, flags=TINY_GPT2)
        else:
            cfg.update(image=[3, 4, 4], flags=TINY_RESNET)
        c["file"] = str(tmp_path / f"{cfg['name']}.json")
        (tmp_path / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for name, small in TINY_TRAFFIC.items():
        t = json.loads((harness.TRAFFIC / f"{name}.json").read_text())
        t.update(small, check_share=1.0)
        (tmp_path / f"{name}.json").write_text(json.dumps(t))
    monkeypatch.setattr(harness, "TRAFFIC", tmp_path)
    return spec


def run(spec, cell, **kw):
    return harness.measure(cell, SEED, 0.01, False, device="cpu", spec=spec,
                           **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run(tiny, cell):
    result, checks, r, _ = run(tiny, cell)
    assert result["correct"], checks
    assert result["attempted"] == r.requests >= 1
    names = {m["name"] for m in harness.metrics_of(tiny, cell, False)}
    assert set(result["metrics"]) == names
    assert list(result)[-1] == "checks"
    assert not harness.forbidden_loaded()


def _bump(B, v):
    """v with 0.5 added to its first slot."""
    e = np.zeros(B.slots)
    e[0] = 0.5
    return B.add_plain(v, e)


def _resnet_fault(monkeypatch, kind):
    from fhe_gpt2_tpu_torch.cnn import resnet as R
    real = R.forward_segments

    def broken(B, rp, boot_between=True):
        segs = real(B, rp, boot_between)
        if kind == "unchanged":
            return [lambda xs: xs for _ in segs]
        return [lambda xs, s=s: [_bump(B, s(xs)[0])] for s in segs]
    monkeypatch.setattr(R, "forward_segments", broken)


def _ln_fault(monkeypatch, kind):
    from fhe_gpt2_tpu_torch.nn import layers as L
    real = L.layer_norm

    def broken(B, xs, sh, ln):
        if kind == "unchanged":
            return list(xs)
        out = real(B, xs, sh, ln)
        if kind == "half":
            return [out[0], out[0]]
        return [_bump(B, out[0])] + out[1:]
    monkeypatch.setattr(L, "layer_norm", broken)


def _boot_fault(monkeypatch, kind):
    from fhe_gpt2_tpu_torch.nn.backend import CkksBackend
    real = CkksBackend.bootstrap

    def broken(self, a, **kw):
        if kind == "unchanged":
            return a
        return _bump(self, real(self, a, **kw))
    monkeypatch.setattr(CkksBackend, "bootstrap", broken)


FAULTS = [("resnet20.stage1", _resnet_fault, "unchanged"),
          ("resnet20.stage1", _resnet_fault, "altered"),
          ("gpt2s.ln1", _ln_fault, "unchanged"),
          ("gpt2s.ln1", _ln_fault, "altered"),
          ("gpt2s.ln1", _ln_fault, "half"),
          ("resnet20.boot", _boot_fault, "unchanged"),
          ("resnet20.boot", _boot_fault, "altered")]


@pytest.mark.parametrize("cell,fault,kind", FAULTS,
                         ids=[f"{c}-{k}" for c, _, k in FAULTS])
def test_a_broken_program_is_not_correct(tiny, monkeypatch, cell, fault,
                                         kind):
    fault(monkeypatch, kind)
    result, checks, _, _ = run(tiny, cell)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", ["gpt2s.ln1", "resnet20.boot",
                                  "resnet20.stage1"])
def test_the_control_reads_far_above_the_program(tiny, cell):
    """A control (``control.readings``) reads three times the program's
    number or more where the program passes; at the full size of the
    cells the limits lie between the two (``PERF.md``), and the
    bootstrap's control fails them here already."""
    out = control.readings(cell, SEED, 0.01, device="cpu", spec=tiny)
    assert out["correct"], out
    assert any(c["numbers"][k] >= 3 * max(v, 1e-300)
               for c in out["controls"]
               for k, v in out["program"].items()), out
    if cell != "gpt2s.ln1":
        _, _, traffic = harness.cell(tiny, cell)
        assert any(c["numbers"][k] > lim for c in out["controls"]
                   for k, lim in traffic["limits"].items()), out


def test_a_traced_run_counts_and_puts_the_program_back(tiny):
    """On the CPU there is no device trace: the probes' counts are read,
    the shares of device time are left out, and every wrapped attribute
    is the program's own again afterwards."""
    from fhe_gpt2_tpu_torch.core import tks, tntt
    from fhe_gpt2_tpu_torch.nn import backend as NB
    before = (tntt.ntt_forward, tks.fused_switch_key, NB._masked_sum)
    result, checks, r, drv = harness.measure("gpt2s.ln1", SEED, 0.01, True,
                                             device="cpu", spec=tiny)
    assert result["correct"], checks
    m = result["metrics"]
    assert m["refreshes.gpt2"]["value"] >= 1
    assert m["refresh_ms.gpt2"]["value"] > 0
    assert "idle.gpt2" not in m and "roofline.gpt2" not in m
    assert r.probe.work.ops > 0 and r.probe.kernels["keyswitch"][0] > 0
    assert (tntt.ntt_forward, tks.fused_switch_key, NB._masked_sum) == before
    assert "multiply" not in vars(drv.ses.B.ev)
    assert "bootstrap" not in vars(drv.ses.B)
