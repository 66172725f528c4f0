"""The Granite cell on the CPU: a tiny dry run of ``granite4h.ssd16``'s
driver and check, a fault it must catch, and the benchmark's copy of the
reference held equal to the port's.

The tiny run keeps the driver, the traffic kind and the check and shrinks
the widths (hidden 64: two groups of 64 inner columns, 16 heads of 8,
state 8), the sequence (8 tokens), the pool (2) and the chain (logN = 10,
10 pairs: the refresh runs often).

    python -m pytest fhe_bench/test_bench_granite.py -q -p no:cacheprovider
"""

import json
from pathlib import Path

import pytest
import torch

from fhe_bench import harness

CELL = "granite4h.ssd16"
TINY = {"hidden_size": 64, "mamba_n_heads": 16, "mamba_d_head": 8,
        "mamba_d_state": 8, "vocab_size": 997}
TINY_FLAGS = ["--seq", "8", "--hidden", "64", "--composite", "--logn", "10",
              "--levels", "10", "--log-scale", "54", "--nsp", "4",
              "--digit-keys"]
SEED = 3000000019


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    spec = harness.load_spec()
    for c in spec["configs"]:
        if c["name"] == "granite-4.0-h-micro":
            cfg = json.loads((harness.REPO / c["file"]).read_text())
            cfg.update(TINY, flags=TINY_FLAGS)
            c["file"] = str(tmp_path / "granite.json")
            (tmp_path / "granite.json").write_text(json.dumps(cfg))
    t = json.loads((harness.TRAFFIC / "ssd_seq16.json").read_text())
    t.update(seq=8, pool=2, check_share=1.0)
    (tmp_path / "ssd_seq16.json").write_text(json.dumps(t))
    monkeypatch.setattr(harness, "TRAFFIC", tmp_path)
    return spec


def run(spec, flags=None):
    return harness.measure(CELL, SEED, 0.01, False, device="cpu", spec=spec,
                           flags=flags)


def test_dry_run(tiny):
    result, checks, r, drv = run(tiny)
    assert result["correct"], checks
    assert result["attempted"] == r.requests >= 1
    assert checks[0][1] < 1e-5, checks
    names = {m["name"] for m in harness.metrics_of(tiny, CELL, False)}
    assert set(result["metrics"]) == names
    assert not harness.forbidden_loaded()


def test_control_fails(tiny):
    """The traffic mix's first control (SiLU and softplus at degree 24)
    reads over the limit."""
    t = json.loads((harness.TRAFFIC / "ssd_seq16.json").read_text())
    _, checks, _, _ = run(tiny, TINY_FLAGS + t["controls"][0]["flags"])
    (_, value, limit), = checks
    assert value > limit, checks


def test_reference_copy_is_the_ports():
    here = Path(__file__).resolve().parent
    assert (here / "reference" / "granite.py").read_bytes() == (
        here.parent / "fhe_gpt2_tpu_torch" / "reference" / "granite.py"
    ).read_bytes()
