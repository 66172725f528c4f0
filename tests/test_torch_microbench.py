"""The port's microbenchmark registry (fhe_gpt2_tpu_torch/utils/
microbench.py) on the CPU: the JAX registry's names and CLI, and every
entry but ``bootstrap`` at logN=10 reporting ``"correct": true`` in the
JAX registry's JSON line (plus the device it ran on). Timings taken here
are CPU timings and are not recorded anywhere.
"""

import json

import pytest

from fhe_gpt2_tpu.utils import microbench as jmb
from fhe_gpt2_tpu_torch.utils import microbench as mb

from torch_port_common import single_torch_thread  # noqa: F401


def test_list_prints_the_reference_registry(capsys):
    assert list(mb.REGISTRY) == list(jmb.REGISTRY)
    assert mb.main(["list"]) == 0
    assert capsys.readouterr().out.split() == list(jmb.REGISTRY)


@pytest.mark.parametrize("name,levels", [("mult_relin", 4), ("rotate", 4),
                                         ("ntt", 4), ("matmul_lt", 4),
                                         ("layernorm", 4)])
def test_entry_is_correct_on_the_cpu(capsys, name, levels):
    rc = mb.main([name, "--logn", "10", "--levels", str(levels),
                  "--iters", "2", "--cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert {k: line[k] for k in ("bench", "logn", "levels", "correct",
                                 "device")} == {
        "bench": name, "logn": 10, "levels": levels, "correct": True,
        "device": "cpu"}
    assert line["seconds"] > 0


def test_without_a_card_the_cli_needs_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mb.main(["ntt", "--logn", "10", "--levels", "2"])
