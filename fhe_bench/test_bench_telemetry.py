"""The metric files that read the port's own recorder
(``fhe_bench/recorded.py``), on tiny dry runs on the CPU.

With the recorder on (``telemetry.enable()``; in a ``--trace 1`` run on
the card the profiler turns it on), every host-side reader of a cell gives
a value; the bootstraps' device ms have no CUDA events to read on the CPU
and are left out. Without a recorder snapshot (a program that lacks it)
every reader gives None.

    python -m pytest fhe_bench -q -p no:cacheprovider -n 3
"""

import types

import pytest

from fhe_bench import harness, recorded
from fhe_bench.test_bench_dry import SEED, tiny  # noqa: F401

HOST = {"resnet20.stage1": ["mask_hit.resnet", "keyswitches.resnet",
                            "dispatch_ms.resnet"],
        "gpt2s.ln1": ["mask_hit.gpt2", "keyswitches.gpt2", "dispatch_ms.gpt2",
                      "refresh_decrypt_ms.gpt2", "refresh_encrypt_ms.gpt2"],
        "resnet20.boot": ["keyswitches.boot"]}
DEVICE = ["boot_lt_ms.boot", "boot_evalmod_ms.boot", "boot_rest_ms.boot"]


@pytest.fixture(autouse=True)
def few_torch_threads():
    """Two intra-op threads a test: several workers share the host's
    cores, where more threads per worker only spin against each other."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", sorted(HOST))
def test_the_recorders_readers_on_a_tiny_run(tiny, cell):  # noqa: F811
    from fhe_gpt2_tpu_torch.utils import telemetry
    telemetry.reset()
    try:
        with telemetry.enable():
            result, checks, run, _ = harness.measure(
                cell, SEED, 0.01, True, device="cpu", spec=tiny)
    finally:
        telemetry.reset()
    assert result["correct"], checks
    m = result["metrics"]
    for name in HOST[cell]:
        assert name in m and m[name]["value"] >= 0, name
    for name in DEVICE:
        assert name not in m
    [ks] = [n for n in HOST[cell] if n.startswith("keyswitches.")]
    assert m[ks]["value"] > 0
    for name in HOST[cell]:
        if name.startswith("mask_hit."):
            assert m[name]["value"] <= 100


def test_without_a_snapshot_every_reader_gives_none(monkeypatch):
    from fhe_gpt2_tpu_torch.utils import telemetry
    monkeypatch.delattr(telemetry, "snapshot")
    run = types.SimpleNamespace(requests=3)
    for names in list(HOST.values()) + [DEVICE]:
        for name in names:
            assert harness.reader(name)(run) is None, name
    assert recorded.snapshot(run) is None
