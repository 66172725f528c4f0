"""The readers of the MAC kernel's share (``mac_kernel.boot``,
``mac_kernel.resnet``): ``mac.kernel`` over ``mac.calls`` from the port's
recorder, None where the port has no such counter (a program before the
MAC kernel) or no recorder.

    python -m pytest fhe_bench/test_bench_mac.py -q -p no:cacheprovider
"""

import types

import pytest

from fhe_bench import harness

NAMES = ["mac_kernel.boot", "mac_kernel.resnet"]


def _run(counters):
    snap = types.SimpleNamespace(counters=counters)
    return types.SimpleNamespace(requests=3, _recorded=snap)


@pytest.mark.parametrize("name", NAMES)
def test_share_of_mac_calls_that_launched(name):
    read = harness.reader(name)
    assert read(_run({"mac.calls": 40, "mac.kernel": 40})) == 100.0
    assert read(_run({"mac.calls": 40, "mac.kernel": 10})) == 25.0
    assert read(_run({"mac.calls": 4})) == 0.0          # the CPU's route


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_counters(name):
    read = harness.reader(name)
    assert read(_run({"ks": 180})) is None
    assert read(types.SimpleNamespace(requests=3, _recorded=None)) is None


def test_each_cell_reports_its_share():
    spec = harness.load_spec()
    assert [m["name"] for m in harness.metrics_of(spec, "resnet20.boot", True)
            if m["name"].startswith("mac_kernel.")] == ["mac_kernel.boot"]
    assert [m["name"] for m in harness.metrics_of(spec, "resnet20.stage1",
                                                  True)
            if m["name"].startswith("mac_kernel.")] == ["mac_kernel.resnet"]
    assert not [m for m in harness.metrics_of(spec, "gpt2s.ln1", True)
                if m["name"].startswith("mac_kernel.")]
