"""The readers of the dyadic kernel's share (``dyadic_kernel.granite``,
``dyadic_kernel.boot``): ``dyadic.kernel`` over ``dyadic.calls`` from the
port's recorder, None where the port has no such counter (a program before
the dyadic kernel) or no recorder.

    python -m pytest fhe_bench/test_bench_dyadic.py -q -p no:cacheprovider
"""

import types

import pytest

from fhe_bench import harness

NAMES = ["dyadic_kernel.granite", "dyadic_kernel.boot"]


def _run(counters):
    snap = types.SimpleNamespace(counters=counters)
    return types.SimpleNamespace(requests=3, _recorded=snap)


@pytest.mark.parametrize("name", NAMES)
def test_share_of_dyadic_calls_that_launched(name):
    read = harness.reader(name)
    assert read(_run({"dyadic.calls": 40, "dyadic.kernel": 40})) == 100.0
    assert read(_run({"dyadic.calls": 40, "dyadic.kernel": 10})) == 25.0
    assert read(_run({"dyadic.calls": 4})) == 0.0       # the CPU's route


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_counters(name):
    read = harness.reader(name)
    assert read(_run({"ks": 180, "mac.calls": 3})) is None
    assert read(types.SimpleNamespace(requests=3, _recorded=None)) is None


def test_each_cell_reports_its_share():
    spec = harness.load_spec()
    share = {cell: [m["name"] for m in harness.metrics_of(spec, cell, True)
                    if m["name"].startswith("dyadic_kernel.")]
             for cell in ("granite4h.ssd16", "resnet20.boot",
                          "resnet20.stage1", "gpt2s.ln1")}
    assert share == {"granite4h.ssd16": ["dyadic_kernel.granite"],
                     "resnet20.boot": ["dyadic_kernel.boot"],
                     "resnet20.stage1": [], "gpt2s.ln1": []}
