"""The harness finds its cells, metrics and traffic by name, holds to the
benchmark's contract, and loads neither JAX nor the JAX package.

    python -m pytest fhe_bench -q -p no:cacheprovider
"""

import json
import re
import subprocess
import sys

import pytest

from fhe_bench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_is_found_by_name():
    for w in SPEC["workloads"]:
        entry, cfg, traffic = harness.cell(SPEC, w["name"])
        assert entry is w
        assert cfg["name"] == w["config"]
        assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").exists()
        assert set(traffic["limits"]) and 0 < traffic["check_share"] <= 1
    with pytest.raises(KeyError):
        harness.cell(SPEC, "no.such.cell")


def test_a_dropped_in_traffic_file_is_found(tmp_path, monkeypatch):
    """A new cell is a BENCHMARK.json entry and a traffic file: nothing of
    the harness is edited."""
    mix = {"driver": "resnet_blocks", "blocks": [4], "pool_images": 2,
           "check_share": 1.0, "limits": {"block_gap": 1.0}}
    (tmp_path / "stage2_one.json").write_text(json.dumps(mix))
    monkeypatch.setattr(harness, "TRAFFIC", tmp_path)
    spec = dict(SPEC, workloads=SPEC["workloads"] + [
        {"name": "resnet20.stage2_one", "config": "resnet20-cifar10",
         "traffic": "stage2_one", "chips": 1, "why": "a test cell"}])
    _, cfg, traffic = harness.cell(spec, "resnet20.stage2_one")
    assert traffic == mix and cfg["depth"] == 20
    names = {m["name"] for m in harness.metrics_of(spec, "resnet20.stage2_one",
                                                     False)}
    assert names == {"setup_s"}


def test_every_metric_has_a_reader():
    for kind in ("end_to_end", "per_layer"):
        for m in SPEC[kind]:
            assert callable(harness.reader(m["name"]))


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(SPEC, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(SPEC, w["name"], True)


def test_the_spec_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["fhe_bench"] and len(SPEC["command"]) <= 32
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    names = [c["name"] for c in SPEC["configs"]]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (harness.REPO / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    cells = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= {w["name"]
                                               for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads",
                                                    m["workloads"]))


def _modules_after(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=300,
        check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_nothing_the_harness_loads_is_jax_or_the_jax_package():
    """Compared by the top-level name, whole: fhe_gpt2_tpu_torch begins
    with fhe_gpt2_tpu and is the program."""
    code = ("import fhe_bench.run, fhe_bench.harness, fhe_bench.control, "
            "fhe_bench.probes, fhe_bench.devtrace\n"
            "from fhe_bench import drivers\n"
            "for d in ('resnet_blocks', 'gpt2_layer_norm', 'bootstrap'):\n"
            "    drivers.load(d)\n"
            "from fhe_bench import harness\n"
            "for m in harness.load_spec()['end_to_end'] + "
            "harness.load_spec()['per_layer']:\n"
            "    harness.reader(m['name'])\n"
            "import fhe_gpt2_tpu_torch.run_resnet\n"
            "import fhe_gpt2_tpu_torch.run_gpt2\n"
            "import fhe_gpt2_tpu_torch.cnn.resnet\n"
            "import fhe_gpt2_tpu_torch.nn.layers\n"
            "import fhe_gpt2_tpu_torch.boot.bootstrap\n")
    mods = _modules_after(code)
    top = {m.split(".")[0] for m in mods}
    assert "fhe_gpt2_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules_after("import fhe_bench.reference.resnet, "
                          "fhe_bench.reference.gpt2_ln, "
                          "fhe_bench.reference.bootstrap")
    top = {m.split(".")[0] for m in mods}
    assert not top & {"fhe_gpt2_tpu_torch", "torch", *harness.FORBIDDEN}


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, "fhe_bench/run.py", "--workload", "gpt2s.ln1",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_a_folder_with_only_the_benchmark_exits_without_a_result(tmp_path):
    import shutil
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "fhe_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "fhe_bench/run.py", "--workload", "gpt2s.ln1",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "fhe_gpt2_tpu_torch" in out.stderr
