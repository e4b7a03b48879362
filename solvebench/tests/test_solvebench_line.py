"""The result line's keys and types, from whole runs of the benchmark's cell
and of the Laplacian beside it at the tiny sizes on the CPU
(``solvebench_tiny``), and the exits without a card and without the
program."""

import json
import shutil
import subprocess
import sys

import pytest

from solvebench import registry, run
from solvebench_tiny import ELAST, LAP, tiny_root

SEED = 2**31 + 77  # more than 32 signed bits hold


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", [LAP, ELAST])
def test_result_line(root, cell):
    out = run.run_cell(cell, SEED, 0.5, False, device="cpu", root=root)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert isinstance(line["attempted"], int) and line["attempted"] >= 1
    assert line["failed"] == 0
    bench = registry.benchmark(root)
    # without a card there is no device trace: its end-to-end metrics read nothing
    want = {m["name"]: m["unit"] for m in registry.cell_metrics(bench, cell, False)
            if m["source"] != "device_trace"}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(isinstance(v["value"], float) for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == {"failed"} | set(registry.workload(cell, root)["limits"])
    for c in line["checks"].values():
        assert isinstance(c["value"], (int, float)) and c["value"] <= c["limit"]


def test_same_seed_same_inputs(root):
    a = run.run_cell(ELAST, SEED, 0.3, False, device="cpu", root=root)
    b = run.run_cell(ELAST, SEED, 0.3, False, device="cpu", root=root)
    assert a["checks"]["resid"]["value"] == b["checks"]["resid"]["value"]


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the harness runs")
    assert run.main(["--workload", ELAST, "--seed", "1", "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_benchmark_alone_does_not_run(tmp_path):
    shutil.copytree(registry.ROOT, tmp_path / "solvebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(registry.ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "solvebench", "--workload", ELAST, "--seed", "3",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
