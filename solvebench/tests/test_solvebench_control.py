"""The lower-precision control on the card, at each cell's own size, on
three seeds, comes out not correct (``readings.py``: the workload's
``control``, the program with TF32 on or the reference in its place in
TF32). Needs the card; the benchmark's own runs do not run it."""

import json
import subprocess
import sys

import pytest

from solvebench import registry

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    secs = str(registry.benchmark()["run_seconds"])
    seeds = ",".join(str(2**31 + k) for k in (101, 202, 303))
    out = subprocess.run([sys.executable, "-m", "solvebench.readings", "--workload", cell,
                          "--seconds", secs, "--control-seeds", seeds],
                         cwd=registry.ROOT.parent, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()[1:]]
    assert len(lines) == 3 and all(x["control"] for x in lines)
    for x in lines:
        print(json.dumps({"cell": cell, "seed": x["seed"], "checks": x["checks"]}))
        assert x["correct"] is False, x["checks"]
