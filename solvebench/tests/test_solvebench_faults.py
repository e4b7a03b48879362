"""A run with the timed path broken underneath comes out not correct, once
for each fault a solve can have: a step that returns its state unchanged,
half of the block left out of the operator, an answer altered where it is
produced (a stretch of one eigenvector lost; one eigenvalue off by 10%,
where the cell compares eigenvalues). The harness's look for a card is
skipped: on the CPU the run is the committed harness's at the tiny sizes and
limits (``solvebench_tiny``, with the Laplacian beside the benchmark's
cell); on a card (``cuda``) it is the benchmark's cells themselves, their
sizes and limits."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from solvebench import registry, run
from solvebench_tiny import ELAST, LAP, TINY, tiny_root

SEED = 2**33 + 5
#: the cells each place runs: the tiny copies, or the benchmark's own
CELLS = {"cpu": [LAP, ELAST], "cuda": [w["name"] for w in registry.benchmark()["workloads"]]}
LIMITS = {"cpu": {c: TINY[c][3] for c in CELLS["cpu"]},
          "cuda": {c: registry.workload(c)["limits"] for c in CELLS["cuda"]}}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """device -> root: the tiny copy on the CPU, or the committed cells on
    the card, each made once."""
    made = {}

    def root(device):
        if device not in made:
            if device == "cpu":
                made[device] = tiny_root(tmp_path_factory.mktemp("tiny"))
            elif not torch.cuda.is_available():
                pytest.skip("needs a CUDA card: the committed cells at their own size")
            else:
                made[device] = first_solve_root(tmp_path_factory.mktemp("cells"))
        return made[device]

    return root


def first_solve_root(tmp):
    """The committed cells with one sampled solve, the window's first, so
    that a short window judges eigenvectors; sizes and limits unchanged."""
    root = Path(tmp) / "solvebench"
    shutil.copytree(registry.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(registry.ROOT.parent / "BENCHMARK.json", Path(tmp) / "BENCHMARK.json")
    for path in (root / "workloads").glob("*.json"):
        wl = json.loads(path.read_text())
        wl["check"] = {"vectors": 1, "within": 1}
        path.write_text(json.dumps(wl))
    return root


def _unchanged(monkeypatch):
    from dune_eigensolver_tpu_torch.solvers import lobpcg

    core = lobpcg._lobpcg_core

    def no_steps(apply_a, apply_b, prec_aux, prec_fn, Q0, nev, tol, maxiter, *rest, **kw):
        return core(apply_a, apply_b, prec_aux, prec_fn, Q0, nev, tol, 0, *rest, **kw)

    monkeypatch.setattr(lobpcg, "_lobpcg_core", no_steps)


def _half_block(monkeypatch):
    import importlib

    spmm = importlib.import_module("dune_eigensolver_tpu_torch.sparse.spmm")

    def halved(fn):
        def apply(A, Xt):
            Y = fn(A, Xt).clone()
            Y[Y.shape[0] // 2:] = 0
            return Y

        apply.__name__ = fn.__name__
        return apply

    for kind, (kernel, plain) in list(spmm._ROUTES.items()):
        monkeypatch.setitem(spmm._ROUTES, kind, (halved(kernel), halved(plain)))


def _altered(change):
    def plant(monkeypatch):
        from dune_eigensolver_tpu_torch.solvers import lobpcg

        sort = lobpcg.sort_result_t

        def altered(evals, Qt, nev, descending):
            evals, Qt = sort(evals, Qt, nev, descending)
            return change(evals.clone(), Qt.clone())

        monkeypatch.setattr(lobpcg, "sort_result_t", altered)

    return plant


def _vector(evals, Qt):
    Qt[1, : Qt.shape[1] // 100] = 0  # a write that lost a stretch of one eigenvector
    return evals, Qt


def _value(evals, Qt):
    evals[1] = evals[1] * 1.1
    return evals, Qt


FAULTS = {"state unchanged": _unchanged, "half of the block": _half_block,
          "eigenvector altered": _altered(_vector), "eigenvalue altered": _altered(_value)}
#: the faults a cell can have: an eigenvalue is an answer only where the
#: cell compares eigenvalues
CASES = [pytest.param(d, c, f, marks=() if d == "cpu" else pytest.mark.cuda)
         for d in CELLS for c in CELLS[d] for f in FAULTS
         if f != "eigenvalue altered" or "eig_err" in LIMITS[d][c]]


@pytest.mark.parametrize("device, cell, fault", CASES)
def test_a_fault_is_not_correct(roots, device, cell, fault, monkeypatch):
    root = roots(device)
    FAULTS[fault](monkeypatch)
    out = run.run_cell(cell, SEED, 0.3, False, device=device, root=root)
    assert out["correct"] is False, out["checks"]
    # a check fails, not only the want of judged vectors
    assert any(c["value"] > c["limit"] for c in out["checks"].values()), out["checks"]


@pytest.mark.parametrize("device, cell", [pytest.param(d, c, marks=() if d == "cpu" else
                                                       pytest.mark.cuda)
                                          for d in CELLS for c in CELLS[d]])
def test_the_sound_run_is_correct(roots, device, cell):
    out = run.run_cell(cell, SEED, 0.3, False, device=device, root=roots(device))
    assert out["correct"] is True, out["checks"]
    assert torch.get_default_dtype() == torch.float32
