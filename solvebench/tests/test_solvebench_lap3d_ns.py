"""The north star's family (``laplacian3d_dia_ns``) on the CPU at N <= 16:
its operand is ``laplacian3d_dia``'s bit for bit, its reference's copies
read as their originals, the closed-form eigenpairs are eigenpairs and
agree with a dense ``eigh``, the TF32 control runs through the readings
path, the port's nested solve on the north star's recipe passes the tiny
limits; and the readers of the nested and V-cycle spans and of the level
counter."""

import collections
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from solvebench import program_trace as pt
from solvebench import readings, registry, run
from solvebench.run import Run
from solvebench_tiny import LAP, LAP_WORKLOAD, TINY, tiny_root

#: the north star's cell: its recipe on this family
CELL = "lap3d-216-ns.nested-nev24"
FAMILY = "laplacian3d_dia_ns"
SEED = 2**33 + 7


def _cfg(N, dtype="float32"):
    return dict(registry.config("lap3d-216-ns"), N=N, n=N ** 3, dtype=dtype)


@pytest.mark.parametrize("N", [3, 7, 16])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_operand_is_laplacian3d_dias(N, dtype):
    mine = registry.operands(FAMILY).make(_cfg(N, dtype), "cpu")
    base = registry.operands("laplacian3d_dia").make(_cfg(N, dtype), "cpu")
    assert mine["offsets"] == base["offsets"] and mine["n"] == base["n"] == N ** 3
    assert mine["data"].dtype == getattr(torch, dtype)
    assert torch.equal(mine["data"], base["data"])


def test_the_reference_copies_read_as_their_originals():
    """``check``, ``exact_smallest`` and ``round_tf32`` are copies of
    ``laplacian3d_dia``'s and ``elasticity2d_bsr``'s (a reference imports no
    other file of the benchmark): the same readings on the same answers."""
    mine, base = registry.reference(FAMILY), registry.reference("laplacian3d_dia")
    N, k = 9, 12
    cfg = _cfg(N)
    arrays = registry.operands(FAMILY).make(cfg, "cpu")
    gen = torch.Generator().manual_seed(5)
    answers = [{"eigenvalues": mine.exact_smallest(N, k + 2) * (1 + 1e-3 * j)}
               for j in range(3)]
    answers[1]["eigenvectors"] = torch.randn(N ** 3, k + 2, generator=gen)
    state = mine.prepare(cfg, k, arrays, None)
    assert np.array_equal(state["exact"], base.prepare(cfg, k, arrays, None)["exact"])
    assert mine.check(state, k, arrays, answers) == base.check(state, k, arrays, answers)
    x = torch.randn(1000, generator=gen) * 1e-3
    assert torch.equal(mine.round_tf32(x), registry.reference("elasticity2d_bsr").round_tf32(x))


def test_closed_form_pairs_are_orthonormal_eigenpairs():
    ref = registry.reference(FAMILY)
    N, k = 12, 20
    arrays = registry.operands(FAMILY).make(_cfg(N, "float64"), "cpu")
    pairs = list(ref.closed_form_pairs(N, k))
    lam = np.array([p[0] for p in pairs])
    V = torch.stack([p[1] for p in pairs])
    assert V.dtype == torch.float64 and V.shape == (k, N ** 3)
    assert np.array_equal(lam, ref.exact_smallest(N, k))
    R = ref.dia_apply_f64(arrays["data"], arrays["offsets"], V) - torch.as_tensor(lam)[:, None] * V
    assert float(R.norm(dim=1).max()) < 1e-12
    assert float((V @ V.T - torch.eye(k, dtype=torch.float64)).abs().max()) < 1e-12
    # x is the fastest index: a mode p has p - 1 sign changes along its axis
    for (a, b, c), (_, v) in zip(ref.smallest_triples(N, k), pairs):
        grid = v.reshape(N, N, N)  # (z, y, x)
        changes = [int((line.sign().diff() != 0).sum())
                   for line in (grid[0, 0, :], grid[0, :, 0], grid[:, 0, 0])]
        assert changes == [a - 1, b - 1, c - 1]


def test_exact_smallest_agrees_with_a_dense_eigh():
    ref = registry.reference(FAMILY)
    N, k = 12, 30
    arrays = registry.operands(FAMILY).make(_cfg(N, "float64"), "cpu")
    dense = ref.dia_apply_f64(arrays["data"], arrays["offsets"], torch.eye(N ** 3,
                                                                         dtype=torch.float64))
    got = torch.linalg.eigvalsh(dense)[:k].numpy()
    assert np.abs(got - ref.exact_smallest(N, k)).max() < 1e-12


def _tiny_cell_root(tmp_path):
    """The committed harness beside the north star's recipe
    (``solvebench_tiny.LAP_WORKLOAD``) on this family, with the closed-form
    control, at N = 16 with the Laplacian's tiny coarsening, sample and
    limits."""
    root = tiny_root(tmp_path)
    cfg_over, opt_over, check, limits = TINY[LAP]
    wl = dict(LAP_WORKLOAD, config="lap3d-216-ns", check=check, limits=limits,
              options=dict(LAP_WORKLOAD["options"], **opt_over),
              control={"kind": "reference", "precision": "tf32"})
    (root / "workloads" / f"{CELL}.json").write_text(json.dumps(wl))
    cpath = root / "configs" / "lap3d-216-ns.json"
    cpath.write_text(json.dumps(dict(json.loads(cpath.read_text()), **cfg_over)))
    return root


def test_tf32_control_through_the_readings_path(tmp_path):
    """``readings.control_window`` puts the closed-form pairs, rounded to
    TF32, in the program's place: one answer of (n, report) float32
    vectors, judged as a run's, whose ``resid`` is the rounding's (the same
    pairs rounded to float32 alone read over 100 times less)."""
    root = _tiny_cell_root(tmp_path)
    cell = run.Cell(CELL, SEED, device="cpu", root=root)
    w = readings.control_window(cell, SEED, 0.0)
    checks, got = cell.judge(w)
    N, k = int(cell.cfg["N"]), int(cell.wl["report"])
    (ans,) = w.answers
    assert ans["eigenvectors"].shape == (N ** 3, k)
    assert ans["eigenvectors"].dtype == torch.float32
    assert checks["resid"]["value"] == got["resid"] > 0 and got["eig_err"] > 0
    ref = registry.reference(FAMILY, root)
    state = cell.reference_state()
    f32 = [{"eigenvalues": state["exact"],
            "eigenvectors": torch.stack([v for _, v in ref.closed_form_pairs(N, k)]).T
            .to(torch.float32)}]
    assert ref.check(state, k, cell.arrays, f32)["resid"] * 100 < got["resid"]


def test_the_port_on_the_recipe_passes_the_tiny_limits(tmp_path):
    root = _tiny_cell_root(tmp_path)
    out = run.run_cell(CELL, SEED, 0.3, False, device="cpu", root=root)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["readings"]["resid"] <= TINY[LAP][3]["resid"]


BASE = 1_000_000_000  # the trace's baseTimeNanoseconds


def _span(name, start_us, end_us, parent=None):
    return SimpleNamespace(name=name, start_ns=BASE + int(start_us * 1000),
                           end_ns=BASE + int(end_us * 1000), parent=parent)


#: solve [0, 100] holding nested.coarse [0, 60] holding mg.apply [10, 50]
#: holding mg.coarse [20, 40]; the fine level's mg.apply [70, 90]
SPANS = [_span("solve", 0, 100), _span("nested.coarse", 0, 60, 0), _span("mg.apply", 10, 50, 1),
         _span("mg.coarse", 20, 40, 2), _span("mg.apply", 70, 90, 0)]
#: (start, dur, launch) on the trace's clock: launched at 5 (nested.coarse),
#: 25 (mg.coarse), 45 (mg.apply, coarse level), 75 (mg.apply, fine), 95 (solve)
OPS = [pt.Op(6, 10, 5), pt.Op(26, 20, 25), pt.Op(46, 5, 45), pt.Op(76, 40, 75), pt.Op(96, 25, 95)]


def test_the_readers_of_the_nested_and_vcycle_spans(monkeypatch):
    from dune_eigensolver_tpu_torch.solvers.nested import lobpcg_nested

    run_ = Run(CELL, {}, {}, 1.0, 1.0, [0.5], [2], 0)
    run_.__dict__[pt._KEY] = pt.Measured(SPANS, SPANS, BASE, OPS)
    assert registry.metric("nested.coarse_pct").read(run_) == pytest.approx(100 * 35 / 100)
    assert registry.metric("mg.coarse_pct").read(run_) == pytest.approx(100 * 20 / 100)
    # a program without the spans (the parent's) reads nothing, not 0
    bare = [s if s.name not in ("nested.coarse", "mg.coarse") else _span("lobpcg.rr", 0, 1, 0)
            for s in SPANS]
    run_.__dict__[pt._KEY] = pt.Measured(bare, bare, BASE, OPS)
    assert registry.metric("nested.coarse_pct").read(run_) is None
    assert registry.metric("mg.coarse_pct").read(run_) is None
    monkeypatch.setattr(lobpcg_nested, "calls", 4)
    monkeypatch.setattr(lobpcg_nested, "iterations", collections.Counter({0: 9, 1: 16, 2: 46}))
    assert registry.metric("nested.coarse_iterations").read(run_) == pytest.approx(62 / 4)
    monkeypatch.setattr(lobpcg_nested, "calls", 0)
    assert registry.metric("nested.coarse_iterations").read(run_) is None
    monkeypatch.delattr(lobpcg_nested, "iterations")
    monkeypatch.setattr(lobpcg_nested, "calls", 4)
    assert registry.metric("nested.coarse_iterations").read(run_) is None
