"""The reader of ``mg.tail_pct`` through the registry: the tail kernel's
launches over the V-cycle's coarse corrections, and nothing where the
program has either counter missing or counted no apply."""

from solvebench import registry
from solvebench.run import Run


def _run():
    return Run("lap3d-216-ns.nested-nev24", {}, {}, 1.0, 1.0, [0.5, 0.5], [3, 3], 0)


def test_tail_share(monkeypatch):
    from dune_eigensolver_tpu_torch.factorize import multigrid

    cc, kernel = multigrid.coarse_correction, multigrid.mg_tail.mg_tail_cuda
    reader = registry.metric("mg.tail_pct")
    monkeypatch.setattr(cc, "applies", 40)
    monkeypatch.setattr(kernel, "launches", 30)
    assert reader.read(_run()) == 75.0
    monkeypatch.setattr(cc, "applies", 0)
    assert reader.read(_run()) is None
    monkeypatch.setattr(cc, "applies", 40)
    monkeypatch.delattr(multigrid, "mg_tail")
    assert reader.read(_run()) is None
    monkeypatch.undo()
    monkeypatch.setattr(kernel, "launches", 30)
    monkeypatch.delattr(multigrid, "coarse_correction")
    assert reader.read(_run()) is None
