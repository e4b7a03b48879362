"""The reader of ``cg.fused_pct`` through the registry: the program's
fused-apply counter over its applies, and nothing where the program has no
such counter or counted no apply."""

from solvebench import registry
from solvebench.run import Run


def _run():
    return Run("elast2d-512.lobpcg-nev8", {}, {}, 1.0, 1.0, [0.5, 0.5], [3, 3], 0)


def test_fused_share(monkeypatch):
    from dune_eigensolver_tpu_torch.factorize.cg import cg_solve_t

    reader = registry.metric("cg.fused_pct")
    monkeypatch.setattr(cg_solve_t, "calls", 8)
    monkeypatch.setattr(cg_solve_t, "fused", 6)
    assert reader.read(_run()) == 75.0
    monkeypatch.setattr(cg_solve_t, "calls", 0)
    assert reader.read(_run()) is None
    monkeypatch.setattr(cg_solve_t, "calls", 8)
    monkeypatch.delattr(cg_solve_t, "fused")
    assert reader.read(_run()) is None
