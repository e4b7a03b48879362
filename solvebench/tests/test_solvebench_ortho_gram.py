"""The reader of ``ortho.gram_pct`` through the registry: the tall-skinny
kernel's launches over the orthonormalization's products, and nothing where
the program has either counter missing or counted no call."""

from solvebench import registry
from solvebench.run import Run


def _run():
    return Run("elast2d-512.lobpcg-nev8", {}, {}, 1.0, 1.0, [0.5, 0.5], [3, 3], 0)


def test_gram_share(monkeypatch):
    from dune_eigensolver_tpu_torch.ops import ortho

    helper, kernel = ortho.gram_product, ortho.ortho_gram.ortho_gram_cuda
    reader = registry.metric("ortho.gram_pct")
    monkeypatch.setattr(helper, "calls", 0)
    monkeypatch.setattr(kernel, "launches", 0)
    assert reader.read(_run()) is None
    monkeypatch.setattr(helper, "calls", 332)
    monkeypatch.setattr(kernel, "launches", 332)
    assert reader.read(_run()) == 100.0
    monkeypatch.setattr(kernel, "launches", 83)
    assert reader.read(_run()) == 25.0
    monkeypatch.delattr(ortho, "ortho_gram")
    assert reader.read(_run()) is None
    monkeypatch.undo()
    monkeypatch.setattr(kernel, "launches", 10)
    monkeypatch.delattr(ortho, "gram_product")
    assert reader.read(_run()) is None
