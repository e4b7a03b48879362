"""Preconditioner kind ``mg``: the program's geometric multigrid V-cycle
(``factorize/multigrid.py::mg_inverse_factory``). Options: ``nu1``, ``nu2``
(smoothing steps), ``dtype`` (storage of the fine-level smoothing, e.g.
``bfloat16``), and optionally ``cycles``, ``omega``, ``coarse_iters``,
``min_coarse``."""

from __future__ import annotations


def factory(options: dict):
    import torch

    from dune_eigensolver_tpu_torch.factorize.multigrid import mg_inverse_factory

    kw = {k: v for k, v in options.items() if k != "kind"}
    if "dtype" in kw:
        kw["dtype"] = getattr(torch, kw["dtype"])
    return mg_inverse_factory(**kw)
