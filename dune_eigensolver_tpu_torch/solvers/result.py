"""Solver result container (counterpart of the JAX package's
``solvers/result.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EigenResult:
    """Result of an eigensolver run.

    ``eigenvalues``: (nev,), sorted ascending for smallest-seeking solvers,
    descending for ``standard_largest``.
    ``eigenvectors``: (n, nev), columns are the (B-)normalized eigenvector
    approximations.
    ``iterations``: outer iterations executed.
    ``converged``: whether the stopping criterion fired before maxiter.
    ``criterion``: final value of the stopping quantity.
    ``ortho_monitor``: final loss-of-orthogonality monitor (0 for solvers
    that do not report it).
    """

    eigenvalues: torch.Tensor
    eigenvectors: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    criterion: torch.Tensor
    ortho_monitor: torch.Tensor


def sort_result(evals: torch.Tensor, Q: torch.Tensor, nev: int, descending: bool):
    """Order eigenpairs and truncate to nev (column layout)."""
    order = torch.argsort(-evals if descending else evals, stable=True)
    return evals[order][:nev], Q[:, order][:, :nev]


def sort_result_t(evals: torch.Tensor, Qt: torch.Tensor, nev: int, descending: bool):
    """Order eigenpairs and truncate to nev (transposed layout: vectors are
    rows of Qt). The sort is stable, as ``jnp.argsort`` is."""
    order = torch.argsort(-evals if descending else evals, stable=True)
    return evals[order][:nev], Qt[order][:nev]
