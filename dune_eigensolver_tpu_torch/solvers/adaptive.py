"""Adaptive GenEO eigenpair selection: grow nev until the spectrum is
covered past a threshold.

Counterpart of the JAX package's ``solvers/adaptive.py`` (reference:
``computeGenSymShiftInvertMinMagnitudeAdaptive``, the GenEO coarse-space
routine): solve for the ``nev`` smallest eigenpairs of ``A x = lambda B x``;
while the largest computed eigenvalue is still below ``threshold`` the
coarse space may be incomplete, so grow nev by ``growth`` and solve again,
until lambda_max >= threshold (every eigenvalue below it is then captured)
or the cap is hit. Returns the last round's pairs and ``n_below``, the
count the GenEO space uses. Each round solves from scratch, as the
reference re-enters ARPACK; the rounds share one factorization.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from dune_eigensolver_tpu_torch.solvers.engine import make_engine
from dune_eigensolver_tpu_torch.solvers.generalized import generalized_inverse
from dune_eigensolver_tpu_torch.solvers.standard import shifted_operand
from dune_eigensolver_tpu_torch.utils.paranoid import reporting


def prepared_inverse(A, B, shift: float, reg: float):
    """An inverse factory that returns one default engine, built here once
    on A' = A + shift*B + reg*I, whatever operand it is given: the rounds of
    a solve (or its segments) then share one factorization."""
    from dune_eigensolver_tpu_torch.factorize import default_inverse_factory

    prepared = default_inverse_factory(make_engine(shifted_operand(A, B, shift, reg))[0])
    return lambda _ignored: prepared


@reporting
def generalized_inverse_adaptive(
    A,
    B,
    threshold: float,
    nev: int = 8,
    tol: float = 2e-3,
    maxiter: int = 4000,
    shift: float = 0.0,
    reg: float = 0.0,
    growth: float = 1.3,
    nev_max: Optional[int] = None,
    inverse: Optional[Callable] = None,
    verbose: int = 0,
    **solver_kw,
):
    """Smallest eigenpairs of ``A x = lambda B x`` until coverage past
    ``threshold``. Returns ``(result, n_below)``.

    nev grows to ``max(ceil(nev * growth), nev + 1)`` a round, capped at
    ``nev_max`` (default ``max(nev, min(n // 2, 1024))``: GenEO coarse
    spaces saturate far below n/2). With ``inverse=None`` the default engine
    is factorized once here and reused by every round; an explicit factory
    is handed to every round as it is. ``solver_kw`` goes to
    ``generalized_inverse``.
    """
    n = A.shape[0]
    nev_max = nev_max or max(nev, min(n // 2, 1024))
    if inverse is None:
        inverse = prepared_inverse(A, B, shift, reg)

    while True:
        res = generalized_inverse(
            A, B, nev=nev, tol=tol, maxiter=maxiter, shift=shift, reg=reg,
            inverse=inverse, **solver_kw,
        )
        evals = res.eigenvalues.cpu().numpy()
        lam_max = float(evals.max())
        n_below = int((evals < threshold).sum())
        if verbose > 0:
            print(
                f"adaptive: nev={nev} lambda_max={lam_max:.3e} "
                f"threshold={threshold:.3e} n_below={n_below}"
            )
        if lam_max >= threshold or nev >= nev_max:
            return res, n_below
        nev = min(max(int(np.ceil(nev * growth)), nev + 1), nev_max)


__all__ = ["generalized_inverse_adaptive", "prepared_inverse"]
