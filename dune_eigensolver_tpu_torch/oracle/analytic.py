"""Closed-form spectra of the discrete Dirichlet Laplacians.

Reference: eigenvalues_laplace_dirichlet_2d (src/dune-eigensolver.cc:437-446):
lambda_{ij} = 4 (sin^2(pi h (i+1)/2) + sin^2(pi h (j+1)/2)), h = 1/(N+1),
i.e. the exact eigenvalues of the N x N 5-point stencil with entries
(4, -1, -1, -1, -1). The 3D analogue has three sine terms and diagonal 6.
"""

from __future__ import annotations

import numpy as np


def eigenvalues_laplace_dirichlet_2d(N: int) -> np.ndarray:
    """All N^2 eigenvalues of the 2D N x N 5-point Laplacian, ascending."""
    h = 1.0 / (N + 1.0)
    k = np.arange(1, N + 1)
    s = 4.0 * np.sin(0.5 * h * k * np.pi) ** 2
    ev = (s[:, None] + s[None, :]).reshape(-1)
    return np.sort(ev)


def eigenvalues_laplace_dirichlet_3d(N: int, count: int | None = None) -> np.ndarray:
    """Eigenvalues of the 3D N^3 7-point Laplacian, ascending.

    If ``count`` is given, only the smallest ``count`` are returned (computed
    without materializing all N^3 values for large N)."""
    h = 1.0 / (N + 1.0)
    k = np.arange(1, N + 1)
    s = 4.0 * np.sin(0.5 * h * k * np.pi) ** 2
    if count is None or N <= 64:
        ev = (s[:, None, None] + s[None, :, None] + s[None, None, :]).reshape(-1)
        ev = np.sort(ev)
        return ev if count is None else ev[:count]
    # small eigenvalues come from small indices only
    cap = max(2, int(np.ceil(count ** (1.0 / 3.0))) + 4)
    sc = s[:cap]
    ev = (sc[:, None, None] + sc[None, :, None] + sc[None, None, :]).reshape(-1)
    return np.sort(ev)[:count]
