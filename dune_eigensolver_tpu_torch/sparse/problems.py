"""Test-problem generators (the slice's subset of the JAX package's
``sparse/problems.py``): the 2D 5-point and 3D 7-point Dirichlet
Laplacians in DIA form.

The diagonals are assembled on the target device from index arithmetic:
at 216^3 the seven diagonals are 280 MB in f32, so nothing is built on the
host and copied.
"""

from __future__ import annotations

import torch

from dune_eigensolver_tpu_torch.sparse.formats import DIAMatrix


def laplacian_dirichlet_2d(N: int, dtype=torch.float64, device="cpu") -> DIAMatrix:
    """2D 5-point Laplacian on an N x N grid, lexicographic ordering
    (4 on the diagonal, -1 for grid neighbours)."""
    n = N * N
    i = torch.arange(n, dtype=torch.int64, device=device)
    one = torch.tensor(-1.0, dtype=dtype, device=device)
    zero = torch.tensor(0.0, dtype=dtype, device=device)
    rows = [
        torch.where(i >= N, one, zero),  # -N
        torch.where(i % N != 0, one, zero),  # -1 (not across grid rows)
        torch.full((n,), 4.0, dtype=dtype, device=device),
        torch.where(i % N != N - 1, one, zero),  # +1
        torch.where(i < n - N, one, zero),  # +N
    ]
    return DIAMatrix(
        data=torch.stack(rows), offsets=(-N, -1, 0, 1, N), shape=(n, n)
    )


def _laplacian_3d_device(N: int, dtype, device) -> torch.Tensor:
    """(7, N^3) diagonals of the 3D 7-point Laplacian, built on ``device``."""
    n = N * N * N
    i = torch.arange(n, dtype=torch.int64, device=device)
    one = torch.tensor(-1.0, dtype=dtype, device=device)
    zero = torch.tensor(0.0, dtype=dtype, device=device)
    rows = [
        torch.where(i >= N * N, one, zero),
        torch.where((i // N) % N != 0, one, zero),
        torch.where(i % N != 0, one, zero),
        torch.full((n,), 6.0, dtype=dtype, device=device),
        torch.where(i % N != N - 1, one, zero),
        torch.where((i // N) % N != N - 1, one, zero),
        torch.where(i < n - N * N, one, zero),
    ]
    return torch.stack(rows)


def laplacian_dirichlet_3d(N: int, dtype=torch.float32, device="cpu") -> DIAMatrix:
    """3D 7-point Laplacian on an N^3 grid (the north-star problem)."""
    n = N * N * N
    offsets = (-N * N, -N, -1, 0, 1, N, N * N)
    return DIAMatrix(
        data=_laplacian_3d_device(N, dtype, device), offsets=offsets, shape=(n, n)
    )
