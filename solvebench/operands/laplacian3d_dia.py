"""Operand family ``laplacian3d_dia``: the 3D 7-point Dirichlet Laplacian
on an N^3 grid, lexicographic order, 6 on the diagonal and -1 for each grid
neighbour, stored by diagonals.

Frozen copy of ``dune_eigensolver_tpu_torch/sparse/problems.py::
_laplacian_3d_device`` (the port's north-star generator): the seven
diagonals are built on the card from index arithmetic in the configuration's
dtype, so nothing is assembled on the host. ``make`` needs only torch, so
the reference reads the same arrays; ``to_port`` wraps them in the
program's containers.
"""

from __future__ import annotations

import torch


def offsets(N: int):
    return (-N * N, -N, -1, 0, 1, N, N * N)


def make(cfg: dict, device) -> dict:
    """The operand's arrays: ``data`` (7, N^3) in ``cfg['dtype']``."""
    N = int(cfg["N"])
    dtype = getattr(torch, cfg["dtype"])
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
    del i
    return {"data": torch.stack(rows), "offsets": offsets(N), "n": n}


def to_port(arrays: dict, cfg: dict) -> dict:
    """The program's containers: A as ``DIAMatrix`` over the same data, and
    the identity B as a one-diagonal ``DIAMatrix`` (the solver is told
    ``b_identity`` and never applies it)."""
    from dune_eigensolver_tpu_torch.sparse.formats import DIAMatrix

    n = arrays["n"]
    data = arrays["data"]
    A = DIAMatrix(data=data, offsets=tuple(arrays["offsets"]), shape=(n, n))
    B = DIAMatrix(data=torch.ones((1, n), dtype=data.dtype, device=data.device), offsets=(0,),
                  shape=(n, n))
    return {"A": A, "B": B}
