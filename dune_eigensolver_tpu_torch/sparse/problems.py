"""Test-problem generators (counterpart of the JAX package's
``sparse/problems.py``):

* the 2D 5-point and 3D 7-point Dirichlet Laplacians in DIA form and the
  operators derived from the 2D one (Neumann variant, the GenEO mass
  matrix, the identity on a pattern, the islands and the rectangular
  operand). Their diagonals are assembled on the target device from index
  arithmetic: at 216^3 the seven diagonals are 280 MB in f32, so nothing
  is built on the host and copied;
* the non-stencil operators: the 2D elasticity pencil (BSR, 2x2 blocks)
  and the unstructured graph Laplacian (ELL). These are assembled on the
  host with numpy/scipy, as in the reference, and then moved to the
  device.
"""

from __future__ import annotations

import numpy as np
import torch

from dune_eigensolver_tpu_torch.sparse.formats import (
    DIAMatrix,
    bsr_from_scipy,
    ell_from_scipy,
)
from dune_eigensolver_tpu_torch.utils.device import resolve


def laplacian_dirichlet_2d(N: int, dtype=torch.float64, device=None) -> DIAMatrix:
    """2D 5-point Laplacian on an N x N grid, lexicographic ordering
    (4 on the diagonal, -1 for grid neighbours). ``device=None`` is the
    current CUDA device."""
    device = resolve(device)
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


def laplacian_neumann_2d(N: int, dtype=torch.float64, device=None) -> DIAMatrix:
    """Neumann-type variant: diagonal := |sum of off-diagonal entries|."""
    A = laplacian_dirichlet_2d(N, dtype=dtype, device=device)
    d0 = A.offsets.index(0)
    data = A.data.clone()
    data[d0] = (A.data.sum(dim=0) - A.data[d0]).abs()
    return DIAMatrix(data=data, offsets=A.offsets, shape=A.shape)


def partition_of_unity_2d(N: int, overlap: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """pu[k] = 0 within ``overlap`` of the grid boundary, else 1, as a
    tensor of N*N entries."""
    device = resolve(device)
    k = torch.arange(N * N, dtype=torch.int64, device=device)
    i, j = k // N, k % N
    near = (i < overlap) | (i > N - 1 - overlap) | (j < overlap) | (j > N - 1 - overlap)
    return torch.where(near, 0.0, 1.0).to(dtype)


def laplacian_b_2d(N: int, overlap: int, dtype=torch.float64, device=None) -> DIAMatrix:
    """GenEO-style B: Laplacian entries masked by the partition of unity,
    B_ij = A_ij * pu_i * pu_j."""
    A = laplacian_dirichlet_2d(N, dtype=dtype, device=device)
    n = A.shape[0]
    pu = partition_of_unity_2d(N, overlap, dtype=dtype, device=A.device)
    i = torch.arange(n, dtype=torch.int64, device=A.device)
    rows = []
    for d, off in enumerate(A.offsets):
        col = i + off
        inside = (col >= 0) & (col < n)
        pu_col = torch.where(inside, pu[col.clamp(0, n - 1)], torch.zeros((), dtype=dtype,
                                                                          device=A.device))
        rows.append(A.data[d] * pu * pu_col)
    return DIAMatrix(data=torch.stack(rows), offsets=A.offsets, shape=A.shape)


def identity_on_pattern(A: DIAMatrix, dtype=None) -> DIAMatrix:
    """Identity matrix stored on A's diagonal pattern, on A's device."""
    data = torch.zeros(A.data.shape, dtype=dtype or A.dtype, device=A.device)
    data[A.offsets.index(0)] = 1.0
    return DIAMatrix(data=data, offsets=A.offsets, shape=A.shape)


def laplacian_islands_2d(N: int, islands: int, dtype=torch.float64, device=None) -> DIAMatrix:
    """``islands`` decoupled N x N Dirichlet Laplacians in one operator:
    constant work per partition and no coupling across partitions."""
    A = laplacian_dirichlet_2d(N, dtype=dtype, device=device)
    n = A.shape[0] * islands
    return DIAMatrix(data=A.data.repeat(1, islands), offsets=A.offsets, shape=(n, n))


def laplacian_dirichlet_rect(Nx: int, Ny: int, dtype=torch.float64, device=None) -> DIAMatrix:
    """2D 5-point Laplacian on an Nx x Ny grid (row-major over y then x):
    the connected weak-scaling operand, whose row partitions cut real -1
    couplings."""
    device = resolve(device)
    n = Nx * Ny
    i = torch.arange(n, dtype=torch.int64, device=device)
    one = torch.tensor(-1.0, dtype=dtype, device=device)
    zero = torch.tensor(0.0, dtype=dtype, device=device)
    rows = [
        torch.where(i >= Nx, one, zero),
        torch.where(i % Nx != 0, one, zero),
        torch.full((n,), 4.0, dtype=dtype, device=device),
        torch.where(i % Nx != Nx - 1, one, zero),
        torch.where(i < n - Nx, one, zero),
    ]
    return DIAMatrix(data=torch.stack(rows), offsets=(-Nx, -1, 0, 1, Nx), shape=(n, n))


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


def laplacian_dirichlet_3d(N: int, dtype=torch.float32, device=None) -> DIAMatrix:
    """3D 7-point Laplacian on an N^3 grid (the north-star problem)."""
    device = resolve(device)
    n = N * N * N
    offsets = (-N * N, -N, -1, 0, 1, N, N * N)
    return DIAMatrix(
        data=_laplacian_3d_device(N, dtype, device), offsets=offsets, shape=(n, n)
    )


# ---------------------------------------------------------------------------
# Non-stencil operators (block / unstructured sparsity)
# ---------------------------------------------------------------------------


def _q1_element_matrices(N: int, E: float, nu: float):
    """(Ke, Me): the 8x8 plane-stress stiffness and consistent mass of one
    bilinear element of width 1/N, by 2x2 Gauss quadrature."""
    h = 1.0 / N
    gp = (-1.0 / np.sqrt(3.0), 1.0 / np.sqrt(3.0))
    D = (E / (1.0 - nu * nu)) * np.array(
        [[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, (1.0 - nu) / 2.0]]
    )
    Ke = np.zeros((8, 8))
    Me = np.zeros((8, 8))
    J = h / 2.0
    for xi in gp:
        for eta in gp:
            dN = 0.25 * np.array(
                [
                    [-(1 - eta), (1 - eta), (1 + eta), -(1 + eta)],
                    [-(1 - xi), -(1 + xi), (1 + xi), (1 - xi)],
                ]
            )
            Nsh = 0.25 * np.array(
                [(1 - xi) * (1 - eta), (1 + xi) * (1 - eta),
                 (1 + xi) * (1 + eta), (1 - xi) * (1 + eta)]
            )
            dNxy = dN / J
            Bm = np.zeros((3, 8))
            Bm[0, 0::2] = dNxy[0]
            Bm[1, 1::2] = dNxy[1]
            Bm[2, 0::2] = dNxy[1]
            Bm[2, 1::2] = dNxy[0]
            Ke += (Bm.T @ D @ Bm) * (J * J)
            Nv = np.zeros((2, 8))
            Nv[0, 0::2] = Nsh
            Nv[1, 1::2] = Nsh
            Me += (Nv.T @ Nv) * (J * J)
    return Ke, Me


def elasticity_2d(
    N: int,
    E: float = 1.0,
    nu: float = 0.3,
    dtype=torch.float64,
    lumped_mass: bool = True,
    device=None,
):
    """2D plane-stress linear elasticity on an N x N Q1 quad mesh, clamped
    boundary: the elasticity-type operator class the reference stores as
    ``BCRSMatrix<FieldMatrix<double,2,2>>``. Returns (A, B) as ``BSRMatrix``
    with (2, 2) blocks: A = stiffness, B = (lumped) mass.

    Boundary nodes are eliminated (interior (N-1)^2 nodes, two dofs each,
    lexicographic), so the spectrum is that of the clamped plate. The
    reference assembles in a Python loop over the N^2 elements; here the
    element loop is one numpy expression that lists the same COO entries
    in the same order, so scipy sums the same duplicates in the same order
    and the matrix comes out bit for bit the same.
    """
    import scipy.sparse as sp

    if N < 2:
        raise ValueError("elasticity_2d: need N >= 2")
    Ke, Me = _q1_element_matrices(N, E, nu)
    nn = N + 1  # nodes per side
    ei, ej = (g.ravel() for g in np.meshgrid(np.arange(N), np.arange(N), indexing="ij"))
    nodes = np.stack(
        [ei * nn + ej, ei * nn + ej + 1, (ei + 1) * nn + ej + 1, (ei + 1) * nn + ej],
        axis=1,
    )  # (N^2, 4), counter-clockwise from the element's lower-left node
    dofs = (2 * nodes[:, :, None] + np.arange(2)).reshape(-1, 8)
    rows = np.repeat(dofs, 8, axis=1).ravel()
    cols = np.tile(dofs, (1, 8)).ravel()
    ndof = 2 * nn * nn
    K = sp.coo_matrix((np.tile(Ke.ravel(), N * N), (rows, cols)), shape=(ndof, ndof)).tocsr()
    M = sp.coo_matrix((np.tile(Me.ravel(), N * N), (rows, cols)), shape=(ndof, ndof)).tocsr()
    ii, jj = np.meshgrid(np.arange(1, N), np.arange(1, N), indexing="ij")
    interior = (ii * nn + jj).ravel()
    keep = np.stack([2 * interior, 2 * interior + 1], axis=1).ravel()
    K = K[keep][:, keep].tocsr()
    M = M[keep][:, keep].tocsr()
    if lumped_mass:
        M = sp.diags(np.asarray(M.sum(axis=1)).ravel()).tocsr()
    A = bsr_from_scipy(K, block=(2, 2), dtype=dtype, device=device)
    B = bsr_from_scipy(M, block=(2, 2), dtype=dtype, device=device)
    return A, B


def unstructured_laplacian(
    n: int, extra_edges: int = 0, seed: int = 0, dtype=torch.float64,
    fmt: str = "ell", device=None,
):
    """Graph Laplacian (+I) of a randomly permuted 1D chain with
    ``extra_edges`` random long-range couplings: an unstructured pattern no
    DIA container can hold. Returns an ``ELLMatrix`` (fmt='ell') or a scipy
    CSR (fmt='scipy'). The pattern comes from numpy's ``default_rng(seed)``,
    as in the reference, so both packages build the same matrix."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    src = perm[:-1]
    dst = perm[1:]
    if extra_edges:
        e1 = rng.integers(0, n, extra_edges)
        e2 = rng.integers(0, n, extra_edges)
        mask = e1 != e2
        src = np.concatenate([src, e1[mask]])
        dst = np.concatenate([dst, e2[mask]])
    W = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    W = W + W.T
    W.data[:] = 1.0
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W + sp.eye(n)
    L = sp.csr_matrix(L)
    if fmt == "scipy":
        return L
    return ell_from_scipy(L, dtype=dtype, device=device)
