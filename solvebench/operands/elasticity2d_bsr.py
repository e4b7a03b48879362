"""Operand family ``elasticity2d_bsr``: 2D plane-stress Q1 linear elasticity
on an N x N mesh of the unit square, clamped on the whole boundary, as a
pencil (A, B) of 2x2 blocks: A the stiffness, B the lumped mass.

The pencil is the one of ``dune_eigensolver_tpu_torch/sparse/problems.py::
elasticity_2d`` (element matrices by 2x2 Gauss quadrature, boundary nodes
eliminated, interior nodes lexicographic, two dofs each, lumped mass the
row sums of the consistent mass over the kept dofs), frozen here. The port
assembles it on the host with scipy; here it is assembled on the card. On a
uniform mesh every interior node lies in four elements, so block (p, q) of
A is the same 2x2 sum of element blocks for every p whose neighbour q in
direction (dr, dc) is interior, and absent otherwise. Blocks are stored as
the port's block-ELL: each row's present blocks in ascending block column,
then padding slots that point at the row's own block with zero values.
"""

from __future__ import annotations

import numpy as np
import torch

#: the nine neighbour directions (dr, dc), in ascending block-column order
DIRECTIONS = tuple((dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1))
#: local node (row, column) offsets of a Q1 element, counter-clockwise from
#: its lower-left node, as the port numbers them
LOCAL = ((0, 0), (0, 1), (1, 1), (1, 0))


def element_matrices(N: int, E: float, nu: float):
    """(Ke, Me): the 8x8 plane-stress stiffness and consistent mass of one
    bilinear element of width 1/N (frozen copy of the port's
    ``_q1_element_matrices``)."""
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


def direction_blocks(Ke: np.ndarray):
    """(9, 2, 2): block (p, p + direction) of an interior node, the sum of
    the element blocks Ke[a, b] over the local pairs (a, b) with that
    offset, in the order the four elements list them."""
    out = np.zeros((len(DIRECTIONS), 2, 2))
    for a, (ra, ca) in enumerate(LOCAL):
        for b, (rb, cb) in enumerate(LOCAL):
            out[DIRECTIONS.index((rb - ra, cb - ca))] += Ke[2 * a:2 * a + 2, 2 * b:2 * b + 2]
    return out


def make(cfg: dict, device) -> dict:
    """The pencil's arrays on ``device`` in ``cfg['dtype']``: A as
    ``bdata`` (nbr, k, 2, 2) and ``bcols`` (nbr, k) int32, k = 9 from N = 4
    on, with ``present`` (nbr, 9) bool by direction; B as ``mass`` (nbr, 2),
    the lumped diagonal. Equal bit for bit to the port's generator in f32."""
    N, E, nu = int(cfg["N"]), float(cfg["E"]), float(cfg["nu"])
    dtype = getattr(torch, cfg["dtype"])
    Ke, Me = element_matrices(N, E, nu)
    k_blocks = torch.as_tensor(direction_blocks(Ke), device=device)  # f64
    m_diag = torch.as_tensor(np.diagonal(direction_blocks(Me), axis1=1, axis2=2).copy(),
                             device=device)  # (9, 2): the consistent mass is diagonal per dof
    side = N - 1  # interior nodes per side
    nbr = side * side
    p = torch.arange(nbr, dtype=torch.int64, device=device)
    ii, jj = p // side, p % side
    dr = torch.tensor([d[0] for d in DIRECTIONS], device=device)
    dc = torch.tensor([d[1] for d in DIRECTIONS], device=device)
    qi, qj = ii[:, None] + dr, jj[:, None] + dc
    present = (qi >= 0) & (qi < side) & (qj >= 0) & (qj < side)  # (nbr, 9)
    slot = torch.cumsum(present.to(torch.int64), dim=1) - 1
    slot = torch.where(present, slot, torch.full_like(slot, len(DIRECTIONS)))
    bdata = torch.zeros((nbr, len(DIRECTIONS) + 1, 2, 2), dtype=torch.float64, device=device)
    bcols = p[:, None].repeat(1, len(DIRECTIONS) + 1)
    rows = p[:, None].expand_as(slot)
    bdata[rows, slot] = torch.where(present[..., None, None], k_blocks, 0.0)
    bcols[rows, slot] = torch.where(present, qi * side + qj, p[:, None])
    # the overflow slot took the absent ones; the padding slots keep the
    # row's own block index and zero values; the width is the fullest row's
    kmax = int(present.sum(dim=1).max())
    bdata, bcols = bdata[:, :kmax], bcols[:, :kmax].to(torch.int32)
    mass = (present.to(torch.float64)[:, :, None] * m_diag).sum(dim=1)  # (nbr, 2)
    return {"bdata": bdata.to(dtype).contiguous(), "bcols": bcols.contiguous(),
            "present": present, "mass": mass.to(dtype).contiguous(), "n": 2 * nbr,
            "nnzb": int(present.sum())}


def to_port(arrays: dict, cfg: dict) -> dict:
    """The program's containers over the same arrays: A and B as
    ``BSRMatrix`` with 2x2 blocks (B one diagonal block a row)."""
    from dune_eigensolver_tpu_torch.sparse.formats import BSRMatrix

    n, nnzb = arrays["n"], arrays["nnzb"]
    mass = arrays["mass"]
    nbr = mass.shape[0]
    A = BSRMatrix(bdata=arrays["bdata"], bcols=arrays["bcols"], shape=(n, n), block=(2, 2),
                  nnz=4 * nnzb)
    eye = torch.eye(2, dtype=mass.dtype, device=mass.device)
    B = BSRMatrix(bdata=(mass[:, :, None] * eye).reshape(nbr, 1, 2, 2).contiguous(),
                  bcols=torch.arange(nbr, dtype=torch.int32, device=mass.device)[:, None].contiguous(),
                  shape=(n, n), block=(2, 2), nnz=4 * nbr)
    return {"A": A, "B": B}
