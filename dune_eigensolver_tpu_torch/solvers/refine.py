"""Rayleigh-Ritz refinement in float64 on the span of a converged block.

Counterpart of the JAX package's ``solvers/refine.py``. The reference's
accuracy protocol compares against a tol=1e-14 ARPACK run in full f64; an
f32 iteration's converged subspace V carries an angle error of ~1e-6..1e-7,
and Rayleigh-Ritz values on a subspace are accurate to the square of that,
provided the projected Grams are computed accurately. Here they are
computed in native float64 on V's device: V and the operand's data are cast
to f64, one ``spmm_t`` (the operand's kernel, f64 instantiation on the
card) and one ``torch.matmul`` give G_A = V^T A V, the same for G_B
(V^T V for B=None), and the small (m, m) pencil is solved in f64 on the
host with scipy. This holds for every operand class. The JAX package's
compensated-f32 branch (``_gram_pieces_dia`` with ``ops/compensated.py``),
a stand-in for the f64 the TPU lacks, has no counterpart: f64 stands in
for it.

``ev.refine=on`` in the CLI runs this after the solve and prints the
refined protocol row (``REFINED_N_M_ERROR``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dune_eigensolver_tpu_torch.sparse.formats import BSRMatrix, ELLMatrix
from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t
from dune_eigensolver_tpu_torch.utils.paranoid import reporting


def _f64(A, device):
    """The operand with its coefficients in float64 on ``device`` (the
    indices moved along); the operand itself where it already is."""
    if A.dtype == torch.float64 and A.device == device:
        return A
    if isinstance(A, BSRMatrix):
        return dataclasses.replace(A, bdata=A.bdata.to(device, torch.float64),
                                   bcols=A.bcols.to(device))
    if isinstance(A, ELLMatrix):
        return dataclasses.replace(A, data=A.data.to(device, torch.float64),
                                   cols=A.cols.to(device))
    return dataclasses.replace(A, data=A.data.to(device, torch.float64))


def _gram(A, Vt: torch.Tensor) -> np.ndarray:
    """V^T A V in f64 from the (m, n) f64 block Vt, on the host."""
    AVt = spmm_t(_f64(A, Vt.device), Vt)
    G = AVt @ Vt.T
    del AVt
    return G.cpu().numpy()


@reporting
def refine_eigenpairs(
    A,
    B,
    V: torch.Tensor,
    nev: Optional[int] = None,
    rotate_vectors: bool = False,
) -> Tuple[np.ndarray, Optional[torch.Tensor]]:
    """f64-grade Ritz values of the pencil (A, B) on the span of V.

    V: (n, m) converged eigenvector block (column layout, any solver's
    ``result.eigenvectors``), any float dtype. B=None means the standard
    problem. Returns (the nev smallest eigenvalues ascending as np.float64,
    the rotated block (n, nev) in V's dtype on V's device, or None). The
    f64 copies of V and of the operands are freed before returning.
    """
    import scipy.linalg as sla

    n, m = V.shape
    nev = m if nev is None else min(nev, m)
    with torch.no_grad():
        Vt = V.T.to(torch.float64).contiguous()  # (m, n)
        GA = _gram(A, Vt)
        GB = (Vt @ Vt.T).cpu().numpy() if B is None else _gram(B, Vt)
        del Vt
    GA = 0.5 * (GA + GA.T)
    GB = 0.5 * (GB + GB.T)
    # B may be semidefinite (GenEO partition-of-unity mass) and the block
    # may carry near-null-B directions: whiten on the B-positive subspace
    # instead of calling eigh(GA, GB) directly (which requires GB > 0)
    db, Ub = sla.eigh(GB)
    keep = db > db.max() * 1e-12
    W = Ub[:, keep] / np.sqrt(db[keep])[None, :]
    w, Cw = sla.eigh(W.T @ GA @ W)
    C = W @ Cw
    w = w[:nev]
    if not rotate_vectors:
        return w, None
    with torch.no_grad():
        Vr = V @ torch.as_tensor(C[:, :nev], dtype=V.dtype, device=V.device)
    return w, Vr


__all__ = ["refine_eigenpairs"]
