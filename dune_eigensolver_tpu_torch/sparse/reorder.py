"""Symmetric reorderings for general-sparsity operands (counterpart of the
JAX package's ``sparse/reorder.py``; numpy/scipy only).

Eigenvalues of the pencil (A, B) are invariant under a symmetric
permutation P A P^T / P B P^T, so an eigensolve on an unstructured operator
may run entirely in reverse Cuthill-McKee order, which keeps each row's
columns near the row and so makes the SpMM's gathers of X local; only the
eigenvectors need permuting back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from dune_eigensolver_tpu_torch.sparse.formats import bsr_from_scipy, ell_from_scipy


def rcm_pencil(
    A, B=None, block: Optional[Tuple[int, int]] = None, dtype=None, device="cpu"
) -> Tuple[object, Optional[object], np.ndarray]:
    """(A', B', perm) with A' = A[perm][:, perm] in RCM order.

    ``A``/``B``: port containers or scipy matrices. ``block``: return
    ``BSRMatrix`` with that block size; the permutation is then computed on
    the block graph so whole blocks move together. Without ``block``,
    returns ``ELLMatrix``. ``dtype`` is a torch dtype (default: the
    operand's own). ``perm`` maps new index -> old index (scalar dofs);
    recover original-order vectors with ``unpermute_vectors``.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    def to_csr(M):
        return sp.csr_matrix(M.to_scipy() if hasattr(M, "to_scipy") else M)

    Sa = to_csr(A)
    Sb = to_csr(B) if B is not None else None
    if block is not None:
        br, bc = block
        if br != bc:
            raise ValueError("rcm_pencil: blocks must be square")
        nb = Sa.shape[0] // br
        # block connectivity graph: collapse scalar pattern onto blocks
        pat = Sa.copy()
        pat.data = np.ones_like(pat.data)
        R = sp.kron(sp.eye(nb), np.ones((1, br)))
        G = sp.csr_matrix(R @ pat @ R.T)
        bperm = np.asarray(reverse_cuthill_mckee(G, symmetric_mode=True))
        perm = (bperm[:, None] * br + np.arange(br)[None, :]).ravel()
    else:
        perm = np.asarray(reverse_cuthill_mckee(sp.csr_matrix(Sa), symmetric_mode=True))
    Sa = Sa[perm][:, perm]
    if Sb is not None:
        Sb = Sb[perm][:, perm]
    if block is not None:
        def convert(S):
            return bsr_from_scipy(S, block=block, dtype=dtype, device=device)
    else:
        def convert(S):
            return ell_from_scipy(S, dtype=dtype, device=device)
    return convert(Sa), None if Sb is None else convert(Sb), perm


def unpermute_vectors(V: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Map eigenvectors computed in permuted order back: rows reordered so
    row perm[i] of the output is row i of the input."""
    out = np.empty_like(V)
    out[perm] = V
    return out


__all__ = ["rcm_pencil", "unpermute_vectors"]
