"""Host-side eigenvalue oracles via scipy (ARPACK under the hood).

The reference validates against ARPACK++ through
``ArpackMLGeneo::ArPackPlusPlus_Algorithms`` (arpack_geneo_wrapper.hh:392-804)
— in particular ``computeGenSymShiftInvertMinMagnitude`` (:581-658), i.e.
ARPACK's symmetric generalized shift-invert mode with which="LM" around a
shift. scipy.sparse.linalg.eigsh wraps the same Fortran ARPACK, so these are
the same oracles (at 1e-14 they serve as ground truth in the convergence
protocol, src/dune-eigensolver.cc:559-565).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import eigsh


def _to_scipy(A):
    return A.to_scipy() if hasattr(A, "to_scipy") else sp.csr_matrix(A)


def smallest_generalized(A, B, nev: int, sigma: float = 0.0, tol: float = 0.0):
    """Smallest nev eigenvalues of A x = lambda B x by shift-invert at sigma.

    Matches computeGenSymShiftInvertMinMagnitude (arpack_geneo_wrapper.hh:581)
    — called with sigma = -shift by the reference program
    (src/dune-eigensolver.cc:565).
    """
    As, Bs = _to_scipy(A).astype(np.float64), _to_scipy(B).astype(np.float64)
    vals, vecs = eigsh(As, k=nev, M=Bs, sigma=sigma, which="LM", tol=tol)
    order = np.argsort(vals)
    return vals[order], vecs[:, order]


def smallest_standard(A, nev: int, sigma: float = 0.0, tol: float = 0.0):
    """Smallest nev eigenvalues of A x = lambda x by shift-invert at sigma."""
    As = _to_scipy(A).astype(np.float64)
    vals, vecs = eigsh(As, k=nev, sigma=sigma, which="LM", tol=tol)
    order = np.argsort(vals)
    return vals[order], vecs[:, order]


def largest_standard(A, nev: int, tol: float = 0.0):
    """Largest nev eigenvalues of A x = lambda x, descending."""
    As = _to_scipy(A).astype(np.float64)
    vals, vecs = eigsh(As, k=nev, which="LA", tol=tol)
    order = np.argsort(vals)[::-1]
    return vals[order], vecs[:, order]


def smallest_standard_nonsym(
    A, nev: int, sigma: float = 0.0, tol: float = 0.0, shift_b=None
):
    """nev eigenvalues of A x = lambda x nearest ``sigma`` for NON-symmetric
    A, via ARPACK's non-symmetric shift-invert (scipy eigs).

    Matches computeStdNonSymMinMagnitude (arpack_geneo_wrapper.hh:428-499).
    ``shift_b`` selects the reference's OwnShiftMode (:92-107): the Arnoldi
    operator is op = (A - sigma*B)^-1 B run as a STANDARD problem (no
    B-inner products, so B may be semidefinite/non-symmetric), and the
    pencil eigenvalues A x = lambda B x are recovered by the manual
    un-shift lambda = sigma + 1/nu (:488-495). With shift_b=None the
    problem is the ordinary standard one (B = I) and eigs performs the
    identical transformation internally. Returns (values, vectors) sorted
    by |lambda - sigma| ascending; values are complex in general.
    """
    from scipy.sparse.linalg import eigs

    As = _to_scipy(A).astype(np.float64)
    if shift_b is not None:
        # OwnShiftMode: standard Arnoldi on (A - sigma*B)^-1 B, manual un-shift
        from scipy.sparse.linalg import LinearOperator, splu

        Bs = _to_scipy(shift_b).astype(np.float64)
        lu = splu(sp.csc_matrix(As - sigma * Bs))
        op = LinearOperator(As.shape, matvec=lambda v: lu.solve(Bs @ v))
        nu, vecs = eigs(op, k=nev, which="LM", tol=tol)
        vals = sigma + 1.0 / nu
    else:
        vals, vecs = eigs(As, k=nev, sigma=sigma, which="LM", tol=tol)
    order = np.argsort(np.abs(vals - sigma))
    return vals[order], vecs[:, order]


def smallest_generalized_nonsym(A, B, nev: int, sigma: float = 0.0, tol: float = 0.0):
    """nev eigenvalues of A x = lambda B x nearest ``sigma`` for
    NON-symmetric pencils, via ARPACK's generalized shift-invert.

    Matches computeGenNonSymShiftInvertMinMagnitude
    (arpack_geneo_wrapper.hh:502-578, ARNonSymGenEig in mode 'S').
    Returns (values, vectors) sorted by |lambda - sigma| ascending.
    """
    from scipy.sparse.linalg import eigs

    As = _to_scipy(A).astype(np.float64)
    Bs = _to_scipy(B).astype(np.float64)
    vals, vecs = eigs(As, k=nev, M=Bs, sigma=sigma, which="LM", tol=tol)
    order = np.argsort(np.abs(vals - sigma))
    return vals[order], vecs[:, order]
