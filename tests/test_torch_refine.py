"""The port's f64 Rayleigh-Ritz refinement against the JAX package's.

Both packages refine the same f32 block V (the exact eigenvectors of a
small operator plus seeded noise, so the Ritz values are genuinely moved
by the refinement) on the same operator. The JAX package projects a DIA
operand by its compensated f32 arithmetic and every other operand on the
host in f64; the port projects every operand in f64 through ``spmm_t``.
The host f64 projection and the port's are exact to ~1e-15 relative, so
their Ritz values agree to 1e-10 relative and their rotated blocks span the
same space; the JAX side of the DIA cases is held there by giving it the
same operator as an ELL container (its host branch). Its compensated DIA
branch, which the port leaves out, is held to the reference's refined
target, 1e-6: on the 2D GenEO pencil at N = 14 it lands 9e-8 (relative)
from the exact f64 Ritz values, where the port lands 1e-15 from them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from dune_eigensolver_tpu.solvers import refine_eigenpairs as jrefine
from dune_eigensolver_tpu.sparse import formats as jformats
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu_torch.oracle import (
    eigenvalues_laplace_dirichlet_2d,
    smallest_generalized,
)
from dune_eigensolver_tpu_torch.solvers import (
    generalized_inverse,
    refine_eigenpairs,
    standard_largest,
)
from dune_eigensolver_tpu_torch.sparse import (
    bsr_from_numpy,
    dia_from_numpy,
    ell_from_scipy,
    problems,
)

torch.set_num_threads(2)


def _dia(Aj):
    return dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape, device="cpu")


def _jell(Mj):
    return None if Mj is None else jformats.ell_from_scipy(Mj.to_scipy(), dtype=np.float32)


def _operands(kind):
    """(JAX A, JAX B or None, port A, port B or None) of one operator."""
    if kind == "dia-standard":
        Aj = jproblems.laplacian_dirichlet_2d(14, dtype=np.float32)
        return Aj, None, _dia(Aj), None
    if kind == "dia-pencil":
        Aj = jproblems.laplacian_neumann_2d(14, dtype=np.float32)
        Bj = jproblems.laplacian_b_2d(14, 3, dtype=np.float32)
        return Aj, Bj, _dia(Aj), _dia(Bj)
    Aj, Bj = jproblems.elasticity_2d(6, dtype=np.float32)
    if kind == "bsr":
        port = [bsr_from_numpy(np.asarray(M.bdata), np.asarray(M.bcols), M.shape, M.block, M.nnz,
                               device="cpu") for M in (Aj, Bj)]
        return Aj, Bj, port[0], port[1]
    # ell: the same pencil scalar-expanded, in both packages
    S = [M.to_scipy() for M in (Aj, Bj)]
    return (jformats.ell_from_scipy(S[0], dtype=np.float32),
            jformats.ell_from_scipy(S[1], dtype=np.float32),
            ell_from_scipy(S[0], dtype=torch.float32, device="cpu"),
            ell_from_scipy(S[1], dtype=torch.float32, device="cpu"))


def _block(Aj, Bj, m, seed):
    """The m smallest eigenvectors of the pencil plus 1e-3 seeded noise, f32."""
    A = Aj.to_scipy().toarray().astype(np.float64)
    B = np.eye(A.shape[0]) if Bj is None else Bj.to_scipy().toarray().astype(np.float64)
    _, U = sla.eigh(A + 1e-3 * B, B + 1e-9 * np.eye(A.shape[0]))
    V = U[:, :m] / np.linalg.norm(U[:, :m], axis=0)
    noise = np.random.default_rng(seed).standard_normal(V.shape)
    return (V + 1e-3 * noise).astype(np.float32)


def _max_subspace_sine(U, V):
    Qu, _ = np.linalg.qr(np.asarray(U, np.float64))
    Qv, _ = np.linalg.qr(np.asarray(V, np.float64))
    s = np.linalg.svd(Qu.T @ Qv, compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - s.min() ** 2)))


@pytest.mark.parametrize("kind", ["dia-standard", "dia-pencil", "bsr", "ell"])
def test_refine_matches_jax(kind):
    """The same V through both packages: Ritz values to 1e-10 relative to
    the largest (against the JAX package's host f64 branch; its compensated
    DIA branch to 1e-6), the rotated blocks (f32, V's dtype) spanning the
    same space to 1e-5 (f32 rounding of V @ C), and the port's rotated
    block on V's device in V's dtype."""
    Aj, Bj, At, Bt = _operands(kind)
    V = _block(Aj, Bj, 8, seed=3)
    if kind.startswith("dia"):
        wc, _ = jrefine(Aj, Bj, jnp.asarray(V), nev=6)  # the compensated branch
        Aj, Bj = _jell(Aj), _jell(Bj)
    wj, Vj = jrefine(Aj, Bj, jnp.asarray(V), nev=6, rotate_vectors=True)
    wt, Vt = refine_eigenpairs(At, Bt, torch.from_numpy(V), nev=6, rotate_vectors=True)
    if kind.startswith("dia"):
        assert np.abs(np.asarray(wc) - wt).max() <= 1e-6 * np.abs(wt).max()
    assert isinstance(wt, np.ndarray) and wt.dtype == np.float64 and wt.shape == (6,)
    assert np.abs(wt - np.asarray(wj)).max() <= 1e-10 * np.abs(wt).max()
    assert Vt.dtype == torch.float32 and Vt.device.type == "cpu" and Vt.shape == (V.shape[0], 6)
    assert _max_subspace_sine(np.asarray(Vj), Vt.numpy()) < 1e-5
    w_none, V_none = refine_eigenpairs(At, Bt, torch.from_numpy(V))
    assert V_none is None and w_none.shape == (8,)
    np.testing.assert_allclose(w_none[:6], wt, rtol=1e-12)


def test_refine_takes_any_block_dtype():
    """An f64 block and an f32 one of the same values refine to the same
    Ritz values: the projection is f64 either way."""
    Aj, Bj, At, Bt = _operands("dia-pencil")
    V = _block(Aj, Bj, 8, seed=4)
    w32, _ = refine_eigenpairs(At, Bt, torch.from_numpy(V))
    w64, V64 = refine_eigenpairs(At, Bt, torch.from_numpy(V).double(), rotate_vectors=True)
    np.testing.assert_allclose(w32, w64, rtol=1e-13)
    assert V64.dtype == torch.float64


def test_refined_largest_vs_analytic():
    """f32 ``standard_largest`` + refinement against the closed-form 2D
    Dirichlet spectrum: <= 1e-6 (tests/test_refine.py:96 holds the JAX
    package to the same)."""
    N = 20
    A = problems.laplacian_dirichlet_2d(N, dtype=torch.float32, device="cpu")
    res = standard_largest(A, nev=4, tol=1e-7, maxiter=2000)
    w, _ = refine_eigenpairs(A, None, res.eigenvectors, nev=4)
    ana = np.sort(eigenvalues_laplace_dirichlet_2d(N))[-4:]
    assert np.abs(np.sort(w) - ana).max() < 1e-6


def test_refined_generalized_hits_1e6_vs_oracle():
    """f32 GenEO solve + refinement against the 1e-14 oracle: the
    reference protocol's tight row (tests/test_refine.py's), with the
    refined error no worse than the unrefined one."""
    N, shift = 24, 1e-3
    A = problems.laplacian_neumann_2d(N, dtype=torch.float32, device="cpu")
    B = problems.laplacian_b_2d(N, 3, dtype=torch.float32, device="cpu")
    res = generalized_inverse(A, B, nev=4, tol=1e-7, maxiter=800, shift=shift)
    truth, _ = smallest_generalized(A, B, 4, sigma=-shift, tol=1e-14)
    raw_err = np.abs(res.eigenvalues.double().numpy()[:4] - truth).max()
    w, _ = refine_eigenpairs(A, B, res.eigenvectors, nev=4)
    ref_err = np.abs(w - truth).max()
    assert ref_err < 1e-6, (ref_err, raw_err)
    assert ref_err <= raw_err + 1e-12


def test_refine_rotation_residual():
    """The rotated vectors are eigenvectors of the operator to the
    refined values (tests/test_refine.py's residual bound)."""
    N = 16
    A = problems.laplacian_dirichlet_2d(N, dtype=torch.float32, device="cpu")
    res = standard_largest(A, nev=4, tol=1e-7, maxiter=2000)
    w, Vr = refine_eigenpairs(A, None, res.eigenvectors, nev=4, rotate_vectors=True)
    As = A.to_scipy().astype(np.float64)
    V = Vr.double().numpy()
    for j in range(4):
        v = V[:, j] / np.linalg.norm(V[:, j])
        assert np.linalg.norm(As @ v - w[j] * v) < 5e-5
