"""The whole-basis orthonormalization (``ortho_block='full'``) on the CPU.

Its one Gram sees cond(S)^2. The first LOBPCG basis ``[X, W, W/2]`` is
rank-deficient by construction, and the later ones are near-dependent, so in
f32 the Gram's null directions carry rounding noise above the whitening's
floor: a noise row comes back with unit A-norm and a genuine direction is
lost. The LOBPCG core accumulates and whitens that Gram in f64
(``gram_dtype``), and the north-star recipe with 'full' then converges as
the 24-row block sweep does."""

import numpy as np
import pytest
import torch

from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory
from dune_eigensolver_tpu_torch.ops.ortho import b_orthonormalize_blocked_t
from dune_eigensolver_tpu_torch.oracle.analytic import eigenvalues_laplace_dirichlet_3d
from dune_eigensolver_tpu_torch.solvers import lobpcg_nested
from dune_eigensolver_tpu_torch.sparse import DIAMatrix, problems
from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t

torch.set_num_threads(2)


@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("N", [12, 16, 24])
def test_f64_gram_whitens_the_rank_deficient_first_basis(N, m):
    """``[X, W, W/2]`` in f32 through one whole-basis CholeskyQR with an f64
    Gram: the 2m independent rows come back A-orthonormal to 1e-6 (f32
    rows), the m dependent rows as noise of A-norm^2 below 1e-5."""
    A = problems.laplacian_dirichlet_3d(N, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(N + m)
    X = torch.randn((m, N**3), generator=g)
    W = torch.randn((m, N**3), generator=g)
    apply_a = lambda V: spmm_t(A, V)  # noqa: E731
    out, _ = b_orthonormalize_blocked_t(apply_a, torch.cat([X, W, 0.5 * W]), block=3 * m,
                                        iterations=1, eps=1e-9, gram_dtype=torch.float64)
    assert out.dtype == torch.float32
    G = apply_a(out).double() @ out.double().T
    h = slice(0, 2 * m)
    assert (G[h, h] - torch.eye(2 * m, dtype=torch.float64)).abs().max() < 1e-6
    assert torch.diagonal(G)[2 * m:].max() < 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N", [16, 24])
def test_full_ortho_recipe_converges_as_the_block_sweep(N, dtype):
    """The north-star recipe (nev 24, tol 2e-3, MG V(1,1)) in f32 with
    ``ortho_block='full'``: the 24-row block sweep converges in 11
    iterations here; 'full' within 20 and the 20 smallest eigenvalues
    within 3e-4 of the closed form (the N=24 gate of the card's smoke
    script). With an f32 Gram it took 92-300 iterations."""
    A = problems.laplacian_dirichlet_3d(N, dtype=torch.float32, device="cpu")
    n = A.shape[0]
    B = DIAMatrix(data=torch.ones((1, n)), offsets=(0,), shape=A.shape)
    res = lobpcg_nested(A, B, nev=24, tol=2e-3, maxiter=300, shift=0.0, min_coarse=48,
                        coarse_tol=2e-4, precond=mg_inverse_factory(nu1=1, nu2=1, dtype=dtype),
                        ortho_iterations=1, ortho_block="full", b_identity=True)
    assert bool(res.converged) and int(res.iterations) <= 20
    ev = np.sort(res.eigenvalues.numpy())[:20]
    assert np.abs(ev - eigenvalues_laplace_dirichlet_3d(N, count=20)).max() <= 3e-4
