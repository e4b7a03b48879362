"""Blocked (B-)orthonormalization of the PyTorch port against the JAX
package, on the same seeded f64 inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_eigensolver_tpu.ops import ortho as jortho
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu_torch.ops import ortho as tortho
from dune_eigensolver_tpu_torch.sparse import dia_from_numpy

torch.set_num_threads(2)


def _laplacian_pair(N=14):
    """The 2D Laplacian (SPD, n = N^2) in both packages."""
    Aj = jproblems.laplacian_dirichlet_2d(N, dtype=np.float64)
    At = dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape, device="cpu")
    return Aj, At


@pytest.mark.parametrize("m,block", [(24, 8), (24, 24), (16, 8)])
@pytest.mark.parametrize("iterations", [1, 2])
def test_b_orthonormalize_blocked_t_matches_jax(m, block, iterations):
    """The Cholesky path is deterministic (positive diagonal), so outputs
    agree entrywise; f64 roundoff through m/b sweeps stays below 1e-10."""
    Aj, At = _laplacian_pair()
    Xt = np.random.default_rng(1).standard_normal((m, Aj.shape[0]))
    Yj, nj, mj = jortho.b_orthonormalize_blocked_t(
        Aj, jnp.asarray(Xt), block=block, iterations=iterations, eps=1e-12,
        return_mass=True,
    )
    Yt, nt, mt = tortho.b_orthonormalize_blocked_t(
        At, torch.from_numpy(Xt), block=block, iterations=iterations,
        eps=1e-12, return_mass=True,
    )
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(nt.item(), float(nj), rtol=1e-10)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-10)
    # and the result is B-orthonormal
    Y = Yt.numpy()
    G = Y @ (At.to_scipy() @ Y.T)
    np.testing.assert_allclose(G, np.eye(m), atol=1e-8)


def test_b_orthonormalize_callable_and_plain_orthonormalize():
    Aj, At = _laplacian_pair()
    Xt = np.random.default_rng(2).standard_normal((16, Aj.shape[0]))
    Yj, nj = jortho.b_orthonormalize_blocked_t(
        lambda V: 2.0 * V, jnp.asarray(Xt), block=8
    )
    Yt, nt = tortho.b_orthonormalize_blocked_t(
        lambda V: 2.0 * V, torch.from_numpy(Xt), block=8
    )
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(nt.item(), float(nj), rtol=1e-10)
    Zj = jortho.orthonormalize_blocked_t(jnp.asarray(Xt), block=8, iterations=2)
    Zt = tortho.orthonormalize_blocked_t(torch.from_numpy(Xt), block=8, iterations=2)
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        tortho.dot_products_diagonal_t(Zt, Zt).numpy(), np.ones(16), atol=1e-12
    )
    with pytest.raises(ValueError, match="multiple"):
        tortho.b_orthonormalize_blocked_t(At, torch.from_numpy(Xt), block=6)


def _gram_and_projector(Y, S):
    """Sign-invariant views of a whitened block Y (rows): its B-Gram and
    Y^T Y (invariant under row sign flips and permutations)."""
    return Y @ (S @ Y.T), Y.T @ Y


def test_whitening_fallback_on_rank_deficient_block():
    """A zero row makes the block's Gram singular: the Cholesky fails in
    both packages and the spectral whitening takes over. eigh's vector
    signs are arbitrary, so compare the Gram of the output and Y^T Y."""
    Aj, At = _laplacian_pair()
    Xt = np.random.default_rng(3).standard_normal((16, Aj.shape[0]))
    Xt[3] = 0.0
    Gr = torch.from_numpy(Xt[:8] @ (At.to_scipy() @ Xt[:8].T))
    assert torch.linalg.cholesky_ex(Gr).info.item() != 0  # really falls back
    Yj, nj = jortho.b_orthonormalize_blocked_t(Aj, jnp.asarray(Xt), block=8, eps=0.0)
    Yt, nt = tortho.b_orthonormalize_blocked_t(At, torch.from_numpy(Xt), block=8,
                                               eps=0.0)
    Yj, Yt = np.asarray(Yj), Yt.numpy()
    assert np.isfinite(Yt).all()
    S = At.to_scipy()
    Gj, Pj = _gram_and_projector(Yj, S)
    Gt, Pt = _gram_and_projector(Yt, S)
    np.testing.assert_allclose(Gt, Gj, atol=1e-8)
    np.testing.assert_allclose(Pt, Pj, atol=1e-8)
    np.testing.assert_allclose(nt.item(), float(nj), rtol=1e-8)
    # 15 healthy directions orthonormalized, the zero one left ~zero
    w = np.linalg.eigvalsh(Gt)
    np.testing.assert_allclose(w[1:], np.ones(15), atol=1e-8)
    assert abs(w[0]) < 1e-8


def test_whiten_apply_falls_back_on_zero_last_pivot():
    """A singular (2, 2) Gram whose LAST Cholesky pivot is exactly zero:
    ``cholesky_ex`` reports it and the spectral transform is taken. (The
    JAX package's unrolled Cholesky returns a finite L with a zero pivot
    there and its triangular solve then yields NaN; the port does not
    mirror that.) Y Y^T = T G T^T has eigenvalues {0, 1}."""
    X = torch.tensor([[2.0, 0.0, 0.0], [1.0, 0.0, 0.0]], dtype=torch.float64)
    G = X @ X.T  # [[4, 2], [2, 1]]
    assert torch.linalg.cholesky_ex(G).info.item() != 0
    (Y,) = tortho._whiten_apply(G, 0.0, (X,))
    assert torch.isfinite(Y).all()
    w = torch.linalg.eigvalsh(Y @ Y.T)
    torch.testing.assert_close(w, torch.tensor([0.0, 1.0], dtype=torch.float64),
                               atol=1e-6, rtol=0)
