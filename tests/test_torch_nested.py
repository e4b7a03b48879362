"""The whole ported slice: nested-iteration LOBPCG of the PyTorch port
against the JAX package and the analytic spectrum.

``lobpcg_nested`` refuses a caller's ``q0``; its coarsest level starts
from ``random_multivector_t(PRNGKey(123), ...)`` in the JAX package, a
stream torch cannot reproduce. The tests therefore replace the port's
``random_multivector_t``, where ``solvers/lobpcg.py`` looks it up, by one
that returns the JAX package's block (passed through numpy), so both
packages start from the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_eigensolver_tpu.factorize import mg_inverse_factory as jmg_factory
from dune_eigensolver_tpu.solvers import lobpcg_nested as jnested
from dune_eigensolver_tpu.solvers.standard import random_multivector_t as jrandom_t
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu.sparse.formats import DIAMatrix as JDIA
from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory as tmg_factory
from dune_eigensolver_tpu_torch.oracle.analytic import eigenvalues_laplace_dirichlet_3d
from dune_eigensolver_tpu_torch.solvers import lobpcg_nested as tnested
from dune_eigensolver_tpu_torch.sparse import dia_from_numpy

torch.set_num_threads(2)

N = 24  # levels 6^3 -> 12^3 -> 24^3 with min_coarse=6


def _problem(dtype):
    Aj = jproblems.laplacian_dirichlet_3d(N, dtype=dtype)
    n = Aj.shape[0]
    Bj = JDIA(data=jnp.ones((1, n), dtype), offsets=(0,), shape=Aj.shape)
    At = dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape)
    Bt = dia_from_numpy(np.ones((1, n), dtype), (0,), Aj.shape)
    return Aj, Bj, At, Bt


@pytest.fixture
def jax_start_block(monkeypatch):
    """Make the port's coarsest start block the JAX package's; records the
    sizes it was asked for."""
    calls = []

    def start(generator, n, m, dtype, device):
        calls.append(n)
        np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
        blk = jrandom_t(jax.random.PRNGKey(123), n, m, np_dtype)
        return torch.from_numpy(np.array(blk)).to(device)

    monkeypatch.setattr(
        "dune_eigensolver_tpu_torch.solvers.lobpcg.random_multivector_t", start
    )
    return calls


def _max_subspace_sine(U, V):
    Qu, _ = np.linalg.qr(U)
    Qv, _ = np.linalg.qr(V)
    s = np.linalg.svd(Qu.T @ Qv, compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - s.min() ** 2)))


def test_nested_slice_matches_jax_f64(jax_start_block):
    """The whole slice in f64 (MG preconditioner, blocked B-ortho, three
    levels): same final iteration count, eigenvalues to rtol 1e-8, and the
    span of the 7 vectors (the clusters 1+3+3 of the spectrum) to 1e-4 —
    the MG's coarsest level is an f32 CG in both packages whose roundoff
    differs, and it moves the vectors at about 1e-5."""
    Aj, Bj, At, Bt = _problem(np.float64)
    kw = dict(nev=7, tol=1e-6, maxiter=300, min_coarse=6, b_identity=True,
              ortho_block=8)
    rj = jnested(Aj, Bj, precond=jmg_factory(), **kw)
    rt = tnested(At, Bt, precond=tmg_factory(), **kw)
    assert jax_start_block == [6**3]  # only the coarsest level draws a start
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged)
    np.testing.assert_allclose(rt.eigenvalues.numpy(), np.asarray(rj.eigenvalues),
                               rtol=1e-8)
    assert _max_subspace_sine(np.asarray(rj.eigenvectors), rt.eigenvectors.numpy()) < 1e-4
    exact = eigenvalues_laplace_dirichlet_3d(N, count=7)
    np.testing.assert_allclose(rt.eigenvalues.numpy(), exact, atol=1e-6)


def test_nested_north_star_recipe_f32_bf16(jax_start_block):
    """The bench's north-star recipe (f32 operand, MG V(1,1) with bf16 fine
    smoothing, single-pass CholeskyQR in 24-row blocks, identity B, nev=24)
    at N=24. Against the analytic spectrum: the 3e-4 envelope of the JAX
    package's own recipe test. Against the JAX package: both stop on a
    2e-3 relative change of the Ritz values and smooth in bf16 with
    different accumulation (f32 in the port, bf16 in the JAX CPU path), so
    the smallest 20 agree to 1e-4 absolute, a third of the envelope."""
    Aj, Bj, At, Bt = _problem(np.float32)
    kw = dict(nev=24, tol=2e-3, maxiter=300, shift=0.0, min_coarse=6,
              coarse_tol=2e-4, ortho_iterations=1, ortho_block=24,
              b_identity=True)
    rj = jnested(Aj, Bj, precond=jmg_factory(nu1=1, nu2=1, dtype=jnp.bfloat16), **kw)
    rt = tnested(At, Bt, precond=tmg_factory(nu1=1, nu2=1, dtype=torch.bfloat16), **kw)
    ev = np.sort(rt.eigenvalues.numpy())[:20]
    assert np.isfinite(ev).all() and bool(rt.converged)
    assert rt.eigenvectors.shape == (N**3, 24) and rt.eigenvectors.dtype == torch.float32
    exact = eigenvalues_laplace_dirichlet_3d(N, count=20)
    assert np.abs(ev - exact).max() < 3e-4
    np.testing.assert_allclose(ev, np.sort(np.asarray(rj.eigenvalues))[:20], atol=1e-4,
                               rtol=0)


def test_nested_refusals():
    _, _, At, Bt = _problem(np.float64)
    with pytest.raises(ValueError, match="b_identity"):
        tnested(At, Bt, nev=2, tol=1e-4, maxiter=50, precond=False)
    with pytest.raises(ValueError, match="q0"):
        tnested(At, Bt, nev=2, tol=1e-4, maxiter=50, b_identity=True,
                q0=torch.zeros(N**3, 8, dtype=torch.float64))
    n = 64
    A1 = dia_from_numpy(np.full((1, n), 2.0), (0,), (n, n))
    with pytest.raises(ValueError, match="structured"):
        tnested(A1, A1, nev=2, tol=1e-4, maxiter=50, b_identity=True)
