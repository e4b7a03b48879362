"""The general-sparsity solves of the PyTorch port against the JAX package.

``generalized_inverse`` (shift-invert subspace iteration, the reference's
flagship entry point) and ``lobpcg_generalized`` run with the Jacobi-CG
inverse on the clamped-plate elasticity pencil (BSR, 2x2 blocks) and on the
RCM-ordered unstructured graph Laplacian (ELL), from the same start block
in both packages. The JAX side runs twice: on its plain containers
(``force_padded=False``, the XLA formulations) and on its windowed
operands (``force_padded=True``), where every A.X, B.X and CG step runs the
Pallas gather kernels in interpret mode. Its windowed planner is given
tile 256 instead of its default 2048, which keeps the interpret-mode
compile to seconds; the kernels compute the same for any tile.

In f64 the port must take the same number of iterations as each, and give
the same eigenvalues (rtol 1e-8) and eigenspaces. f32 runs are held
against the scipy/ARPACK oracle at the tolerance of
tests/test_gather_spmm.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dune_eigensolver_tpu.factorize import cg_inverse_factory as jcg_factory
from dune_eigensolver_tpu.kernels import gather_spmm as jgather
from dune_eigensolver_tpu.solvers import generalized_inverse as jgeneralized
from dune_eigensolver_tpu.solvers import lobpcg_generalized as jlobpcg
from dune_eigensolver_tpu.sparse import formats as jformats
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu.sparse.reorder import rcm_pencil as jrcm_pencil
from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory as tcg_factory
from dune_eigensolver_tpu_torch.oracle import smallest_generalized, smallest_standard
from dune_eigensolver_tpu_torch.solvers import generalized_inverse as tgeneralized
from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized as tlobpcg
from dune_eigensolver_tpu_torch.sparse import (
    bsr_from_numpy,
    ell_from_numpy,
    ell_from_scipy,
    problems,
    rcm_pencil,
    unpermute_vectors,
)

torch.set_num_threads(2)

TOL = 2e-3  # tests/test_gather_spmm.py


@pytest.fixture
def windowed_tile_256(monkeypatch):
    """The JAX engine's windowed planner at tile 256 (see module doc)."""
    monkeypatch.setattr(
        jgather, "make_windowed_operands",
        functools.partial(jgather.make_windowed_operands, tile=256),
    )


def _bridge(J):
    if isinstance(J, jformats.BSRMatrix):
        return bsr_from_numpy(np.asarray(J.bdata), np.asarray(J.bcols), J.shape, J.block, J.nnz,
                              device="cpu")
    return ell_from_numpy(np.asarray(J.data), np.asarray(J.cols), J.shape, J.nnz, device="cpu")


def _max_subspace_sine(U, V):
    """Largest principal-angle sine between the column spans of U and V."""
    Qu, _ = np.linalg.qr(U)
    Qv, _ = np.linalg.qr(V)
    s = np.linalg.svd(Qu.T @ Qv, compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - s.min() ** 2)))


def _elasticity(perturbed_mass=False):
    """elasticity_2d(10) f64. ``perturbed_mass`` scales the lumped mass by
    a seeded factor in [1, 1.2): the plate's symmetry makes its smallest
    eigenvalue double, and inside that pair LOBPCG's Ritz vectors turn on
    roundoff, so two correct implementations need not take the same number
    of iterations there (the JAX package's own two engines differ by one);
    the scaling splits the pair."""
    A, B = jproblems.elasticity_2d(10)
    if perturbed_mass:
        w = 1.0 + 0.2 * np.random.default_rng(3).random(A.shape[0])
        B = jformats.bsr_from_scipy(sp.diags(B.to_scipy().diagonal() * w), block=(2, 2))
    return A, B


def _unstructured():
    S = jproblems.unstructured_laplacian(800, extra_edges=40, seed=5, fmt="scipy")
    A, _, perm = jrcm_pencil(S)
    return S, A, jformats.ell_from_scipy(sp.eye(800)), perm


def _q0(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 8))


def _assert_same_solve(rj, rt, nvec, max_sine=1e-6):
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) == bool(rj.converged) is True
    ej, et = np.asarray(rj.eigenvalues), rt.eigenvalues.numpy()
    assert np.all(np.diff(et) >= 0)
    np.testing.assert_allclose(et, ej, rtol=1e-8)
    assert rt.eigenvectors.shape == tuple(np.shape(rj.eigenvectors))
    sine = _max_subspace_sine(np.asarray(rj.eigenvectors)[:, :nvec],
                              rt.eigenvectors.numpy()[:, :nvec])
    assert sine < max_sine, sine


@pytest.mark.parametrize(
    "force_padded,rayleigh_ritz",
    [(False, False), (False, True), (True, True)],
    ids=["xla", "xla-rayleigh-ritz", "pallas-interpret-rayleigh-ritz"],
)
def test_generalized_inverse_elasticity_matches_jax(windowed_tile_256, force_padded,
                                                    rayleigh_ritz):
    """The flagship entry point with a tight CG inverse on the BSR pencil.
    Without Rayleigh-Ritz the quotients are per column, as in the
    reference: the padded block's tail converges slowly, so the run is long
    (~250 iterations) and every one of them must match. The interpret-mode
    run takes the Rayleigh-Ritz form (~60 iterations) to stay in the test
    budget."""
    Aj, Bj = _elasticity()
    q0 = _q0(Aj.shape[0], seed=0)
    kw = dict(nev=4, tol=1e-6, maxiter=300, shift=1e-3, rayleigh_ritz=rayleigh_ritz)
    rj = jgeneralized(Aj, Bj, inverse=jcg_factory(rtol=1e-10, maxiter=2000),
                      q0=jnp.asarray(q0), force_padded=force_padded, **kw)
    rt = tgeneralized(_bridge(Aj), _bridge(Bj), inverse=tcg_factory(rtol=1e-10, maxiter=2000),
                      q0=torch.from_numpy(q0), **kw)
    # the smallest pair is double: compare the spans of all four
    _assert_same_solve(rj, rt, nvec=4)
    assert np.isfinite(float(rt.ortho_monitor))


@pytest.mark.parametrize("force_padded", [False, True], ids=["xla", "pallas-interpret"])
def test_lobpcg_elasticity_matches_jax(windowed_tile_256, force_padded):
    """LOBPCG with the cg25 preconditioner (rtol 1e-2, 25 steps) on the BSR
    pencil, B a non-identity BSR operand."""
    Aj, Bj = _elasticity(perturbed_mass=True)
    q0 = _q0(Aj.shape[0], seed=0)
    kw = dict(nev=4, tol=1e-8, maxiter=300, shift=1e-3)
    rj = jlobpcg(Aj, Bj, precond=jcg_factory(rtol=1e-2, maxiter=25), q0=jnp.asarray(q0),
                 force_padded=force_padded, **kw)
    rt = tlobpcg(_bridge(Aj), _bridge(Bj), precond=tcg_factory(rtol=1e-2, maxiter=25),
                 q0=torch.from_numpy(q0), **kw)
    _assert_same_solve(rj, rt, nvec=4)


@pytest.mark.parametrize("force_padded", [False, True], ids=["xla", "pallas-interpret"])
def test_lobpcg_unstructured_matches_jax(windowed_tile_256, force_padded):
    """LOBPCG with the cg25 preconditioner on the RCM-ordered graph
    Laplacian (ELL), B the identity as an ELL operand. The smallest four
    eigenvalues lie within 3.3e-3 of 1 (gaps of ~6e-4), and a
    change-based stop at 1e-8 leaves their vectors converged only to about
    sqrt(1e-8)/gap; the roundoff of the two packages moves them inside that
    cluster by a few 1e-6 (measured 4.5e-6), held at 5e-5."""
    _, Aj, Bj, _ = _unstructured()
    q0 = _q0(Aj.shape[0], seed=1)
    kw = dict(nev=4, tol=1e-8, maxiter=300, shift=1e-3)
    rj = jlobpcg(Aj, Bj, precond=jcg_factory(rtol=1e-2, maxiter=25), q0=jnp.asarray(q0),
                 force_padded=force_padded, **kw)
    rt = tlobpcg(_bridge(Aj), _bridge(Bj), precond=tcg_factory(rtol=1e-2, maxiter=25),
                 q0=torch.from_numpy(q0), **kw)
    _assert_same_solve(rj, rt, nvec=4, max_sine=5e-5)


def test_generalized_inverse_f32_vs_oracle():
    """f32 elasticity pencil from the port's own generator and seeded start
    block, against ARPACK shift-invert at sigma = -shift."""
    A, B = problems.elasticity_2d(10, dtype=torch.float32, device="cpu")
    res = tgeneralized(A, B, nev=4, tol=1e-5, maxiter=300, shift=1e-3,
                       inverse=tcg_factory(rtol=1e-5, maxiter=1000))
    ref, _ = smallest_generalized(A, B, nev=4, sigma=-1e-3)
    got = res.eigenvalues.numpy()
    assert res.eigenvalues.dtype == torch.float32 and bool(res.converged)
    assert np.abs(got - ref).max() / np.abs(ref).max() < TOL


def test_lobpcg_unstructured_f32_vs_oracle():
    """f32 graph Laplacian in RCM order against ARPACK on the original
    order; the eigenvectors map back through the permutation."""
    S, _, _, _ = _unstructured()
    A, _, perm = rcm_pencil(S, dtype=torch.float32, device="cpu")
    B = ell_from_scipy(sp.eye(800), dtype=torch.float32, device="cpu")
    res = tlobpcg(A, B, nev=4, tol=1e-6, maxiter=300, shift=1e-3,
                  precond=tcg_factory(rtol=1e-2, maxiter=25))
    ref, _ = smallest_standard(S, nev=4, sigma=-1e-3)
    got = res.eigenvalues.numpy()
    assert bool(res.converged) and np.abs(got - ref).max() < TOL
    V = unpermute_vectors(res.eigenvectors.numpy()[:, :1].astype(np.float64), perm)
    r = S @ V[:, 0] - got[0] * V[:, 0]
    assert np.linalg.norm(r) / np.linalg.norm(V[:, 0]) < 5e-3


def test_seeded_start_is_reproducible():
    """Without q0 the start block is a torch.Generator draw from ``seed``:
    the same seed gives the same iterates."""
    A, B = problems.elasticity_2d(6, device="cpu")
    inv = tcg_factory(rtol=1e-8, maxiter=500)
    kw = dict(nev=3, tol=1e-6, maxiter=60, shift=1e-3, inverse=inv, seed=11)
    r1, r2 = tgeneralized(A, B, **kw), tgeneralized(A, B, **kw)
    torch.testing.assert_close(r1.eigenvalues, r2.eigenvalues, rtol=0, atol=0)
    assert r1.eigenvectors.shape == (A.shape[0], 3)


def test_default_inverses_are_refused():
    """``inverse=None``/``precond=None`` select the JAX package's
    default_inverse_factory (the RCM-banded direct engine), which is not
    ported yet: both entry points say so instead of running something
    else."""
    A, B = problems.elasticity_2d(4, device="cpu")
    with pytest.raises(ValueError, match="default_inverse_factory"):
        tgeneralized(A, B, nev=2, tol=1e-6, maxiter=10)
    with pytest.raises(ValueError, match="default_inverse_factory"):
        tlobpcg(A, B, nev=2, tol=1e-6, maxiter=10)
