"""The standard entry points, the problem generators and the column-layout
B-orthonormalization of the port against the JAX package, on the CPU.

``standard_largest`` and ``standard_inverse`` run from the same start block
(``q0``, made with numpy) in both packages, on the 2D 5-point (N = 24, 32)
and the 3D 7-point (N = 12) Dirichlet Laplacians. In f64 the port must take
the same number of iterations and give the same eigenvalues to 1e-10
(absolute; eigenvalues are O(1)) and the same eigenspace; in f32 the
eigenvalues agree to 1e-4 (both stop on a change of 1e-4..2e-3, and
f32 roundoff moves an iterate by ~1e-6). The stop is change-based in both,
so neither is held to the exact spectrum beyond a loose envelope.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_eigensolver_tpu.factorize import cg_inverse_factory as jcg_factory
from dune_eigensolver_tpu.factorize import mg_cg_inverse_factory as jmg_cg_factory
from dune_eigensolver_tpu.ops import ortho as jortho
from dune_eigensolver_tpu.solvers import generalized_inverse as jgeneralized
from dune_eigensolver_tpu.solvers import lobpcg_generalized as jlobpcg
from dune_eigensolver_tpu.solvers import result as jresult
from dune_eigensolver_tpu.solvers import standard_inverse as jinverse
from dune_eigensolver_tpu.solvers import standard_largest as jlargest
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu.sparse.formats import DIAMatrix as JDIA

from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory as tcg_factory
from dune_eigensolver_tpu_torch.factorize import mg_cg_inverse_factory as tmg_cg_factory
from dune_eigensolver_tpu_torch.ops import ortho as tortho
from dune_eigensolver_tpu_torch.oracle import (
    eigenvalues_laplace_dirichlet_2d,
    eigenvalues_laplace_dirichlet_3d,
)
from dune_eigensolver_tpu_torch.solvers import generalized_inverse as tgeneralized
from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized as tlobpcg
from dune_eigensolver_tpu_torch.solvers import result as tresult
from dune_eigensolver_tpu_torch.solvers import standard_inverse as tinverse
from dune_eigensolver_tpu_torch.solvers import standard_largest as tlargest
from dune_eigensolver_tpu_torch.sparse import dia_from_numpy, problems

torch.set_num_threads(2)


def _laplacian(dim, N, dtype):
    """The same operand in both packages, and a numpy start block."""
    build = jproblems.laplacian_dirichlet_2d if dim == 2 else jproblems.laplacian_dirichlet_3d
    Aj = build(N, dtype=dtype)
    At = dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape, device="cpu")
    q0 = np.random.default_rng(N).standard_normal((Aj.shape[0], 8)).astype(dtype)
    return Aj, At, q0


def _max_subspace_sine(U, V):
    """Largest principal-angle sine between the column spans of U and V."""
    Qu, _ = np.linalg.qr(U)
    Qv, _ = np.linalg.qr(V)
    s = np.linalg.svd(Qu.T @ Qv, compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - s.min() ** 2)))


def _same_result(rj, rt, n, nev, f64):
    ej, et = np.asarray(rj.eigenvalues), rt.eigenvalues.numpy()
    assert et.shape == (nev,) and rt.eigenvectors.shape == (n, nev)
    assert bool(rt.converged) == bool(rj.converged)
    if f64:
        assert int(rt.iterations) == int(rj.iterations)
        assert np.abs(et - ej).max() <= 1e-10
        assert abs(float(rt.criterion) - float(rj.criterion)) <= 1e-10
        assert _max_subspace_sine(np.asarray(rj.eigenvectors), rt.eigenvectors.numpy()) <= 1e-6
    else:
        assert abs(int(rt.iterations) - int(rj.iterations)) <= 2
        assert np.abs(et - ej).max() <= 1e-4


@pytest.mark.parametrize("dim,N", [(2, 24), (2, 32), (3, 12)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rr,shift", [(False, 0.0), (True, 0.0), (False, 0.5)])
def test_standard_largest_matches_jax(dim, N, dtype, rr, shift):
    """Tolerances: module docstring. tol = 2e-3 (the reference's default),
    nev = 6 of a block of 8."""
    Aj, At, q0 = _laplacian(dim, N, dtype)
    kw = dict(nev=6, tol=2e-3, maxiter=500, shift=shift, rayleigh_ritz=rr)
    rj = jlargest(Aj, q0=jnp.asarray(q0), **kw)
    rt = tlargest(At, q0=torch.from_numpy(q0), **kw)
    _same_result(rj, rt, Aj.shape[0], 6, dtype == np.float64)
    ev = rt.eigenvalues.numpy()
    assert (np.diff(ev) <= 0).all()  # descending
    top = 4.0 * dim
    assert ev.max() < top and ev.min() > top - 1.0  # the upper end of the spectrum


@pytest.mark.parametrize("dim,N", [(2, 24), (3, 12)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rr", [False, True])
def test_standard_inverse_matches_jax(dim, N, dtype, rr):
    """Shift-invert with the Jacobi-CG inverse (rtol 1e-10 in f64, 1e-6 in
    f32) in both packages; the CG's stopping test is read once a step in
    both, so the inner iterates coincide. The smallest 6 are also within
    1e-3 of the closed form (tol 1e-5, well-separated low end)."""
    Aj, At, q0 = _laplacian(dim, N, dtype)
    rtol = 1e-10 if dtype == np.float64 else 1e-6
    kw = dict(nev=6, tol=1e-5, maxiter=100, shift=0.01, rayleigh_ritz=rr)
    rj = jinverse(Aj, q0=jnp.asarray(q0), inverse=jcg_factory(rtol=rtol, maxiter=2000), **kw)
    rt = tinverse(At, q0=torch.from_numpy(q0), inverse=tcg_factory(rtol=rtol, maxiter=2000), **kw)
    _same_result(rj, rt, Aj.shape[0], 6, dtype == np.float64)
    exact = (eigenvalues_laplace_dirichlet_2d(N)[:6] if dim == 2
             else eigenvalues_laplace_dirichlet_3d(N, count=6))
    assert np.abs(rt.eigenvalues.numpy() - exact).max() <= 1e-3


def test_standard_inverse_with_mg_cg_matches_jax():
    """The V-cycle-CG inverse on the 3D operand, f64: same iterations,
    eigenvalues to 1e-10."""
    Aj, At, q0 = _laplacian(3, 12, np.float64)
    kw = dict(nev=4, tol=1e-6, maxiter=60, shift=0.0)
    rj = jinverse(Aj, q0=jnp.asarray(q0), inverse=jmg_cg_factory(rtol=1e-9), **kw)
    rt = tinverse(At, q0=torch.from_numpy(q0), inverse=tmg_cg_factory(rtol=1e-9), **kw)
    _same_result(rj, rt, Aj.shape[0], 4, True)


def test_standard_loop_bounds_are_the_reference_ones():
    """k runs in [0, maxiter) and cannot stop before k = 2: maxiter 1 and 2
    give 1 and 2 iterations (not converged / as the change decides), and a
    huge tol stops at exactly 2, in both packages."""
    Aj, At, q0 = _laplacian(2, 24, np.float64)
    for maxiter, tol in ((1, 1e-3), (2, 1e-30), (50, 1e30)):
        rj = jlargest(Aj, nev=8, tol=tol, maxiter=maxiter, q0=jnp.asarray(q0))
        rt = tlargest(At, nev=8, tol=tol, maxiter=maxiter, q0=torch.from_numpy(q0))
        assert int(rt.iterations) == int(rj.iterations) == min(maxiter, 2)
        assert bool(rt.converged) == bool(rj.converged) == (tol > 1)


def test_standard_default_start_block_and_dtype():
    """Without ``q0`` the start block is a seeded ``torch.Generator`` draw
    on A's device (another stream than the JAX package's, so only
    determinism and the envelope are held); ``dtype`` sets its type."""
    _, At, _ = _laplacian(2, 24, np.float64)
    r1 = tlargest(At, nev=4, tol=1e-3, maxiter=200, seed=5)
    r2 = tlargest(At, nev=4, tol=1e-3, maxiter=200, seed=5)
    assert torch.equal(r1.eigenvalues, r2.eigenvalues) and r1.eigenvalues.dtype == torch.float64
    assert r1.eigenvectors.shape == (576, 4) and 7.0 < float(r1.eigenvalues[0]) < 8.0
    r3 = tinverse(At, nev=4, tol=1e-6, maxiter=50, shift=0.01,
                  inverse=tcg_factory(rtol=1e-8), seed=5)
    assert np.abs(r3.eigenvalues.numpy() - eigenvalues_laplace_dirichlet_2d(24)[:4]).max() < 1e-3


@pytest.mark.parametrize("solver", ["generalized_inverse", "lobpcg"])
def test_eval_shift_and_dtype_match_jax(solver):
    """A caller that folded the shift into A passes ``shift=0`` and
    ``eval_shift``: same iterations and eigenvalues (1e-10, f64) as the JAX
    package for the shift-invert solver; unpreconditioned LOBPCG takes ~46
    iterations whose last change sits at the tolerance, so roundoff may move
    its stop by one iteration and its eigenvalues by the tolerance (1e-8).
    Both give the eigenvalues of the unshifted pencil."""
    Aj, At, q0 = _laplacian(3, 10, np.float64)
    n = Aj.shape[0]
    Aj_sh, At_sh = Aj.with_shifted_diagonal(0.25), At.with_shifted_diagonal(0.25)
    Bj = JDIA(data=jnp.ones((1, n)), offsets=(0,), shape=Aj.shape)
    Bt = dia_from_numpy(np.ones((1, n)), (0,), Aj.shape, device="cpu")
    kw = dict(nev=4, tol=1e-8, maxiter=200, shift=0.0, eval_shift=0.25, dtype=np.float64)
    if solver == "lobpcg":
        rj = jlobpcg(Aj_sh, Bj, precond=False, q0=jnp.asarray(q0), **kw)
        kw["dtype"] = torch.float64
        rt = tlobpcg(At_sh, Bt, precond=False, q0=torch.from_numpy(q0), **kw)
    else:
        rj = jgeneralized(Aj_sh, Bj, inverse=jcg_factory(rtol=1e-10), q0=jnp.asarray(q0), **kw)
        kw["dtype"] = torch.float64
        rt = tgeneralized(At_sh, Bt, inverse=tcg_factory(rtol=1e-10), q0=torch.from_numpy(q0),
                          **kw)
    slack, tol = (1, 1e-8) if solver == "lobpcg" else (0, 1e-10)
    assert abs(int(rt.iterations) - int(rj.iterations)) <= slack
    assert np.abs(rt.eigenvalues.numpy() - np.asarray(rj.eigenvalues)).max() <= tol
    exact = eigenvalues_laplace_dirichlet_3d(10, count=4)
    assert np.abs(rt.eigenvalues.numpy() - exact).max() <= 1e-5


@pytest.mark.parametrize("descending", [False, True])
def test_sort_result_matches_jax(descending):
    rng = np.random.default_rng(2)
    ev, Q = rng.standard_normal(8), rng.standard_normal((30, 8))
    ej, Qj = jresult.sort_result(jnp.asarray(ev), jnp.asarray(Q), 5, descending)
    et, Qt = tresult.sort_result(torch.from_numpy(ev), torch.from_numpy(Q), 5, descending)
    assert np.array_equal(et.numpy(), np.asarray(ej)) and np.array_equal(Qt.numpy(), np.asarray(Qj))
    et2, Qtt = tresult.sort_result_t(torch.from_numpy(ev), torch.from_numpy(Q.T.copy()), 5,
                                     descending)
    assert torch.equal(et2, et) and torch.equal(Qtt.T, Qt)


GENERATORS = {
    "neumann": (lambda p, dt, **kw: p.laplacian_neumann_2d(7, dtype=dt, **kw)),
    "b_2d": (lambda p, dt, **kw: p.laplacian_b_2d(9, 2, dtype=dt, **kw)),
    "b_2d_overlap0": (lambda p, dt, **kw: p.laplacian_b_2d(5, 0, dtype=dt, **kw)),
    "islands": (lambda p, dt, **kw: p.laplacian_islands_2d(5, 3, dtype=dt, **kw)),
    "rect": (lambda p, dt, **kw: p.laplacian_dirichlet_rect(7, 4, dtype=dt, **kw)),
    "identity": (lambda p, dt, **kw: p.identity_on_pattern(
        p.laplacian_dirichlet_2d(6, dtype=dt, **kw), dtype=dt)),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_problem_generators_match_jax(name, dtype):
    """The same diagonals, offsets and shape: exact."""
    J = GENERATORS[name](jproblems, dtype)
    T = GENERATORS[name](problems, getattr(torch, np.dtype(dtype).name), device="cpu")
    assert T.offsets == J.offsets and T.shape == J.shape
    assert T.data.numpy().dtype == dtype
    assert np.array_equal(T.data.numpy(), np.asarray(J.data))


def test_partition_of_unity_matches_jax():
    for N, overlap in ((9, 2), (6, 0), (5, 3)):
        pu = problems.partition_of_unity_2d(N, overlap, device="cpu").numpy()
        assert np.array_equal(pu, jproblems.partition_of_unity_2d(N, overlap))


@pytest.mark.parametrize("operand", ["container", "callable"])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-11), (np.float32, 2e-5)])
def test_b_orthonormalize_blocked_column_layout(operand, dtype, tol):
    """The column-layout wrapper with the GenEO mass matrix plus a small
    shift (positive definite): X^T B X = I, the monitor and the masses
    equal the JAX package's to the dtype's roundoff."""
    Bj = jproblems.laplacian_b_2d(12, 2, dtype=dtype).with_shifted_diagonal(0.5)
    Bt = dia_from_numpy(np.asarray(Bj.data), Bj.offsets, Bj.shape, device="cpu")
    X = np.random.default_rng(4).standard_normal((144, 16)).astype(dtype)
    if operand == "callable":
        from dune_eigensolver_tpu.sparse.spmm import spmm as jspmm
        from dune_eigensolver_tpu_torch.sparse import spmm as tspmm

        bj, bt = (lambda V: jspmm(Bj, V)), (lambda V: tspmm(Bt, V))
    else:
        bj, bt = Bj, Bt
    Qj, nj, mj = jortho.b_orthonormalize_blocked(bj, jnp.asarray(X), block=8, return_mass=True)
    Qt, nt, mt = tortho.b_orthonormalize_blocked(bt, torch.from_numpy(X), block=8,
                                                 return_mass=True)
    assert Qt.shape == X.shape and mt.shape == (16,)
    assert np.abs(Qt.numpy() - np.asarray(Qj)).max() <= tol * 50
    assert abs(float(nt) - float(nj)) <= tol * max(1.0, float(nj))
    assert np.abs(mt.numpy() - np.asarray(mj)).max() <= tol * np.abs(np.asarray(mj)).max()
    G = Qt.numpy().astype(np.float64).T @ (Bt.to_scipy() @ Qt.numpy().astype(np.float64))
    assert np.abs(G - np.eye(16)).max() <= (1e-10 if dtype == np.float64 else 1e-4)
    out2 = tortho.b_orthonormalize_blocked(bt, torch.from_numpy(X), block=8)
    assert len(out2) == 2 and torch.equal(out2[0], Qt)
