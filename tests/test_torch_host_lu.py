"""The host-LU engine of the port against the JAX package's, on the CPU:
``factorize/host_lu.py`` (SuperLU on the host, row equilibration, the
level schedule, and the chunked triangular solve on the device).

The schedules are numpy in both packages and must be equal; the solves are
held to scipy's and to the JAX package's on the same right-hand sides,
numpy-seeded, f64 unless a test says otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dune_eigensolver_tpu.factorize import host_lu as jlu
from dune_eigensolver_tpu.solvers import standard_inverse as jinverse
from dune_eigensolver_tpu.sparse.formats import ell_from_scipy as jell_from_scipy
from dune_eigensolver_tpu.sparse import problems as jproblems

from dune_eigensolver_tpu_torch import factorize
from dune_eigensolver_tpu_torch.factorize import host_lu as tlu
from dune_eigensolver_tpu_torch.solvers import standard_inverse as tinverse
from dune_eigensolver_tpu_torch.sparse import dia_from_numpy, ell_from_scipy, spmm_t

torch.set_num_threads(2)


def _laplacian(N, dtype=np.float64):
    Aj = jproblems.laplacian_dirichlet_2d(N, dtype=dtype)
    return Aj, dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape, device="cpu")


def _unsymmetric(n=80):
    A = sp.random(n, n, density=0.08, random_state=np.random.RandomState(3))
    return sp.csc_matrix(A + sp.eye(n) * 4.0)


def _tri_arrays(T):
    return [np.asarray(a) for a in (T.rows, T.cols, T.vals)]


def test_schedule_matches_jax():
    """Levels and chunks of L and U (N = 16, chunks of 64): the same arrays
    as the JAX package's, the same statistics and permutations."""
    Aj, At = _laplacian(16)
    Ft = factorize.factorize(At, chunk=64)
    Fj = jlu.factorize(Aj, chunk=64, dtype=np.float64)
    assert Ft.stats == Fj.stats and Ft.n == Fj.n == 256
    assert Ft.dtype == torch.float64  # a DIA operand's own dtype, as the reference's
    for tt, tj in ((Ft.L, Fj.L), (Ft.U, Fj.U)):
        assert tt.nchunk == tj.nchunk
        for a, b in zip(_tri_arrays(tt), _tri_arrays(tj)):
            assert np.array_equal(a, b)
    for name in ("dinv", "pr_inv", "pc", "rs"):
        assert np.array_equal(getattr(Ft, name).numpy(), np.asarray(getattr(Fj, name)))
    S = sp.csr_matrix(Aj.to_scipy())
    L = sp.tril(S, k=-1, format="csr")
    assert np.array_equal(tlu._levels_from_csr(L.indptr, L.indices),
                          jlu._levels_from_csr(L.indptr, L.indices))


def test_lu_solve_laplacian(rng):
    """Within 1e-10 of scipy's SuperLU solve (the reference's bound) and
    1e-12 of the JAX package's."""
    Aj, At = _laplacian(16)
    X = rng.normal(size=(256, 8))
    Ft = factorize.factorize(At, chunk=64, dtype=torch.float64)
    Y = tlu.lu_solve(Ft, torch.from_numpy(X)).numpy()
    ref = sp.linalg.splu(sp.csc_matrix(Aj.to_scipy())).solve(X)
    assert np.abs(Y - ref).max() < 1e-10
    Yj = np.asarray(jlu.lu_solve(jlu.factorize(Aj, chunk=64, dtype=np.float64), jnp.asarray(X)))
    assert np.abs(Y - Yj).max() < 1e-12


def test_lu_solve_unsymmetric(rng):
    """An unsymmetric random operand (COLAMD, symmetric mode off): residual
    below 1e-9 (the reference's bound), the JAX solve to 1e-12."""
    A = _unsymmetric()
    X = rng.normal(size=(80, 4))
    kw = dict(chunk=32, symmetric=False, permc_spec="COLAMD")
    Ft = factorize.factorize(A, dtype=torch.float64, device="cpu", **kw)
    Y = tlu.lu_solve(Ft, torch.from_numpy(X)).numpy()
    assert np.abs(A @ Y - X).max() < 1e-9
    Yj = np.asarray(jlu.lu_solve(jlu.factorize(A, dtype=np.float64, **kw), jnp.asarray(X)))
    assert np.abs(Y - Yj).max() < 1e-12


@pytest.mark.parametrize("what", ["singular", "zero-row"])
def test_singular_raises(what):
    """An exactly singular operand raises, as in the reference: SuperLU's
    own error without the row scaling, the scaling's zero-row check with
    it."""
    A = sp.eye(10, format="csc").tolil()
    A[5, 5] = 0.0
    if what == "singular":
        with pytest.raises(RuntimeError, match="singular"):
            factorize.factorize(sp.csc_matrix(A), equilibrate=False, device="cpu")
    else:
        with pytest.raises(ZeroDivisionError, match="zero row"):
            factorize.factorize(sp.csc_matrix(A), device="cpu")


def test_lu_equilibration_ill_scaled():
    """Rows spanning ~16 orders of magnitude: with the row scaling the
    factors hold Rs*A, and the solve's relative residual stays below 1e-10
    with f64 factors and 1e-4 with f32 ones (the reference's bounds)."""
    rng = np.random.default_rng(3)
    A = jproblems.laplacian_dirichlet_2d(24, dtype=np.float64).to_scipy()
    d = 10.0 ** rng.uniform(-8, 8, size=A.shape[0])
    As = sp.csr_matrix(sp.diags(d) @ A @ sp.diags(d))
    b = As @ rng.normal(size=(A.shape[0], 4))
    F = factorize.factorize(As, dtype=torch.float64, device="cpu")
    assert F.rs is not None
    x = tlu.lu_solve(F, torch.from_numpy(b)).numpy()
    assert np.linalg.norm(As @ x - b) / np.linalg.norm(b) < 1e-10
    F32 = factorize.factorize(As, device="cpu")
    assert F32.dtype == torch.float32  # scipy input: float32, the reference's rule
    x32 = tlu.lu_solve(F32, torch.from_numpy(b.astype(np.float32))).numpy()
    assert np.linalg.norm(As @ x32.astype(np.float64) - b) / np.linalg.norm(b) < 1e-4


def test_lu_inverse_factory_in_standard_inverse():
    """``inverse=lu_inverse_factory`` (the reference reaches it through the
    API only): the pair's solve in the transposed layout solves the shifted
    operator to 1e-12, and ``standard_inverse`` on an ELL Laplacian (N =
    14) takes the JAX package's iterations and eigenvalues (1e-10) from the
    same start block."""
    Aj, _ = _laplacian(14)
    S = sp.csr_matrix(Aj.to_scipy())
    At = ell_from_scipy(S, device="cpu")
    aux, fn = factorize.lu_inverse_factory(At, chunk=64)
    assert fn.layout_t and fn.engine == "host_lu" and aux.dtype == torch.float64
    R = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 196)))
    Y = fn(aux, R)
    assert Y.is_contiguous() and (spmm_t(At, Y) - R).abs().max().item() < 1e-12
    q0 = np.random.default_rng(2).standard_normal((196, 8))
    kw = dict(nev=4, tol=1e-10, maxiter=500, shift=-1e-3)
    rt = tinverse(At, q0=torch.from_numpy(q0), inverse=factorize.lu_inverse_factory, **kw)
    rj = jinverse(jell_from_scipy(S, dtype=np.float64), q0=jnp.asarray(q0),
                  inverse=jlu.lu_inverse_factory, **kw)
    assert int(rt.iterations) == int(rj.iterations)
    assert np.abs(rt.eigenvalues.numpy() - np.asarray(rj.eigenvalues)).max() <= 1e-10
