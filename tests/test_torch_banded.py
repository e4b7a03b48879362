"""The block-banded direct engine of the port against the JAX package's, on
the CPU: ``factorize/banded.py``.

Host factorizations (banded Cholesky, no-pivot banded LU, bandwidth wider
than the block), the device factorization (block Cholesky and block LU with
pivoting inside the diagonal blocks, on a definite and an indefinite
operator), the sweep against the JAX factors through
``banded_factorization_from_numpy``, the refined pair, and the solvers
through the default inverse. Operands are the JAX generators' (bridged with
``dia_from_numpy``), right-hand sides numpy-seeded; f64 unless a test says
otherwise. Tolerances are relative to max|X| of the reference solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch

from dune_eigensolver_tpu.factorize import banded as jbanded
from dune_eigensolver_tpu.oracle.analytic import eigenvalues_laplace_dirichlet_2d
from dune_eigensolver_tpu.oracle.scipy_oracle import smallest_generalized
from dune_eigensolver_tpu.solvers import generalized_inverse as jgeneralized
from dune_eigensolver_tpu.solvers import standard_inverse as jinverse
from dune_eigensolver_tpu.sparse import formats as jformats
from dune_eigensolver_tpu.sparse import problems as jproblems

from dune_eigensolver_tpu_torch import factorize
from dune_eigensolver_tpu_torch.factorize import banded as tbanded
from dune_eigensolver_tpu_torch.solvers import generalized_inverse as tgeneralized
from dune_eigensolver_tpu_torch.solvers import standard_inverse as tinverse
from dune_eigensolver_tpu_torch.sparse import dia_from_numpy, spmm_t

torch.set_num_threads(2)


def _laplacian(N, shift, dtype=np.float64):
    Aj = jproblems.laplacian_dirichlet_2d(N, dtype=dtype).with_shifted_diagonal(shift)
    return Aj, _bridge(Aj)


def _bridge(Aj):
    return dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape, device="cpu")


def _rhs(n, m=8, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(dtype)


def _relerr(X, ref):
    return float(np.abs(np.asarray(X, np.float64) - ref).max() / np.abs(ref).max())


def _spsolve(At, B):
    return spl.spsolve(At.to_scipy().tocsc().astype(np.float64), B.astype(np.float64))


def _solve(F, B):
    return tbanded.banded_solve(F, torch.from_numpy(B)).numpy()


def _jax_arrays(F):
    return [np.asarray(a) for a in (F.fwd.dinv, F.fwd.sub, F.bwd.dinv, F.bwd.sub)]


def _port_arrays(F):
    return [t.numpy() for t in (F.fwd.dinv, F.fwd.sub, F.bwd.dinv, F.bwd.sub)]


@pytest.fixture
def jax_native_helper(monkeypatch):
    """Point the JAX package's bridge (its ``utils/native.py``) at the
    port's g++ build of the same host helper source, so that both packages
    run the no-pivot band LU in it, as the JAX package does once its
    ``native/`` library is built. The bridge's state is restored after the
    test."""
    from dune_eigensolver_tpu.utils import native as jnative

    from dune_eigensolver_tpu_torch.utils import native as tnative

    path = tnative.build_host()[0]
    monkeypatch.setattr(jnative, "_lib_path", lambda: path)
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    assert jnative.available()


@pytest.mark.parametrize("N,C,shift,kind", [
    (16, 128, 0.1, "cholesky"), (40, 128, 0.1, "cholesky"), (40, 256, 0.1, "cholesky"),
    (33, 128, 0.1, "cholesky"), (30, 128, -0.5, "lu"), (150, 128, 0.05, "cholesky"),
])
def test_host_factorization_matches_jax(N, C, shift, kind, jax_native_helper):
    """``factorize_banded`` (f64 on the host, as the reference's): scipy's
    Cholesky for the SPD operators, the no-pivot LU of the host helper for
    the indefinite one (shift -0.5), in both packages, k = 2 block columns
    where the band (150) exceeds C = 128. The same factor blocks as the
    JAX package's to 1e-12 of their largest, and a solve within 1e-11 of
    scipy's (1e-8 for the indefinite LU, the reference's bound). The
    helper and the numpy LU differ in rounding, which this LU's pivot
    growth (|U| up to 481 at shift -0.5) lifts to ~2e-9 of max|band|:
    ``test_torch_native_host.py`` holds them to each other."""
    Aj, At = _laplacian(N, shift)
    Fj = jbanded.factorize_banded(Aj, C=C, dtype=np.float64)
    Ft = factorize.factorize_banded(At, C=C)
    assert Ft.stats == Fj.stats and Ft.stats[3] == kind
    assert Ft.fwd.k == Fj.fwd.k == -(-N // C) and Ft.npad == Fj.npad
    for t, j in zip(_port_arrays(Ft), _jax_arrays(Fj)):
        assert t.shape == j.shape and np.abs(t - j).max() <= 1e-12 * np.abs(j).max()
    B = _rhs(N * N)
    assert _relerr(_solve(Ft, B), _spsolve(At, B)) < (1e-8 if kind == "lu" else 1e-11)


def test_host_lu_zero_pivot_raises():
    """The no-pivot band LU stops at an exactly zero pivot, as the
    reference's does."""
    band = np.array([[0.0, 1.0, 1.0], [0.0, 0.0, 0.0], [1.0, 1.0, 0.0]])  # zero diagonal
    with pytest.raises(ZeroDivisionError, match="zero pivot at row 0"):
        tbanded._lu_banded(band, 1, 3)


def test_host_factorization_f32():
    """f32 blocks of the f64 host factors: a solve within 5e-4 of scipy's
    (the reference's bound) and within 1e-5 of the JAX package's f32
    solve."""
    Aj, At = _laplacian(32, 0.1, np.float32)
    B = _rhs(32 * 32, dtype=np.float32)
    Ft = factorize.factorize_banded(At, C=128)
    assert Ft.dtype == torch.float32
    X = _solve(Ft, B)
    assert _relerr(X, _spsolve(At, B)) < 5e-4
    Xj = np.asarray(jbanded.banded_solve(jbanded.factorize_banded(Aj, C=128), jnp.asarray(B)))
    assert _relerr(X, Xj.astype(np.float64)) < 1e-5


def test_block_tridiagonal_extraction_matches_jax():
    """The (nb, C, C) diagonal, sub- and superdiagonal blocks the device
    factorization starts from, padding rows on an identity diagonal: equal
    to the JAX package's bit for bit (n = 1,600 in blocks of 128: 12.5)."""
    Aj, At = _laplacian(40, 0.1)
    blocks_j = jbanded._dia_to_block_tridiag(Aj, 128, 1664, 13, np.float64)
    blocks_t = tbanded._dia_to_block_tridiag(At, 128, 1664, 13, torch.float64)
    for t, j in zip(blocks_t, blocks_j):
        assert np.array_equal(t.numpy(), np.asarray(j))
    dense = At.to_scipy().toarray()
    assert np.array_equal(blocks_t[0][1].numpy(), dense[128:256, 128:256])
    assert np.array_equal(blocks_t[1][1].numpy(), dense[128:256, :128])
    assert np.array_equal(blocks_t[2][1].numpy(), dense[128:256, 256:384])


@pytest.mark.parametrize("method,shift", [("cholesky", 0.1), ("lu", 0.1), ("auto", -0.5)])
def test_device_factorization_matches_jax(method, shift):
    """``factorize_banded_device`` (N = 50, C = 128: 20 blocks): the same
    four block arrays as the JAX package's to 1e-10 of their largest, hence
    the same forward Dfwd = inv(L) P^T and the same placement of the
    reversed backward blocks; a solve within 1e-12 of scipy's on the
    definite operator, 1e-10 on the indefinite one (the reference's
    bounds). ``auto`` takes LU."""
    Aj, At = _laplacian(50, shift)
    Fj = jbanded.factorize_banded_device(Aj, C=128, dtype=np.float64, method=method)
    Ft = factorize.factorize_banded_device(At, C=128, method=method, validate=True)
    assert Ft.stats == Fj.stats == (50, 128, 20, "cholesky" if method == "cholesky" else "lu")
    for t, j in zip(_port_arrays(Ft), _jax_arrays(Fj)):
        assert t.shape == j.shape and np.abs(t - j).max() <= 1e-10 * np.abs(j).max()
    B = _rhs(2500)
    assert _relerr(_solve(Ft, B), _spsolve(At, B)) < (1e-12 if shift > 0 else 1e-10)


def test_device_lu_pivots_inside_the_blocks():
    """A tridiagonal operator with a zero diagonal (n = 300 even, so every
    leading block of C = 128 is nonsingular): the no-pivot band LU cannot
    start, the device block LU pivots inside the blocks and solves within
    1e-12 of scipy's, with the JAX package's factors to 1e-10. Only the
    pivots' conversion (LAPACK swaps -> P with S = P L U -> inv(L) P^T)
    makes this come out right."""
    n = 300
    data = np.zeros((3, n))
    data[0, 1:] = 1.0  # A[i, i-1]
    data[2, :-1] = 2.0  # A[i, i+1]
    At = dia_from_numpy(data, (-1, 0, 1), (n, n), device="cpu")
    Aj = jformats.DIAMatrix(data=jnp.asarray(data), offsets=(-1, 0, 1), shape=(n, n))
    with pytest.raises(ZeroDivisionError):
        factorize.factorize_banded(At, C=128)
    Ft = factorize.factorize_banded_device(At, C=128, validate=True)
    Fj = jbanded.factorize_banded_device(Aj, C=128, dtype=np.float64)
    for t, j in zip(_port_arrays(Ft), _jax_arrays(Fj)):
        assert np.abs(t - j).max() <= 1e-10 * np.abs(j).max()
    B = _rhs(n)
    assert _relerr(_solve(Ft, B), _spsolve(At, B)) < 1e-12


def test_device_cholesky_validate_raises_on_an_indefinite_operator():
    """``validate=True`` reads the per-block failure codes back once and
    raises the reference's ``ZeroDivisionError``; without it nothing is
    read and nothing raises."""
    _, At = _laplacian(30, -0.5)
    with pytest.raises(ZeroDivisionError, match="not SPD"):
        factorize.factorize_banded_device(At, C=128, method="cholesky", validate=True)
    factorize.factorize_banded_device(At, C=128, method="cholesky")
    factorize.factorize_banded_device(At, C=128, validate=True)  # LU takes it


def test_device_vs_host_factor_parity():
    """The same operator through both setup paths gives the same solve
    (1e-10 absolute, the reference's bound)."""
    _, At = _laplacian(33, 0.2)
    B = _rhs(33 * 33, seed=3)
    Xh = _solve(factorize.factorize_banded(At, C=128), B)
    Xd = _solve(factorize.factorize_banded_device(At, C=128, method="cholesky"), B)
    np.testing.assert_allclose(Xh, Xd, atol=1e-10)


@pytest.mark.parametrize("path", ["device-lu", "host-k2"])
def test_sweep_on_the_jax_factors(path):
    """The port's sweep on the JAX package's own factors (bridged with
    ``banded_factorization_from_numpy``), whatever pivots either library
    would choose: the JAX solve to 1e-12 of max|X|. ``host-k2``: a band of
    150 in blocks of 128, two subdiagonal block columns."""
    if path == "device-lu":
        Aj, _ = _laplacian(30, -0.5)
        Fj = jbanded.factorize_banded_device(Aj, C=128, dtype=np.float64)
    else:
        Aj, _ = _laplacian(150, 0.05)
        Fj = jbanded.factorize_banded(Aj, C=128, dtype=np.float64)
    Ft = factorize.banded_factorization_from_numpy(*_jax_arrays(Fj), Fj.n, Fj.stats,
                                                   device="cpu")
    assert (Ft.npad, Ft.fwd.k, Ft.stats) == (Fj.npad, Fj.fwd.k, Fj.stats)
    B = _rhs(Fj.n, seed=5)
    Xj = np.asarray(jbanded.banded_solve(Fj, jnp.asarray(B)))
    assert _relerr(_solve(Ft, B), Xj) < 1e-12


def test_bridge_checks_shapes():
    Aj, _ = _laplacian(12, 0.1)
    arrays = _jax_arrays(jbanded.factorize_banded_device(Aj, C=128, dtype=np.float64))
    with pytest.raises(ValueError, match="do not match"):
        factorize.banded_factorization_from_numpy(arrays[0][:1], *arrays[1:], 144, (12,),
                                                  device="cpu")
    with pytest.raises(ValueError, match="does not fill"):
        factorize.banded_factorization_from_numpy(*arrays, 500, (12,), device="cpu")


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 2e-5)])
def test_banded_inverse_factory_matches_jax(dtype, tol):
    """The pair the solvers get: ``((F, A), fn)`` in the transposed layout
    with one refinement step (a product with A through ``spmm_t``); the JAX
    pair's column-layout solve transposed, to ``tol`` of max|Y| (f32: the
    factors differ in rounding, refinement pulls both to the solve's
    accuracy)."""
    Aj, At = _laplacian(40, 0.1, dtype)
    auxt, fnt = factorize.banded_inverse_factory(At)
    auxj, fnj = jbanded.banded_inverse_factory(Aj)
    assert fnt.layout_t and fnt.engine == "banded" and auxt[1] is At
    assert auxt[0].stats == auxj[0].stats == (40, 256, 7, "lu")
    R = _rhs(1600, seed=2, dtype=dtype)
    Yt = fnt(auxt, torch.from_numpy(R.T.copy()))
    assert Yt.dtype == torch.from_numpy(R).dtype and Yt.is_contiguous()
    Yj = np.asarray(fnj(auxj, jnp.asarray(R))).T
    assert _relerr(Yt.numpy(), Yj.astype(np.float64)) < tol
    resid = (spmm_t(At, Yt) - torch.from_numpy(R.T.copy())).abs().max().item()
    assert resid <= (1e-12 if dtype == np.float64 else 1e-4) * np.abs(R).max()


def test_default_routes_dia_by_bandwidth():
    """``default_inverse_factory`` on DIA: the banded engine up to a band
    of 2048 (a 3D stencil at N = 12, band 144: C = 256), the iterative ones
    beyond (tests/test_torch_chebyshev.py::
    test_default_inverse_factory_routing)."""
    A3 = jproblems.laplacian_dirichlet_3d(12, dtype=np.float64)
    aux, fn = factorize.default_inverse_factory(_bridge(A3))
    assert fn.engine == "banded" and aux[0].stats == (144, 256, 7, "lu")
    assert factorize.BANDED_BW_MAX == jbanded._DEVICE_BW_MAX


def test_standard_inverse_default_matches_jax_and_closed_form():
    """``standard_inverse`` with no ``inverse=`` on the 2D Laplacian (N =
    24, shift -1e-3, tol 1e-10): the banded engine in both packages, from
    the same start block: the same iterations, eigenvalues within 1e-10 of
    the JAX package's and 1e-6 of the closed form (the reference's
    bound)."""
    Aj, At = _laplacian(24, 0.0)
    q0 = _rhs(576, seed=7)
    kw = dict(nev=4, tol=1e-10, maxiter=500, shift=-1e-3)
    rt = tinverse(At, q0=torch.from_numpy(q0), **kw)
    rj = jinverse(Aj, q0=jnp.asarray(q0), **kw)
    assert int(rt.iterations) == int(rj.iterations) and bool(rt.converged)
    ev = rt.eigenvalues.numpy()
    assert np.abs(ev - np.asarray(rj.eigenvalues)).max() <= 1e-10
    assert np.abs(ev - eigenvalues_laplace_dirichlet_2d(24)[:4]).max() <= 1e-6


def test_generalized_inverse_default_matches_jax_and_arpack():
    """``generalized_inverse`` with no ``inverse=`` on the GenEO pencil (N =
    24, overlap 3, shift 1e-3, tol 1e-8): the banded engine on A + shift B
    in both packages, the same start block: the same iterations,
    eigenvalues within 1e-9 of the JAX package's and 2e-5 of ARPACK's (the
    reference's bound)."""
    Aj = jproblems.laplacian_neumann_2d(24, dtype=np.float64)
    Bj = jproblems.laplacian_b_2d(24, 3, dtype=np.float64)
    At, Bt = _bridge(Aj), _bridge(Bj)
    q0 = _rhs(576, seed=8)
    kw = dict(nev=4, tol=1e-8, maxiter=300, shift=1e-3, min_iter=3)
    rt = tgeneralized(At, Bt, q0=torch.from_numpy(q0), **kw)
    rj = jgeneralized(Aj, Bj, q0=jnp.asarray(q0), **kw)
    assert int(rt.iterations) == int(rj.iterations) and bool(rt.converged)
    ev = rt.eigenvalues.numpy()
    assert np.abs(ev - np.asarray(rj.eigenvalues)).max() <= 1e-9
    ref, _ = smallest_generalized(Aj, Bj, nev=4, sigma=-1e-3)
    np.testing.assert_allclose(ev, ref, atol=2e-5)


def test_solve_linear_system_takes_the_banded_engine():
    """The single-RHS sanity solve through the default engine (1e-12)."""
    _, At = _laplacian(20, 0.3)
    b = _rhs(400, m=1, seed=9)[:, 0]
    x = factorize.solve_linear_system(At, b)
    assert _relerr(x.numpy(), spl.spsolve(sp.csc_matrix(At.to_scipy()), b)) < 1e-12
