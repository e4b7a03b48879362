"""The iterative inverse engines of the port against the JAX package, on
the CPU: ``chebyshev_apply_t``, the Chebyshev and Chebyshev-CG factories,
``mg_cg_inverse_factory``, and ``default_inverse_factory``'s routing.

The power iteration that estimates the spectral bound starts from a random
block (a ``jax.random`` key there, a ``torch.Generator`` here), so the two
packages' bounds differ in the last digits; the solves are compared by
handing the JAX solve functions the port's bounds. Operands and right-hand
sides come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dune_eigensolver_tpu.factorize import chebyshev as jcheb
from dune_eigensolver_tpu.factorize import mg_cg_inverse_factory as jmg_cg_factory
from dune_eigensolver_tpu.solvers import standard_inverse as jinverse
from dune_eigensolver_tpu.sparse import formats as jformats
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu.sparse.spmm import spmm_t as jspmm_t

from dune_eigensolver_tpu_torch import factorize
from dune_eigensolver_tpu_torch.factorize import chebyshev as tcheb
from dune_eigensolver_tpu_torch.solvers import generalized_inverse as tgeneralized
from dune_eigensolver_tpu_torch.solvers import standard_inverse as tinverse
from dune_eigensolver_tpu_torch.sparse import (
    DIAMatrix,
    bsr_from_numpy,
    dia_from_numpy,
    ell_from_numpy,
    problems,
    spmm_t,
)

torch.set_num_threads(2)


def _bridge(J):
    """A JAX container as the port's, on the CPU."""
    if isinstance(J, jformats.DIAMatrix):
        return dia_from_numpy(np.asarray(J.data), J.offsets, J.shape, device="cpu")
    if isinstance(J, jformats.BSRMatrix):
        return bsr_from_numpy(np.asarray(J.bdata), np.asarray(J.bcols), J.shape, J.block, J.nnz,
                              device="cpu")
    return ell_from_numpy(np.asarray(J.data), np.asarray(J.cols), J.shape, J.nnz, device="cpu")


def _operand(dim, N, dtype, shift=0.05):
    build = jproblems.laplacian_dirichlet_2d if dim == 2 else jproblems.laplacian_dirichlet_3d
    Aj = build(N, dtype=dtype).with_shifted_diagonal(shift)
    At = dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape, device="cpu")
    R = np.random.default_rng(N).standard_normal((4, Aj.shape[0])).astype(dtype)
    return Aj, At, R


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 2e-5)])
@pytest.mark.parametrize("degree", [4, 7, 17])
@pytest.mark.parametrize("jacobi", [True, False])
def test_chebyshev_apply_t_matches_jax(dtype, tol, degree, jacobi):
    """The same recurrence in both (an even degree is rounded up to odd in
    both): relative to max|W|, f64 1e-12, f32 2e-5 (up to 17 dependent
    SpMM + axpy steps)."""
    Aj, At, R = _operand(2, 20, dtype)
    lmin, lmax = 0.07, 2.1
    dj = 1.0 / Aj.diagonal() if jacobi else None
    dt_ = 1.0 / At.diagonal() if jacobi else None
    Wj = np.asarray(jcheb.chebyshev_apply_t(lambda V: jspmm_t(Aj, V), jnp.asarray(R), lmin, lmax,
                                            degree, dj))
    Wt = tcheb.chebyshev_apply_t(lambda V: spmm_t(At, V), torch.from_numpy(R), lmin, lmax,
                                 degree, dt_)
    assert Wt.dtype == torch.from_numpy(R).dtype and Wt.shape == R.shape
    assert np.abs(Wt.numpy() - Wj).max() <= tol * np.abs(Wj).max()
    # the column-layout wrapper is the same function transposed
    Wc = tcheb.chebyshev_apply(lambda X: spmm_t(At, X.T.contiguous()).T, torch.from_numpy(R).T,
                               lmin, lmax, degree, dt_)
    assert torch.equal(Wc.T, Wt)


def test_power_iteration_bounds_the_spectrum():
    """lmax of D^-1 A from 40 power steps of an 8-row block: within 3% below
    the true value (dense eigvalsh), deterministic for a seeded generator,
    on the operand's device."""
    _, At, _ = _operand(2, 16, np.float64)
    S = At.to_scipy().toarray()
    d = np.diag(S)
    true = np.linalg.eigvalsh(S / np.sqrt(np.outer(d, d))).max()
    est = [
        float(tcheb._power_lmax_t(lambda V: spmm_t(At, V), 1.0 / At.diagonal(), At.shape[0],
                                  torch.float64, 40, torch.Generator().manual_seed(s)))
        for s in (42, 42, 7)
    ]
    assert est[0] == est[1]
    assert all(0.97 * true <= e <= true * (1 + 1e-12) for e in est)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-11), (np.float32, 5e-5)])
@pytest.mark.parametrize("kind", ["cheb", "cheb_cg"])
def test_chebyshev_factories_match_jax(kind, dtype, tol):
    """The port's factory sets up (operand, 1/diag, lmin, lmax); the JAX
    package's solve function, given those bounds, returns the same block
    (f64 1e-11, f32 5e-5 of max|Y|), and for Chebyshev-CG the result solves
    the system to its rtol."""
    Aj, At, R = _operand(3, 10, dtype)
    Rt = torch.from_numpy(R)
    if kind == "cheb":
        aux, fn = factorize.chebyshev_inverse_factory(degree=9, cond_target=20.0)(At)
        jfn = jcheb._cheb_solve_fn(9, True)
    else:
        aux, fn = factorize.cheb_cg_inverse_factory(degree=5, rtol=1e-6, maxiter=80)(At)
        jfn = jcheb._cheb_cg_solve_fn(5, 1e-6, 80)
    assert fn.layout_t and aux[0] is At
    lmin, lmax = float(aux[2]), float(aux[3])
    assert abs(lmax / lmin - (20.0 if kind == "cheb" else 30.0)) < 1e-6 and 1.5 < lmax < 2.3
    Yt = fn(aux, Rt)
    Yj = np.asarray(jfn((Aj, 1.0 / Aj.diagonal(), jnp.asarray(lmin, dtype), jnp.asarray(lmax, dtype)),
                        jnp.asarray(R)))
    assert Yt.dtype == Rt.dtype
    assert np.abs(Yt.numpy() - Yj).max() <= tol * np.abs(Yj).max()
    if kind == "cheb_cg":
        resid = (spmm_t(At, Yt) - Rt).norm(dim=1) / Rt.norm(dim=1)
        assert resid.max().item() <= (2e-6 if dtype == np.float64 else 1e-5)


def test_chebyshev_factory_options():
    _, At, R = _operand(2, 16, np.float32)
    Rt = torch.from_numpy(R)
    for bad in (dict(cond_target=1.0), dict(degree=0)):
        with pytest.raises(ValueError):
            factorize.chebyshev_inverse_factory(**bad)
        with pytest.raises(ValueError):
            factorize.cheb_cg_inverse_factory(**bad)
    # an explicit generator for the power iteration's start block
    a1, f1 = factorize.chebyshev_inverse_factory(generator=torch.Generator().manual_seed(1))(At)
    a2, _ = factorize.chebyshev_inverse_factory(generator=torch.Generator().manual_seed(1))(At)
    a3, _ = factorize.chebyshev_inverse_factory()(At)
    assert float(a1[3]) == float(a2[3]) and abs(float(a1[3]) / float(a3[3]) - 1) < 0.03
    # no Jacobi scaling: bounds of A itself; bf16 streaming: f32 out, close
    a4, f4 = factorize.chebyshev_inverse_factory(jacobi=False)(At)
    assert a4[1] is None and 7.0 < float(a4[3]) < 9.0
    a5, f5 = factorize.chebyshev_inverse_factory(dtype=torch.bfloat16)(At)
    Y, Y16 = f1(a1, Rt), f5(a5, Rt)
    assert Y16.dtype == torch.float32
    assert (Y16 - Y).abs().max().item() <= 0.05 * Y.abs().max().item()
    # an even degree is the next odd one
    _, f6 = factorize.chebyshev_inverse_factory(degree=16)(At)
    assert torch.equal(f6(a1, Rt), f1(a1, Rt))


@pytest.mark.parametrize("dim,N", [(2, 24), (3, 12)])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-4)])
def test_mg_cg_inverse_factory_matches_jax(dim, N, dtype, tol):
    """V-cycle-preconditioned CG to rtol 1e-8 (f64) / 1e-5 (f32): the same
    steps in both, so the solutions agree far below the CG's own tolerance
    in f64 (1e-10 of max|Y|) and to 1e-4 in f32; the residual meets rtol."""
    Aj, At, R = _operand(dim, N, dtype, shift=0.0)
    rtol = 1e-8 if dtype == np.float64 else 1e-5
    auxj, fnj = jmg_cg_factory(rtol=rtol, maxiter=60)(Aj)
    auxt, fnt = factorize.mg_cg_inverse_factory(rtol=rtol, maxiter=60)(At)
    Yj = np.asarray(fnj(auxj, jnp.asarray(R)))
    Yt = fnt(auxt, torch.from_numpy(R))
    assert fnt.layout_t and Yt.dtype == torch.from_numpy(R).dtype
    assert np.abs(Yt.numpy() - Yj).max() <= tol * np.abs(Yj).max()
    Rt = torch.from_numpy(R)
    assert ((spmm_t(At, Yt) - Rt).norm(dim=1) / Rt.norm(dim=1)).max().item() <= 3 * rtol
    with pytest.raises(ValueError, match="structured"):
        bad = DIAMatrix(data=At.data[:3], offsets=(-2, 0, 2), shape=At.shape)
        factorize.mg_cg_inverse_factory()(bad)


def _wide_dia(n, far, low=()):
    """A diagonally dominant DIA operand with offsets (+-1, +-far) that is no
    grid stencil; ``low`` replaces the first diagonal entries, which
    separates as many eigenvalues at the low end."""
    rng = np.random.default_rng(0)
    data = np.zeros((5, n), np.float32)
    data[2] = 4.0 + rng.random(n)
    data[2, 100:100 + len(low)] = low
    data[1, 1:] = data[3, :-1] = -1.0
    data[0, far:] = data[4, :-far] = -1.0
    return dia_from_numpy(data, (-far, -1, 0, 1, far), (n, n), device="cpu")


def test_default_inverse_factory_routing():
    """The reference's routing for the iterative branches: a 3D stencil
    wider than the banded engine's limit gets V-cycle-CG (rtol 1e-5, at most
    100 steps), another wide DIA Chebyshev-CG (1e-5, 300); both solve to
    that tolerance."""
    N = 46  # N^2 = 2116 > 2048
    A3 = problems.laplacian_dirichlet_3d(N, dtype=torch.float32, device="cpu")
    aux, fn = factorize.default_inverse_factory(A3)
    assert fn.layout_t and aux[0] is A3 and len(aux) == 2  # (A, 1/diag): the MG-CG pair
    R = torch.from_numpy(np.random.default_rng(1).standard_normal((2, N**3)).astype(np.float32))
    Y = fn(aux, R)
    assert ((spmm_t(A3, Y) - R).norm(dim=1) / R.norm(dim=1)).max().item() <= 3e-5

    Aw = _wide_dia(10_000, 3_000)  # 10,000 is no multiple of 3,000: no grid
    aux, fn = factorize.default_inverse_factory(Aw)
    assert fn.layout_t and len(aux) == 4  # (A, 1/diag, lmin, lmax): Chebyshev-CG
    R = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 10_000)).astype(np.float32))
    Y = fn(aux, R)
    assert ((spmm_t(Aw, Y) - R).norm(dim=1) / R.norm(dim=1)).max().item() <= 3e-5
    x = factorize.solve_linear_system(Aw, R[0].numpy())
    assert torch.equal(x, Y[0])


@pytest.mark.parametrize("kind", ["dia-2d", "dia-3d-narrow", "ell", "bsr"])
def test_default_inverse_factory_refuses_the_banded_branches(kind):
    """Where the reference takes the block-banded or the RCM-banded direct
    engine, the port takes it too (the name is from when the port refused
    these branches): the pair names the engine and its blocks, and
    ``standard_inverse`` with no ``inverse=`` gives the JAX default's
    iterations and eigenvalues (1e-9) from the same start block, f64."""
    if kind == "dia-2d":
        Aj = jproblems.laplacian_dirichlet_2d(40, dtype=np.float64)
        engine, stats = "banded", (40, 256, 7, "lu")
    elif kind == "dia-3d-narrow":
        Aj = jproblems.laplacian_dirichlet_3d(12, dtype=np.float64)
        engine, stats = "banded", (144, 256, 7, "lu")
    elif kind == "ell":
        S = jproblems.laplacian_dirichlet_2d(20, dtype=np.float64).to_scipy()
        p = np.random.default_rng(0).permutation(400)
        Aj = jformats.ell_from_scipy(sp.csr_matrix(S[p][:, p]), dtype=np.float64)
        engine, stats = "rcm_banded", (20, 256, 2, "lu")
    else:
        Aj = jproblems.elasticity_2d(4, dtype=np.float64)[0]
        engine, stats = "rcm_banded", None
    At = _bridge(Aj)
    aux, fn = factorize.default_inverse_factory(At)
    assert fn.engine == engine and fn.layout_t
    if stats is not None:
        assert aux[0].stats == stats
    n = At.shape[0]
    q0 = np.random.default_rng(n).standard_normal((n, 8))
    kw = dict(nev=2, tol=1e-9, maxiter=200, shift=-1e-3)
    rt = tinverse(At, q0=torch.from_numpy(q0), **kw)
    rj = jinverse(Aj, q0=jnp.asarray(q0), **kw)
    assert int(rt.iterations) == int(rj.iterations)
    assert np.abs(rt.eigenvalues.numpy() - np.asarray(rj.eigenvalues)).max() <= 1e-9 * max(
        1.0, np.abs(np.asarray(rj.eigenvalues)).max())


def test_default_inverse_serves_the_entry_points():
    """``inverse=None`` on a wide non-stencil DIA pencil: ``standard_inverse``
    and ``generalized_inverse`` run through Chebyshev-CG and agree with a
    dense eigensolve to 1e-3 (f32, tol 1e-6; the three smallest eigenvalues
    are separated by construction, so the change-based stop is sharp)."""
    Aw = _wide_dia(2_600, 2_100, low=(2.2, 2.6, 3.0))
    exact = np.linalg.eigvalsh(Aw.to_scipy().toarray().astype(np.float64))[:3]
    r = tinverse(Aw, nev=3, tol=1e-6, maxiter=200, seed=1)
    assert np.abs(r.eigenvalues.numpy() - exact).max() <= 1e-3
    B = problems.identity_on_pattern(Aw)
    g = tgeneralized(Aw, B, nev=3, tol=1e-6, maxiter=200, seed=1)
    assert np.abs(g.eigenvalues.numpy() - exact).max() <= 1e-3
