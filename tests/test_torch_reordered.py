"""The RCM-banded direct engine of the port against the JAX package's, on
the CPU: ``factorize/reordered.py`` and the ELL/BSR branch of
``default_inverse_factory``.

The operands are a 2D Laplacian whose rows and columns are scrambled by a
seeded permutation (a band of ~n, ~N after RCM), the clamped-plate
elasticity pencil (BSR 2x2) and a random graph that RCM cannot confine.
f64; tolerances are relative to max|X| of the reference solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch

from dune_eigensolver_tpu.factorize import reordered as jreordered
from dune_eigensolver_tpu.oracle.analytic import eigenvalues_laplace_dirichlet_2d
from dune_eigensolver_tpu.solvers import standard_inverse as jinverse
from dune_eigensolver_tpu.sparse import formats as jformats
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu.sparse.spmm import spmm as jspmm

from dune_eigensolver_tpu_torch import factorize
from dune_eigensolver_tpu_torch.solvers import standard_inverse as tinverse
from dune_eigensolver_tpu_torch.sparse import (
    BSRMatrix,
    ELLMatrix,
    bsr_from_numpy,
    ell_from_scipy,
    spmm_t,
)

torch.set_num_threads(2)


def _scrambled_laplacian(N=20, seed=0, shift=0.1):
    """The reference test's operand: a shifted 2D Laplacian with rows and
    columns permuted at random."""
    S = jproblems.laplacian_dirichlet_2d(N, dtype=np.float64).to_scipy()
    S = S + shift * sp.identity(S.shape[0])
    p = np.random.default_rng(seed).permutation(S.shape[0])
    return sp.csr_matrix(S[p][:, p])


def _bandwidth(S):
    coo = sp.coo_matrix(S)
    return int(np.abs(coo.row - coo.col).max())


def test_rcm_bandwidth_matches_jax():
    """The same permutation and bandwidth as the JAX package's (both are
    scipy's RCM); the band shrinks more than 4x (the reference's bound)."""
    S = _scrambled_laplacian()
    perm_t, bw_t = factorize.rcm_bandwidth(S)
    perm_j, bw_j = jreordered.rcm_bandwidth(S)
    assert np.array_equal(perm_t, perm_j) and bw_t == bw_j
    assert bw_t < _bandwidth(S) / 4


def test_rcm_banded_solve_matches_scipy_and_jax():
    """ELL operand: the port's pair (transposed layout) within 1e-10 of
    scipy's solve (the reference's bound) and 1e-12 of the JAX pair's; the
    factorization is the banded engine's on the permuted operator, C = 128
    raised to cover nothing (band 20)."""
    S = _scrambled_laplacian()
    At = ell_from_scipy(S, device="cpu")
    aux, fn = factorize.rcm_banded_inverse_factory(At, C=128)
    auxj, fnj = jreordered.rcm_banded_inverse_factory(
        jformats.ell_from_scipy(S, dtype=np.float64), C=128, dtype=np.float64)
    assert fn.layout_t and fn.engine == "rcm_banded"
    assert aux[0].stats == auxj[0][0].stats == (20, 128, 4, "lu")
    B = np.random.default_rng(1).standard_normal((400, 8))
    Y = fn(aux, torch.from_numpy(B.T.copy())).numpy().T
    ref = spl.spsolve(S.tocsc(), B)
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 1e-10
    Yj = np.asarray(fnj(auxj, jnp.asarray(B)))
    assert np.abs(Y - Yj).max() / np.abs(Yj).max() < 1e-12


def test_residual_runs_on_the_operand_container():
    """The refinement residual multiplies by the permuted operand in the
    operand's own container (ELL for ELL, BSR for BSR), where the reference
    multiplies by its DIA form: the same operator, to 1e-13 of the
    product's largest entry (another order of summation). A scalar RCM
    permutation splits the 2x2 blocks, which the BSR form then holds with
    explicit zeros."""
    S = _scrambled_laplacian()
    aux, _ = factorize.rcm_banded_inverse_factory(ell_from_scipy(S, device="cpu"))
    Aj, Bj = jproblems.elasticity_2d(6, dtype=np.float64)
    Ab = bsr_from_numpy(np.asarray(Aj.bdata), np.asarray(Aj.bcols), Aj.shape, Aj.block,
                        Aj.nnz, device="cpu")
    auxb, fnb = factorize.rcm_banded_inverse_factory(Ab)
    assert isinstance(aux[1], ELLMatrix) and isinstance(auxb[1], BSRMatrix)
    for (F, A_res, perm, _), Ssrc in ((aux, S), (auxb, Aj.to_scipy())):
        p = perm.numpy()
        Sp = sp.csr_matrix(Ssrc)[p][:, p]
        A_dia = jformats.dia_from_scipy(Sp, dtype=np.float64)
        X = np.random.default_rng(2).standard_normal((Sp.shape[0], 4))
        ref = np.asarray(jspmm(A_dia, jnp.asarray(X)))
        got = spmm_t(A_res, torch.from_numpy(X.T.copy())).numpy().T
        assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
    B = np.random.default_rng(3).standard_normal((Ab.shape[0], 8))
    Y = fnb(auxb, torch.from_numpy(B.T.copy())).numpy().T
    ref = spl.spsolve(sp.csc_matrix(Aj.to_scipy()), B)
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 1e-10


def test_rcm_takes_a_given_permutation_and_scipy_input():
    """``perm=`` skips RCM (the identity keeps the scrambled band of ~n,
    here within 2048); a scipy operand gets its own dtype and the device
    asked for."""
    S = _scrambled_laplacian(N=12)
    aux, fn = factorize.rcm_banded_inverse_factory(S, perm=np.arange(144), device="cpu")
    assert aux[0].stats[0] == _bandwidth(S) and aux[0].dtype == torch.float64
    B = np.random.default_rng(4).standard_normal((2, 144))
    ref = spl.spsolve(S.tocsc(), B.T).T
    Y = fn(aux, torch.from_numpy(B)).numpy()
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 1e-10


def _wide_graph(n=6000, seed=0):
    """A random symmetric graph Laplacian plus I: expander-like, so RCM
    leaves a band far over 2048."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, 6 * n)
    j = rng.integers(0, n, 6 * n)
    W = sp.coo_matrix((np.ones(6 * n), (i, j)), shape=(n, n)).tocsr()
    W = W + W.T
    W.setdiag(0)
    W.eliminate_zeros()
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W
    return sp.csr_matrix(L + sp.identity(n))


def test_too_wide_a_band_raises_and_the_default_falls_back():
    """RCM cannot confine the random graph: ``ValueError`` from the engine,
    and ``default_inverse_factory`` takes Chebyshev-CG (rtol 1e-5), the
    reference's branch, which solves to that tolerance."""
    S = _wide_graph()
    assert factorize.rcm_bandwidth(S)[1] > factorize.BANDED_BW_MAX
    A = ell_from_scipy(S, device="cpu")
    with pytest.raises(ValueError, match="exceeds 2048"):
        factorize.rcm_banded_inverse_factory(A)
    aux, fn = factorize.default_inverse_factory(A)
    assert not hasattr(fn, "engine") and len(aux) == 4  # (A, 1/diag, lmin, lmax)
    R = torch.from_numpy(np.random.default_rng(5).standard_normal((2, S.shape[0])))
    Y = fn(aux, R)
    assert ((spmm_t(A, Y) - R).norm(dim=1) / R.norm(dim=1)).max().item() <= 3e-5


def test_standard_inverse_on_scrambled_ell_matches_jax():
    """End to end, no ``inverse=``: the scrambled 14x14 Laplacian as ELL
    goes through RCM + the banded engine in both packages; from the same
    start block the same iterations, eigenvalues within 1e-10 of the JAX
    package's and 1e-6 of the closed form (the reference's bound)."""
    S = _scrambled_laplacian(N=14, seed=3, shift=0.0)
    q0 = np.random.default_rng(6).standard_normal((196, 8))
    kw = dict(nev=4, tol=1e-10, maxiter=500, shift=-1e-3)
    rt = tinverse(ell_from_scipy(S, device="cpu"), q0=torch.from_numpy(q0), **kw)
    rj = jinverse(jformats.ell_from_scipy(S, dtype=np.float64), q0=jnp.asarray(q0), **kw)
    assert int(rt.iterations) == int(rj.iterations) and bool(rt.converged)
    ev = rt.eigenvalues.numpy()
    assert np.abs(ev - np.asarray(rj.eigenvalues)).max() <= 1e-10
    assert np.abs(ev - eigenvalues_laplace_dirichlet_2d(14)[:4]).max() <= 1e-6
