"""Jacobi-CG of the PyTorch port against the JAX package.

``cg_solve_t``, ``cg_solve`` and ``cg_inverse_factory`` run on the same
shifted operators (the elasticity pencil's A + 1e-3 B as BSR, the
RCM-ordered graph Laplacian as ELL) and the same right-hand sides in both
packages. The port's loop reads the reference's stopping condition to the
host once per iteration, so the iteration counts must be equal and the
iterates agree to roundoff.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_eigensolver_tpu.factorize import cg as jcg
from dune_eigensolver_tpu.kernels.gather_spmm import make_windowed_operands
from dune_eigensolver_tpu.sparse import formats as jformats
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu.sparse.reorder import rcm_pencil as jrcm_pencil
from dune_eigensolver_tpu.sparse.spmm import spmm_t as jspmm_t
from dune_eigensolver_tpu_torch.factorize import cg as tcg
from dune_eigensolver_tpu_torch.sparse import (
    BSRMatrix,
    DIAMatrix,
    ELLMatrix,
    bsr_from_numpy,
    ell_from_numpy,
    spmm_t,
)

torch.set_num_threads(2)


def _bridge(J):
    if isinstance(J, jformats.BSRMatrix):
        return bsr_from_numpy(np.asarray(J.bdata), np.asarray(J.bcols), J.shape, J.block, J.nnz,
                              device="cpu")
    return ell_from_numpy(np.asarray(J.data), np.asarray(J.cols), J.shape, J.nnz, device="cpu")


def _operator(kind, dtype=np.float64):
    """A shifted SPD operator of the slice, as a JAX container."""
    if kind == "bsr":
        A, B = jproblems.elasticity_2d(8, dtype=dtype)
        return A.axpy(1e-3, B)
    S = jproblems.unstructured_laplacian(500, extra_edges=25, seed=5, fmt="scipy")
    return jrcm_pencil(S, dtype=dtype)[0]


def _rhs(n, m=8, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(dtype)


@pytest.mark.parametrize("kind", ["bsr", "ell"])
@pytest.mark.parametrize("rtol,maxiter", [(1e-8, 500), (1e-2, 25), (1e-12, 7)])
@pytest.mark.parametrize("with_x0", [False, True], ids=["x0=0", "x0"])
def test_cg_solve_t_matches_jax(kind, rtol, maxiter, with_x0):
    """f64, Jacobi-preconditioned: the same count of iterations (the loop
    condition is the reference's, evaluated on the host) and the same
    iterate to rtol 1e-10 of its magnitude."""
    J = _operator(kind)
    T = _bridge(J)
    n = J.shape[0]
    B = _rhs(n)
    x0 = _rhs(n, seed=1) if with_x0 else None
    Xj, kj = jcg.cg_solve_t(
        lambda V: jspmm_t(J, V), jnp.asarray(B), inv_diag=1.0 / J.diagonal(),
        rtol=rtol, maxiter=maxiter, x0=None if x0 is None else jnp.asarray(x0),
    )
    Xt, kt = tcg.cg_solve_t(
        lambda V: spmm_t(T, V), torch.from_numpy(B), inv_diag=1.0 / T.diagonal(),
        rtol=rtol, maxiter=maxiter, x0=None if x0 is None else torch.from_numpy(x0),
    )
    assert kt == int(kj) and 0 < kt <= maxiter
    Xj = np.asarray(Xj)
    np.testing.assert_allclose(Xt.numpy(), Xj, rtol=1e-10, atol=1e-10 * np.abs(Xj).max())


@pytest.mark.parametrize("kind", ["bsr", "ell"])
def test_cg_solve_column_layout_and_precond_apply(kind):
    """The column-layout wrapper, and a caller's fixed preconditioner in
    place of Jacobi, against the JAX package."""
    J = _operator(kind)
    T = _bridge(J)
    n = J.shape[0]
    B = _rhs(n, m=4, seed=2).T.copy()  # (n, m)
    Xj, kj = jcg.cg_solve(
        lambda V: jspmm_t(J, V.T).T, jnp.asarray(B), diag=J.diagonal(), rtol=1e-9, maxiter=400
    )
    Xt, kt = tcg.cg_solve(
        lambda V: spmm_t(T, V.T).T, torch.from_numpy(B), diag=T.diagonal(), rtol=1e-9, maxiter=400
    )
    assert kt == int(kj)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(Xj)).max())
    Bt = _rhs(n, seed=3)
    scale_j, scale_t = 0.5 / J.diagonal(), 0.5 / T.diagonal()
    Yj, kj = jcg.cg_solve_t(lambda V: jspmm_t(J, V), jnp.asarray(Bt), rtol=1e-9, maxiter=400,
                            precond_apply=lambda R: R * scale_j[None, :])
    Yt, kt = tcg.cg_solve_t(lambda V: spmm_t(T, V), torch.from_numpy(Bt), rtol=1e-9, maxiter=400,
                            precond_apply=lambda R: R * scale_t[None, :])
    assert kt == int(kj)
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(Yj)).max())


@pytest.mark.parametrize("kind", ["bsr", "ell"])
@pytest.mark.parametrize("rtol,maxiter", [(1e-2, 25), (1e-5, 1000)])
def test_cg_inverse_factory_matches_jax(kind, rtol, maxiter):
    """The factory's (aux, fn) pair, as the solvers call it: the LOBPCG
    preconditioner recipe (rtol 1e-2, 25 iterations) and the
    generalized_inverse recipe (rtol 1e-5, up to 1000)."""
    J = _operator(kind)
    T = _bridge(J)
    B = _rhs(J.shape[0], seed=4)
    aux_j, fn_j = jcg.cg_inverse_factory(rtol=rtol, maxiter=maxiter)(J)
    aux_t, fn_t = tcg.cg_inverse_factory(rtol=rtol, maxiter=maxiter)(T)
    assert fn_t.layout_t
    Yj = np.asarray(fn_j(aux_j, jnp.asarray(B)))
    Yt = fn_t(aux_t, torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(Yt, Yj, rtol=1e-10, atol=1e-10 * np.abs(Yj).max())


def test_cg_inverse_factory_matches_pallas_interpret():
    """The JAX side on its windowed operand, so every inner A.X runs the
    Pallas block kernel (K3) in interpret mode (tile 256 keeps the
    interpret-mode compile small). f32: the two sum in other orders, and
    CG amplifies roundoff over its 25 steps; held at 1e-4 of the output's
    magnitude."""
    J = _operator("bsr", np.float32)
    T = _bridge(J)
    W, _, L = make_windowed_operands(J, tile=256)
    B = _rhs(J.shape[0], seed=5, dtype=np.float32)
    aux_j, fn_j = jcg.cg_inverse_factory(rtol=1e-2, maxiter=25)(W)
    Yj = np.asarray(L.unpad(fn_j(aux_j, L.pad(jnp.asarray(B)))))
    aux_t, fn_t = tcg.cg_inverse_factory(rtol=1e-2, maxiter=25)(T)
    Yt = fn_t(aux_t, torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(Yt, Yj, rtol=1e-4, atol=1e-4 * np.abs(Yj).max())


def test_cg_inverse_factory_bf16_inner_solve():
    """``dtype=torch.bfloat16`` runs the whole inner CG in bf16 on the CPU
    (the plain versions accumulate SpMMs and dots in f32) and returns the
    caller's dtype: a preconditioner-grade direction, within 5% of the f32
    solve's norm-wise."""
    for kind in ("bsr", "ell"):
        T = _bridge(_operator(kind, np.float32))
        B = torch.from_numpy(_rhs(T.shape[0], seed=6, dtype=np.float32))
        aux, fn = tcg.cg_inverse_factory(rtol=1e-2, maxiter=25)(T)
        aux16, fn16 = tcg.cg_inverse_factory(rtol=1e-2, maxiter=25, dtype=torch.bfloat16)(T)
        Y, Y16 = fn(aux, B), fn16(aux16, B)
        assert Y16.dtype == torch.float32 and torch.isfinite(Y16).all()
        assert (Y16 - Y).norm() <= 5e-2 * Y.norm()


def test_cast_floating_on_every_container():
    E = _bridge(_operator("ell"))
    Bs = _bridge(_operator("bsr"))
    D = DIAMatrix(torch.ones((1, 4), dtype=torch.float64), (0,), (4, 4))
    out = tcg._cast_floating((E, Bs, [D, torch.arange(3)]), torch.float32)
    assert isinstance(out, tuple) and isinstance(out[2], list)
    assert isinstance(out[0], ELLMatrix) and out[0].data.dtype == torch.float32
    assert out[0].cols.dtype == torch.int32
    assert isinstance(out[1], BSRMatrix) and out[1].bdata.dtype == torch.float32
    assert out[1].bcols.dtype == torch.int32
    assert out[2][0].data.dtype == torch.float32 and out[2][1].dtype == torch.int64


def test_cg_zero_rhs_rows_take_no_step():
    """Rows with a zero right-hand side are converged by definition; an
    all-zero block takes no iteration, as in the reference."""
    T = _bridge(_operator("ell"))
    B = torch.zeros((8, T.shape[0]), dtype=torch.float64)
    X, k = tcg.cg_solve_t(lambda V: spmm_t(T, V), B, inv_diag=1.0 / T.diagonal())
    assert k == 0 and torch.count_nonzero(X) == 0
    J = _operator("ell")
    _, kj = jcg.cg_solve_t(lambda V: jspmm_t(J, V), jnp.zeros((8, J.shape[0])))
    assert int(kj) == 0
