"""The CG step's plain versions (``kernels/cg_step.py``) against the plain
loop ``factorize/cg.py::_cg_loop``, on the CPU.

Each plain version repeats ``_cg_loop``'s arithmetic operation for
operation, so chained over a few steps they give its X, R and P bit for bit,
and chained as ``_cg_fused`` chains the kernels, with its stop read, they
give its X and iteration count. ``_cg_loop``'s
R and P are read where it hands them on: P to the operator, R to the
preconditioner (``precond_apply`` set to the Jacobi scaling, the same
arithmetic as its ``inv_diag`` path). No JAX: the JAX parity of the loop is
``test_torch_cg.py``'s.
"""

import numpy as np
import pytest
import torch

from dune_eigensolver_tpu_torch.factorize import cg as tcg
from dune_eigensolver_tpu_torch.kernels import cg_step as cs
from dune_eigensolver_tpu_torch.sparse import problems, spmm_t

torch.set_num_threads(2)


def _operator(kind, dtype):
    """A shifted SPD operator: the elasticity pencil's A + 1e-3 B (BSR) or
    the 2D Dirichlet Laplacian (DIA)."""
    if kind == "bsr":
        A, B = problems.elasticity_2d(8, dtype=dtype, device="cpu")
        return A.axpy(1e-3, B)
    return problems.laplacian_dirichlet_2d(15, dtype=dtype, device="cpu")


def _rhs(n, m, dtype, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((m, n))).to(dtype)


def _recorded_loop(A, B, inv_diag, maxiter):
    """``_cg_loop`` run to ``maxiter`` steps (rtol 0 never stops it earlier),
    with the P it hands the operator and the R it hands the preconditioner
    at each step."""
    Ps, Rs = [], []

    def apply_a(P):
        Ps.append(P.clone())
        return spmm_t(A, P)

    def precond(R):
        Rs.append(R.clone())
        return R if inv_diag is None else R * inv_diag[None, :]

    X, k = tcg._cg_loop(apply_a, B, None, 0.0, maxiter, None, precond, None)
    assert k == maxiter
    return X, Ps, Rs


@pytest.mark.parametrize("kind", ["bsr", "dia"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("jacobi", [True, False], ids=["jacobi", "none"])
def test_plain_chain_matches_cg_loop_bits(kind, dtype, jacobi):
    """Setup, then per step direction (from the second), pap and update:
    R and P equal ``_cg_loop``'s at every step, X after the last."""
    A = _operator(kind, dtype)
    inv_diag = 1.0 / A.diagonal() if jacobi else None
    B = _rhs(A.shape[0], 5, dtype)
    steps = 6
    X_ref, Ps, Rs = _recorded_loop(A, B, inv_diag, steps)
    X, R, P, st = cs.cg_setup_reference(B, inv_diag, 0.0)
    assert torch.equal(R, Rs[0]) and torch.equal(P, Ps[0])
    for k in range(steps):
        if k:
            cs.cg_direction_reference(R, P, inv_diag, st)
            assert torch.equal(P, Ps[k])
        AP = spmm_t(A, P)
        cs.cg_pap_reference(P, AP, st)
        cs.cg_update_reference(X, R, P, AP, inv_diag, st)
        assert torch.equal(R, Rs[k + 1])
        assert st.going()
    assert torch.equal(X, X_ref)


def _plain_apply(apply_a, B, inv_diag, rtol, maxiter):
    """An apply of the plain versions in ``_cg_fused``'s order, with its stop
    read: (X, iterations)."""
    X, R, P, st = cs.cg_setup_reference(B, inv_diag, rtol)
    k = 0
    while k < maxiter and st.going():
        if k:
            cs.cg_direction_reference(R, P, inv_diag, st)
        AP = apply_a(P)
        cs.cg_pap_reference(P, AP, st)
        cs.cg_update_reference(X, R, P, AP, inv_diag, st)
        k += 1
    return X, k


@pytest.mark.parametrize("kind", ["bsr", "dia"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rtol,maxiter", [(1e-2, 25), (1e-6, 400)])
def test_plain_versions_stop_where_cg_loop_stops(kind, dtype, rtol, maxiter):
    """The plain versions' flag reads the stop condition of ``_cg_loop``:
    the same iteration count and X bit for bit, converged or capped."""
    A = _operator(kind, dtype)
    inv_diag = 1.0 / A.diagonal()
    B = _rhs(A.shape[0], 8, dtype, seed=1)

    def apply_a(V):
        return spmm_t(A, V)

    X_ref, k_ref = tcg._cg_loop(apply_a, B, inv_diag, rtol, maxiter, None, None, None)
    X, k = _plain_apply(apply_a, B, inv_diag, rtol, maxiter)
    assert k == k_ref and 0 < k <= maxiter
    assert torch.equal(X, X_ref)


def test_plain_versions_zero_rhs_rows_take_no_step():
    """A zero row of B stays zero in X and drives no step; an all-zero B
    takes none, as in ``_cg_loop``; the caller's B is never written."""
    A = _operator("bsr", torch.float64)
    inv_diag = 1.0 / A.diagonal()
    B = _rhs(A.shape[0], 4, torch.float64)
    B[1] = 0.0
    B0 = B.clone()

    def apply_a(V):
        return spmm_t(A, V)

    X, k = _plain_apply(apply_a, B, inv_diag, 1e-8, 500)
    X_ref, k_ref = tcg._cg_loop(apply_a, B, inv_diag, 1e-8, 500, None, None, None)
    assert k == k_ref > 0 and torch.equal(X, X_ref) and torch.count_nonzero(X[1]) == 0
    assert torch.equal(B, B0)
    X, k = _plain_apply(apply_a, torch.zeros_like(B), inv_diag, 1e-8, 500)
    assert k == 0 and torch.count_nonzero(X) == 0


def test_cpu_solves_keep_the_plain_loop():
    """On the CPU ``cg_solve_t`` runs ``_cg_loop``: ``takes`` refuses a CPU
    iterate, and the fused counter does not move while the others do."""
    A = _operator("dia", torch.float32)
    inv_diag = 1.0 / A.diagonal()
    B = _rhs(A.shape[0], 8, torch.float32)
    assert not cs.takes(B, inv_diag)
    calls, fused, steps = tcg.cg_solve_t.calls, tcg.cg_solve_t.fused, tcg.cg_solve_t.steps
    _, k = tcg.cg_solve_t(lambda V: spmm_t(A, V), B, inv_diag=inv_diag, rtol=1e-2, maxiter=25)
    assert tcg.cg_solve_t.calls == calls + 1 and tcg.cg_solve_t.steps == steps + k
    assert tcg.cg_solve_t.fused == fused
