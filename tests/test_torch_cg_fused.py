"""The fused CG step (``kernels/cg_step.py``, ``csrc/cg_step.cu``) on the card.

``cg_solve_t`` takes the fused path for a CUDA iterate of f32 or f64 with
the Jacobi or no preconditioner and no hooks; it is held to the plain loop
``factorize/cg.py::_cg_loop`` run on the same card tensors (the same
decisions, so the same iteration count, and X to roundoff: only the
summation order of the dots differs), to itself (bit for bit: the dots are
summed in a fixed order), and each kernel to its plain version. Every test
needs an NVIDIA GPU and skips without one; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cg_fused.py -q
"""

import numpy as np
import pytest
import torch

from dune_eigensolver_tpu_torch.factorize import cg as tcg
from dune_eigensolver_tpu_torch.kernels import cg_step as cs
from dune_eigensolver_tpu_torch.sparse import problems, spmm_t

pytestmark = pytest.mark.cuda

#: X's largest difference from the plain loop's over X's largest value
X_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
#: the same for a step length or rz, summed in another order
DOT_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operator(name, dtype, device):
    """The elasticity pencil's A + 1e-3 B as 2x2 BSR (n = 2 (N-1)^2: 7,938
    and 32,258, two columns a thread in f32 and f64) or the 2D Dirichlet
    Laplacian as DIA (n = N^2: 65,025 odd, one column a thread; 65,536, four
    in f32)."""
    kind, N = name[:3], int(name[3:])
    if kind == "bsr":
        A, B = problems.elasticity_2d(N, dtype=dtype, device=device)
        return A.axpy(1e-3, B)
    return problems.laplacian_dirichlet_2d(N, dtype=dtype, device=device)


def _rhs(m, n, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((m, n))).to(device, dtype)


def _relmax(X, ref):
    return ((X - ref).abs().max() / ref.abs().max()).item()


def _both(A, B, rtol, maxiter):
    """(X, k) of ``cg_solve_t`` (fused) and of ``_cg_loop`` on the same card
    tensors; asserts that the first took the fused path."""
    inv_diag = 1.0 / A.diagonal()
    fused = tcg.cg_solve_t.fused
    X, k = tcg.cg_solve_t(lambda V: spmm_t(A, V), B, inv_diag=inv_diag, rtol=rtol,
                          maxiter=maxiter)
    assert tcg.cg_solve_t.fused == fused + 1
    X_ref, k_ref = tcg._cg_loop(lambda V: spmm_t(A, V), B, inv_diag, rtol, maxiter, None, None,
                                None)
    torch.cuda.synchronize()
    return X, k, X_ref, k_ref


@pytest.mark.parametrize("op", ["bsr64", "bsr128", "dia255", "dia256"])
@pytest.mark.parametrize("m", [8, 24])
@pytest.mark.parametrize("dtype,rtol,maxiter", [
    (torch.float32, 1e-2, 25), (torch.float64, 1e-2, 25), (torch.float64, 1e-6, 100)])
def test_fused_matches_plain_loop(cuda, op, m, dtype, rtol, maxiter):
    """The same iteration count as the plain loop and X to roundoff; the
    launches are one setup, and per step a pap and an update, and a
    direction from the second step on."""
    A = _operator(op, dtype, cuda)
    B = _rhs(m, A.shape[0], dtype, cuda)
    launches = [w.launches for w in (cs.cg_setup_cuda, cs.cg_pap_cuda, cs.cg_update_cuda,
                                     cs.cg_direction_cuda)]
    X, k, X_ref, k_ref = _both(A, B, rtol, maxiter)
    after = [w.launches for w in (cs.cg_setup_cuda, cs.cg_pap_cuda, cs.cg_update_cuda,
                                  cs.cg_direction_cuda)]
    assert k == k_ref and k > 0
    assert [b - a for a, b in zip(launches, after)] == [1, k, k, k - 1]
    assert _relmax(X, X_ref) <= X_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_repeats_its_bits_and_leaves_b(cuda, dtype):
    """Two fused solves of the same B are equal bit for bit, and B is never
    written."""
    A = _operator("bsr128", dtype, cuda)
    B = _rhs(8, A.shape[0], dtype, cuda, seed=3)
    B0 = B.clone()
    inv_diag = 1.0 / A.diagonal()
    runs = [tcg.cg_solve_t(lambda V: spmm_t(A, V), B, inv_diag=inv_diag, rtol=1e-2, maxiter=25)
            for _ in range(2)]
    assert runs[0][1] == runs[1][1] and torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(B, B0)


def test_fused_zero_rhs_rows_take_no_step(cuda):
    """A zero row of B stays zero in X; an all-zero B takes no step."""
    A = _operator("dia256", torch.float32, cuda)
    B = _rhs(8, A.shape[0], torch.float32, cuda)
    B[2] = 0.0
    X, k, X_ref, k_ref = _both(A, B, 1e-2, 25)
    assert k == k_ref and k > 0 and torch.count_nonzero(X[2]) == 0
    X, k, _, k_ref = _both(A, torch.zeros_like(B), 1e-2, 25)
    assert k == k_ref == 0 and torch.count_nonzero(X) == 0


def test_hooks_keep_the_plain_loop(cuda):
    """``gram_reduce``, ``precond_apply``, ``x0`` and a bf16 inner solve run
    ``_cg_loop``: the fused counter does not move while the apply count
    does; the same f32 apply without hooks moves it."""
    A = _operator("dia256", torch.float32, cuda)
    B = _rhs(8, A.shape[0], torch.float32, cuda)
    inv_diag = 1.0 / A.diagonal()

    def apply_a(V):
        return spmm_t(A, V)

    hooked = [
        dict(inv_diag=inv_diag, gram_reduce=lambda g: g),
        dict(precond_apply=lambda R: R * inv_diag[None, :]),
        dict(inv_diag=inv_diag, x0=torch.zeros_like(B)),
    ]
    for kw in hooked:
        calls, fused = tcg.cg_solve_t.calls, tcg.cg_solve_t.fused
        tcg.cg_solve_t(apply_a, B, rtol=1e-2, maxiter=25, **kw)
        assert tcg.cg_solve_t.calls == calls + 1 and tcg.cg_solve_t.fused == fused
    aux, fn = tcg.cg_inverse_factory(rtol=1e-2, maxiter=25, dtype=torch.bfloat16)(A)
    calls, fused = tcg.cg_solve_t.calls, tcg.cg_solve_t.fused
    fn(aux, B)
    assert tcg.cg_solve_t.calls == calls + 1 and tcg.cg_solve_t.fused == fused
    aux, fn = tcg.cg_inverse_factory(rtol=1e-2, maxiter=25)(A)
    fn(aux, B)
    assert tcg.cg_solve_t.fused == fused + 1


def test_column_layout_takes_strided_operands(cuda):
    """``cg_solve`` hands the fused path B and each AP as transposed views
    (strided, one column a thread): the plain loop's count and X."""
    A = _operator("bsr64", torch.float64, cuda)
    Bc = _rhs(6, A.shape[0], torch.float64, cuda).T.contiguous()  # (n, m)
    fused = tcg.cg_solve_t.fused
    X, k = tcg.cg_solve(lambda V: spmm_t(A, V.T.contiguous()).T.contiguous(), Bc,
                        diag=A.diagonal(), rtol=1e-6, maxiter=100)
    assert tcg.cg_solve_t.fused == fused + 1
    X_ref, k_ref = tcg._cg_loop(lambda V: spmm_t(A, V), Bc.T.contiguous(), 1.0 / A.diagonal(),
                                1e-6, 100, None, None, None)
    assert k == k_ref and _relmax(X.T, X_ref) <= X_TOL[torch.float64]


def test_strided_inv_diag_takes_the_fused_path(cuda):
    """A reciprocal diagonal that is a strided view takes the fused path
    (read contiguous) and gives the plain loop's count and X; the kernels'
    wrappers refuse it as it is."""
    A = _operator("dia255", torch.float32, cuda)
    n = A.shape[0]
    d = torch.empty(2 * n, dtype=torch.float32, device=cuda)[::2]
    d.copy_(1.0 / A.diagonal())
    B = _rhs(8, n, torch.float32, cuda)
    fused = tcg.cg_solve_t.fused
    X, k = tcg.cg_solve_t(lambda V: spmm_t(A, V), B, inv_diag=d, rtol=1e-2, maxiter=25)
    assert tcg.cg_solve_t.fused == fused + 1
    X_ref, k_ref = tcg._cg_loop(lambda V: spmm_t(A, V), B, d, 1e-2, 25, None, None, None)
    assert k == k_ref > 0 and _relmax(X, X_ref) <= X_TOL[torch.float32]
    with pytest.raises(ValueError, match="contiguous"):
        cs.cg_setup_cuda(B, d, 1e-2)


@pytest.mark.parametrize("n,dtype", [
    *((n, dt) for dt in (torch.float32, torch.float64) for n in (1000, 1002, 1001)),
    (522_242, torch.float32),  # the GenEO cell's n: V=2, ~1,020 blocks along n
    (2_097_152, torch.float32),  # V=4: 2,048 blocks' worth, two passes of 1,024
    (600_002, torch.float64),  # V=2: 1,172 blocks' worth, two passes
], ids=["v4-f32", "v2-f32", "v1-f32", "v2-f64", "v2b-f64", "v1-f64", "cell-f32",
        "two-passes-f32", "two-passes-f64"])
@pytest.mark.parametrize("m", [3, 8, 24])
@pytest.mark.parametrize("jacobi", [True, False], ids=["jacobi", "none"])
def test_kernels_match_plain_versions(cuda, n, dtype, m, jacobi):
    """Each kernel against its plain version on the same card tensors: the
    elementwise results bit for bit where the step lengths are the same,
    the dots (rz, alpha, beta) to roundoff, the flag equal. AP also as a
    strided view, which gives the same X and R. The small n take 4, 2 and 1
    columns a thread in one block along n; the large ones combine many
    blocks' partial sums (the last block's fixed-order sum), and the last
    two run the grid-stride loop twice (more than 1,024 blocks of 256
    threads' worth of columns)."""
    B = _rhs(m, n, dtype, cuda, seed=7)
    d = (1.0 + torch.rand(n, dtype=dtype, device=cuda)) if jacobi else None
    rtol = 0.5
    X, R, P, st = cs.cg_setup_cuda(B, d, rtol)
    Xr, Rr, Pr, sr = cs.cg_setup_reference(B, d, rtol)
    AP = P * (1.0 + torch.rand(m, n, dtype=dtype, device=cuda))  # P.AP > 0
    AP[0] = -AP[0]  # and one row's < 0: alpha 0 there
    assert torch.equal(X, Xr) and torch.equal(R, Rr) and torch.equal(P, Pr)
    for row in (cs.RZ, cs.TARGET):
        assert _relmax(st.vec[row], sr.vec[row]) <= DOT_TOL[dtype]
    assert st.going() == sr.going()

    cs.cg_pap_cuda(P, AP, st)
    cs.cg_pap_reference(Pr, AP, sr)
    assert _relmax(st.vec[cs.ALPHA], sr.vec[cs.ALPHA]) <= DOT_TOL[dtype]

    sr.vec.copy_(st.vec)  # the same alpha and rz on both sides from here
    X2, R2, st2 = X.clone(), R.clone(), cs.CgState(st.vec.clone(), st.ctl.clone(),
                                                    st.part.clone())
    cs.cg_update_cuda(X, R, P, AP, d, st)
    cs.cg_update_reference(Xr, Rr, Pr, AP, d, sr)
    assert torch.equal(X, Xr) and torch.equal(R, Rr)
    for row in (cs.BETA, cs.RZ):
        assert _relmax(st.vec[row], sr.vec[row]) <= DOT_TOL[dtype]
    assert st.going() == sr.going()
    cs.cg_update_cuda(X2, R2, P, AP.T.contiguous().T, d, st2)
    assert torch.equal(X2, X) and torch.equal(R2, R)

    sr.vec.copy_(st.vec)
    cs.cg_direction_cuda(R, P, d, st)
    cs.cg_direction_reference(Rr, Pr, d, sr)
    assert torch.equal(P, Pr)

