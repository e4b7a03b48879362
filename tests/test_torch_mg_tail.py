"""The multigrid V-cycle's coarse tail as one kernel (``kernels/mg_tail.py``,
``csrc/mg_tail.cu``) on the card.

The kernel is held to its plain version, the eager recursion
``factorize/multigrid.py::_vcycle_coarse`` run on the same card tensors
(``mg_tail_reference``): bit for bit where the coarsest grid is one point
(every dot of the CG one term, so nothing is summed in another order),
and within a stated tolerance where the coarsest CG sums its dots in
another order; to itself bit for bit; and one launch a V-cycle on the
north star's path. Every test needs an NVIDIA GPU and skips without one;
the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_mg_tail.py -q
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dune_eigensolver_tpu_torch.factorize import multigrid as tmg
from dune_eigensolver_tpu_torch.kernels import mg_tail as mt
from dune_eigensolver_tpu_torch.sparse import problems

pytestmark = pytest.mark.cuda

#: The tail's largest difference from the eager tail's over the eager tail's
#: largest value, where the coarsest CG (f32, 48 steps) sums its dots in
#: another order. The CG's x then differs by f32 roundoff; on bf16 levels it
#: is rounded to bf16 (x.to(b.dtype)), where a value near a rounding boundary
#: may land one bf16 ulp (2^-8 relative) apart, and prolongation and
#: smoothing carry such a flip on with weights below one, rounding again at
#: each operation: 2^-6, four ulps of the largest value. On f32 and f64
#: levels nothing rounds the CG's roundoff up: 1e-5.
TAIL_TOL = {torch.bfloat16: 2.0**-6, torch.float32: 1e-5, torch.float64: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _coeffs(nd, shift, device):
    """``_sampled_coeffs``' (a_fine, sigma) of the 2D/3D Dirichlet Laplacian
    with ``shift`` on its diagonal, as the V-cycle samples them."""
    dims = (8,) * nd
    A = (problems.laplacian_dirichlet_3d if nd == 3 else problems.laplacian_dirichlet_2d)(
        8, dtype=torch.float32, device=device)
    data = A.data.clone()
    data[A.offsets.index(0)] += shift
    _, a_fine, sigma = tmg._sampled_coeffs(SimpleNamespace(data=data, offsets=A.offsets), dims)
    return a_fine, sigma


def _rhs(m, dims, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((m,) + tuple(dims))).to(device, dtype)


def _pair(levels, level, b, nd, shift=0.0, iters=48, nu1=1, nu2=1):
    """(kernel, eager) tails on the same card tensors."""
    a_fine, sigma = _coeffs(nd, shift, b.device)
    args = (levels, level, b, a_fine, sigma, nu1, nu2, 0.8, iters)
    launches = mt.mg_tail_cuda.launches
    X = mt.mg_tail_cuda(*args)
    assert mt.mg_tail_cuda.launches == launches + 1
    X_ref = mt.mg_tail_reference(*args)
    torch.cuda.synchronize()
    assert X.shape == b.shape and X.dtype == b.dtype
    return X, X_ref


def _relmax(X, ref):
    return ((X.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


@pytest.mark.parametrize("N", [54, 108, 216])
def test_fit_rule_enters_at_27_on_the_card(cuda, N):
    """The north star's bf16 V-cycles enter the kernel at 27^3 (level 1, 2,
    3 of the 54^3, 108^3, 216^3 cycles) under the card's own limit."""
    levels = tmg._coarse_levels((N,) * 3, 6)
    start = mt.tail_start(levels, 1, torch.bfloat16, mt.smem_optin(cuda))
    assert levels[start] == (27, 27, 27)
    b = torch.zeros((2,) + levels[start], dtype=torch.bfloat16, device=cuda)
    assert mt.takes(b, levels, start)
    assert start == 1 or not mt.takes(torch.zeros((2,) + levels[start - 1], dtype=torch.bfloat16,
                                                  device=cuda), levels, start - 1)


@pytest.mark.parametrize("N", [54, 108, 216])
def test_tail_matches_eager_at_the_cell_entries(cuda, N):
    """m = 24 bf16 rows at the 27^3 entry of each nested level's V-cycle
    (its couplings scaled by 4^-1, 4^-2, 4^-3)."""
    levels = tmg._coarse_levels((N,) * 3, 6)
    start = mt.tail_start(levels, 1, torch.bfloat16, mt.smem_optin(cuda))
    b = _rhs(24, levels[start], torch.bfloat16, cuda, seed=N)
    X, X_ref = _pair(levels, start, b, 3)
    assert _relmax(X, X_ref) <= TAIL_TOL[torch.bfloat16]


#: chains whose coarsest grid is one point: (dims, min_coarse), odd and even
#: extents (27 -> 13 -> 6 -> 3 -> 1; 26 even; 20 x 27 x 16 mixed), 2D and 3D
ONE_POINT = [((27, 27, 27), 1), ((26, 26, 26), 1), ((20, 27, 16), 1), ((27, 27), 1),
             ((20, 31), 1)]


@pytest.mark.parametrize("dims,min_coarse", ONE_POINT)
@pytest.mark.parametrize("dtype", mt.TAIL_DTYPES)
@pytest.mark.parametrize("nu", [(1, 1), (2, 2)])
def test_tail_equals_eager_bit_for_bit(cuda, dims, min_coarse, dtype, nu):
    """Where the coarsest grid is one point every dot is one term, so the
    kernel computes what the eager recursion computes, operation for
    operation: the same bits, through smoothing, restriction, prolongation
    and the CG's guards (its residual vanishes after one step). The tail
    starts where the card's limit admits it (13^3 for f32 and f64 levels
    under 27^3)."""
    levels = tmg._coarse_levels(dims, min_coarse)
    assert levels[-1] == (1,) * len(dims)
    start = mt.tail_start(levels, 0, dtype, mt.smem_optin(cuda))
    b = _rhs(5, levels[start], dtype, cuda, seed=len(dims))
    X, X_ref = _pair(levels, start, b, len(dims), shift=0.1, nu1=nu[0], nu2=nu[1])
    assert torch.equal(X, X_ref)


@pytest.mark.parametrize("dims", [(27, 27, 27), (13, 13, 13), (20, 27, 16), (64, 64), (45, 31)])
@pytest.mark.parametrize("dtype", mt.TAIL_DTYPES)
def test_tail_matches_eager(cuda, dims, dtype):
    """2D and 3D grids, odd and even extents, each level type, from the
    first level the card's limit admits, down to a 6-wide coarsest grid."""
    levels = tmg._coarse_levels(dims, 6)
    start = mt.tail_start(levels, 0, dtype, mt.smem_optin(cuda))
    b = _rhs(6, levels[start], dtype, cuda, seed=7)
    X, X_ref = _pair(levels, start, b, len(dims), shift=0.05)
    assert _relmax(X, X_ref) <= TAIL_TOL[dtype]


@pytest.mark.parametrize("dtype", mt.TAIL_DTYPES)
def test_zero_row_takes_the_guards(cuda, dtype):
    """A zero row: rz and p.Ap are 0, so alpha and beta are 0 by the guards,
    and the row's correction is 0, as the eager tail's; the other rows are
    untouched by it."""
    levels = tmg._coarse_levels((54, 54, 54), 6)
    start = mt.tail_start(levels, 1, dtype, mt.smem_optin(cuda))
    b = _rhs(4, levels[start], dtype, cuda, seed=3)
    b[1] = 0
    X, X_ref = _pair(levels, start, b, 3)
    assert not X[1].any() and not X_ref[1].any()
    alone = mt.mg_tail_cuda(levels, start, b[[0, 2, 3]].contiguous(), *_coeffs(3, 0.0, cuda), 1,
                            1, 0.8, 48)
    assert torch.equal(alone, X[[0, 2, 3]])
    assert _relmax(X, X_ref) <= TAIL_TOL[dtype]


@pytest.mark.parametrize("dtype", mt.TAIL_DTYPES)
def test_tail_bits_repeat(cuda, dtype):
    """The dots are summed in a fixed order: the same bits on every run."""
    levels = tmg._coarse_levels((108, 108, 108), 6)
    start = mt.tail_start(levels, 1, dtype, mt.smem_optin(cuda))
    b = _rhs(24, levels[start], dtype, cuda, seed=11)
    a_fine, sigma = _coeffs(3, 0.0, cuda)
    runs = [mt.mg_tail_cuda(levels, start, b, a_fine, sigma, 1, 1, 0.8, 48) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def _mg_apply(N, m, dtype, cuda, seed=5):
    A = problems.laplacian_dirichlet_3d(N, dtype=torch.float32, device=cuda)
    aux, fn = tmg.mg_inverse_factory(nu1=1, nu2=1, dtype=dtype)(A)
    R = _rhs(m, (N ** 3,), torch.float32, cuda, seed=seed)
    return aux, fn, R


def test_one_launch_a_vcycle_on_the_north_star_path(cuda):
    """A 54^3 bf16 V(1,1) apply, the north star's coarsest nested level:
    one kernel launch, one counted apply."""
    aux, fn, R = _mg_apply(54, 24, torch.bfloat16, cuda)
    before = (mt.mg_tail_cuda.launches, tmg.coarse_correction.applies)
    fn(aux, R)
    torch.cuda.synchronize()
    after = (mt.mg_tail_cuda.launches, tmg.coarse_correction.applies)
    assert [a - b for a, b in zip(after, before)] == [1, 1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mg_apply_matches_eager_apply(cuda, monkeypatch, dtype):
    """A whole ``mg_inverse_factory`` apply at 54^3 (m = 24) against the same
    apply with the tail left eager (``mg_tail.takes`` patched false). The
    tail's difference (``TAIL_TOL``) enters the fine level through the
    prolongation and two smoothing sweeps, which damp it, and the output
    keeps the level type's rounding: held at the same share of the output's
    largest value."""
    aux, fn, R = _mg_apply(54, 24, dtype, cuda)
    Y = fn(aux, R)
    monkeypatch.setattr(mt, "takes", lambda b, levels, level: False)
    launches = mt.mg_tail_cuda.launches
    Y_ref = fn(aux, R)
    torch.cuda.synchronize()
    assert mt.mg_tail_cuda.launches == launches
    assert Y.dtype == Y_ref.dtype == torch.float32
    assert _relmax(Y, Y_ref) <= TAIL_TOL[dtype]


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """A half-precision block, a block whose shape is not the level's, and
    coefficients of another type raise before any launch."""
    levels = tmg._coarse_levels((27, 27, 27), 6)
    a_fine, sigma = _coeffs(3, 0.0, cuda)
    with pytest.raises(TypeError):
        mt.mg_tail_cuda(levels, 0, torch.zeros((2, 27, 27, 27), dtype=torch.float16, device=cuda),
                        a_fine, sigma, 1, 1, 0.8, 48)
    with pytest.raises(ValueError):
        mt.mg_tail_cuda(levels, 0, torch.zeros((2, 27, 27, 26), device=cuda), a_fine, sigma, 1, 1,
                        0.8, 48)
    with pytest.raises(ValueError):
        mt.mg_tail_cuda(levels, 0, torch.zeros((2, 27, 27, 27), device=cuda),
                        tuple(a.double() for a in a_fine), sigma, 1, 1, 0.8, 48)
