"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so on a machine without JAX it runs without the suite's conftest
(which configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import collections
import importlib
import json
import os

import numpy as np
import pytest
import torch

from dune_eigensolver_tpu_torch.kernels import dia_spmm as kd
from dune_eigensolver_tpu_torch.sparse import DIAMatrix, problems, spmm_t

import test_torch_ell_cases

pytestmark = pytest.mark.cuda

# (n, offsets, columns a thread of the kernel owns). 2D 5-point and 3D
# 7-point patterns; 7^3 = 343 and 37^3 = 50653 are odd and no multiples of a
# block; 54^3 and 108^3 are the nested solve's coarser grids (54 = 2 mod 4);
# n = 1002 = 2 mod 4 caps the width at 2; n = 1000 leaves the last warp of
# the 4-wide kernel with lanes past n; the last four are no stencil the
# vector kernels are built for
PATTERNS = {
    "2d16": (256, (-16, -1, 0, 1, 16), 4),
    "3d7": (343, (-49, -7, -1, 0, 1, 7, 49), 1),
    "3d37": (50653, (-1369, -37, -1, 0, 1, 37, 1369), 1),
    "3d54": (157464, (-2916, -54, -1, 0, 1, 54, 2916), 2),
    "3d108": (1259712, (-11664, -108, -1, 0, 1, 108, 11664), 4),
    "n1002": (1002, (-30, -1, 0, 1, 30), 2),
    "n1000": (1000, (-100, -1, 0, 1, 100), 4),
    "1d": (4100, (-1, 0, 1), 1),
    "mass": (1000, (0,), 1),
    "by4": (1000, (-12, -8, -4, 0, 4, 8, 12), 1),
    "adjacent": (1000, (-3, -2, -1, 0, 1, 2, 3), 1),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(pattern, m, dtype, device, seed=0):
    n, offsets, _ = PATTERNS[pattern]
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.standard_normal((len(offsets), n))).to(device, dtype)
    X = torch.from_numpy(rng.standard_normal((m, n))).to(device, dtype)
    return DIAMatrix(data=data, offsets=offsets, shape=(n, n)), X


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("m", [1, 3, 8, 24, 72])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_reference(cuda, pattern, m, dtype):
    """f32: the same sum, FMA-contracted, 1e-5 of the output magnitude;
    bf16: both round one f32 sum, at most one bf16 ulp (2^-7) apart. The
    data are random everywhere, so a coefficient the kernel must mask (a
    column outside [0, n)) shows. m = 1 and 3 leave the unrolled row loop a
    remainder."""
    A, X = _operands(pattern, m, dtype, cuda)
    before = kd.dia_spmm_t_cuda.launches
    Y = spmm_t(A, X)
    torch.cuda.synchronize()
    assert kd.dia_spmm_t_cuda.launches == before + 1
    assert kd.dia_spmm_t_cuda.width == PATTERNS[pattern][2]
    assert Y.dtype == dtype and Y.shape == X.shape
    R = kd.dia_spmm_t_reference(A, X)
    tol = (1e-5 if dtype == torch.float32 else 1e-2) * R.float().abs().max().item()
    assert (Y.float() - R.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_widths_give_the_same_bits(cuda, dtype):
    """One chain of fused multiply-adds per output in offset order at every
    width: rows of X taken at an offset address (a narrower vector, down to
    one column a thread) give the aligned call's bits."""
    A, X = _operands("3d108", 5, dtype, cuda)
    Y = kd.dia_spmm_t_cuda(A, X)
    assert kd.dia_spmm_t_cuda.width == 4
    flat = torch.empty(X.numel() + 8, dtype=dtype, device=cuda)
    widths = []
    for shift in (4, 2, 1):  # elements; a vector of as many stays aligned
        Xs = flat[shift : shift + X.numel()].view_as(X).copy_(X)
        assert torch.equal(kd.dia_spmm_t_cuda(A, Xs), Y)
        widths.append(kd.dia_spmm_t_cuda.width)
    assert widths == [4, 2, 1]


@pytest.mark.parametrize("pattern", ["n1000", "n1002", "3d7"])
def test_kernel_masks_a_column_outside_with_its_own(cuda, pattern):
    """A neighbour outside [0, n) enters as a zero coefficient times the
    thread's own column, at every width: an infinite value in X shows only
    in the outputs whose stencil holds its column."""
    A, X = _operands(pattern, 3, torch.float32, cuda)
    n = X.shape[1]
    for column in (n - 4, n - 2, 1, 3):
        Xi = X.clone()
        Xi[:, column] = float("inf")
        Y = kd.dia_spmm_t_cuda(A, Xi)
        R = kd.dia_spmm_t_reference(A, Xi)
        assert torch.equal(torch.isfinite(Y), torch.isfinite(R)), column


def test_kernel_wrapper_refuses_bad_operands(cuda):
    A, X = _operands("3d7", 8, torch.float32, cuda)
    with pytest.raises(TypeError, match="float32, bfloat16 or float64"):
        kd.dia_spmm_t_cuda(A, X.double())
    with pytest.raises(ValueError, match="contiguous"):
        kd.dia_spmm_t_cuda(A, X.T.contiguous().T)
    A_cpu = DIAMatrix(data=A.data.cpu(), offsets=A.offsets, shape=A.shape)
    with pytest.raises(ValueError, match="CUDA"):
        kd.dia_spmm_t_cuda(A_cpu, X)
    with pytest.raises(ValueError, match="operands on"):
        spmm_t(A, X.cpu())


def test_nested_recipe_small_on_card(cuda):
    """The north-star recipe at N=24 on the card against the analytic
    spectrum, with the 3e-4 envelope of the CPU recipe test."""
    from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory
    from dune_eigensolver_tpu_torch.oracle.analytic import (
        eigenvalues_laplace_dirichlet_3d,
    )
    from dune_eigensolver_tpu_torch.solvers import lobpcg_nested

    N = 24
    A = problems.laplacian_dirichlet_3d(N, dtype=torch.float32, device=cuda)
    B = DIAMatrix(data=torch.ones((1, N**3), device=cuda), offsets=(0,), shape=A.shape)
    before = kd.dia_spmm_t_cuda.launches
    res = lobpcg_nested(
        A, B, nev=24, tol=2e-3, maxiter=300, shift=0.0, min_coarse=6,
        coarse_tol=2e-4, precond=mg_inverse_factory(nu1=1, nu2=1, dtype=torch.bfloat16),
        ortho_iterations=1, ortho_block=24, b_identity=True,
    )
    assert kd.dia_spmm_t_cuda.launches > before
    ev = np.sort(res.eigenvalues.cpu().numpy())[:20]
    assert bool(res.converged) and np.isfinite(ev).all()
    assert np.abs(ev - eigenvalues_laplace_dirichlet_3d(N, count=20)).max() < 3e-4


def test_a_solve_builds_the_solver_library_alone(cuda, tmp_path):
    """With an empty build directory, a small nested solve on the card (K1
    and the V-cycle's tail) builds one kernel library, from the solver's
    five sources, and loads no other: no study source is compiled."""
    import subprocess
    import sys
    import textwrap

    from dune_eigensolver_tpu_torch.utils import native

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent("""
        import json, os, sys, torch
        from dune_eigensolver_tpu_torch.utils import native
        native.BUILD_DIR = sys.argv[1]
        from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory
        from dune_eigensolver_tpu_torch.kernels import dia_spmm, mg_tail
        from dune_eigensolver_tpu_torch.solvers import lobpcg_nested
        from dune_eigensolver_tpu_torch.sparse import DIAMatrix, problems
        A = problems.laplacian_dirichlet_3d(16, dtype=torch.float32, device="cuda")
        B = DIAMatrix(data=torch.ones((1, 16**3), device="cuda"), offsets=(0,), shape=A.shape)
        res = lobpcg_nested(A, B, nev=8, tol=2e-3, maxiter=300, shift=0.0, min_coarse=6,
                            precond=mg_inverse_factory(nu1=1, nu2=1, dtype=torch.bfloat16),
                            b_identity=True)
        print(json.dumps(dict(converged=bool(res.converged), libs=sorted(native._LIBS),
                              k1=dia_spmm.dia_spmm_t_cuda.launches,
                              tail=mg_tail.mg_tail_cuda.launches,
                              files=sorted(os.listdir(sys.argv[1])))))
    """)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=repo, check=True,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=repo)).stdout
    got = json.loads(out.splitlines()[-1])
    assert got["converged"] and got["k1"] > 0 and got["tail"] > 0
    assert got["libs"] == [native.SOLVER]
    built = [f for f in got["files"] if f.startswith("libdune_")]
    want = native._lib_path(native._sources(native.SOLVER), native._headers(native.SOLVER))
    assert built == [os.path.basename(want)]
    assert [os.path.basename(f) for f in native._sources(native.SOLVER)] == [
        "bsr_spmm.cu", "cg_step.cu", "dia_spmm.cu", "ell_spmm.cu", "mg_tail.cu"]


def _gather_operand(kind, device):
    """Small ELL/BSR operands on the card: n not a multiple of the
    256-thread block, rows wider than one register chunk, a rectangular
    ELL, and b = 2 and 4 blocks."""
    import scipy.sparse as sp

    from dune_eigensolver_tpu_torch.sparse import bsr_from_scipy, ell_from_scipy, rcm_pencil

    f32 = torch.float32
    if kind == "ell-graph":
        S = problems.unstructured_laplacian(1001, extra_edges=50, seed=5, fmt="scipy")
        return rcm_pencil(S, dtype=f32, device=device)[0]
    if kind == "ell-wide":  # k > 32: two register chunks
        S = sp.random(700, 700, density=0.06, random_state=0, format="csr") + sp.eye(700)
        return ell_from_scipy(S, dtype=f32, device=device)
    if kind == "ell-rect":
        S = sp.random(300, 517, density=0.02, random_state=1, format="csr")
        return ell_from_scipy(S, dtype=f32, device=device)
    if kind == "bsr2-elasticity":
        return problems.elasticity_2d(13, dtype=f32, device=device)[0]
    if kind == "bsr2-k11":  # 11 blocks a block row: one chunk and a remainder
        pattern = sp.diags([np.ones(400 - abs(o)) for o in range(-5, 6)], list(range(-5, 6)),
                           format="csr")
    else:
        pattern = sp.random(90, 90, density=0.2, random_state=2, format="csr") + sp.eye(90)
    b = 4 if kind == "bsr4" else 2  # k > 9 (b=2) or > 4 (b=4): chunked
    block = np.random.default_rng(3).standard_normal((b, b))
    return bsr_from_scipy(sp.kron(pattern, block).tocsr(), block=(b, b), dtype=f32, device=device)


GATHER_KINDS = ["ell-graph", "ell-wide", "ell-rect", "bsr2-elasticity", "bsr2-wide", "bsr2-k11",
                "bsr4"]


@pytest.mark.parametrize("kind", GATHER_KINDS)
@pytest.mark.parametrize("m", [1, 3, 8, 24, 128])
def test_gather_kernels_match_reference(cuda, kind, m):
    """Both sum the same f32 products of a row in other orders: within
    1e-5 of the row's |A|.|X|. m = 1 and 3 leave the unrolled row loops a
    remainder; at m = 128 these small operands split their rows over the
    grid's second dimension."""
    import dataclasses

    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.sparse import BSRMatrix

    A = _gather_operand(kind, cuda)
    field = "bdata" if isinstance(A, BSRMatrix) else "data"
    wrapper = kg.bsr_spmm_t_cuda if field == "bdata" else kg.ell_spmm_t_cuda
    plain = kg.bsr_spmm_t_reference if field == "bdata" else kg.ell_spmm_t_reference
    X = torch.from_numpy(np.random.default_rng(m).standard_normal((m, A.shape[1]))).to(cuda, torch.float32)
    before = wrapper.launches
    Y = spmm_t(A, X)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert Y.shape == (m, A.shape[0]) and Y.dtype == torch.float32
    absA = dataclasses.replace(A, **{field: getattr(A, field).abs()})
    tol = 1e-5 * plain(absA, X.abs()).max().item()
    assert (Y - plain(A, X)).abs().max().item() <= tol


def _warp_operand(kind, device):
    return test_torch_ell_cases.warp_operand(kind, device, torch.float32)


WARP_KINDS = test_torch_ell_cases.WARP_KINDS


@pytest.mark.parametrize("kind", WARP_KINDS)
@pytest.mark.parametrize("m", [1, 3, 9, 24, 128])
def test_ell_kernel_stops_each_warp_at_its_count(cuda, kind, m):
    """K2 runs each warp's slots to its ``warp_slots`` count: against the
    plain version (all k slots) within 1e-5 of the row's |A|.|X|, as
    ``test_gather_kernels_match_reference``; m = 1, 3, 9 leave the unrolled
    row loop a remainder, m = 128 splits the rows over the grid."""
    import dataclasses

    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg

    A = _warp_operand(kind, cuda)
    assert A.warp_slots.max().item() <= A.k
    X = torch.from_numpy(np.random.default_rng(m).standard_normal((m, A.shape[1]))).to(cuda, torch.float32)
    before = kg.ell_spmm_t_cuda.launches
    Y = spmm_t(A, X)
    torch.cuda.synchronize()
    assert kg.ell_spmm_t_cuda.launches == before + 1 and Y.shape == (m, A.shape[0])
    absA = dataclasses.replace(A, data=A.data.abs())
    tol = 1e-5 * kg.ell_spmm_t_reference(absA, X.abs()).max().item()
    assert (Y - kg.ell_spmm_t_reference(A, X)).abs().max().item() <= tol


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("m", [1, 8])
def test_ell_kernel_int16_and_int32_indices_give_the_same_bits(cuda, far, m):
    """A banded operand at n = 40,000 feeds the kernel int16 offsets; one
    entry 39,999 columns from its row makes the container keep int32
    columns. Each is its plain version to 1e-5 of the row sums of |A| |X|,
    and the two give the same bits in every row but the one they differ
    in (row 0)."""
    import dataclasses

    import scipy.sparse as sp

    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.sparse import ell_from_scipy

    n = 40_000
    S = sp.diags([np.full(n - abs(o), 1.0 + 0.1 * o) for o in (-700, -1, 0, 1, 700)],
                 [-700, -1, 0, 1, 700], format="lil")
    near = ell_from_scipy(sp.csr_matrix(S), dtype=torch.float32, device=cuda)
    S[0, n - 1] = 0.25
    wide = ell_from_scipy(sp.csr_matrix(S), dtype=torch.float32, device=cuda)
    A, other = (wide, near) if far else (near, wide)
    X = torch.from_numpy(np.random.default_rng(m).standard_normal((m, n)).astype(np.float32)).to(cuda)
    Y = kg.ell_spmm_t_cuda(A, X)
    assert A.kernel_streams[1].element_size() == (4 if far else 2)
    absA = dataclasses.replace(A, data=A.data.abs())
    tol = 1e-5 * kg.ell_spmm_t_reference(absA, X.abs()).max().item()
    assert (Y - kg.ell_spmm_t_reference(A, X)).abs().max().item() <= tol
    assert torch.equal(Y[:, 1:], kg.ell_spmm_t_cuda(other, X)[:, 1:])


def test_ell_kernel_skips_padding_past_the_warp_count(cuda):
    """The deliberate difference (ROADMAP queue 3): row 40 has no diagonal
    entry, and no row stores column 40, so only row 40's padding slots
    (zero coefficient, own column) read X[:, 40]. Its warp stops after
    slot 3, before that padding, while k = 9 is set by row 0 in the other
    warp. An infinite X[:, 40] makes the plain version NaN in row 40
    (0 * inf); K2 stays finite there and gives the sum of row 40's stored
    entries, and every other output is the plain version's to rounding."""
    import scipy.sparse as sp

    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.sparse import ell_from_scipy

    n = 64
    lengths = [9] + [2] * 31 + [3] * 32
    S = test_torch_ell_cases.rows_csr(lengths).tolil()
    S[40, 40], S[40, 43] = 0.0, 0.7  # row 40: columns 41, 42, 43
    S[39, 40] = 0.0  # the rows before it reach column 40; drop that
    S[38, 40] = 0.0
    S = sp.csr_matrix(S)
    S.eliminate_zeros()
    assert S[:, 40].nnz == 0 and S[40].nnz == 3
    A = ell_from_scipy(S, dtype=torch.float32, device=cuda)
    assert A.k == 9 and A.warp_slots.tolist() == [9, 3]
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((3, n)).astype(np.float32)).to(cuda)
    X[:, 40] = float("inf")
    Y = kg.ell_spmm_t_cuda(A, X)
    plain = kg.ell_spmm_t_reference(A, X)
    assert torch.isnan(plain[:, 40]).all()
    assert torch.isfinite(Y).all()
    others = torch.arange(n, device=cuda) != 40
    torch.testing.assert_close(Y[:, others], plain[:, others], rtol=1e-6, atol=1e-6)
    X0 = X.clone()
    X0[:, 40] = 0.0
    torch.testing.assert_close(Y[:, 40], kg.ell_spmm_t_reference(A, X0)[:, 40], rtol=1e-6, atol=1e-6)


def test_gather_wrappers_refuse_bad_operands(cuda):
    from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory
    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.sparse import BSRMatrix, ELLMatrix

    for kind, wrapper in (("ell-graph", kg.ell_spmm_t_cuda), ("bsr2-elasticity", kg.bsr_spmm_t_cuda)):
        A = _gather_operand(kind, cuda)
        X = torch.randn((8, A.shape[1]), device=cuda)
        with pytest.raises(TypeError, match="float32"):
            wrapper(A, X.to(torch.bfloat16))
        with pytest.raises(TypeError, match="float32"):
            wrapper(A, X.double())
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(A, X.T.contiguous().T)
        with pytest.raises(ValueError, match="CUDA"):
            if isinstance(A, BSRMatrix):
                wrapper(BSRMatrix(A.bdata.cpu(), A.bcols.cpu(), A.shape, A.block, A.nnz), X)
            else:
                wrapper(ELLMatrix(A.data.cpu(), A.cols.cpu(), A.shape, A.nnz), X)
        with pytest.raises(ValueError, match="operands on"):
            spmm_t(A, X.cpu())
        # the bf16 inner CG reaches the gather kernels, which refuse it
        aux, fn = cg_inverse_factory(rtol=1e-2, maxiter=5, dtype=torch.bfloat16)(A)
        with pytest.raises(TypeError, match="float32"):
            fn(aux, X)


def test_general_sparsity_solves_small_on_card(cuda):
    """generalized_inverse on elasticity_2d(16) (BSR kernel) and LOBPCG on
    a 2,000-node graph (ELL kernel) with the CG inverse, against the
    scipy/ARPACK oracle at 1e-2 relative."""
    import scipy.sparse as sp

    from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory
    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.oracle import smallest_generalized, smallest_standard
    from dune_eigensolver_tpu_torch.solvers import generalized_inverse, lobpcg_generalized
    from dune_eigensolver_tpu_torch.sparse import ell_from_scipy, rcm_pencil

    A, B = problems.elasticity_2d(16, dtype=torch.float32, device=cuda)
    before = kg.bsr_spmm_t_cuda.launches
    res = generalized_inverse(A, B, nev=4, tol=2e-3, maxiter=300, shift=1e-3,
                              inverse=cg_inverse_factory(rtol=1e-5, maxiter=1000))
    assert kg.bsr_spmm_t_cuda.launches > before and bool(res.converged)
    ref, _ = smallest_generalized(A, B, nev=4, sigma=-1e-3)
    ev = res.eigenvalues.cpu().numpy()
    assert np.isfinite(ev).all() and np.abs(ev - ref).max() / np.abs(ref).max() < 1e-2

    S = problems.unstructured_laplacian(2000, extra_edges=100, seed=5, fmt="scipy")
    Au = rcm_pencil(S, dtype=torch.float32, device=cuda)[0]
    Bu = ell_from_scipy(sp.eye(2000), dtype=torch.float32, device=cuda)
    before = kg.ell_spmm_t_cuda.launches
    res = lobpcg_generalized(Au, Bu, nev=4, tol=2e-3, maxiter=300, shift=1e-3,
                             precond=cg_inverse_factory(rtol=1e-2, maxiter=25))
    assert kg.ell_spmm_t_cuda.launches > before and bool(res.converged)
    ref, _ = smallest_standard(S, nev=4, sigma=-1e-3)
    ev = res.eigenvalues.cpu().numpy()
    assert np.isfinite(ev).all() and np.abs(ev - ref).max() / np.abs(ref).max() < 1e-2


# ---------------------------------------------------------------------------
# The copy probe and the DIA staging variants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,tile", [((8, 4096), 1024), ((8, 40960), 32768),
                                        ((3, 1001), 100), ((5, 2052), 512)])
def test_copy_kernels_match_plain(cuda, shape, tile):
    """One f32 add per element in kernel and plain version alike: exact.
    (3, 1001) takes the 4-byte path, the others the 16-byte one; (5, 2052)
    has a last tile that is not full."""
    from dune_eigensolver_tpu_torch.experiments import pipeline_probe as pp

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    d = torch.from_numpy(rng.standard_normal((5, shape[1])).astype(np.float32)).to(cuda)
    before = (pp.ident.launches, pp.identd.launches, pp.ident_alias.launches)
    assert torch.equal(pp.ident(tile, x), pp.ident_reference(x))
    assert torch.equal(pp.identd(tile, d, x), pp.identd_reference(d, x))
    xa = x.clone()
    assert pp.ident_alias(tile, xa) is xa
    assert torch.equal(xa, pp.ident_reference(x))
    assert (pp.ident.launches, pp.identd.launches, pp.ident_alias.launches) == tuple(
        b + 1 for b in before)


# (rows, width, tile, floats x's first element lies past an allocation):
# rows 1, 3 and 8; tiles that divide the width and tiles that do not; a
# last tile narrower than a chunk; an odd width and views 4 and 8 bytes off
# 16 (the first version's scalar path); the timed shape
COPY_BODY_CASES = [
    (1, 4096, 1024, 0),
    (3, 40960, 32768, 0),
    (8, 40960, 4096, 0),
    (3, 4100, 1000, 0),
    (5, 2052, 512, 0),
    (8, 1000, 4, 0),
    (3, 100_003, 1000, 0),
    (8, 4096, 1024, 1),
    (2, 4096, 1024, 2),
    (8, 4_259_840, 16384, 0),
]


@pytest.mark.parametrize("rows,width,tile,off", COPY_BODY_CASES)
def test_copy_bodies_match_plain(cuda, rows, width, tile, off):
    """``ident`` and ``ident_alias`` (the bulk copies where ``copy_body``
    says so, else their first version) against the plain version bit for
    bit, out of place and in place; every launch counted once."""
    from dune_eigensolver_tpu_torch.experiments import pipeline_probe as pp

    gen = torch.Generator(device="cuda").manual_seed(rows * width + tile + off)
    flat = torch.randn(rows * width + off, generator=gen, device=cuda)
    x = flat[off:].view(rows, width)
    ptrs = x.data_ptr() | 16
    body = pp.copy_body(width, tile, align=ptrs & -ptrs)
    assert body == ("bulk" if width % 4 == 0 and tile % 4 == 0 and off % 4 == 0 else "first")
    want = pp.ident_reference(x)
    wrappers = (pp.ident, pp.ident_alias)
    counts = {fn: fn.launches for fn in wrappers}
    assert torch.equal(pp.ident(tile, x), want) and pp.ident.body == body
    xa = flat.clone()[off:].view(rows, width)  # the same alignment as x
    assert pp.ident_alias(tile, xa) is xa and torch.equal(xa, want)
    assert pp.ident_alias.body == body
    torch.cuda.synchronize()
    assert all(fn.launches == counts[fn] + 1 for fn in wrappers)


def test_copy_launchers_refuse_bulk_off_grid(cuda):
    """The launcher checks what ``copy_body`` checks: the bulk body (flag 1)
    on a width, tile or address off 16 bytes is refused before any
    launch."""
    from dune_eigensolver_tpu_torch.experiments import pipeline_probe as pp

    flat = torch.zeros(4 * 1024 + 1, device=cuda)
    y = torch.empty((4, 1024), device=cuda)
    body = pp.BODIES["bulk"]
    for x_ptr, width, tile in ((flat[1:].data_ptr(), 1024, 256),
                               (flat.data_ptr(), 1022, 256),
                               (flat.data_ptr(), 1024, 254)):
        with pytest.raises(RuntimeError, match="copy_add1_launch"):
            pp._run("copy_add1_launch", flat, body, x_ptr, y.data_ptr(), 4, width, tile)
        with pytest.raises(RuntimeError, match="copy_add1_inplace_launch"):
            pp._run("copy_add1_inplace_launch", flat, body, x_ptr, 4, width, tile)


@pytest.mark.parametrize("nd", [1, 2, 5])
@pytest.mark.parametrize("shape,tile", [((8, 4096), 1024), ((3, 1001), 100), ((5, 2052), 512)])
def test_identd_coefficient_rows_match_plain(cuda, nd, shape, tile):
    """``identd`` with one coefficient row (no stream) and with more (rows
    1.. loaded and folded): Y = X + d[0] exactly, on the 16-byte path and
    the 4-byte one."""
    from dune_eigensolver_tpu_torch.experiments import pipeline_probe as pp

    gen = torch.Generator(device="cuda").manual_seed(nd * shape[1] + tile)
    x = torch.randn(shape, generator=gen, device=cuda)
    d = torch.randn((nd, shape[1]), generator=gen, device=cuda)
    before = pp.identd.launches
    assert torch.equal(pp.identd(tile, d, x), pp.identd_reference(d, x))
    assert pp.identd.launches == before + 1


def test_identd_sass_keeps_the_coefficient_loads(cuda):
    """What ptxas kept: in ``cuobjdump -sass`` of the built studies' library,
    each instantiation of ``copy_add_row_kernel`` that streams rows 1.. of d
    (STREAM, taken where nd > 1) has at least CP_UNROLL = 4 global loads
    more than the same body without them; a load whose result nothing reads
    would be gone. Skips only where the toolkit has no cuobjdump."""
    from dune_eigensolver_tpu_torch.experiments import pipeline_probe as pp
    from dune_eigensolver_tpu_torch.utils import native

    if native.cuobjdump() is None:
        pytest.skip("needs the CUDA toolkit's cuobjdump")
    loads = pp.coefficient_loads()
    assert set(loads) == {(v, st) for v in (False, True) for st in (False, True)}, loads
    for vec in (False, True):
        assert loads[(vec, True)] >= loads[(vec, False)] + 4, loads


def _variant_calls(kv, tile, rows):
    """(name, call, wrapper): every variant (B off the 16-byte grid on its
    first version)."""
    calls = [("c", lambda A, X: kv.spmm_c(A, X, tile=tile, rows=rows), kv.spmm_c)]
    for s, q in kv.B_RINGS:
        calls.append((f"b{s}{q}", lambda A, X, s=s, q=q: kv.spmm_b(A, X, s, q, tile=tile, rows=rows),
                      kv.spmm_b))
    for alias in (False, True):
        name = "d_alias" if alias else "d"
        calls.append((name, lambda A, X, a=alias: kv.spmm_d(A, X, alias=a, tile=tile, rows=rows),
                      kv.spmm_d))
    return calls


@pytest.mark.parametrize("N,m,tile,rows", [(32, 8, 256, 8), (45, 8, 256, 2), (46, 8, 256, 4),
                                           (37, 5, 64, 2), (48, 8, 2560, 2), (100, 16, 128, 1)])
def test_variants_match_plain(cuda, N, m, tile, rows):
    """C, B at its three rings, D and D in place against the plain DIA
    product on the 2D Laplacian with random diagonals kept: the same f32
    sum FMA-contracted, 1e-5 of max|R|; the staged bodies give the shipped
    kernel's bits (K1: one FMA chain in offset order, zeros outside [0, n)),
    and so does B's bulk body where n % 4 == 0; B's first version, off the
    grid, is held to the plain version. n = 2025 is odd (cp.async), 2116
    and 1369 are no multiples of the tile, (48, 2560) is one tile that holds
    the whole operand, (100, 128) has many chunks; (32, 256), (48, 2560) and
    (100, 128) take four columns a thread."""
    from dune_eigensolver_tpu_torch.experiments import kernel_variants as kv

    A = problems.laplacian_dirichlet_2d(N, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(1)
    n = N * N
    data = A.data * torch.from_numpy(rng.uniform(0.5, 1.5, (5, n)).astype(np.float32)).to(cuda)
    A = DIAMatrix(data=data, offsets=A.offsets, shape=A.shape)
    X = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(cuda)
    R = kd.dia_spmm_t_reference(A, X)
    K1 = kd.dia_spmm_t_cuda(A, X)
    tol = 1e-5 * R.abs().max().item()
    for name, fn, wrapper in _variant_calls(kv, tile, rows):
        before = wrapper.launches
        Xin = X.clone()
        Y = fn(A, Xin)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, name
        assert (Y.data_ptr() == Xin.data_ptr()) == name.startswith("d_alias"), name
        assert (Y - R).abs().max().item() <= tol, name
        # B is on the staged body where n lies on the 16-byte grid
        if name[0] != "b" or n % 4 == 0:
            assert torch.equal(Y, K1), name


def _stage_operand(N, m, cuda):
    """The 2D stencil of N^2 rows with random coefficients on every
    diagonal, also where the neighbour lies outside [0, n)."""
    n = N * N
    rng = np.random.default_rng(N)
    offsets = (-N, -1, 0, 1, N)
    data = torch.from_numpy(rng.standard_normal((5, n)).astype(np.float32)).to(cuda)
    X = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(cuda)
    return DIAMatrix(data=data, offsets=offsets, shape=(n, n)), X


# (N, route, width): 200^2 and 48^2 on the 16-byte grid with offsets that are
# multiples of 4; 46^2 on the grid with offsets that are not; 201^2 and 45^2 odd
STAGE_CASES = [(200, "bulk", 4), (48, "bulk", 4), (46, "bulk", 1), (201, "async", 1),
               (45, "async", 1)]


@pytest.mark.parametrize("N,route,width", STAGE_CASES)
@pytest.mark.parametrize("variant", ["c", "d", "d_alias"])
def test_stage_bodies_match_plain(cuda, N, route, width, variant):
    """The staged C, D and D in place at every tile and rows of their sweep
    that fit (tiles of 2048 and 4096 hold the small operands in one or a few
    tiles; 1024 several), against the plain DIA product with random
    coefficients on every diagonal: a launch on X of 1e30 runs first at each
    setting, so stale shared memory would show; m = 5 (a pair of rows is cut
    short); one application and the 2-chain within 1e-5 of max|Y|, and K1's
    bits; every launch takes the route and width the rules give it."""
    from dune_eigensolver_tpu_torch.experiments import kernel_variants as kv

    A, X = _stage_operand(N, 5, cuda)
    n = N * N
    R = kd.dia_spmm_t_reference(A, X)
    R2 = kd.dia_spmm_t_reference(A, R)
    K1 = kd.dia_spmm_t_cuda(A, X)
    K2 = kd.dia_spmm_t_cuda(A, K1)
    wrapper = kv.spmm_c if variant == "c" else kv.spmm_d
    done = 0
    for (T, rows), g in kv.stage_settings(variant[0], A.offsets, n):
        if not g.fits:
            continue
        assert (g.route, g.width) == (kv.stage_route(n), kv.stage_width(A.offsets, n, T))
        assert (g.route, g.width) == (route, width if T % 128 == 0 else 1)

        def call(x):
            if variant == "c":
                return kv.spmm_c(A, x, tile=T, rows=rows)
            return kv.spmm_d(A, x.clone() if variant == "d_alias" else x,
                             alias=variant == "d_alias", tile=T, rows=rows)

        call(torch.full_like(X, 1e30))
        before = wrapper.taken[g.route, g.width]
        Y = call(X)
        Y2 = call(Y)
        torch.cuda.synchronize()
        assert wrapper.taken[g.route, g.width] == before + 2, (T, rows)
        assert (Y - R).abs().max().item() <= 1e-5 * R.abs().max().item(), (T, rows)
        assert (Y2 - R2).abs().max().item() <= 1e-5 * R2.abs().max().item(), (T, rows)
        assert torch.equal(Y, K1) and torch.equal(Y2, K2), (T, rows)
        done += 1
    assert done >= 3


# n on the 16-byte grid (bulk copies) and off it (the first version's
# cp.async); 200^2 = 40,000 and 201^2 = 40,401 hold three tiles of 16384
@pytest.mark.parametrize("N,route", [(200, "bulk"), (201, "first"), (46, "bulk"), (45, "first")])
@pytest.mark.parametrize("ring", [(2, 1), (3, 2), (4, 3)])
def test_ring_bodies_match_plain(cuda, N, route, ring):
    """Variant B at every tile and rows of its sweep that fit, against the
    plain DIA product: random coefficients on every diagonal, also where
    the neighbour lies outside [0, n) (the plain version reads X as zero
    there, so stale shared memory would show: a launch on X of 1e30 runs
    first at each setting), m = 5 (a group of two rows is cut short), one
    application and the 2-chain each within 1e-5 of its max|Y|, and on the
    bulk route (the staged body) K1's bits; every launch takes the route n
    gives it and the width ``stage_width`` gives it. The bulk body's
    coefficient tiles leave two settings of ring (4, 3) room."""
    from dune_eigensolver_tpu_torch.experiments import kernel_variants as kv

    n = N * N
    A, X = _stage_operand(N, 5, cuda)
    offsets = A.offsets
    R = kd.dia_spmm_t_reference(A, X)
    R2 = kd.dia_spmm_t_reference(A, R)
    K1 = kd.dia_spmm_t_cuda(A, X)
    s, q = ring
    done = 0
    for T in kv.RING_TILES:
        for rows in kv.RING_ROWS:
            g = kv.ring_geometry(offsets, n, T, rows, s, q, check=False)
            if not g.fits:
                continue
            kv.spmm_b(A, torch.full_like(X, 1e30), s, q, tile=T, rows=rows)
            before = kv.spmm_b.taken[route]
            Y = kv.spmm_b(A, X, s, q, tile=T, rows=rows)
            Y2 = kv.spmm_b(A, Y, s, q, tile=T, rows=rows)
            torch.cuda.synchronize()
            assert kv.spmm_b.taken[route] == before + 2
            assert kv.spmm_b.width == (kv.stage_width(offsets, n, T) if route == "bulk" else 1)
            assert (Y - R).abs().max().item() <= 1e-5 * R.abs().max().item(), (T, rows)
            assert (Y2 - R2).abs().max().item() <= 1e-5 * R2.abs().max().item(), (T, rows)
            if route == "bulk":
                assert torch.equal(Y, K1), (T, rows)
            done += 1
    assert done >= 2


def test_ring_launcher_refuses_bulk_off_grid(cuda):
    """The bulk body needs n, the tile, the window start and X on 16 bytes,
    256 or 512 threads, and width 4 only on a stencil it takes and a tile on
    128; its launcher refuses anything else (the wrapper never asks: it
    takes the first version, at 256, off the grid)."""
    from dune_eigensolver_tpu_torch.experiments import kernel_variants as kv

    def launch(n, X, tile=256, body=1, threads=256, width=1):
        A = DIAMatrix(data=torch.ones((3, n), device=cuda), offsets=(-1, 0, 1), shape=(n, n))
        g = kv.ring_geometry(A.offsets, n, 256, 1, 2, 1, check=False)
        Y = torch.empty((2, n), device=cuda)
        kv._run("dia_b_launch", A, X, Y, (), (tile, g.fl_base, g.window, 1, 1, 2, 1, body,
                                              threads, width))
        return Y

    with pytest.raises(RuntimeError, match="dia_b_launch"):
        launch(1001, torch.ones((2, 1001), device=cuda))
    buf = torch.ones(2 * 1024 + 1, device=cuda)
    with pytest.raises(RuntimeError, match="dia_b_launch"):
        launch(1024, buf[1:].view(2, 1024))  # X one float off 16 bytes
    with pytest.raises(RuntimeError, match="dia_b_launch"):
        launch(1024, torch.ones((2, 1024), device=cuda), tile=254)
    with pytest.raises(RuntimeError, match="dia_b_launch"):
        launch(1024, torch.ones((2, 1024), device=cuda), body=2)
    with pytest.raises(RuntimeError, match="dia_b_launch"):
        launch(1024, torch.ones((2, 1024), device=cuda), threads=384)
    with pytest.raises(RuntimeError, match="dia_b_launch"):
        launch(1001, torch.ones((2, 1001), device=cuda), body=0, threads=512)
    with pytest.raises(RuntimeError, match="dia_b_launch"):
        launch(1024, torch.ones((2, 1024), device=cuda), width=4)  # three diagonals
    with pytest.raises(RuntimeError, match="dia_b_launch"):
        launch(1001, torch.ones((2, 1001), device=cuda), body=0, width=4)
    Y = launch(1024, torch.ones((2, 1024), device=cuda), threads=512)  # the bulk body at 512
    torch.cuda.synchronize()
    assert Y[:, 1:-1].eq(3.0).all() and Y[:, 0].eq(2.0).all() and Y[:, -1].eq(2.0).all()
    Y = launch(1001, torch.ones((2, 1001), device=cuda), body=0)  # the first version takes it
    torch.cuda.synchronize()
    assert Y[:, 1:-1].eq(3.0).all() and Y[:, 0].eq(2.0).all() and Y[:, -1].eq(2.0).all()


def test_stage_launchers_refuse_what_the_rules_refuse(cuda):
    """The staged C's and D's launchers check what ``stage_route`` and
    ``stage_width`` decide: the bulk route off the 16-byte grid, width 4 on
    offsets off 4 or a tile off 128, the cp.async route at width 4 or 512
    threads are refused before any launch."""
    from dune_eigensolver_tpu_torch.experiments import kernel_variants as kv

    def launch(N, name, route, width, tile=256, threads=256):
        A, X = _stage_operand(N, 2, cuda)
        Y = torch.empty_like(X)
        if name == "c":
            kv._run("dia_c_stage_launch", A, X, Y, (), (tile, 64, 2, 1, route, width, threads))
        else:
            kv._run("dia_d_stage_launch", A, X, Y, (None,), (tile, 2, 1, route, width, threads))
        torch.cuda.synchronize()
        return A, X, Y

    for name in ("c", "d"):
        what = f"dia_{name}_stage_launch"
        with pytest.raises(RuntimeError, match=what):
            launch(45, name, 1, 1)  # n odd: no bulk copies
        with pytest.raises(RuntimeError, match=what):
            launch(46, name, 1, 4)  # offsets +-46: no 16-byte loads
        with pytest.raises(RuntimeError, match=what):
            launch(48, name, 1, 4, tile=192)  # a tile off 128
        with pytest.raises(RuntimeError, match=what):
            launch(48, name, 2, 4)
        with pytest.raises(RuntimeError, match=what):
            launch(45, name, 2, 1, threads=512)
        with pytest.raises(RuntimeError, match=what):
            launch(48, name, 3, 1)
        A, X, Y = launch(48, name, 1, 4)  # what the rules give: bulk, width 4
        assert torch.equal(Y, kd.dia_spmm_t_cuda(A, X))
        A, X, Y = launch(48, name, 2, 1)  # the cp.async body takes any n
        assert torch.equal(Y, kd.dia_spmm_t_cuda(A, X))


def test_variant_d_in_place_two_chain(cuda):
    """The in-place form fed its own output (the reference's 2-chain
    check), with chunks of one and of several tiles, on the staged body
    (bulk copies, width 4 at N = 96 and 300, width 1 on cp.async at N = 95),
    within 1e-5 of the plain 2-chain and K1's bits."""
    from dune_eigensolver_tpu_torch.experiments import kernel_variants as kv

    for N, tile in ((96, 128), (300, 512), (95, 128)):
        A = problems.laplacian_dirichlet_2d(N, dtype=torch.float32, device=cuda)
        A = DIAMatrix(data=A.data / 8.0, offsets=A.offsets, shape=A.shape)
        X = torch.randn((8, N * N), generator=torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
        R2 = kd.dia_spmm_t_reference(A, kd.dia_spmm_t_reference(A, X))
        Y = kv.spmm_d(A, kv.spmm_d(A, X.clone(), alias=True, tile=tile), alias=True, tile=tile)
        assert (Y - R2).abs().max().item() <= 1e-5 * R2.abs().max().item(), N
        assert torch.equal(Y, kd.dia_spmm_t_cuda(A, kd.dia_spmm_t_cuda(A, X))), N


def test_variant_wrappers_refuse(cuda):
    from dune_eigensolver_tpu_torch.experiments import kernel_variants as kv
    from dune_eigensolver_tpu_torch.experiments import pipeline_probe as pp

    A = problems.laplacian_dirichlet_2d(64, dtype=torch.float32, device=cuda)
    X = torch.ones((8, 64 * 64), device=cuda)
    with pytest.raises(ValueError, match="exceeds the tile"):
        kv.spmm_d(A, X, tile=32)
    with pytest.raises(ValueError, match="depth < nslots"):
        kv.spmm_b(A, X, nslots=2, depth=2)
    with pytest.raises(ValueError, match="shared memory"):
        kv.spmm_c(A, X, tile=32768, rows=8)  # two windows beyond 227 KB
    with pytest.raises(ValueError, match="shared memory"):
        kv.spmm_b(A, X, nslots=4, depth=3, tile=8192, rows=8)
    with pytest.raises(ValueError, match="shared memory"):
        kv.spmm_d(A, X, tile=8192, rows=8)
    with pytest.raises(ValueError, match="shared memory"):
        kv.spmm_d(A, X, tile=4096, rows=2)  # the ring fits, not with its coefficient tiles
    for fn in (kv.spmm_c, kv.spmm_d, kv.spmm_b):
        with pytest.raises(TypeError, match="float32"):
            fn(A, X.double())
    for fn in (kv.spmm_c, kv.spmm_b, kv.spmm_d):
        with pytest.raises(ValueError, match="CUDA"):
            fn(A, X.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        pp.ident(1024, X.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        pp.identd(1024, X[:5].contiguous(), X.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        pp.ident_alias(1024, X.cpu())


def test_cli_and_experiments_on_card(cuda, capsys):
    """The measurement path's entry points at a small size on the card:
    every kernel variant prints its line."""
    from dune_eigensolver_tpu_torch import cli
    from dune_eigensolver_tpu_torch.experiments import kernel_variants as kv
    from dune_eigensolver_tpu_torch.experiments import pipeline_probe as pp

    assert cli.main(["--test", "matvec", "ev.N=64", "mv.m=8"]) == 0
    assert cli.main(["--test", "mgs", "mgs.n=12"]) == 0
    assert pp.main(["1024", "--width", "40960", "--mb", "4"]) == 0
    assert kv.main(["256", "--N", "128", "--mb", "4"]) == 0
    out = capsys.readouterr().out
    for variant in ("plain", "plain_t", "cuda_t", "bsr_plain", "bsr_cuda", "ell_plain",
                    "ell_cuda"):
        assert f"RESULT {variant} " in out
    assert "P_n_m_i_perfn_perfb: 1 4096 16 15 " in out
    for label in ("ident T=1024", "ident+d", "ALIASED", "A shipped", "D rolling", "D in-place",
                  "B s=4 d=3", "C r1-style"):
        assert label in out
    assert "first" not in out


# ---------------------------------------------------------------------------
# The ELL ablation, the gather probes and the standard entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(1001, 7), (2049, 18), (777, 33), (300, 3)])
@pytest.mark.parametrize("m", [1, 8, 24])
def test_ablate_variants_match_plain(cuda, n, k, m):
    """``check_variants``: K2's body at every (rows, kc) of the sweep gives
    K2's bits; ``nogather`` and ``nodyn``, on
    K2's body, stay within 1e-5 of the largest row's sum of |data| |X| of
    their plain versions; ``nofma`` is exact. n is no multiple of a block,
    k spans one to several register chunks."""
    import scipy.sparse as sp

    from dune_eigensolver_tpu_torch.experiments import gather_ablate as ga
    from dune_eigensolver_tpu_torch.sparse import ell_from_scipy

    S = sp.random(n, n, density=(k - 1) / n, random_state=k, format="csr") + sp.eye(n)
    A = ell_from_scipy(sp.csr_matrix(S), dtype=torch.float32, device=cuda)
    X = torch.from_numpy(np.random.default_rng(m).standard_normal((m, n)).astype(np.float32)).to(cuda)
    before = {v: f.launches for v, f in ga.VARIANT_KERNELS.items()}
    full_before = ga.ablate_full.launches
    errs = ga.check_variants(A, X)
    torch.cuda.synchronize()
    assert set(errs) == set(ga.VARIANTS) and errs["nofma"] == 0.0
    assert ga.ablate_full.launches == full_before + len(ga.SWEEP)  # one a setting
    for v, f in ga.VARIANT_KERNELS.items():
        assert f.launches >= before[v] + 1


@pytest.mark.parametrize("kind", ["int16", "int32", "long"])
@pytest.mark.parametrize("m", [1, 9, 24])
def test_ablate_sweep_gives_k2s_bits(cuda, kind, m):
    """K2's body at every (rows, kc) of the sweep sums a row's slots in
    stored order from +0: K2's bits, on the int16 offsets of a banded
    operand, on int32 columns (one entry 39,999 columns away), and on rows
    of up to ~50 slots (several register chunks); the degraded variants
    read the same index stream."""
    import scipy.sparse as sp

    from dune_eigensolver_tpu_torch.experiments import gather_ablate as ga
    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.sparse import ell_from_scipy

    if kind == "long":
        S = sp.random(2049, 2049, density=40 / 2049, random_state=3, format="csr") + sp.eye(2049)
    else:
        n = 40_000
        S = sp.diags([np.full(n - abs(o), 1.0 + 0.1 * o) for o in (-700, -1, 0, 1, 700)],
                     [-700, -1, 0, 1, 700], format="lil")
        if kind == "int32":
            S[0, n - 1] = 0.25
    A = ell_from_scipy(sp.csr_matrix(S), dtype=torch.float32, device=cuda)
    assert A.kernel_streams[1].element_size() == (4 if kind == "int32" else 2)
    X = torch.from_numpy(np.random.default_rng(m).standard_normal((m, A.shape[1])).astype(np.float32)).to(cuda)
    K2 = kg.ell_spmm_t_cuda(A, X)
    before = ga.ablate_full.launches
    for rows, kc in ga.SWEEP:
        assert torch.equal(ga.ablate_full(A, X, rows, kc), K2), (rows, kc)
    assert ga.ablate_full.launches == before + len(ga.SWEEP)


def test_ablation_sass_keeps_the_slot_loads(cuda):
    """What ptxas kept of the ablation's slot loads: in ``cuobjdump -sass``
    of the built studies' library, at K2's setting and both index widths,
    ``nogather`` has exactly K2's global loads (it loads every coefficient
    and index K2 loads, and X once a term) and ``nofma`` at least two beyond
    its epilogue's six (``gather_ablate.slot_load_faults``); a load whose
    value nothing reads would be gone. Skips only where the toolkit has no
    cuobjdump."""
    from dune_eigensolver_tpu_torch.experiments import gather_ablate as ga
    from dune_eigensolver_tpu_torch.utils import native

    if native.cuobjdump() is None:
        pytest.skip("needs the CUDA toolkit's cuobjdump")
    loads = ga.slot_loads()
    assert set(loads) == {(v, b) for v in ga.VARIANTS for b in (2, 4)}, loads
    assert ga.slot_load_faults(loads) == [], loads


def test_ablate_wrappers_refuse_bad_operands(cuda):
    import dataclasses

    import scipy.sparse as sp

    from dune_eigensolver_tpu_torch.experiments import gather_ablate as ga
    from dune_eigensolver_tpu_torch.sparse import ell_from_scipy

    A = ell_from_scipy(sp.random(50, 20, density=0.9, random_state=0, format="csr"),
                       dtype=torch.float32, device=cuda)
    X = torch.ones((8, 20), device=cuda)
    assert ga.ablate_nogather(A, X).shape == (8, 50)  # rectangular: i' = min(i, ncols - 1)
    assert A.k <= 20 and ga.ablate_nodyn(A, X).shape == (8, 50)
    wide = ell_from_scipy(sp.csr_matrix(np.ones((4, 3))), dtype=torch.float32, device=cuda)
    wide = type(wide)(data=wide.data.repeat(1, 2), cols=wide.cols.repeat(1, 2), shape=wide.shape,
                      nnz=wide.nnz)
    with pytest.raises(ValueError, match="exceeds"):
        ga.ablate_nodyn(wide, torch.ones((2, 3), device=cuda))
    with pytest.raises(ValueError, match="not built"):
        ga.ablate_full(A, X, rows=3, kc=9)
    with pytest.raises(ValueError, match="not built"):
        ga.ablate_full(A, X, rows=8, kc=10)
    with pytest.raises(TypeError, match="float32"):
        ga.ablate_nofma(A, X.double())
    with pytest.raises(TypeError, match="float32"):
        ga.ablate_nogather(dataclasses.replace(A, data=A.data.double()), X.double())


def test_gather_probes_all_ok_on_card(cuda, capsys):
    """The eleven probes and the shuffle form of the first: on this card
    none may fail."""
    from dune_eigensolver_tpu_torch.experiments import gather_probe as gp

    gp_before = {k: f.launches for k, f in gp.KERNELS.items()}
    verdicts = gp.run_probes(cuda)
    assert len(verdicts) == 12 and set(verdicts.values()) == {"OK"}
    # every kernel serves a probe but the L1/L2 form of the row gather,
    # which only the timing table runs
    assert all(f.launches > gp_before[k] for k, f in gp.KERNELS.items()
               if k != "gather_lanes_global")
    assert capsys.readouterr().out.count(": OK") == 12


@pytest.mark.parametrize("rows,width,seg", [(8, 4096, 128), (3, 2560, 256), (5, 10240, 64),
                                            (1, 512, 512), (16, 8192, 128)])
def test_gather_forms_match_plain(cuda, rows, width, seg):
    """Every probe kernel against its plain version on random data and
    indices (exact): several chunks a row, a last chunk that is not full,
    one segment a row; then the timed table itself at (8, width), which
    raises on a mismatch."""
    from dune_eigensolver_tpu_torch.experiments import gather_probe as gp

    gen = torch.Generator(device="cuda").manual_seed(rows * width + seg)
    x = torch.randn((rows, width), generator=gen, device=cuda)
    lanes = torch.randint(0, seg, (rows, width), generator=gen, device=cuda, dtype=torch.int32)
    want = gp.gather_lanes_reference(x, lanes, seg)
    assert torch.equal(gp.gather_lanes_smem(x, lanes, seg), want)
    assert torch.equal(gp.gather_lanes_global(x, lanes, seg), want)
    if seg == 128:
        assert torch.equal(gp.gather_lanes_shfl(x, lanes), want)
    if seg <= 128:
        assert torch.equal(gp.gather_lanes_int8(x, lanes.to(torch.int8), seg), want)
    across = torch.randint(0, rows, (rows, width), generator=gen, device=cuda, dtype=torch.int32)
    assert torch.equal(gp.gather_axis0(x, across), gp.gather_axis0_reference(x, across))
    s = torch.tensor([37], dtype=torch.int32, device=cuda)
    assert torch.equal(gp.roll_lanes(x, s, min(256, seg)),
                       gp.roll_lanes_reference(x, s, min(256, seg)))
    i8 = torch.randint(-128, 128, (rows, width), generator=gen, device=cuda, dtype=torch.int8)
    assert torch.equal(gp.int8_widen(x, i8), gp.int8_widen_reference(x, i8))
    p, bw = torch.tensor([2], dtype=torch.int32, device=cuda), width // 4
    want = gp.lane_slice_reference(x, p, bw)
    assert torch.equal(gp.lane_slice(x, p, bw), want)
    assert torch.equal(gp.block_select_scratch(x, p, bw), want)
    x3 = x.reshape(rows, 4, bw).transpose(0, 1).contiguous()
    assert torch.equal(gp.block_select(x3, p), gp.block_select_reference(x3, p))
    table = list(gp.form_table(cuda, width))
    assert sorted(r["name"] for r in table[1:]) == sorted(gp.KERNELS)
    assert all(r["max_abs_err"] == 0.0 for r in table[1:])
    assert all(r["us"] > 0 for r in table)


# (rows, nb, bw, floats x's first element lies past an allocation, p): odd
# rows; bw no multiple of 4 (the scalar path); a last chunk of a row that is
# not full (8196 = 2049 float4s, 4097 floats); views 4 and 8 bytes off 16;
# p below and above [0, nb - 1] (clamped); nb = 1
SELECT_CASES = [
    (7, 4, 1024, 0, 2),
    (5, 3, 127, 0, 1),
    (3, 4, 4, 0, 3),
    (3, 2, 8196, 0, 1),
    (2, 3, 4097, 0, 2),
    (8, 4, 256, 1, 1),
    (9, 5, 132, 2, 4),
    (4, 6, 64, 0, -7),
    (4, 6, 64, 0, 99),
    (1, 1, 1000, 0, 0),
    (6, 1, 33, 3, 5),
]


@pytest.mark.parametrize("rows,nb,bw,off,p", SELECT_CASES)
def test_row_copy_selections_match_plain(cuda, rows, nb, bw, off, p):
    """``lane_slice`` and ``block_select`` (the row copy) against the plain
    versions, bit for bit, each launch counted once; float4 moves exactly where bw is a multiple of 4 and x lies on 16
    bytes (the output, a fresh allocation, always does)."""
    from dune_eigensolver_tpu_torch.experiments import gather_probe as gp

    gen = torch.Generator(device="cuda").manual_seed(rows * nb * bw + off)
    flat = torch.randn(rows * nb * bw + off, generator=gen, device=cuda)[off:]
    x2, x3 = flat.view(rows, nb * bw), flat.view(nb, rows, bw)
    pt = torch.tensor([p], dtype=torch.int32, device=cuda)
    width = 4 if bw % 4 == 0 and off % 4 == 0 else 1
    counts = {f: f.launches for f in (gp.lane_slice, gp.block_select)}
    want2, want3 = gp.lane_slice_reference(x2, pt, bw), gp.block_select_reference(x3, pt)
    assert torch.equal(gp.lane_slice(x2, pt, bw), want2) and gp.lane_slice.width == width
    assert torch.equal(gp.block_select(x3, pt), want3) and gp.block_select.width == width
    torch.cuda.synchronize()
    assert all(f.launches == c + 1 for f, c in counts.items())


# (rows, nb, bw, floats x's first element lies past an allocation, p):
# rows 1, 3 and 8; bw no multiple of 4 (the row copy); one float4 a row;
# chunks that straddle rows (bw 1,000, 4,100) and rows of several chunks; a
# view 4 and 8 bytes off 16 (the row copy); p below and above [0, nb - 1]
# (clamped); nb = 1; 64 blocks of 8 KB; the timed shape
SCRATCH_CASES = [
    (1, 4, 1024, 0, 2),
    (3, 3, 1000, 0, 1),
    (8, 4, 4100, 0, 3),
    (3, 5, 127, 0, 4),
    (3, 4, 4, 0, 3),
    (8, 2, 8196, 0, 1),
    (2, 3, 4096, 1, 2),
    (4, 3, 256, 2, 0),
    (4, 6, 64, 0, -7),
    (4, 6, 64, 0, 99),
    (1, 1, 1000, 0, 0),
    (2, 64, 2048, 0, 63),
    (8, 4, 1_048_576, 0, 2),
]


@pytest.mark.parametrize("rows,nb,bw,off,p", SCRATCH_CASES)
def test_scratch_bodies_match_plain(cuda, rows, nb, bw, off, p):
    """``block_select_scratch`` (bulk copies of block p alone where
    ``scratch_body`` says so, else the row copy of ``lane_slice``) against
    the plain version bit for bit; each launch counted once."""
    from dune_eigensolver_tpu_torch.experiments import gather_probe as gp

    gen = torch.Generator(device="cuda").manual_seed(rows * nb * bw + off)
    flat = torch.randn(rows * nb * bw + off, generator=gen, device=cuda)
    x = flat[off:].view(rows, nb * bw)
    pt = torch.tensor([p], dtype=torch.int32, device=cuda)
    want = gp.lane_slice_reference(x, pt, bw)
    body = "bulk" if bw % 4 == 0 and off % 4 == 0 else "rows"
    before = gp.block_select_scratch.launches
    assert torch.equal(gp.block_select_scratch(x, pt, bw), want)
    assert gp.block_select_scratch.body == body
    torch.cuda.synchronize()
    assert gp.block_select_scratch.launches == before + 1


def test_scratch_launcher_refuses_bulk_off_grid(cuda):
    """``block_select_launch`` (the bulk body) refuses where a segment would
    leave the 16-byte grid: x off 16 bytes, bw no multiple of 4, the output
    off 16 bytes."""
    from dune_eigensolver_tpu_torch.experiments import gather_probe as gp

    flat = torch.zeros(4 * 512 + 4, device=cuda)
    out = torch.empty(4 * 128 + 1, device=cuda)
    p = torch.zeros(1, dtype=torch.int32, device=cuda)
    for x_ptr, bw, o_ptr in ((flat[1:].data_ptr(), 128, out.data_ptr()),
                             (flat.data_ptr(), 126, out.data_ptr()),
                             (flat.data_ptr(), 128, out[1:].data_ptr())):
        with pytest.raises(RuntimeError, match="block_select_launch"):
            gp._run("block_select_launch", flat, x_ptr, p.data_ptr(), o_ptr, 4, bw, 4)


def test_row_copy_launcher_refuses_float4_off_grid(cuda):
    """The launcher checks what ``slice_vector_width`` checks: float4 moves
    on an address off 16 bytes, or on a bw no multiple of 4, are refused
    before any launch."""
    from dune_eigensolver_tpu_torch.experiments import gather_probe as gp

    flat = torch.zeros(4 * 128 + 1, device=cuda)
    out = torch.empty((4, 128), device=cuda)
    p = torch.zeros(1, dtype=torch.int32, device=cuda)
    for x_ptr, bw in ((flat[1:].data_ptr(), 128), (flat.data_ptr(), 126)):
        with pytest.raises(RuntimeError, match="slice_rows_launch"):
            gp._run("slice_rows_launch", flat, 4, x_ptr, p.data_ptr(), out.data_ptr(), 4, bw, 1,
                    bw, 4 * bw)


# (rows, width, floats x's first element lies past an allocation, body):
# rows 1, 3, 8 and 16; a last chunk of 488 columns and one of 4; a width off
# the 16-byte grid and a view one float off (the first version); the most
# rows a block's shared memory holds (231 KB) and more than that
AXIS0_CASES = [
    (1, 4096, 0, "bulk"),
    (3, 1000, 0, "bulk"),
    (8, 40964, 0, "bulk"),
    (16, 8192, 0, "bulk"),
    (8, 1001, 0, "first"),
    (8, 4096, 1, "first"),
    (113, 1028, 0, "bulk"),
    (120, 256, 0, "first"),
]


@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("rows,width,off,body", AXIS0_CASES)
def test_axis0_bodies_match_plain(cuda, rows, width, off, body, wild):
    """``gather_axis0`` (the bulk body where ``axis0_body`` says so, else the
    first version) against the plain version bit for bit, on indices in
    range and on wild ones (clamped); each launch counted once."""
    from dune_eigensolver_tpu_torch.experiments import gather_probe as gp

    gen = torch.Generator(device="cuda").manual_seed(rows * width + off + wild)
    flat = torch.randn(rows * width + off, generator=gen, device=cuda)
    x = flat[off:].view(rows, width)
    lo, hi = (-3 * rows, 4 * rows) if wild else (0, rows)
    idx = torch.randint(lo, hi, (rows, width), generator=gen, device=cuda, dtype=torch.int32)
    want = gp.gather_axis0_reference(x, idx)
    before = gp.gather_axis0.launches
    assert torch.equal(gp.gather_axis0(x, idx), want) and gp.gather_axis0.body == body
    torch.cuda.synchronize()
    assert gp.gather_axis0.launches == before + 1


def test_axis0_launcher_refuses_bulk_off_grid(cuda):
    """``gather_axis0_launch`` checks what ``axis0_body`` checks: the bulk
    body (flag 1) on x, idx or out off 16 bytes, on a width no multiple of
    4 or on more rows than shared memory holds is refused before any
    launch, and so is an unknown flag."""
    from dune_eigensolver_tpu_torch.experiments import gather_probe as gp

    n = 4 * 1024 + 4
    x = torch.zeros(n, device=cuda)
    idx = torch.zeros(n, dtype=torch.int32, device=cuda)
    out = torch.empty(n, device=cuda)
    ptrs = (x.data_ptr(), idx.data_ptr(), out.data_ptr())
    bulk = gp.AXIS0_BODIES["bulk"]
    for body, (xp, ip, op), rows, width in (
        (bulk, (x[1:].data_ptr(), ptrs[1], ptrs[2]), 4, 1024),
        (bulk, (ptrs[0], idx[1:].data_ptr(), ptrs[2]), 4, 1024),
        (bulk, (ptrs[0], ptrs[1], out[1:].data_ptr()), 4, 1024),
        (bulk, ptrs, 4, 1022),
        (bulk, ptrs, gp.AXIS0_MAX_ROWS + 1, 4),
        (2, ptrs, 4, 1024),
    ):
        with pytest.raises(RuntimeError, match="gather_axis0_launch"):
            gp._run("gather_axis0_launch", x, body, xp, ip, op, rows, width)


def test_probe_kernels_clamp_and_refuse(cuda):
    from dune_eigensolver_tpu_torch.experiments import gather_probe as gp

    x = torch.randn((4, 256), device=cuda)
    wild = torch.randint(-500, 500, (4, 256), device=cuda, dtype=torch.int32)
    for fn in (gp.gather_lanes_smem, gp.gather_lanes_global):
        assert torch.equal(fn(x, wild, 128), gp.gather_lanes_reference(x, wild, 128))
    assert torch.equal(gp.gather_lanes_shfl(x, wild), gp.gather_lanes_reference(x, wild, 128))
    assert torch.equal(gp.gather_axis0(x, wild), gp.gather_axis0_reference(x, wild))
    for s in (-5, 0, 300):
        st = torch.tensor([s], dtype=torch.int32, device=cuda)
        assert torch.equal(gp.roll_lanes(x, st, 64), gp.roll_lanes_reference(x, st, 64))
    for p in (-3, 1, 9):
        pt = torch.tensor([p], dtype=torch.int32, device=cuda)
        assert torch.equal(gp.lane_slice(x, pt, 64), gp.lane_slice_reference(x, pt, 64))
        assert torch.equal(gp.block_select_scratch(x, pt, 64), gp.lane_slice_reference(x, pt, 64))
        assert torch.equal(gp.block_select(x.reshape(4, 4, 64), pt),
                           gp.block_select_reference(x.reshape(4, 4, 64), pt))
    odd = torch.randn((3, 7), device=cuda)  # 21 elements: the byte path of the widen-add
    i8 = torch.randint(-128, 128, (3, 7), device=cuda, dtype=torch.int8)
    assert torch.equal(gp.int8_widen(odd, i8), gp.int8_widen_reference(odd, i8))
    with pytest.raises(ValueError, match="power of two"):
        gp.gather_lanes_smem(x, wild, 96)
    with pytest.raises(ValueError, match="seg = 128"):
        gp.gather_lanes_shfl(x, wild, 64)
    with pytest.raises(TypeError, match="idx dtype"):
        gp.gather_lanes_int8(x, wild, 128)
    with pytest.raises(TypeError, match="float32"):
        gp.roll_lanes(x.double(), torch.zeros(1, dtype=torch.int32, device=cuda), 64)
    # 64 blocks of 8 KB: the bulk body stages chunks of block p alone
    wide = torch.randn((1, 64 * 2048), device=cuda)
    p0 = torch.tensor([63], dtype=torch.int32, device=cuda)
    assert torch.equal(gp.block_select_scratch(wide, p0, 2048),
                       gp.lane_slice_reference(wide, p0, 2048))


def test_standard_entry_points_on_card(cuda):
    """``standard_largest`` on the 2D Laplacian (N = 96) and
    ``standard_inverse`` with the default inverse on the 3D one (N = 48,
    band 2304 > 2048: V-cycle-CG) and on the 2D one (the block-banded
    engine) on the card, through the DIA kernel, against the closed form: the largest 4 within 4 * sqrt(tol) (a
    change-based stop on a dense upper end fires near k = sqrt(4 / tol)
    iterations, where a Rayleigh quotient sits 4 / k = sqrt(4 * tol) below
    the top: the gate is twice that and depends on tol alone), the smallest
    4 within 1e-4 (3D) and 1e-5 (2D, 10 x tol) at tol 1e-6."""
    from dune_eigensolver_tpu_torch.oracle import (
        eigenvalues_laplace_dirichlet_2d,
        eigenvalues_laplace_dirichlet_3d,
    )
    from dune_eigensolver_tpu_torch.solvers import standard_inverse, standard_largest

    A2 = problems.laplacian_dirichlet_2d(96, dtype=torch.float32, device=cuda)
    before = kd.dia_spmm_t_cuda.launches
    res = standard_largest(A2, nev=4, tol=2e-3, maxiter=2000, rayleigh_ritz=True)
    assert kd.dia_spmm_t_cuda.launches == before + 2 * int(res.iterations)
    ev = res.eigenvalues.cpu().numpy()
    assert bool(res.converged) and res.eigenvectors.shape == (96 * 96, 4)
    err = np.abs(ev - eigenvalues_laplace_dirichlet_2d(96)[::-1][:4]).max()
    assert err <= 4 * np.sqrt(2e-3)
    A3 = problems.laplacian_dirichlet_3d(48, dtype=torch.float32, device=cuda)
    before = kd.dia_spmm_t_cuda.launches
    res = standard_inverse(A3, nev=4, tol=1e-6, maxiter=100)
    assert kd.dia_spmm_t_cuda.launches > before and bool(res.converged)
    ev = res.eigenvalues.cpu().numpy()
    assert np.abs(ev - eigenvalues_laplace_dirichlet_3d(48, count=4)).max() <= 1e-4
    # no inverse= on the 2D stencil: the block-banded engine (K1 refines)
    before = kd.dia_spmm_t_cuda.launches
    res = standard_inverse(A2, nev=4, tol=1e-6, maxiter=100)
    assert kd.dia_spmm_t_cuda.launches > before and bool(res.converged)
    ev = res.eigenvalues.cpu().numpy()
    assert np.abs(ev - eigenvalues_laplace_dirichlet_2d(96)[:4]).max() <= 1e-5


def test_study_path_and_protocols_on_card(cuda, capsys):
    """The new entry points at a small size on the card: the ablation and
    probe mains and the three convergence protocols print their lines."""
    from dune_eigensolver_tpu_torch import cli
    from dune_eigensolver_tpu_torch.experiments import gather_ablate as ga
    from dune_eigensolver_tpu_torch.experiments import gather_probe as gp

    assert ga.main(["32", "--graph-n", "20000"]) == 0
    assert gp.main(["--width", "65536"]) == 0
    assert cli.main(["--test", "largest", "ev.N=32"]) == 0
    assert cli.main(["--test", "smallest", "ev.N=12", "ev.dim=3", "ev.inverse=mgcg"]) == 0
    assert cli.main(["--test", "eigenvalues", "ev.method=lobpcg", "ev.nested=1", "ev.dim=3",
                     "ev.N=24", "ev.inverse=mg", "ev.b_identity=1", "ev.min_coarse=6"]) == 0
    out = capsys.readouterr().out
    assert out.count("ABLATE variant=") == 8 and out.count("ABLATE rows=") == 2 * len(ga.SWEEP)
    assert "ABLATE first" not in out and "copy_share=n/a" not in out
    assert out.count(": OK") == 12 and "probe done" in out and "FORM name=gather_lanes_shfl" in out
    assert "N_M_TOL_ESARERROR_ESANERROR_ARANERROR_TIMERATIO: 32 8 " in out
    assert "N_M_TOL_RASERROR_ARPERROR_TIMERATIO: 12 8 " in out
    assert "RESULT eigenvalues_test lobpcg N=24 m=8 " in out


def _backward_err(A, Y, R):
    """max|A Y - R| / max(|A| |Y|) in float64 on the host, Y and R (m, n):
    a few f32 ulps for a stable solve, whatever the operator's condition."""
    S = A.to_scipy().astype(np.float64)
    Yd, Rd = Y.double().cpu().numpy().T, R.double().cpu().numpy().T
    return float(np.abs(S @ Yd - Rd).max() / (abs(S) @ np.abs(Yd)).max())


def _spd_laplacian(N, shift, device):
    return problems.laplacian_dirichlet_2d(N, dtype=torch.float32, device=device) \
        .with_shifted_diagonal(shift)


@pytest.mark.parametrize("method,shift,tol", [
    ("lu", 0.1, 1e-4), ("cholesky", 0.1, 1e-4), ("lu", -0.5, 2e-3)])
def test_banded_solve_on_card_matches_cpu(cuda, method, shift, tol):
    """The device factorization and the sweep on the card (cuSOLVER/cuBLAS,
    strict f32) against the same on the CPU (LAPACK): N = 100, C = 256
    (40 blocks), 8 right-hand sides, within ``tol`` of each other relative
    to max|X|: f32 rounding times the condition, ~80 for shift 0.1 (SPD),
    ~1.5e4 for shift -0.5 (indefinite: the LU pivots inside the blocks)."""
    from dune_eigensolver_tpu_torch.factorize import banded_solve, factorize_banded_device

    out = []
    for dev in ("cpu", cuda):
        A = _spd_laplacian(100, shift, dev)
        F = factorize_banded_device(A, method=method, validate=True)
        assert F.stats == (100, 256, 40, method) and F.fwd.dinv.device.type == torch.device(dev).type
        B = torch.from_numpy(np.random.default_rng(0).standard_normal((10_000, 8))).float()
        out.append(banded_solve(F, B.to(dev)).cpu())
    scale = out[0].abs().max()
    assert ((out[1] - out[0]).abs().max() / scale).item() <= tol


def test_device_cholesky_validate_raises_on_card(cuda):
    """``validate=True`` reads cuSOLVER's codes back once and raises on a
    non-SPD operator; the LU of the same operator passes."""
    from dune_eigensolver_tpu_torch.factorize import factorize_banded_device

    A = _spd_laplacian(60, -0.5, cuda)
    with pytest.raises(ZeroDivisionError, match="not SPD"):
        factorize_banded_device(A, method="cholesky", validate=True)
    factorize_banded_device(A, validate=True)


def test_banded_pair_refines_through_k1(cuda):
    """The default pair on a 2D stencil: one K1 launch per apply (the
    refinement residual), the plain DIA product never, and a backward error
    (``_backward_err``) of at most 1e-5."""
    from dune_eigensolver_tpu_torch.factorize import default_inverse_factory
    spmm_mod = importlib.import_module("dune_eigensolver_tpu_torch.sparse.spmm")

    A = _spd_laplacian(128, 0.05, cuda)
    aux, fn = default_inverse_factory(A)
    assert fn.engine == "banded" and aux[0].stats == (128, 256, 64, "lu")
    R = torch.randn((8, A.shape[0]), device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    route = spmm_mod._ROUTES[DIAMatrix]
    spmm_mod._ROUTES[DIAMatrix] = (route[0], None)  # the plain version would raise
    try:
        before = kd.dia_spmm_t_cuda.launches
        Y = fn(aux, R)
        torch.cuda.synchronize()
        assert kd.dia_spmm_t_cuda.launches == before + 1
    finally:
        spmm_mod._ROUTES[DIAMatrix] = route
    assert _backward_err(A, Y, R) <= 1e-5


@pytest.mark.parametrize("kind", ["ell", "bsr"])
def test_rcm_residual_runs_the_gather_kernels(cuda, kind):
    """The RCM-banded pair on the card: the refinement residual multiplies
    by the permuted operand in its own container, so each apply launches K2
    (ELL: a scrambled 2D Laplacian) or K3 (BSR: ``elasticity_2d(32)``) once
    and no plain product (its routes are taken away for the apply); the
    solve's backward error is at most 1e-5."""
    import scipy.sparse as sp

    from dune_eigensolver_tpu_torch.factorize import default_inverse_factory
    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.sparse import ELLMatrix, BSRMatrix, ell_from_scipy
    spmm_mod = importlib.import_module("dune_eigensolver_tpu_torch.sparse.spmm")

    if kind == "ell":
        S = problems.laplacian_dirichlet_2d(60, dtype=torch.float64, device="cpu").to_scipy()
        p = np.random.default_rng(0).permutation(3600)
        A = ell_from_scipy(sp.csr_matrix(S[p][:, p]) + 0.05 * sp.identity(3600),
                           dtype=torch.float32, device=cuda)
        kernel = kg.ell_spmm_t_cuda
    else:
        A = problems.elasticity_2d(32, dtype=torch.float32, device=cuda)[0].with_shifted_diagonal(1e-3)
        kernel = kg.bsr_spmm_t_cuda
    aux, fn = default_inverse_factory(A)
    assert fn.engine == "rcm_banded" and type(aux[1]) is type(A)
    R = torch.randn((8, A.shape[0]), device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    saved = dict(spmm_mod._ROUTES)
    for cls in (DIAMatrix, ELLMatrix, BSRMatrix):
        spmm_mod._ROUTES[cls] = (saved[cls][0], None)
    try:
        before = kernel.launches
        Y = fn(aux, R)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
    finally:
        spmm_mod._ROUTES.update(saved)
    assert _backward_err(A, Y, R) <= 1e-5


def test_host_lu_on_card_matches_cpu(cuda):
    """``lu_inverse_factory``: SuperLU on the host, the chunked solve on
    the card, against the same solve on the CPU (1e-5 of max|Y|, f32; the
    same factors, the gathers in another order) and a backward error of at
    most 1e-5."""
    from dune_eigensolver_tpu_torch.factorize import lu_inverse_factory

    out = []
    R = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 4096))).float()
    for dev in ("cpu", cuda):
        A = _spd_laplacian(64, 0.0, dev)
        aux, fn = lu_inverse_factory(A)
        assert fn.engine == "host_lu" and aux.dinv.device.type == torch.device(dev).type
        out.append(fn(aux, R.to(dev)))
    assert ((out[1].cpu() - out[0]).abs().max() / out[0].abs().max()).item() <= 1e-5
    assert _backward_err(A, out[1], R) <= 1e-5


# --- float64: the f64 instantiations of K1, K2 and K3 ---------------------


def _f64(A):
    import dataclasses

    field = "bdata" if hasattr(A, "bdata") else "data"
    return dataclasses.replace(A, **{field: getattr(A, field).double()})


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("m", [1, 3, 8, 24])
def test_f64_dia_kernel_matches_reference(cuda, pattern, m):
    """K1 in f64 takes one column a thread on every pattern (no vector body
    for 8-byte items) and sums the plain version's f64 products in offset
    order, FMA-contracted: within 1e-12 of max|A| max|X| ndiag."""
    A, X = _operands(pattern, m, torch.float64, cuda)
    before = kd.dia_spmm_t_cuda.launches
    Y = spmm_t(A, X)
    torch.cuda.synchronize()
    assert kd.dia_spmm_t_cuda.launches == before + 1
    assert kd.dia_spmm_t_cuda.width == 1 and Y.dtype == torch.float64
    tol = 1e-12 * A.data.abs().max().item() * X.abs().max().item() * len(A.offsets)
    assert (Y - kd.dia_spmm_t_reference(A, X)).abs().max().item() <= tol


def test_f64_leaves_the_f32_and_bf16_widths(cuda):
    """The f64 rule moves no f32/bf16 dispatch: the widths chip_smoke.py
    asserts at the solve's shapes (4 at N=108, 2 at N=54, 1 at N=37)."""
    for pattern, want in (("3d108", 4), ("3d54", 2), ("3d37", 1), ("2d16", 4)):
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            A, X = _operands(pattern, 2, dtype, cuda)
            kd.dia_spmm_t_cuda(A, X)
            assert kd.dia_spmm_t_cuda.width == (1 if dtype == torch.float64 else want)


@pytest.mark.parametrize("kind", GATHER_KINDS)
@pytest.mark.parametrize("m", [1, 3, 8, 24, 128])
def test_f64_gather_kernels_match_reference(cuda, kind, m):
    """K2 and K3 in f64 against their plain versions: the same f64 products
    of a row in other orders, within 1e-12 of the row's |A|.|X|; int16
    offsets and int32 columns alike; b = 2 and 4."""
    import dataclasses

    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.sparse import BSRMatrix

    A = _f64(_gather_operand(kind, cuda))
    field = "bdata" if isinstance(A, BSRMatrix) else "data"
    wrapper = kg.bsr_spmm_t_cuda if field == "bdata" else kg.ell_spmm_t_cuda
    plain = kg.bsr_spmm_t_reference if field == "bdata" else kg.ell_spmm_t_reference
    X = torch.from_numpy(np.random.default_rng(m).standard_normal((m, A.shape[1]))).to(cuda)
    before = wrapper.launches
    Y = spmm_t(A, X)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert Y.shape == (m, A.shape[0]) and Y.dtype == torch.float64
    absA = dataclasses.replace(A, **{field: getattr(A, field).abs()})
    tol = 1e-12 * plain(absA, X.abs()).max().item()
    assert (Y - plain(A, X)).abs().max().item() <= tol


@pytest.mark.parametrize("kind", WARP_KINDS)
def test_f64_ell_kernel_stops_each_warp_at_its_count(cuda, kind):
    import dataclasses

    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg

    A = _f64(_warp_operand(kind, cuda))
    X = torch.from_numpy(np.random.default_rng(9).standard_normal((9, A.shape[1]))).to(cuda)
    absA = dataclasses.replace(A, data=A.data.abs())
    tol = 1e-12 * kg.ell_spmm_t_reference(absA, X.abs()).max().item()
    assert (kg.ell_spmm_t_cuda(A, X) - kg.ell_spmm_t_reference(A, X)).abs().max().item() <= tol


def test_f64_wrappers_refuse_mixed_operands(cuda):
    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg

    A, X = _operands("3d7", 4, torch.float64, cuda)
    with pytest.raises(TypeError, match="the same for both"):
        kd.dia_spmm_t_cuda(A, X.float())
    for kind, wrapper in (("ell-graph", kg.ell_spmm_t_cuda), ("bsr2-elasticity", kg.bsr_spmm_t_cuda)):
        A = _f64(_gather_operand(kind, cuda))
        with pytest.raises(TypeError, match="float32 or float64"):
            wrapper(A, torch.randn((4, A.shape[1]), device=cuda))


def test_paranoid_nan_check_on_kernel_dispatches(cuda, capsys):
    """In paranoid mode each kernel dispatch of ``spmm_t`` feeds its output
    to ``nan_check`` under the kernel's name: an infinite X value inside the
    sampled centre raises that kernel's flag on the card, read once by
    ``report``; paranoid mode off, a dispatch makes no flag."""
    from dune_eigensolver_tpu_torch.utils import paranoid

    dia, _ = _operands("3d108", 2, torch.float32, cuda)
    operands = {"dia_spmm_t_cuda": dia, "ell_spmm_t_cuda": _gather_operand("ell-graph", cuda),
                "bsr_spmm_t_cuda": _gather_operand("bsr2-elasticity", cuda)}
    paranoid.set_paranoid(True)
    try:
        for tag, A in operands.items():
            n = A.shape[1]
            X = torch.ones((2, n), device=cuda)
            spmm_t(A, X)
            assert paranoid.report() == []
            X[:, n // 2] = float("inf")
            spmm_t(A, X)
            flag = paranoid._FLAGS[("nan", tag, X.device)]
            assert flag.is_cuda and bool(flag)
            (line,) = paranoid.report()
            assert f"kernel '{tag}'" in line and line.startswith("PARANOID")
    finally:
        paranoid.set_paranoid(False)
    spmm_t(dia, torch.full((2, dia.shape[1]), float("inf"), device=cuda))
    assert paranoid._FLAGS == {}


def test_refine_on_card_matches_cpu(cuda):
    """``refine_eigenpairs`` on the card (the f64 kernels, one launch for
    B = None) against the same refinement on the CPU: 1e-12 relative."""
    from dune_eigensolver_tpu_torch.solvers import refine_eigenpairs

    for A_cpu, B_cpu in (
        (problems.laplacian_dirichlet_2d(40, dtype=torch.float32, device="cpu"), None),
        problems.elasticity_2d(12, dtype=torch.float32, device="cpu"),
    ):
        n = A_cpu.shape[0]
        V = torch.from_numpy(np.random.default_rng(0).standard_normal((n, 8))).float()
        w_cpu, _ = refine_eigenpairs(A_cpu, B_cpu, V)
        move = lambda M: None if M is None else _to(M, cuda)  # noqa: E731
        before = kd.dia_spmm_t_cuda.launches
        w, Vr = refine_eigenpairs(move(A_cpu), move(B_cpu), V.to(cuda), rotate_vectors=True)
        if B_cpu is None:
            assert kd.dia_spmm_t_cuda.launches == before + 1
        assert Vr.is_cuda and Vr.dtype == torch.float32
        assert np.abs(w - w_cpu).max() <= 1e-12 * np.abs(w_cpu).max()


def _to(M, device):
    import dataclasses

    return dataclasses.replace(M, **{f.name: getattr(M, f.name).to(device)
                                     for f in dataclasses.fields(M)
                                     if isinstance(getattr(M, f.name), torch.Tensor)})


def test_f64_solves_on_card_match_cpu(cuda):
    """f64 end to end on the card (the CLI's ``ev.dtype=float64``): the
    default-inverse ``generalized_inverse`` on the 2D GenEO pencil (DIA,
    K1 f64) and on elasticity_2d(8) (BSR, K3 f64) from one start block,
    against the same solve on the CPU: iterations within one, eigenvalues
    to 1e-8 relative."""
    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.solvers import generalized_inverse

    pencils = (
        (problems.laplacian_neumann_2d(16, dtype=torch.float64, device="cpu"),
         problems.laplacian_b_2d(16, 3, dtype=torch.float64, device="cpu"), kd.dia_spmm_t_cuda),
        problems.elasticity_2d(8, dtype=torch.float64, device="cpu") + (kg.bsr_spmm_t_cuda,),
    )
    for A, B, kernel in pencils:
        q0 = torch.from_numpy(np.random.default_rng(1).standard_normal((A.shape[0], 8)))
        kw = dict(nev=8, tol=1e-8, maxiter=300, shift=1e-3)
        r_cpu = generalized_inverse(A, B, q0=q0, **kw)
        before = kernel.launches
        r = generalized_inverse(_to(A, cuda), _to(B, cuda), q0=q0.to(cuda), **kw)
        assert kernel.launches > before
        # cuBLAS and the CPU's BLAS round differently: the change-based stop
        # may move by one iteration
        assert abs(int(r.iterations) - int(r_cpu.iterations)) <= 1
        e = r_cpu.eigenvalues.numpy()
        assert np.abs(r.eigenvalues.cpu().numpy() - e).max() <= 1e-8 * np.abs(e).max()


@pytest.fixture
def nccl_world1(cuda, tmp_path):
    """A world-size-1 NCCL group on the card (FileStore under tmp_path),
    ended after the test."""
    import torch.distributed as dist

    from dune_eigensolver_tpu_torch.dist import init_distributed

    store = dist.FileStore(str(tmp_path / "store"), 1)
    init_distributed(cuda, store=store, rank=0, world_size=1)
    yield cuda
    dist.destroy_process_group()


def test_dist_world1_nccl_solves_run_the_kernels(nccl_world1):
    """The sharded drivers at world size 1 under NCCL: the north-star form
    (``precond='mg'``, bf16 smoothing, ``ortho_block=24``) on the 3D N=24
    Laplacian launches K1 (f32 and bf16), all-reduces its Grams and gathers
    once a V-cycle, and gives the single-card LOBPCG's eigenvalues (same
    seed; at P = 1 the sharded V(1,1) cycle restricts in the single-card
    order, so the same operations) to 1e-6 relative and the analytic
    spectrum to 3e-4; ``sharded_standard_largest`` gives
    ``standard_largest``'s bits. A CUDA tensor on a gloo group raises."""
    import torch.distributed as dist

    from dune_eigensolver_tpu_torch import dist as tdist
    from dune_eigensolver_tpu_torch.dist import sharded
    from dune_eigensolver_tpu_torch.dist.mesh import Mesh
    from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory
    from dune_eigensolver_tpu_torch.oracle.analytic import eigenvalues_laplace_dirichlet_3d
    from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized, standard_largest

    dev = nccl_world1
    A = problems.laplacian_dirichlet_3d(24, dtype=torch.float32, device=dev)
    n = A.shape[0]
    B = DIAMatrix(data=torch.ones((1, n), device=dev), offsets=(0,), shape=A.shape)
    kw = dict(nev=24, tol=2e-3, maxiter=300, ortho_block=24)
    mesh = tdist.make_mesh()
    assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cuda")
    sharded.COUNTS.clear()
    def by_dtype():
        out = collections.Counter()
        for call, c in kd.dia_spmm_t_cuda.calls.items():
            out[call.dtype] += c
        return out

    before = by_dtype()
    r = tdist.sharded_lobpcg_generalized(A, B, mesh=mesh, precond="mg",
                                         prec_dtype=torch.bfloat16, **kw)
    after = by_dtype()
    for dt in (torch.float32, torch.bfloat16):
        assert after[dt] > before[dt]
    assert sharded.COUNTS["all_reduce"] > 0 and sharded.COUNTS["all_gather"] > int(r.iterations)
    r1 = lobpcg_generalized(A, B, precond=mg_inverse_factory(nu1=1, nu2=1, dtype=torch.bfloat16),
                            **kw)
    ev, ev1 = r.eigenvalues.cpu().numpy(), r1.eigenvalues.cpu().numpy()
    assert np.abs(ev - ev1).max() <= 1e-6 * np.abs(ev1).max()
    exact = eigenvalues_laplace_dirichlet_3d(24, count=20)
    assert np.abs(np.sort(ev)[:20] - exact).max() <= 3e-4
    A2 = problems.laplacian_dirichlet_2d(64, dtype=torch.float32, device=dev)
    rs = tdist.sharded_standard_largest(A2, nev=8, tol=1e-4, maxiter=500, mesh=mesh)
    rl = standard_largest(A2, nev=8, tol=1e-4, maxiter=500)
    assert int(rs.iterations) == int(rl.iterations)
    assert torch.equal(rs.eigenvalues, rl.eigenvalues)
    gloo = dist.new_group(backend="gloo")
    with pytest.raises(ValueError, match="no fallback"):
        tdist.sharded_standard_largest(A2, nev=8, tol=1e-4, maxiter=5,
                                       mesh=Mesh(group=gloo, ranks=(0,), rank=0, device=dev))


@pytest.mark.parametrize("P", [2, 3, 4, 8])
def test_dist_local_applies_split_p_ways(cuda, P):
    """The K1 and K2 routes' local applies, P ranks played in one process
    (``dist/dryrun.py``), against the global kernel on the card: K1 on the
    3D N=24 and 2D N=50 (padded rows at P = 3, 8) Laplacians, f32 to 1e-6
    of max|Y| and bf16 to 1e-2 (the edge terms are added after the
    kernel's bf16 rounding); K2 overlapped and serialized on an RCM-ordered
    graph Laplacian (n = 3001, padded at every P) to 1e-6 of max|Y|. K1 and
    K2 launch once a rank; the bandwidth guard raises."""
    from dune_eigensolver_tpu_torch.dist.dryrun import split_dia_apply_t, split_windowed_apply_t
    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.sparse import rcm_pencil

    gen = torch.Generator(device=cuda).manual_seed(P)
    for A in (problems.laplacian_dirichlet_3d(24, dtype=torch.float32, device=cuda),
              problems.laplacian_dirichlet_2d(50, dtype=torch.float32, device=cuda)):
        for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
            Ad = DIAMatrix(data=A.data.to(dtype), offsets=A.offsets, shape=A.shape)
            X = torch.randn((8, A.shape[0]), generator=gen, device=cuda).to(dtype)
            Y = spmm_t(Ad, X).float()
            before = kd.dia_spmm_t_cuda.launches
            Z = split_dia_apply_t(Ad, X, P).float()
            assert kd.dia_spmm_t_cuda.launches == before + P
            assert (Z - Y).abs().max().item() <= tol * Y.abs().max().item()
    S = problems.unstructured_laplacian(3001, extra_edges=100, seed=5, fmt="scipy")
    E = rcm_pencil(S, dtype=torch.float32, device=cuda)[0]
    X = torch.randn((8, 3001), generator=gen, device=cuda)
    Y = spmm_t(E, X)
    plans = None
    for overlap in (True, False):
        before = kg.ell_spmm_t_cuda.launches
        Z, plans = split_windowed_apply_t(E.to_scipy(), X, P, overlap, plans)
        assert kg.ell_spmm_t_cuda.launches == before + P
        assert (Z - Y).abs().max().item() <= 1e-6 * Y.abs().max().item()
    from dune_eigensolver_tpu_torch.dist import sharded

    with pytest.raises(ValueError, match="bandwidth"):
        sharded.dia_local_apply_t(sharded.local_operand(A.data[:, :40].contiguous(), A.offsets),
                                  X[:, :40].contiguous())


# ---------------------------------------------------------------------------
# The JAX package's public hooks and transposed gather products
# ---------------------------------------------------------------------------


def test_hooked_lobpcg_runs_the_dia_kernel(cuda):
    """``lobpcg_generalized`` on a CUDA DIA operand, matrix-free (K1 through
    ``apply_a``, identity ``apply_b`` and ``gram_reduce``, the V-cycle handed
    out by ``precond(None)``, q0 transposed): K1 launches, and the result
    is the unhooked solve's bits."""
    from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory
    from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized

    A = problems.laplacian_dirichlet_3d(24, dtype=torch.float32, device=cuda)
    n = A.shape[0]
    B = DIAMatrix(data=torch.ones((1, n), device=cuda), offsets=(0,), shape=A.shape)
    prec = mg_inverse_factory(nu1=1, nu2=1)
    pair = prec(A)
    q0 = torch.randn((n, 8), generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    kw = dict(nev=8, tol=2e-3, maxiter=100, ortho_iterations=1, ortho_block=8)
    plain = lobpcg_generalized(A, B, precond=lambda _A: pair, b_identity=True, q0=q0, **kw)
    before = kd.dia_spmm_t_cuda.launches
    hooked = lobpcg_generalized(A, B, apply_a=lambda X: spmm_t(A, X), apply_b=lambda X: X,
                                gram_reduce=lambda g: g, precond=lambda _none: pair,
                                q0=q0.T.contiguous(), **kw)
    assert kd.dia_spmm_t_cuda.launches > before
    assert int(hooked.iterations) == int(plain.iterations)
    assert torch.equal(hooked.eigenvalues, plain.eigenvalues)
    assert torch.equal(hooked.eigenvectors, plain.eigenvectors)


@pytest.mark.parametrize("kind", ["ell", "bsr"])
def test_transposed_gather_products_run_their_kernels(cuda, kind):
    """``ell_spmm_t`` / ``bsr_spmm_t`` on CUDA tensors launch K2 / K3 (the
    counters move by one) and give ``spmm_t``'s bits; the plain version
    agrees to 1e-5 of the row's |A|.|X| (the kernels' own tolerance)."""
    import dataclasses

    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.sparse import ell_from_scipy
    from dune_eigensolver_tpu_torch.sparse.spmm import bsr_spmm_t, ell_spmm_t

    if kind == "ell":
        S = problems.unstructured_laplacian(5000, extra_edges=300, seed=5, fmt="scipy")
        A = ell_from_scipy(S, dtype=torch.float32, device=cuda)
        fn, wrapper, plain = ell_spmm_t, kg.ell_spmm_t_cuda, kg.ell_spmm_t_reference
    else:
        A, _ = problems.elasticity_2d(24, dtype=torch.float32, device=cuda)
        fn, wrapper, plain = bsr_spmm_t, kg.bsr_spmm_t_cuda, kg.bsr_spmm_t_reference
    X = torch.randn((8, A.shape[1]), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    before, calls = wrapper.launches, collections.Counter(wrapper.calls)
    Y = fn(A, X)
    assert wrapper.launches == before + 1
    (key,) = wrapper.calls - calls  # one launch, tallied by its shape
    assert (key.n, key.m, key.dtype, key.k) == (A.shape[0], 8, torch.float32, A.k if kind == "ell"
                                                else A.bcols.shape[1])
    assert torch.equal(Y, spmm_t(A, X))
    field = "bdata" if kind == "bsr" else "data"
    absA = dataclasses.replace(A, **{field: getattr(A, field).abs()})
    bound = 1e-5 * plain(absA, X.abs()).max().item()
    assert (Y - plain(A, X)).abs().max().item() <= bound


def _trace(prof, tmp_path):
    import json

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def test_spans_hold_every_k3_launch_on_the_trace_clock(cuda, tmp_path):
    """The program's spans on the card (``utils/vlog.py``), in one solve of
    the elasticity pencil with Jacobi-CG profiled with the card's activity
    alone: every K3 operation's launch record (its correlation id) falls
    inside a ``cg.apply``, ``lobpcg.spmm``, ``lobpcg.ortho`` or ``lobpcg.rr``
    (B in the Gram) span on the trace's clock (``baseTimeNanoseconds`` +
    ``ts`` * 1000), and the spans leave the bits. Then, with the host's
    activity too, every span holds its own ``record_function`` range to 20
    us. Prints a ``TRACECLOCK`` line of the margins, with each device
    operation's start against its launch record: the card's clock against
    the host's, whose offset the profiler sets anew in each process (-65 to
    +9 us on an H100), so it is reported and not held to a bound."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory
    from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized
    from dune_eigensolver_tpu_torch.utils import vlog

    A, B = problems.elasticity_2d(96, dtype=torch.float32, device=cuda)
    kw = dict(nev=8, tol=2e-3, maxiter=300, shift=1e-3, seed=3,
              precond=cg_inverse_factory(rtol=1e-2, maxiter=25))
    off = lobpcg_generalized(A, B, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with vlog.tracing() as spans:
            on = lobpcg_generalized(A, B, **kw)
            on.eigenvalues.cpu()
    assert torch.equal(off.eigenvalues, on.eigenvalues)
    assert torch.equal(off.eigenvectors, on.eigenvectors)
    trace = _trace(prof, tmp_path)
    base = int(trace["baseTimeNanoseconds"])
    events = trace["traceEvents"]
    launches = {}  # correlation id -> the earliest launch record's start
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            t = base + round(float(e["ts"]) * 1000)
            launches[corr] = min(t, launches.get(corr, t))
    ops = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    linked = [(e, launches[e["args"]["correlation"]]) for e in ops
              if e.get("args", {}).get("correlation") in launches]
    lags = [base + round(float(e["ts"]) * 1000) - t for e, t in linked]
    held = [(s.start_ns, s.end_ns) for s in spans
            if s.name in ("cg.apply", "lobpcg.spmm", "lobpcg.ortho", "lobpcg.rr")]
    k3_ops = [e for e in ops if "bsr_spmm_t_kernel" in e["name"]]
    k3 = [(base + round(float(e["ts"]) * 1000), t) for e, t in linked
          if "bsr_spmm_t_kernel" in e["name"]]
    assert len(k3) == len(k3_ops) > 0  # every K3 operation has its launch record
    k3 = [t for _, t in k3]
    outside = [t for t in k3 if not any(a <= t <= b for a, b in held)]
    assert not outside, f"{len(outside)} of {len(k3)} K3 launches outside the spans"
    margin = [min(t - a for a, b in held if a <= t <= b) for t in k3]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with vlog.tracing() as spans:
            lobpcg_generalized(A, B, **kw).eigenvalues.cpu()
    trace = _trace(prof, tmp_path)
    base = int(trace["baseTimeNanoseconds"])
    ranges = collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            r0 = base + round(float(e["ts"]) * 1000)
            ranges[e["name"]].append((r0, r0 + round(float(e["dur"]) * 1000)))
    mine = collections.defaultdict(list)
    for s in spans:
        mine[s.name].append((s.start_ns, s.end_ns))
    opening, closing = [], []
    for name, held in mine.items():
        theirs = sorted(ranges[name])
        assert len(theirs) == len(held), name
        for (start, end), (r0, r1) in zip(held, theirs):
            assert start - 20_000 <= r0 <= r1 <= end + 20_000, (name, r0 - start, end - r1)
            opening.append(r0 - start)
            closing.append(end - r1)
    q = lambda v, f: sorted(v)[min(int(f * len(v)), len(v) - 1)] / 1e3  # noqa: E731
    print("TRACECLOCK " + json.dumps(dict(
        k3_launches=len(k3), device_ops=len(ops), linked=len(linked),
        launch_to_start_us_min=min(lags) / 1e3, launch_to_start_us_median=q(lags, 0.5),
        started_before_launch=sum(lag <= 0 for lag in lags),
        k3_after_span_start_us_min=min(margin) / 1e3,
        spans=len(opening), range_opening_us_median=q(opening, 0.5),
        range_opening_us_max=q(opening, 1.0), range_closing_us_median=q(closing, 0.5),
        range_closing_us_max=q(closing, 1.0))))
