"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so on a machine without JAX it runs without the suite's conftest
(which configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dune_eigensolver_tpu_torch.kernels import dia_spmm as kd
from dune_eigensolver_tpu_torch.sparse import DIAMatrix, problems, spmm_t

pytestmark = pytest.mark.cuda

# 2D 5-point and 3D 7-point patterns; 7^3 = 343 and 37^3 = 50653 are not
# multiples of the 256-thread block
PATTERNS = {
    "2d16": (256, (-16, -1, 0, 1, 16)),
    "3d7": (343, (-49, -7, -1, 0, 1, 7, 49)),
    "3d37": (50653, (-1369, -37, -1, 0, 1, 37, 1369)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(pattern, m, dtype, device, seed=0):
    n, offsets = PATTERNS[pattern]
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.standard_normal((len(offsets), n))).to(device, dtype)
    X = torch.from_numpy(rng.standard_normal((m, n))).to(device, dtype)
    return DIAMatrix(data=data, offsets=offsets, shape=(n, n)), X


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("m", [8, 24, 72])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_reference(cuda, pattern, m, dtype):
    """f32: the same sum, FMA-contracted, 1e-5 of the output magnitude;
    bf16: both round one f32 sum, at most one bf16 ulp (2^-7) apart."""
    A, X = _operands(pattern, m, dtype, cuda)
    before = kd.dia_spmm_t_cuda.launches
    Y = spmm_t(A, X)
    torch.cuda.synchronize()
    assert kd.dia_spmm_t_cuda.launches == before + 1
    assert Y.dtype == dtype and Y.shape == X.shape
    R = kd.dia_spmm_t_reference(A, X)
    tol = (1e-5 if dtype == torch.float32 else 1e-2) * R.float().abs().max().item()
    assert (Y.float() - R.float()).abs().max().item() <= tol


def test_kernel_wrapper_refuses_bad_operands(cuda):
    A, X = _operands("3d7", 8, torch.float32, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
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
    pattern = sp.random(90, 90, density=0.2, random_state=2, format="csr") + sp.eye(90)
    b = 2 if kind == "bsr2-wide" else 4  # k > 16 (b=2) or > 4 (b=4): chunked
    block = np.random.default_rng(3).standard_normal((b, b))
    return bsr_from_scipy(sp.kron(pattern, block).tocsr(), block=(b, b), dtype=f32, device=device)


GATHER_KINDS = ["ell-graph", "ell-wide", "ell-rect", "bsr2-elasticity", "bsr2-wide", "bsr4"]


@pytest.mark.parametrize("kind", GATHER_KINDS)
@pytest.mark.parametrize("m", [8, 24])
def test_gather_kernels_match_reference(cuda, kind, m):
    """Both sum the same f32 products of a row in other orders: within
    1e-5 of the row's |A|.|X|."""
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


def _variant_calls(kv, tile, rows):
    calls = [("c", lambda A, X: kv.spmm_c(A, X, tile=tile, rows=rows), kv.spmm_c)]
    for s, q in kv.B_RINGS:
        calls.append((f"b{s}{q}", lambda A, X, s=s, q=q: kv.spmm_b(A, X, s, q, tile=tile, rows=rows),
                      kv.spmm_b))
    calls.append(("d", lambda A, X: kv.spmm_d(A, X, tile=tile, rows=rows), kv.spmm_d))
    calls.append(("d_alias", lambda A, X: kv.spmm_d(A, X, alias=True, tile=tile, rows=rows),
                  kv.spmm_d))
    return calls


@pytest.mark.parametrize("N,m,tile,rows", [(32, 8, 256, 8), (45, 8, 256, 2), (46, 8, 256, 4),
                                           (37, 5, 64, 2), (64, 8, 4096, 2), (100, 16, 128, 1)])
def test_variants_match_plain(cuda, N, m, tile, rows):
    """C, B at its three rings, D and D in place against the plain DIA
    product on the 2D Laplacian with random diagonals kept: the same f32
    sum FMA-contracted, 1e-5 of max|R|. n = 2025 is odd (4-byte copies),
    2116 and 1369 are no multiples of the tile, (64, 4096) is one tile that
    holds the whole operand, (100, 128) has many chunks."""
    from dune_eigensolver_tpu_torch.experiments import kernel_variants as kv

    A = problems.laplacian_dirichlet_2d(N, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(1)
    n = N * N
    data = A.data * torch.from_numpy(rng.uniform(0.5, 1.5, (5, n)).astype(np.float32)).to(cuda)
    A = DIAMatrix(data=data, offsets=A.offsets, shape=A.shape)
    X = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(cuda)
    R = kd.dia_spmm_t_reference(A, X)
    tol = 1e-5 * R.abs().max().item()
    for name, fn, wrapper in _variant_calls(kv, tile, rows):
        before = wrapper.launches
        Xin = X.clone()
        Y = fn(A, Xin)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, name
        assert (Y.data_ptr() == Xin.data_ptr()) == (name == "d_alias"), name
        assert (Y - R).abs().max().item() <= tol, name


def test_variant_d_in_place_two_chain(cuda):
    """The in-place form fed its own output (the reference's 2-chain
    check), with chunks of one and of several tiles."""
    from dune_eigensolver_tpu_torch.experiments import kernel_variants as kv

    for N, tile in ((96, 128), (300, 512)):
        A = problems.laplacian_dirichlet_2d(N, dtype=torch.float32, device=cuda)
        A = DIAMatrix(data=A.data / 8.0, offsets=A.offsets, shape=A.shape)
        X = torch.randn((8, N * N), generator=torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
        R2 = kd.dia_spmm_t_reference(A, kd.dia_spmm_t_reference(A, X))
        Y = kv.spmm_d(A, kv.spmm_d(A, X.clone(), alias=True, tile=tile), alias=True, tile=tile)
        assert (Y - R2).abs().max().item() <= 1e-5 * R2.abs().max().item()


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
    with pytest.raises(TypeError, match="float32"):
        kv.spmm_c(A, X.double())
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
