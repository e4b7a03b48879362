"""The port's CUDA kernel on the card, against its plain PyTorch version.

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
