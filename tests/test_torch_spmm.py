"""DIA SpMM of the PyTorch port against the JAX package.

The port's plain version ``dia_spmm_t_reference`` is held against the JAX
package's XLA formulation ``dia_spmm_t_xla`` and its Pallas kernel in
interpret mode, on the same seeded inputs carried across as numpy arrays.
The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_eigensolver_tpu.kernels.dia_spmm import dia_spmm_t_pallas, dia_spmm_t_xla
from dune_eigensolver_tpu.sparse.formats import DIAMatrix as JDIA
from dune_eigensolver_tpu_torch.kernels import dia_spmm as kd
from dune_eigensolver_tpu_torch.sparse import DIAMatrix, dia_from_numpy, spmm_t

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, n, offsets): 2D 5-point and 3D 7-point patterns; 7^3 = 343 is not
# a multiple of the TPU tile (128) nor of the CUDA block (256)
PATTERNS = {
    "2d16": (256, (-16, -1, 0, 1, 16)),
    "3d7": (343, (-49, -7, -1, 0, 1, 7, 49)),
    "3d8": (512, (-64, -8, -1, 0, 1, 8, 64)),
}


def _operands(pattern, m, dtype, seed=0):
    """Random diagonals and X on a stencil pattern, as numpy arrays."""
    n, offsets = PATTERNS[pattern]
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n)).astype(dtype)
    Xt = rng.standard_normal((m, n)).astype(dtype)
    return data, offsets, n, Xt


def _jax_op(data, offsets, n):
    return JDIA(data=jnp.asarray(data), offsets=offsets, shape=(n, n))


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("m", [8, 24, 72])
@pytest.mark.parametrize(
    "dtype,rtol",
    # f64: same sum in the same order, so only roundoff of the last bits;
    # f32: one f32 rounding per term, relative to the row's magnitude
    [(np.float64, 1e-12), (np.float32, 1e-5)],
)
def test_reference_matches_xla(pattern, m, dtype, rtol):
    data, offsets, n, Xt = _operands(pattern, m, dtype)
    Yj = np.asarray(dia_spmm_t_xla(_jax_op(data, offsets, n), jnp.asarray(Xt)))
    A = dia_from_numpy(data, offsets, (n, n), device="cpu")
    Yt = kd.dia_spmm_t_reference(A, torch.from_numpy(Xt)).numpy()
    assert Yt.dtype == dtype
    np.testing.assert_allclose(Yt, Yj, rtol=rtol, atol=rtol * np.abs(Yj).max())


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("m", [8, 24, 72])
def test_reference_bf16_matches_pallas_interpret(pattern, m):
    """bf16 storage with f32 accumulation, as the Pallas kernel does (the
    XLA formulation would accumulate in bf16, so it is not the reference
    here). Both sum the same f32 products and round once to bf16, so they
    may differ by one bf16 ulp where the f32 sums straddle a rounding
    boundary: 2^-7 relative, held at 2e-2 of the output's magnitude."""
    data, offsets, n, Xt = _operands(pattern, m, np.float32)
    dj = jnp.asarray(data, jnp.bfloat16)
    Yj = dia_spmm_t_pallas(
        JDIA(data=dj, offsets=offsets, shape=(n, n)),
        jnp.asarray(Xt, jnp.bfloat16),
        interpret=True,
    )
    Yj = np.asarray(Yj.astype(jnp.float32))
    A = DIAMatrix(
        data=torch.from_numpy(data).to(torch.bfloat16), offsets=offsets,
        shape=(n, n),
    )
    Yt = kd.dia_spmm_t_reference(A, torch.from_numpy(Xt).to(torch.bfloat16))
    assert Yt.dtype == torch.bfloat16
    err = np.abs(Yt.float().numpy() - Yj).max()
    assert err <= 2e-2 * np.abs(Yj).max(), err


def test_spmm_t_dispatch_on_cpu():
    data, offsets, n, Xt = _operands("3d7", 8, np.float64)
    A = dia_from_numpy(data, offsets, (n, n), device="cpu")
    X = torch.from_numpy(Xt)
    before = kd.dia_spmm_t_cuda.launches
    torch.testing.assert_close(spmm_t(A, X), kd.dia_spmm_t_reference(A, X))
    assert kd.dia_spmm_t_cuda.launches == before  # the CPU path never counts
    with pytest.raises(TypeError, match="unsupported operand"):
        spmm_t(A.to_scipy(), X)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper checks its operands before it loads anything, and
    never falls back to the plain version."""
    data, offsets, n, Xt = _operands("2d16", 8, np.float32)
    A = dia_from_numpy(data, offsets, (n, n), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kd.dia_spmm_t_cuda(A, torch.from_numpy(Xt))


def test_dia_from_numpy_and_scipy_roundtrip():
    from dune_eigensolver_tpu_torch.sparse import dia_from_scipy

    data, offsets, n, Xt = _operands("3d7", 4, np.float64)
    A = dia_from_numpy(data, offsets, (n, n), device="cpu")
    S = A.to_scipy()
    X = torch.from_numpy(Xt)
    # entries past the matrix edge are dropped by scipy and masked by spmm_t
    expect = (S @ Xt.T).T
    np.testing.assert_allclose(spmm_t(A, X).numpy(), expect, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(spmm_t(dia_from_scipy(S, device="cpu"), X).numpy(), expect,
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="offsets"):
        dia_from_numpy(data[:3], offsets, (n, n), device="cpu")


def test_port_imports_no_jax():
    """The port never imports jax, directly or through the JAX package."""
    code = (
        "import sys, dune_eigensolver_tpu_torch, "
        "dune_eigensolver_tpu_torch.solvers.nested, "
        "dune_eigensolver_tpu_torch.solvers.generalized, "
        "dune_eigensolver_tpu_torch.factorize.cg, "
        "dune_eigensolver_tpu_torch.kernels.dia_spmm, "
        "dune_eigensolver_tpu_torch.kernels.gather_spmm, "
        "dune_eigensolver_tpu_torch.sparse.problems, "
        "dune_eigensolver_tpu_torch.sparse.reorder, "
        "dune_eigensolver_tpu_torch.oracle.scipy_oracle, "
        "dune_eigensolver_tpu_torch.utils.native, "
        "dune_eigensolver_tpu_torch.utils.device, "
        "dune_eigensolver_tpu_torch.utils.printers, "
        "dune_eigensolver_tpu_torch.cli, "
        "dune_eigensolver_tpu_torch.config, "
        "dune_eigensolver_tpu_torch.bench.models, "
        "dune_eigensolver_tpu_torch.bench.timing, "
        "dune_eigensolver_tpu_torch.experiments.pipeline_probe, "
        "dune_eigensolver_tpu_torch.experiments.kernel_variants; "
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.') "
        "or k.startswith('dune_eigensolver_tpu.') or k == 'dune_eigensolver_tpu']; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)
