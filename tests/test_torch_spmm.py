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


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("m", [1, 3, 9])
def test_reference_matches_xla_at_remainder_rows(pattern, m):
    """The row counts that leave a remainder in the CUDA kernel's unrolled
    row loop (m = 1, m odd), f32: one f32 rounding per term, 1e-5 of the
    output's magnitude."""
    data, offsets, n, Xt = _operands(pattern, m, np.float32, seed=m)
    Yj = np.asarray(dia_spmm_t_xla(_jax_op(data, offsets, n), jnp.asarray(Xt)))
    A = dia_from_numpy(data, offsets, (n, n), device="cpu")
    Yt = kd.dia_spmm_t_reference(A, torch.from_numpy(Xt)).numpy()
    assert Yt.shape == (m, n)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-5, atol=1e-5 * np.abs(Yj).max())


def _stencil(N, dim):
    return tuple(sorted({s * N**p for p in range(dim) for s in (-1, 1)} | {0}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "N,dim,width",
    # 216, 128, 108, 2048: N a multiple of 4; 54: N = 2 mod 4; 37: n odd
    [(216, 3, 4), (128, 3, 4), (108, 3, 4), (54, 3, 2), (37, 3, 1), (2048, 2, 4), (54, 2, 2),
     (37, 2, 1)],
)
def test_vector_width_of_the_stencils(N, dim, width, dtype):
    """The specialisation of the CUDA kernel each grid of the solves takes."""
    assert kd.dia_vector_width(_stencil(N, dim), N**dim, dtype) == width


@pytest.mark.parametrize(
    "offsets,n,expect",
    [
        ((-30, -1, 0, 1, 30), 1002, 2),  # n = 2 mod 4 caps the width
        ((-30, -1, 0, 1, 30), 1000, 2),  # 30 = 2 mod 4
        ((-32, -1, 0, 1, 32), 1000, 4),
        ((-32, -1, 0, 1, 32), 1001, 1),  # n odd: rows of X start off a vector boundary
        ((-33, -1, 0, 1, 33), 1000, 1),  # an odd far offset fits no vector
        ((-64, -8, -1, 0, 1, 8, 64), 1024, 4),
        ((-64, -6, -1, 0, 1, 6, 64), 1024, 2),
        ((-1, 0, 1), 1000, 1),  # the 1D stencil: no vector kernel built for three
        ((0,), 1000, 1),  # a diagonal mass matrix
        ((-3, -2, -1, 0, 1, 2, 3), 1000, 1),  # adjacent diagonals beyond +-1
        ((-12, -8, -4, 0, 4, 8, 12), 1000, 1),  # multiples of 4 without the +-1 neighbours
        ((-8, 0, 1, 2, 8), 1000, 1),  # +1 without -1: not a stencil the kernel knows
        ((-64, -8, -1, 0, 1, 8, 64, 128, 256), 1024, 1),  # nine diagonals
        ((-4, -1, 0, 1, 4), 4, 4),
        ((-4, -1, 0, 1, 4), 2, 2),
        ((-4, -1, 0, 1, 4), 1, 1),
    ],
)
def test_vector_width_of_invented_offsets(offsets, n, expect):
    assert kd.dia_vector_width(offsets, n, torch.float32) == expect
    assert kd.dia_vector_width(offsets, n, torch.bfloat16) == expect


def test_vector_width_follows_the_operands_alignment():
    """A width needs every operand's address on a vector boundary: 16 bytes
    for four f32, 8 for four bf16 or two f32, 4 for two bf16."""
    offsets = _stencil(216, 3)
    for dtype, by_align in ((torch.float32, {16: 4, 8: 2, 4: 1}),
                            (torch.bfloat16, {16: 4, 8: 4, 4: 2, 2: 1})):
        for align, width in by_align.items():
            assert kd.dia_vector_width(offsets, 216**3, dtype, align=align) == width


@pytest.mark.parametrize("N,dim", [(216, 3), (128, 3), (108, 3), (54, 3), (37, 3), (2048, 2)])
def test_vector_width_is_one_for_float64(N, dim):
    """float64 (8-byte items) takes one column a thread at every shape and
    alignment: the kernel has no vector body for them, and a 16-byte
    aligned operand would otherwise qualify for width 2."""
    for align in (16, 8):
        assert kd.dia_vector_width(_stencil(N, dim), N**dim, torch.float64, align=align) == 1
    assert kd.dia_vector_width((-64, -8, -1, 0, 1, 8, 64), 1024, torch.float64) == 1


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
        "dune_eigensolver_tpu_torch.experiments.kernel_variants, "
        "dune_eigensolver_tpu_torch.experiments.gather_ablate, "
        "dune_eigensolver_tpu_torch.experiments.gather_probe, "
        "dune_eigensolver_tpu_torch.solvers.standard, "
        "dune_eigensolver_tpu_torch.factorize.chebyshev, "
        "dune_eigensolver_tpu_torch.factorize.multigrid; "
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.') "
        "or k.startswith('dune_eigensolver_tpu.') or k == 'dune_eigensolver_tpu' "
        "or k == 'experiments' or k.startswith('experiments.')]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)
