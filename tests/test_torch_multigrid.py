"""Geometric multigrid of the PyTorch port against the JAX package: grid
detection, grid transfers, coarse operators and one V-cycle apply."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_eigensolver_tpu.factorize import multigrid as jmg
from dune_eigensolver_tpu.solvers import nested as jnested
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu_torch.factorize import multigrid as tmg
from dune_eigensolver_tpu_torch.solvers import nested as tnested
from dune_eigensolver_tpu_torch.sparse import dia_from_numpy, problems as tproblems

torch.set_num_threads(2)


def _port(Aj):
    return dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape)


@pytest.mark.parametrize(
    "offsets,n",
    [
        ((-16, -1, 0, 1, 16), 256),  # 2D 16x16
        ((-64, -8, -1, 0, 1, 8, 64), 512),  # 3D 8^3
        ((-40, -8, -1, 0, 1, 8, 40), 200),  # 3D 5x5x8
        ((-2, -1, 0, 1, 2), 64),  # (32, 2): too thin, rejected
        ((-16, -1, 0, 1), 256),  # not symmetric
        ((-1, 1), 10),  # no main diagonal
        ((-7, 0, 7), 49),  # no +-1 coupling
    ],
)
def test_detect_grid_dims_matches_jax(offsets, n):
    assert tmg.detect_grid_dims(offsets, n) == jmg.detect_grid_dims(offsets, n)


@pytest.mark.parametrize("dims", [(8, 8), (9, 7), (6, 7, 8), (5, 5, 5)])
def test_restrict_and_prolong_match_jax(dims):
    x = np.random.default_rng(4).standard_normal((3,) + dims)
    rj = np.asarray(jmg._restrict(jnp.asarray(x)))
    rt = tmg._restrict(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=1e-14, atol=1e-14)
    pj = np.asarray(jmg._prolong(jnp.asarray(rj), dims))
    pt = tmg._prolong(torch.from_numpy(rt), dims).numpy()
    assert pt.shape == (3,) + dims
    np.testing.assert_allclose(pt, pj, rtol=1e-14, atol=1e-14)
    # prolong_vectors is the same transfer on an (n_coarse, m) block
    Y = rt.reshape(3, -1).T.copy()
    np.testing.assert_allclose(
        tnested.prolong_vectors(torch.from_numpy(Y), rt.shape[1:], dims).numpy(),
        np.asarray(jnested.prolong_vectors(jnp.asarray(Y), rt.shape[1:], dims)),
        rtol=1e-14, atol=1e-14,
    )


@pytest.mark.parametrize("dims", [(8, 8, 8), (6, 6, 6), (8, 8)])
def test_coarse_operator_matches_jax_exactly(dims):
    """Same-coefficient rediscretization: sampled coefficients and Dirichlet
    masking are exact arithmetic, so the diagonals agree bit for bit."""
    if len(dims) == 3:
        Aj = jproblems.laplacian_dirichlet_3d(16, dtype=np.float64)
    else:
        Aj = jproblems.laplacian_dirichlet_2d(16, dtype=np.float64)
    Aj = Aj.with_shifted_diagonal(0.25)  # a nonzero zeroth-order term
    Cj = jnested._coarse_operator(Aj, dims)
    Ct = tnested._coarse_operator(_port(Aj), dims)
    assert Ct.offsets == Cj.offsets and Ct.shape == Cj.shape
    np.testing.assert_array_equal(Ct.data.numpy(), np.asarray(Cj.data))


def test_port_problem_builders_match_jax():
    for N in (5, 8):
        Aj = jproblems.laplacian_dirichlet_3d(N, dtype=np.float64)
        At = tproblems.laplacian_dirichlet_3d(N, dtype=torch.float64)
        assert At.offsets == Aj.offsets
        np.testing.assert_array_equal(At.data.numpy(), np.asarray(Aj.data))
    Aj = jproblems.laplacian_dirichlet_2d(9, dtype=np.float64)
    At = tproblems.laplacian_dirichlet_2d(9, dtype=torch.float64)
    assert At.offsets == Aj.offsets
    np.testing.assert_array_equal(At.data.numpy(), np.asarray(Aj.data))


def _mg_apply_pair(N, m, dtype_j, dtype_t, seed=5, **kw):
    Aj = jproblems.laplacian_dirichlet_3d(N, dtype=np.float64)
    Aj = Aj.with_shifted_diagonal(0.1)
    R = np.random.default_rng(seed).standard_normal((m, Aj.shape[0]))
    aux_j, fn_j = jmg.mg_inverse_factory(nu1=1, nu2=1, dtype=dtype_j, **kw)(Aj)
    Yj = np.asarray(fn_j(aux_j, jnp.asarray(R)))
    aux_t, fn_t = tmg.mg_inverse_factory(nu1=1, nu2=1, dtype=dtype_t, **kw)(_port(Aj))
    Yt = fn_t(aux_t, torch.from_numpy(R)).numpy()
    return R, Yj, Yt


@pytest.mark.parametrize("N", [12, 13])
def test_mg_inverse_apply_f64_matches_jax(N):
    """One V(1,1) cycle with f64 smoothing. The coarsest level is a fixed
    48-iteration CG in f32 in both packages, and the two sum its dots in
    different orders, so the output carries f32 roundoff of the coarse
    correction: held at 1e-5 of the output's magnitude."""
    _, Yj, Yt = _mg_apply_pair(N, 8, None, None)
    assert Yt.dtype == np.float64
    assert np.abs(Yt - Yj).max() <= 1e-5 * np.abs(Yj).max()


def test_mg_single_level_f64_matches_jax_tightly():
    """With no coarse level (min_coarse above the grid) the cycle is f64
    Jacobi smoothing alone: the same operations in the same order, so only
    the last bits differ."""
    _, Yj, Yt = _mg_apply_pair(12, 8, None, None, min_coarse=100)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-12, atol=1e-12 * np.abs(Yj).max())


def test_mg_inverse_apply_bf16_matches_jax_loosely():
    """One V(1,1) cycle with bf16 fine smoothing. The port's fine residual
    accumulates in f32 (as the Pallas kernel does) where the JAX package's
    XLA formulation on the CPU accumulates in bf16, and the two frameworks
    round bf16 intermediates at different places: both are bf16-grade
    approximations of the same f64 cycle (relative error ~2^-8 per op),
    held here at 5% of the output's norm against each other and against
    the f64 cycle."""
    R, Yj, Yt = _mg_apply_pair(12, 8, jnp.bfloat16, torch.bfloat16)
    _, Y64, _ = _mg_apply_pair(12, 8, None, None)
    assert Yt.dtype == np.float64  # output in the caller's dtype
    scale = np.linalg.norm(Y64)
    assert np.linalg.norm(Yt - Yj) <= 5e-2 * scale
    assert np.linalg.norm(Yt - Y64) <= 5e-2 * scale
    assert np.linalg.norm(Yj - Y64) <= 5e-2 * scale


def test_mg_inverse_rejects_unstructured_operands():
    n = 64
    A = dia_from_numpy(np.full((1, n), 2.0), (0,), (n, n))
    with pytest.raises(ValueError, match="structured"):
        tmg.mg_inverse_factory()(A)
