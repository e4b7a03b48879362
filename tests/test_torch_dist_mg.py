"""The sharded geometric-multigrid V-cycle (``dist/mg.py``) against the JAX
package's, on the CPU.

The port runs on 4 gloo ranks that one module-scoped ``RankPool`` spawns;
the JAX package runs ``make_sharded_mg_prec_fn`` under ``shard_map`` on its
CPU mesh with ``make_mesh(P)`` ('xla' engine). One V(1,1) cycle with f64
smoothing on the same block, in 3D and 2D, at P = 2 and 4: the coarsest
level is a fixed 48-iteration CG in f32 in both packages, and the two sum
its dots in different orders, so the outputs agree to f32 roundoff of the
coarse correction, 1e-5 of max|Y| (as tests/test_torch_multigrid.py holds
the single-card cycles). Within the port every other operation is the
same: the P-way cycle is the single-card ``mg_inverse_factory(nu1=1,
nu2=1)`` cycle (restriction over y, x before z, then the one gather) to
1e-12 of max|X| at P = 1, 2, 4. The
sharded LOBPCG with ``precond='mg'`` on the 3D Laplacian meets the analytic
spectrum, bf16 smoothing too; bad geometry raises ``ValueError``
(tests/test_dist_mg.py:70).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

from dune_eigensolver_tpu.dist import make_mesh as jmake_mesh
from dune_eigensolver_tpu.dist.mg import make_sharded_mg_prec_fn as jmg_prec
from dune_eigensolver_tpu.dist.mg import sharded_mg_geometry as jgeometry
from dune_eigensolver_tpu.dist.sharded import _ShardEngine as JEngine
from dune_eigensolver_tpu.sparse import problems as jproblems

import test_torch_dist_cases as cases
from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory
from dune_eigensolver_tpu_torch.oracle import (
    eigenvalues_laplace_dirichlet_2d,
    eigenvalues_laplace_dirichlet_3d,
)
from dune_eigensolver_tpu_torch.sparse import dia_from_numpy

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with cases.pool(4, tmp_path_factory.mktemp("ranks")) as pool:
        yield pool


def _spec(A):
    return (np.asarray(A.data), tuple(A.offsets), tuple(A.shape))


def _jax_cycle(A, Xt, P):
    mesh = jmake_mesh(P)
    n = A.shape[0]
    dims = jgeometry(A.offsets, n, n, P)

    def local(adata, x):
        eng = JEngine([adata], [A.offsets], x.shape[0], "rows", "xla")
        return jmg_prec(eng, dims, P, "rows")(None, x)

    f = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(JP(None, "rows"), JP(None, "rows")),
                              out_specs=JP(None, "rows"), check_vma=False))
    Ad = jax.device_put(jnp.asarray(A.data), NamedSharding(mesh, JP(None, "rows")))
    Xs = jax.device_put(jnp.asarray(Xt), NamedSharding(mesh, JP(None, "rows")))
    return np.asarray(f(Ad, Xs))


@pytest.mark.parametrize("dim,N,P", [(3, 16, 2), (3, 16, 4), (2, 32, 4)])
def test_one_vcycle_matches_jax(ranks, dim, N, P):
    build = jproblems.laplacian_dirichlet_3d if dim == 3 else jproblems.laplacian_dirichlet_2d
    A = build(N, dtype=np.float64).with_shifted_diagonal(1e-3)
    Xt = np.random.default_rng(dim * N + P).standard_normal((8, A.shape[0]))
    ref = _jax_cycle(A, Xt, P)
    out = ranks.run(cases.mg_cycle, P, _spec(A), Xt)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("P", [1, 2, 4])
def test_sharded_cycle_is_the_single_card_cycle(ranks, P):
    A = jproblems.laplacian_dirichlet_3d(16, dtype=np.float64).with_shifted_diagonal(1e-3)
    Xt = np.random.default_rng(1).standard_normal((8, A.shape[0]))
    out = ranks.run(cases.mg_cycle, P, _spec(A), Xt)
    At = dia_from_numpy(np.asarray(A.data), A.offsets, A.shape, device="cpu")
    aux, fn = mg_inverse_factory(nu1=1, nu2=1)(At)
    ref = fn(aux, torch.from_numpy(Xt)).numpy()
    assert np.abs(out - ref).max() <= 1e-12 * np.abs(Xt).max()


@pytest.mark.parametrize("dim,N,P,prec_dtype", [(3, 16, 4, None), (2, 32, 4, "bfloat16")])
def test_sharded_mg_lobpcg_matches_analytic(ranks, dim, N, P, prec_dtype):
    build = jproblems.laplacian_dirichlet_3d if dim == 3 else jproblems.laplacian_dirichlet_2d
    A = build(N, dtype=np.float32)
    B = jproblems.identity_on_pattern(A)
    n = A.shape[0]
    q0 = np.random.default_rng(3).standard_normal((n, 8)).astype(np.float32)
    kw = dict(nev=4, tol=1e-5, maxiter=200, shift=1e-3, precond="mg", ortho_block=8)
    if prec_dtype:
        kw["prec_dtype"] = getattr(torch, prec_dtype)
    res = ranks.run(cases.dia_driver, P, "sharded_lobpcg_generalized", _spec(A), _spec(B), q0,
                    kw)
    exact = (eigenvalues_laplace_dirichlet_3d(N, count=4) if dim == 3
             else eigenvalues_laplace_dirichlet_2d(N)[:4])
    assert res["converged"]
    assert np.abs(np.sort(res["ev"]) - exact).max() < 2e-3
    assert res["V"].shape == (n, 4) and np.isfinite(res["V"]).all()


def test_sharded_mg_rejects_bad_geometry(ranks):
    # a row count 3 ranks do not divide (pad rows), 2 planes a rank, no grid
    msg = ranks.run(cases.mg_geometry_error, 3, (-16, -1, 0, 1, 16), 256, 258)
    assert msg is not None and "pad" in msg
    msg = ranks.run(cases.mg_geometry_error, 4, (-8, -1, 0, 1, 8), 64, 64)
    assert msg is not None and "planes" in msg
    msg = ranks.run(cases.mg_geometry_error, 2, (-7, 0, 7), 49, 49)
    assert msg is not None and "not a structured" in msg
    # and through the driver, before any collective: 12 planes over 4 ranks
    A = jproblems.laplacian_neumann_2d(12, dtype=np.float32)
    B = jproblems.laplacian_b_2d(12, 3, dtype=np.float32)
    q0 = np.zeros((144, 8), np.float32)
    with pytest.raises(RuntimeError, match="planes"):
        ranks.run(cases.dia_driver, 4, "sharded_lobpcg_generalized", _spec(A), _spec(B), q0,
                  dict(nev=4, tol=1e-4, maxiter=5, shift=1e-3, precond="mg"))
