"""The distributed layer's general-sparsity half (``dist/windowed.py``)
against the JAX package's, on the CPU.

The port runs on 4 gloo ranks that one module-scoped ``RankPool`` spawns;
K2's plain version computes each rank's product here.

* ``windowed_spmm_halo_t``, overlapped and serialized, assembled over
  P = 1, 2, 3, 4 ranks against the global ELL product of an RCM-ordered
  operand (1e-12 of max|A| max|X| k in f64: the boundary terms are summed
  apart from the interior ones); P = 3 leaves padded rows.
* The plan: autopadding of a row count P does not divide (a prime n), the
  bandwidth guard, the boundary blocks and the local band.
* The three general drivers against JAX's at P = 2 from the same start
  block (JAX ``random_multivector_t(PRNGKey(seed))`` over the logical rows,
  the block JAX's ``_q0_general`` draws). JAX runs its windowed gather
  kernel in interpret mode (``tile=128``, as tests/test_dist_windowed.py
  does). f64: the same iteration count, eigenvalues to 1e-10 relative,
  subspace angle <= 1e-8.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from dune_eigensolver_tpu import dist as jdist
from dune_eigensolver_tpu.solvers.standard import random_multivector_t as jrandom_t
from dune_eigensolver_tpu.sparse import problems as jproblems

import test_torch_dist_cases as cases
from dune_eigensolver_tpu_torch.dist import windowed
from dune_eigensolver_tpu_torch.sparse import ell_from_scipy, spmm_t

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with cases.pool(4, tmp_path_factory.mktemp("ranks")) as pool:
        yield pool


def _random_sym_csr(n, avg_nnz, seed, bw=40, dtype=np.float64):
    """A banded symmetric diagonally dominant SPD operator with an irregular
    pattern inside the band: a general operator after an RCM ordering (the
    JAX tests' ``_random_sym_csr``)."""
    g = np.random.default_rng(seed)
    nnz = avg_nnz * n // 2
    r = g.integers(0, n, nnz)
    c = np.clip(r + g.integers(-bw, bw + 1, nnz), 0, n - 1)
    v = -np.abs(g.normal(size=nnz))
    i = np.arange(n - 1)
    r, c = np.concatenate([r, i]), np.concatenate([c, i + 1])
    v = np.concatenate([v, -np.ones(n - 1)])
    S = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    S = S + S.T
    S = S - sp.diags(S.diagonal())
    S = S + sp.diags(np.asarray(-S.sum(axis=1)).ravel() + 0.5)
    return sp.csr_matrix(S).astype(dtype)


def _rcm_elasticity(N):
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    A, _ = jproblems.elasticity_2d(N, dtype=np.float64)
    S = sp.csr_matrix(A.to_scipy())
    p = np.asarray(reverse_cuthill_mckee(S, symmetric_mode=True))
    return sp.csr_matrix(S[p][:, p])


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("operand", ["elasticity", "random"])
def test_windowed_spmm_matches_global(ranks, P, overlap, operand):
    S = _rcm_elasticity(16) if operand == "elasticity" else _random_sym_csr(1001, 6, 3)
    n = S.shape[0]
    Xt = np.random.default_rng(P).standard_normal((5, n))
    out = ranks.run(cases.windowed_product, P, S, Xt, overlap)
    E = ell_from_scipy(S, device="cpu")
    ref = spmm_t(E, torch.from_numpy(Xt)).numpy()
    assert out["Y"].shape == ref.shape
    scale = np.abs(S.data).max() * np.abs(Xt).max() * E.k
    assert np.abs(out["Y"] - ref).max() <= 1e-12 * scale
    assert out["n"] == -(-n // P) * P and out["halo"] <= out["nloc"]


def test_shard_plan_pads_validates_and_splits():
    S = _random_sym_csr(1009, 6, 6)  # a prime row count
    plans = [windowed.windowed_shard_plan(S, 4, r, "cpu", local_band=True) for r in range(4)]
    assert {(p.n, p.rows, p.nloc) for p in plans} == {(1012, 1009, 253)}
    halo = plans[0].halo
    assert all(p.halo == halo and p.ell.shape == (253, 253 + 2 * halo) for p in plans)
    # the pad rows are decoupled identity rows of the last rank
    last = plans[-1]
    assert np.allclose(last.diag.numpy()[-3:], 1.0)
    # every rank's band block is its diagonal block of the operator
    for r, p in enumerate(plans[:-1]):
        blk = S[r * 253:(r + 1) * 253, r * 253:(r + 1) * 253].toarray()
        assert np.allclose(p.band.to_scipy().toarray(), blk, rtol=0, atol=0)
        assert np.allclose(p.diag.numpy(), np.diag(blk))
    # the boundary blocks hold the couplings into the neighbours' halos
    p1 = plans[1]
    left = S[253:253 + halo, 253 - halo:253].toarray()
    assert np.array_equal(p1.bnd_left.numpy(), left)
    # diag_fill=0 (a mass matrix) leaves the pad rows empty
    pb = windowed.windowed_shard_plan(S, 4, 3, "cpu", diag_fill=0.0)
    assert np.allclose(pb.diag.numpy()[-3:], 0.0)
    # a bandwidth past the local rows raises
    i = np.arange(1024)
    Sw = sp.coo_matrix((np.ones(2048), (np.concatenate([i, i]),
                                        np.concatenate([i, np.clip(i + 700, 0, 1023)]))),
                       shape=(1024, 1024)).tocsr()
    with pytest.raises(ValueError, match="bandwidth"):
        windowed.windowed_shard_plan(Sw, 4, 0, "cpu")
    with pytest.raises(ValueError, match="rank"):
        windowed.windowed_shard_plan(S, 4, 4, "cpu")


def _max_subspace_sine(U, V):
    Qu, _ = np.linalg.qr(U)
    Qv, _ = np.linalg.qr(V)
    return float(np.linalg.norm(Qv - Qu @ (Qu.T @ Qv), 2))


def _q0(n, m, seed=123):
    return np.asarray(jrandom_t(jax.random.PRNGKey(seed), n, m, jnp.float64)).T.copy()


def _geneo(N):
    A = jproblems.laplacian_neumann_2d(N, dtype=np.float64)
    B = jproblems.laplacian_b_2d(N, 3, dtype=np.float64)
    return sp.csr_matrix(A.to_scipy()), sp.csr_matrix(B.to_scipy())


GENERAL = [
    ("sharded_standard_largest_general", dict(nev=4, tol=1e-6, maxiter=400)),
    ("sharded_generalized_inverse_general",
     dict(nev=4, tol=1e-8, maxiter=100, shift=1e-3, inner="schwarz", cg_rtol=1e-10)),
    ("sharded_lobpcg_general", dict(nev=4, tol=1e-8, maxiter=100, shift=1e-3, cg_rtol=1e-3,
                                    cg_maxiter=20)),
]


@pytest.mark.parametrize("name,kw", GENERAL)
def test_general_drivers_match_jax(ranks, name, kw):
    P = 2
    if name == "sharded_standard_largest_general":
        A, B = _random_sym_csr(1001, 6, 4), None
    elif name == "sharded_lobpcg_general":
        A, B = _random_sym_csr(1000, 6, 5), None
    else:
        A, B = _geneo(16)
    n = A.shape[0]
    rj = getattr(jdist, name)(*((A,) if B is None else (A, B)), mesh=jdist.make_mesh(P),
                              seed=123, tile=128, **kw)
    rt = ranks.run(cases.general_driver, P, name, A, B, _q0(n, 8), kw)
    ej = np.asarray(rj.eigenvalues)
    assert rt["V"].shape == (n, 4)
    assert rt["iterations"] == int(rj.iterations)
    assert rt["converged"] == bool(rj.converged)
    assert np.abs(rt["ev"] - ej).max() <= 1e-10 * np.abs(ej).max()
    assert _max_subspace_sine(np.asarray(rj.eigenvectors), rt["V"]) <= 1e-8
