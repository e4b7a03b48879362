"""The distributed layer's DIA half against the JAX package's, on the CPU.

The port runs on gloo ranks that one module-scoped ``RankPool`` spawns
(8 processes, one thread each, on a ``FileStore`` in a temporary
directory); the JAX package runs the same inputs on its 8-device CPU mesh
with ``make_mesh(P)``, in its 'xla' slice formulation. The port's K1 route
('padded') runs K1's plain version here.

* Halo SpMM: the slice formulation, the K1 route and ``halo_exchange_t``
  against JAX ``dia_spmm_halo_t``/``halo_exchange_t`` at P = 2, 3, 8 in
  f64 (1e-12 of max|A| max|X| ndiag: only the order of the edge terms
  differs), a diagonal-only operand (halo 0), the bandwidth guard.
* The four DIA drivers against JAX's at the same P and the same start block
  (JAX ``random_multivector_t(PRNGKey(seed))``, the block JAX's own
  ``_random_q0_t`` draws): f64, the same iteration count, eigenvalues to
  1e-10 relative, subspace angle <= 1e-8; P = 3 leaves padded rows;
  ``inner='schwarz'`` and ``'cg'``; ``spmm='padded'`` against ``'xla'``.
* The hooks: each core with the gloo ``gram_reduce`` at P = 2 against the
  same core at P = 1 (no reduction): 1e-12 for one orthonormalization or
  solve, the drivers' 1e-10 and 1e-8 for the iterated eigensolvers (the
  reduction order is the only difference); with the hooks off every
  single-card solver gives the bits (``torch.equal``) of the core driven
  with an identity reduce.
* ``make_mesh`` past the world raises; ``dryrun_multichip(2)``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

from dune_eigensolver_tpu import dist as jdist
from dune_eigensolver_tpu.solvers.standard import random_multivector_t as jrandom_t
from dune_eigensolver_tpu.sparse import problems as jproblems

import test_torch_dist_cases as cases
from dune_eigensolver_tpu_torch.dist import dryrun
from dune_eigensolver_tpu_torch.sparse import dia_from_numpy

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with cases.pool(8, tmp_path_factory.mktemp("ranks")) as pool:
        yield pool


def _spec(A):
    return (np.asarray(A.data), tuple(A.offsets), tuple(A.shape))


def _jax_halo(A, Xt, P, fn):
    mesh = jdist.make_mesh(P)
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(JP(None, "rows"), JP(None, "rows")),
                              out_specs=JP(None, "rows")))
    Ad = jax.device_put(jnp.asarray(A.data), NamedSharding(mesh, JP(None, "rows")))
    Xs = jax.device_put(jnp.asarray(Xt), NamedSharding(mesh, JP(None, "rows")))
    return np.asarray(f(Ad, Xs))


@pytest.mark.parametrize("P", [2, 3, 8])
@pytest.mark.parametrize("mode", ["xla", "padded"])
def test_halo_spmm_matches_jax(ranks, P, mode):
    A = jproblems.laplacian_dirichlet_2d(24, dtype=np.float64)  # n = 576, halo 24
    n = A.shape[0]
    rng = np.random.default_rng(P)
    data = rng.standard_normal(np.shape(A.data)) * (np.asarray(A.data) != 0)
    A = type(A)(data=jnp.asarray(data), offsets=A.offsets, shape=A.shape)
    Xt = rng.standard_normal((5, n))
    ref = _jax_halo(A, Xt, P, lambda ad, x: jdist.dia_spmm_halo_t(ad, A.offsets, x))
    out = ranks.run(cases.halo_product, P, data, A.offsets, Xt, mode)
    scale = np.abs(data).max() * np.abs(Xt).max() * len(A.offsets)
    assert np.abs(out - ref).max() <= 1e-12 * scale
    # and the global product
    At = dia_from_numpy(data, A.offsets, A.shape, device="cpu")
    from dune_eigensolver_tpu_torch.sparse import spmm_t

    assert np.abs(out - spmm_t(At, torch.from_numpy(Xt)).numpy()).max() <= 1e-12 * scale


@pytest.mark.parametrize("P", [2, 8])
def test_halo_exchange_matches_jax(ranks, P):
    rng = np.random.default_rng(11)
    Xt = rng.standard_normal((3, 8 * 40))
    halo = 7
    ref = _jax_halo(type("A", (), {"data": np.zeros((1, 320))})(), Xt, P,
                    lambda _a, x: jdist.halo_exchange_t(x, halo))
    out = ranks.run(cases.halo_product, P, np.zeros((2, 320)), (-halo, halo), Xt, "exchange")
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("mode", ["xla", "padded"])
def test_halo_zero_diagonal_only(ranks, mode):
    rng = np.random.default_rng(2)
    data, Xt = rng.standard_normal((1, 96)), rng.standard_normal((4, 96))
    out = ranks.run(cases.halo_product, 3, data, (0,), Xt, mode)
    assert np.allclose(out, data * Xt, rtol=0, atol=1e-15)
    ext = ranks.run(cases.halo_product, 3, data, (0,), Xt, "exchange")
    assert ext.shape == Xt.shape  # no 3 * nloc-wide block at halo 0


@pytest.mark.parametrize("mode", ["xla", "padded"])
def test_halo_bandwidth_guard(ranks, mode):
    # n = 64 over 8 ranks: nloc = 8 < bandwidth 9 (tests/test_dist.py:46)
    msg = ranks.run(cases.halo_guard, 8, 64, (-9, 0, 9), mode)
    assert msg is not None and "bandwidth 9 exceeds local rows 8" in msg


def _max_subspace_sine(U, V):
    """Sine of the largest principal angle between the column spans, as
    ||(I - Qu Qu^T) Qv||_2: exact to roundoff near 0 (sqrt(1 - cos^2)
    cannot resolve an angle below ~1.5e-8)."""
    Qu, _ = np.linalg.qr(U)
    Qv, _ = np.linalg.qr(V)
    return float(np.linalg.norm(Qv - Qu @ (Qu.T @ Qv), 2))


def _same(rj, rt, n, nev):
    ej = np.asarray(rj.eigenvalues)
    assert rt["V"].shape == (n, nev) and rt["ev"].shape == (nev,)
    assert rt["iterations"] == int(rj.iterations)
    assert rt["converged"] == bool(rj.converged)
    assert np.abs(rt["ev"] - ej).max() <= 1e-10 * np.abs(ej).max()
    assert _max_subspace_sine(np.asarray(rj.eigenvectors), rt["V"]) <= 1e-8


def _q0(n, m, seed=123):
    return np.asarray(jrandom_t(jax.random.PRNGKey(seed), n, m, jnp.float64)).T.copy()


DRIVERS = [
    # (name, problem, P, kwargs for both packages, port-only kwargs)
    ("sharded_standard_largest", "dirichlet", 2, dict(nev=4, tol=1e-6, maxiter=400), {}),
    ("sharded_standard_largest", "dirichlet", 3,
     dict(nev=4, tol=1e-6, maxiter=400, rayleigh_ritz=True), {}),
    ("sharded_standard_largest", "dirichlet", 2, dict(nev=4, tol=1e-6, maxiter=400),
     dict(spmm="padded")),
    ("sharded_standard_inverse", "dirichlet", 3,
     dict(nev=4, tol=1e-7, maxiter=100, shift=0.1, inner="schwarz", cg_rtol=1e-10), {}),
    ("sharded_standard_inverse", "dirichlet", 2,
     dict(nev=4, tol=1e-7, maxiter=100, shift=0.1, inner="cg", cg_rtol=1e-10), {}),
    ("sharded_generalized_inverse", "geneo", 2,
     dict(nev=4, tol=1e-4, maxiter=100, shift=1e-3, inner="schwarz", cg_rtol=1e-9), {}),
    ("sharded_generalized_inverse", "geneo", 3,
     dict(nev=4, tol=1e-4, maxiter=100, shift=1e-3, inner="schwarz", cg_rtol=1e-9,
          rayleigh_ritz=True), dict(spmm="padded")),
    # LOBPCG selects by Rayleigh-Ritz, whose vectors inside an exactly
    # degenerate cluster turn on roundoff: a perturbed diagonal separates
    # the clusters (as tests/test_torch_lobpcg.py does)
    ("sharded_lobpcg_generalized", "perturbed", 2,
     dict(nev=4, tol=1e-8, maxiter=100, cg_rtol=1e-3, cg_maxiter=20), {}),
]


def _problem(kind):
    if kind == "geneo":
        return (jproblems.laplacian_neumann_2d(16, dtype=np.float64),
                jproblems.laplacian_b_2d(16, 3, dtype=np.float64))
    A = jproblems.laplacian_dirichlet_2d(16, dtype=np.float64)
    if kind == "dirichlet":
        return A, None
    d = np.array(A.data)
    d[A.offsets.index(0)] += 0.3 * np.random.default_rng(8).random(A.shape[0])
    A = type(A)(data=jnp.asarray(d), offsets=A.offsets, shape=A.shape)
    return A, jproblems.identity_on_pattern(A)


@pytest.mark.parametrize("name,problem,P,kw,port_kw", DRIVERS)
def test_dia_drivers_match_jax(ranks, name, problem, P, kw, port_kw):
    A, B = _problem(problem)
    n = A.shape[0]
    m = -(-kw["nev"] // 8) * 8
    fn = getattr(jdist, name)
    rj = fn(*((A,) if B is None else (A, B)), mesh=jdist.make_mesh(P), seed=123, **kw)
    rt = ranks.run(cases.dia_driver, P, name, _spec(A), None if B is None else _spec(B),
                   _q0(n, m), {**kw, **port_kw})
    _same(rj, rt, n, kw["nev"])


# ---------------------------------------------------------------------------
# The hooks
# ---------------------------------------------------------------------------

def _core_args(which):
    A = jproblems.laplacian_dirichlet_2d(12, dtype=np.float64)  # n = 144
    args = dict(A=_spec(A))
    n = A.shape[0]
    if which in ("generalized", "lobpcg"):
        # a perturbed diagonal separates the degenerate clusters (see DRIVERS)
        d = np.array(A.data)
        d[A.offsets.index(0)] += 0.3 * np.random.default_rng(8).random(n)
        A = type(A)(data=jnp.asarray(d), offsets=A.offsets, shape=A.shape)
        args = dict(A=_spec(A), B=_spec(jproblems.identity_on_pattern(A)))
    args["q0t"] = np.random.default_rng(5).standard_normal((8, n))
    return args


def _close(a, b, tol):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], tol)
        return
    if isinstance(a, (int, np.integer)):
        assert a == b
        return
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max()), np.abs(a - b).max()


@pytest.mark.parametrize("which", ["ortho", "b_ortho", "cg", "chebyshev", "largest",
                                   "generalized", "lobpcg"])
def test_core_with_gram_reduce_matches_one_rank(ranks, which):
    args = _core_args(which)
    two = ranks.run(cases.core_hooks, 2, which, args)
    one = cases.core_single(which, args)
    if which in ("largest", "generalized", "lobpcg"):
        # an iterated solve amplifies the reduction order's roundoff: the
        # drivers' 1e-10 (module docstring)
        assert two["iterations"] == one["iterations"]
        _close(two["ev"], one["ev"], 1e-10)
        assert _max_subspace_sine(one["V"], two["V"]) <= 1e-8
    elif which == "chebyshev":
        _close(two["poly"], one["poly"], 1e-12)
        _close(two["cheb_cg"], one["cheb_cg"], 1e-8)  # two CG runs to 1e-10
    else:
        _close(two, one, 1e-12)


def test_hooks_off_leave_the_single_card_solvers_bit_for_bit():
    """Each single-card entry point gives exactly what its core gives when
    driven with an identity ``gram_reduce``: the hook adds nothing when
    off."""
    from dune_eigensolver_tpu_torch.factorize import cg as tcg
    from dune_eigensolver_tpu_torch.ops import ortho as tortho
    from dune_eigensolver_tpu_torch.solvers import (
        generalized,
        generalized_inverse,
        lobpcg,
        lobpcg_generalized,
        standard,
        standard_largest,
    )
    from dune_eigensolver_tpu_torch.sparse import problems, spmm_t

    ident = lambda g: g  # noqa: E731
    A = problems.laplacian_dirichlet_2d(12, device="cpu")
    q0 = torch.from_numpy(np.random.default_rng(5).standard_normal((144, 8)))
    Q0 = q0.T.contiguous()
    apply_a = lambda X: spmm_t(A, X)  # noqa: E731

    def same(r, s):
        for f in ("eigenvalues", "eigenvectors", "iterations", "converged", "criterion",
                  "ortho_monitor"):
            assert torch.equal(getattr(r, f), getattr(s, f)), f

    r = standard_largest(A, nev=4, tol=1e-6, maxiter=200, q0=q0)
    with torch.no_grad():
        s = standard._core(apply_a, apply_a, Q0, 4, 1e-6, 200, 0.0, 8, 1, False, True,
                           gram_reduce=ident)
    same(r, s)
    An = problems.laplacian_neumann_2d(12, device="cpu").with_shifted_diagonal(1e-2)
    B = problems.laplacian_b_2d(12, 2, device="cpu")
    fac = tcg.cg_inverse_factory(rtol=1e-8, maxiter=300)
    r = generalized_inverse(An, B, nev=4, tol=1e-6, maxiter=50, inverse=fac, q0=q0)
    (aux, fn) = fac(An)
    with torch.no_grad():
        s = generalized._gen_core(lambda X: spmm_t(An, X), lambda X: spmm_t(B, X), aux, fn,
                                  Q0, 4, 1e-6, 50, 0.0, 8, 10, 1, False, gram_reduce=ident)
    same(r, s)
    r = lobpcg_generalized(An, B, nev=4, tol=1e-6, maxiter=50, precond=fac, q0=q0)
    with torch.no_grad():
        s = lobpcg._lobpcg_core(lambda X: spmm_t(An, X), lambda X: spmm_t(B, X), aux, fn, Q0,
                                4, 1e-6, 50, 0.0, 3, 1e-9, 2, 8, gram_reduce=ident)
    same(r, s)
    X1, k1 = tcg.cg_solve_t(apply_a, Q0, rtol=1e-9, maxiter=300)
    X2, k2 = tcg.cg_solve_t(apply_a, Q0, rtol=1e-9, maxiter=300, gram_reduce=ident)
    assert k1 == k2 and torch.equal(X1, X2)
    assert torch.equal(tortho.orthonormalize_blocked_t(Q0, block=4, iterations=2),
                       tortho.orthonormalize_blocked_t(Q0, block=4, iterations=2,
                                                       gram_reduce=ident))


# ---------------------------------------------------------------------------
# Mesh, backend and the dry run
# ---------------------------------------------------------------------------

def test_make_mesh_past_the_world_raises(ranks):
    out = ranks.run(cases.mesh_checks, 8)
    assert out["msg"] is not None and "requested 9 ranks" in out["msg"]
    assert (out["size"], out["rank"], out["device"]) == (8, 0, "cpu")
    assert out["cuda_msg"] is not None and "no fallback" in out["cuda_msg"]


def test_make_mesh_needs_a_process_group():
    from dune_eigensolver_tpu_torch.dist import init_distributed, make_mesh

    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh()
    if not torch.cuda.is_available():
        # the device default is the card: without one, no group starts
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_distributed()


@pytest.mark.parametrize("argv,head", [
    (["--test", "eigenvalues", "ev.method=dist", "parallel.ndevices=2"],
     "RESULT eigenvalues_test dist N=16 m=8 "),
    (["--test", "eigenvalues", "ev.method=dist_general", "parallel.ndevices=3"],
     "RESULT eigenvalues_test dist_general N=16 m=8 "),
    (["--test", "scaling", "scaling.log2_rows_per_device=8", "scaling.n_iter=2",
      "scaling.solver_n_iter=1", "scaling.phases=0"], "SCALING "),
])
def test_cli_on_a_multi_rank_group(ranks, argv, head):
    """Under a launcher's group (the pool's 8 ranks, as torchrun gives) the
    CLI joins it instead of starting one, every rank runs, rank 0 alone
    prints: ``dist`` over a 2-rank subgroup, ``dist_general`` over a
    3-rank one (padded rows), ``scaling`` at P = 1, 2, 4, 8."""
    rc, out = ranks.run(cases.cli_run, argv + ["ev.N=16", "ev.device=cpu"])
    assert rc == 0
    lines = [ln for ln in out.splitlines() if ln.startswith(head)]
    if head == "SCALING ":
        assert [ln.split()[4] for ln in lines] == ["1", "2", "4", "8"] * 4
    else:
        assert len(lines) == 1


def test_dryrun_multichip_two_ranks():
    out = dryrun.dryrun_multichip(2)
    assert set(out) >= {"generalized_inverse", "lobpcg_mg", "largest_nondivisible",
                        "standard_inverse", "largest_general", "generalized_inverse_general"}
    for ev in out.values():
        assert np.isfinite(ev).all()
