"""The JAX package's public hooks and exports in the port, on the CPU.

Each public function that takes the reference's ``apply_a`` /
``apply_b`` / ``gram_reduce`` keywords runs in both packages on the same
f64 operands and start block (numpy-seeded), with the hooks each package's
own product and an identity ``gram_reduce`` (the shape of a psum over one
shard): ``gram_reduce`` alone, ``apply_a`` alone, and the matrix-free mode
(both apply hooks, the shift folded into ``apply_a``, ``shift=0`` and
``eval_shift``), with ``precond=False`` and with ``precond(None)``. The
port is held to the JAX package at the tolerances of the unhooked parity
tests of the same functions (``test_torch_lobpcg.py``,
``test_torch_generalized.py``, ``test_torch_standard.py``,
``test_torch_cg.py``, ``test_torch_ortho.py``), stated at each test, and
within the port each hooked call must give the bits of the unhooked call
it stands for. ``q0`` goes in the transposed (m, n) layout when a hook
says so and in the column layout otherwise. Then the exports, ``.n``, and
the transposed ``ell_spmm_t`` / ``bsr_spmm_t``.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dune_eigensolver_tpu as jpkg
from dune_eigensolver_tpu.factorize import cg as jcg
from dune_eigensolver_tpu.ops import ortho as jortho
from dune_eigensolver_tpu.solvers import generalized_inverse as jgeneralized
from dune_eigensolver_tpu.solvers import lobpcg_generalized as jlobpcg
from dune_eigensolver_tpu.solvers import standard_inverse as jinverse
from dune_eigensolver_tpu.solvers import standard_largest as jlargest
from dune_eigensolver_tpu.solvers.standard import shifted_operand as jshifted
from dune_eigensolver_tpu.sparse import formats as jformats
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu.sparse.spmm import bsr_spmm_t as jbsr_spmm_t
from dune_eigensolver_tpu.sparse.spmm import ell_spmm_t as jell_spmm_t
from dune_eigensolver_tpu.sparse.spmm import spmm as jspmm
from dune_eigensolver_tpu.sparse.spmm import spmm_t as jspmm_t

import dune_eigensolver_tpu_torch as tpkg
from dune_eigensolver_tpu_torch import ops as tops
from dune_eigensolver_tpu_torch.factorize import cg as tcg
from dune_eigensolver_tpu_torch.ops import ortho as tortho
from dune_eigensolver_tpu_torch.solvers import generalized_inverse as tgeneralized
from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized as tlobpcg
from dune_eigensolver_tpu_torch.solvers import standard_inverse as tinverse
from dune_eigensolver_tpu_torch.solvers import standard_largest as tlargest
from dune_eigensolver_tpu_torch.solvers.standard import shifted_operand as tshifted
from dune_eigensolver_tpu_torch.sparse import (
    bsr_from_numpy,
    dia_from_numpy,
    ell_from_numpy,
    spmm_t,
)
from dune_eigensolver_tpu_torch.sparse.spmm import bsr_spmm_t, ell_spmm_t, spmm

torch.set_num_threads(2)

N, SHIFT = 24, 1e-3  # n = 576


def _identity(g):
    return g


def _dia(Aj):
    return dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape, device="cpu")


def _pencil():
    """The 2D Dirichlet Laplacian, its diagonal perturbed by a seeded 0.3 *
    U(0, 1) as in test_torch_lobpcg.py (the pure operator's exactly double
    eigenvalues let roundoff steer the iteration path), and the
    partition-of-unity mass of tests/test_engine.py, in both packages, with
    the shifted operator and a start block of 8 columns. (With that test's
    Neumann operator the smallest eigenvalue is 0, which no relative
    tolerance can hold.)"""
    A0 = jproblems.laplacian_dirichlet_2d(N, dtype=np.float64)
    data = np.array(A0.data)
    data[A0.offsets.index(0)] += 0.3 * np.random.default_rng(8).random(N * N)
    Aj = jformats.DIAMatrix(data=jnp.asarray(data), offsets=A0.offsets, shape=A0.shape)
    Bj = jproblems.laplacian_b_2d(N, 3, dtype=np.float64)
    At, Bt = _dia(Aj), _dia(Bj)
    q0 = np.random.default_rng(21).standard_normal((N * N, 8))
    return dict(Aj=Aj, Bj=Bj, At=At, Bt=Bt, q0=q0,
                Aj_sh=jshifted(Aj, Bj, SHIFT, 0.0), At_sh=tshifted(At, Bt, SHIFT, 0.0))


def _jax_hooks(p):
    return dict(apply_a=lambda X: jspmm_t(p["Aj_sh"], X),
                apply_b=lambda X: jspmm_t(p["Bj"], X), gram_reduce=_identity)


def _port_hooks(p):
    return dict(apply_a=lambda X: spmm_t(p["At_sh"], X),
                apply_b=lambda X: spmm_t(p["Bt"], X), gram_reduce=_identity)


def _max_subspace_sine(U, V):
    """Largest principal-angle sine between the column spans of U and V."""
    Qu, _ = np.linalg.qr(U)
    Qv, _ = np.linalg.qr(V)
    s = np.linalg.svd(Qu.T @ Qv, compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - s.min() ** 2)))


def _same_solve(rj, rt, max_sine=1e-6):
    """The unhooked parity tests' bounds (test_torch_lobpcg.py,
    test_torch_generalized.py): the same iteration count, eigenvalues to
    rtol 1e-8 (sorted), eigenvectors to a subspace sine of 1e-6."""
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) == bool(rj.converged)
    ej, et = np.asarray(rj.eigenvalues), rt.eigenvalues.numpy()
    assert np.all(np.diff(et) >= 0)
    np.testing.assert_allclose(et, np.sort(ej), rtol=1e-8)
    assert rt.eigenvectors.shape == tuple(np.shape(rj.eigenvectors))
    assert _max_subspace_sine(np.asarray(rj.eigenvectors), rt.eigenvectors.numpy()) < max_sine


def _same_bits(r1, r2):
    assert int(r1.iterations) == int(r2.iterations)
    assert torch.equal(r1.eigenvalues, r2.eigenvalues)
    assert torch.equal(r1.eigenvectors, r2.eigenvectors)
    assert torch.equal(r1.criterion, r2.criterion)


def _cg_on(fac, rtol, maxiter):
    """A factory that ignores the operand the solver hands it and runs CG
    on the operator ``fac`` gives (no Jacobi), so that a matrix-free call
    (``precond(None)``) and an unhooked one (``precond(A')``) build the same
    solve."""
    return lambda A_int: fac(rtol=rtol, maxiter=maxiter,
                             apply_a=lambda X: spmm_t(A_int, X))(None)


# ---------------------------------------------------------------------------
# lobpcg_generalized
# ---------------------------------------------------------------------------

LOBPCG_MODES = ["gram_reduce", "apply_a", "matrix_free", "matrix_free_precond"]


def _lobpcg_pencil():
    """A 3D 7-point operand at N = 12 (n = 1,728) whose spectrum
    unpreconditioned LOBPCG resolves in a few iterations: a weak Laplacian
    (0.01 x) on a diagonal holding eight isolated values 1..8 (the block's
    width: the stop watches every Ritz value of the block) at seeded rows
    and a seeded cluster in [100, 101] elsewhere; and an identity mass as
    a DIA operand. (Unpreconditioned LOBPCG on the plain Laplacian runs
    ~80 steps, over which the JAX package's eager hooked core and its
    jitted plain core already part by roundoff.)"""
    A0 = jproblems.laplacian_dirichlet_3d(12, dtype=np.float64)
    n = A0.shape[0]
    rng = np.random.default_rng(8)
    data = 0.01 * np.array(A0.data)
    diag = 100.0 + rng.random(n)
    diag[rng.choice(n, 8, replace=False)] = np.arange(1.0, 9.0)
    data[A0.offsets.index(0)] += diag
    Aj = jformats.DIAMatrix(data=jnp.asarray(data), offsets=A0.offsets, shape=A0.shape)
    Bj = jformats.DIAMatrix(data=jnp.ones((1, n)), offsets=(0,), shape=A0.shape)
    At, Bt = _dia(Aj), _dia(Bj)
    q0 = rng.standard_normal((n, 8))
    return dict(Aj=Aj, Bj=Bj, At=At, Bt=Bt, q0=q0,
                Aj_sh=jshifted(Aj, Bj, SHIFT, 0.0), At_sh=tshifted(At, Bt, SHIFT, 0.0))


def _lobpcg_kwargs(mode, hooks, cg_factory, A):
    """(hooked kwargs, their unhooked equivalent, whether q0 is transposed)
    for one package's hooks. Without a preconditioner the recipe is
    test_torch_lobpcg.py's "none" case (no shift, identity B). ``A``: the
    package's product with the unshifted operand."""
    none = dict(shift=0.0, precond=False, b_identity=True)
    if mode == "gram_reduce":
        return dict(none, gram_reduce=hooks["gram_reduce"]), none, True
    if mode == "apply_a":  # B falls back to the identity of b_identity
        return dict(none, apply_a=A), none, False
    if mode == "matrix_free":
        return (dict(apply_a=A, apply_b=_identity, precond=False), none, True)
    return (dict(apply_a=hooks["apply_a"], apply_b=hooks["apply_b"],
                 gram_reduce=hooks["gram_reduce"], shift=0.0, eval_shift=SHIFT,
                 precond=lambda _none: cg_factory(rtol=1e-2, maxiter=25,
                                                  apply_a=hooks["apply_a"])(None)),
            dict(shift=SHIFT, precond=_cg_on(cg_factory, 1e-2, 25)), True)


@pytest.mark.parametrize("mode", LOBPCG_MODES)
def test_lobpcg_generalized_hooks(mode):
    """``lobpcg_generalized`` with each set of hooks (without a
    preconditioner, as test_torch_lobpcg.py's "none" case, and with a CG
    on the hook's operator through ``precond(None)``): the JAX package's
    solve (``_same_solve``'s bounds), and the port's unhooked solve's
    bits."""
    p = _lobpcg_pencil()
    kw = dict(nev=7, tol=1e-6, maxiter=150, ortho_block=8)
    hj, _, transposed = _lobpcg_kwargs(mode, _jax_hooks(p), jcg.cg_inverse_factory,
                                       lambda X: jspmm_t(p["Aj"], X))
    ht, plain, _ = _lobpcg_kwargs(mode, _port_hooks(p), tcg.cg_inverse_factory,
                                  lambda X: spmm_t(p["At"], X))
    q0 = p["q0"].T.copy() if transposed else p["q0"]
    rj = jlobpcg(p["Aj"], p["Bj"], q0=jnp.asarray(q0), **hj, **kw)
    rt = tlobpcg(p["At"], p["Bt"], q0=torch.from_numpy(q0), **ht, **kw)
    assert bool(rt.converged)
    _same_solve(rj, rt)
    _same_bits(rt, tlobpcg(p["At"], p["Bt"], q0=torch.from_numpy(p["q0"]), **plain, **kw))


def test_lobpcg_matrix_free_touches_no_operand_setup():
    """Matrix-free: the setup memo stays as it was and the preconditioner
    factory is handed ``None``; ``precond=None`` there is the caller's
    error, as in the JAX package (``None`` is not callable)."""
    from dune_eigensolver_tpu_torch.solvers import engine

    p = _pencil()
    hooks = _port_hooks(p)
    seen = []

    def prec(arg):
        seen.append(arg)
        return lambda X: X

    before = dict(engine._SETUP_MEMO)
    tlobpcg(p["At"], p["Bt"], nev=4, tol=1e-6, maxiter=3, apply_a=hooks["apply_a"],
            apply_b=hooks["apply_b"], precond=prec, q0=torch.from_numpy(p["q0"].T.copy()))
    assert seen == [None] and engine._SETUP_MEMO == before
    with pytest.raises(TypeError):
        tlobpcg(p["At"], p["Bt"], nev=4, tol=1e-6, maxiter=3, apply_a=hooks["apply_a"],
                apply_b=hooks["apply_b"], q0=torch.from_numpy(p["q0"].T.copy()))


# ---------------------------------------------------------------------------
# generalized_inverse
# ---------------------------------------------------------------------------

GEN_MODES = ["gram_reduce", "apply_a", "matrix_free"]


def _gen_kwargs(mode, hooks, cg_factory):
    inv = cg_factory(rtol=1e-10, maxiter=2000)
    if mode == "gram_reduce":
        return (dict(gram_reduce=hooks["gram_reduce"], shift=SHIFT, inverse=inv),
                dict(shift=SHIFT, inverse=inv), True)
    if mode == "apply_a":
        return (dict(apply_a=hooks["apply_a"], shift=SHIFT, inverse=inv),
                dict(shift=SHIFT, inverse=inv), False)
    return (dict(apply_a=hooks["apply_a"], apply_b=hooks["apply_b"],
                 gram_reduce=hooks["gram_reduce"], shift=0.0, eval_shift=SHIFT,
                 inverse=cg_factory(rtol=1e-10, maxiter=2000, apply_a=hooks["apply_a"])),
            dict(shift=SHIFT, inverse=_cg_on(cg_factory, 1e-10, 2000)), True)


@pytest.mark.parametrize("mode", GEN_MODES)
def test_generalized_inverse_hooks(mode):
    """``generalized_inverse`` with each set of hooks (Rayleigh-Ritz, as
    test_torch_generalized.py's interpret-mode case, ~110 iterations); the
    matrix-free inverse is ``cg_inverse_factory(apply_a=...)``, which the
    solver calls with ``None``. The JAX solve at ``_same_solve``'s bounds,
    the port's unhooked solve's bits."""
    p = _pencil()
    kw = dict(nev=4, tol=1e-6, maxiter=300, min_iter=2, rayleigh_ritz=True)
    hj, _, transposed = _gen_kwargs(mode, _jax_hooks(p), jcg.cg_inverse_factory)
    ht, plain, _ = _gen_kwargs(mode, _port_hooks(p), tcg.cg_inverse_factory)
    q0 = p["q0"].T.copy() if transposed else p["q0"]
    rj = jgeneralized(p["Aj"], p["Bj"], q0=jnp.asarray(q0), **hj, **kw)
    rt = tgeneralized(p["At"], p["Bt"], q0=torch.from_numpy(q0), **ht, **kw)
    assert bool(rt.converged)
    _same_solve(rj, rt)
    _same_bits(rt, tgeneralized(p["At"], p["Bt"], q0=torch.from_numpy(p["q0"]), **plain, **kw))


# ---------------------------------------------------------------------------
# standard_largest, standard_inverse
# ---------------------------------------------------------------------------


def _laplacian():
    Aj = jproblems.laplacian_dirichlet_2d(N, dtype=np.float64)
    return Aj, _dia(Aj), np.random.default_rng(N).standard_normal((N * N, 8))


def _same_standard(rj, rt):
    """test_torch_standard.py's f64 bounds: the same iteration count,
    eigenvalues and criterion within 1e-10, subspace sine 1e-6."""
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) == bool(rj.converged)
    assert np.abs(rt.eigenvalues.numpy() - np.asarray(rj.eigenvalues)).max() <= 1e-10
    assert abs(float(rt.criterion) - float(rj.criterion)) <= 1e-10
    assert _max_subspace_sine(np.asarray(rj.eigenvectors), rt.eigenvectors.numpy()) <= 1e-6


@pytest.mark.parametrize("hooks", ["gram_reduce", "apply_a", "both"])
def test_standard_largest_hooks(hooks):
    """``standard_largest`` with ``gram_reduce``, a lone ``apply_a`` (which
    already makes ``q0`` transposed: its mode is either hook) and both; the
    shift 0.5 is folded into ``apply_a`` and subtracted from the Ritz
    values, as in the JAX package."""
    Aj, At, q0 = _laplacian()
    kw = dict(nev=4, tol=1e-8, maxiter=600, shift=0.5, rayleigh_ritz=True)
    Aj_sh, At_sh = Aj.with_shifted_diagonal(0.5), At.with_shifted_diagonal(0.5)
    hj, ht = {}, {}
    if hooks in ("gram_reduce", "both"):
        hj["gram_reduce"] = ht["gram_reduce"] = _identity
    if hooks in ("apply_a", "both"):
        hj["apply_a"] = lambda X: jspmm_t(Aj_sh, X)
        ht["apply_a"] = lambda X: spmm_t(At_sh, X)
    rj = jlargest(Aj, q0=jnp.asarray(q0.T.copy()), **hj, **kw)
    rt = tlargest(At, q0=torch.from_numpy(q0.T.copy()), **ht, **kw)
    _same_standard(rj, rt)
    _same_bits(rt, tlargest(At, q0=torch.from_numpy(q0), **kw))


def test_standard_inverse_gram_reduce():
    """``standard_inverse(gram_reduce=)`` with a tight Jacobi-CG inverse
    (rtol 1e-10, as test_torch_standard.py), ``q0`` transposed."""
    Aj, At, q0 = _laplacian()
    kw = dict(nev=4, tol=1e-8, maxiter=200)
    rj = jinverse(Aj, q0=jnp.asarray(q0.T.copy()), gram_reduce=_identity,
                  inverse=jcg.cg_inverse_factory(rtol=1e-10, maxiter=2000), **kw)
    inv = tcg.cg_inverse_factory(rtol=1e-10, maxiter=2000)
    rt = tinverse(At, q0=torch.from_numpy(q0.T.copy()), gram_reduce=_identity, inverse=inv, **kw)
    _same_standard(rj, rt)
    _same_bits(rt, tinverse(At, q0=torch.from_numpy(q0), inverse=inv, **kw))


def test_q0_layout_follows_the_hooks():
    """Without hooks ``q0`` is (n, m); with one it is (m, n): the same
    block in the two layouts gives the same bits, and a column block handed
    to a hooked call raises ``ValueError`` rather than run."""
    Aj, At, q0 = _laplacian()
    kw = dict(nev=4, tol=1e-8, maxiter=50)
    r_col = tlargest(At, q0=torch.from_numpy(q0), **kw)
    r_row = tlargest(At, q0=torch.from_numpy(q0.T.copy()), gram_reduce=_identity, **kw)
    _same_bits(r_col, r_row)
    wide = np.random.default_rng(3).standard_normal((N * N, 12))
    with pytest.raises(ValueError):
        tlargest(At, q0=torch.from_numpy(wide), gram_reduce=_identity, **kw)


# ---------------------------------------------------------------------------
# cg_solve, cg_inverse_factory
# ---------------------------------------------------------------------------


def test_cg_solve_gram_reduce():
    """The column-layout ``cg_solve(gram_reduce=)``: the JAX iterate to
    1e-10 of its magnitude and the same count (test_torch_cg.py), the
    unhooked bits."""
    Aj, At, _ = _laplacian()
    B = np.random.default_rng(4).standard_normal((N * N, 4))
    kw = dict(rtol=1e-9, maxiter=400)
    Xj, kj = jcg.cg_solve(lambda V: jspmm(Aj, V), jnp.asarray(B), diag=Aj.diagonal(),
                          gram_reduce=_identity, **kw)
    Xt, kt = tcg.cg_solve(lambda V: spmm(At, V), torch.from_numpy(B),
                          diag=At.diagonal(), gram_reduce=_identity, **kw)
    assert kt == int(kj)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(Xj)).max())
    X0, k0 = tcg.cg_solve(lambda V: spmm(At, V), torch.from_numpy(B),
                          diag=At.diagonal(), **kw)
    assert k0 == kt and torch.equal(X0, Xt)


@pytest.mark.parametrize("operand", [True, False], ids=["jacobi", "none"])
@pytest.mark.parametrize("gram", [False, True], ids=["apply_a", "apply_a+gram_reduce"])
def test_cg_inverse_factory_hooks(operand, gram):
    """``cg_inverse_factory(apply_a=, gram_reduce=)``: a plain transposed
    solve, Jacobi on the operand's diagonal when one is handed in and none
    for ``inverse(None)``; the JAX solve at test_torch_cg.py's 1e-10; with
    an operand, the unhooked pair's bits."""
    Aj, At, _ = _laplacian()
    Xt = np.random.default_rng(6).standard_normal((8, N * N))
    kw = dict(rtol=1e-5, maxiter=1000)
    gj = dict(gram_reduce=_identity) if gram else {}
    solve_j = jcg.cg_inverse_factory(apply_a=lambda V: jspmm_t(Aj, V), **gj, **kw)(
        Aj if operand else None)
    solve_t = tcg.cg_inverse_factory(apply_a=lambda V: spmm_t(At, V), **gj, **kw)(
        At if operand else None)
    assert callable(solve_t) and solve_t.layout_t
    Yj = np.asarray(solve_j(jnp.asarray(Xt)))
    Yt = solve_t(torch.from_numpy(Xt))
    np.testing.assert_allclose(Yt.numpy(), Yj, rtol=1e-10, atol=1e-10 * np.abs(Yj).max())
    if operand:
        aux, fn = tcg.cg_inverse_factory(**gj, **kw)(At)
        assert torch.equal(fn(aux, torch.from_numpy(Xt)), Yt)


def test_cg_inverse_factory_gram_reduce_pair():
    """``gram_reduce`` alone reaches the pair's inner CG: each of its row
    dots goes through it (counted), and the result is the JAX pair's."""
    Aj, At, _ = _laplacian()
    Xt = np.random.default_rng(7).standard_normal((8, N * N))
    calls = []

    def counting(g):
        calls.append(g.shape)
        return g

    aux_j, fn_j = jcg.cg_inverse_factory(rtol=1e-5, maxiter=1000, gram_reduce=_identity)(Aj)
    aux_t, fn_t = tcg.cg_inverse_factory(rtol=1e-5, maxiter=1000, gram_reduce=counting)(At)
    Yj = np.asarray(fn_j(aux_j, jnp.asarray(Xt)))
    Yt = fn_t(aux_t, torch.from_numpy(Xt)).numpy()
    np.testing.assert_allclose(Yt, Yj, rtol=1e-10, atol=1e-10 * np.abs(Yj).max())
    assert calls and set(calls) == {(8,)}


# ---------------------------------------------------------------------------
# orthonormalizations
# ---------------------------------------------------------------------------


def test_orthonormalize_blocked_gram_reduce():
    """The column-layout orthonormalizations with ``gram_reduce``: the JAX
    results to rtol 1e-10 (test_torch_ortho.py), the unhooked bits."""
    p = _pencil()
    X = np.random.default_rng(9).standard_normal((N * N, 16))
    Qj = np.asarray(jortho.orthonormalize_blocked(jnp.asarray(X), block=8,
                                                  gram_reduce=_identity, iterations=2))
    Qt = tortho.orthonormalize_blocked(torch.from_numpy(X), block=8, gram_reduce=_identity,
                                       iterations=2)
    np.testing.assert_allclose(Qt.numpy(), Qj, rtol=1e-10, atol=1e-10)
    assert torch.equal(Qt, tortho.orthonormalize_blocked(torch.from_numpy(X), block=8,
                                                         iterations=2))
    Yj, nj = jortho.b_orthonormalize_blocked(p["Bj"], jnp.asarray(X), block=8,
                                             gram_reduce=_identity)
    Yt, nt = tortho.b_orthonormalize_blocked(p["Bt"], torch.from_numpy(X), block=8,
                                             gram_reduce=_identity)
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(nt.item(), float(nj), rtol=1e-10)
    Y0, n0 = tortho.b_orthonormalize_blocked(p["Bt"], torch.from_numpy(X), block=8)
    assert torch.equal(Y0, Yt) and torch.equal(n0, nt)


# ---------------------------------------------------------------------------
# signatures, exports, .n, ell_spmm_t / bsr_spmm_t
# ---------------------------------------------------------------------------

HOOKED = [
    ("lobpcg_generalized", tlobpcg, jlobpcg, ("apply_a", "apply_b", "gram_reduce")),
    ("generalized_inverse", tgeneralized, jgeneralized, ("apply_a", "apply_b", "gram_reduce")),
    ("standard_largest", tlargest, jlargest, ("apply_a", "gram_reduce")),
    ("standard_inverse", tinverse, jinverse, ("gram_reduce",)),
    ("cg_inverse_factory", tcg.cg_inverse_factory, jcg.cg_inverse_factory,
     ("gram_reduce", "apply_a")),
    ("cg_solve", tcg.cg_solve, jcg.cg_solve, ("gram_reduce",)),
    ("orthonormalize_blocked", tortho.orthonormalize_blocked, jortho.orthonormalize_blocked,
     ("gram_reduce",)),
    ("b_orthonormalize_blocked", tortho.b_orthonormalize_blocked,
     jortho.b_orthonormalize_blocked, ("gram_reduce",)),
]


@pytest.mark.parametrize("name,port,ref,hooks", HOOKED, ids=[h[0] for h in HOOKED])
def test_signatures_take_the_hooks(name, port, ref, hooks):
    """Each hook keyword is there with the JAX package's default and
    position among the keywords both packages have; ``force_padded`` (the
    guarded layout, left out) is not."""
    ps = inspect.signature(inspect.unwrap(port)).parameters
    rs = inspect.signature(ref).parameters
    for h in hooks:
        assert ps[h].default is None and rs[h].default is None
    common = [k for k in rs if k in ps]
    assert [k for k in ps if k in rs] == common
    assert "force_padded" not in ps


def test_exports_are_the_same_functions():
    """Every name the JAX package exports at its top level, the port
    exports, and the new ones are the port's own functions."""
    assert set(jpkg.__all__) <= set(tpkg.__all__)
    assert tpkg.spmm is spmm
    for name in ("orthonormalize_blocked", "b_orthonormalize_blocked",
                 "dot_products_diagonal", "dot_products_all"):
        assert getattr(tpkg, name) is getattr(tortho, name) is getattr(tops, name)
        assert name in tops.__all__


def _gather_operands():
    Sg = jproblems.unstructured_laplacian(1500, extra_edges=80, seed=5, fmt="scipy")
    Ej = jformats.ell_from_scipy(Sg)
    Et = ell_from_numpy(np.asarray(Ej.data), np.asarray(Ej.cols), Ej.shape, Ej.nnz, device="cpu")
    Bj, _ = jproblems.elasticity_2d(12, dtype=np.float64)
    Bt = bsr_from_numpy(np.asarray(Bj.bdata), np.asarray(Bj.bcols), Bj.shape, Bj.block, Bj.nnz,
                        device="cpu")
    return Ej, Et, Bj, Bt


def test_n_property():
    """``DIAMatrix.n`` and ``ELLMatrix.n`` are shape[0], as the JAX
    package's."""
    Ej, Et, _, _ = _gather_operands()
    Aj, At, _ = _laplacian()
    assert At.n == Aj.n == N * N == At.shape[0]
    assert Et.n == Ej.n == 1500 == Et.shape[0]


def test_ell_and_bsr_spmm_t_match_jax():
    """The transposed ``ell_spmm_t`` / ``bsr_spmm_t`` against the JAX
    package's (f64, rtol 1e-12 of max|Y|), with ``spmm_t``'s bits (the same
    route: the plain version on the CPU, K2 / K3 on a CUDA tensor), and
    ``TypeError`` for the other container."""
    Ej, Et, Bj, Bt = _gather_operands()
    rng = np.random.default_rng(12)
    for Mj, Mt, fj, ft in ((Ej, Et, jell_spmm_t, ell_spmm_t),
                           (Bj, Bt, jbsr_spmm_t, bsr_spmm_t)):
        X = rng.standard_normal((8, Mj.shape[1]))
        Yj = np.asarray(fj(Mj, jnp.asarray(X)))
        Yt = ft(Mt, torch.from_numpy(X))
        np.testing.assert_allclose(Yt.numpy(), Yj, rtol=0, atol=1e-12 * np.abs(Yj).max())
        assert torch.equal(Yt, spmm_t(Mt, torch.from_numpy(X)))
    with pytest.raises(TypeError, match="expected ELLMatrix"):
        ell_spmm_t(Bt, torch.zeros((8, Bt.shape[1]), dtype=torch.float64))
    with pytest.raises(TypeError, match="expected BSRMatrix"):
        bsr_spmm_t(Et, torch.zeros((8, Et.shape[1]), dtype=torch.float64))
