"""LOBPCG of the PyTorch port against the JAX package, from the same start
block on the same operand.

The operand is the 3D N=12 Dirichlet Laplacian with a seeded random
perturbation of its diagonal: the pure Laplacian's spectrum has exactly
degenerate clusters, inside which the Ritz vectors (and with them the
iteration path) turn on roundoff, so two correct implementations need not
take the same number of iterations there. The perturbation makes every
gap O(1e-3) and the paths comparable step by step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_eigensolver_tpu.factorize import mg_inverse_factory as jmg_factory
from dune_eigensolver_tpu.solvers import lobpcg_generalized as jlobpcg
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu.sparse.formats import DIAMatrix as JDIA
from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory as tmg_factory
from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized as tlobpcg
from dune_eigensolver_tpu_torch.sparse import dia_from_numpy

torch.set_num_threads(2)

N, NEV = 12, 7  # nev=7 pads to one 8-row block


def _pencil(dtype):
    A0 = jproblems.laplacian_dirichlet_3d(N, dtype=np.float64)
    n = A0.shape[0]
    data = np.array(A0.data)
    data[A0.offsets.index(0)] += 0.3 * np.random.default_rng(8).random(n)
    data = data.astype(dtype)
    Aj = JDIA(data=jnp.asarray(data), offsets=A0.offsets, shape=A0.shape)
    Bj = JDIA(data=jnp.ones((1, n), dtype), offsets=(0,), shape=A0.shape)
    At = dia_from_numpy(data, A0.offsets, A0.shape, device="cpu")
    Bt = dia_from_numpy(np.ones((1, n), dtype), (0,), A0.shape, device="cpu")
    q0 = np.random.default_rng(7).standard_normal((n, 8)).astype(dtype)
    return Aj, Bj, At, Bt, q0


def _max_subspace_sine(U, V):
    """Largest principal-angle sine between the column spans of U and V."""
    Qu, _ = np.linalg.qr(U)
    Qv, _ = np.linalg.qr(V)
    s = np.linalg.svd(Qu.T @ Qv, compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - s.min() ** 2)))


def _solve_both(dtype, precond, tol, force_padded=None):
    Aj, Bj, At, Bt, q0 = _pencil(dtype)
    kw = dict(nev=NEV, tol=tol, maxiter=150, b_identity=True, ortho_block=8)
    rj = jlobpcg(Aj, Bj, precond=jmg_factory() if precond else False,
                 q0=jnp.asarray(q0), force_padded=force_padded, **kw)
    rt = tlobpcg(At, Bt, precond=tmg_factory() if precond else False,
                 q0=torch.from_numpy(q0), **kw)
    return rj, rt


@pytest.mark.parametrize("precond", [True, False], ids=["mg", "none"])
def test_lobpcg_matches_jax_f64(precond):
    """f64 with the same q0: the same iteration, so the same count, and
    eigenvalues to rtol 1e-8. The MG's coarsest level is an f32 CG in both
    packages, whose roundoff differs; it moves the vectors at the 1e-7
    level (the eigenvalues only quadratically), hence 1e-6 on the angle."""
    rj, rt = _solve_both(np.float64, precond, tol=1e-6)
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) == bool(rj.converged) is True
    ej, et = np.asarray(rj.eigenvalues), rt.eigenvalues.numpy()
    assert np.all(np.diff(et) >= 0)
    np.testing.assert_allclose(et, ej, rtol=1e-8)
    assert rt.eigenvectors.shape == (N**3, NEV)
    assert _max_subspace_sine(np.asarray(rj.eigenvectors), rt.eigenvectors.numpy()) < 1e-6


def test_lobpcg_matches_pallas_interpret_f32():
    """The JAX side on its guarded layout, so every A.X runs the Pallas
    kernel in interpret mode. In f32, both accumulate A.X in f32 but in
    other orders: eigenvalues to rtol 1e-5; the Ritz vectors of a
    tol=1e-4 solve inside gaps of ~3e-3 move with that roundoff at the
    1e-3 level, held at 1e-2."""
    rj, rt = _solve_both(np.float32, True, tol=1e-4, force_padded=True)
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(rt.eigenvalues.numpy(), np.asarray(rj.eigenvalues),
                               rtol=1e-5)
    assert _max_subspace_sine(np.asarray(rj.eigenvectors), rt.eigenvectors.numpy()) < 1e-2


def test_lobpcg_port_seeded_start_and_explicit_b():
    """Without q0 the port draws its start block from a torch.Generator:
    the same seed gives the same result, and b_identity=True agrees with
    the honest identity B apply."""
    _, _, At, Bt, _ = _pencil(np.float64)
    kw = dict(nev=4, tol=1e-8, maxiter=150, precond=tmg_factory(), seed=3)
    r1 = tlobpcg(At, Bt, b_identity=True, **kw)
    r2 = tlobpcg(At, Bt, b_identity=True, **kw)
    r3 = tlobpcg(At, Bt, b_identity=False, **kw)
    torch.testing.assert_close(r1.eigenvalues, r2.eigenvalues, rtol=0, atol=0)
    torch.testing.assert_close(r1.eigenvalues, r3.eigenvalues, rtol=1e-10, atol=0)
    exact = np.linalg.eigvalsh(At.to_scipy().toarray())[:4]
    np.testing.assert_allclose(r1.eigenvalues.numpy(), exact, rtol=1e-7)


def test_lobpcg_port_refuses_default_preconditioner():
    _, _, At, Bt, _ = _pencil(np.float64)
    with pytest.raises(ValueError, match="default_inverse_factory"):
        tlobpcg(At, Bt, nev=4, tol=1e-6, maxiter=10)


def test_shifted_operand_and_normalize_inverse_match_jax():
    """A + shift*B + reg*I (the shift fold of every solve) and the inverse
    normalization, against the JAX package's helpers."""
    from dune_eigensolver_tpu.solvers import standard as jstandard
    from dune_eigensolver_tpu_torch.solvers import standard as tstandard

    Aj, _, At, _, _ = _pencil(np.float64)
    n = Aj.shape[0]
    w = np.random.default_rng(9).random(n)
    Bj = JDIA(data=jnp.asarray(w[None, :]), offsets=(0,), shape=Aj.shape)
    Bt = dia_from_numpy(w[None, :], (0,), Aj.shape, device="cpu")
    for B_j, B_t, shift, reg in ((Bj, Bt, 0.5, 0.1), (None, None, 0.25, 0.0),
                                 (Bj, Bt, 0.0, 0.0)):
        Sj = jstandard.shifted_operand(Aj, B_j, shift, reg)
        St = tstandard.shifted_operand(At, B_t, shift, reg)
        assert St.offsets == Sj.offsets
        np.testing.assert_allclose(St.data.numpy(), np.asarray(Sj.data), rtol=1e-15)
    assert tstandard.shifted_operand(At, Bt, 0.0, 0.0) is At
    np.testing.assert_array_equal(At.data.numpy(), np.asarray(Aj.data))  # unmutated
    aux, fn = tstandard.normalize_inverse(lambda X: 2.0 * X)
    X = torch.ones(2, 3, dtype=torch.float64)
    assert aux is None and torch.equal(fn(aux, X), 2.0 * X)
    assert tstandard.padded_width(7, 8) == jstandard.padded_width(7, 8) == 8
