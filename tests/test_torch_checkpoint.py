"""Checkpoint/resume of the port against the JAX package's.

The pencil is the 2D GenEO pair at N = 12 (n = 144), shift 1e-3, in f64,
with a seeded random perturbation of A's diagonal (as in
tests/test_torch_lobpcg.py: the pure pencil has exactly degenerate
eigenvalues, inside which the iteration path turns on roundoff, and two
correct LOBPCGs then need not stop at the same iteration); the solves run
in segments of 5 iterations. A run interrupted by
``maxiter`` and resumed from its file must end where the uninterrupted run
ends (the same iterations and eigenvalues: the state at a segment boundary
is the file's). A checkpoint written by either package must resume in the
other: both packages resume the same file and are held to each other.
``generalized_inverse`` (the default inverse, the block-banded direct
engine in both, tol 1e-8) continues from the same block along the same
path: the same iterations and eigenvalues to 1e-10 relative. LOBPCG (the
Jacobi-CG preconditioner of the GenEO recipe, rtol 1e-2 and 25 steps, tol
1e-6) does not: the first iteration of a resumed segment has no search
direction and fills its place with half the preconditioned residual, which
the orthonormalization reduces to roundoff (the reference's filler); from
a nearly converged block those roundoff directions are the two packages'
own, so the runs stop within 3 iterations of each other and agree on the
eigenvalues to 1e-5 relative (10 x tol), not to the bit.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_eigensolver_tpu.factorize import cg_inverse_factory as jcg_factory
from dune_eigensolver_tpu.solvers import checkpoint as jckpt
from dune_eigensolver_tpu.sparse import formats as jformats
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory as tcg_factory
from dune_eigensolver_tpu_torch.solvers import checkpoint as tckpt
from dune_eigensolver_tpu_torch.sparse import dia_from_numpy

torch.set_num_threads(2)

N, NEV, EVERY = 12, 4, 5


def _pencil():
    A0 = jproblems.laplacian_neumann_2d(N, dtype=np.float64)
    data = np.array(A0.data)
    data[A0.offsets.index(0)] += 0.3 * np.random.default_rng(8).random(N * N)
    Aj = jformats.DIAMatrix(data=jnp.asarray(data), offsets=A0.offsets, shape=A0.shape)
    Bj = jproblems.laplacian_b_2d(N, 3, dtype=np.float64)
    At, Bt = (dia_from_numpy(np.asarray(M.data), M.offsets, M.shape, device="cpu")
              for M in (Aj, Bj))
    return Aj, Bj, At, Bt


# solver name -> (JAX call, port call), each (A, B, path, maxiter) -> result
SOLVERS = {
    "generalized": (
        lambda A, B, path, maxiter: jckpt.generalized_inverse_checkpointed(
            A, B, nev=NEV, tol=1e-8, maxiter=maxiter, checkpoint_path=path,
            checkpoint_every=EVERY, shift=1e-3),
        lambda A, B, path, maxiter: tckpt.generalized_inverse_checkpointed(
            A, B, nev=NEV, tol=1e-8, maxiter=maxiter, checkpoint_path=path,
            checkpoint_every=EVERY, shift=1e-3),
    ),
    "lobpcg": (
        lambda A, B, path, maxiter: jckpt.lobpcg_generalized_checkpointed(
            A, B, nev=NEV, tol=1e-6, maxiter=maxiter, checkpoint_path=path,
            checkpoint_every=EVERY, shift=1e-3, precond=jcg_factory(rtol=1e-2, maxiter=25)),
        lambda A, B, path, maxiter: tckpt.lobpcg_generalized_checkpointed(
            A, B, nev=NEV, tol=1e-6, maxiter=maxiter, checkpoint_path=path,
            checkpoint_every=EVERY, shift=1e-3, precond=tcg_factory(rtol=1e-2, maxiter=25)),
    ),
}


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_resume_equals_uninterrupted(solver, tmp_path):
    _, _, At, Bt = _pencil()
    run = SOLVERS[solver][1]
    full = run(At, Bt, str(tmp_path / "full.npz"), 300)
    path = str(tmp_path / "cut.npz")
    cut = run(At, Bt, path, EVERY)
    assert int(cut.iterations) == EVERY and not bool(cut.converged)
    with np.load(path) as z:
        assert z["Q"].shape == (N * N, 8) and int(z["iterations"]) == EVERY
        assert z["iterations"].dtype == np.int64 and z["eigenvalues"].shape == (8,)
    resumed = run(At, Bt, path, 300)
    assert bool(full.converged) and bool(resumed.converged)
    assert int(resumed.iterations) == int(full.iterations) > EVERY
    ef = full.eigenvalues.numpy()
    assert np.abs(resumed.eigenvalues.numpy() - ef).max() <= 1e-12 * np.abs(ef).max()
    assert resumed.eigenvectors.shape == (N * N, NEV)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_checkpoint_resumes_in_the_other_package(solver, writer, tmp_path):
    Aj, Bj, At, Bt = _pencil()
    jrun, trun = SOLVERS[solver]
    first = str(tmp_path / "first.npz")
    if writer == "jax":
        jrun(Aj, Bj, first, EVERY)
    else:
        trun(At, Bt, first, EVERY)
    for name in ("j.npz", "t.npz"):
        shutil.copy(first, tmp_path / name)
    rj = jrun(Aj, Bj, str(tmp_path / "j.npz"), 300)
    rt = trun(At, Bt, str(tmp_path / "t.npz"), 300)
    assert bool(rj.converged) and bool(rt.converged)
    assert min(int(rt.iterations), int(rj.iterations)) > EVERY
    ej = np.asarray(rj.eigenvalues)
    err = np.abs(rt.eigenvalues.numpy() - ej).max() / np.abs(ej).max()
    if solver == "generalized":
        assert int(rt.iterations) == int(rj.iterations) and err <= 1e-10
    else:
        assert abs(int(rt.iterations) - int(rj.iterations)) <= 3 and err <= 1e-5
    # each package's final file is readable by the other's loader
    for path in (tmp_path / "j.npz", tmp_path / "t.npz"):
        Qj, itj = jckpt.load_checkpoint(str(path))
        Qt, itt = tckpt.load_checkpoint(str(path))
        assert itj == itt and Qj.shape == (N * N, 8) and np.array_equal(Qj, Qt)
    assert tckpt.load_checkpoint(str(tmp_path / "t.npz"))[1] == int(rt.iterations)


def test_save_is_atomic_and_loads(tmp_path):
    """The write goes through a temporary file in the target's directory
    that is gone afterwards; tensors (any device) and arrays are taken; a
    missing file loads as None."""
    path = tmp_path / "sub" / "state.npz"
    Q = torch.arange(12.0, dtype=torch.float64).reshape(4, 3).T  # a non-contiguous view
    tckpt.save_checkpoint(str(path), Q, 7, torch.tensor([1.0, 2.0]))
    assert os.listdir(tmp_path / "sub") == ["state.npz"]
    with np.load(path) as z:
        assert sorted(z.files) == ["Q", "eigenvalues", "iterations"]
        assert np.array_equal(z["Q"], Q.numpy()) and int(z["iterations"]) == 7
        assert np.array_equal(z["eigenvalues"], [1.0, 2.0])
    tckpt.save_checkpoint(str(path), np.ones((3, 2)), 9)
    assert os.listdir(tmp_path / "sub") == ["state.npz"]
    Q2, it = tckpt.load_checkpoint(str(path))
    assert it == 9 and Q2.shape == (3, 2)
    with np.load(path) as z:
        assert z["eigenvalues"].shape == (0,)
    assert tckpt.load_checkpoint(str(tmp_path / "none.npz")) is None
    # the JAX package reads the port's file as its own
    Qj, itj = jckpt.load_checkpoint(str(path))
    assert itj == 9 and np.array_equal(Qj, Q2) and jnp.asarray(Qj).shape == (3, 2)


def test_fully_resumed_run_returns_one_iteration_more(tmp_path):
    """A file whose iterations already reach ``maxiter``: one iteration from
    the stored block, and the stored count, in both packages."""
    Aj, Bj, At, Bt = _pencil()
    jrun, trun = SOLVERS["generalized"]
    path = str(tmp_path / "c.npz")
    trun(At, Bt, path, EVERY)
    rt = trun(At, Bt, path, EVERY)
    rj = jrun(Aj, Bj, path, EVERY)
    assert int(rt.iterations) == int(rj.iterations) == EVERY
    ej = np.asarray(rj.eigenvalues)
    assert np.abs(rt.eigenvalues.numpy() - ej).max() <= 1e-10 * np.abs(ej).max()
