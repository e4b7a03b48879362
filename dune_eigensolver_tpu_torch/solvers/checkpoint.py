"""Checkpoint/resume for long eigensolver runs.

Counterpart of the JAX package's ``solvers/checkpoint.py``: the solver runs
``checkpoint_every`` iterations a segment, writes the iterate block Q and
its Rayleigh quotients to ``<path>`` after every segment, and resumes from
the file on restart. The file is the JAX package's: an ``.npz`` holding
``Q`` (n, m) in column layout, ``iterations`` (int64) and ``eigenvalues``,
so a checkpoint written by either package resumes in the other. A resume
re-orthonormalizes the stored block, so it continues the solve, not its
bits; LOBPCG also rebuilds its search direction from the first iteration of
each segment.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional

import numpy as np
import torch

from dune_eigensolver_tpu_torch.solvers.adaptive import prepared_inverse
from dune_eigensolver_tpu_torch.solvers.generalized import generalized_inverse
from dune_eigensolver_tpu_torch.solvers.lobpcg import lobpcg_generalized
from dune_eigensolver_tpu_torch.solvers.result import EigenResult
from dune_eigensolver_tpu_torch.solvers.standard import padded_width
from dune_eigensolver_tpu_torch.utils.paranoid import reporting


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x)


def save_checkpoint(path: str, Q, iterations: int, eigenvalues=None) -> None:
    """Atomic write (temporary file in the same directory, then
    ``os.replace``) of the solver state. Q and eigenvalues may be tensors on
    any device or arrays."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(
                fh,
                Q=_numpy(Q),
                iterations=np.int64(iterations),
                eigenvalues=_numpy(eigenvalues) if eigenvalues is not None else np.zeros(0),
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str):
    """(Q as a numpy array, iterations) or None if no checkpoint exists."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return z["Q"], int(z["iterations"])


def _segments(solve, A, nev, maxiter, checkpoint_path, checkpoint_every, min_iter,
              verbose, solver_kw):
    """The segment loop both checkpointed solvers share: ``solve(maxiter,
    min_iter, q0)`` runs one segment at the full padded width."""
    m = padded_width(nev, solver_kw.get("block", 8))  # checkpoint the full padded block
    q0 = None
    done = 0
    state = load_checkpoint(checkpoint_path)
    if state is not None:
        q0, done = state
        q0 = torch.as_tensor(q0, dtype=solver_kw.get("dtype") or A.dtype, device=A.device)
        if verbose > 0:
            print(f"checkpoint: resuming at iteration {done}")

    res = None
    while done < maxiter:
        res = solve(m, min(checkpoint_every, maxiter - done), max(0, min_iter - done), q0)
        done += int(res.iterations)
        Q = res.eigenvectors  # (n, m): the full sorted block
        save_checkpoint(checkpoint_path, Q, done, res.eigenvalues)
        if verbose > 0:
            print(
                f"checkpoint: segment done, iterations={done} "
                f"criterion={float(res.criterion):.3e}"
            )
        if bool(res.converged) and done > min_iter:
            break
        q0 = Q
    if res is None:  # maxiter <= done at entry (a fully resumed run)
        res = solve(m, 1, 0, q0)
    return EigenResult(
        eigenvalues=res.eigenvalues[:nev],
        eigenvectors=res.eigenvectors[:, :nev],
        iterations=torch.tensor(done, dtype=torch.int32),
        converged=res.converged,
        criterion=res.criterion,
        ortho_monitor=res.ortho_monitor,
    )


@reporting
def generalized_inverse_checkpointed(
    A,
    B,
    nev: int,
    tol: float,
    maxiter: int,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    shift: float = 0.0,
    reg: float = 0.0,
    min_iter: int = 10,
    inverse: Optional[Callable] = None,
    verbose: int = 0,
    **solver_kw,
) -> EigenResult:
    """``generalized_inverse`` in segments with an on-disk checkpoint after
    each. Same contract as ``generalized_inverse``; if ``checkpoint_path``
    holds a checkpoint of an interrupted run, the solve resumes there. With
    ``inverse=None`` the default engine is factorized once for all
    segments."""
    if inverse is None:
        inverse = prepared_inverse(A, B, shift, reg)

    def solve(m, seg, seg_min_iter, q0):
        return generalized_inverse(
            A, B, nev=m, tol=tol, maxiter=seg, shift=shift, reg=reg,
            min_iter=seg_min_iter, inverse=inverse, q0=q0, **solver_kw,
        )

    return _segments(solve, A, nev, maxiter, checkpoint_path, checkpoint_every, min_iter,
                     verbose, solver_kw)


@reporting
def lobpcg_generalized_checkpointed(
    A,
    B,
    nev: int,
    tol: float,
    maxiter: int,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    shift: float = 0.0,
    reg: float = 0.0,
    min_iter: int = 3,
    precond: Optional[Callable] = None,
    verbose: int = 0,
    **solver_kw,
) -> EigenResult:
    """``lobpcg_generalized`` in segments with an on-disk checkpoint after
    each. LOBPCG's state is (X, P); the checkpoint keeps the Ritz block X
    (the same file format), so a resume starts from X and rebuilds the
    direction P over its first iteration: a step of momentum lost, not
    correctness. Same contract as ``lobpcg_generalized`` otherwise."""

    def solve(m, seg, seg_min_iter, q0):
        return lobpcg_generalized(
            A, B, nev=m, tol=tol, maxiter=seg, shift=shift, reg=reg,
            min_iter=seg_min_iter, precond=precond, q0=q0, **solver_kw,
        )

    return _segments(solve, A, nev, maxiter, checkpoint_path, checkpoint_every, min_iter,
                     verbose, solver_kw)


__all__ = [
    "generalized_inverse_checkpointed",
    "load_checkpoint",
    "lobpcg_generalized_checkpointed",
    "save_checkpoint",
]
