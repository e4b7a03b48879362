"""Spawned CPU ranks on gloo, and the multi-rank dry run.

``RankPool`` starts n processes once, each a gloo rank of one process
group on a ``FileStore`` in a temporary directory, and runs module-level
functions on all of them (SPMD): every rank calls ``fn(*args)``, rank 0's
return value comes back (numpy arrays and plain Python values travel; keep
tensors out of it). A rank that raises sends its traceback, and ``run``
raises it; collectives time out after ``timeout`` seconds, so a rank left
waiting for a failed one raises too instead of hanging.

``split_dia_apply_t`` and ``split_windowed_apply_t`` play P ranks in one
process: each rank's local apply (K1 or K2 on its rows, then the edge or
boundary terms) fed with the slabs its neighbours would send, the results
concatenated. No collective runs, so a single card checks the P-way split
of an operand against the global kernel.

``dryrun_multichip(n)`` is the counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip`` (:58-214): the four sharded DIA
drivers, the sharded MG preconditioner, a row count the world size does not
divide, and the general-sparsity drivers, at tiny shapes on n gloo ranks,
each checked finite, of the expected shape and (where the reference checks
it) equal to the single-process solver.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import traceback
from typing import Optional

import numpy as np


def _rank_main(rank, world, store_path, inbox, outbox, threads, timeout):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
    except BaseException:
        outbox.put((rank, False, traceback.format_exc()))
        return
    outbox.put((rank, True, "ready"))
    while True:
        job = inbox.get()
        if job is None:
            break
        fn, args, kw = job
        try:
            out = fn(*args, **kw)
            outbox.put((rank, True, out if rank == 0 else None))
        except BaseException:
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """n gloo ranks in spawned processes (module docstring). Use as a
    context manager, or call ``close``."""

    def __init__(self, n: int, threads: int = 1, timeout: float = 120.0,
                 store_dir: Optional[str] = None):
        self.n = int(n)
        self.timeout = float(timeout)
        self._own_dir = store_dir is None
        self.store_dir = tempfile.mkdtemp(prefix="rankpool_") if store_dir is None else store_dir
        ctx = multiprocessing.get_context("spawn")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(self.n)]
        store_path = os.path.join(self.store_dir, "store")
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, self.n, store_path, self._inboxes[r], self._outbox,
                              int(threads), self.timeout))
            for r in range(self.n)
        ]
        for p in self._procs:
            p.start()
        try:
            self._collect("start")
        except BaseException:
            self.close()
            raise

    def _get(self, what):
        """The next answer; raises once a rank has died or the collectives'
        timeout (plus a minute) has passed without one."""
        waited = 0.0
        while True:
            try:
                return self._outbox.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
            dead = [r for r, p in enumerate(self._procs) if p.exitcode is not None]
            if dead or waited > self.timeout + 60:
                raise RuntimeError(
                    f"RankPool: no answer from every rank for {what}"
                    + (f": rank(s) {dead} exited" if dead else f" within {waited:.0f} s"))

    def _collect(self, what):
        results, errors = {}, []
        for _ in range(self.n):
            rank, ok, out = self._get(what)
            if ok:
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
        if errors:
            raise RuntimeError(f"RankPool: {what} failed on {len(errors)} rank(s):\n"
                               + "\n".join(errors))
        return results[0]

    def run(self, fn, *args, **kw):
        """``fn(*args, **kw)`` on every rank; rank 0's return value. ``fn``
        must be a module-level function that the spawned processes can
        import."""
        for box in self._inboxes:
            box.put((fn, args, kw))
        return self._collect(getattr(fn, "__name__", "job"))

    def close(self):
        for box, p in zip(self._inboxes, self._procs):
            if p.is_alive():
                box.put(None)
        for p in self._procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()
                p.join()
        if self._own_dir:
            shutil.rmtree(self.store_dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _slabs(Xp, r, nloc, halo):
    """Rank r's lanes of the padded (m, n_pad) block and the slabs its
    neighbours send (zeros at the edges)."""
    import torch

    m, n_pad = Xp.shape
    r0, r1 = r * nloc, (r + 1) * nloc
    zero = torch.zeros((m, halo), dtype=Xp.dtype, device=Xp.device)
    left = Xp[:, r0 - halo:r0].contiguous() if r0 > 0 else zero
    right = Xp[:, r1:r1 + halo].contiguous() if r1 < n_pad else zero
    return Xp[:, r0:r1].contiguous(), left, right


def split_dia_apply_t(A, Xt, P: int):
    """(A @ X)^T from P ranks' K1-route local applies
    (``dist/sharded.py::dia_local_apply_t``), rows padded as the drivers
    pad them; the logical rows returned."""
    import torch
    import torch.nn.functional as F

    from dune_eigensolver_tpu_torch.dist import sharded

    n = A.shape[0]
    n_pad = sharded._padded_rows(n, P)
    Ap = sharded._pad_rows_dia(A, n_pad, 1.0)
    Xp = F.pad(Xt, (0, n_pad - n))
    nloc = n_pad // P
    halo = sharded._halo_of(A.offsets, nloc, "split_dia_apply_t")
    out = []
    for r in range(P):
        x, left, right = _slabs(Xp, r, nloc, halo)
        op = sharded.local_operand(Ap.data[:, r * nloc:(r + 1) * nloc].contiguous(), A.offsets)
        out.append(sharded.dia_local_apply_t(op, x, left, right) if halo else
                   sharded.dia_local_apply_t(op, x))
    return torch.cat(out, dim=1)[:, :n]


def split_windowed_apply_t(S, Xt, P: int, overlap: bool, plans=None):
    """(S @ X)^T from P ranks' K2 local applies
    (``dist/windowed.py::windowed_local_apply_t``) in the form asked for;
    ``plans``: the ranks' ``windowed_shard_plan``s (built on Xt's device
    when None). Returns (Y, plans)."""
    import torch
    import torch.nn.functional as F

    from dune_eigensolver_tpu_torch.dist import windowed

    if plans is None:
        plans = windowed.windowed_shard_plans(S, P, Xt.device)
    p0 = plans[0]
    Xp = F.pad(Xt, (0, p0.n - p0.rows))
    out = []
    for r, plan in enumerate(plans):
        x, left, right = _slabs(Xp, r, plan.nloc, plan.halo)
        out.append(windowed.windowed_local_apply_t(plan, x, left, right, overlap=overlap))
    return torch.cat(out, dim=1)[:, :p0.rows], plans


def _finite(res, rows, nev):
    ev = res.eigenvalues.numpy()
    assert ev.shape == (nev,) and np.isfinite(ev).all(), ev
    assert tuple(res.eigenvectors.shape) == (rows, nev), tuple(res.eigenvectors.shape)
    return ev


def _dryrun_case(n_ranks: int) -> dict:
    """The dry run's body on every rank (shapes as in the reference's
    dry run, f32 on the CPU)."""
    import scipy.sparse as sp
    import torch

    from dune_eigensolver_tpu_torch.dist import (
        make_mesh,
        sharded_generalized_inverse,
        sharded_generalized_inverse_general,
        sharded_lobpcg_generalized,
        sharded_standard_inverse,
        sharded_standard_largest,
        sharded_standard_largest_general,
    )
    from dune_eigensolver_tpu_torch.solvers import standard_largest
    from dune_eigensolver_tpu_torch.sparse import problems

    f32, cpu = torch.float32, "cpu"
    mesh = make_mesh(n_ranks)
    N = max(16, 4 * n_ranks)
    N = -(-N // n_ranks) * n_ranks
    A = problems.laplacian_neumann_2d(N, dtype=f32, device=cpu)
    B = problems.laplacian_b_2d(N, 3, dtype=f32, device=cpu)
    out = {}
    res = sharded_generalized_inverse(A, B, nev=8, tol=1e-2, maxiter=12, shift=1e-3, mesh=mesh,
                                      min_iter=1, cg_rtol=1e-3, cg_maxiter=50)
    out["generalized_inverse"] = _finite(res, N * N, 8)
    res = sharded_lobpcg_generalized(A, B, nev=8, tol=1e-2, maxiter=8, shift=1e-3, mesh=mesh,
                                     min_iter=1, cg_maxiter=25)
    out["lobpcg_cg"] = _finite(res, N * N, 8)
    # the sharded V-cycle: a structured stencil with >= 4 slab planes a rank
    A_mg = problems.laplacian_dirichlet_2d(N, dtype=f32, device=cpu)
    res = sharded_lobpcg_generalized(A_mg, problems.identity_on_pattern(A_mg), nev=4, tol=1e-2,
                                     maxiter=6, shift=1e-3, mesh=mesh, min_iter=1, precond="mg")
    out["lobpcg_mg"] = _finite(res, N * N, 4)
    # the K1 route (K1's plain version on the CPU)
    res = sharded_generalized_inverse(A, B, nev=8, tol=1e-2, maxiter=6, shift=1e-3, mesh=mesh,
                                      min_iter=1, cg_rtol=1e-3, cg_maxiter=25, spmm="padded")
    out["generalized_inverse_padded"] = _finite(res, N * N, 8)
    # a row count the world size does not divide: N * (N - 1)
    A_nd = problems.laplacian_dirichlet_rect(N, N - 1, dtype=f32, device=cpu)
    res = sharded_standard_largest(A_nd, nev=4, tol=1e-4, maxiter=100, mesh=mesh)
    out["largest_nondivisible"] = _finite(res, N * (N - 1), 4)
    # sharded against single-process, same seed
    res_s = sharded_standard_largest(A_mg, nev=4, tol=1e-8, maxiter=300, mesh=mesh)
    res_1 = standard_largest(A_mg, nev=4, tol=1e-8, maxiter=300)
    ev_s, ev_1 = _finite(res_s, N * N, 4), res_1.eigenvalues.numpy()
    assert np.abs(ev_s - ev_1).max() < 1e-4, (ev_s, ev_1)
    out["largest"] = ev_s
    res = sharded_standard_inverse(A_mg, nev=4, tol=1e-2, maxiter=12, shift=1e-3, mesh=mesh,
                                   cg_rtol=1e-3, cg_maxiter=50, inner="schwarz")
    out["standard_inverse"] = _finite(res, N * N, 4)
    # the general-sparsity path: a banded random operator through K2's plain version
    ng = -(-1024 // n_ranks) * n_ranks
    rng = np.random.default_rng(7)
    nz = 3 * ng
    r = rng.integers(0, ng, nz)
    c = np.clip(r + rng.integers(-40, 41, nz), 0, ng - 1)
    i = np.arange(ng - 1)
    Sg = sp.coo_matrix(
        (np.concatenate([-np.abs(rng.normal(size=nz)), -np.ones(ng - 1)]),
         (np.concatenate([r, i]), np.concatenate([c, i + 1]))), shape=(ng, ng)).tocsr()
    Sg = Sg + Sg.T
    Sg = Sg - sp.diags(Sg.diagonal())
    Sg = (Sg + sp.diags(np.asarray(-Sg.sum(axis=1)).ravel() + 0.5)).astype(np.float32)
    res = sharded_standard_largest_general(Sg, nev=4, tol=1e-6, maxiter=200, mesh=mesh)
    out["largest_general"] = _finite(res, ng, 4)
    res = sharded_generalized_inverse_general(
        Sg, sp.eye(ng, dtype=np.float32, format="csr"), nev=4, tol=1e-2, maxiter=10,
        shift=1e-3, mesh=mesh, cg_rtol=1e-4, cg_maxiter=100, inner="schwarz", min_iter=1)
    out["generalized_inverse_general"] = _finite(res, ng, 4)
    return out


def dryrun_multichip(n_devices: int) -> dict:
    """The sharded drivers at tiny shapes on ``n_devices`` spawned gloo CPU
    ranks (module docstring); raises on any failure, returns rank 0's
    eigenvalues by case."""
    with RankPool(n_devices) as pool:
        return pool.run(_dryrun_case, int(n_devices))


if __name__ == "__main__":
    import sys

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    for name, ev in dryrun_multichip(n).items():
        print(f"{name}: {np.array2string(np.asarray(ev), precision=6)}")
    print(f"dryrun_multichip({n}) ok")
