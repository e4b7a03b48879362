"""Weak-scaling measurement over the ranks of the process group.

Counterpart of the JAX package's ``bench/scaling.py``: the rows a rank
holds stay fixed while the mesh grows, and efficiency(P) = t(1) / t(P),
ideal weak scaling keeping the per-iteration time flat (the local work is
constant and the halo volume O(bw * m) a neighbour whatever P).

Every rank of the default group calls these functions (SPMD); mesh size P
is the subgroup of the first P ranks (``dist/mesh.py::make_mesh``), the
others wait for the next size. A time is the slowest member's (an
``all_reduce`` MAX), per application, from ``bench/timing.py::bench_loop``
(CUDA events on the card, the host clock on the CPU). The records come back
on rank 0 (None elsewhere).

On gloo CPU ranks the numbers characterize the host, not a network of
cards; scaling across several GPUs (``torchrun --nproc-per-node=P``) has
not been measured with this port. The reference's two-K slope (``_two_k_
slope``, a tunnel workaround) is not ported.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from dune_eigensolver_tpu_torch.bench.timing import bench_loop
from dune_eigensolver_tpu_torch.dist.mesh import make_mesh
from dune_eigensolver_tpu_torch.dist.sharded import (
    _local_rows,
    _pick_spmm,
    _ShardEngine,
    psum_reduce,
    schwarz_inverse_t,
)
from dune_eigensolver_tpu_torch.sparse import problems
from dune_eigensolver_tpu_torch.utils.device import resolve

# a per-iteration time below this is timer noise, not a time; an efficiency
# against it is reported as nan and excluded from any scaling claim
_EFF_FLOOR = 1e-7


def _efficiency(t1: Optional[float], t: float) -> float:
    if t1 is None or t1 <= _EFF_FLOOR or t <= _EFF_FLOOR:
        return float("nan")
    return t1 / t


def _counts(device_counts):
    world = dist.get_world_size()
    return device_counts or [p for p in (1, 2, 4, 8) if p <= world]


def _side(rows_per_device: int) -> int:
    N = int(np.sqrt(rows_per_device))
    if N * N != rows_per_device:
        raise ValueError("rows_per_device must be a perfect square")
    return N


def _operand(coupling, N, p, dtype, device):
    """p decoupled N x N Laplacians ('islands': exchanged halo rows meet
    zeros) or one N x (N p) Laplacian whose rank cuts carry real couplings
    ('connected')."""
    if coupling == "connected":
        return problems.laplacian_dirichlet_rect(N, N * p, dtype=dtype, device=device)
    return problems.laplacian_islands_2d(N, p, dtype=dtype, device=device)


def _slowest(t: float, mesh, device) -> float:
    x = torch.tensor([t], dtype=torch.float64, device=device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(x.item())


def weak_scaling_spmm(
    rows_per_device: int = 1 << 14,
    m: int = 8,
    n_iter: int = 50,
    device_counts: Optional[List[int]] = None,
    dtype=torch.float32,
    verbose: int = 0,
    coupling: str = "islands",
    spmm: Optional[str] = None,
    device=None,
):
    """Per-iteration time of the sharded SpMM at fixed rows a rank (JAX
    :76), in the mode the solvers dispatch (``spmm``: 'padded' = K1 on a
    CUDA tensor, 'xla' on the CPU). Returns one record per mesh size on
    rank 0."""
    device = resolve(device)
    mode = _pick_spmm(spmm, device)
    N = _side(rows_per_device)
    records, t1 = [], None
    for p in _counts(device_counts):
        mesh = make_mesh(p)
        if not mesh.member:
            continue
        n = rows_per_device * p
        Ap = _operand(coupling, N, p, dtype, device)
        Ap = type(Ap)(data=Ap.data / 8.0, offsets=Ap.offsets, shape=Ap.shape)  # bounded chain
        eng = _ShardEngine([_local_rows(Ap.data, mesh)], [Ap.offsets], mesh, mode)
        apply = eng.apply(0)
        x0 = torch.ones((m, eng.nloc), dtype=dtype, device=device)
        with torch.no_grad():
            best = _slowest(bench_loop(apply, x0, K=n_iter, reps=3), mesh, device)
        if t1 is None:
            t1 = best
        rec = dict(devices=p, rows=n, t_iter=best, efficiency=_efficiency(t1, best), mode=mode,
                   gbps_per_device=(len(Ap.offsets) * n + 2 * n * m) * Ap.data.element_size()
                   / best / 1e9 / p)
        records.append(rec)
        if verbose > 0 and mesh.rank == 0:
            print(f"  P={p} n={n} [{mode}] t={best * 1e6:.0f}us/iter "
                  f"eff={rec['efficiency']:.2f} {rec['gbps_per_device']:.1f} GB/s/dev",
                  flush=True)
    return records if dist.get_rank() == 0 else None


def weak_scaling_solver(
    rows_per_device: int = 1 << 12,
    m: int = 8,
    n_iter: int = 5,
    device_counts: Optional[List[int]] = None,
    dtype=torch.float32,
    verbose: int = 0,
    coupling: str = "connected",
    inner: str = "schwarz",
    inner_iters: int = 10,
    spmm: Optional[str] = None,
    phases: bool = False,
    device=None,
):
    """Weak-scale ONE full generalized-inverse solver iteration (JAX :172):
    the ``_gen_core`` body (B-SpMM, the inner solve at a FIXED iteration
    count so the communication is the same at every P, blocked
    B-orthonormalization, Rayleigh quotients), per mesh size at fixed rows a
    rank. ``phases=True`` also times each phase alone (``t_spmm``,
    ``t_inner``, ``t_ortho``, ``t_rayleigh``)."""
    from dune_eigensolver_tpu_torch.factorize.cg import cg_solve_t
    from dune_eigensolver_tpu_torch.ops.ortho import (
        b_orthonormalize_blocked_t,
        dot_products_diagonal_t,
    )

    device = resolve(device)
    mode = _pick_spmm(spmm, device)
    N = _side(rows_per_device)
    records, t1 = [], None
    for p in _counts(device_counts):
        mesh = make_mesh(p)
        if not mesh.member:
            continue
        n = rows_per_device * p
        Ap = _operand(coupling, N, p, dtype, device).with_shifted_diagonal(1e-3)
        Bp = problems.identity_on_pattern(Ap, dtype=dtype)
        adata = _local_rows(Ap.data, mesh)
        eng = _ShardEngine([adata, _local_rows(Bp.data, mesh)], [Ap.offsets, Bp.offsets],
                           mesh, mode)
        apply_a, apply_b = eng.apply(0), eng.apply(1)
        reduce_ = psum_reduce(mesh)
        if inner == "schwarz":
            solve = schwarz_inverse_t(adata, Ap.offsets, apply_a, reduce_, rtol=1e-30,
                                      maxiter=inner_iters)
        else:
            inv_diag = eng.inv_diag(0)

            def solve(X):
                return cg_solve_t(apply_a, X, inv_diag=inv_diag, rtol=1e-30, maxiter=inner_iters,
                                  gram_reduce=reduce_)[0]

        def b_ortho(Q):
            return b_orthonormalize_blocked_t(apply_b, Q, block=8, gram_reduce=reduce_)[0]

        def full(Q):  # the _gen_core loop body (solvers/generalized.py)
            Q1 = b_ortho(solve(apply_b(Q)))
            reduce_(dot_products_diagonal_t(Q1, apply_a(Q1)))
            return Q1

        def rayleigh(Q):
            reduce_(dot_products_diagonal_t(Q, apply_a(Q)))
            return Q

        bodies = dict(full=full, spmm=apply_b, inner=solve, ortho=b_ortho, rayleigh=rayleigh)
        x0 = torch.ones((m, eng.nloc), dtype=dtype, device=device) / np.sqrt(n)

        def timed(phase):
            with torch.no_grad():
                return _slowest(bench_loop(bodies[phase], x0, K=n_iter, reps=3), mesh, device)

        best = timed("full")
        if t1 is None:
            t1 = best
        rec = dict(devices=p, rows=n, t_iter=best, efficiency=_efficiency(t1, best),
                   inner=inner, mode=mode)
        if phases:
            for ph in ("spmm", "inner", "ortho", "rayleigh"):
                rec[f"t_{ph}"] = timed(ph)
        records.append(rec)
        if verbose > 0 and mesh.rank == 0:
            extra = " ".join(f"{ph}={rec[f't_{ph}'] * 1e6:.0f}us"
                             for ph in ("spmm", "inner", "ortho", "rayleigh") if phases)
            print(f"  P={p} n={n} [{mode}] t={best * 1e6:.0f}us/solver-iter "
                  f"eff={rec['efficiency']:.2f} {extra}", flush=True)
    return records if dist.get_rank() == 0 else None


def scaling_test(ptree, device=None) -> Optional[List[dict]]:
    """CLI protocol (JAX :345): greppable ``SCALING <kind> <mode>
    <coupling> P n t_us eff [phase columns]`` lines from rank 0, the bare
    SpMM sweep and the full solver-iteration sweep, each for both
    couplings. Keys: ``scaling.log2_rows_per_device`` (12),
    ``scaling.n_iter`` (30), ``scaling.solver_n_iter`` (3),
    ``scaling.inner`` (schwarz), ``scaling.spmm`` (auto),
    ``scaling.phases`` (1); ``mv.m``, ``ev.dtype``, ``ev.verbose``."""
    rows = 1 << int(ptree.get("scaling.log2_rows_per_device", 12))
    m = int(ptree["mv.m"])
    spmm_mode = str(ptree.get("scaling.spmm", "")) or None
    dtype = getattr(torch, np.dtype(ptree["ev.dtype"]).name)
    verbose = int(ptree["ev.verbose"])
    rank0 = dist.get_rank() == 0
    out = []
    for coupling in ("islands", "connected"):
        recs = weak_scaling_spmm(rows_per_device=rows, m=m,
                                 n_iter=int(ptree.get("scaling.n_iter", 30)), dtype=dtype,
                                 verbose=verbose, coupling=coupling, spmm=spmm_mode,
                                 device=device)
        for r in recs or ():
            r.update(coupling=coupling, kind="spmm")
            print(f"SCALING spmm {r['mode']} {coupling} {r['devices']} {r['rows']} "
                  f"{r['t_iter'] * 1e6:.0f} {r['efficiency']:.3f}", flush=True)
            out.append(r)
    for coupling in ("islands", "connected"):
        recs = weak_scaling_solver(rows_per_device=rows, m=m,
                                   n_iter=int(ptree.get("scaling.solver_n_iter", 3)),
                                   dtype=dtype, verbose=verbose, coupling=coupling,
                                   inner=str(ptree.get("scaling.inner", "schwarz")),
                                   spmm=spmm_mode,
                                   phases=bool(int(ptree.get("scaling.phases", 1))),
                                   device=device)
        for r in recs or ():
            r.update(coupling=coupling, kind="solver")
            cols = "".join(f" {r[f't_{ph}'] * 1e6:.0f}"
                           for ph in ("spmm", "inner", "ortho", "rayleigh") if f"t_{ph}" in r)
            print(f"SCALING solver {r['mode']} {coupling} {r['devices']} {r['rows']} "
                  f"{r['t_iter'] * 1e6:.0f} {r['efficiency']:.3f}{cols}", flush=True)
            out.append(r)
    return out if rank0 else None
