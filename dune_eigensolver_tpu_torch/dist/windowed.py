"""Row-partitioned execution of GENERAL-sparsity operands: K2 on each
rank's rows.

Counterpart of the JAX package's ``dist/windowed.py`` (the name is kept so
a reader finds it; the TPU's windowed/segment planner itself is not
ported, see ROADMAP). ``dist/sharded.py`` distributes the structured DIA
operand; this module distributes the reference's native operand class,
arbitrary CSR patterns (BSR and DIA inputs become scalar ELL through scipy,
as in JAX :133-141):

* rows split into P equal blocks; after an RCM ordering the bandwidth
  ``halo = max |col - row|`` is bounded, so a rank's SpMM needs only its
  neighbours' boundary rows, the same ``batch_isend_irecv`` exchange as the
  DIA path (``dist/sharded.py::halo_exchange_t``);
* each rank holds its rows as an ``ELLMatrix`` over the halo-EXTENDED
  column space ``[r0 - halo, r1 + halo)``: the input of the hand-written ELL
  kernel K2 (``csrc/ell_spmm.cu``), with its ``warp_slots`` and
  ``kernel_streams``. Every rank builds only its own plan; no unification
  is needed, because nothing has to be one static program across ranks;
* ``windowed_spmm_halo_t`` has the reference's two forms. Serialized: the
  exchange, then K2 on the extended X. Overlapped (when the halo is at
  most ``_BND_DENSE_CAP``): K2 on the local lanes (halo slabs zero) while
  the exchange is in flight, then two boundary products with the dense
  ``(halo, halo)`` blocks ``(A_l, A_r)``, f32 ``torch.matmul`` with TF32
  off (JAX :404-409 computes them outside its kernel too);
* row counts that P does not divide are padded with decoupled rows
  (``diag_fill`` on the diagonal), as the DIA drivers pad.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from dune_eigensolver_tpu_torch.dist.mesh import Mesh, check_device, make_mesh
from dune_eigensolver_tpu_torch.dist.sharded import (
    _finish,
    _gather_result,
    _start_exchange,
    halo_exchange_t,
    psum_reduce,
)
from dune_eigensolver_tpu_torch.sparse.formats import (
    BSRMatrix,
    DIAMatrix,
    ELLMatrix,
    dia_from_scipy,
    ell_from_scipy,
)
from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t

# dense boundary blocks cost halo^2 values per side; past this the overlap
# costs more memory than it hides and the drivers serialize exchange ->
# kernel (the reference's cap)
_BND_DENSE_CAP = 2048


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One rank's share of a row-partitioned general operand (JAX
    ``WindowedShardPlan``, per rank).

    ``ell``: the rank's rows (nloc, nloc + 2*halo) over the extended
    columns. ``bnd_left``/``bnd_right``: the dense (halo, halo) blocks of
    the entries whose columns are in the left/right exchanged slab (None
    past ``_BND_DENSE_CAP`` or at halo 0). ``diag``: the local main
    diagonal (JAX ``_shard_diag``, :416). ``band``: the rank's diagonal
    block as a DIA operand (the Schwarz factorization), or None."""

    ell: ELLMatrix
    bnd_left: Optional[torch.Tensor]
    bnd_right: Optional[torch.Tensor]
    diag: torch.Tensor
    band: Optional[DIAMatrix]
    halo: int
    nloc: int
    n: int  # global rows after padding (nloc * size)
    n_logical: int  # rows of the operand as given
    rank: int
    size: int

    @property
    def rows(self) -> int:
        return self.n_logical

    @property
    def dtype(self) -> torch.dtype:
        return self.ell.dtype


def _to_scipy(A):
    import scipy.sparse as sp

    if isinstance(A, (ELLMatrix, BSRMatrix, DIAMatrix)):
        return A.to_scipy().tocsr()
    if sp.issparse(A):
        return A.tocsr()
    raise TypeError(f"windowed_shard_plan: unsupported operand {type(A)}")


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=np_dtype)).dtype


def windowed_shard_plan(A, P_shards: int, rank: int, device=None, diag_fill: float = 1.0,
                        local_band: bool = False) -> ShardPlan:
    """Host-side planning of rank ``rank``'s share of ``A`` split P_shards
    ways (JAX :143): pad a row count that P does not divide with decoupled
    rows (``diag_fill`` on their diagonal: 1.0 for operators, 0.0 for mass
    matrices), check the bandwidth against the local rows, and build the
    rank's extended-column ELL, boundary blocks, diagonal and (``local_band``)
    diagonal band block on ``device``."""
    if not 0 <= rank < P_shards:
        raise ValueError(f"windowed_shard_plan: rank {rank} outside [0, {P_shards})")
    return windowed_shard_plans(A, P_shards, device, diag_fill, local_band, ranks=(rank,))[0]


def windowed_shard_plans(A, P_shards: int, device=None, diag_fill: float = 1.0,
                         local_band: bool = False, ranks=None):
    """``windowed_shard_plan`` for each rank of ``ranks`` (default all),
    the operand split and checked once."""
    import scipy.sparse as sp

    from dune_eigensolver_tpu_torch.utils.device import resolve

    device = resolve(device)
    S = _to_scipy(A)
    if S.shape[0] != S.shape[1]:
        raise ValueError("windowed_shard_plan: operator must be square")
    n_logical = n = S.shape[0]
    if n % P_shards:
        n = -(-n // P_shards) * P_shards
        coo = S.tocoo()
        rows, cols, vals = coo.row, coo.col, coo.data
        if diag_fill != 0.0:
            pr = np.arange(n_logical, n)
            rows = np.concatenate([rows, pr])
            cols = np.concatenate([cols, pr])
            vals = np.concatenate([vals, np.full(n - n_logical, diag_fill, dtype=vals.dtype)])
        S = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    nloc = n // P_shards
    coo = S.tocoo()
    halo = int(np.abs(coo.col.astype(np.int64) - coo.row).max()) if coo.nnz else 0
    del coo
    if halo > nloc:
        raise ValueError(
            f"windowed_shard_plan: bandwidth {halo} exceeds local rows {nloc}; use "
            "fewer ranks or reorder (RCM) first"
        )
    if halo > _BND_DENSE_CAP:
        from dune_eigensolver_tpu_torch.utils.vlog import warn_fallback

        warn_fallback(
            f"windowed_shard_plan: halo {halo} > {_BND_DENSE_CAP}: no dense boundary "
            "blocks, the halo exchange serializes before the kernel on this operand"
        )
    return [_rank_plan(S, r, P_shards, nloc, halo, n, n_logical, device, local_band)
            for r in (range(P_shards) if ranks is None else ranks)]


def _rank_plan(S, rank, P_shards, nloc, halo, n, n_logical, device, local_band):
    import scipy.sparse as sp

    from dune_eigensolver_tpu_torch.factorize.banded import BANDED_BW_MAX

    dtype = _torch_dtype(S.dtype)
    r0 = rank * nloc
    Sl = S[r0:r0 + nloc, :].tocoo()
    cols_ext = Sl.col.astype(np.int64) - (r0 - halo)  # all in [0, nloc + 2*halo)
    Sl_ext = sp.coo_matrix((Sl.data, (Sl.row, cols_ext)), shape=(nloc, nloc + 2 * halo)).tocsr()
    bnd_left = bnd_right = None
    if 0 < halo <= _BND_DENSE_CAP:
        bnd_left = torch.from_numpy(Sl_ext[:halo, :halo].toarray()).to(device)
        bnd_right = torch.from_numpy(Sl_ext[nloc - halo:, halo + nloc:].toarray()).to(device)
    block = S[r0:r0 + nloc, r0:r0 + nloc]
    diag = torch.from_numpy(np.ascontiguousarray(block.diagonal())).to(device)
    band = None
    if local_band:
        if halo > BANDED_BW_MAX:
            from dune_eigensolver_tpu_torch.utils.vlog import warn_fallback

            warn_fallback(
                f"windowed_shard_plan: local bandwidth {halo} > {BANDED_BW_MAX}: no "
                "per-rank banded block (Schwarz unavailable; inner='cg')"
            )
        else:
            band = dia_from_scipy(block, dtype=dtype, device=device)
    return ShardPlan(
        ell=ell_from_scipy(Sl_ext, dtype=dtype, device=device),
        bnd_left=bnd_left, bnd_right=bnd_right, diag=diag, band=band, halo=halo,
        nloc=nloc, n=n, n_logical=n_logical, rank=rank, size=P_shards,
    )


def windowed_local_apply_t(plan: ShardPlan, x_local: torch.Tensor, from_left=None,
                           from_right=None, overlap: Optional[bool] = None) -> torch.Tensor:
    """The local half of ``windowed_spmm_halo_t``: the rank's rows of
    ``(A @ X)^T`` given its neighbours' slabs (None: zeros, an unsplit
    operand or world size 1). ``overlap`` (default: when the plan has
    boundary blocks) picks the form: K2 on the zero-extended local lanes
    plus the two boundary products; else K2 on the extended X. Needs no
    collective, so one process can feed each rank of a split operand."""
    halo = plan.halo
    if overlap is None:
        overlap = plan.bnd_left is not None
    if overlap and plan.bnd_left is None and halo > 0:
        raise ValueError("windowed_local_apply_t: the plan has no boundary blocks to overlap")
    if halo == 0:
        return spmm_t(plan.ell, x_local)
    if not overlap:
        m = x_local.shape[0]
        if from_left is None:
            from_left = torch.zeros((m, halo), dtype=x_local.dtype, device=x_local.device)
            from_right = from_left
        return spmm_t(plan.ell, torch.cat([from_left, x_local, from_right], dim=1))
    Y = spmm_t(plan.ell, F.pad(x_local, (halo, halo)))
    if from_left is not None:
        _boundary_terms(Y, plan, from_left, from_right)
    return Y


def _boundary_terms(Y, plan, from_left, from_right):
    nloc, halo = plan.nloc, plan.halo
    Y[:, :halo] += torch.matmul(from_left, plan.bnd_left.T)
    Y[:, nloc - halo:] += torch.matmul(from_right, plan.bnd_right.T)
    return Y


def windowed_spmm_halo_t(plan: ShardPlan, x_local: torch.Tensor, mesh: Mesh,
                         overlap: Optional[bool] = None) -> torch.Tensor:
    """Local rows of ``(A @ X)^T`` for the row-sharded general operand
    (JAX :368); x_local (m, nloc). Overlapped (the default where the plan
    has boundary blocks): the exchange is posted first, K2 reads only the
    local lanes while it is in flight, and the boundary products alone
    wait for the slabs. Serialized: the exchange completes, then K2 reads
    the extended X."""
    halo = plan.halo
    if overlap is None:
        overlap = plan.bnd_left is not None
    if halo == 0:
        return spmm_t(plan.ell, x_local)
    if not overlap:
        return spmm_t(plan.ell, halo_exchange_t(x_local, halo, mesh))
    if mesh.size == 1:
        return windowed_local_apply_t(plan, x_local, overlap=True)
    from_left, from_right, pending = _start_exchange(x_local, halo, mesh)
    Y = spmm_t(plan.ell, F.pad(x_local, (halo, halo)))
    _finish(pending)
    return _boundary_terms(Y, plan, from_left, from_right)


def largest_operator(A, shift: float = 0.0):
    """The (shifted) operator ``sharded_standard_largest_general`` plans
    (JAX :466): prebuild its plan with ``windowed_shard_plan(
    largest_operator(A, shift), P, rank)`` and pass ``plan=`` to reuse it."""
    import scipy.sparse as sp

    S = _to_scipy(A)
    if shift != 0.0:
        S = (S + shift * sp.eye(S.shape[0], dtype=S.dtype)).tocsr()
    return S


def pencil_operator(A, B, shift: float = 0.0, reg: float = 0.0):
    """The shift-folded operator A + shift*B + reg*I the general pencil
    drivers plan (JAX :480)."""
    import scipy.sparse as sp

    S = _to_scipy(A)
    Sb = None if B is None else _to_scipy(B)
    n = S.shape[0]
    if shift != 0.0:
        S = S + shift * (sp.eye(n, dtype=S.dtype) if Sb is None else Sb)
    if reg != 0.0:
        S = S + reg * sp.eye(n, dtype=S.dtype)
    return S.tocsr()


def _q0_general(seed, plan: ShardPlan, m: int, mesh: Mesh, q0=None) -> torch.Tensor:
    """This rank's lanes of the start block over the logical rows, pad
    lanes exactly zero (JAX :429, ``dist/sharded.py::_random_q0_t``)."""
    from dune_eigensolver_tpu_torch.dist.sharded import _random_q0_t

    return _random_q0_t(seed, plan.rows, plan.n, m, mesh, plan.dtype, q0)


def _mesh_for(A, mesh, what):
    mesh = mesh or make_mesh()
    device = getattr(A, "device", None)
    if device is not None:
        check_device(mesh, device, what)
    else:
        check_device(mesh, mesh.device, what)
    return mesh


def _plan_for(objs, mesh, key, build):
    """``build()`` memoized on the operands' identities and ``key`` (JAX
    memoizes its plans the same way): a repeated solve on the same
    operands skips the host planning and upload."""
    from dune_eigensolver_tpu_torch.solvers.engine import memoized_setup

    return memoized_setup(objs, key + (mesh.size, mesh.rank, str(mesh.device)), build)


def _schwarz_factor(plan: ShardPlan):
    from dune_eigensolver_tpu_torch.factorize.banded import banded_solve_t, factorize_banded_device

    Fct = factorize_banded_device(plan.band)
    return lambda R: banded_solve_t(Fct, R)


def sharded_standard_largest_general(
    A,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    mesh: Optional[Mesh] = None,
    block: int = 8,
    seed: int = 123,
    ortho_iterations: int = 1,
    rayleigh_ritz: bool = False,
    plan: Optional[ShardPlan] = None,
    q0: Optional[torch.Tensor] = None,
):
    """Multi-rank ``standard_largest`` on a GENERAL (ELL/BSR/DIA/scipy)
    operand through K2 (JAX :495). ``shift`` is folded into the plan on the
    host. ``plan``: this rank's prebuilt ``windowed_shard_plan(
    largest_operator(A, shift), size, rank)``."""
    from dune_eigensolver_tpu_torch.solvers.standard import _core, padded_width

    mesh = _mesh_for(A, mesh, "sharded_standard_largest_general")
    if plan is None:
        plan = _plan_for((A,), mesh, ("win_plan_largest", float(shift)),
                         lambda: windowed_shard_plan(largest_operator(A, shift), mesh.size,
                                                     mesh.rank, mesh.device))
    if plan.size != mesh.size or plan.rank != mesh.rank:
        raise ValueError("plan does not match the mesh")
    m = padded_width(nev, block)
    Q0 = _q0_general(seed, plan, m, mesh, q0)

    def apply_a(X):
        return windowed_spmm_halo_t(plan, X, mesh)

    with torch.no_grad():
        res = _core(apply_a, apply_a, Q0, nev, float(tol), int(maxiter), float(shift),
                    int(block), int(ortho_iterations), bool(rayleigh_ritz), descending=True,
                    gram_reduce=psum_reduce(mesh))
        return _gather_result(res, mesh, plan.rows)


def sharded_lobpcg_general(
    A,
    B=None,
    nev: int = 8,
    tol: float = 2e-3,
    maxiter: int = 200,
    shift: float = 1e-3,
    reg: float = 0.0,
    mesh: Optional[Mesh] = None,
    block: int = 8,
    seed: int = 123,
    min_iter: int = 3,
    ortho_eps: float = 1e-9,
    cg_rtol: float = 1e-2,
    cg_maxiter: int = 50,
    ortho_block=None,
    plans=None,
    precond: str = "cg",
    q0: Optional[torch.Tensor] = None,
):
    """Multi-rank preconditioned LOBPCG (smallest eigenpairs) on a GENERAL
    operand pair (JAX :581). ``B=None`` is the identity pencil.
    ``precond``: 'cg' (per-rank Jacobi-CG on the shifted operator, its dots
    all-reduced) or 'schwarz' (one exact banded solve of the rank's
    diagonal block per apply; 'cg' with a ``FALLBACK:`` line past the
    device band ceiling). ``plans``: this rank's prebuilt ``(plan_a,
    plan_b)`` (plan_a over ``pencil_operator(A, B, shift, reg)``, with
    ``local_band=True`` for 'schwarz'; plan_b over B with ``diag_fill=0``,
    or None)."""
    from dune_eigensolver_tpu_torch.factorize.cg import cg_solve_t
    from dune_eigensolver_tpu_torch.solvers.lobpcg import _lobpcg_core
    from dune_eigensolver_tpu_torch.solvers.standard import padded_width

    if precond not in ("cg", "schwarz"):
        raise ValueError(f"unknown precond {precond!r} (cg|schwarz)")
    mesh = _mesh_for(A, mesh, "sharded_lobpcg_general")
    m = padded_width(nev, block)
    if plans is None:
        def build():
            pa = windowed_shard_plan(pencil_operator(A, B, shift, reg), mesh.size, mesh.rank,
                                     mesh.device, local_band=(precond == "schwarz"))
            pb = None if B is None else windowed_shard_plan(
                _to_scipy(B), mesh.size, mesh.rank, mesh.device, diag_fill=0.0)
            return pa, pb

        plans = _plan_for((A,) if B is None else (A, B), mesh,
                          ("win_plan_lobpcg", float(shift), float(reg), precond), build)
    plan_a, plan_b = plans
    if precond == "schwarz" and plan_a.band is None:
        precond = "cg"  # the plan has warned (bandwidth past the device ceiling)
    Q0 = _q0_general(seed, plan_a, m, mesh, q0)
    reduce_ = psum_reduce(mesh)

    def apply_a(X):
        return windowed_spmm_halo_t(plan_a, X, mesh)

    if plan_b is None:
        def apply_b(X):
            return X
    else:
        def apply_b(X):
            return windowed_spmm_halo_t(plan_b, X, mesh)

    with torch.no_grad():
        if precond == "schwarz":
            solve = _schwarz_factor(plan_a)

            def prec_fn(_aux, X):
                return solve(X)
        else:
            inv_diag = 1.0 / plan_a.diag

            def prec_fn(_aux, X):
                Y, _ = cg_solve_t(apply_a, X, inv_diag=inv_diag, rtol=cg_rtol,
                                  maxiter=cg_maxiter, gram_reduce=reduce_)
                return Y

        res = _lobpcg_core(
            apply_a, apply_b, None, prec_fn, Q0, nev, float(tol), int(maxiter), float(shift),
            int(min_iter), float(ortho_eps), 2,
            "full" if ortho_block == "full" else int(ortho_block or block),
            gram_reduce=reduce_,
        )
        return _gather_result(res, mesh, plan_a.rows)


def sharded_generalized_inverse_general(
    A,
    B,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    reg: float = 0.0,
    mesh: Optional[Mesh] = None,
    block: int = 8,
    seed: int = 123,
    min_iter: int = 10,
    ortho_iterations: int = 1,
    rayleigh_ritz: bool = False,
    cg_rtol: float = 1e-6,
    cg_maxiter: int = 2000,
    inner: str = "schwarz",
    plans=None,
    q0: Optional[torch.Tensor] = None,
):
    """Multi-rank ``generalized_inverse`` (shift-invert subspace iteration)
    on a GENERAL operand pair through K2 (JAX :749). ``inner='schwarz'``
    (default): the global CG on the shifted operator preconditioned by
    exact per-rank banded block solves (the block solve alone at world
    size 1); 'cg' with a ``FALLBACK:`` line past the device band ceiling.
    ``inner='cg'``: plain Jacobi-CG. ``plans``: this rank's prebuilt
    ``(plan_a, plan_b)``."""
    from dune_eigensolver_tpu_torch.factorize.cg import cg_solve_t
    from dune_eigensolver_tpu_torch.solvers.generalized import _gen_core
    from dune_eigensolver_tpu_torch.solvers.standard import padded_width

    if inner not in ("schwarz", "cg"):
        raise ValueError(f"unknown inner engine {inner!r} (schwarz|cg)")
    mesh = _mesh_for(A, mesh, "sharded_generalized_inverse_general")
    m = padded_width(nev, block)
    if plans is None:
        def build():
            return (
                windowed_shard_plan(pencil_operator(A, B, shift, reg), mesh.size, mesh.rank,
                                    mesh.device, local_band=(inner == "schwarz")),
                windowed_shard_plan(_to_scipy(B), mesh.size, mesh.rank, mesh.device,
                                    diag_fill=0.0),
            )

        plans = _plan_for((A, B), mesh, ("win_plan_gen", float(shift), float(reg), inner),
                          build)
    plan_a, plan_b = plans
    if inner == "schwarz" and plan_a.band is None:
        inner = "cg"  # the plan has warned (bandwidth past the device ceiling)
    Q0 = _q0_general(seed, plan_a, m, mesh, q0)
    reduce_ = psum_reduce(mesh)

    def apply_a(X):
        return windowed_spmm_halo_t(plan_a, X, mesh)

    def apply_b(X):
        return windowed_spmm_halo_t(plan_b, X, mesh)

    with torch.no_grad():
        if inner == "schwarz":
            precond = _schwarz_factor(plan_a)
            if mesh.size == 1:
                def inv_fn(_aux, X):
                    return precond(X)
            else:
                def inv_fn(_aux, X):
                    Y, _ = cg_solve_t(apply_a, X, rtol=cg_rtol, maxiter=cg_maxiter,
                                      gram_reduce=reduce_, precond_apply=precond)
                    return Y
        else:
            inv_diag = 1.0 / plan_a.diag

            def inv_fn(_aux, X):
                Y, _ = cg_solve_t(apply_a, X, inv_diag=inv_diag, rtol=cg_rtol,
                                  maxiter=cg_maxiter, gram_reduce=reduce_)
                return Y

        res = _gen_core(apply_a, apply_b, None, inv_fn, Q0, nev, float(tol), int(maxiter),
                        float(shift), int(block), int(min_iter), int(ortho_iterations),
                        bool(rayleigh_ritz), gram_reduce=reduce_)
        return _gather_result(res, mesh, plan_a.rows)

