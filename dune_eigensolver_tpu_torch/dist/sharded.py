"""Row-partitioned execution of the DIA solvers on ``torch.distributed``:
halo-exchange SpMM, all-reduced Grams, and the sharded drivers.

Counterpart of the JAX package's ``dist/sharded.py``. There the whole
solve is one ``shard_map`` over a 1D device mesh in one process; here it
runs SPMD, one process per rank (``dist/mesh.py``):

* every rank calls the same driver with the same global operand and takes
  its own rows, ``r0:r1`` of each diagonal (rows that the world size does
  not divide are padded with decoupled identity rows, as in the reference);
* the solver cores run unchanged on the rank's local (m, nloc) block with
  three hooks: ``apply_a``/``apply_b`` (the halo SpMM below),
  ``gram_reduce`` (one ``all_reduce`` SUM of each Gram, dot and convergence
  quantity, so every rank takes the same decisions) and the inner solve or
  preconditioner;
* a SpMM needs the neighbours' boundary rows up to the bandwidth: each rank
  sends its first/last ``halo`` lanes to its neighbours with
  ``batch_isend_irecv`` (non-cyclic: the edge ranks keep zeros, the
  Dirichlet zero padding the local kernel reads anyway);
* ``spmm='padded'`` (the default on a CUDA tensor) runs the hand-written DIA
  kernel K1 (``csrc/dia_spmm.cu``) on the local block while the exchange is
  in flight, then adds the O(halo) edge terms from the received slabs
  (``padded_spmm_halo_t``; JAX ``padded_spmm_halo``, :143-192). On a CPU
  tensor it runs K1's plain version, as every kernel of the port does.
  ``spmm='xla'`` is the reference's slice formulation (``dia_spmm_halo_t``),
  the CPU default. A route asked for is the route taken;
* the drivers return the JAX drivers' ``EigenResult``, the eigenvectors the
  global (n, nev) block assembled with ``all_gather`` on every rank (the
  JAX ``out_specs`` ``P(axis, None)``) with the pad rows sliced off.

``COUNTS`` tallies the collectives this module and ``dist/mg.py`` issue
(``all_reduce``, ``all_gather``, ``halo_exchange``); a caller zeroes it
around a run.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dune_eigensolver_tpu_torch.dist.mesh import Mesh, check_device, make_mesh
from dune_eigensolver_tpu_torch.sparse.formats import DIAMatrix
from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t

#: collectives issued since the caller last cleared it, by kind
COUNTS: collections.Counter = collections.Counter()


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def psum_reduce(mesh: Mesh):
    """The ``gram_reduce`` hook: an ``all_reduce`` SUM over the mesh (JAX
    ``lax.psum``). Every rank gets the same bits, so every rank takes the
    same branch at every host-side stopping test."""

    def reduce_(g):
        g = g.contiguous()
        dist.all_reduce(g, group=mesh.group)
        COUNTS["all_reduce"] += 1
        return g

    return reduce_


def all_gather_cat(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each) concatenated along ``dim``
    in rank order (JAX ``lax.all_gather(..., tiled=True)``)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    COUNTS["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def _start_exchange(x_local: torch.Tensor, halo: int, mesh: Mesh):
    """Post the halo sends and receives: this rank's first ``halo`` lanes to
    its left neighbour, its last ``halo`` to its right one. Returns
    ``(from_left, from_right, pending)``; the slabs are valid once every
    request of ``pending`` has been waited on (``_finish``). An edge rank's
    missing slab stays zero."""
    m = x_local.shape[0]
    r, P = mesh.rank, mesh.size
    from_left = torch.zeros((m, halo), dtype=x_local.dtype, device=x_local.device)
    from_right = torch.zeros_like(from_left)
    ops, keep = [], []
    if r > 0:
        keep.append(x_local[:, :halo].contiguous())
        ops.append(dist.P2POp(dist.isend, keep[-1], mesh.ranks[r - 1], mesh.group))
        ops.append(dist.P2POp(dist.irecv, from_left, mesh.ranks[r - 1], mesh.group))
    if r < P - 1:
        keep.append(x_local[:, -halo:].contiguous())
        ops.append(dist.P2POp(dist.isend, keep[-1], mesh.ranks[r + 1], mesh.group))
        ops.append(dist.P2POp(dist.irecv, from_right, mesh.ranks[r + 1], mesh.group))
    pending = (dist.batch_isend_irecv(ops) if ops else [], keep)
    COUNTS["halo_exchange"] += 1
    return from_left, from_right, pending


def _finish(pending) -> None:
    for work in pending[0]:
        work.wait()


def exchange_halos(x_local: torch.Tensor, halo: int, mesh: Mesh):
    """``(from_left, from_right)``: the ``halo`` lanes of each neighbour
    nearest this rank, zeros at the edges."""
    from_left, from_right, pending = _start_exchange(x_local, halo, mesh)
    _finish(pending)
    return from_left, from_right


def halo_exchange_t(x_local: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """x_local (m, nloc) -> x_ext (m, halo + nloc + halo) with the
    neighbours' boundary lanes (zeros at the edges; JAX :64)."""
    if halo == 0:
        # diagonal-only operand: nothing to exchange (without the guard a
        # zero-width slice would take the whole array)
        return x_local
    if mesh.size == 1:
        return F.pad(x_local, (halo, halo))
    from_left, from_right = exchange_halos(x_local, halo, mesh)
    return torch.cat([from_left, x_local, from_right], dim=1)


def halo_exchange(x_local: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """Column-layout wrapper over ``halo_exchange_t`` (x_local (nloc, m))."""
    return halo_exchange_t(x_local.T.contiguous(), halo, mesh).T


# ---------------------------------------------------------------------------
# The halo SpMM
# ---------------------------------------------------------------------------


def _halo_of(offsets, nloc: int, what: str) -> int:
    halo = max((abs(o) for o in offsets), default=0)
    if halo > nloc:
        raise ValueError(
            f"{what}: bandwidth {halo} exceeds local rows {nloc}; use fewer "
            "ranks or a wider partition"
        )
    return halo


def _edge_terms(Y, data_local, offsets, from_left, from_right):
    """Add the cross-rank terms to the local product in place: the first
    |off| rows of a negative offset read the left slab, the last off rows
    of a positive one the right slab (JAX :122-133)."""
    nloc = Y.shape[1]
    halo = from_left.shape[1]
    for d, off in enumerate(offsets):
        if off < 0:
            Y[:, :-off] += data_local[d][None, :-off] * from_left[:, halo + off:]
        elif off > 0:
            Y[:, nloc - off:] += data_local[d][None, nloc - off:] * from_right[:, :off]
    return Y


def dia_spmm_halo_t(data_local: torch.Tensor, offsets, x_local: torch.Tensor,
                    mesh: Mesh) -> torch.Tensor:
    """Local rows of ``(A @ X)^T`` for a row-sharded DIA matrix, the slice
    formulation (``spmm='xla'``, JAX :87): the exchange is posted first,
    the interior sweep over zero-padded local lanes runs while it is in
    flight, the edge terms wait for it. data_local (ndiag, nloc), x_local
    (m, nloc); requires halo = max|offset| <= nloc."""
    m, nloc = x_local.shape
    halo = _halo_of(offsets, nloc, "dia_spmm_halo_t")
    if halo == 0:
        return data_local[0][None, :] * x_local
    if mesh.size > 1:
        from_left, from_right, pending = _start_exchange(x_local, halo, mesh)
    Xp = F.pad(x_local, (halo, halo))
    acc = torch.zeros_like(x_local)
    for d, off in enumerate(offsets):
        acc = acc + data_local[d][None, :] * Xp[:, halo + off: halo + off + nloc]
    if mesh.size > 1:
        _finish(pending)
        _edge_terms(acc, data_local, offsets, from_left, from_right)
    return acc


def dia_spmm_halo(data_local: torch.Tensor, offsets, x_local: torch.Tensor,
                  mesh: Mesh) -> torch.Tensor:
    """Column-layout wrapper over ``dia_spmm_halo_t`` (x_local (nloc, m))."""
    return dia_spmm_halo_t(data_local, offsets, x_local.T.contiguous(), mesh).T


def local_operand(data_local: torch.Tensor, offsets) -> DIAMatrix:
    """The rank's rows as a square (nloc, nloc) DIA operand: K1 on it reads
    zero for every column outside [0, nloc), which the edge terms supply."""
    nloc = data_local.shape[1]
    return DIAMatrix(data=data_local, offsets=tuple(offsets), shape=(nloc, nloc))


def dia_local_apply_t(A_local: DIAMatrix, x_local: torch.Tensor, from_left=None,
                      from_right=None) -> torch.Tensor:
    """The K1 route's local half: K1 on the rank's block (its plain version
    on a CPU tensor, through ``spmm_t``), then the edge terms from the
    received slabs (none: an unsplit operand or world size 1). Needs no
    collective, so a caller can split one operand P ways in one process
    and feed each rank's slabs itself."""
    _halo_of(A_local.offsets, x_local.shape[1], "dia_local_apply_t")
    Y = spmm_t(A_local, x_local)
    if from_left is not None:
        _edge_terms(Y, A_local.data, A_local.offsets, from_left, from_right)
    return Y


def padded_spmm_halo_t(A_local: DIAMatrix, x_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Local rows of ``(A @ X)^T`` with the interior on K1 (``spmm='padded'``,
    JAX ``padded_spmm_halo``): the exchange is posted, K1 runs on the local
    block while it is in flight, and only the O(halo) edge terms wait for
    the slabs."""
    halo = _halo_of(A_local.offsets, x_local.shape[1], "padded_spmm_halo_t")
    if mesh.size == 1 or halo == 0:
        return spmm_t(A_local, x_local)
    from_left, from_right, pending = _start_exchange(x_local, halo, mesh)
    Y = spmm_t(A_local, x_local)
    _finish(pending)
    return _edge_terms(Y, A_local.data, A_local.offsets, from_left, from_right)


def local_diag_block(data_local: torch.Tensor, offsets) -> torch.Tensor:
    """Zero the cross-rank couplings of a row-sharded DIA block: entry
    (i, i + off) belongs to the rank's diagonal block iff the column is
    local (JAX :214)."""
    nloc = data_local.shape[1]
    i = torch.arange(nloc, device=data_local.device)
    out = []
    for d, off in enumerate(offsets):
        valid = (i + off >= 0) & (i + off < nloc)
        out.append(torch.where(valid, data_local[d], torch.zeros((), dtype=data_local.dtype,
                                                                  device=data_local.device)))
    return torch.stack(out)


class _ShardEngine:
    """The rank's local operands and their SpMM hooks (JAX :227, without
    the guarded layout: K1 masks its own bounds). ``mode`` 'padded' is the
    K1 route, 'xla' the slice formulation."""

    def __init__(self, datas, offsets_list, mesh: Mesh, mode: str):
        if mode not in ("padded", "xla"):
            raise ValueError(f"unknown spmm mode {mode!r} (padded|xla)")
        self.mesh = mesh
        self.mode = mode
        self.datas = list(datas)
        self.offsets_list = [tuple(o) for o in offsets_list]
        self.nloc = self.datas[0].shape[1]
        self._cast = {}

    def operand(self, i: int, dtype=None) -> DIAMatrix:
        """Operand i's local block, its coefficients in ``dtype`` (cast once
        and kept: the bf16 preconditioner path)."""
        key = (i, dtype)
        if key not in self._cast:
            data = self.datas[i] if dtype is None else self.datas[i].to(dtype)
            self._cast[key] = local_operand(data, self.offsets_list[i])
        return self._cast[key]

    def apply(self, i: int, dtype=None):
        """The transposed-layout SpMM hook of operand i (multivectors in
        ``dtype`` when given)."""
        op = self.operand(i, dtype)
        mesh = self.mesh
        if self.mode == "padded":
            return lambda X: padded_spmm_halo_t(op, X, mesh)
        return lambda X: dia_spmm_halo_t(op.data, op.offsets, X, mesh)

    def inv_diag(self, i: int) -> torch.Tensor:
        """Reciprocal main diagonal of operand i's local rows (Jacobi)."""
        return 1.0 / self.datas[i][self.offsets_list[i].index(0)]


def schwarz_inverse_t(
    data_local: torch.Tensor,
    offsets,
    apply_a,
    gram_reduce,
    rtol: float = 1e-6,
    maxiter: int = 200,
    C: int = 256,
    direct: bool = False,
):
    """Additive-Schwarz (block-Jacobi) inverse for the sharded solvers (JAX
    :304): each rank factorizes ITS diagonal band block with the device
    block-banded engine (``factorize/banded.py``) and the global CG uses the
    exact local solves as its fixed SPD preconditioner. ``direct``: at world
    size 1 the local block is the whole operator, so the block solve is
    applied directly instead of under a CG that would verify it (JAX
    :358-367). Returns a transposed-layout solve marked ``layout_t``."""
    from dune_eigensolver_tpu_torch.factorize.banded import banded_solve_t, factorize_banded_device
    from dune_eigensolver_tpu_torch.factorize.cg import cg_solve_t

    blk = local_diag_block(data_local, offsets)
    Fct = factorize_banded_device(local_operand(blk, offsets), C=C)

    def precond(R):
        return banded_solve_t(Fct, R)

    if direct:
        solve = precond
    else:

        def solve(X):
            Y, _ = cg_solve_t(apply_a, X, rtol=rtol, maxiter=maxiter,
                              gram_reduce=gram_reduce, precond_apply=precond)
            return Y

    solve.layout_t = True
    return solve


# ---------------------------------------------------------------------------
# Row padding, start blocks, results
# ---------------------------------------------------------------------------


def _pad_rows_dia(A: DIAMatrix, n_pad: int, diag_fill: float) -> DIAMatrix:
    """Extend an n x n DIA matrix to n_pad x n_pad with DECOUPLED pad rows:
    ``diag_fill`` on the main diagonal, zero elsewhere (JAX :390). With a
    zero start block the pad lanes stay exactly zero, so the spectrum is
    untouched."""
    n = A.shape[0]
    if n_pad == n:
        return A
    data = F.pad(A.data, (0, n_pad - n))
    if diag_fill != 0.0:
        if 0 not in A.offsets:
            raise ValueError(
                "_pad_rows_dia: operator has no main diagonal to carry the "
                "pad-row identity; cannot pad to the mesh size"
            )
        data[A.offsets.index(0), n:] = diag_fill
    return DIAMatrix(data=data, offsets=A.offsets, shape=(n_pad, n_pad))


def _padded_rows(n: int, size: int) -> int:
    return -(-n // size) * size


def _local_rows(data: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's lanes ``r0:r1`` of a (k, n_pad) array (no copy at world
    size 1)."""
    nloc = data.shape[1] // mesh.size
    return data[:, mesh.rank * nloc:(mesh.rank + 1) * nloc].contiguous()


def _random_q0_t(seed, n, n_pad, m, mesh: Mesh, dtype, q0=None) -> torch.Tensor:
    """This rank's lanes of the (m, n_pad) start block (JAX :427): ``q0.T``
    ((n, m) global, the same on every rank) or a ``torch.Generator`` draw
    from ``seed`` on the mesh's device (at world size 1 the single-card
    solvers' start block for the same seed); pad lanes EXACTLY zero."""
    from dune_eigensolver_tpu_torch.solvers.standard import random_multivector_t

    if q0 is not None:
        Q0 = q0.T.to(device=mesh.device, dtype=dtype)
    else:
        gen = torch.Generator(device=mesh.device).manual_seed(int(seed))
        Q0 = random_multivector_t(gen, n, m, dtype, mesh.device)
    if tuple(Q0.shape) != (m, n):
        raise ValueError(f"start block {tuple(Q0.shape)} is not ({m}, {n}) transposed")
    return _local_rows(F.pad(Q0, (0, n_pad - n)), mesh)


def _slice_result(res, n: int):
    """Drop the pad rows from assembled eigenvectors (JAX :420)."""
    if res.eigenvectors.shape[0] == n:
        return res
    return dataclasses.replace(res, eigenvectors=res.eigenvectors[:n])


def _gather_result(res, mesh: Mesh, n: int):
    """The global eigenvectors on every rank: the local (nloc, nev) rows
    gathered in rank order (the JAX ``out_specs`` ``P(axis, None)``), pad
    rows sliced off."""
    V = all_gather_cat(res.eigenvectors, mesh, dim=0)
    return _slice_result(dataclasses.replace(res, eigenvectors=V), n)


def _pick_spmm(spmm: Optional[str], device) -> str:
    """'padded' (K1) on a CUDA tensor, 'xla' (the slice formulation) on
    the CPU, unless the caller names one (JAX :438-443)."""
    if spmm is None:
        return "padded" if torch.device(device).type == "cuda" else "xla"
    if spmm not in ("padded", "xla"):
        raise ValueError(f"unknown spmm mode {spmm!r} (padded|xla)")
    return spmm


def _pick_inner(inner: str, A, nloc: int) -> str:
    """Validate the distributed inverse engine (JAX :982): Schwarz needs
    the band inside the rank and inside the device engine's ceiling
    (``factorize/banded.py::BANDED_BW_MAX``); past it, plain Jacobi-CG with
    a loud ``FALLBACK:`` line, as the reference does."""
    from dune_eigensolver_tpu_torch.factorize.banded import BANDED_BW_MAX

    if inner not in ("schwarz", "cg"):
        raise ValueError(f"unknown inner engine {inner!r} (schwarz|cg)")
    if inner == "schwarz":
        bw = max((abs(o) for o in A.offsets), default=0)
        if bw > min(nloc, BANDED_BW_MAX):
            from dune_eigensolver_tpu_torch.utils.vlog import warn_fallback

            warn_fallback(
                f"schwarz inner engine needs bandwidth {bw} <= min(nloc={nloc}, "
                f"{BANDED_BW_MAX}) -> plain Jacobi-CG (no per-rank block solves; "
                "expect more inner iterations)"
            )
            return "cg"
    return inner


def _prepare(A, mesh, spmm, what):
    mesh = mesh or make_mesh()
    check_device(mesh, A.device, what)
    n = A.shape[0]
    return mesh, _pick_spmm(spmm, A.device), n, _padded_rows(n, mesh.size)


def _cg_inverse(eng, apply_a, reduce_, rtol, maxiter):
    from dune_eigensolver_tpu_torch.factorize.cg import cg_solve_t

    inv_diag = eng.inv_diag(0)

    def inv_fn(_aux, X):
        Y, _ = cg_solve_t(apply_a, X, inv_diag=inv_diag, rtol=rtol, maxiter=maxiter,
                          gram_reduce=reduce_)
        return Y

    return inv_fn


def _inner_inverse(inner, eng, apply_a, reduce_, rtol, maxiter):
    """``inv_fn(aux, X)`` of the shift-invert drivers: Schwarz (direct at
    world size 1) or Jacobi-CG on operand 0."""
    if inner == "schwarz":
        solve = schwarz_inverse_t(eng.datas[0], eng.offsets_list[0], apply_a, reduce_,
                                  rtol=rtol, maxiter=maxiter, direct=(eng.mesh.size == 1))
        return lambda _aux, X: solve(X)
    return _cg_inverse(eng, apply_a, reduce_, rtol, maxiter)


def _pencil_rows(A, B, shift, reg, n_pad, mesh):
    """The rank's rows of A + shift*B + reg*I (pad rows identity) and of B
    (pad rows zero)."""
    A_op = A
    if shift != 0.0:
        A_op = A_op.axpy(shift, B)
    if reg != 0.0:
        A_op = A_op.with_shifted_diagonal(reg)
    A_op = _pad_rows_dia(A_op, n_pad, 1.0)
    B_p = _pad_rows_dia(B, n_pad, 0.0)
    return _local_rows(A_op.data, mesh), _local_rows(B_p.data, mesh)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def sharded_standard_largest(
    A: DIAMatrix,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    mesh: Optional[Mesh] = None,
    block: int = 8,
    seed: int = 123,
    ortho_iterations: int = 1,
    rayleigh_ritz: bool = False,
    spmm: Optional[str] = None,
    q0: Optional[torch.Tensor] = None,
):
    """Multi-rank ``standard_largest`` (JAX :485): same semantics, rows
    sharded over the mesh. ``spmm``: 'padded' (K1, the default on a CUDA
    tensor) or 'xla' (the slice formulation, the CPU default). ``q0``:
    the global (n, m) start block, the same on every rank (default a draw
    from ``seed``)."""
    from dune_eigensolver_tpu_torch.solvers.standard import _core, padded_width

    mesh, mode, n, n_pad = _prepare(A, mesh, spmm, "sharded_standard_largest")
    A_sh = A.with_shifted_diagonal(shift) if shift != 0.0 else A
    A_sh = _pad_rows_dia(A_sh, n_pad, 1.0)
    eng = _ShardEngine([_local_rows(A_sh.data, mesh)], [A.offsets], mesh, mode)
    m = padded_width(nev, block)
    Q0 = _random_q0_t(seed, n, n_pad, m, mesh, A.dtype, q0)
    apply_a = eng.apply(0)
    with torch.no_grad():
        res = _core(apply_a, apply_a, Q0, nev, float(tol), int(maxiter), float(shift),
                    int(block), int(ortho_iterations), bool(rayleigh_ritz), descending=True,
                    gram_reduce=psum_reduce(mesh))
        return _gather_result(res, mesh, n)


def sharded_standard_inverse(
    A: DIAMatrix,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    mesh: Optional[Mesh] = None,
    block: int = 8,
    seed: int = 123,
    ortho_iterations: int = 1,
    cg_rtol: float = 1e-6,
    cg_maxiter: int = 2000,
    inner: str = "schwarz",
    spmm: Optional[str] = None,
    q0: Optional[torch.Tensor] = None,
):
    """Multi-rank ``standard_inverse``: smallest eigenpairs by shift-invert
    (JAX :557, the loop of ``_sharded_inverse_core`` :658). ``inner``:
    'schwarz' (default: global CG preconditioned by exact per-rank banded
    block solves, ``schwarz_inverse_t``; the block solve alone at world size
    1) or 'cg' (plain Jacobi-CG)."""
    from dune_eigensolver_tpu_torch.solvers.standard import _core, padded_width

    mesh, mode, n, n_pad = _prepare(A, mesh, spmm, "sharded_standard_inverse")
    inner = _pick_inner(inner, A, n_pad // mesh.size)
    A_sh = A.with_shifted_diagonal(shift) if shift != 0.0 else A
    A_sh = _pad_rows_dia(A_sh, n_pad, 1.0)
    eng = _ShardEngine([_local_rows(A_sh.data, mesh)], [A.offsets], mesh, mode)
    m = padded_width(nev, block)
    Q0 = _random_q0_t(seed, n, n_pad, m, mesh, A.dtype, q0)
    reduce_ = psum_reduce(mesh)
    apply_a = eng.apply(0)
    with torch.no_grad():
        inv_fn = _inner_inverse(inner, eng, apply_a, reduce_, cg_rtol, cg_maxiter)
        res = _core(lambda X: inv_fn(None, X), apply_a, Q0, nev, float(tol), int(maxiter),
                    float(shift), int(block), int(ortho_iterations), False, descending=False,
                    gram_reduce=reduce_)
        return _gather_result(res, mesh, n)


def sharded_generalized_inverse(
    A: DIAMatrix,
    B: DIAMatrix,
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
    spmm: Optional[str] = None,
    q0: Optional[torch.Tensor] = None,
):
    """Multi-rank ``generalized_inverse`` (JAX :712). ``inner`` as in
    ``sharded_standard_inverse``, on the shifted operator A + shift*B +
    reg*I; every SpMM, outer and inner, takes the ``spmm`` route."""
    from dune_eigensolver_tpu_torch.solvers.generalized import _gen_core
    from dune_eigensolver_tpu_torch.solvers.standard import padded_width

    mesh, mode, n, n_pad = _prepare(A, mesh, spmm, "sharded_generalized_inverse")
    check_device(mesh, B.device, "sharded_generalized_inverse")
    inner = _pick_inner(inner, A, n_pad // mesh.size)
    adata, bdata = _pencil_rows(A, B, shift, reg, n_pad, mesh)
    eng = _ShardEngine([adata, bdata], [A.offsets, B.offsets], mesh, mode)
    m = padded_width(nev, block)
    Q0 = _random_q0_t(seed, n, n_pad, m, mesh, A.dtype, q0)
    reduce_ = psum_reduce(mesh)
    apply_a, apply_b = eng.apply(0), eng.apply(1)
    with torch.no_grad():
        inv_fn = _inner_inverse(inner, eng, apply_a, reduce_, cg_rtol, cg_maxiter)
        res = _gen_core(apply_a, apply_b, None, inv_fn, Q0, nev, float(tol), int(maxiter),
                        float(shift), int(block), int(min_iter), int(ortho_iterations),
                        bool(rayleigh_ritz), gram_reduce=reduce_)
        return _gather_result(res, mesh, n)


def sharded_lobpcg_generalized(
    A: DIAMatrix,
    B: DIAMatrix,
    nev: int,
    tol: float,
    maxiter: int,
    shift: float = 0.0,
    reg: float = 0.0,
    mesh: Optional[Mesh] = None,
    block: int = 8,
    seed: int = 123,
    min_iter: int = 3,
    ortho_eps: float = 1e-9,
    cg_rtol: float = 1e-2,
    cg_maxiter: int = 100,
    spmm: Optional[str] = None,
    prec_dtype=None,
    precond: str = "cg",
    ortho_block=None,
    q0: Optional[torch.Tensor] = None,
):
    """Multi-rank LOBPCG on the reciprocal pencil (JAX :833).

    ``precond='cg'``: a loose Jacobi-CG on the shifted operator (all dots
    all-reduced). ``precond='mg'`` (structured 2D/3D stencils): the sharded
    geometric V(1,1) cycle (``dist/mg.py``), one ``all_gather`` a cycle.
    ``prec_dtype``: the preconditioner streams the operand and multivector
    in this dtype (``torch.bfloat16``: K1's bf16 instantiation; dots stay
    f32). ``ortho_block``: the LOBPCG core's orthonormalization block (24
    with MG is the north-star setting)."""
    from dune_eigensolver_tpu_torch.factorize.cg import cg_solve_t
    from dune_eigensolver_tpu_torch.solvers.lobpcg import _lobpcg_core
    from dune_eigensolver_tpu_torch.solvers.standard import padded_width

    if precond not in ("cg", "mg"):
        raise ValueError(f"unknown precond {precond!r} (cg|mg)")
    mesh, mode, n, n_pad = _prepare(A, mesh, spmm, "sharded_lobpcg_generalized")
    check_device(mesh, B.device, "sharded_lobpcg_generalized")
    mg_dims = None
    if precond == "mg":
        from dune_eigensolver_tpu_torch.dist.mg import sharded_mg_geometry

        mg_dims = sharded_mg_geometry(A.offsets, n, n_pad, mesh.size)
    adata, bdata = _pencil_rows(A, B, shift, reg, n_pad, mesh)
    eng = _ShardEngine([adata, bdata], [A.offsets, B.offsets], mesh, mode)
    m = padded_width(nev, block)
    Q0 = _random_q0_t(seed, n, n_pad, m, mesh, A.dtype, q0)
    reduce_ = psum_reduce(mesh)
    apply_a, apply_b = eng.apply(0), eng.apply(1)

    if precond == "mg":
        from dune_eigensolver_tpu_torch.dist.mg import make_sharded_mg_prec_fn

        prec_fn = make_sharded_mg_prec_fn(eng, mg_dims, dtype=prec_dtype)
    else:
        apply_a_p = eng.apply(0, dtype=prec_dtype)
        inv_diag = eng.inv_diag(0)
        inv_diag_p = inv_diag if prec_dtype is None else inv_diag.to(prec_dtype)

        def prec_fn(_aux, X):
            Xp = X if prec_dtype is None else X.to(prec_dtype)
            Y, _ = cg_solve_t(apply_a_p, Xp, inv_diag=inv_diag_p, rtol=cg_rtol,
                              maxiter=cg_maxiter, gram_reduce=reduce_)
            return Y.to(X.dtype)

    with torch.no_grad():
        res = _lobpcg_core(
            apply_a, apply_b, None, prec_fn, Q0, nev, float(tol), int(maxiter), float(shift),
            int(min_iter), float(ortho_eps), 2,
            "full" if ortho_block == "full" else int(ortho_block or block),
            gram_reduce=reduce_,
        )
        return _gather_result(res, mesh, n)
