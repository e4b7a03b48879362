"""Rank-side bodies of the distributed-layer tests (no JAX, no tests of its
own): the gloo ranks that ``dist/dryrun.py::RankPool`` spawns import this
module and run these functions, SPMD; rank 0 hands back numpy values.

Every case first builds ``make_mesh(P)`` on all ranks of the pool (a mesh
smaller than the pool is a subgroup); ranks outside it return None. Global
operands arrive as numpy arrays or scipy matrices, the same on every rank,
and each rank takes its rows as the drivers do.
"""

import numpy as np
import torch

from dune_eigensolver_tpu_torch import dist as tdist
from dune_eigensolver_tpu_torch.dist import dryrun, mg as tmg, sharded, windowed
from dune_eigensolver_tpu_torch.sparse import dia_from_numpy

CPU = "cpu"


def pool(n, store_dir):
    """A RankPool of n gloo ranks, one thread each, their FileStore in
    ``store_dir``."""
    return dryrun.RankPool(n, threads=1, timeout=90.0, store_dir=str(store_dir))


def _dia(spec):
    data, offsets, shape = spec
    return dia_from_numpy(data, offsets, shape, device=CPU)


def _rows(a, mesh, n_pad=None):
    """This rank's lanes of a (k, n) array, padded with zeros to n_pad."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if n_pad is not None and n_pad != t.shape[1]:
        t = torch.nn.functional.pad(t, (0, n_pad - t.shape[1]))
    return sharded._local_rows(t, mesh)


def _result(res):
    return dict(ev=res.eigenvalues.numpy(), V=res.eigenvectors.numpy(),
                iterations=int(res.iterations), converged=bool(res.converged),
                criterion=float(res.criterion))


def halo_product(P, data, offsets, Xt, mode):
    """(A @ X)^T assembled from the P ranks' halo SpMMs: 'xla' (the slice
    formulation), 'padded' (the K1 route) or 'exchange' (halo_exchange_t's
    extended block, gathered)."""
    mesh = tdist.make_mesh(P)
    if not mesh.member:
        return None
    x = _rows(Xt, mesh)
    d = _rows(data, mesh)
    if mode == "xla":
        Y = sharded.dia_spmm_halo_t(d, tuple(offsets), x, mesh)
    elif mode == "padded":
        Y = sharded.padded_spmm_halo_t(sharded.local_operand(d, offsets), x, mesh)
    else:
        halo = max(abs(o) for o in offsets)
        Y = sharded.halo_exchange_t(x, halo, mesh)
    return sharded.all_gather_cat(Y, mesh, dim=1).numpy()


def mesh_checks(world):
    """make_mesh past the world raises ValueError (its text returned); a CPU
    operand on the gloo mesh passes the backend check, a CUDA one does not."""
    from dune_eigensolver_tpu_torch.dist.mesh import check_device

    try:
        tdist.make_mesh(world + 1)
    except ValueError as e:
        msg = str(e)
    else:
        msg = None
    mesh = tdist.make_mesh()
    check_device(mesh, "cpu", "test")
    try:  # a CUDA operand on this gloo group: refused, no fallback
        check_device(mesh, "cuda:0", "test")
    except ValueError as e:
        cuda_msg = str(e)
    else:
        cuda_msg = None
    return dict(msg=msg, size=mesh.size, rank=mesh.rank, device=str(mesh.device),
                cuda_msg=cuda_msg)


def halo_guard(P, n, offsets, mode):
    """The ValueError text of a halo SpMM whose bandwidth exceeds the local
    rows (every rank raises before any collective), or None."""
    mesh = tdist.make_mesh(P)
    if not mesh.member:
        return None
    nloc = n // P
    d = torch.zeros((len(offsets), nloc), dtype=torch.float64)
    x = torch.zeros((8, nloc), dtype=torch.float64)
    try:
        if mode == "xla":
            sharded.dia_spmm_halo_t(d, tuple(offsets), x, mesh)
        else:
            sharded.padded_spmm_halo_t(sharded.local_operand(d, offsets), x, mesh)
    except ValueError as e:
        return str(e)
    return None


def dia_driver(P, name, A, B, q0, kwargs):
    """One of the four sharded DIA drivers on P ranks; the result as numpy."""
    mesh = tdist.make_mesh(P)
    if not mesh.member:
        return None
    fn = getattr(tdist, name)
    operands = (_dia(A),) if B is None else (_dia(A), _dia(B))
    res = fn(*operands, mesh=mesh, q0=torch.from_numpy(q0), **kwargs)
    return _result(res)


def general_driver(P, name, A, B, q0, kwargs):
    """One of the three general drivers on P ranks (scipy operands)."""
    mesh = tdist.make_mesh(P)
    if not mesh.member:
        return None
    fn = getattr(tdist, name)
    operands = (A,) if name == "sharded_standard_largest_general" else (A, B)
    res = fn(*operands, mesh=mesh, q0=torch.from_numpy(q0), **kwargs)
    return _result(res)


def mg_cycle(P, A, Xt, dtype=None):
    """One sharded V(1,1) cycle (``make_sharded_mg_prec_fn``) on P ranks,
    assembled."""
    mesh = tdist.make_mesh(P)
    if not mesh.member:
        return None
    Ad = _dia(A)
    n = Ad.shape[0]
    dims = tmg.sharded_mg_geometry(Ad.offsets, n, n, P)
    eng = sharded._ShardEngine([sharded._local_rows(Ad.data, mesh)], [Ad.offsets], mesh, "xla")
    prec = tmg.make_sharded_mg_prec_fn(eng, dims, dtype=dtype)
    Y = prec(None, _rows(Xt, mesh))
    return sharded.all_gather_cat(Y, mesh, dim=1).numpy()


def mg_geometry_error(P, offsets, n, n_pad):
    mesh = tdist.make_mesh(P)
    if not mesh.member:
        return None
    try:
        tmg.sharded_mg_geometry(tuple(offsets), n, n_pad, P)
    except ValueError as e:
        return str(e)
    return None


def windowed_product(P, S, Xt, overlap):
    """(S @ X)^T assembled from the P ranks' ``windowed_spmm_halo_t`` in
    the form asked for, with each rank's plan figures."""
    mesh = tdist.make_mesh(P)
    if not mesh.member:
        return None
    plan = windowed.windowed_shard_plan(S, P, mesh.rank, CPU)
    x = _rows(Xt, mesh, plan.n)
    Y = windowed.windowed_spmm_halo_t(plan, x, mesh, overlap=overlap)
    full = sharded.all_gather_cat(Y, mesh, dim=1).numpy()
    return dict(Y=full[:, :plan.rows], halo=plan.halo, nloc=plan.nloc, n=plan.n)


def core_hooks(P, which, args):
    """A solver core on P ranks with ``psum_reduce`` as its gram_reduce
    (``args`` built by the test), the local outputs gathered."""
    mesh = tdist.make_mesh(P)
    if not mesh.member:
        return None
    return _run_core(which, args, mesh)


def _run_core(which, args, mesh):
    """The core ``which`` on this rank's rows (mesh None: the whole
    operand, no reduction)."""
    from dune_eigensolver_tpu_torch.factorize import chebyshev, cg
    from dune_eigensolver_tpu_torch.ops import ortho
    from dune_eigensolver_tpu_torch.solvers import generalized, lobpcg, standard

    A = _dia(args["A"])
    B = _dia(args["B"]) if "B" in args else None
    if mesh is None:
        rows = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
        red, gather = None, (lambda t: t.numpy())

        def apply(M):
            return lambda X: sharded.dia_spmm_halo_t(M.data, M.offsets, X, _ONE)
    else:
        rows = lambda a: _rows(a, mesh)  # noqa: E731
        red = sharded.psum_reduce(mesh)

        def gather(t):
            return sharded.all_gather_cat(t, mesh, dim=t.ndim - 1).numpy()

        def apply(M):
            d = sharded._local_rows(M.data, mesh)
            return lambda X: sharded.dia_spmm_halo_t(d, M.offsets, X, mesh)

    Q0 = rows(args["q0t"])
    apply_a = apply(A)
    with torch.no_grad():
        if which == "ortho":
            return gather(ortho.orthonormalize_blocked_t(Q0, block=4, iterations=2,
                                                         gram_reduce=red))
        if which == "b_ortho":
            X, norm, mass = ortho.b_orthonormalize_blocked_t(apply_a, Q0, block=4, iterations=2,
                                                             return_mass=True, gram_reduce=red)
            return dict(X=gather(X), norm=float(norm), mass=mass.numpy())
        if which == "cg":
            inv = 1.0 / rows(A.data[A.offsets.index(0)][None].numpy())[0]
            X, k = cg.cg_solve_t(apply_a, Q0, inv_diag=inv, rtol=1e-10, maxiter=500,
                                 gram_reduce=red)
            return dict(X=gather(X), k=k)
        if which == "chebyshev":
            # the polynomial on fixed bounds, and the Chebyshev-CG solve
            # (its bounds from the power iteration through the hooks; the
            # CG runs to 1e-10 whatever the start block's draw per rank)
            inv = 1.0 / rows(A.data[A.offsets.index(0)][None].numpy())[0]
            local = sharded.local_operand(rows(A.data.numpy()), A.offsets)
            poly = chebyshev.chebyshev_apply_t(apply_a, Q0, 0.05, 2.2, 7, inv)
            fac = chebyshev.cheb_cg_inverse_factory(
                degree=5, rtol=1e-10, maxiter=200, apply_a=apply_a, gram_reduce=red,
                fold=None if mesh is None else mesh.rank)
            return dict(poly=gather(poly), cheb_cg=gather(fac(local)(Q0)))
        if which == "largest":
            res = standard._core(apply_a, apply_a, Q0, 4, 1e-8, 200, 0.0, 4, 1, True, True,
                                 gram_reduce=red)
        elif which == "generalized":
            apply_b = apply(B)
            inv = 1.0 / rows(A.data[A.offsets.index(0)][None].numpy())[0]

            def inv_fn(_aux, X):
                return cg.cg_solve_t(apply_a, X, inv_diag=inv, rtol=1e-10, maxiter=500,
                                     gram_reduce=red)[0]

            # eight iterations (tol 0): the hook, not the convergence, is tested
            res = generalized._gen_core(apply_a, apply_b, None, inv_fn, Q0, 4, 0.0, 8, 0.0,
                                        4, 2, 1, False, gram_reduce=red)
        else:  # lobpcg
            apply_b = apply(B)
            inv = 1.0 / rows(A.data[A.offsets.index(0)][None].numpy())[0]

            def prec(_aux, X):  # a loose Jacobi-CG, its dots reduced too
                return cg.cg_solve_t(apply_a, X, inv_diag=inv, rtol=1e-3, maxiter=20,
                                     gram_reduce=red)[0]

            res = lobpcg._lobpcg_core(apply_a, apply_b, None, prec, Q0, 4, 1e-8, 100, 0.0, 3,
                                      1e-9, 2, 4, gram_reduce=red)
        V = res.eigenvectors.T.contiguous()  # (nev, nloc): gather along the rows
        return dict(ev=res.eigenvalues.numpy(), V=gather(V).T, iterations=int(res.iterations))


class _OneRank:
    """A mesh of one rank that issues no collective (the P = 1 reference
    of ``_run_core``)."""

    size = 1
    rank = 0


_ONE = _OneRank()


def core_single(which, args):
    """``_run_core`` on the whole operand with no gram_reduce (runs in the
    test's own process)."""
    return _run_core(which, args, None)



def cli_run(argv):
    """The CLI inside the pool's process group (as under torchrun): every
    rank runs it; rank 0 returns (exit code, its output), any other rank
    raises if it printed anything."""
    import contextlib
    import io

    from dune_eigensolver_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    if torch.distributed.get_rank() != 0 and buf.getvalue():
        raise AssertionError(f"rank {torch.distributed.get_rank()} printed {buf.getvalue()!r}")
    return rc, buf.getvalue()
