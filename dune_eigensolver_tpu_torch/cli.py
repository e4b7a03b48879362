"""Command-line interface: the convergence protocols and kernel benchmarks
of the reference program.

Counterpart of the JAX package's ``cli.py`` (itself the counterpart of
src/dune-eigensolver.cc): the same greppable result lines and the same INI
+ ``key=value`` configuration (``ParameterTree``, config.py). Ported
protocols:

* ``largest``  — largest-eigenvalue convergence protocol (cc:620-730, the
  test the reference ``main()`` runs): oracle at 1e-14, oracle at tol,
  ``standard_largest`` at tol, analytic 2D spectrum; line
  ``N_M_TOL_ESARERROR_ESANERROR_ARANERROR_TIMERATIO``.
* ``smallest`` — smallest-eigenvalue convergence protocol (cc:528-617) on
  the GenEO pair (Neumann A, partition-of-unity B; ``ev.dim=3``: the 3D
  Laplacian with the identity; ``ev.problem=elasticity``: the elasticity
  pencil) with ``generalized_inverse``; line
  ``N_M_TOL_RASERROR_ARPERROR_TIMERATIO``.
* ``eigenvalues`` — timing run dispatching on ``ev.method`` (cc:448-525):
  ``raes``/``tpu`` -> ``generalized_inverse``, ``arpack`` -> the scipy
  oracle, ``lobpcg`` -> preconditioned LOBPCG (``ev.nested=1``: nested
  iteration; ``ev.ortho_block=full``: whole-basis CholeskyQR),
  ``adaptive`` -> ``generalized_inverse_adaptive`` (grow nev by
  ``ev.growth`` until lambda_max >= ``ev.threshold``), ``dist`` ->
  ``dist.sharded_generalized_inverse`` and ``dist_general`` ->
  ``dist.sharded_generalized_inverse_general`` (the pencil as scipy
  matrices, K2 on each rank's rows; ``ev.dist_inner``) over
  ``parallel.ndevices`` ranks (0: all); line ``RESULT eigenvalues_test
  ...`` (``n_below=`` appended for ``adaptive``).
* ``mgs``     — orthonormalization benchmark (cc:164-311) with the roofline
  models of bench/models.py; line ``P_n_m_i_perfn_perfb``.
* ``scaling`` — weak scaling of the sharded SpMM and of one sharded
  solver iteration (``bench/scaling.py``); lines ``SCALING ...``.
* ``matvec``  — SpMM benchmark (cc:315-427); lines
  ``RESULT <variant> <n> <nnz> <m> <GFLOPs> <GBs>``. Variants: ``plain``
  (column layout), ``plain_t`` and ``cuda_t`` (the DIA kernel) on the 2D
  Laplacian; ``bsr_plain``/``bsr_cuda`` and ``ell_plain``/``ell_cuda`` on
  the elasticity operator and its scalar expansion. With ``ev.device=cpu``
  only the plain variants run. A variant that fails raises.

``ev.inverse`` picks the inner solve: ``cg``, ``cg16``, ``chebcg``, ``mg``,
``mgcg``, ``cheb``, or ``auto``/``banded``/``lu`` for the solver's default
(``factorize.default_inverse_factory``: the block-banded direct engine for
2D stencils and 3D ones up to N = 45, V-cycle-CG beyond, RCM-banded for
the elasticity pencil), as in the reference.
``ev.refine=on`` refines the whole block of ``largest``/``smallest`` in f64
(``solvers/refine.py``) and prints ``REFINED_N_M_ERROR``. ``float64`` runs
natively on the card (the kernels have f64 instantiations), so
``ev.refine=auto`` never refines. ``ev.paranoid=1`` turns on the NaN
tripwire (``utils/paranoid.py``; its alarms print after each test);
``ev.profile_dir=<dir>`` writes a ``torch.profiler`` Chrome trace of the
tests there.

Everything runs on the current CUDA device unless ``ev.device=cpu``.
``scaling`` and ``ev.method=dist|dist_general`` need a process group: in a
process without one the CLI starts a world-size-1 group itself (NCCL on
the card, gloo with ``ev.device=cpu``) on a ``FileStore`` in a temporary
directory and ends it after the tests; under ``torchrun`` it joins the
launcher's group (each rank on card ``LOCAL_RANK``), every rank runs the
CLI and rank 0 prints.

Usage: ``python -m dune_eigensolver_tpu_torch [ini-file] [sec.key=value ...]
[--test largest|smallest|eigenvalues|mgs|matvec|scaling|all]``
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np
import torch

from dune_eigensolver_tpu_torch.config import ParameterTree
from dune_eigensolver_tpu_torch.utils.device import resolve


def _rank0() -> bool:
    """Whether this process prints: always without a process group, rank 0
    of one otherwise."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _log(ptree, level, *msg):
    if int(ptree["ev.verbose"]) >= level and _rank0():
        print(*msg, flush=True)


def _dtype(ptree) -> torch.dtype:
    """``ev.dtype`` as a torch dtype. The card has f64 hardware, so float64
    means float64 (the reference iterates in f32 there and refines)."""
    name = np.dtype(ptree["ev.dtype"]).name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"ev.dtype={ptree['ev.dtype']!r} is no floating-point type")
    return dt


def _device(ptree) -> torch.device:
    return resolve(str(ptree.get("ev.device", "")))


def _problem_pair(ptree):
    """(A, B) for the generalized protocol: Neumann Laplacian + GenEO B
    (reference cc:475-479); ``ev.dim=3`` the 3D Dirichlet Laplacian with the
    identity on its pattern; ``ev.problem=elasticity`` the clamped-plate 2D
    elasticity pencil (BSR 2x2)."""
    from dune_eigensolver_tpu_torch.sparse import problems

    N = int(ptree["ev.N"])
    dt = _dtype(ptree)
    device = _device(ptree)
    if str(ptree.get("ev.problem", "geneo")) == "elasticity":
        return problems.elasticity_2d(N, dtype=dt, device=device)
    if int(ptree["ev.dim"]) == 3:
        A = problems.laplacian_dirichlet_3d(N, dtype=dt, device=device)
        return A, problems.identity_on_pattern(A, dtype=dt)
    A = problems.laplacian_neumann_2d(N, dtype=dt, device=device)
    B = problems.laplacian_b_2d(N, int(ptree["ev.overlap"]), dtype=dt, device=device)
    return A, B


def _inverse_factory(ptree):
    from dune_eigensolver_tpu_torch import factorize

    kind = str(ptree["ev.inverse"])
    if kind in ("auto", "banded", "lu"):
        return None  # the solver's default (factorize.default_inverse_factory)
    if kind == "cg":
        return factorize.cg_inverse_factory(rtol=1e-4, maxiter=1000)
    if kind == "cg16":
        # bf16-streamed loose CG: preconditioner-grade only (~2 digits), for
        # ev.method=lobpcg; not valid as a shift-invert inner solve
        return factorize.cg_inverse_factory(rtol=1e-2, maxiter=25, dtype=torch.bfloat16)
    if kind == "chebcg":
        return factorize.cheb_cg_inverse_factory(rtol=1e-4, maxiter=300)
    if kind == "mg":
        # one geometric V-cycle: preconditioner-grade (ev.method=lobpcg);
        # structured 2D/3D stencil operands only
        return factorize.mg_inverse_factory()
    if kind == "mgcg":
        # V-cycle-preconditioned CG to tolerance: the converging inner solve
        # for shift-invert on structured (3D) stencils
        return factorize.mg_cg_inverse_factory(rtol=1e-4, maxiter=100)
    if kind == "cheb":
        return factorize.chebyshev_inverse_factory()
    raise ValueError(f"unknown ev.inverse={kind!r}")


def _want_refine(ptree) -> bool:
    """The reference refines for ``ev.refine=on`` and, on a TPU, for
    ``ev.dtype=float64`` (it iterates in f32 there). This card has f64
    hardware, so ``auto`` (and ``off``) is False."""
    return str(ptree.get("ev.refine", "auto")).lower() in ("on", "1", "true")


def _timed(fn, device):
    """(result, seconds) of ``fn()``, the device drained before and after."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Convergence protocols
# ---------------------------------------------------------------------------


def largest_eigenvalues_convergence_test(ptree) -> dict:
    """Reference cc:620-730. Three-way comparison on the Dirichlet Laplacian:
    scipy oracle @1e-14 (ground truth), oracle @tol, standard_largest @tol,
    plus the closed-form spectrum."""
    from dune_eigensolver_tpu_torch.oracle import (
        eigenvalues_laplace_dirichlet_2d,
        largest_standard,
    )
    from dune_eigensolver_tpu_torch.solvers import standard_largest
    from dune_eigensolver_tpu_torch.sparse import problems

    N = int(ptree["ev.N"])
    nev = int(ptree["ev.m"])
    tol = float(ptree["ev.tol"])
    block = int(ptree["ev.block"])
    device = _device(ptree)

    A = problems.laplacian_dirichlet_2d(N, dtype=_dtype(ptree), device=device)
    m = -(-nev // block) * block

    t0 = time.perf_counter()
    ev_oracle, _ = largest_standard(A, m, tol=1e-14)
    t_oracle_hi = time.perf_counter() - t0
    t0 = time.perf_counter()
    largest_standard(A, m, tol=tol)
    t_oracle = time.perf_counter() - t0

    res, t_es = _timed(
        lambda: standard_largest(
            A, nev=m, tol=tol, maxiter=int(ptree["ev.maxiter"]), seed=int(ptree["ev.seed"]),
            block=block, rayleigh_ritz=bool(ptree.get("ev.rr", False)),
        ),
        device,
    )
    ev_es = res.eigenvalues.double().cpu().numpy()
    ev_anal = eigenvalues_laplace_dirichlet_2d(N)[::-1][:m]  # descending

    err_es_or = np.abs(ev_es - ev_oracle).max()
    err_es_an = np.abs(ev_es - ev_anal).max()
    err_or_an = np.abs(ev_oracle - ev_anal).max()
    _log(ptree, 1, f"  eigensolver: {ev_es[:4]}")
    _log(ptree, 1, f"  oracle     : {ev_oracle[:4]}")
    _log(ptree, 1, f"  analytic   : {ev_anal[:4]}")
    # greppable line mirroring N_M_TOL_... (reference cc:718-727)
    print(
        f"N_M_TOL_ESARERROR_ESANERROR_ARANERROR_TIMERATIO: "
        f"{N} {m} {tol:.1e} {err_es_or:.3e} {err_es_an:.3e} {err_or_an:.3e} "
        f"{t_es / max(t_oracle, 1e-12):.2f}",
        flush=True,
    )
    err_refined = None
    if _want_refine(ptree):
        from dune_eigensolver_tpu_torch.solvers import refine_eigenpairs

        # refine on the whole block, report the requested nev: the block's
        # trailing vectors act as guard vectors for the leading Ritz values
        w, _ = refine_eigenpairs(A, None, res.eigenvectors)
        err_refined = float(np.abs(np.sort(w)[::-1][:nev] - ev_oracle[:nev]).max())
        print(f"REFINED_N_M_ERROR: {N} {nev} {err_refined:.3e}", flush=True)
    return dict(
        err_vs_oracle=float(err_es_or),
        err_vs_analytic=float(err_es_an),
        oracle_vs_analytic=float(err_or_an),
        err_refined=err_refined,
        time=t_es,
        time_oracle=t_oracle,
        time_oracle_hi=t_oracle_hi,
        iterations=int(res.iterations),
    )


def _generalized_inverse_kwargs(ptree, m):
    return dict(
        nev=m,
        tol=float(ptree["ev.tol"]),
        maxiter=int(ptree["ev.maxiter"]),
        shift=float(ptree["ev.shift"]),
        reg=float(ptree["ev.regularization"]),
        block=int(ptree["ev.block"]),
        seed=int(ptree["ev.seed"]),
        inverse=_inverse_factory(ptree),
        rayleigh_ritz=bool(ptree.get("ev.rr", False)),
    )


def smallest_eigenvalues_convergence_test(ptree) -> dict:
    """Reference cc:528-617: generalized protocol on the GenEO pair."""
    from dune_eigensolver_tpu_torch.oracle import smallest_generalized
    from dune_eigensolver_tpu_torch.solvers import generalized_inverse

    nev = int(ptree["ev.m"])
    tol = float(ptree["ev.tol"])
    shift = float(ptree["ev.shift"])
    block = int(ptree["ev.block"])
    m = -(-nev // block) * block
    A, B = _problem_pair(ptree)

    t0 = time.perf_counter()
    ev_truth, _ = smallest_generalized(A, B, m, sigma=-shift, tol=1e-14)
    t_truth = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev_oracle, _ = smallest_generalized(A, B, m, sigma=-shift, tol=tol)
    t_oracle = time.perf_counter() - t0

    res, t_ras = _timed(
        lambda: generalized_inverse(A, B, **_generalized_inverse_kwargs(ptree, m)),
        _device(ptree),
    )
    ev_ras = res.eigenvalues.double().cpu().numpy()

    err_ras = np.abs(ev_ras - ev_truth).max()
    err_arp = np.abs(ev_oracle - ev_truth).max()
    _log(ptree, 1, f"  eigensolver: {ev_ras[:4]}")
    _log(ptree, 1, f"  oracle     : {ev_truth[:4]}")
    # reference line N_M_TOL_RASERROR_ARPERROR_TIMERATIO_ARPACKITER (cc:606)
    print(
        f"N_M_TOL_RASERROR_ARPERROR_TIMERATIO: "
        f"{ptree['ev.N']} {m} {tol:.1e} {err_ras:.3e} {err_arp:.3e} "
        f"{t_ras / max(t_oracle, 1e-12):.2f}",
        flush=True,
    )
    err_refined = None
    if _want_refine(ptree):
        from dune_eigensolver_tpu_torch.solvers import refine_eigenpairs

        w, _ = refine_eigenpairs(A, B, res.eigenvectors)
        err_refined = float(np.abs(np.sort(w)[:nev] - np.sort(ev_truth)[:nev]).max())
        print(f"REFINED_N_M_ERROR: {ptree['ev.N']} {nev} {err_refined:.3e}", flush=True)
    return dict(
        err_vs_truth=float(err_ras),
        oracle_err=float(err_arp),
        err_refined=err_refined,
        time=t_ras,
        time_oracle=t_oracle,
        time_truth=t_truth,
        iterations=int(res.iterations),
        converged=bool(res.converged),
    )


def eigenvalues_test(ptree) -> dict:
    """Reference cc:448-525: timing run dispatching on ev.method."""
    method = str(ptree["ev.method"])
    nev = int(ptree["ev.m"])
    block = int(ptree["ev.block"])
    m = -(-nev // block) * block
    device = _device(ptree)
    extra: dict = {}
    if method not in ("raes", "tpu", "lobpcg", "adaptive", "arpack", "dist", "dist_general"):
        raise ValueError(f"unknown ev.method={method!r}")
    A, B = _problem_pair(ptree)

    if method in ("raes", "tpu"):
        from dune_eigensolver_tpu_torch.solvers import generalized_inverse

        res, t = _timed(
            lambda: generalized_inverse(A, B, **_generalized_inverse_kwargs(ptree, m)), device)
        ev = res.eigenvalues.cpu().numpy()
        iters = int(res.iterations)
    elif method == "lobpcg":
        from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized, lobpcg_nested

        b_identity = bool(int(ptree.get("ev.b_identity", 0)))
        if b_identity and int(ptree["ev.dim"]) != 3:
            # ev.b_identity skips ALL B-applies, which is only valid for the
            # identity pencil the 3D protocol builds; the 2D default B is
            # the GenEO mass matrix
            raise ValueError(
                "ev.b_identity=1 requires the identity-pencil problem "
                "(ev.dim=3); the 2D protocol's B is the GenEO "
                "partition-of-unity mass matrix"
            )
        ortho_block = str(ptree.get("ev.ortho_block", ""))
        kwargs = dict(
            nev=m,
            tol=float(ptree["ev.tol"]),
            maxiter=int(ptree["ev.maxiter"]),
            shift=float(ptree["ev.shift"]),
            reg=float(ptree["ev.regularization"]),
            block=block,
            seed=int(ptree["ev.seed"]),
            precond=False if str(ptree["ev.inverse"]) == "none" else _inverse_factory(ptree),
            ortho_iterations=int(ptree.get("ev.ortho_iterations", 2)),
            ortho_block=(None if ortho_block == "" else
                         "full" if ortho_block == "full" else int(ortho_block)),
            b_identity=b_identity,
        )
        if bool(int(ptree.get("ev.nested", 0))):
            # nested iteration (solvers/nested.py): coarse-grid hierarchy
            # seeds; needs the identity pencil (the solver validates) and a
            # structured-grid DIA operand. ev.coarse_tol default = tol/10.
            ct = str(ptree.get("ev.coarse_tol", ""))
            run = lambda: lobpcg_nested(  # noqa: E731
                A, B,
                min_coarse=int(ptree.get("ev.min_coarse", 48)),
                coarse_tol=float(ct) if ct else None,
                **kwargs,
            )
        else:
            run = lambda: lobpcg_generalized(A, B, **kwargs)  # noqa: E731
        res, t = _timed(run, device)
        ev = res.eigenvalues.cpu().numpy()
        iters = int(res.iterations)
    elif method == "adaptive":
        # GenEO coarse-space selection: grow nev by ev.growth until
        # lambda_max >= ev.threshold
        from dune_eigensolver_tpu_torch.solvers import generalized_inverse_adaptive

        (res, n_below), t = _timed(
            lambda: generalized_inverse_adaptive(
                A, B,
                threshold=float(ptree["ev.threshold"]),
                nev=m,
                tol=float(ptree["ev.tol"]),
                maxiter=int(ptree["ev.maxiter"]),
                shift=float(ptree["ev.shift"]),
                reg=float(ptree["ev.regularization"]),
                growth=float(ptree["ev.growth"]),
                block=block,
                seed=int(ptree["ev.seed"]),
                verbose=int(ptree["ev.verbose"]),
            ),
            device,
        )
        ev = res.eigenvalues.cpu().numpy()
        iters = int(res.iterations)
        m = ev.size  # the final (possibly grown) block; the RESULT line reports it
        extra = dict(n_below=n_below)
        _log(ptree, 1, f"  adaptive: m_final={ev.size} n_below={n_below}")
    elif method in ("dist", "dist_general"):
        # the distributed layer over parallel.ndevices ranks of the group
        # main() joined or started; dist_general takes the pencil as scipy
        # matrices (K2 on each rank's rows)
        import torch.distributed as dist

        from dune_eigensolver_tpu_torch import dist as tdist

        nd = int(ptree["parallel.ndevices"]) or dist.get_world_size()
        mesh = tdist.make_mesh(nd)
        if not mesh.member:  # a rank past parallel.ndevices: nothing to solve
            return dict(time=0.0, iterations=-1, eigenvalues=None)
        common = dict(nev=m, tol=float(ptree["ev.tol"]), maxiter=int(ptree["ev.maxiter"]),
                      shift=float(ptree["ev.shift"]), mesh=mesh, seed=int(ptree["ev.seed"]))
        if method == "dist":
            run = lambda: tdist.sharded_generalized_inverse(A, B, **common)  # noqa: E731
        else:
            run = lambda: tdist.sharded_generalized_inverse_general(  # noqa: E731
                A.to_scipy(), B.to_scipy(), cg_rtol=1e-8, cg_maxiter=500,
                inner=str(ptree.get("ev.dist_inner", "schwarz")), **common)
        res, t = _timed(run, device)
        ev = res.eigenvalues.cpu().numpy()
        iters = int(res.iterations)
    else:  # arpack
        from dune_eigensolver_tpu_torch.oracle import smallest_generalized

        t0 = time.perf_counter()
        ev, _ = smallest_generalized(
            A, B, m, sigma=-float(ptree["ev.shift"]), tol=float(ptree["ev.tol"])
        )
        t = time.perf_counter() - t0
        iters = -1

    _log(ptree, 1, f"  eigenvalues: {np.sort(ev)[:6]}")
    if _rank0():
        print(
            f"RESULT eigenvalues_test {method} N={ptree['ev.N']} m={m} "
            f"iters={iters} time={t:.3f}s"
            + "".join(f" {k}={v}" for k, v in extra.items()),
            flush=True,
        )
    return dict(time=t, iterations=iters, eigenvalues=np.sort(ev)[:m], **extra)


# ---------------------------------------------------------------------------
# Kernel benchmarks
# ---------------------------------------------------------------------------


def _bench_op(fn, x0, n_iter: int, reps: int = 3, op_args=()) -> float:
    """Time per application of the self-composable ``fn(x, *op_args)``:
    chains of ``n_iter`` applications between CUDA events (bench/timing.py)."""
    from dune_eigensolver_tpu_torch.bench.timing import bench_loop

    return bench_loop(fn, x0, K=n_iter, reps=reps, op_args=op_args)


def mgs_performance_test(ptree) -> dict:
    """Reference cc:164-311: orthonormalization throughput, naive (block=1
    column MGS) vs blocked (Cholesky-QR per block), with the roofline
    models. Result line mirrors ``P_n_m_i_iblocked_perfn_perfb_perfv``."""
    from dune_eigensolver_tpu_torch.bench.models import (
        bytes_orthonormalize_blocked,
        bytes_orthonormalize_naive,
        flops_orthonormalize,
    )
    from dune_eigensolver_tpu_torch.ops.ortho import orthonormalize_blocked
    from dune_eigensolver_tpu_torch.solvers.standard import random_multivector

    n = 1 << int(ptree["mgs.n"])
    m = int(ptree["mgs.m"])
    n_iter = int(ptree["mgs.n_iter"])
    dt = _dtype(ptree)
    device = _device(ptree)
    gen = torch.Generator(device=device).manual_seed(int(ptree["ev.seed"]))
    X = random_multivector(gen, n, m, dt, device)

    t_naive = _bench_op(lambda V: orthonormalize_blocked(V, block=1), X, n_iter=n_iter)
    block = int(ptree["ev.block"])
    t_blocked = _bench_op(
        lambda V: orthonormalize_blocked(V, block=block), X, n_iter=n_iter
    )

    fl = flops_orthonormalize(n, m)
    gf_n, gf_b = fl / t_naive / 1e9, fl / t_blocked / 1e9
    int_n = fl / bytes_orthonormalize_naive(n, m, dt.itemsize)
    int_b = fl / bytes_orthonormalize_blocked(n, m, block, dt.itemsize)
    _log(ptree, 1, f"  naive:   {t_naive*1e6:.0f}us  {gf_n:.1f} GFLOP/s  AI={int_n:.2f}")
    _log(ptree, 1, f"  blocked: {t_blocked*1e6:.0f}us  {gf_b:.1f} GFLOP/s  AI={int_b:.2f}")
    print(
        f"P_n_m_i_perfn_perfb: 1 {n} {m} {n_iter} {gf_n:.2f} {gf_b:.2f}",
        flush=True,
    )
    return dict(gflops_naive=gf_n, gflops_blocked=gf_b)


def matvec_gather_operands(N: int, dtype, device):
    """The general-sparsity operands of ``matvec``: the elasticity operator
    on a ``max(2, N // 2)`` grid as 2x2 BSR and scalar-expanded to ELL — the
    operand class the reference streams as raw CSR/BCRS
    (kernels_cpp.hh:626-657) — scaled by its max row sum so that chained
    applications stay bounded (the DIA operand is pre-scaled the same way)."""
    from dune_eigensolver_tpu_torch.sparse import problems
    from dune_eigensolver_tpu_torch.sparse.formats import bsr_from_scipy, ell_from_scipy

    Ab, _ = problems.elasticity_2d(max(2, N // 2), dtype=torch.float64, device="cpu")
    Sa = Ab.to_scipy()
    Sa = Sa / float(np.abs(Sa).sum(axis=1).max())
    return (bsr_from_scipy(Sa, block=Ab.block, dtype=dtype, device=device),
            ell_from_scipy(Sa, dtype=dtype, device=device))


def matvec_performance_test(ptree) -> dict:
    """Reference cc:315-427: tall-skinny SpMM throughput, the plain PyTorch
    versions against the CUDA kernels. The reference's windowed planner and
    its ``pallas_padded`` variant (the guarded layout) have no counterpart
    in the port."""
    from dune_eigensolver_tpu_torch.bench.models import bytes_spmm_dia, flops_spmm
    from dune_eigensolver_tpu_torch.kernels.dia_spmm import (
        dia_spmm_t_cuda,
        dia_spmm_t_reference,
    )
    from dune_eigensolver_tpu_torch.kernels.gather_spmm import (
        bsr_spmm_t_cuda,
        bsr_spmm_t_reference,
        ell_spmm_t_cuda,
        ell_spmm_t_reference,
    )
    from dune_eigensolver_tpu_torch.sparse import problems
    from dune_eigensolver_tpu_torch.sparse.formats import DIAMatrix

    N = int(ptree["ev.N"])
    m = int(ptree["mv.m"])
    dt = _dtype(ptree)
    device = _device(ptree)
    on_card = device.type == "cuda"
    A = problems.laplacian_dirichlet_2d(N, dtype=dt, device=device)
    A = DIAMatrix(data=A.data / 8.0, offsets=A.offsets, shape=A.shape)
    n, nnz = A.shape[0], A.nnz
    gen = torch.Generator(device=device).manual_seed(0)
    X = torch.randn((n, m), generator=gen, dtype=dt, device=device)
    Xt = X.T.contiguous()

    results = {}
    # the column-layout form transposes around the plain product, so that
    # the plain variants stay plain on the card too
    variants = [
        ("plain", lambda V, M: dia_spmm_t_reference(M, V.T.contiguous()).T.contiguous(), X),
        ("plain_t", lambda V, M: dia_spmm_t_reference(M, V), Xt),
    ]
    if on_card:
        variants.append(("cuda_t", lambda V, M: dia_spmm_t_cuda(M, V), Xt))
    for name, fn, x0 in variants:
        t = _bench_op(fn, x0, n_iter=20, op_args=(A,))
        gf = flops_spmm(nnz, m) / t / 1e9
        gb = bytes_spmm_dia(n, len(A.offsets), m, dt.itemsize) / t / 1e9
        results[name] = gf
        print(
            f"RESULT {name} {n} {nnz} {m} {gf:.2f} GFLOP/s {gb:.1f} GB/s",
            flush=True,
        )

    Mb, Me = matvec_gather_operands(N, dt, device)
    for name, M, plain, kernel in (
        ("bsr", Mb, bsr_spmm_t_reference, bsr_spmm_t_cuda),
        ("ell", Me, ell_spmm_t_reference, ell_spmm_t_cuda),
    ):
        Xw = torch.randn((m, M.shape[0]), generator=gen, dtype=dt, device=device)
        for variant, op in ((f"{name}_plain", plain), (f"{name}_cuda", kernel)):
            if op is kernel and not on_card:
                continue
            t = _bench_op(lambda V, M_, op=op: op(M_, V), Xw, n_iter=20, op_args=(M,))
            gf = flops_spmm(M.nnz, m) / t / 1e9
            # effective bytes: coefficients+indices once, X and Y once. The
            # reference's model: one index per scalar nonzero, which counts
            # 4x the indices a 2x2 BSR operand holds (one per block)
            bts = (2 * M.nnz + 2 * M.shape[0] * m) * dt.itemsize
            results[variant] = gf
            print(
                f"RESULT {variant} {M.shape[0]} {M.nnz} {m} "
                f"{gf:.2f} GFLOP/s {bts / t / 1e9:.1f} GB/s",
                flush=True,
            )
    return results


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def scaling_test(ptree):
    """Weak scaling over the process group's ranks (``bench/scaling.py``)."""
    from dune_eigensolver_tpu_torch.bench.scaling import scaling_test as run

    return run(ptree, device=_device(ptree))


TESTS = {
    "largest": largest_eigenvalues_convergence_test,
    "smallest": smallest_eigenvalues_convergence_test,
    "eigenvalues": eigenvalues_test,
    "mgs": mgs_performance_test,
    "matvec": matvec_performance_test,
    "scaling": scaling_test,
}


def _join_group(device: torch.device):
    """Make sure a process group exists for the distributed protocols:
    under ``torchrun`` (``RANK``/``WORLD_SIZE`` set) join the launcher's,
    else start a world-size-1 group on a ``FileStore`` in a temporary
    directory. Returns the cleanup to call after the tests (ends the group
    this call started; nothing for one that was there)."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from dune_eigensolver_tpu_torch.dist import init_distributed

    if dist.is_initialized():
        return lambda: None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":  # one card a rank
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        init_distributed(device, init_method="env://")
        return dist.destroy_process_group
    tmp = tempfile.mkdtemp(prefix="cli_group_")
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    init_distributed(device, store=store, rank=0, world_size=1)

    def cleanup():
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    return cleanup


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    test = "largest"  # the test the reference main() runs (cc:777)
    if "--test" in argv:
        i = argv.index("--test")
        test = argv[i + 1]
        del argv[i : i + 2]
    ptree = ParameterTree()
    if argv and "=" not in argv[0]:
        ptree.read_ini(argv.pop(0))
    ptree.read_cli(argv)

    names = list(TESTS) if test == "all" else [test]
    for name in names:
        if name not in TESTS:
            print(f"unknown test {name!r}; choose from {sorted(TESTS)} or 'all'")
            return 2

    from dune_eigensolver_tpu_torch.utils import paranoid
    from dune_eigensolver_tpu_torch.utils.vlog import profiler_trace

    device = _device(ptree)
    needs_group = "scaling" in names or (
        "eigenvalues" in names and str(ptree["ev.method"]) in ("dist", "dist_general"))
    leave_group = _join_group(device) if needs_group else (lambda: None)
    if needs_group:
        device = _device(ptree)  # under torchrun: this rank's card
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    _log(ptree, 1, f"device: {kind} platform={device.type}")
    _log(ptree, 2, repr(ptree))
    was_paranoid = paranoid.paranoid_enabled()
    if int(ptree.get("ev.paranoid", 0)):
        # the NaN tripwire on every kernel dispatch; alarms print after each test
        paranoid.set_paranoid(True)
    try:
        with profiler_trace(ptree.get("ev.profile_dir")):
            for name in names:
                _log(ptree, 1, f"== {name} ==")
                TESTS[name](ptree)
                paranoid.report()
    finally:
        paranoid.set_paranoid(was_paranoid)
        leave_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
