#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; one GPU

Phases (any failure raises and exits non-zero; there is no fallback):

1. device   — requires ``torch.cuda.is_available()``; prints the card.
2. build    — compiles ``dune_eigensolver_tpu_torch/csrc/*.cu`` with nvcc
              into the package's ``_build/`` and prints ptxas' report.
3. kernel   — the CUDA DIA SpMM against its plain PyTorch version on the
              card, at the main path's shapes (2D N=2048 m=8; 3D N=216
              m=24/72 in f32 and bf16; 3D N=37, whose n is not a multiple
              of the 256-thread block), each with its tolerance; median
              times of both with CUDA events, and GB/s under the byte model
              ``(ndiag*n + 2*n*m) * itemsize``.
4. solve    — the north-star recipe through the port's entry points:
              ``lobpcg_nested`` on the 3D 7-point Dirichlet Laplacian, first
              at N=24 against the analytic spectrum, then at N=216
              (10,077,696 dof) twice, timing the second run. The kernel's
              launch counter is zeroed just before the timed run and read
              just after; the run must converge, be finite, launch the
              kernel, and match the analytic smallest 20 to 1e-5.
5. spread   — two more timed 216^3 solves, then one under torch.profiler:
              device time, device operations, and the device's busy share
              of the unprofiled solve, with the top of the operator table.
6. gather   — the CUDA ELL and BSR SpMMs against their plain PyTorch
              versions on the card, f32, at the general-sparsity path's
              shapes (elasticity_2d(512) as 2x2 BSR at m=8 and 24 and
              scalar-expanded to ELL at m=24; elasticity_2d(96) BSR at
              m=128; the RCM-ordered 2^20-node unstructured graph Laplacian
              as ELL at m=8 and 24; a 100,003-row graph, whose n is not a
              multiple of the 256-thread block; the operands of the CLI's
              ``matvec`` at ev.N=2048, elasticity_2d(1024) scaled by its
              max row sum as BSR and as ELL at m=8), with median times of
              both and GFLOP/s as 2*nnz*m/t.
7. geneo    — the GenEO elasticity pencil at full size: elasticity_2d(512)
              f32 (n = 522,242) through ``lobpcg_generalized`` with the
              cg25 Jacobi-CG preconditioner, twice, timing the second run;
              converged, finite, BSR kernel launched, and the smallest 8
              within 1e-2 (relative) of scipy/ARPACK shift-invert.
8. flagship — ``generalized_inverse`` on elasticity_2d(96) at nev=124
              (the m=128 production GenEO block) with a CG inverse, twice,
              timing the second; within 5e-2 of the oracle; then nev=4 on
              the same pencil within 1e-2.
9. graph    — the RCM-ordered 2^20-node unstructured graph Laplacian (ELL)
              through ``lobpcg_generalized`` with the cg25 preconditioner
              and an identity ELL mass, twice, timing the second; every
              Ritz pair's relative residual within 0.1; the same recipe at
              n = 20,000 within 2e-2 of the oracle.

10. copy    — the copy probe's three kernels (csrc/copy_probe.cu) against
              their plain versions (exact), at an odd width and at the
              multivector's shape.
11. variants — the DIA staging variants (csrc/dia_variants.cu: C, B at
              (2,1), (3,2), (4,3), D, D in place) against the plain DIA
              product at two n that are no multiple of the tile (one of
              them odd), one application and the 2-chain (1e-5 of max|R|).
12. measure — the measurement path through its entry points, every launch
              counter zeroed just before and read just after:
              ``cli.main`` with ``--test matvec ev.N=2048 mv.m=8`` and
              ``--test mgs`` (n = 2^20, m = 16), then the tables the two
              experiment modules' ``main`` print: ``copy_table`` (the
              library's 1-D and 2-D copies, the hand-written copy over its
              tile sweep, copy + coefficient stream, in place) as ``COPY``
              lines and one ``ROOFLINE`` line with ``copy_gbps``, the best
              out-of-place rate; ``variant_table`` (2D N=2048 m=8 f32, each
              variant held to the plain product at 1e-5 of max|R| over one
              application and the 2-chain, then timed) as ``VARIANT`` lines
              with ms, GB/s under ``bytes_spmm_dia`` and the share of
              ``copy_gbps``, the shipped kernel and the plain version
              beside them. Every ``RESULT`` number must be finite and every
              kernel's counter must have moved. Then the copy kernels'
              rows of the kernel table, at the sweep's best tile.
13. library — one PyTorch call computing the same function, where there is
              one: ``torch.sparse.mm`` on a CSR tensor for the DIA and ELL
              operands and on a BSR tensor for the BSR operand, at the
              kernel table's shapes, held to the kernel's result. An
              installation that refuses a layout gets its error text
              printed in the row (the only exception caught here, around
              the library's constructor and first product alone).

Each solve phase zeroes every kernel's launch counter just before its
timed run and reads the counters just after; a phase whose kernel was not
launched fails. Results flagged PLATEAU have an oracle error above 5x the
change-based stopping tolerance (the reference's own flag).

Output: progress lines, then one JSON line with the kernel table (each
kernel's launches from the timed run of its own path: DIA phase 4, BSR
phase 7, ELL phase 9, the probe and variant kernels phase 12; ``bound_ms``
is the larger of bytes / 3.35 TB/s and flops / 67 TFLOP/s, the card's
published rates, over the least bytes the function needs: coefficients,
one index per scalar (ELL) or per block (BSR), X and Y once; row 0 of the
copy probe's ``d``, whose other rows the kernel streams by design;
``copy_bound_ms`` is the same bytes over the measured ``copy_gbps``), then the card's name and power limit as nvidia-smi reports
them, then the last line ``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=7, inner=5):
    """Median over ``reps`` of the mean time of ``inner`` calls, by CUDA
    events around each group, after at least two warm-up calls and 30 ms of
    them (a card left idle by host work has dropped its clocks)."""
    import torch

    t0 = time.perf_counter()
    calls = 0
    while calls < 2 or time.perf_counter() - t0 < 0.03:
        fn()
        torch.cuda.synchronize()
        calls += 1
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def phase_kernel(torch, kd, problems):
    """Kernel against plain version; returns the per-case records."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("2d N=2048 m=8 f32", 2, 2048, 8, torch.float32),
        ("3d N=216 m=24 f32", 3, 216, 24, torch.float32),
        ("3d N=216 m=72 f32", 3, 216, 72, torch.float32),
        ("3d N=216 m=24 bf16", 3, 216, 24, torch.bfloat16),
        ("3d N=216 m=72 bf16", 3, 216, 72, torch.bfloat16),
        ("3d N=37 m=24 f32", 3, 37, 24, torch.float32),
        ("3d N=37 m=24 bf16", 3, 37, 24, torch.bfloat16),
    ]
    records = []
    for name, dim, N, m, dtype in cases:
        build = problems.laplacian_dirichlet_2d if dim == 2 else problems.laplacian_dirichlet_3d
        A32 = build(N, dtype=torch.float32, device="cuda")
        A = type(A32)(data=A32.data.to(dtype), offsets=A32.offsets, shape=A32.shape)
        del A32
        n = A.shape[0]
        X = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
        Y = kd.dia_spmm_t_cuda(A, X)
        R = kd.dia_spmm_t_reference(A, X)
        torch.cuda.synchronize()
        if not torch.isfinite(Y).all():
            raise RuntimeError(f"{name}: kernel output not finite")
        err = (Y.float() - R.float()).abs().max().item()
        scale = R.float().abs().max().item()
        # f32: same sum, FMA-contracted; bf16: both round one f32 sum, at
        # most one bf16 ulp (2^-7 of the binade) apart
        tol = (1e-5 if dtype == torch.float32 else 1e-2) * scale
        if not err <= tol:
            raise RuntimeError(f"{name}: max_abs_err {err:.3e} > tol {tol:.3e}")
        del Y, R
        ms = median_ms(lambda: kd.dia_spmm_t_cuda(A, X))
        plain_ms = median_ms(lambda: kd.dia_spmm_t_reference(A, X), reps=5, inner=2)
        nbytes = (len(A.offsets) * n + 2 * n * m) * X.element_size()
        rec = dict(case=name, n=n, m=m, max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain_ms, gbps=nbytes / ms / 1e6,
                   plain_gbps=nbytes / plain_ms / 1e6)
        log("KERNEL " + json.dumps(rec))
        records.append(rec)
        del A, X
        torch.cuda.empty_cache()
    return records


def north_star(torch, N, problems, DIAMatrix, lobpcg_nested, mg_inverse_factory):
    """The bench's north-star call (bench.py) through the port."""
    A3 = problems.laplacian_dirichlet_3d(N, dtype=torch.float32, device="cuda")
    n = A3.shape[0]
    B3 = DIAMatrix(data=torch.ones((1, n), device="cuda"), offsets=(0,), shape=A3.shape)
    prec = mg_inverse_factory(nu1=1, nu2=1, dtype=torch.bfloat16)
    return lambda: lobpcg_nested(  # noqa: E731
        A3, B3, nev=24, tol=2e-3, maxiter=300, shift=0.0,
        min_coarse=48, coarse_tol=2e-4, precond=prec,
        ortho_iterations=1, ortho_block=24, b_identity=True,
    )


def check_result(torch, res, N, nev_err, tol_err, exact):
    ev = check_solve(torch, f"N={N}", res, N**3, 24)
    err = float(np.abs(np.sort(ev)[:nev_err] - exact).max())
    if not err <= tol_err:
        raise RuntimeError(f"N={N}: max_err {err:.3e} > {tol_err:.0e}")
    return err


def profile_solve(torch, run, t_solve):
    """Phase 5: spread of the solve time, and where the device time goes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reps = []
    for _ in range(2):
        t0 = time.perf_counter()
        run().eigenvalues.cpu()
        reps.append(time.perf_counter() - t0)
    log(f"REPEAT seconds {json.dumps(reps)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run().eigenvalues.cpu()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    # the profiler slows the host many times over, so the busy share is the
    # device time over the UNPROFILED solve's wall time
    log(f"PROFILE device time {busy_s:.3f} s in {sum(e.count for e in kernels)} "
        f"device operations; busy share {100 * busy_s / t_solve:.1f}% of the "
        f"{t_solve:.3f} s solve (profiled wall {wall:.3f} s)")
    table = events.table(sort_by="self_device_time_total", row_limit=25,
                         max_name_column_width=60)
    log(table)


def set_counts(kernels, value=0):
    for fn in kernels.values():
        fn.launches = value


def read_counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def relerr(ev, ref):
    """The reference's oracle error: max |lambda - lambda_ref| / max |lambda_ref|."""
    return float(np.abs(np.sort(ev)[: len(ref)] - ref).max() / np.abs(ref).max())


def plateau(err, tol):
    """The reference's flag for a change-based stop that left the oracle
    error above 5x tol (experiments/windowed_solve_tpu.py)."""
    return bool(err > 5 * tol)


def timed_twice(torch, run, kernels):
    """Run ``run`` twice; time the second with every launch counter zeroed
    just before it and read just after. Returns (result, record)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run().eigenvalues.cpu()
    t_first = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_counts(kernels)
    t0 = time.perf_counter()
    res = run()
    res.eigenvalues.cpu()
    seconds = time.perf_counter() - t0
    launches = read_counts(kernels)
    return res, dict(seconds=seconds, first_run_seconds=t_first,
                     iterations=int(res.iterations), converged=bool(res.converged),
                     launches=launches, peak_bytes=torch.cuda.max_memory_allocated())


def check_solve(torch, name, res, n, nev):
    """Finite eigenpairs of the expected shapes from a converged run."""
    ev = res.eigenvalues.cpu().numpy()
    if ev.shape != (nev,) or not np.isfinite(ev).all():
        raise RuntimeError(f"{name}: eigenvalues {ev}")
    if tuple(res.eigenvectors.shape) != (n, nev) or not torch.isfinite(res.eigenvectors).all():
        raise RuntimeError(f"{name}: eigenvectors {tuple(res.eigenvectors.shape)} not finite")
    if not bool(res.converged):
        raise RuntimeError(f"{name}: not converged after {int(res.iterations)} iterations")
    return ev


def phase_gather(torch, kg, cases):
    """Phase 6: the ELL and BSR kernels against their plain versions."""
    from dune_eigensolver_tpu_torch.sparse import BSRMatrix

    gen = torch.Generator(device="cuda").manual_seed(1)
    records = []
    for name, A, m in cases:
        if isinstance(A, BSRMatrix):
            kernel, plain, field = kg.bsr_spmm_t_cuda, kg.bsr_spmm_t_reference, "bdata"
        else:
            kernel, plain, field = kg.ell_spmm_t_cuda, kg.ell_spmm_t_reference, "data"
        n = A.shape[0]
        X = torch.randn((m, n), generator=gen, device="cuda")
        before = kernel.launches
        Y = kernel(A, X)
        R = plain(A, X)
        torch.cuda.synchronize()
        if kernel.launches != before + 1 or not torch.isfinite(Y).all():
            raise RuntimeError(f"{name}: kernel did not launch or gave non-finite values")
        err = (Y - R).abs().max().item()
        # both sum the same f32 products of a row in other orders: at most a
        # few k*2^-24 of the row's |A|.|X|, held at 1e-5 of its largest
        absA = dataclasses.replace(A, **{field: getattr(A, field).abs()})
        tol = 1e-5 * plain(absA, X.abs()).max().item()
        if not err <= tol:
            raise RuntimeError(f"{name}: max_abs_err {err:.3e} > tol {tol:.3e}")
        del Y, R, absA
        ms = median_ms(lambda: kernel(A, X))
        plain_ms = median_ms(lambda: plain(A, X), reps=5, inner=2)
        flops = 2.0 * A.nnz * m
        # launches of this case: the check, the warm-up and 7x5 timed
        rec = dict(case=name, kernel=kernel.__name__, n=n, nnz=A.nnz, m=m,
                   launches=kernel.launches - before,
                   max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                   gflops=flops / ms / 1e6, plain_gflops=flops / plain_ms / 1e6)
        log("GATHER " + json.dumps(rec))
        records.append(rec)
        del X
        torch.cuda.empty_cache()
    return records


def phase_geneo(torch, kernels, A, B):
    """Phase 7: bench.py's fast-path recipe on the 522k elasticity pencil,
    against scipy/ARPACK shift-invert on the host (its seconds printed)."""
    from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory
    from dune_eigensolver_tpu_torch.oracle import smallest_generalized
    from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized

    prec = cg_inverse_factory(rtol=1e-2, maxiter=25)

    def run():
        return lobpcg_generalized(A, B, nev=8, tol=2e-3, maxiter=300, shift=1e-3,
                                  precond=prec)

    res, rec = timed_twice(torch, run, kernels)
    ev = check_solve(torch, "geneo", res, A.shape[0], 8)
    if rec["launches"]["bsr_spmm_t"] <= 0:
        raise RuntimeError("geneo: the solve launched the BSR kernel no time")
    del res
    t0 = time.perf_counter()
    ref, _ = smallest_generalized(A, B, nev=8, sigma=-1e-3)
    err = relerr(ev, ref)
    rec.update(n=A.shape[0], nev=8, eigenvalues=ev.tolist(),
               oracle_seconds=time.perf_counter() - t0, relerr=err,
               plateau=plateau(err, 2e-3))
    log("GENEO " + json.dumps(rec))
    if not err <= 1e-2:
        raise RuntimeError(f"geneo: relerr {err:.3e} > 1e-2")
    return rec


def phase_flagship(torch, kernels, A, B):
    """Phase 8: generalized_inverse at the m=128 production GenEO block."""
    from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory
    from dune_eigensolver_tpu_torch.oracle import smallest_generalized
    from dune_eigensolver_tpu_torch.solvers import generalized_inverse

    inv = cg_inverse_factory(rtol=1e-5, maxiter=1000)
    out = []
    for nev, gate in ((124, 5e-2), (4, 1e-2)):
        def run(nev=nev):
            return generalized_inverse(A, B, nev=nev, tol=2e-3, maxiter=300, shift=1e-3,
                                       inverse=inv)

        res, rec = timed_twice(torch, run, kernels)
        ev = check_solve(torch, f"flagship nev={nev}", res, A.shape[0], nev)
        if rec["launches"]["bsr_spmm_t"] <= 0:
            raise RuntimeError(f"flagship nev={nev}: the solve launched the BSR kernel no time")
        del res
        t0 = time.perf_counter()
        ref, _ = smallest_generalized(A, B, nev=nev, sigma=-1e-3)
        err = relerr(ev, ref)
        rec.update(n=A.shape[0], nev=nev, m=-(-nev // 8) * 8,
                   oracle_seconds=time.perf_counter() - t0, relerr=err, gate=gate,
                   plateau=plateau(err, 2e-3))
        log(f"FLAGSHIP nev={nev} " + json.dumps(rec))
        if not err <= gate:
            raise RuntimeError(f"flagship nev={nev}: relerr {err:.3e} > {gate:.0e}")
        out.append(rec)
    return out


def phase_graph(torch, kernels, Au, small):
    """Phase 9: the RCM-ordered unstructured graph Laplacian (ELL)."""
    import scipy.sparse as sp

    from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory
    from dune_eigensolver_tpu_torch.oracle import smallest_standard
    from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized
    from dune_eigensolver_tpu_torch.sparse import ell_from_scipy, spmm_t

    def recipe(A_):
        B_ = ell_from_scipy(sp.eye(A_.shape[0]), dtype=A_.dtype, device=A_.device)
        prec = cg_inverse_factory(rtol=1e-2, maxiter=25)
        return lambda: lobpcg_generalized(  # noqa: E731
            A_, B_, nev=4, tol=2e-3, maxiter=300, shift=1e-3, precond=prec,
        )

    n = Au.shape[0]
    res, rec = timed_twice(torch, recipe(Au), kernels)
    ev = check_solve(torch, "graph", res, n, 4)
    if rec["launches"]["ell_spmm_t"] <= 0:
        raise RuntimeError("graph: the solve launched the ELL kernel no time")
    Xt = res.eigenvectors.T.contiguous()
    AX = spmm_t(Au, Xt)
    resid = ((AX - res.eigenvalues[:, None] * Xt).norm(dim=1) / AX.norm(dim=1)).cpu().numpy()
    rec.update(n=n, nev=4, eigenvalues=ev.tolist(), residuals=resid.tolist())
    if not (resid <= 0.1).all():
        raise RuntimeError(f"graph: relative residuals {resid} > 0.1")
    del res, Xt, AX
    S, A20 = small
    res = recipe(A20)()
    ev20 = check_solve(torch, "graph n=20000", res, A20.shape[0], 4)
    ref, _ = smallest_standard(S, nev=4, sigma=-1e-3)
    err = relerr(ev20, ref)
    rec.update(small_n=A20.shape[0], small_iterations=int(res.iterations), small_relerr=err,
               small_plateau=plateau(err, 2e-3))
    log("GRAPH " + json.dumps(rec))
    if not err <= 2e-2:
        raise RuntimeError(f"graph n=20000: relerr {err:.3e} > 2e-2")
    return rec


HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, published


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def exact_or_raise(name, Y, R):
    err = (Y - R).abs().max().item()
    if err != 0.0:
        raise RuntimeError(f"{name}: max_abs_err {err:.3e}, expected exactly 0")
    return err


def phase_copy_check(torch, pp):
    """Phase 10: the copy kernels against their plain versions. Returns the
    operands of the multivector's shape and each kernel's max_abs_err there."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    # an odd width (4-byte accesses) first, then the multivector's shape
    for rows, width, tile in ((3, 100_003, 1000), (8, pp.WIDTH, 32768)):
        x = torch.randn((rows, width), generator=gen, device="cuda")
        d = torch.randn((5, width), generator=gen, device="cuda")
        before = (pp.ident.launches, pp.identd.launches, pp.ident_alias.launches)
        # one f32 add per element in kernel and plain version alike: 0 ulp
        errs = dict(
            ident=exact_or_raise("ident", pp.ident(tile, x), pp.ident_reference(x)),
            identd=exact_or_raise("identd", pp.identd(tile, d, x), pp.identd_reference(d, x)),
        )
        xa = x.clone()
        if pp.ident_alias(tile, xa) is not xa:
            raise RuntimeError("ident_alias did not return its argument")
        errs["ident_alias"] = exact_or_raise("ident_alias", xa, pp.ident_reference(x))
        torch.cuda.synchronize()
        after = (pp.ident.launches, pp.identd.launches, pp.ident_alias.launches)
        if after != tuple(b + 1 for b in before):
            raise RuntimeError(f"copy kernels: launch counters {before} -> {after}")
        log(f"copy check ({rows}, {width}) tile {tile}: exact")
        del xa
    return x, d, errs


def phase_variant_check(torch, kv, kd, problems, DIAMatrix):
    """Phase 11: the staging variants against the plain DIA product where n
    is no multiple of the tile (the full-size check is the table's own)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    # 45^2 = 2025 is odd (4-byte copies), 46^2 = 2116 a multiple of 4
    # (16-byte copies); the tile of 256 holds the halo
    for N in (45, 46):
        A = problems.laplacian_dirichlet_2d(N, dtype=torch.float32, device="cuda")
        A = DIAMatrix(data=A.data / 8.0, offsets=A.offsets, shape=A.shape)
        X = torch.randn((8, N * N), generator=gen, device="cuda")
        R = kd.dia_spmm_t_reference(A, X)
        R2 = kd.dia_spmm_t_reference(A, R)
        # the same sum as the plain version, FMA-contracted: 1e-5 of max|R|
        # (as phase 3), for one application and for the 2-chain
        tol = 1e-5 * R.abs().max().item()
        for name, step in kv.variant_steps(tile=256)[1:]:
            Y = step(X.clone(), A)  # on clones: the in-place form overwrites
            Y2 = step(Y.clone(), A)
            torch.cuda.synchronize()
            err = max((Y - R).abs().max().item(), (Y2 - R2).abs().max().item())
            if not err <= tol:  # a NaN fails too
                raise RuntimeError(f"{name} N={N}: max_abs_err {err:.3e} > tol {tol:.3e}")
            log(f"variant check {name} n={N * N} tile 256: max_abs_err {err:.3e}")


class Tee(io.StringIO):
    """Collects what is printed and passes it on."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)

    def flush(self):
        self.out.flush()


def phase_measure(torch, kernels, pp, kv):
    """Phase 12: the measurement path through its entry points, inside one
    counted window. Returns (launches, copy table, variant table)."""
    from dune_eigensolver_tpu_torch import cli

    torch.cuda.synchronize()
    set_counts(kernels)
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        ini = os.path.join(ROOT, "dune-eigensolver.ini")
        for argv in ([ini, "--test", "matvec", "ev.N=2048", "mv.m=8"], [ini, "--test", "mgs"]):
            rc = cli.main(argv)
            if rc != 0:
                raise RuntimeError(f"cli.main({argv}) returned {rc}")
    copy_rows = []
    for label, t, gbps, kind in pp.copy_table(None):
        log("COPY " + json.dumps(dict(case=label, kind=kind, us=t * 1e6, gbps=gbps)))
        copy_rows.append((label, t, gbps, kind))
    copy_gbps = max(g for label, _, g, _ in copy_rows if "ALIASED" not in label)
    best_tile = max((g, label) for label, _, g, kind in copy_rows
                    if kind == "kernel" and label.startswith("ident T="))[1]
    best_tile = int(best_tile.split("=")[1])
    log("ROOFLINE " + json.dumps(dict(copy_gbps=copy_gbps, best_ident_tile=best_tile)))
    variants = {}
    for label, t, gbps, err in kv.variant_table(None):
        rec = dict(ms=t * 1e3, gbps=gbps, share_of_copy=gbps / copy_gbps, max_abs_err=err)
        log("VARIANT " + json.dumps(dict(variant=label, **rec)))
        variants[label.split(" T=")[0]] = rec
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    seconds = time.perf_counter() - t0
    results = {}
    for line in tee.getvalue().splitlines():
        f = line.split()
        if f[:1] == ["RESULT"]:
            # RESULT <variant> n nnz m <GFLOP/s> GFLOP/s <GB/s> GB/s
            results[f[1]] = (float(f[5]), float(f[7]))
        elif f[:1] == ["P_n_m_i_perfn_perfb:"]:
            results["mgs"] = (float(f[5]), float(f[6]))
    want = {"plain", "plain_t", "cuda_t", "bsr_plain", "bsr_cuda", "ell_plain", "ell_cuda", "mgs"}
    if set(results) != want:
        raise RuntimeError(f"cli: result lines {sorted(results)}, expected {sorted(want)}")
    bad = {k: v for k, v in results.items() if not all(np.isfinite(x) and x > 0 for x in v)}
    if bad:
        raise RuntimeError(f"cli: non-finite or non-positive results {bad}")
    idle = [name for name, count in launches.items() if count <= 0]
    if idle:
        raise RuntimeError(f"cli: kernels launched no time on the measurement path: {idle}")
    log("CLI " + json.dumps(dict(seconds=seconds, launches=launches, results=results)))
    return launches, dict(copy_gbps=copy_gbps, best_tile=best_tile), variants


def copy_kernel_rows(torch, pp, x, d, errs, tile):
    """The kernel table's rows of the three copy kernels at the
    multivector's shape, each beside its plain version (one PyTorch call,
    so the library call too), by the probe's own timing helper."""
    from dune_eigensolver_tpu_torch.bench.timing import bench_loop

    xbytes = 2 * x.numel() * 4
    recs = {}
    for name, step, plain, nbytes, streamed in (
        ("ident", lambda v: pp.ident(tile, v), pp.ident_reference, xbytes, xbytes),
        # the function needs row 0 of d; the kernel streams all five rows
        ("identd", lambda v: pp.identd(tile, d, v), lambda v: pp.identd_reference(d, v),
         xbytes + d.shape[1] * 4, xbytes + d.numel() * 4),
        ("ident_alias", lambda v: pp.ident_alias(tile, v), lambda v: v.add_(1.0), xbytes, xbytes),
    ):
        ms = bench_loop(step, x.clone(), K=30) * 1e3
        plain_ms = bench_loop(plain, x.clone(), K=30) * 1e3
        recs[name] = dict(case=f"({x.shape[0]}, {x.shape[1]}) f32 tile {tile}",
                          max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, library_ms=plain_ms,
                          nbytes=nbytes, flops=x.numel(),  # one add per element
                          streamed_bytes=streamed, streamed_gbps=streamed / ms / 1e6)
        log("COPYKERNEL " + json.dumps(dict(kernel=name, **recs[name])))
    return recs


def csr_arrays(torch, A):
    """(crow, col, values) of the operand in CSR order (block CSR for a
    BSRMatrix), int32 indices, on the card; padding and out-of-range
    entries dropped."""
    from dune_eigensolver_tpu_torch.sparse import BSRMatrix, DIAMatrix

    n = A.shape[0]
    if isinstance(A, DIAMatrix):
        i = torch.arange(n, device=A.device)
        cols = i[:, None] + torch.tensor(A.offsets, device=A.device)[None, :]
        keep = (cols >= 0) & (cols < n)
        vals = A.data.T
    elif isinstance(A, BSRMatrix):
        cols, vals = A.bcols, A.bdata
        keep = (vals != 0).any(dim=3).any(dim=2)
    else:
        cols, vals = A.cols, A.data
        keep = vals != 0
    crow = torch.zeros(keep.shape[0] + 1, dtype=torch.int32, device=A.device)
    crow[1:] = torch.cumsum(keep.sum(dim=1), dim=0)
    return crow, cols[keep].to(torch.int32), vals[keep].contiguous()


def phase_library(torch, cases):
    """Phase 13: ``torch.sparse.mm`` beside each SpMM kernel. ``cases``:
    (name, operand, Xt, kernel wrapper). Returns {name: ms or None}."""
    out = {}
    for name, A, Xt, kernel in cases:
        Y = kernel(A, Xt)
        X = Xt.T.contiguous()  # (n, m), the layout the library call takes
        bsr = hasattr(A, "bdata")
        rec = dict(case=name, layout="bsr" if bsr else "csr")
        arrays = csr_arrays(torch, A)
        torch.cuda.synchronize()  # a fault of the port's own code surfaces here
        try:
            make = torch.sparse_bsr_tensor if bsr else torch.sparse_csr_tensor
            S = make(*arrays, size=A.shape)
            Z = torch.sparse.mm(S, X)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:  # the library's refusal of a layout
            rec.update(library_ms=None, refused=f"{type(e).__name__}: {str(e)[:200]}")
            log("LIBRARY " + json.dumps(rec))
            out[name] = None
            continue
        err = (Z.T - Y).abs().max().item()
        scale = Y.abs().max().item()
        # the same products summed in another order: 1e-5 of the largest |Y|
        if not err <= 1e-5 * scale:
            raise RuntimeError(f"library {name}: differs from the kernel by {err:.3e}")
        ms = median_ms(lambda: torch.sparse.mm(S, X))
        kernel_ms = median_ms(lambda: kernel(A, Xt))
        rec.update(library_ms=ms, kernel_ms=kernel_ms, kernel_speedup=ms / kernel_ms,
                   max_abs_diff=err)
        log("LIBRARY " + json.dumps(rec))
        out[name] = ms
        del S, Z, X, Y, arrays
        torch.cuda.empty_cache()
    return out


def main():
    import torch

    # --- phase 1: device ---
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import dune_eigensolver_tpu_torch  # noqa: F401  (sets TF32 off)
    from dune_eigensolver_tpu_torch import cli
    from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory
    from dune_eigensolver_tpu_torch.kernels import dia_spmm as kd
    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.oracle.analytic import eigenvalues_laplace_dirichlet_3d
    from dune_eigensolver_tpu_torch.solvers import lobpcg_nested
    from dune_eigensolver_tpu_torch.sparse import DIAMatrix, ell_from_scipy, problems, rcm_pencil
    from dune_eigensolver_tpu_torch.utils import native

    from dune_eigensolver_tpu_torch.experiments import kernel_variants as kv
    from dune_eigensolver_tpu_torch.experiments import pipeline_probe as pp

    kernels = {"dia_spmm_t": kd.dia_spmm_t_cuda, "ell_spmm_t": kg.ell_spmm_t_cuda,
               "bsr_spmm_t": kg.bsr_spmm_t_cuda, "spmm_c": kv.spmm_c, "spmm_b": kv.spmm_b,
               "spmm_d": kv.spmm_d, "ident": pp.ident, "identd": pp.identd,
               "ident_alias": pp.ident_alias}

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")

    # --- phase 2: build ---
    t0 = time.perf_counter()
    path, build_log = native.build()
    native.load()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(path, ROOT)}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  ptxas: " + line.strip())

    # --- phase 3: kernel against plain version ---
    records = phase_kernel(torch, kd, problems)

    # --- phase 4: the main path ---
    small = north_star(torch, 24, problems, DIAMatrix, lobpcg_nested, mg_inverse_factory)
    res = small()
    err24 = check_result(torch, res, 24, 20, 3e-4,
                         eigenvalues_laplace_dirichlet_3d(24, count=20))
    log(f"solve N=24: iterations {int(res.iterations)} max_err {err24:.3e} (limit 3e-4)")
    del res, small

    N3 = 216
    run = north_star(torch, N3, problems, DIAMatrix, lobpcg_nested, mg_inverse_factory)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run()
    res.eigenvalues.cpu()
    t_first = time.perf_counter() - t0
    peak_first = torch.cuda.max_memory_allocated()
    del res
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_counts(kernels)
    t0 = time.perf_counter()
    res = run()
    res.eigenvalues.cpu()
    t_solve = time.perf_counter() - t0
    launches = kd.dia_spmm_t_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    exact = eigenvalues_laplace_dirichlet_3d(N3, count=20)
    err = check_result(torch, res, N3, 20, 1e-5, exact)
    if launches <= 0:
        raise RuntimeError("the 216^3 solve launched the DIA kernel no time")
    log("SOLVE " + json.dumps(dict(
        n=N3**3, nev=20, seconds=t_solve, first_run_seconds=t_first,
        iterations=int(res.iterations), converged=bool(res.converged),
        max_err=err, dia_spmm_launches=launches, peak_bytes=peak,
        first_run_peak_bytes=peak_first,
    )))
    del res

    # --- phase 5: spread and profile ---
    profile_solve(torch, run, t_solve)
    del run
    torch.cuda.empty_cache()

    # --- phase 6: the gather kernels against their plain versions ---
    t0 = time.perf_counter()
    A512, B512 = problems.elasticity_2d(512, dtype=torch.float32, device="cuda")
    A96, B96 = problems.elasticity_2d(96, dtype=torch.float32, device="cuda")
    S_graph = problems.unstructured_laplacian(2**20, extra_edges=2**20 // 20, seed=5, fmt="scipy")
    A_graph = rcm_pencil(S_graph, dtype=torch.float32, device="cuda")[0]
    del S_graph
    S_odd = problems.unstructured_laplacian(100_003, extra_edges=5_000, seed=5, fmt="scipy")
    A_odd = rcm_pencil(S_odd, dtype=torch.float32, device="cuda")[0]
    E512 = ell_from_scipy(A512.to_scipy(), dtype=torch.float32, device="cuda")
    # the operands the CLI's matvec at ev.N=2048 gives the two kernels
    B1024, E1024 = cli.matvec_gather_operands(2048, torch.float32, "cuda")
    log(f"gather operands: {time.perf_counter() - t0:.1f} s host setup; "
        f"elasticity n={A512.shape[0]} nnz={A512.nnz}, graph n={A_graph.shape[0]} "
        f"nnz={A_graph.nnz} k={A_graph.k}")
    gather = phase_gather(torch, kg, [
        ("bsr elasticity N=512 m=8", A512, 8),
        ("bsr elasticity N=512 m=24", A512, 24),
        ("bsr elasticity N=96 m=128", A96, 128),
        ("ell graph n=2^20 m=8", A_graph, 8),
        ("ell graph n=2^20 m=24", A_graph, 24),
        ("ell elasticity N=512 scalar m=24", E512, 24),
        ("ell graph n=100003 m=8", A_odd, 8),
        ("bsr elasticity N=1024 scaled m=8 (matvec)", B1024, 8),
        ("ell elasticity N=1024 scalar scaled m=8 (matvec)", E1024, 8),
    ])
    del E512, A_odd, B1024, E1024
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(4)
    library = phase_library(torch, [
        ("bsr elasticity N=512 m=8", A512,
         torch.randn((8, A512.shape[0]), generator=gen, device="cuda"), kg.bsr_spmm_t_cuda),
        ("ell graph n=2^20 m=8", A_graph,
         torch.randn((8, A_graph.shape[0]), generator=gen, device="cuda"), kg.ell_spmm_t_cuda),
    ])

    # --- phases 7-9: the general-sparsity path ---
    geneo = phase_geneo(torch, kernels, A512, B512)
    del A512, B512
    torch.cuda.empty_cache()
    phase_flagship(torch, kernels, A96, B96)
    S20 = problems.unstructured_laplacian(20_000, extra_edges=1_000, seed=5, fmt="scipy")
    graph_small = (S20, rcm_pencil(S20, dtype=torch.float32, device="cuda")[0])
    graph = phase_graph(torch, kernels, A_graph, graph_small)
    del A_graph

    del graph_small
    torch.cuda.empty_cache()

    # --- phases 10-11: the new kernels against their plain versions ---
    x8, d5, copy_errs = phase_copy_check(torch, pp)
    phase_variant_check(torch, kv, kd, problems, DIAMatrix)

    # --- phase 12: the measurement path through its entry points ---
    cli_launches, roofline, variants = phase_measure(torch, kernels, pp, kv)
    copy_gbps = roofline["copy_gbps"]
    copies = copy_kernel_rows(torch, pp, x8, d5, copy_errs, roofline["best_tile"])
    del x8, d5
    torch.cuda.empty_cache()

    # --- phase 13: the library call beside the DIA kernel ---
    A2 = problems.laplacian_dirichlet_2d(2048, dtype=torch.float32, device="cuda")
    A3 = problems.laplacian_dirichlet_3d(N3, dtype=torch.float32, device="cuda")
    library.update(phase_library(torch, [
        ("2d N=2048 m=8 f32", A2,
         torch.randn((8, 2048**2), generator=gen, device="cuda"), kd.dia_spmm_t_cuda),
        ("3d N=216 m=24 f32", A3,
         torch.randn((24, N3**3), generator=gen, device="cuda"), kd.dia_spmm_t_cuda),
    ]))
    del A2, A3
    torch.cuda.empty_cache()

    # --- phase 14: the kernel table ---
    def entry(name, source, replaces, launches, rec, nbytes, flops, library_ms):
        b_ms, b_by = bound(nbytes, flops)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms, "shape": rec["case"],
                "copy_bound_ms": nbytes / copy_gbps / 1e6,
                "share_of_copy_bound": nbytes / copy_gbps / 1e6 / rec["ms"],
                "cli_launches": cli_launches[name]}

    def gather_entry(name, source, replaces, launches, rec, per_index):
        # coefficients once, one 4-byte index per ``per_index`` of them (a
        # scalar in ELL, a 2x2 block in BSR), X and Y once
        nbytes = (rec["nnz"] + rec["nnz"] // per_index + 2 * rec["n"] * rec["m"]) * 4
        return entry(name, source, replaces, launches, rec, nbytes,
                     2.0 * rec["nnz"] * rec["m"], library[rec["case"]])

    csrc = "dune_eigensolver_tpu_torch/csrc/"
    gathered = {r["case"]: r for r in gather}
    k1 = next(r for r in records if r["case"] == "3d N=216 m=24 f32")
    k1_bytes = (7 * k1["n"] + 2 * k1["n"] * k1["m"]) * 4
    k1_nnz = sum(k1["n"] - abs(o) for o in (-N3 * N3, -N3, -1, 0, 1, N3, N3 * N3))
    table = [
        entry("dia_spmm_t", csrc + "dia_spmm.cu", "dune_eigensolver_tpu/kernels/dia_spmm.py:288",
              launches, k1, k1_bytes, 2.0 * k1_nnz * k1["m"], library[k1["case"]]),
        gather_entry("ell_spmm_t", csrc + "ell_spmm.cu",
                     "dune_eigensolver_tpu/kernels/gather_spmm.py:792",
                     graph["launches"]["ell_spmm_t"], gathered["ell graph n=2^20 m=8"], 1),
        gather_entry("bsr_spmm_t", csrc + "bsr_spmm.cu",
                     "dune_eigensolver_tpu/kernels/gather_spmm.py:845",
                     geneo["launches"]["bsr_spmm_t"], gathered["bsr elasticity N=512 m=8"], 4),
    ]
    n2, m2 = 2048**2, 8
    v_bytes = (5 * n2 + 2 * n2 * m2) * 4  # bytes_spmm_dia
    v_flops = 2.0 * (5 * n2 - 2 * 2048 - 2) * m2
    for name, variant, line in (("spmm_c", "C r1-style", 51), ("spmm_b", "B s=2 d=1", 109),
                                ("spmm_d", "D rolling", 175)):
        rec = dict(variants[variant], plain_ms=variants["plain"]["ms"],
                   case=f"2d N=2048 m=8 f32 tile 2048 rows 2 ({variant})")
        table.append(entry(name, csrc + "dia_variants.cu", f"experiments/kernel_variants.py:{line}",
                           cli_launches[name], rec, v_bytes, v_flops,
                           library["2d N=2048 m=8 f32"]))
    for name, line in (("ident", 42), ("identd", 57), ("ident_alias", 113)):
        rec = copies[name]
        table.append(entry(name, csrc + "copy_probe.cu", f"experiments/pipeline_probe.py:{line}",
                           cli_launches[name], rec, rec["nbytes"], rec["flops"],
                           rec["library_ms"]))
    log(json.dumps({"kernels": table}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
