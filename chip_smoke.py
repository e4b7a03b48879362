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
              multiple of the 256-thread block), with median times of both
              and GFLOP/s as 2*nnz*m/t.
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

Each solve phase zeroes every kernel's launch counter just before its
timed run and reads the counters just after; a phase whose kernel was not
launched fails. Results flagged PLATEAU have an oracle error above 5x the
change-based stopping tolerance (the reference's own flag).

Output: progress lines, then one JSON line with the kernel table (each
kernel's launches from the timed run of its own path: DIA phase 4, BSR
phase 7, ELL phase 9), then the card's name and power limit as
nvidia-smi reports them, then the last line ``{"ok": true, "device":
{...}}``.
"""

import dataclasses
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
    events around each group, after two warm-up calls."""
    import torch

    fn()
    fn()
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
        # launches of this case: the check, two warm-ups and 7x5 timed
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


def main():
    import torch

    # --- phase 1: device ---
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import dune_eigensolver_tpu_torch  # noqa: F401  (sets TF32 off)
    from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory
    from dune_eigensolver_tpu_torch.kernels import dia_spmm as kd
    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.oracle.analytic import eigenvalues_laplace_dirichlet_3d
    from dune_eigensolver_tpu_torch.solvers import lobpcg_nested
    from dune_eigensolver_tpu_torch.sparse import DIAMatrix, ell_from_scipy, problems, rcm_pencil
    from dune_eigensolver_tpu_torch.utils import native

    kernels = {"dia_spmm_t": kd.dia_spmm_t_cuda, "ell_spmm_t": kg.ell_spmm_t_cuda,
               "bsr_spmm_t": kg.bsr_spmm_t_cuda}

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
    ])
    del E512, A_odd
    torch.cuda.empty_cache()

    # --- phases 7-9: the general-sparsity path ---
    geneo = phase_geneo(torch, kernels, A512, B512)
    del A512, B512
    torch.cuda.empty_cache()
    phase_flagship(torch, kernels, A96, B96)
    S20 = problems.unstructured_laplacian(20_000, extra_edges=1_000, seed=5, fmt="scipy")
    graph = phase_graph(torch, kernels, A_graph,
                        (S20, rcm_pencil(S20, dtype=torch.float32, device="cuda")[0]))

    # --- phase 10: the kernel table ---
    def entry(name, source, replaces, launches, rec):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "shape": rec["case"]}

    csrc = "dune_eigensolver_tpu_torch/csrc/"
    gathered = {r["case"]: r for r in gather}
    log(json.dumps({"kernels": [
        entry("dia_spmm_t", csrc + "dia_spmm.cu", "dune_eigensolver_tpu/kernels/dia_spmm.py:288",
              launches, next(r for r in records if r["case"] == "3d N=216 m=24 f32")),
        entry("ell_spmm_t", csrc + "ell_spmm.cu",
              "dune_eigensolver_tpu/kernels/gather_spmm.py:792",
              graph["launches"]["ell_spmm_t"], gathered["ell graph n=2^20 m=8"]),
        entry("bsr_spmm_t", csrc + "bsr_spmm.cu",
              "dune_eigensolver_tpu/kernels/gather_spmm.py:845",
              geneo["launches"]["bsr_spmm_t"], gathered["bsr elasticity N=512 m=8"]),
    ]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
