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
5. spread   — five more timed 216^3 solves, then one under torch.profiler:
              device time, device operations, and the device's busy share
              of the unprofiled solve, with the top of the operator table.

Output: progress lines, then one JSON line with the kernel table, then
the card's name and power limit as nvidia-smi reports them, then the last
line ``{"ok": true, "device": {...}}``.
"""

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
    ev = res.eigenvalues.cpu().numpy()
    if ev.shape != (24,) or not np.isfinite(ev).all():
        raise RuntimeError(f"N={N}: eigenvalues {ev}")
    if tuple(res.eigenvectors.shape) != (N**3, 24):
        raise RuntimeError(f"N={N}: eigenvectors {tuple(res.eigenvectors.shape)}")
    if not torch.isfinite(res.eigenvectors).all():
        raise RuntimeError(f"N={N}: eigenvectors not finite")
    if not bool(res.converged):
        raise RuntimeError(f"N={N}: not converged after {int(res.iterations)} iterations")
    err = float(np.abs(np.sort(ev)[:nev_err] - exact).max())
    if not err <= tol_err:
        raise RuntimeError(f"N={N}: max_err {err:.3e} > {tol_err:.0e}")
    return err


def profile_solve(torch, run, t_solve):
    """Phase 5: spread of the solve time, and where the device time goes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reps = []
    for _ in range(5):
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


def main():
    import torch

    # --- phase 1: device ---
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import dune_eigensolver_tpu_torch  # noqa: F401  (sets TF32 off)
    from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory
    from dune_eigensolver_tpu_torch.kernels import dia_spmm as kd
    from dune_eigensolver_tpu_torch.oracle.analytic import eigenvalues_laplace_dirichlet_3d
    from dune_eigensolver_tpu_torch.solvers import lobpcg_nested
    from dune_eigensolver_tpu_torch.sparse import DIAMatrix, problems
    from dune_eigensolver_tpu_torch.utils import native

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
    kd.dia_spmm_t_cuda.launches = 0
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

    main_rec = next(r for r in records if r["case"] == "3d N=216 m=24 f32")
    log(json.dumps({"kernels": [{
        "name": "dia_spmm_t",
        "route": "cuda",
        "source": "dune_eigensolver_tpu_torch/csrc/dia_spmm.cu",
        "replaces": "dune_eigensolver_tpu/kernels/dia_spmm.py:288",
        "launches": launches,
        "max_abs_err": main_rec["max_abs_err"],
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
    }]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
