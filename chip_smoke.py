#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; one GPU

Phases (any failure raises and exits non-zero; there is no fallback):

1. device   — requires ``torch.cuda.is_available()``; prints the card.
2. build    — compiles the two kernel libraries with nvcc into the
              package's ``_build/``, the solver's
              (``dune_eigensolver_tpu_torch/csrc/*.cu``) and the studies'
              (``csrc/experiments/*.cu``), and prints ptxas' report, and
              one ``REGISTERS`` line: the registers and spill stores of
              every instantiation of the ELL body (``csrc/ell_body.cuh``),
              K2's four (f32 and f64, int32 and int16 indices, from the
              solver's build) apart; then the host-setup helper
              (``csrc/host/dunetpu.cpp``) with g++.
3. kernel   — the CUDA DIA SpMM against its plain PyTorch version on the
              card, at the main path's shapes (2D N=2048 m=8; 3D N=216
              m=24/72 in f32 and bf16; the nested solve's coarser grids
              N=108 and N=54 at m=24 in both; ``standard_inverse``'s N=128
              m=8; 3D N=37, whose n is odd), each with its tolerance and the
              columns a thread of the kernel must own there (4, 4, 2 at
              N=54, 1 at N=37); then float64 (the f64 instantiation, one
              column a thread) at 3D N=216 m=24, 2D N=2048 m=8 and 2D N=200
              m=8, held at 1e-12 of max|A| max|X| ndiag; the kernel's median time launched in a
              loop from the host (``ms``) and its device time by CUDA-graph
              replay (``device_ms``: the shortest kernels do not keep the
              host's loop busy), the plain version's median time, and GB/s
              under the byte model ``(ndiag*n + 2*n*m) * itemsize`` over
              ``ms`` and over ``device_ms``.
4. solve    — the north-star recipe through the port's entry points:
              ``lobpcg_nested`` on the 3D 7-point Dirichlet Laplacian, first
              at N=24 against the analytic spectrum, then at N=216
              (10,077,696 dof) twice, timing the second run. The kernel's
              launch counter is zeroed just before the timed run and read
              just after; the run must converge, be finite, launch the
              kernel, take 4 columns a thread at every fine-level launch,
              and match the analytic smallest 20 to 1e-5.
5. spread   — two more timed 216^3 solves, then one under torch.profiler:
              device time, device operations, and the device's busy share
              of the unprofiled solve, with the top of the operator table
              (``PROFILE north star``; phase 7 does the same for its solve,
              ``PROFILE geneo``).
6. gather   — the CUDA ELL and BSR SpMMs against their plain PyTorch
              versions on the card, f32, at the general-sparsity path's
              shapes (elasticity_2d(512) as 2x2 BSR at m=8 and 24 and
              scalar-expanded to ELL at m=8 and 24; elasticity_2d(96) BSR at
              m=128; the RCM-ordered 2^20-node unstructured graph Laplacian
              as ELL at m=8 and 24; a 100,003-row graph, whose n is not a
              multiple of the 256-thread block; the operands of the CLI's
              ``matvec`` at ev.N=2048, elasticity_2d(1024) scaled by its
              max row sum as BSR and as ELL at m=8), with the kernel's
              times (``ms``, ``device_ms`` as in phase 3), the plain
              version's median time and GFLOP/s as 2*nnz*m/t. The ELL
              kernel stops each warp at its last stored entry
              (``ELLMatrix.warp_slots``; the graph's mean count is logged,
              4.00 against k = 7); it reads int32 columns on the graph and
              int16 offsets on the elasticity operands (the index stream
              of ``ELLMatrix.kernel_streams``), asserted. Then float64: K2
              on the graph and on elasticity_2d(512) scalar, K3 on
              elasticity_2d(512), m=8, held at 1e-12 of the row's |A|.|X|.
              Then one
              ``REREAD`` line per operand of ``phase_reread``: what the far
              re-reads of X cost the DIA and the BSR kernel.
7. geneo    — the GenEO elasticity pencil at full size: elasticity_2d(512)
              f32 (n = 522,242) through ``lobpcg_generalized`` with the
              cg25 Jacobi-CG preconditioner, twice, timing the second run;
              converged, finite, BSR kernel and the four CG step kernels
              launched, and the smallest 8
              within 1e-2 (relative) of scipy/ARPACK shift-invert, which a
              worker process computes on the host from phase 3 on.
8. flagship — ``generalized_inverse`` on elasticity_2d(96) at nev=124
              (the m=128 production GenEO block) with a CG inverse, twice,
              timing the second; within 5e-2 of the oracle; then nev=4 on
              the same pencil within 1e-2; the BSR kernel and the four CG
              step kernels launched in both.
9. graph    — the RCM-ordered 2^20-node unstructured graph Laplacian (ELL)
              through ``lobpcg_generalized`` with the cg25 preconditioner
              and an identity ELL mass, twice, timing the second; every
              Ritz pair's relative residual within 0.1; then under
              torch.profiler (``PROFILE graph``: the solve's device time
              and K2's share of it); the same recipe at n = 20,000 within
              2e-2 of the oracle.

10. copy    — the copy probe's three kernels (csrc/experiments/copy_probe.cu)
              against their plain versions (exact), at an odd width (where
              the wrappers take the first version) and at the multivector's
              shape (the bulk copies, asserted); then the SASS check
              (``SASS`` line, where the toolkit has ``cuobjdump``, on the
              studies' library): every instantiation of
              ``copy_add_row_kernel`` that streams rows 1.. of ``identd``'s
              d has at least 4 global loads more than without them.
11. variants — the DIA staging variants (csrc/experiments/dia_variants.cu,
              dia_stage_c.cu, dia_stage_d.cu: C, B at (2,1), (3,2), (4,3),
              D, D in place) against the plain DIA product at three n that
              are no multiple of the tile (2025 odd: the cp.async bodies;
              2116: bulk copies, one column a thread; 2304: bulk copies,
              four), one application and the 2-chain (1e-5 of max|R|),
              after a launch on X of 1e30; every staged body (C, D, B on
              the grid) must give the shipped kernel's bits and take the
              route and width the rules give it, and B off the grid (its
              first version) is held to the plain version; then B, C and D
              at every setting of their sweeps that fits, with random
              coefficients on every diagonal, at each n.
12. measure — the measurement path through its entry points, every launch
              counter zeroed just before and read just after:
              ``cli.main`` with ``--test matvec ev.N=2048 mv.m=8`` and
              ``--test mgs`` (n = 2^20, m = 16), then the tables the two
              experiment modules' ``main`` print: ``copy_table`` (the
              library's 1-D and 2-D copies, the hand-written copy over its
              tile sweep, copy + coefficient stream, in place) as ``COPY``
              lines and one ``ROOFLINE`` line with
              ``copy_gbps``, the best out-of-place rate; ``variant_table`` (2D N=2048 m=8 f32, each
              variant held to the plain product at 1e-5 of max|R| over one
              application and the 2-chain, the staged bodies to the shipped
              kernel's bits, then timed by CUDA-graph replay) as
              ``VARIANT`` lines with ms, GB/s under ``bytes_spmm_dia`` and
              the share of ``copy_gbps``, the shipped kernel and the plain
              version beside them; each variant's row (tile 2048, two rows;
              B's rings (3,2) and (4,3) one, as their coefficient tiles
              leave room) names its route (bulk copies, asserted at
              n = 2048^2), width (4, asserted), threads and staged bytes per
              consumed; the sweeps of B
              (``kernel_variants.ring_settings``), C and D
              (``stage_settings``) and each ring's, C's and D's best
              setting follow. Every ``RESULT`` number must be finite and every
              kernel's counter must have moved. Then the copy kernels'
              rows of the kernel table: ``ident`` and ``ident_alias`` at
              the tile the bulk body does best at in the sweep
              (``best_ident_tile``, in ``ROOFLINE``), ``identd`` at its own
              best tile, by replay too, in turns with the library call. Any reading of a kernel's
              streamed bytes (over 100 MB) above 1.05 x ``copy_gbps`` fails
              the script (``check_streamed``; phase 16's ``FORM`` rows
              too): the L2 cannot hold them.
13. library — one PyTorch call computing the same function, where there is
              one: ``torch.sparse.mm`` on a CSR tensor for the DIA and ELL
              operands and on a BSR tensor for the BSR operand, at the
              shapes of phases 3 and 6, held to the kernel's result (1e-5
              of the largest |Y| in f32, 1e-2 in bf16, as phase 3). An
              installation that refuses a layout gets its error text
              printed in the row (the only exception caught here, around
              the library's constructor and first product alone).

15. study check — every ablation variant of the ELL kernel (K2's body,
              csrc/ell_body.cuh, instantiated by csrc/experiments/
              ell_ablate.cu and ell_sweep_r{1,4,8}.cu) against its plain
              version at odd sizes (n no multiple of a block; k = 17, 33,
              51 from requested 7, 18, 33 plus the diagonal; m = 1, 8, 24):
              K2's body at every (rows, kc) of
              ``gather_ablate.SWEEP`` must give ``ell_spmm_t_cuda``'s bits,
              ``nogather``/``nodyn`` stay within 1e-5 of the row's
              |data|.|X|, ``nofma`` is exact; then what ptxas kept of
              their slot loads (``SASS`` line for ``ell_spmm_t_kernel`` in the studies'
              library,
              ``gather_ablate.slot_load_faults``: ``nogather`` as many
              global loads as K2, ``nofma`` at least 8, at both index
              widths); then the eleven gather
              probes (csrc/experiments/gather_probe.cu) and the shuffle form of the
              first, none of which may print anything but OK.
16. study   — the gather-kernel study path through its entry points, every
              launch counter of its kernels zeroed just before and read just
              after: ``gather_ablate.ablate_table`` at Nel=512 m=8 and on
              the 2^20 graph (``ABLATE`` lines: the four variants with their
              shares of K2's time and of the copy bound over phase 12's
              ``copy_gbps`` and the bytes their bodies stream, each held to
              ``check_streamed``, then the (rows, kc) sweep; K2's launches
              counted per operand), ``gather_probe.form_table`` at
              (8, 4,194,304) (``FORM`` lines), where ``lane_slice`` and
              ``block_select``, one row-copy kernel, must have taken float4
              moves and ``block_select_scratch`` and ``gather_axis0`` their
              bulk bodies (``REDESIGN`` lines: the kernel's time, the
              library call's, the shares of the table's ``x + 1.0`` rate;
              device times by CUDA-graph replay, the kernel's and the
              library call's eager times beside).
              These tables are the only timing of the new kernels; every
              one must have been launched.
17. standard — ``standard_largest`` on laplacian_dirichlet_2d(2048)
              (n = 4,194,304), nev=8, tol 2e-3, twice, timing the second
              (``LARGEST``: seconds, iterations, max_err against the closed
              form, each returned pair's residual and Rayleigh quotient
              by the plain product, DIA launches, and the same with
              ``rayleigh_ritz=True``); ``standard_inverse`` with
              ``inverse=None`` on laplacian_dirichlet_3d(128)
              (n = 2,097,152), nev=8, which must route to V-cycle-CG
              (``INVERSE``); both must stop by their change-based criterion
              and stay under the gates stated, with their reasons, at
              ``phase_standard``. Then the
              CLI in process: ``--test largest ev.N=128``, ``--test smallest
              ev.dim=3 ev.N=24 ev.inverse=mgcg`` and ``--test eigenvalues
              ev.method=lobpcg ev.nested=1 ev.dim=3 ev.N=64``, each
              returning 0 and printing its result line.

18. direct  — the direct shift-invert engines, the reference's default
              inverse, through the entry points with no ``inverse=``
              (``DIRECT`` lines; ``phase_direct`` states each gate):
              (a) bench.py's reference-parity solve, ``generalized_inverse``
              on the 2D Neumann pencil at N=256, nev=8 (banded device LU,
              C = nb = 256, 268 MB of factors) against ARPACK; (b)
              ``standard_inverse`` on laplacian_dirichlet_2d(1024), the
              largest 2D band one card holds (C = nb = 1024, 17.2 GB of
              factors), against the closed form; (c) the RCM-banded route
              on the flagship pencil elasticity_2d(96) at nev=124 and 4
              (residual through K3) beside phase 8's CG route, host syncs
              of both, and its scalar expansion to ELL at nev=4 (K2); (d)
              ``lu_inverse_factory`` on laplacian_dirichlet_2d(256), m=8,
              against the banded pair and scipy's spsolve, its setup
              seconds beside the chunk schedules' through the host helper
              (``schedule_route`` "native") and through the numpy loops on
              the same triangles, whose tables must be equal bit for bit;
              (e) the CLI's
              ``smallest`` and ``eigenvalues`` with the INI's defaults. Each
              line carries the engine taken and its blocks, iterations,
              error, seconds (setup and solve), launches by kernel, peak
              memory, and per apply: ms, device operations and device
              time beside the byte bound. No product of the phase may take
              a plain version.

19. extras  — the single-card solver extras and float64 through the entry
              points (``EXTRAS`` lines; each part states its gates): (a)
              ``refine_eigenpairs`` on phase 4's timed 216^3 block (refined
              max_err <= 1e-6, one f64 K1 launch), on the parity pencil and
              on an ELL graph solve (f64 K2); (b) adaptive GenEO on the
              parity pencil (n_below equal to ARPACK's count, one
              factorization) and the CLI's ``ev.method=adaptive``; (c) the
              checkpointed parity solve, interrupted and resumed, and the
              checkpointed GenEO LOBPCG (phase 7's pencil and oracle); (d)
              paranoid mode: silent on clean solves, an alarm per kernel on
              an injected inf, ``b_identity_check``, and nothing added once
              off (device operations and host syncs); (e) the CLI in
              float64 (f64 K1 and K3) and with ``ev.refine=on`` and
              ``ev.profile_dir`` (at N=64); (f) ``ortho_block='full'`` at
              N=24 (gated) and 108^3 (recorded; it runs to maxiter).

20. dist    — the distributed layer (``dune_eigensolver_tpu_torch/dist``)
              at world size 1 under NCCL (``DIST`` lines; ``phase_dist``
              states each gate): an impossible start raises, a CUDA
              operand on a gloo group raises; (a) the north star through
              ``sharded_lobpcg_generalized`` in the JAX package's sharded
              form (MG, bf16, ortho_block 24) beside the single-card
              solve; (b) the other DIA drivers beside phases 17/18; (c) the
              general drivers (K2) against phases 7-9's ARPACK values;
              (d) K1's and K2's local applies split P = 2, 3, 4, 8 ways in
              one process against the global kernel. NCCL refuses two ranks
              on one card, so no exchange between real ranks runs here.

21. hooks   — the JAX package's public hook keywords at full width
              (``HOOKS`` lines; ``phase_hooks`` states each gate): (a)
              ``lobpcg_generalized`` on the 216^3 north-star operand, one
              level, plain and matrix-free (K1 through ``apply_a``) from
              one start block: equal iterations, eigenvalues within 1e-6
              relative; (b) ``generalized_inverse`` with ``gram_reduce``
              alone on the flagship pencil at nev 4 (K3): the plain call's
              bits; (c) ``cg_inverse_factory(apply_a=, gram_reduce=)`` on
              the 2^20 graph (K2): the bits of the plain loop
              (``factorize/cg.py::_cg_loop``) on the same operand, and
              within ``HOOKS_CG_Y_TOL`` of the plain factory's result
              (its CG takes the fused step, ``kernels/cg_step.py``, whose
              dots are summed in another order).
22. cg step — the CG step's four kernels (``csrc/cg_step.cu``) against
              their plain versions on the card at the GenEO cell's shape,
              (8, 522,242) f32 on elasticity_2d(512)'s A + 1e-3 B with the
              Jacobi diagonal and AP from K3 (``CGSTEP`` lines): X, R and P
              bit for bit, the dots (rz, the targets, alpha, beta) within
              ``CG_STEP_DOT_TOL`` relative, the flag equal; then each
              kernel's device time by CUDA-graph replay in turns with its
              plain version's, and its time launched in a loop.

23. mg tail — the multigrid V-cycle's coarse tail as one kernel
              (``csrc/mg_tail.cu``) against the eager tail at the north
              star's entries (``bench/mg_tail.py``: m = 24 bf16 rows at 27^3
              under the 54^3, 108^3 and 216^3 V-cycles), each within
              ``MG_TAIL_TOL``; the kernel's device time by CUDA-graph replay
              and in place, with no CG step, and the eager tail's device
              time, wall time and device operations (``MGTAIL`` lines).

Phases 22 and 23 run between phases 6 and 7; phases 15-21 run before phase
14, the kernel table, which comes last.

Each solve phase zeroes every kernel's launch counter just before its
timed run and reads the counters just after; a phase whose kernel was not
launched fails. Results flagged PLATEAU have an oracle error above 5x the
change-based stopping tolerance (the reference's own flag).

Output: progress lines, then one JSON line with the kernel table (each
kernel's launches from the timed run of its own path: DIA phase 4, BSR
phase 7, ELL phase 9, the probe and variant kernels phase 12, the ablation
and gather-probe kernels phase 16, the CG step kernels phase 7, with
``flagship_launches``, phase 8's nev=124 run's, beside; the K1, K2 and K3 rows that the
direct engines drive add ``direct_launches``, those of phase 18's runs;
three f64 rows (K1 at 3D N=216 m=24, K2 on the graph, K3 on
elasticity_2d(512), m=8) carry the f64 launches of phase 19; the f32 K1
row and the graph's K2 row carry ``dist_launches``, those of phase 20's
timed runs;
``bound_ms``
is the larger of bytes / 3.35 TB/s and flops / 67 TFLOP/s (34 in f64), the card's
published rates, over the least bytes the function needs: coefficients,
one index per scalar (ELL: 2 bytes where K2 reads int16 offsets, else 4)
or per block (BSR, 4 bytes), X and Y once; row 0 of the
copy probe's ``d``, whose other rows the kernel streams by design;
``copy_bound_ms`` is the same bytes over the measured ``copy_gbps``; the
four CG step rows' ``ms`` is their device time by replay (phase 22), with
``eager_ms``, the plain version's device time by replay as ``plain_ms``
and the dots' largest relative difference (``dot_relerr``) beside; the
DIA row and the two BSR rows, at elasticity_2d(512) m=8 and at the
flagship's elasticity_2d(96) m=128, carry ``device_ms`` beside ``ms``;
so do the four ELL rows: the 2^20 graph at m=8 (the graph solve's
launches), the CLI ``matvec`` operand at m=8 (its launches),
elasticity_2d(512) scalar at m=8 (the launches of ``ablate_table`` on that
operand, scaled) and at m=24 (no path launches it: 0)); the
gather-probe rows' ``ms`` is the device time by CUDA-graph replay (their
kernels take less time than the host's launch through a wrapper),
``eager_ms`` and ``library_eager_ms`` beside it (their ``launches``
count the wrapper's calls: a graph replay re-runs the launches it
captured without a call, uncounted); the ``lane_slice``, ``block_select``,
``block_select_scratch`` and ``gather_axis0`` rows carry the body or width
taken (phase 16), and so do the ``ident`` and ``ident_alias`` rows (phase
12; with ``device_ms`` and ``library_device_ms`` by replay, in turns, at
``tile``); the ``identd`` row carries ``device_ms`` and
``library_device_ms`` (``x + d[0]``) by replay; the ``spmm_c``, ``spmm_b`` (ring (2,1)) and
``spmm_d`` rows (tile 2048, two rows) carry ``device_ms`` (their ``ms``, by
replay), their route, width, threads and staged bytes per consumed, and
their best setting of the sweep with its copy share; ``spmm_b`` the three
rings' times and rows, ``spmm_d`` its in-place form's; the ablation rows
(``ablate_full``: K2's body at K2's setting from the ablation source, with
the whole sweep in ``sweep_ms``; the three degraded variants) take ``ms``
by CUDA-graph replay, ``eager_ms`` (a chain of launches) beside, and carry
K2's time and their share of it, the graph operand's numbers beside, and
the bytes their bodies stream (``streamed_bytes``, ``streamed_gbps``); ``ablate_nofma``'s
``library_ms`` is its function as one PyTorch call, ``Xt + data_t[0]``.
A ``PHASES`` line before the table gives each phase's seconds. Then
the card's
name and power limit as nvidia-smi reports them, then the last line
``{"ok": true, "device": {...}}``.
"""

import collections
import concurrent.futures
import contextlib
import dataclasses
import importlib
import io
import json
import multiprocessing
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


def replay_ms(fn):
    """Device time of one call by CUDA-graph replay (bench/timing.py)."""
    from dune_eigensolver_tpu_torch.bench.timing import replay_ms as timed

    return timed(fn)


def phase_kernel_cases(torch):
    """Phase 3's shapes: (name, dim, N, m, dtype, the columns a thread of
    the kernel must own there)."""
    return [
        ("2d N=2048 m=8 f32", 2, 2048, 8, torch.float32, 4),
        ("3d N=216 m=24 f32", 3, 216, 24, torch.float32, 4),
        ("3d N=216 m=72 f32", 3, 216, 72, torch.float32, 4),
        ("3d N=216 m=24 bf16", 3, 216, 24, torch.bfloat16, 4),
        ("3d N=216 m=72 bf16", 3, 216, 72, torch.bfloat16, 4),
        ("3d N=108 m=24 f32", 3, 108, 24, torch.float32, 4),
        ("3d N=108 m=24 bf16", 3, 108, 24, torch.bfloat16, 4),
        ("3d N=54 m=24 f32", 3, 54, 24, torch.float32, 2),
        ("3d N=54 m=24 bf16", 3, 54, 24, torch.bfloat16, 2),
        ("3d N=128 m=8 f32", 3, 128, 8, torch.float32, 4),
        ("3d N=37 m=24 f32", 3, 37, 24, torch.float32, 1),
        ("3d N=37 m=24 bf16", 3, 37, 24, torch.bfloat16, 1),
        # f64: one column a thread (no vector body for 8-byte items); the
        # refinement's shape, the f64 CLI's 2D shapes
        ("3d N=216 m=24 f64", 3, 216, 24, torch.float64, 1),
        ("2d N=2048 m=8 f64", 2, 2048, 8, torch.float64, 1),
        ("2d N=200 m=8 f64", 2, 200, 8, torch.float64, 1),
    ]


def kernel_tol(dtype, scale, bound64):
    """A kernel's tolerance against its plain version: f32, the same sum
    FMA-contracted, 1e-5 of the output's scale; bf16, both round one f32
    sum, one bf16 ulp (2^-7 of the binade) apart; f64, the same f64 products
    summed in another order, 1e-12 of ``bound64`` (max|A| max|X| times the
    terms a row sums, or the row's |A|.|X|)."""
    import torch

    if dtype == torch.float64:
        return 1e-12 * bound64
    return (1e-5 if dtype == torch.float32 else 1e-2) * scale


def phase_kernel(torch, kd, problems):
    """Kernel against plain version; returns the per-case records."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for name, dim, N, m, dtype, width in phase_kernel_cases(torch):
        build = problems.laplacian_dirichlet_2d if dim == 2 else problems.laplacian_dirichlet_3d
        A32 = build(N, dtype=torch.float32, device="cuda")
        A = type(A32)(data=A32.data.to(dtype), offsets=A32.offsets, shape=A32.shape)
        del A32
        n = A.shape[0]
        X = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
        Y = kd.dia_spmm_t_cuda(A, X)
        R = kd.dia_spmm_t_reference(A, X)
        torch.cuda.synchronize()
        if kd.dia_spmm_t_cuda.width != width:
            raise RuntimeError(f"{name}: the kernel took {kd.dia_spmm_t_cuda.width} columns "
                               f"a thread, expected {width}")
        if not torch.isfinite(Y).all():
            raise RuntimeError(f"{name}: kernel output not finite")
        err = (Y.double() - R.double()).abs().max().item()
        scale = R.float().abs().max().item()
        tol = kernel_tol(dtype, scale, A.data.abs().max().item() * X.abs().max().item()
                         * len(A.offsets))
        if not err <= tol:
            raise RuntimeError(f"{name}: max_abs_err {err:.3e} > tol {tol:.3e}")
        del Y, R
        # ms: a loop of launches from the host, which the shortest kernels
        # do not keep busy; device_ms: device time by graph replay
        ms = median_ms(lambda: kd.dia_spmm_t_cuda(A, X))
        device_ms = replay_ms(lambda: kd.dia_spmm_t_cuda(A, X))
        plain_ms = median_ms(lambda: kd.dia_spmm_t_reference(A, X), reps=5, inner=2)
        nbytes = (len(A.offsets) * n + 2 * n * m) * X.element_size()
        rec = dict(case=name, dtype=str(dtype).split(".")[1], n=n, m=m, width=width,
                   max_abs_err=err, tol=tol, ms=ms,
                   device_ms=device_ms, plain_ms=plain_ms, gbps=nbytes / ms / 1e6,
                   device_gbps=nbytes / device_ms / 1e6, plain_gbps=nbytes / plain_ms / 1e6)
        log("KERNEL " + json.dumps(rec))
        records.append(rec)
        del A, X
        torch.cuda.empty_cache()
    return records


def phase_reread(torch, kd, kg, problems, A512):
    """What the far re-reads of X cost: the DIA kernel at n = 216^3, m = 24 on
    seven-diagonal stencils around (-1, 0, 1) whose far offsets are 4 and 8
    (every re-read of X near by), N and 2N (a grid row away), and the
    operator's own N and N^2; the BSR kernel at elasticity_2d(512), m = 8,
    with every block column set to its own block row, and as it is. Bytes,
    flops, the kernel's body (4 columns a thread, asserted) and its count of
    loads are the same within each group; each operand is held to the plain
    version first. One ``REREAD`` line each, ``ms`` by graph replay."""
    import dataclasses

    N, m = 216, 24
    gen = torch.Generator(device="cuda").manual_seed(6)
    A3 = problems.laplacian_dirichlet_3d(N, dtype=torch.float32, device="cuda")
    n = A3.shape[0]
    operands = (
        ("near", (-8, -4, -1, 0, 1, 4, 8)),
        ("rows", (-2 * N, -N, -1, 0, 1, N, 2 * N)),
        ("stencil", A3.offsets),
    )
    for dtype in (torch.float32, torch.bfloat16):
        X = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
        rows = []
        for name, offsets in operands:
            A = type(A3)(data=A3.data.to(dtype), offsets=offsets, shape=A3.shape)
            Y = kd.dia_spmm_t_cuda(A, X)
            if kd.dia_spmm_t_cuda.width != 4:
                raise RuntimeError(f"reread {name}: the kernel took "
                                   f"{kd.dia_spmm_t_cuda.width} columns a thread, expected 4")
            R = kd.dia_spmm_t_reference(A, X)
            err = (Y.float() - R.float()).abs().max().item()
            # as phase 3: the same sum FMA-contracted, or one bf16 ulp
            tol = (1e-5 if dtype == torch.float32 else 1e-2) * R.float().abs().max().item()
            if not err <= tol:
                raise RuntimeError(f"reread {name}: max_abs_err {err:.3e} > tol {tol:.3e}")
            del Y, R
            rows.append(dict(kernel="dia_spmm_t", operand=name, offsets=list(offsets),
                             dtype=str(dtype).split(".")[1], n=n, m=m, width=4,
                             ms=replay_ms(lambda: kd.dia_spmm_t_cuda(A, X))))
            del A
        for row in rows:
            log("REREAD " + json.dumps(dict(row, of_stencil=row["ms"] / rows[-1]["ms"])))
        del X
        torch.cuda.empty_cache()
    del A3
    own = torch.arange(A512.nbr, dtype=torch.int32, device="cuda")[:, None]
    A_own = dataclasses.replace(A512, bcols=own.expand(-1, A512.bcols.shape[1]).contiguous())
    X = torch.randn((8, A512.shape[0]), generator=gen, device="cuda")
    rows = []
    for name, A in (("own block row", A_own), ("mesh", A512)):
        err = (kg.bsr_spmm_t_cuda(A, X) - kg.bsr_spmm_t_reference(A, X)).abs().max().item()
        absA = dataclasses.replace(A, bdata=A.bdata.abs())
        tol = 1e-5 * kg.bsr_spmm_t_reference(absA, X.abs()).max().item()  # as phase 6
        if not err <= tol:
            raise RuntimeError(f"reread bsr {name}: max_abs_err {err:.3e} > tol {tol:.3e}")
        rows.append(dict(kernel="bsr_spmm_t", operand=name, n=A.shape[0], m=8,
                         ms=replay_ms(lambda: kg.bsr_spmm_t_cuda(A, X))))
    for row in rows:
        log("REREAD " + json.dumps(dict(row, of_mesh=row["ms"] / rows[-1]["ms"])))


def north_star(torch, N, problems, DIAMatrix, lobpcg_nested, mg_inverse_factory,
               ortho_block=24):
    """The bench's north-star call (bench.py) through the port."""
    A3 = problems.laplacian_dirichlet_3d(N, dtype=torch.float32, device="cuda")
    n = A3.shape[0]
    B3 = DIAMatrix(data=torch.ones((1, n), device="cuda"), offsets=(0,), shape=A3.shape)
    prec = mg_inverse_factory(nu1=1, nu2=1, dtype=torch.bfloat16)
    return lambda: lobpcg_nested(  # noqa: E731
        A3, B3, nev=24, tol=2e-3, maxiter=300, shift=0.0,
        min_coarse=48, coarse_tol=2e-4, precond=prec,
        ortho_iterations=1, ortho_block=ortho_block, b_identity=True,
    )


def check_result(torch, res, N, nev_err, tol_err, exact):
    ev = check_solve(torch, f"N={N}", res, N**3, 24)
    err = float(np.abs(np.sort(ev)[:nev_err] - exact).max())
    if not err <= tol_err:
        raise RuntimeError(f"N={N}: max_err {err:.3e} > {tol_err:.0e}")
    return err


def profile_solve(torch, name, run, t_solve, rows=25):
    """One solve under torch.profiler: where the device time goes. Returns
    (device seconds, the device operations' averaged events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    log(f"PROFILE {name}: device time {busy_s:.3f} s in {sum(e.count for e in kernels)} "
        f"device operations; busy share {100 * busy_s / t_solve:.1f}% of the "
        f"{t_solve:.3f} s solve (profiled wall {wall:.3f} s)")
    table = events.table(sort_by="self_device_time_total", row_limit=rows,
                         max_name_column_width=60)
    log(table)
    return busy_s, kernels


def ell_registers(build_log):
    """ptxas' registers and spill stores of every instantiation of the ELL
    body (csrc/ell_body.cuh), keyed "v=<variant> rows=<R> kc=<KC>
    cap=<blocks> <f32|f64> <int16|int32>" from the mangled names."""
    import re

    pat = re.compile(r"ell_spmm_t_kernelILi(\d)ELi(\d+)ELi(\d+)ELi(\d+)E([fd])([si])E")
    out, key = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = pat.search(m.group(1))
            key = None if k is None else (
                f"v={k[1]} rows={k[2]} kc={k[3]} cap={k[4]} {dict(f='f32', d='f64')[k[5]]} "
                f"{dict(s='int16', i='int32')[k[6]]}")
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if key and m:
            out.setdefault(key, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if key and m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def kernel_device_s(events, name):
    """Seconds of device time of the kernels whose name holds ``name``."""
    return sum(e.self_device_time_total for e in events if name in e.key) / 1e6


#: phase 19's running totals of f64 launches by kernel (None outside it):
#: ``set_counts`` folds the tallies into them before it clears them
F64_TOTAL = None


def set_counts(kernels, value=0):
    if F64_TOTAL is not None:
        for name, count in f64_counts(kernels).items():
            F64_TOTAL[name] += count
    for fn in kernels.values():
        fn.launches = value
        if hasattr(fn, "calls"):
            fn.calls.clear()


def f64_counts(kernels):
    """The f64 launches of each SpMM kernel since ``set_counts`` (from its
    by-shape tally ``calls``)."""
    import torch

    return {name: sum(c for call, c in fn.calls.items() if call.dtype == torch.float64)
            for name, fn in kernels.items() if hasattr(fn, "calls")}


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


def to_f64(A):
    """The operand with its coefficients in float64 (indices shared)."""
    import torch

    field = "bdata" if hasattr(A, "bdata") else "data"
    return dataclasses.replace(A, **{field: getattr(A, field).to(torch.float64)})


def phase_gather(torch, kg, cases):
    """Phase 6: the ELL and BSR kernels against their plain versions (f32,
    and f64 where the operand is f64)."""
    from dune_eigensolver_tpu_torch.sparse import BSRMatrix

    gen = torch.Generator(device="cuda").manual_seed(1)
    records = []
    for name, A, m in cases:
        if isinstance(A, BSRMatrix):
            kernel, plain, field = kg.bsr_spmm_t_cuda, kg.bsr_spmm_t_reference, "bdata"
        else:
            kernel, plain, field = kg.ell_spmm_t_cuda, kg.ell_spmm_t_reference, "data"
        n = A.shape[0]
        X = torch.randn((m, n), generator=gen, device="cuda", dtype=A.dtype)
        before = kernel.launches
        Y = kernel(A, X)
        R = plain(A, X)
        torch.cuda.synchronize()
        if kernel.launches != before + 1 or not torch.isfinite(Y).all():
            raise RuntimeError(f"{name}: kernel did not launch or gave non-finite values")
        err = (Y - R).abs().max().item()
        # both sum the same products of a row in other orders: at most a few
        # k*u of the row's |A|.|X|, held at 1e-5 of its largest in f32 and
        # 1e-12 in f64
        absA = dataclasses.replace(A, **{field: getattr(A, field).abs()})
        rowsum = plain(absA, X.abs()).max().item()
        tol = kernel_tol(A.dtype, rowsum, rowsum)
        if not err <= tol:
            raise RuntimeError(f"{name}: max_abs_err {err:.3e} > tol {tol:.3e}")
        more = {}
        if kernel is kg.ell_spmm_t_cuda:
            more = dict(mean_warp_slots=A.warp_slots.float().mean().item(), k=A.k,
                        index_bytes=A.kernel_streams[1].element_size())
        del Y, R, absA
        ms = median_ms(lambda: kernel(A, X))  # launched in a loop from the host
        device_ms = replay_ms(lambda: kernel(A, X))  # device time by graph replay
        plain_ms = median_ms(lambda: plain(A, X), reps=5, inner=2)
        flops = 2.0 * A.nnz * m
        itemsize = X.element_size()
        # the byte model of the kernel table: coefficients once, one index
        # per scalar (ELL, of the width read) or per block (BSR, int32), X
        # and Y once
        index = A.nnz * more.get("index_bytes", 4) if field == "data" else A.nnz // 4 * 4
        nbytes = (A.nnz + 2 * n * m) * itemsize + index
        # launches of this case: the check, the warm-up, 7x5 timed and the graph's capture
        rec = dict(case=name, kernel=kernel.__name__, dtype=str(A.dtype).split(".")[1], n=n,
                   nnz=A.nnz, m=m, **more, launches=kernel.launches - before,
                   max_abs_err=err, tol=tol, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                   gflops=flops / ms / 1e6, device_gflops=flops / device_ms / 1e6,
                   plain_gflops=flops / plain_ms / 1e6, gbps=nbytes / ms / 1e6,
                   device_gbps=nbytes / device_ms / 1e6)
        log("GATHER " + json.dumps(rec))
        records.append(rec)
        del X
        torch.cuda.empty_cache()
    return records


def geneo_oracle(Nel=512):
    """Phase 7's oracle: the smallest 8 eigenvalues of the elasticity_2d(Nel)
    pencil, f32 as the card's, by scipy/ARPACK shift-invert at -1e-3, and
    the seconds it took. Run in a worker process from phase 3 on, so that
    the host's tens of seconds of sparse LU overlap the card's phases."""
    import torch

    from dune_eigensolver_tpu_torch.oracle import smallest_generalized
    from dune_eigensolver_tpu_torch.sparse import problems

    t0 = time.perf_counter()
    A, B = problems.elasticity_2d(Nel, dtype=torch.float32, device="cpu")
    ref, _ = smallest_generalized(A, B, nev=8, sigma=-1e-3)
    return ref, time.perf_counter() - t0


#: the CG step's kernels (``kernels/cg_step.py``: ``<name>_cuda``)
CG_STEP_KERNELS = ("cg_setup", "cg_pap", "cg_update", "cg_direction")
#: phase 22: a dot's largest difference from the plain version's over its
#: largest value (``tests/test_torch_cg_fused.py``'s f32 ``DOT_TOL``): the
#: kernels sum in another order
CG_STEP_DOT_TOL = 1e-5


def phase_cg_step(torch, A, B):
    """Phase 22: the CG step's kernels against their plain versions at the
    GenEO cell's shape: (8, n) f32 right-hand sides (seeded) on
    ``elasticity_2d(512)``'s A + 1e-3 B, the Jacobi diagonal, rtol 1e-2 (the
    cell's cg25), AP by K3. Setup, pap, update and direction in turn, each
    pair fed the same tensors and, from pap on, the same step lengths: X, R
    and P must equal bit for bit, the dots (rz, the targets, alpha, beta,
    the new rz) lie within ``CG_STEP_DOT_TOL`` of the plain version's, and
    the flags equal. Then each kernel's device time by CUDA-graph replay in
    turns with its plain version's, and its time launched in a loop. Returns
    {name: record} for the kernel table."""
    from dune_eigensolver_tpu_torch.bench.timing import in_turns
    from dune_eigensolver_tpu_torch.kernels import cg_step as cs
    from dune_eigensolver_tpu_torch.sparse import spmm_t

    t0 = time.perf_counter()
    Ash = A.axpy(1e-3, B)
    n, m, rtol = Ash.shape[0], 8, 1e-2
    gen = torch.Generator(device="cuda").manual_seed(22)
    Bm = torch.randn((m, n), generator=gen, device="cuda")
    d = 1.0 / Ash.diagonal()
    dots = {}

    def dot(what, st, sr, row):
        got, ref = st.vec[row], sr.vec[row]
        dots[what] = rel = float(((got - ref).abs().max() / ref.abs().max()).item())
        if not rel <= CG_STEP_DOT_TOL:
            raise RuntimeError(f"cg step {what}: relative {rel:.3e} > {CG_STEP_DOT_TOL:.0e}")

    def same(what, got, ref):
        if not torch.equal(got, ref):
            err = (got - ref).abs().max().item()
            raise RuntimeError(f"cg step {what}: the kernel's bits differ from the plain "
                               f"version's (max abs {err:.3e})")

    def flags(what, st, sr):
        if st.going() != sr.going():
            raise RuntimeError(f"cg step {what}: flag {st.going()} against {sr.going()}")

    X, R, P, st = cs.cg_setup_cuda(Bm, d, rtol)
    Xr, Rr, Pr, sr = cs.cg_setup_reference(Bm, d, rtol)
    for what, got, ref in (("setup X", X, Xr), ("setup R", R, Rr), ("setup P", P, Pr)):
        same(what, got, ref)
    dot("setup rz", st, sr, cs.RZ)
    dot("setup target", st, sr, cs.TARGET)
    flags("setup", st, sr)
    AP = spmm_t(Ash, P)
    cs.cg_pap_cuda(P, AP, st)
    cs.cg_pap_reference(Pr, AP, sr)
    dot("pap alpha", st, sr, cs.ALPHA)
    sr.vec.copy_(st.vec)  # the same step lengths on both sides from here
    cs.cg_update_cuda(X, R, P, AP, d, st)
    cs.cg_update_reference(Xr, Rr, Pr, AP, d, sr)
    same("update X", X, Xr)
    same("update R", R, Rr)
    dot("update beta", st, sr, cs.BETA)
    dot("update rz", st, sr, cs.RZ)
    flags("update", st, sr)
    sr.vec.copy_(st.vec)
    cs.cg_direction_cuda(R, P, d, st)
    cs.cg_direction_reference(Rr, Pr, d, sr)
    same("direction P", P, Pr)

    # least bytes: each (m, n) array read or written once, d once; flops:
    # setup P = B d and three dots, update two axpys, Z and two dots
    mn, ds = m * n * 4, n * 4
    cases = {
        "cg_setup": (4 * mn + ds, 7 * m * n, lambda: cs.cg_setup_cuda(Bm, d, rtol),
                     lambda: cs.cg_setup_reference(Bm, d, rtol)),
        "cg_pap": (2 * mn, 2 * m * n, lambda: cs.cg_pap_cuda(P, AP, st),
                   lambda: cs.cg_pap_reference(Pr, AP, sr)),
        "cg_update": (6 * mn + ds, 9 * m * n, lambda: cs.cg_update_cuda(X, R, P, AP, d, st),
                      lambda: cs.cg_update_reference(Xr, Rr, Pr, AP, d, sr)),
        "cg_direction": (3 * mn + ds, 3 * m * n, lambda: cs.cg_direction_cuda(R, P, d, st),
                         lambda: cs.cg_direction_reference(Rr, Pr, d, sr)),
    }
    out = {}
    for name, (nbytes, flops, kernel, plain) in cases.items():
        ms, plain_ms = in_turns([kernel, plain], replay_ms)
        out[name] = rec = dict(
            case=f"({m}, {n}) f32, elasticity_2d(512) A + 1e-3 B, Jacobi, AP by K3",
            dtype="float32", max_abs_err=0.0, ms=ms, eager_ms=median_ms(kernel),
            plain_ms=plain_ms, nbytes=nbytes, flops=flops,
            dot_relerr={k: v for k, v in dots.items() if k.startswith(name[3:])})
        log("CGSTEP " + json.dumps(dict(kernel=name, **rec)))
    log("CGSTEP " + json.dumps(dict(seconds=time.perf_counter() - t0, dot_relerr=dots)))
    del Ash, Bm, d, X, R, P, AP, Xr, Rr, Pr
    torch.cuda.empty_cache()
    return out


#: phase 23: the tail's largest difference from the eager tail's over its
#: largest value (``tests/test_torch_mg_tail.py``'s bf16 ``TAIL_TOL``: the
#: coarsest CG sums its dots in another order, and a bf16 level may round
#: its result one ulp apart)
MG_TAIL_TOL = 2.0**-6


def phase_mg_tail(torch):
    """Phase 23: ``bench/mg_tail.py``'s records at the north star's three
    entries, each held to ``MG_TAIL_TOL``. Returns them for the kernel
    table."""
    from dune_eigensolver_tpu_torch.bench import mg_tail as bm

    t0 = time.perf_counter()
    recs = bm.measure(24)
    for rec in recs:
        log("MGTAIL " + json.dumps(rec))
        if not rec["relmax"] <= MG_TAIL_TOL:
            raise RuntimeError(f"mg tail at {rec['vcycle']}: {rec['relmax']:.3e} of the eager "
                               f"tail's largest value > {MG_TAIL_TOL:.3e}")
    log(f"mg tail: {time.perf_counter() - t0:.1f} s")
    return recs


def phase_geneo(torch, kernels, A, B, oracle):
    """Phase 7: bench.py's fast-path recipe on the 522k elasticity pencil,
    against scipy/ARPACK shift-invert on the host (``oracle``: the future of
    ``geneo_oracle``; its own seconds printed, and the seconds this phase
    waited for it)."""
    from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory
    from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized

    prec = cg_inverse_factory(rtol=1e-2, maxiter=25)

    def run():
        return lobpcg_generalized(A, B, nev=8, tol=2e-3, maxiter=300, shift=1e-3,
                                  precond=prec)

    res, rec = timed_twice(torch, run, kernels)
    ev = check_solve(torch, "geneo", res, A.shape[0], 8)
    idle = [k for k in ("bsr_spmm_t", *CG_STEP_KERNELS) if rec["launches"][k] <= 0]
    if idle:
        raise RuntimeError(f"geneo: the solve launched these kernels no time: {idle}")
    del res
    t0 = time.perf_counter()
    ref, oracle_seconds = oracle.result()
    err = relerr(ev, ref)
    rec.update(n=A.shape[0], nev=8, eigenvalues=ev.tolist(), oracle_seconds=oracle_seconds,
               oracle_wait_seconds=time.perf_counter() - t0, relerr=err,
               plateau=plateau(err, 2e-3))
    log("GENEO " + json.dumps(rec))
    if not err <= 1e-2:
        raise RuntimeError(f"geneo: relerr {err:.3e} > 1e-2")
    profile_solve(torch, "geneo", run, rec["seconds"], rows=12)
    return dict(rec, oracle=ref)  # phase 19 holds its checkpointed solve to the same oracle


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
        idle = [k for k in ("bsr_spmm_t", *CG_STEP_KERNELS) if rec["launches"][k] <= 0]
        if idle:
            raise RuntimeError(f"flagship nev={nev}: the solve launched these kernels no "
                               f"time: {idle}")
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
        out.append(dict(rec, oracle=ref))  # phase 18 holds its solves to the same oracle
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
    run = recipe(Au)
    res, rec = timed_twice(torch, run, kernels)
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
    # the solve's device time and K2's part of it
    busy, events = profile_solve(torch, "graph", run, rec["seconds"], rows=10)
    rec.update(device_s=busy, k2_device_s=kernel_device_s(events, "ell_spmm_t_kernel"))
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
F64_FLOPS_PER_S = 34e12  # H100 SXM f64 outside the tensor cores, published


def bound(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    """(bound_ms, bound_by): the least time the card could take."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_streamed(what, streamed_bytes, seconds, copy_gbps):
    """Raise where a kernel's streamed bytes over its time read above 1.05 x
    ``copy_gbps``, for more than 100 MB: two L2s' worth of bytes cannot
    stay in the 50 MB L2 across a chain or a replay, so such a reading
    means the kernel did not move the bytes it is credited with (as the
    first ``identd``'s 3,388 GB/s did, its discarded loads gone)."""
    gbps = streamed_bytes / seconds / 1e9
    if streamed_bytes > 100e6 and gbps > 1.05 * copy_gbps:
        raise RuntimeError(f"{what}: {streamed_bytes / 1e6:.1f} MB streamed at {gbps:.1f} GB/s, "
                           f"above 1.05 x copy_gbps {copy_gbps:.1f}")
    return gbps


def sass_check(pp, native):
    """What ptxas kept of ``identd``'s coefficient stream: in the SASS of the
    built studies' library each instantiation of ``copy_add_row_kernel`` that loads
    rows 1.. of d (STREAM) has at least CP_UNROLL = 4 global loads more than
    the same body without them. Returns the counts (None where the toolkit
    has no cuobjdump)."""
    if native.cuobjdump() is None:
        log("SASS copy_add_row_kernel: no cuobjdump in this toolkit, not checked")
        return None
    by = {f"vec={int(v)} stream={int(st)}": n for (v, st), n in pp.coefficient_loads().items()}
    if len(by) != 4 or any(by[f"vec={v} stream=1"] < by[f"vec={v} stream=0"] + 4 for v in "01"):
        raise RuntimeError(f"SASS copy_add_row_kernel: global loads {by}: the coefficient "
                           "stream's loads are missing")
    log("SASS " + json.dumps(dict(kernel="copy_add_row_kernel", global_loads=by)))
    return by


def ablate_sass_check(ga, native):
    """What ptxas kept of the ablation's slot loads: in the SASS of the
    built studies' library, each degraded instantiation of K2's body at K2's setting
    keeps the coefficient and index loads it is credited with
    (``gather_ablate.slot_load_faults`` states the rule). Returns the counts
    (None where the toolkit has no cuobjdump)."""
    if native.cuobjdump() is None:
        log("SASS ell_spmm_t_kernel: no cuobjdump in this toolkit, not checked")
        return None
    loads = ga.slot_loads()
    by = {f"{v} index={b}": loads[(v, b)] for v, b in sorted(loads)}
    faults = ga.slot_load_faults(loads)
    if faults:
        raise RuntimeError(f"SASS ell_spmm_t_kernel: global loads {by}: {faults}")
    log("SASS " + json.dumps(dict(kernel="ell_spmm_t_kernel", global_loads=by)))
    return by


def exact_or_raise(name, Y, R):
    err = (Y - R).abs().max().item()
    if err != 0.0:
        raise RuntimeError(f"{name}: max_abs_err {err:.3e}, expected exactly 0")
    return err


def phase_copy_check(torch, pp):
    """Phase 10: the copy kernels against their plain versions, then
    ``sass_check``.
    Returns the operands of the multivector's shape and each kernel's
    max_abs_err there."""
    from dune_eigensolver_tpu_torch.utils import native

    gen = torch.Generator(device="cuda").manual_seed(2)
    # an odd width (4-byte accesses: the wrappers take the first version)
    # first, then the multivector's shape (the bulk copies)
    for rows, width, tile, body in ((3, 100_003, 1000, "first"), (8, pp.WIDTH, 32768, "bulk")):
        wrappers = (pp.ident, pp.identd, pp.ident_alias)
        x = torch.randn((rows, width), generator=gen, device="cuda")
        d = torch.randn((5, width), generator=gen, device="cuda")
        before = [fn.launches for fn in wrappers]
        # one f32 add per element in kernel and plain version alike: 0 ulp
        want = pp.ident_reference(x)
        errs = dict(
            ident=exact_or_raise("ident", pp.ident(tile, x), want),
            identd=exact_or_raise("identd", pp.identd(tile, d, x), pp.identd_reference(d, x)),
        )
        xa = x.clone()
        if pp.ident_alias(tile, xa) is not xa:
            raise RuntimeError("ident_alias did not return its argument")
        errs["ident_alias"] = exact_or_raise("ident_alias", xa, want)
        del xa
        torch.cuda.synchronize()
        after = [fn.launches for fn in wrappers]
        if after != [b + 1 for b in before]:
            raise RuntimeError(f"copy kernels: launch counters {before} -> {after}")
        if (pp.ident.body, pp.ident_alias.body) != (body, body):
            raise RuntimeError(f"copy kernels ({rows}, {width}): bodies "
                               f"{pp.ident.body}/{pp.ident_alias.body}, expected {body}")
        log(f"copy check ({rows}, {width}) tile {tile}: exact, body {body}")
        del want
    sass_check(pp, native)
    return x, d, errs


def phase_variant_check(torch, kv, kd, problems, DIAMatrix):
    """Phase 11: the staging variants against the plain DIA product where n
    is no multiple of the tile (the full-size check is the table's own):
    every staged body (C, D, D in place, B where n % 4 == 0) must also give
    the shipped kernel's bits, and B off the grid (its first version) is
    held to the plain version; then B, C and D at every setting of their
    sweeps that fits, on every route (bulk copies where n % 4 == 0, the
    cp.async bodies elsewhere) and width (4 columns a thread where the
    offsets allow), with random coefficients on every diagonal, after a
    launch on X of 1e30 (stale shared memory would show)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    # 45^2 = 2025 is odd (cp.async; B's first version), 46^2 = 2116 a
    # multiple of 4 with offsets that are not (bulk copies, width 1), 48^2 =
    # 2304 with offsets that are (bulk copies, width 4); the tile of 256
    # holds the halo
    for N in (45, 46, 48):
        A = problems.laplacian_dirichlet_2d(N, dtype=torch.float32, device="cuda")
        A = DIAMatrix(data=A.data / 8.0, offsets=A.offsets, shape=A.shape)
        X = torch.randn((8, N * N), generator=gen, device="cuda")
        n = N * N
        route = kv.stage_route(n)

        def check(name, step, A, X, bits):
            R = kd.dia_spmm_t_reference(A, X)
            R2 = kd.dia_spmm_t_reference(A, R)
            K = kd.dia_spmm_t_cuda(A, X)
            K2 = kd.dia_spmm_t_cuda(A, K)
            # the same sum as the plain version, FMA-contracted: 1e-5 of
            # max|R| (as phase 3), for one application and for the 2-chain
            tol = 1e-5 * R.abs().max().item()
            step(torch.full_like(X, 1e30), A)
            Y = step(X.clone(), A)  # on clones: the in-place form overwrites
            Y2 = step(Y.clone(), A)
            torch.cuda.synchronize()
            err = max((Y - R).abs().max().item(), (Y2 - R2).abs().max().item())
            if not err <= tol:  # a NaN fails too
                raise RuntimeError(f"{name} N={N}: max_abs_err {err:.3e} > tol {tol:.3e}")
            if bits and not (torch.equal(Y, K) and torch.equal(Y2, K2)):
                raise RuntimeError(f"{name} N={N}: not the shipped kernel's bits")
            return err

        for name, step in kv.variant_steps(tile=256)[1:]:
            counts = {w: dict(w.taken) for w in (kv.spmm_b, kv.spmm_c, kv.spmm_d)}
            staged = not name.startswith("B ") or n % 4 == 0
            err = check(name, step, A, X, bits=staged)
            wrapper = {"B": kv.spmm_b, "C": kv.spmm_c, "D": kv.spmm_d}[name[0]]
            if name[0] == "B":
                key = "bulk" if n % 4 == 0 else "first"
            else:
                key = (route, kv.stage_width(A.offsets, n, 256) if route == "bulk" else 1)
            if wrapper.taken[key] != counts[wrapper].get(key, 0) + 3:
                raise RuntimeError(f"{name} N={N}: did not take {key}")
            log(f"variant check {name} n={n} tile 256 {key}: max_abs_err {err:.3e}"
                f"{', bits of K1' if staged else ''}")
        Ar = DIAMatrix(data=torch.randn(A.data.shape, generator=gen, device="cuda"),
                       offsets=A.offsets, shape=A.shape)
        X5 = X[:5].contiguous()
        errs = {}
        for (sl, q, T, r), g in kv.ring_settings(Ar.offsets, n):
            if g.fits:
                errs[f"B s={sl} d={q} T={T} rows={r}"] = check(
                    f"B s={sl} d={q} T={T} rows={r}",
                    lambda x, A_, sl=sl, q=q, T=T, r=r: kv.spmm_b(A_, x, sl, q, tile=T, rows=r),
                    Ar, X5, bits=n % 4 == 0)
        for variant, fn in (("c", kv.spmm_c), ("d", kv.spmm_d)):
            for (T, r), g in kv.stage_settings(variant, Ar.offsets, n):
                if g.fits:
                    errs[f"{variant} T={T} rows={r}"] = check(
                        f"{variant.upper()} T={T} rows={r}",
                        lambda x, A_, fn=fn, T=T, r=r: fn(A_, x, tile=T, rows=r), Ar, X5,
                        bits=True)
        log(f"variant check sweeps n={n} route {route}, random diagonals, m=5: "
            f"{len(errs)} settings, max_abs_err {max(errs.values()):.3e}, the staged bodies "
            "K1's bits")


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
    for label, t, g, _ in copy_rows:  # each row counts its own bytes, 136 MB or more
        check_streamed(f"COPY {label}", g * t * 1e9, t, copy_gbps)
    # the kernel table's copy rows hold the kernel at its best tile in the
    # sweep; identd, which the sweep does not time, finds its own in
    # copy_kernel_rows
    best_ident_tile = int(max((g, label) for label, _, g, k in copy_rows
                              if k == "kernel" and label.startswith("ident T="))[1]
                          .split("=")[1])
    log("ROOFLINE " + json.dumps(dict(copy_gbps=copy_gbps, best_ident_tile=best_ident_tile)))
    variants, sweep, best_rows = {}, [], {}
    for row in kv.variant_table(None):
        rec = {k: v for k, v in row.items() if k not in ("label", "seconds")}
        if row["seconds"] is not None:
            rec.update(ms=row["seconds"] * 1e3, share_of_copy=row["gbps"] / copy_gbps)
        log("VARIANT " + json.dumps(dict(variant=row["label"], **rec)))
        if row.get("sweep"):
            sweep.append(dict(rec, label=row["label"]))
        elif row.get("best"):
            best_rows[row["label"].split(" best")[0]] = dict(rec, label=row["label"])
        else:
            variants[row["label"].split(" T=")[0]] = rec
    # n = 2048^2 lies on 16 bytes and the offsets on 4: every staged row took
    # the bulk copies at four columns a thread
    taken = {(r["route"], r["width"]) for r in [*variants.values(), *sweep]
             if "ms" in r and "route" in r}
    if taken != {("bulk", 4)}:
        raise RuntimeError(f"variant_table: the staged bodies took {taken}, expected bulk, 4")
    variants["sweep"] = sweep
    variants["best"] = best_rows
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
    # the CG step's kernels run on the solve paths (phases 7 and 8), the
    # multigrid tail on the north star's (phase 4), not here
    idle = [name for name, count in launches.items()
            if count <= 0 and name not in (*CG_STEP_KERNELS, "mg_tail")]
    if idle:
        raise RuntimeError(f"cli: kernels launched no time on the measurement path: {idle}")
    log("CLI " + json.dumps(dict(seconds=seconds, launches=launches, results=results)))
    return launches, dict(copy_gbps=copy_gbps, best_ident_tile=best_ident_tile), variants


def copy_kernel_rows(torch, pp, x, d, errs, tile, copy_gbps):
    """The kernel table's rows of the three copy kernels at the
    multivector's shape, each beside its plain version (one PyTorch call,
    so the library call too), by the probe's own timing helpers; ``ident``
    and ``ident_alias`` at ``tile``, and by CUDA-graph replay, the kernel
    and the library call in turns (``device_ms``, ``library_device_ms``);
    ``identd`` at its own best of ``pp.TILES``, by replay in turns with
    ``x + d[0]`` too. Every reading of the streamed
    bytes is held under 1.05 x ``copy_gbps`` (``check_streamed``)."""
    from dune_eigensolver_tpu_torch.bench.timing import bench_loop, in_turns, replay_ms

    def identd_ms(T):
        return bench_loop(lambda v: pp.identd(T, d, v), x.clone(), K=30)

    xbytes = 2 * x.numel() * 4
    d_tile = min(pp.TILES, key=identd_ms)  # the sweep has no identd rows
    recs = {}
    for name, step, plain, nbytes, streamed in (
        ("ident", lambda v: pp.ident(tile, v), pp.ident_reference, xbytes, xbytes),
        # the function needs row 0 of d; the kernel streams all five rows
        ("identd", lambda v: pp.identd(d_tile, d, v), lambda v: pp.identd_reference(d, v),
         xbytes + d.shape[1] * 4, xbytes + d.numel() * 4),
        ("ident_alias", lambda v: pp.ident_alias(tile, v), lambda v: v.add_(1.0), xbytes, xbytes),
    ):
        def timed(fn):
            return bench_loop(fn, x.clone(), K=30) * 1e3

        ms = timed(step)
        more = {} if name == "identd" else dict(body=getattr(pp, name).body)
        # the device times, by replaying a CUDA graph of ten calls, in turns
        xr = x.clone()
        more["device_ms"], more["library_device_ms"] = in_turns(
            [lambda: step(xr), lambda: plain(xr)], replay_ms)
        plain_ms = timed(plain)
        at = d_tile if name == "identd" else tile
        gbps = check_streamed(f"COPYKERNEL {name}", streamed, ms * 1e-3, copy_gbps)
        more["device_streamed_gbps"] = check_streamed(f"COPYKERNEL {name} by replay", streamed,
                                                      more["device_ms"] * 1e-3, copy_gbps)
        recs[name] = dict(case=f"({x.shape[0]}, {x.shape[1]}) f32 tile {at}", tile=at,
                          max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, library_ms=plain_ms,
                          nbytes=nbytes, flops=x.numel(),  # one add per element
                          streamed_bytes=streamed, streamed_gbps=gbps, **more)
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
        err = (Z.T.double() - Y.double()).abs().max().item()
        scale = Y.float().abs().max().item()
        crow, _, vals = arrays
        per_row = int((crow[1:] - crow[:-1]).max()) * (A.block[1] if bsr else 1)
        # the same products summed in another order: 1e-5 of the largest |Y|
        # in f32, 1e-12 of max|A| max|X| (terms a row sums) in f64; in bf16
        # both round a sum once, one bf16 ulp (as phase 3)
        if not err <= kernel_tol(Y.dtype, scale,
                                 vals.abs().max().item() * X.abs().max().item() * per_row):
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


#: kernel of csrc/experiments/gather_probe.cu -> the lines of the TPU probes it serves
#: (experiments/mosaic_gather_probe.py)
PROBE_LINES = {
    "gather_lanes_smem": "31,44,147", "gather_lanes_shfl": "31", "gather_lanes_global": "31",
    "gather_lanes_int8": "211", "block_select_scratch": "57", "lane_slice": "106",
    "block_select": "84,175", "roll_lanes": "128", "gather_axis0": "160", "int8_widen": "197",
}


def phase_study_check(torch, ga, gp):
    """Phase 15: the ablation variants and the gather probes against their
    plain versions. Nothing is caught: a mismatch raises."""
    import scipy.sparse as sp

    from dune_eigensolver_tpu_torch.sparse import ell_from_scipy

    gen = torch.Generator(device="cuda").manual_seed(5)
    for n, k in ((1001, 7), (2049, 18), (777, 33)):
        S = sp.random(n, n, density=(k - 1) / n, random_state=k, format="csr") + sp.eye(n)
        A = ell_from_scipy(sp.csr_matrix(S), dtype=torch.float32, device="cuda")
        for m in (1, 8, 24):
            X = torch.randn((m, n), generator=gen, device="cuda")
            errs = ga.check_variants(A, X)  # raises on a mismatch; full: bit for bit
            torch.cuda.synchronize()
            log(f"ablate check n={n} k={A.k} m={m} index {A.kernel_streams[1].element_size()} "
                f"bytes: the full body at {len(ga.SWEEP)} (rows, kc) settings == "
                "ell_spmm_t_cuda; max_abs_err " + json.dumps(errs))
    from dune_eigensolver_tpu_torch.utils import native

    ablate_sass_check(ga, native)
    verdicts = gp.run_probes(None)
    torch.cuda.synchronize()
    bad = {name: v for name, v in verdicts.items() if v != "OK"}
    if len(verdicts) != 12 or bad:
        raise RuntimeError(f"gather probes: {len(verdicts)} verdicts, not OK: {bad}")


def phase_study(torch, study_kernels, ga, gp, copy_gbps):
    """Phase 16: the study path through its entry points, inside one counted
    window; the ablation's copy shares over phase 12's ``copy_gbps``.
    Returns (launches, K2's launches by ablation operand, operands, ablation
    rows, form rows by name)."""
    t0 = time.perf_counter()
    operands = ga.ablate_operands(None, 512)
    log(f"ablate operands: {time.perf_counter() - t0:.1f} s host setup; " + ", ".join(
        f"{name} n={A.shape[0]} k={A.k} nnz={A.nnz}" for name, A in operands))
    torch.cuda.synchronize()
    set_counts(study_kernels)
    t0 = time.perf_counter()
    ablate_rows, k2_by_operand = [], {}
    for name, A in operands:  # one table per operand, to count K2's launches on each
        before = study_kernels["ell_spmm_t"].launches
        ablate_rows += ga.ablate_table(None, 512, 8, operands=[(name, A)], copy_gbps=copy_gbps)
        k2_by_operand[name] = study_kernels["ell_spmm_t"].launches - before
    forms = {row["name"]: row for row in gp.form_table(None)}
    torch.cuda.synchronize()
    launches = read_counts(study_kernels)
    idle = [name for name, count in launches.items() if count <= 0]
    if idle:
        raise RuntimeError(f"study: kernels launched no time on the study path: {idle}")
    variants = [r for r in ablate_rows if "variant" in r]
    sweep = [r for r in ablate_rows if "kc" in r]
    if len(variants) != 2 * len(ga.VARIANTS) or len(sweep) != 2 * len(ga.SWEEP):
        raise RuntimeError(f"study: {len(variants)} variant rows, {len(sweep)} sweep rows")
    numbers = [r["us"] for r in ablate_rows] + [r["us"] for r in forms.values()]
    if not all(np.isfinite(x) and x > 0 for x in numbers):
        raise RuntimeError(f"study: non-finite or non-positive times {numbers}")
    # what each variant's body streams (89.7 MB on elasticity, under
    # check_streamed's 100 MB, where the SASS check of phase 15 guards it;
    # 100.7 MB on the graph)
    for row in variants:
        check_streamed(f"ABLATE {row['variant']} {row['operand']}", row["streamed_bytes"],
                       row["us"] * 1e-6, copy_gbps)
    for row in forms.values():  # 402.7 MB for the gathers: above the L2 twice over
        for key in ("us", "eager_us"):
            if row[key] is not None:
                check_streamed(f"FORM {row['name']} {key}", row["streamed_bytes"],
                               row[key] * 1e-6, copy_gbps)
    # each redesigned kernel: the timed shape lies on 16 bytes everywhere,
    # so the row copy must take float4 moves and the scratch form and the
    # gather across rows their bulk copies
    expect = {"lane_slice": ("width", 4), "block_select": ("width", 4),
              "block_select_scratch": ("body", "bulk"), "gather_axis0": ("body", "bulk")}
    for name, (attr, want) in expect.items():
        row, fn = forms[name], gp.KERNELS[name]
        taken = getattr(fn, attr)
        if taken != want:
            raise RuntimeError(f"study: {name} took {taken}, expected {want}")
        log("REDESIGN " + json.dumps(dict(
            name=name, shape=row["shape"], taken=taken, us=row["us"], eager_us=row["eager_us"],
            library_us=row["library_us"], library_eager_us=row["library_eager_us"],
            plain_us=row["plain_us"], share=row["share"],
            vs_library=row["us"] / row["library_us"],
            eager_vs_library_eager=row["eager_us"] / row["library_eager_us"])))
    best = {}
    for r in sweep:
        if r["operand"] not in best or r["us"] < best[r["operand"]]["us"]:
            best[r["operand"]] = r
    log("STUDY " + json.dumps(dict(
        seconds=time.perf_counter() - t0, launches=launches, ell_spmm_t_by_operand=k2_by_operand,
        best_sweep={k: dict(rows=r["rows"], kc=r["kc"], us=r["us"], share=r["share"])
                    for k, r in best.items()},
        k2_shares={name: {v["variant"]: dict(share=v["share"], copy_share=v["copy_share"],
                                             streamed_gbps=v["streamed_gbps"])
                          for v in variants if v["operand"] == name}
                   for name, _ in operands},
    )))
    return launches, k2_by_operand, operands, ablate_rows, forms


def phase_standard(torch, kernels, problems):
    """Phase 17: ``standard_largest``, ``standard_inverse`` with the default
    inverse, and the CLI's three convergence protocols.

    Gates, and why. Both solvers stop when no eigenvalue moved by more than
    ``tol`` in one iteration (the reference's criterion), which bounds the
    change, not the error. LARGEST: the 8 largest eigenvalues of the 2D
    operator at N = 2048 lie within 3e-5 of each other just below 8, at the
    end of a spectrum whose density is constant there, so after k power
    iterations a vector's weight over the distance d = 8 - lambda falls like
    exp(-2 k d / 8): its Rayleigh quotient sits 4/k below 8 and its
    residual ||A q - theta q|| is the same 4/k. The quotient moves 4/k^2 an
    iteration, so the stop fires near k = sqrt(4 / tol), where error and
    residual are sqrt(4 * tol) = 0.089 at tol 2e-3 (the run plateaus by
    design, as PERF.md section 2 records for the flagship; ``plateau`` flags
    an error above 5 * tol). The gate is twice that, 4 * sqrt(tol), for both:
    it depends on tol alone, so a solve that runs on without closing in does
    not pass by its length. Besides, each returned pair is held to its own
    vector: orthonormal to 1e-4, and the returned value within tol / 2 of
    the vector's Rayleigh quotient under the plain DIA product, summed in
    float64. INVERSE: the smallest eigenvalues of the 3D
    operator at N = 128 are 1.8e-3..5.3e-3 and well separated, so tol is
    1e-6 absolute and the gate 1e-5 (shift-invert converges linearly at a
    rate rho, and a change-based stop leaves rho/(1-rho) changes: 10x tol
    holds up to rho = 0.9)."""
    from dune_eigensolver_tpu_torch import cli, factorize
    from dune_eigensolver_tpu_torch.kernels import dia_spmm as kd
    from dune_eigensolver_tpu_torch.oracle.analytic import (
        eigenvalues_laplace_dirichlet_2d,
        eigenvalues_laplace_dirichlet_3d,
    )
    from dune_eigensolver_tpu_torch.solvers import standard_inverse, standard_largest

    N2, nev = 2048, 8
    A2 = problems.laplacian_dirichlet_2d(N2, dtype=torch.float32, device="cuda")
    exact = eigenvalues_laplace_dirichlet_2d(N2)[::-1][:nev]

    def largest(rr):
        return lambda: standard_largest(A2, nev=nev, tol=2e-3, maxiter=4000, rayleigh_ritz=rr)

    def pair_check(r):
        # by the plain product, in float64: nothing of the kernel under test
        Qt = r.eigenvectors.T.contiguous()
        AQ = kd.dia_spmm_t_reference(A2, Qt).double()
        Qd, lam = Qt.double(), r.eigenvalues.double()
        quotient = (Qd * AQ).sum(dim=1) / (Qd * Qd).sum(dim=1)
        eye = torch.eye(nev, dtype=torch.float64, device=Qd.device)
        return dict(max_residual=(AQ - lam[:, None] * Qd).norm(dim=1).max().item(),
                    max_quotient_gap=(quotient - lam).abs().max().item(),
                    max_ortho_gap=(Qd @ Qd.T - eye).abs().max().item())

    res, rec = timed_twice(torch, largest(False), kernels)
    ev = check_solve(torch, "largest", res, N2 * N2, nev)
    err = float(np.abs(ev - exact).max())
    res_rr = largest(True)()
    ev_rr = check_solve(torch, "largest rr", res_rr, N2 * N2, nev)
    err_rr = float(np.abs(ev_rr - exact).max())
    launches = rec["launches"]["dia_spmm_t"]
    gate = 4 * np.sqrt(2e-3)
    pairs, pairs_rr = pair_check(res), pair_check(res_rr)
    rec.update(n=N2 * N2, nev=nev, tol=2e-3, max_err=err, gate=gate,
               plateau=plateau(err, 2e-3), dia_spmm_launches=launches, **pairs,
               rayleigh_ritz=dict(iterations=int(res_rr.iterations), max_err=err_rr, **pairs_rr),
               eigenvalues=ev.tolist())
    log("LARGEST " + json.dumps(rec))
    largest_ev = ev
    if launches != 2 * rec["iterations"]:
        raise RuntimeError(f"largest: {launches} DIA launches in {rec['iterations']} iterations")
    if not (err <= gate and err_rr <= gate):
        raise RuntimeError(f"largest: max_err {err:.3e} or, with rayleigh_ritz, {err_rr:.3e} "
                           f"> {gate:.3e}")
    for what, got in (("largest", pairs), ("largest rr", pairs_rr)):
        if not (got["max_residual"] <= gate and got["max_quotient_gap"] <= 1e-3
                and got["max_ortho_gap"] <= 1e-4):
            raise RuntimeError(f"{what}: returned pairs fail their own check {got} "
                               f"(residual gate {gate:.3e}, quotient 1e-3, orthonormal 1e-4)")
    del A2, res, res_rr
    torch.cuda.empty_cache()

    N3 = 128
    A3 = problems.laplacian_dirichlet_3d(N3, dtype=torch.float32, device="cuda")
    route = factorize.default_inverse_factory(A3)[1].__qualname__
    if "_mg_cg_solve_fn" not in route:
        raise RuntimeError(f"inverse: default_inverse_factory routed to {route}, not to MG-CG")
    res, rec = timed_twice(
        torch, lambda: standard_inverse(A3, nev=nev, tol=1e-6, maxiter=200), kernels)
    ev = check_solve(torch, "inverse", res, N3**3, nev)
    err = float(np.abs(ev - eigenvalues_laplace_dirichlet_3d(N3, count=nev)).max())
    rec.update(n=N3**3, nev=nev, tol=1e-6, max_err=err, gate=1e-5, route=route,
               dia_spmm_launches=rec["launches"]["dia_spmm_t"], eigenvalues=ev.tolist())
    log("INVERSE " + json.dumps(rec))
    if rec["launches"]["dia_spmm_t"] <= 0:
        raise RuntimeError("inverse: the solve launched the DIA kernel no time")
    if not err <= 1e-5:
        raise RuntimeError(f"inverse: max_err {err:.3e} > 1e-5")
    del A3, res
    torch.cuda.empty_cache()

    ini = os.path.join(ROOT, "dune-eigensolver.ini")
    protocols = (
        # sizes at which each protocol's own ARPACK oracle takes seconds on
        # the host, not tens of them (N=256 and 3D N=32 took 23 and 33 s)
        (["--test", "largest", "ev.N=128"], "N_M_TOL_ESARERROR_ESANERROR_ARANERROR_TIMERATIO:"),
        (["--test", "smallest", "ev.dim=3", "ev.N=24", "ev.inverse=mgcg"],
         "N_M_TOL_RASERROR_ARPERROR_TIMERATIO:"),
        (["--test", "eigenvalues", "ev.method=lobpcg", "ev.nested=1", "ev.dim=3", "ev.N=64",
          "ev.inverse=mg", "ev.b_identity=1", "ev.min_coarse=16"], "RESULT eigenvalues_test"),
    )
    for argv, head in protocols:
        cli_protocol(kernels, cli, [ini, *argv], head)
    return dict(largest=largest_ev)  # phase 20 holds its sharded solve to these


def cli_protocol(kernels, cli, argv, head, kernel="dia_spmm_t", f64=False, also=()):
    """``cli.main(argv)`` in process, every launch counter zeroed just
    before and read just after: it must return 0, print one finite result
    line starting with ``head`` (and one starting with each of ``also``)
    and launch ``kernel`` (its f64 instantiation with ``f64``). Returns the
    ``PROTOCOL`` record."""
    tee = Tee(sys.stdout)
    set_counts(kernels)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    out = tee.getvalue().splitlines()
    found = {h: [ln for ln in out if ln.startswith(h)] for h in (head, *also)}
    if rc != 0 or any(len(lines) != 1 for lines in found.values()):
        raise RuntimeError(f"cli.main({argv}) returned {rc} with result lines {found}")
    for (line,) in found.values():
        numbers = [float(f) for f in line.split(":")[-1].split() if f[0].isdigit()
                   and "=" not in f]
        if not all(np.isfinite(numbers)):
            raise RuntimeError(f"cli.main({argv}): non-finite result {line}")
    launches, launches_f64 = read_counts(kernels), f64_counts(kernels)
    taken = (launches_f64 if f64 else launches)[kernel]
    if taken <= 0:
        raise RuntimeError(f"cli.main({argv}) launched the {'f64 ' if f64 else ''}{kernel} "
                           "kernel no time")
    rec = dict(argv=argv[1:], seconds=seconds, dia_spmm_launches=launches["dia_spmm_t"],
               launches=launches, f64_launches=launches_f64, line=found[head][0],
               **{h.rstrip(":"): found[h][0] for h in also})
    log("PROTOCOL " + json.dumps(rec))
    return rec


class EngineLog:
    """Records the direct engine ``default_inverse_factory`` takes. Inside
    the ``with`` block the two factories it calls (attributes of the
    ``factorize`` package, which it reads at each call) are wrapped: each
    call is timed to the end of its device work and notes the peak device
    memory since the block began (entering it resets the peak); the pair
    it returns is kept."""

    NAMES = ("banded_inverse_factory", "rcm_banded_inverse_factory")

    def __init__(self, torch):
        from dune_eigensolver_tpu_torch import factorize

        self.torch, self.factorize, self.calls = torch, factorize, []

    def __enter__(self):
        self.torch.cuda.synchronize()
        self.torch.cuda.reset_peak_memory_stats()
        self.saved = {name: getattr(self.factorize, name) for name in self.NAMES}
        for name, fn in self.saved.items():
            setattr(self.factorize, name, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.factorize, name, fn)

    def _wrap(self, fn):
        torch = self.torch

        def wrapped(A, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pair = fn(A, **kw)
            torch.cuda.synchronize()
            self.calls.append(dict(pair=pair, seconds=time.perf_counter() - t0,
                                   peak_bytes=torch.cuda.max_memory_allocated()))
            return pair

        return wrapped

    def only(self, what, engine):
        """The one call recorded, which must have taken ``engine``."""
        taken = [c["pair"][1].engine for c in self.calls]
        if taken != [engine]:
            raise RuntimeError(f"{what}: the default inverse took {taken}, not [{engine!r}]")
        return self.calls[0]


class PlainProductsRefused:
    """Inside the ``with`` block ``spmm_t`` has no plain version to take:
    a product on the card launches its kernel or raises, and any product
    that reached a plain version would raise."""

    def __enter__(self):
        self.mod = importlib.import_module("dune_eigensolver_tpu_torch.sparse.spmm")
        self.saved = dict(self.mod._ROUTES)

        def refuse(A, Xt):
            raise RuntimeError(f"a {type(A).__name__} product took the plain version")

        for cls, (kernel, _) in self.saved.items():
            self.mod._ROUTES[cls] = (kernel, refuse)
        return self

    def __exit__(self, *exc):
        self.mod._ROUTES.update(self.saved)


def count_syncs(torch, run):
    """Host syncs of one run of ``run`` (its result read to the host
    included), as torch's sync debug mode reports them: one warning for
    each operation that waits for the card."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run().eigenvalues.cpu()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(1 for w in caught if "synchroniz" in str(w.message))


def apply_profile(torch, pair, Xt, nbytes, reps=5):
    """One inverse pair's apply to Xt: ms per apply on the host clock over
    ``reps`` back-to-back applies ending in a device sync; the device
    operations and device time of one apply under torch.profiler; and the
    byte bound of ``nbytes`` (what one apply must read) at 3.35 TB/s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    aux, fn = pair
    fn(aux, Xt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(aux, Xt)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(aux, Xt)
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return dict(ms_per_apply=ms, device_ops_per_apply=sum(e.count for e in ops),
                device_ms_per_apply=sum(e.self_device_time_total for e in ops) / 1e3,
                bytes_per_apply=nbytes, bound_ms_per_apply=nbytes / HBM_BYTES_PER_S * 1e3)


def banded_apply_bytes(F, A_res, m, refine=1):
    """Least bytes of one apply of a banded pair with ``refine`` steps: the
    four factor arrays once per solve, and for each residual the product's
    operand arrays (coefficients and indices as stored), X and Y once."""
    operand = sum(t.numel() * t.element_size() for t in (
        getattr(A_res, f, None) for f in ("data", "cols", "bdata", "bcols")) if t is not None)
    return (1 + refine) * F.nbytes + refine * (operand + 2 * A_res.shape[0] * m * 4)


def drop_setups():
    """Empty the solvers' setup memo (``solvers/engine.py``). Its values
    hold the operands it is keyed on (the internal operand of a solve with
    no shift is the operand itself), so its weakref eviction does not fire
    while an entry lives, and a direct engine's factors stay on the card
    after their operand is deleted; the reference's memo is built the same
    way (ROADMAP queue 3). Called between the runs of phase 18 so that each
    one's peak memory is its own."""
    importlib.import_module("dune_eigensolver_tpu_torch.solvers.engine")._SETUP_MEMO.clear()


def host_schedules(A, stats, chunk=512):
    """Phase 18 (d): the host LU's chunk schedules of both triangles
    through the host helper (the package's route) and through the numpy
    loops it replaced, on the same SuperLU triangles, one triangle at a
    time (a route's tables take ~10 GB a triangle at 2D N = 256); seconds
    of each route and of SuperLU. Raises unless the two routes' tables,
    kmax and level counts are equal bit for bit and the levels are those
    ``factorize`` recorded."""
    from dune_eigensolver_tpu_torch.factorize import host_lu
    from dune_eigensolver_tpu_torch.utils import native

    t0 = time.perf_counter()
    lu, _ = host_lu._superlu(A.to_scipy(), "MMD_AT_PLUS_A", True, True)
    splu_s = time.perf_counter() - t0
    n = A.shape[0]
    seconds = {"native": 0.0, "numpy": 0.0}
    levels = []
    for T in host_lu._strict_triangles(lu):
        data = T.data.astype(np.float32)  # as ``factorize`` packs f32 factors
        t0 = time.perf_counter()
        got = host_lu._chunk_schedule(T.indptr, T.indices, data, n, chunk)
        seconds["native"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        want = host_lu._chunk_schedule_numpy(T.indptr, T.indices, data, n, chunk)
        seconds["numpy"] += time.perf_counter() - t0
        if got[3:] != want[3:] or not all(g.dtype == w.dtype and np.array_equal(g, w)
                                          for g, w in zip(got[:3], want[:3])):
            raise RuntimeError("host lu: the helper's chunk schedule differs from the numpy "
                               f"loops' (kmax, levels {got[3:]} against {want[3:]})")
        levels.append(got[4])
        del got, want
    if tuple(levels) != tuple(stats[2:]):
        raise RuntimeError(f"host lu: levels {levels} against factorize's {stats[2:]}")
    return dict(schedule_route="native",
                host_library=os.path.relpath(native.build_host()[0], ROOT),
                schedule_seconds=seconds["native"], numpy_schedule_seconds=seconds["numpy"],
                schedules_equal=True, splu_seconds=splu_s)


def phase_direct(torch, kernels, problems, flagship, A96, B96):
    """Phase 18: the direct shift-invert engines, which are the reference's
    default inverse, through the entry points with no ``inverse=``.

    (a) bench.py's reference-parity solve, ``generalized_inverse`` on the
    2D Neumann pencil at N = 256 (nev 8, tol 2e-3, shift 1e-3): banded
    device LU, C = nb = 256, 268 MB of factors; relerr against ARPACK
    within 5e-2, and within 1e-2 for the same solve with
    ``rayleigh_ritz=True``. Without it, m = nev = 8 columns keep their own
    Rayleigh quotients, mixtures inside the cluster lambda_5..8 (0.0190,
    0.0203 twice, 0.0205) that the change-based stop at 2e-3 can leave above
    1e-2 relative, depending on the start block: a plateau of the
    reference's own algorithm, as at the flagship's nev=124 (gate 5e-2).
    (b) The largest
    2D band one card holds, ``standard_inverse`` on the Dirichlet Laplacian
    at N = 1024 (n = 2^20, C = nb = 1024, 17.2 GB of factors): the smallest 8
    within 10 x tol = 1e-5 of the closed form, as phase 17's
    ``standard_inverse``. (c) The RCM route: the flagship pencil
    ``elasticity_2d(96)`` at nev 124 and 4 against phase 8's oracle and
    gates (5e-2, 1e-2), beside phase 8's CG route, with the host syncs of
    both; then its scalar expansion (ELL, K2) at nev 4. (d) Host LU on the
    2D Dirichlet Laplacian at N = 256, m = 8, against the banded pair and
    scipy's spsolve, its setup seconds beside the schedules' through the
    host helper and through the numpy loops (``host_schedules``). (e) The CLI's ``smallest`` and ``eigenvalues`` with the
    INI's defaults. No product of the phase may take a plain version."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    from dune_eigensolver_tpu_torch import cli
    from dune_eigensolver_tpu_torch.factorize import (
        cg_inverse_factory,
        default_inverse_factory,
        lu_inverse_factory,
    )
    from dune_eigensolver_tpu_torch.oracle import smallest_generalized
    from dune_eigensolver_tpu_torch.oracle.analytic import eigenvalues_laplace_dirichlet_2d
    from dune_eigensolver_tpu_torch.solvers import generalized_inverse, standard_inverse
    from dune_eigensolver_tpu_torch.sparse import ell_from_scipy

    gen = torch.Generator(device="cuda").manual_seed(18)
    out = {}

    def engine_record(call, A_res, m):
        F = call["pair"][0][0]
        Xt = torch.randn((m, F.n), generator=gen, device="cuda")
        return dict(engine=call["pair"][1].engine, stats=list(F.stats), factor_bytes=F.nbytes,
                    setup_seconds=call["seconds"], setup_peak_bytes=call["peak_bytes"],
                    **apply_profile(torch, call["pair"], Xt, banded_apply_bytes(F, A_res, m)))

    drop_setups()
    torch.cuda.empty_cache()
    with PlainProductsRefused():
        # (a) the reference-parity solve: bench.py's call, and the same with
        # rayleigh_ritz=True, whose Ritz values the change-based stop does
        # not leave mixed inside the cluster lambda_5..8
        A = problems.laplacian_neumann_2d(256, dtype=torch.float32, device="cuda")
        B = problems.laplacian_b_2d(256, 3, dtype=torch.float32, device="cuda")

        def run_a(rr=False):
            return generalized_inverse(A, B, nev=8, tol=2e-3, maxiter=200, shift=1e-3,
                                       rayleigh_ritz=rr)

        with EngineLog(torch) as engines:
            res, rec = timed_twice(torch, run_a, kernels)
            res_rr = run_a(True)
        call = engines.only("parity", "banded")
        F = call["pair"][0][0]
        if F.stats != (256, 256, 256, "lu") or F.nbytes != 4 * 256 * 256**2 * 4:
            raise RuntimeError(f"parity: factors {F.stats}, {F.nbytes} bytes")
        ev = check_solve(torch, "parity", res, 256**2, 8)
        ev_rr = check_solve(torch, "parity rr", res_rr, 256**2, 8)
        ref, _ = smallest_generalized(A, B, nev=8, sigma=-1e-3)
        err, err_rr = relerr(ev, ref), relerr(ev_rr, ref)
        rec.update(n=256**2, nev=8, relerr=err, gate=5e-2, plateau=plateau(err, 2e-3),
                   reference_iterations=15, host_syncs=count_syncs(torch, run_a),
                   rayleigh_ritz=dict(iterations=int(res_rr.iterations), relerr=err_rr,
                                      gate=1e-2),
                   eigenvalues=ev.tolist(), **engine_record(call, call["pair"][0][1], 8))
        log("DIRECT parity " + json.dumps(rec))
        if rec["launches"]["dia_spmm_t"] <= 0:
            raise RuntimeError("parity: the solve launched the DIA kernel no time")
        if not (err <= 5e-2 and err_rr <= 1e-2):
            raise RuntimeError(f"parity: relerr {err:.3e} (gate 5e-2) or, with "
                               f"rayleigh_ritz, {err_rr:.3e} (gate 1e-2)")
        out["parity"] = rec
        del A, B, run_a, res, res_rr, call, F, engines
        drop_setups()
        torch.cuda.empty_cache()

        # (b) the largest 2D band on one card
        N = 1024
        A = problems.laplacian_dirichlet_2d(N, dtype=torch.float32, device="cuda")

        def run_b():
            return standard_inverse(A, nev=8, tol=1e-6, maxiter=200)

        with EngineLog(torch) as engines:
            res, rec = timed_twice(torch, run_b, kernels)
        call = engines.only("band 1024", "banded")
        F = call["pair"][0][0]
        if F.stats != (N, N, N, "lu") or F.nbytes != 4 * N * N**2 * 4:
            raise RuntimeError(f"band 1024: factors {F.stats}, {F.nbytes} bytes")
        ev = check_solve(torch, "band 1024", res, N * N, 8)
        err = float(np.abs(ev - eigenvalues_laplace_dirichlet_2d(N)[:8]).max())
        rec.update(n=N * N, nev=8, tol=1e-6, max_err=err, gate=1e-5, eigenvalues=ev.tolist(),
                   **engine_record(call, A, 8))
        log("DIRECT band 1024 " + json.dumps(rec))
        if rec["launches"]["dia_spmm_t"] <= 0:
            raise RuntimeError("band 1024: the solve launched the DIA kernel no time")
        if not err <= 1e-5:
            raise RuntimeError(f"band 1024: max_err {err:.3e} > 1e-5")
        out["band_1024"] = rec
        del A, run_b, res, call, F, engines
        drop_setups()  # frees the 17.2 GB of factors
        torch.cuda.empty_cache()

        # (c) the RCM route on the flagship pencil, beside phase 8's CG route;
        # one factorization serves both nev (the setup is memoized on the
        # operands)
        cg = cg_inverse_factory(rtol=1e-5, maxiter=1000)
        with EngineLog(torch) as engines:
            for (nev, gate), cg_rec in zip(((124, 5e-2), (4, 1e-2)), flagship):
                def run_c(nev=nev, inverse=None):
                    return generalized_inverse(A96, B96, nev=nev, tol=2e-3, maxiter=300,
                                               shift=1e-3, inverse=inverse)

                res, rec = timed_twice(torch, run_c, kernels)
                call = engines.only(f"rcm nev={nev}", "rcm_banded")
                ev = check_solve(torch, f"rcm nev={nev}", res, A96.shape[0], nev)
                err = relerr(ev, cg_rec["oracle"])
                rec.update(n=A96.shape[0], nev=nev, relerr=err, gate=gate,
                           plateau=plateau(err, 2e-3), host_syncs=count_syncs(torch, run_c),
                           residual_container=type(call["pair"][0][1]).__name__,
                           cg_route=dict(seconds=cg_rec["seconds"],
                                         iterations=cg_rec["iterations"],
                                         relerr=cg_rec["relerr"],
                                         host_syncs=count_syncs(torch,
                                                                lambda: run_c(inverse=cg))),
                           **engine_record(call, call["pair"][0][1], -(-nev // 8) * 8))
                log(f"DIRECT rcm nev={nev} " + json.dumps(rec))
                if rec["launches"]["bsr_spmm_t"] <= 0 or rec["launches"]["dia_spmm_t"] != 0:
                    raise RuntimeError(f"rcm nev={nev}: launches {rec['launches']}")
                if not err <= gate:
                    raise RuntimeError(f"rcm nev={nev}: relerr {err:.3e} > {gate:.0e}")
                out[f"rcm_{nev}"] = rec
                del res, call
        del engines
        # the same pencil scalar-expanded to ELL: the residual runs K2
        Ae = ell_from_scipy(A96.to_scipy(), dtype=torch.float32, device="cuda")
        Be = ell_from_scipy(B96.to_scipy(), dtype=torch.float32, device="cuda")

        def run_e():
            return generalized_inverse(Ae, Be, nev=4, tol=2e-3, maxiter=300, shift=1e-3)

        with EngineLog(torch) as engines:
            res, rec = timed_twice(torch, run_e, kernels)
        call = engines.only("rcm ell", "rcm_banded")
        ev = check_solve(torch, "rcm ell", res, Ae.shape[0], 4)
        err = relerr(ev, flagship[1]["oracle"])
        rec.update(n=Ae.shape[0], nev=4, relerr=err, gate=1e-2,
                   residual_container=type(call["pair"][0][1]).__name__,
                   **engine_record(call, call["pair"][0][1], 8))
        log("DIRECT rcm ell nev=4 " + json.dumps(rec))
        if rec["launches"]["ell_spmm_t"] <= 0 or rec["launches"]["dia_spmm_t"] != 0:
            raise RuntimeError(f"rcm ell: launches {rec['launches']}")
        if not err <= 1e-2:
            raise RuntimeError(f"rcm ell: relerr {err:.3e} > 1e-2")
        out["rcm_ell_4"] = rec
        del Ae, Be, run_e, res, call, engines
        drop_setups()
        torch.cuda.empty_cache()

        # (d) host LU, against the banded pair and scipy
        A = problems.laplacian_dirichlet_2d(256, dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lu_pair = lu_inverse_factory(A)
        t_setup = time.perf_counter() - t0
        banded_pair = default_inverse_factory(A)
        Xt = torch.randn((8, A.shape[0]), generator=gen, device="cuda")
        Y_lu = lu_pair[1](lu_pair[0], Xt).double().cpu().numpy().T
        Y_b = banded_pair[1](banded_pair[0], Xt).double().cpu().numpy().T
        S = A.to_scipy().astype(np.float64).tocsc()
        X = Xt.double().cpu().numpy().T
        Y_ref = spl.spsolve(S, X)

        def backward(Y):
            return float(np.abs(S @ Y - X).max() / (abs(S) @ np.abs(Y)).max())

        def forward(Y, ref):
            return float(np.abs(Y - ref).max() / np.abs(ref).max())

        F = lu_pair[0]
        lu_bytes = sum(t.numel() * t.element_size() for T in (F.L, F.U)
                       for t in (T.rows, T.cols, T.vals))
        rec = dict(n=A.shape[0], m=8, engine=lu_pair[1].engine, setup_seconds=t_setup,
                   **host_schedules(A, F.stats),
                   nnz_L=F.stats[0], nnz_U=F.stats[1], levels_L=F.stats[2], levels_U=F.stats[3],
                   chunks_L=F.L.nchunk, chunks_U=F.U.nchunk,
                   backward_err=backward(Y_lu), banded_backward_err=backward(Y_b),
                   forward_err=forward(Y_lu, Y_ref), banded_forward_err=forward(Y_b, Y_ref),
                   lu_vs_banded=forward(Y_lu, Y_b),
                   **apply_profile(torch, lu_pair, Xt, lu_bytes))
        rec["banded_ms_per_apply"] = apply_profile(
            torch, banded_pair, Xt, banded_apply_bytes(banded_pair[0][0], A, 8))["ms_per_apply"]
        log("DIRECT host lu " + json.dumps(rec))
        # f32 solves of an operator of condition 2.7e4: a few ulps backward,
        # up to ~cond x that forward
        if not (rec["backward_err"] <= 1e-5 and rec["banded_backward_err"] <= 1e-5
                and rec["forward_err"] <= 1e-2 and rec["banded_forward_err"] <= 1e-2
                and rec["lu_vs_banded"] <= 1e-2):
            raise RuntimeError(f"host lu: errors {rec}")
        out["host_lu"] = rec
        del A, lu_pair, banded_pair, F
        torch.cuda.empty_cache()

        # (e) the CLI with the INI's defaults
        ini = os.path.join(ROOT, "dune-eigensolver.ini")
        out["cli"] = {
            argv[-1]: cli_protocol(kernels, cli, [ini, *argv], head) for argv, head in (
                (["--test", "smallest"], "N_M_TOL_RASERROR_ARPERROR_TIMERATIO:"),
                (["--test", "eigenvalues"], "RESULT eigenvalues_test"),
            )}
    return out


def op_counts(torch, run):
    """One call of ``run`` under torch.profiler: (device operations by name,
    aten operations by name). The aten records come from the dispatcher and
    are exact; the device records come from CUPTI, which drops a few of a
    solve's records from run to run (``EXTRAS paranoid`` lists the device
    operations that differ beside equal aten counts, the kernels' own
    launches among them), so only the aten counts are compared exactly."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = collections.Counter({e.key: e.count for e in events
                                  if e.device_type == DeviceType.CUDA})
    aten = collections.Counter({e.key: e.count for e in events
                                if e.device_type == DeviceType.CPU and e.key.startswith("aten::")})
    return device, aten


def extras_refine(torch, kernels, problems, north, parity):
    """Phase 19 (a): ``refine_eigenpairs`` on the timed 216^3 result of phase
    4 (the closed form: refined max_err of the smallest 20 within 1e-6, the
    reference's REFINED target; exactly one f64 K1 launch), on the parity
    pencil's block of 8 (ARPACK, f64: the refined error no worse than the
    unrefined one), and on an ELL graph solve (K2 f64: LOBPCG's values are
    Ritz values already, so refinement changes only their f32 rounding,
    held within 1e-6 of the unrefined error)."""
    import scipy.sparse as sp

    from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory
    from dune_eigensolver_tpu_torch.oracle import smallest_standard
    from dune_eigensolver_tpu_torch.oracle.analytic import eigenvalues_laplace_dirichlet_3d
    from dune_eigensolver_tpu_torch.solvers import (
        generalized_inverse,
        lobpcg_generalized,
        refine_eigenpairs,
    )
    from dune_eigensolver_tpu_torch.sparse import ell_from_scipy, rcm_pencil

    out = {}
    N = north["N"]
    A3 = problems.laplacian_dirichlet_3d(N, dtype=torch.float32, device="cuda")
    V = north["V"].to("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_counts(kernels)
    t0 = time.perf_counter()
    w, _ = refine_eigenpairs(A3, None, V)
    seconds = time.perf_counter() - t0
    rec = dict(n=N**3, m=V.shape[1], seconds=seconds, peak_bytes=torch.cuda.max_memory_allocated(),
               launches=read_counts(kernels), f64_launches=f64_counts(kernels),
               max_err=float(np.abs(np.sort(w)[:20]
                                    - eigenvalues_laplace_dirichlet_3d(N, count=20)).max()),
               unrefined_max_err=north["max_err"], gate=1e-6)
    log("EXTRAS refine 216 " + json.dumps(rec))
    if rec["f64_launches"]["dia_spmm_t"] != 1:
        raise RuntimeError(f"refine 216: {rec['f64_launches']} f64 launches, expected one K1")
    if not rec["max_err"] <= 1e-6:
        raise RuntimeError(f"refine 216: refined max_err {rec['max_err']:.3e} > 1e-6")
    out["refine_216"] = rec
    del A3, V, north["V"]
    torch.cuda.empty_cache()

    A, B, ref = parity["A"], parity["B"], parity["oracle"][:8]
    set_counts(kernels)
    res = generalized_inverse(A, B, nev=8, tol=2e-3, maxiter=200, shift=1e-3)
    ev = check_solve(torch, "refine parity", res, A.shape[0], 8)
    t0 = time.perf_counter()
    w, _ = refine_eigenpairs(A, B, res.eigenvectors)
    rec = dict(n=A.shape[0], m=8, seconds=time.perf_counter() - t0, iterations=int(res.iterations),
               relerr=relerr(ev, ref), refined_relerr=relerr(w, ref),
               plateau=plateau(relerr(ev, ref), 2e-3), f64_launches=f64_counts(kernels))
    log("EXTRAS refine parity " + json.dumps(rec))
    if not rec["refined_relerr"] <= rec["relerr"]:
        raise RuntimeError(f"refine parity: refined {rec['refined_relerr']:.3e} worse than "
                           f"unrefined {rec['relerr']:.3e}")
    out["refine_parity"] = rec

    S = problems.unstructured_laplacian(20_000, extra_edges=1_000, seed=5, fmt="scipy")
    Ag = rcm_pencil(S, dtype=torch.float32, device="cuda")[0]
    Bg = ell_from_scipy(sp.eye(Ag.shape[0]), dtype=torch.float32, device="cuda")
    set_counts(kernels)
    res = lobpcg_generalized(Ag, Bg, nev=4, tol=2e-3, maxiter=300, shift=1e-3,
                             precond=cg_inverse_factory(rtol=1e-2, maxiter=25))
    ev = check_solve(torch, "refine graph", res, Ag.shape[0], 4)
    w, _ = refine_eigenpairs(Ag, None, res.eigenvectors)
    ref_g, _ = smallest_standard(S, nev=4, sigma=-1e-3)
    rec = dict(n=Ag.shape[0], m=4, relerr=relerr(ev, ref_g), refined_relerr=relerr(w, ref_g),
               f64_launches=f64_counts(kernels))
    log("EXTRAS refine graph " + json.dumps(rec))
    if rec["f64_launches"]["ell_spmm_t"] != 1:
        raise RuntimeError(f"refine graph: {rec['f64_launches']} f64 launches, expected one K2")
    if not rec["refined_relerr"] <= rec["relerr"] + 1e-6:
        raise RuntimeError(f"refine graph: refined {rec['refined_relerr']:.3e} against "
                           f"unrefined {rec['relerr']:.3e}")
    out["refine_graph"] = rec
    return out


def extras_adaptive(torch, kernels, cli, parity):
    """Phase 19 (b): ``generalized_inverse_adaptive`` on the parity pencil
    (Rayleigh-Ritz, nev 8, growth 1.3), the threshold at the midpoint of the
    widest gap among lambda_17..24 (ARPACK): n_below must equal the
    oracle's count, lambda_max reach the threshold, and the factorization be
    built once; then the CLI's ``ev.method=adaptive`` at the same threshold
    (its n_below is recorded; the CLI's quotients are per column, as in the
    reference)."""
    import re

    from dune_eigensolver_tpu_torch.solvers import generalized_inverse_adaptive

    A, B, lam = parity["A"], parity["B"], np.sort(parity["oracle"])
    k = int(np.argmax(np.diff(lam[16:24])))
    threshold = float(0.5 * (lam[16 + k] + lam[17 + k]))
    expected = int((lam < threshold).sum())

    def run():
        return generalized_inverse_adaptive(A, B, threshold, nev=8, tol=2e-3, maxiter=400,
                                            shift=1e-3, growth=1.3, rayleigh_ritz=True,
                                            verbose=1)

    tee = Tee(sys.stdout)
    torch.cuda.synchronize()
    set_counts(kernels)
    with EngineLog(torch) as engines, contextlib.redirect_stdout(tee):
        t0 = time.perf_counter()
        res, n_below = run()
        res.eigenvalues.cpu()
        seconds = time.perf_counter() - t0
    launches = read_counts(kernels)
    rounds = [int(x) for x in re.findall(r"adaptive: nev=(\d+)", tee.getvalue())]
    lam_max = float(res.eigenvalues.max())
    rec = dict(n=A.shape[0], threshold=threshold, oracle_below=expected, n_below=n_below,
               lambda_max=lam_max, rounds=len(rounds), nev_per_round=rounds, seconds=seconds,
               factorizations=len(engines.calls), launches=launches,
               host_syncs=count_syncs(torch, lambda: run()[0]))
    log("EXTRAS adaptive " + json.dumps(rec))
    if n_below != expected or not lam_max >= threshold or len(engines.calls) != 1:
        raise RuntimeError(f"adaptive: n_below {n_below} (oracle {expected}), lambda_max "
                           f"{lam_max:.4e} (threshold {threshold:.4e}), "
                           f"{len(engines.calls)} factorizations")
    ini = os.path.join(ROOT, "dune-eigensolver.ini")
    cli_rec = cli_protocol(kernels, cli, [ini, "--test", "eigenvalues", "ev.method=adaptive",
                                          f"ev.threshold={threshold!r}", "ev.N=256"],
                           "RESULT eigenvalues_test")
    rec["cli_n_below"] = int(cli_rec["line"].split("n_below=")[1])
    return rec


def extras_checkpoint(torch, kernels, problems, parity, geneo):
    """Phase 19 (c): the parity solve checkpointed every 10 iterations,
    interrupted by maxiter=10 (a file numpy reads: Q (n, 8), iterations 10,
    the eigenvalues) and resumed to convergence within phase 18's parity
    gate (5e-2, PLATEAU); GenEO LOBPCG on phase 7's pencil in segments of 10
    within phase 7's 1e-2 of its ARPACK eigenvalues, its file holding the
    full padded block (iterations and segments are recorded: each resume
    rebuilds LOBPCG's search direction)."""
    import tempfile

    from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory
    from dune_eigensolver_tpu_torch.solvers import (
        generalized_inverse_checkpointed,
        lobpcg_generalized_checkpointed,
    )

    A, B, ref = parity["A"], parity["B"], parity["oracle"][:8]
    out = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "parity.npz")
        kw = dict(nev=8, tol=2e-3, checkpoint_path=path, checkpoint_every=10, shift=1e-3)
        set_counts(kernels)
        t0 = time.perf_counter()
        generalized_inverse_checkpointed(A, B, maxiter=10, **kw)
        with np.load(path) as z:
            stored = dict(Q=list(z["Q"].shape), iterations=int(z["iterations"]),
                          eigenvalues=list(z["eigenvalues"].shape))
        res = generalized_inverse_checkpointed(A, B, maxiter=200, **kw)
        seconds = time.perf_counter() - t0
        ev = check_solve(torch, "checkpoint parity", res, A.shape[0], 8)
        err = relerr(ev, ref)
        rec = dict(n=A.shape[0], file=stored, iterations=int(res.iterations), seconds=seconds,
                   relerr=err, gate=5e-2, plateau=plateau(err, 2e-3),
                   launches=read_counts(kernels))
        log("EXTRAS checkpoint parity " + json.dumps(rec))
        if stored != dict(Q=[A.shape[0], 8], iterations=10, eigenvalues=[8]):
            raise RuntimeError(f"checkpoint parity: the file holds {stored}")
        if not err <= 5e-2:
            raise RuntimeError(f"checkpoint parity: relerr {err:.3e} > 5e-2")
        out["parity"] = rec

        A5, B5 = geneo["A"], geneo["B"]
        path = os.path.join(d, "geneo.npz")
        set_counts(kernels)
        t0 = time.perf_counter()
        res = lobpcg_generalized_checkpointed(
            A5, B5, nev=8, tol=2e-3, maxiter=300, checkpoint_path=path, checkpoint_every=10,
            shift=1e-3, precond=cg_inverse_factory(rtol=1e-2, maxiter=25))
        seconds = time.perf_counter() - t0
        ev = check_solve(torch, "checkpoint geneo", res, A5.shape[0], 8)
        with np.load(path) as z:
            q_shape, stored_it = list(z["Q"].shape), int(z["iterations"])
        err = relerr(ev, geneo["oracle"])
        it = int(res.iterations)
        rec = dict(n=A5.shape[0], iterations=it, segments=-(-it // 10), file_Q=q_shape,
                   file_iterations=stored_it, phase7_iterations=geneo["iterations"],
                   seconds=seconds, relerr=err, gate=1e-2, launches=read_counts(kernels))
        log("EXTRAS checkpoint geneo " + json.dumps(rec))
        if q_shape != [A5.shape[0], 8] or stored_it != it or rec["launches"]["bsr_spmm_t"] <= 0:
            raise RuntimeError(f"checkpoint geneo: file Q {q_shape} at {stored_it}, {rec}")
        if not err <= 1e-2:
            raise RuntimeError(f"checkpoint geneo: relerr {err:.3e} > 1e-2")
        out["geneo"] = rec
    return out


def extras_paranoid(torch, kernels, problems, small, parity, geneo):
    """Phase 19 (d): paranoid mode. The N=24 north-star solve and the GenEO
    solve report nothing; one K1, K2 and K3 dispatch each on an X with an
    ``inf`` inside the sampled centre alarms for its own kernel;
    ``b_identity_check`` is silent on ``identity_on_pattern`` and alarms
    on the mass B. Turned off again, the N=24 solve makes the same aten
    operations, name by name, and as many host syncs as before paranoid mode
    was first turned on; the same solve with paranoid mode on shows that the
    count sees the check (it adds operations at every kernel dispatch). Its
    device operations are recorded beside them, not compared: CUPTI drops a
    few records from run to run (``op_counts``). Both sides are taken after
    a warm run, since the solves in between may push the N=24 setup out of
    the solvers' memo (``solvers/engine.py`` keeps 32 entries) and its
    rebuild is setup, not the cost of a dispatch."""
    from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory
    from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized
    from dune_eigensolver_tpu_torch.sparse import spmm_t
    from dune_eigensolver_tpu_torch.utils import paranoid

    small().eigenvalues.cpu()  # warm: the setup memo holds the MG hierarchy
    before = [op_counts(torch, small) for _ in range(2)]
    syncs_before = [count_syncs(torch, small) for _ in range(2)]
    prec = cg_inverse_factory(rtol=1e-2, maxiter=25)
    operands = {"dia_spmm_t_cuda": parity["A"], "ell_spmm_t_cuda": geneo["E"],
                "bsr_spmm_t_cuda": geneo["A"]}
    tee = Tee(sys.stdout)
    paranoid.set_paranoid(True)
    try:
        with contextlib.redirect_stdout(tee):
            on = op_counts(torch, small)
            lobpcg_generalized(geneo["A"], geneo["B"], nev=8, tol=2e-3, maxiter=300, shift=1e-3,
                               precond=prec).eigenvalues.cpu()
        clean = [ln for ln in tee.getvalue().splitlines() if ln.startswith("PARANOID")]
        alarms = {}
        for tag, M in operands.items():
            n = M.shape[1]
            X = torch.ones((8, n), device="cuda")
            X[3, n // 2] = float("inf")
            with contextlib.redirect_stdout(io.StringIO()):
                spmm_t(M, X)
                alarms[tag] = paranoid.report()
        A_id = problems.identity_on_pattern(parity["A"])
        with contextlib.redirect_stdout(io.StringIO()):
            paranoid.b_identity_check(A_id)
            b_identity = paranoid.report()
            paranoid.b_identity_check(parity["B"])
            b_mass = paranoid.report()
    finally:
        paranoid.set_paranoid(False)
    small().eigenvalues.cpu()  # warm again: rebuild a setup the solves above evicted
    after = [op_counts(torch, small) for _ in range(2)]
    syncs_after = [count_syncs(torch, small) for _ in range(2)]
    aten_off = [a for _, a in before + after]
    aten_differ = {k: [c[k] for c in aten_off] for k in set().union(*aten_off)
                   if len({c[k] for c in aten_off}) > 1}
    aten_added_on = {k: on[1][k] - before[-1][1][k] for k in on[1]
                     if on[1][k] != before[-1][1][k]}
    device_off = [d for d, _ in before + after]
    rec = dict(clean_alarms=clean, alarms=alarms, b_identity_alarms=b_identity,
               b_mass_alarms=b_mass,
               aten_ops_before=[sum(a.values()) for _, a in before],
               aten_ops_after=[sum(a.values()) for _, a in after],
               aten_ops_on=sum(on[1].values()), aten_added_on=aten_added_on,
               aten_ops_that_differ=aten_differ,
               device_ops_before=[sum(d.values()) for d, _ in before],
               device_ops_after=[sum(d.values()) for d, _ in after],
               device_ops_on=sum(on[0].values()),
               device_ops_that_differ={k: [c[k] for c in device_off]
                                       for k in set().union(*device_off)
                                       if len({c[k] for c in device_off}) > 1},
               host_syncs_before=syncs_before, host_syncs_after=syncs_after)
    log("EXTRAS paranoid " + json.dumps(rec))
    if clean:
        raise RuntimeError(f"paranoid: clean solves alarmed {clean}")
    for tag, lines in alarms.items():
        if len(lines) != 1 or f"kernel '{tag}'" not in lines[0]:
            raise RuntimeError(f"paranoid: an inf through {tag} alarmed {lines}")
    if b_identity or len(b_mass) != 1 or "b_identity=True" not in b_mass[0]:
        raise RuntimeError(f"paranoid: b_identity_check {b_identity} / {b_mass}")
    if sum(on[1].values()) <= sum(before[-1][1].values()):
        raise RuntimeError(f"paranoid on: the aten count did not see the check "
                           f"({sum(on[1].values())} against {rec['aten_ops_before']})")
    if aten_differ or syncs_after != [syncs_before[-1]] * 2:
        raise RuntimeError(f"paranoid off: aten operations that differ {aten_differ}, "
                           f"host syncs {syncs_after} against {syncs_before}")
    return rec


def extras_cli(torch, kernels, cli):
    """Phase 19 (e): the CLI in float64 and with the new options. Each run
    prints its protocol line (REFINED where asked) and launches the kernel
    named: ``largest ev.dtype=float64`` at the INI's N = 200 the f64 K1,
    ``eigenvalues`` on the elasticity pencil at N = 96 in f64 the f64 K3,
    ``largest``/``smallest ev.refine=on`` the f64 K1 of the refinement,
    ``largest ev.N=64 ev.profile_dir`` K1, whose symbol the trace file
    must name (a small N: the trace is what is checked, and phase 17 runs
    the ``largest`` protocol itself)."""
    import tempfile

    ini = os.path.join(ROOT, "dune-eigensolver.ini")
    largest = "N_M_TOL_ESARERROR_ESANERROR_ARANERROR_TIMERATIO:"
    smallest = "N_M_TOL_RASERROR_ARPERROR_TIMERATIO:"
    out = {}
    for key, argv, head, kernel, also in (
        ("largest_f64", ["--test", "largest", "ev.dtype=float64"], largest, "dia_spmm_t", ()),
        ("elasticity_f64", ["--test", "eigenvalues", "ev.problem=elasticity", "ev.N=96",
                            "ev.dtype=float64"], "RESULT eigenvalues_test", "bsr_spmm_t", ()),
        ("largest_refine", ["--test", "largest", "ev.refine=on"], largest, "dia_spmm_t",
         ("REFINED_N_M_ERROR:",)),
        ("smallest_refine", ["--test", "smallest", "ev.refine=on"], smallest, "dia_spmm_t",
         ("REFINED_N_M_ERROR:",)),
    ):
        out[key] = cli_protocol(kernels, cli, [ini, *argv], head, kernel=kernel, f64=True,
                                also=also)
    with tempfile.TemporaryDirectory() as d:
        rec = cli_protocol(kernels, cli, [ini, "--test", "largest", "ev.N=64",
                                          f"ev.profile_dir={d}"], largest)
        files = os.listdir(d)
        with open(os.path.join(d, files[0])) as fh:
            names_k1 = "dia_spmm_t" in fh.read()
        rec.update(trace_files=len(files), trace_bytes=os.path.getsize(os.path.join(d, files[0])),
                   trace_names_k1=names_k1)
    log("EXTRAS profile_dir " + json.dumps(rec))
    if len(files) != 1 or not names_k1:
        raise RuntimeError(f"profile_dir: {files}, K1 named: {names_k1}")
    out["profile_dir"] = rec
    return out


def extras_ortho_full(torch, kernels, problems, DIAMatrix, lobpcg_nested, mg_inverse_factory):
    """Phase 19 (f): ``ortho_block='full'`` in the north-star recipe: at N=24
    finite and within the N=24 gate (3e-4), whether or not its change-based
    stop fires within maxiter (the port accumulates and whitens the
    whole-basis Gram in f64 and converges in about as many iterations as
    with ortho_block=24; the reference's f32 Gram needs 163 at N=24 on the
    CPU); one 108^3 solve recorded, not gated (the
    reference keeps 'full' outside its validated envelope): finite or not,
    max_err, iterations, seconds, and the time inside the
    orthonormalization, by CUDA events around each call (a profiler would
    have to hold every operation of a solve that may run to maxiter), as a
    share of the solve's seconds."""
    from dune_eigensolver_tpu_torch.oracle.analytic import eigenvalues_laplace_dirichlet_3d

    lob = importlib.import_module("dune_eigensolver_tpu_torch.solvers.lobpcg")
    small = north_star(torch, 24, problems, DIAMatrix, lobpcg_nested, mg_inverse_factory,
                       ortho_block="full")
    res = small()
    ev24 = res.eigenvalues.cpu().numpy()
    err24 = float(np.abs(np.sort(ev24)[:20] - eigenvalues_laplace_dirichlet_3d(24, count=20)).max())
    n24 = dict(n24_max_err=err24, n24_iterations=int(res.iterations),
               n24_converged=bool(res.converged), n24_criterion=float(res.criterion))
    if not (np.isfinite(ev24).all() and err24 <= 3e-4):
        raise RuntimeError(f"ortho full N=24: {n24} (gate 3e-4)")
    N = 108
    run = north_star(torch, N, problems, DIAMatrix, lobpcg_nested, mg_inverse_factory,
                     ortho_block="full")
    orig, ranges = lob.b_orthonormalize_blocked_t, []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*args, **kwargs)
        end.record()
        ranges.append((start, end))
        return out

    lob.b_orthonormalize_blocked_t = timed
    try:
        torch.cuda.synchronize()
        set_counts(kernels)
        t0 = time.perf_counter()
        res = run()
        ev = res.eigenvalues.cpu().numpy()
        seconds = time.perf_counter() - t0
    finally:
        lob.b_orthonormalize_blocked_t = orig
    torch.cuda.synchronize()
    ortho_ms = sum(a.elapsed_time(b) for a, b in ranges)
    finite = bool(np.isfinite(ev).all() and torch.isfinite(res.eigenvectors).all())
    err = (float(np.abs(np.sort(ev)[:20] - eigenvalues_laplace_dirichlet_3d(N, count=20)).max())
           if finite else None)
    rec = dict(**n24, n=N**3, finite=finite,
               max_err=err, iterations=int(res.iterations), converged=bool(res.converged),
               seconds=seconds, orthos=len(ranges), ortho_ms=ortho_ms,
               ortho_share_of_seconds=ortho_ms / 1e3 / seconds, launches=read_counts(kernels))
    log("EXTRAS ortho full " + json.dumps(rec))
    return rec


def phase_extras(torch, kernels, cli, problems, DIAMatrix, lobpcg_nested, mg_inverse_factory,
                 north, geneo_rec):
    """Phase 19: the single-card solver extras and float64 through the entry
    points (``EXTRAS`` lines; each part states its gates). Returns the
    records and the f64 launches of K1, K2 and K3 over the phase."""
    from dune_eigensolver_tpu_torch.oracle import smallest_generalized
    from dune_eigensolver_tpu_torch.sparse import ell_from_scipy

    global F64_TOTAL
    t_phase = time.perf_counter()
    set_counts(kernels)
    F64_TOTAL = f64_total = {name: 0 for name in ("dia_spmm_t", "ell_spmm_t", "bsr_spmm_t")}
    drop_setups()
    torch.cuda.empty_cache()
    # the parity pencil of phase 18 (a) and its 24 smallest eigenvalues
    A = problems.laplacian_neumann_2d(256, dtype=torch.float32, device="cuda")
    B = problems.laplacian_b_2d(256, 3, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    oracle, _ = smallest_generalized(A, B, nev=24, sigma=-1e-3)
    parity = dict(A=A, B=B, oracle=np.sort(oracle))
    log(f"extras: parity oracle nev=24 {time.perf_counter() - t0:.1f} s")
    out = dict(refine=extras_refine(torch, kernels, problems, north, parity),
               parity_oracle=parity["oracle"])  # phase 20 holds its sharded solve to it
    out["adaptive"] = extras_adaptive(torch, kernels, cli, parity)
    A5, B5 = problems.elasticity_2d(512, dtype=torch.float32, device="cuda")
    geneo = dict(geneo_rec, A=A5, B=B5,
                 E=ell_from_scipy(A5.to_scipy(), dtype=torch.float32, device="cuda"))
    out["checkpoint"] = extras_checkpoint(torch, kernels, problems, parity, geneo)
    small = north_star(torch, 24, problems, DIAMatrix, lobpcg_nested, mg_inverse_factory)
    out["paranoid"] = extras_paranoid(torch, kernels, problems, small, parity, geneo)
    del geneo, A5, B5, small
    drop_setups()
    torch.cuda.empty_cache()
    out["cli"] = extras_cli(torch, kernels, cli)
    out["ortho_full"] = extras_ortho_full(torch, kernels, problems, DIAMatrix, lobpcg_nested,
                                          mg_inverse_factory)
    set_counts(kernels)  # folds the last part's launches in
    F64_TOTAL = None
    drop_setups()
    torch.cuda.empty_cache()
    log("EXTRAS " + json.dumps(dict(seconds=time.perf_counter() - t_phase,
                                    f64_launches=f64_total)))
    for name, count in f64_total.items():
        if count <= 0:
            raise RuntimeError(f"extras: the f64 {name} kernel was launched no time")
    return out, f64_total


def dist_record(torch, kernels, run, counts):
    """One sharded solve, timed as ``timed_twice`` times it, with the
    collectives of the timed run beside the kernels' launches."""
    def counted():
        counts.clear()
        return run()

    res, rec = timed_twice(torch, counted, kernels)
    rec["collectives"] = dict(counts)
    return res, rec


def dist_match(name, ev, ref, gate, absolute=False):
    """Agreement of a sharded solve's eigenvalues with another solve's
    (``ref``): max |difference| over max |ref| (or absolute), held to
    ``gate``."""
    ref = np.asarray(ref)[: len(ev)]
    err = float(np.abs(np.sort(ev) - np.sort(ref)).max())
    if not absolute:
        err /= float(np.abs(ref).max())
    if not err <= gate:
        kind = "absolute" if absolute else "relative"
        raise RuntimeError(f"{name}: eigenvalues {err:.3e} ({kind}) from the reference solve, "
                           f"gate {gate:.0e}")
    return err


def dist_no_fallback(torch, dist):
    """A process-group start that cannot succeed (rank 1 of a world of one)
    raises and leaves no group behind; run before the real group exists.
    Its store waits 5 s for the NCCL id rank 0 would publish."""
    import datetime
    import tempfile

    from dune_eigensolver_tpu_torch.dist import init_distributed

    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    store = dist.FileStore(os.path.join(tmp, "bad"), 1)
    store.set_timeout(datetime.timedelta(seconds=5))  # rank 1 waits for rank 0's NCCL id
    t0 = time.perf_counter()
    try:
        init_distributed("cuda", store=store, rank=1, world_size=1,
                         timeout=datetime.timedelta(seconds=5))
    except Exception as e:  # the one failure this phase provokes on purpose
        failed = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    else:
        raise RuntimeError("an impossible NCCL start did not raise")
    if dist.is_initialized():
        raise RuntimeError("a failed NCCL start left a process group behind")
    return dict(failed_start=failed, failed_start_seconds=time.perf_counter() - t0), tmp


def phase_dist(torch, kernels, problems, DIAMatrix, refs):
    """Phase 20: the distributed layer (``dune_eigensolver_tpu_torch/dist``)
    on the card, world size 1 under NCCL (one card: NCCL refuses two ranks
    on one device, so no exchange between real ranks runs here; the layer's
    exchanges are held to the JAX package's on gloo CPU ranks by the tests).

    (a) The north star through ``sharded_lobpcg_generalized`` in the JAX
    package's sharded form (precond='mg', bf16 smoothing, ortho_block=24,
    nev=24, identity B as a one-diagonal DIA operand), 216^3, twice, timing
    the second: max_err <= 1e-5 against the analytic smallest 20, and the
    single-card ``lobpcg_generalized`` with the same flags (the V(1,1) bf16
    cycle, the same seed and so the same start block) within 1e-6
    relative. (b) ``sharded_standard_largest`` (2D N=2048, nev 8: phase
    17's call, held to its eigenvalues to 1e-6: the same products and the
    Grams all-reduced over one rank), ``sharded_standard_inverse`` (2D
    N=512, nev 8, inner='schwarz', the block solve alone at P = 1: the
    analytic spectrum within 1e-5, and the single-card default-inverse
    solve within the same 10 tol = 1e-5) and ``sharded_generalized_inverse``
    on the parity pencil (phase 18 (a)'s gate, 5e-2 of ARPACK, and its
    eigenvalues within 10 tol = 2e-2 relative). The single-card banded
    engine refines its solve once and the Schwarz block solve does not, so
    the two iterations differ in the last f32 digits of every inverse, and
    each change-based stop may leave its eigenvalues up to tol/(1 - rho)
    from the limit (phase 17's reasoning). (c)
    The general drivers (K2): ``sharded_standard_largest_general`` on the
    RCM-ordered 2^20 graph (the single-card ``standard_largest`` on its
    ELL container to 1e-6: the same sums), ``sharded_generalized_inverse_
    general`` on RCM-ordered elasticity_2d(96), nev 4, inner 'schwarz' and
    'cg' (phase 8's ARPACK values, its gate 1e-2), ``sharded_lobpcg_general``
    on elasticity_2d(512), nev 8 (phase 7's ARPACK values and gate, 1e-2).
    (d) The local applies split P ways in one process, P = 2, 3, 4, 8, fed
    with the slabs the neighbours would send, against the global kernel on
    the same X: K1 on 3D N=216 m=24 (f32: 1e-6 of max|Y|, the edge terms
    added after the interior sum; bf16: 1e-2, after the kernel's bf16
    rounding), K2 overlapped and serialized on RCM-ordered elasticity_2d(512)
    scalar m=8 (P = 3 pads its rows) and serialized on the graph m=8 (its
    halo, ~95k, is past the dense boundary blocks' cap, so the reference
    serializes there too), 1e-6 of max|Y|; the bandwidth guards raise.
    Every product of (a)-(c) launches its kernel (``PlainProductsRefused``).
    Returns the launches of K1 and K2 on the dist path."""
    import tempfile

    import scipy.sparse as sp
    import torch.distributed as dist
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from dune_eigensolver_tpu_torch import dist as tdist
    from dune_eigensolver_tpu_torch.dist import dryrun, sharded, windowed
    from dune_eigensolver_tpu_torch.dist.mesh import Mesh
    from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory
    from dune_eigensolver_tpu_torch.kernels import dia_spmm as kd
    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.oracle.analytic import (
        eigenvalues_laplace_dirichlet_2d,
        eigenvalues_laplace_dirichlet_3d,
    )
    from dune_eigensolver_tpu_torch.solvers import (
        lobpcg_generalized,
        standard_inverse,
        standard_largest,
    )
    from dune_eigensolver_tpu_torch.sparse import ell_from_scipy

    t_phase = time.perf_counter()
    counts = sharded.COUNTS
    launches = dict(dia_spmm_t=0, ell_spmm_t=0)

    def tally(rec):
        for k in launches:
            launches[k] += rec["launches"][k]

    checks, tmp = dist_no_fallback(torch, dist)
    device = tdist.init_distributed("cuda", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                    rank=0, world_size=1)
    mesh = tdist.make_mesh()
    gloo = dist.new_group(backend="gloo")
    try:
        tdist.sharded_standard_largest(
            problems.laplacian_dirichlet_2d(8, dtype=torch.float32, device="cuda"), nev=4,
            tol=1e-3, maxiter=3, mesh=Mesh(group=gloo, ranks=(0,), rank=0, device=device))
    except ValueError as e:
        checks["cuda_on_gloo"] = str(e)
    else:
        raise RuntimeError("a CUDA operand on a gloo group did not raise")
    log("DIST checks " + json.dumps(dict(checks, mesh=dict(size=mesh.size, rank=mesh.rank,
                                                           device=str(mesh.device)))))
    out = {}
    with PlainProductsRefused():
        # (a) the north star, sharded form
        N3 = 216
        A3 = problems.laplacian_dirichlet_3d(N3, dtype=torch.float32, device="cuda")
        n3 = A3.shape[0]
        B3 = DIAMatrix(data=torch.ones((1, n3), device="cuda"), offsets=(0,), shape=A3.shape)
        kw = dict(nev=24, tol=2e-3, maxiter=300, shift=0.0, ortho_block=24)
        res, rec = dist_record(torch, kernels, lambda: tdist.sharded_lobpcg_generalized(
            A3, B3, mesh=mesh, precond="mg", prec_dtype=torch.bfloat16, **kw), counts)
        ev = check_solve(torch, "dist north star", res, n3, 24)
        exact = eigenvalues_laplace_dirichlet_3d(N3, count=20)
        err = float(np.abs(np.sort(ev)[:20] - exact).max())
        del res
        t0 = time.perf_counter()
        single = lobpcg_generalized(A3, B3, precond=mg_inverse_factory(
            nu1=1, nu2=1, dtype=torch.bfloat16), **kw)
        ev1 = single.eigenvalues.cpu().numpy()
        t_single = time.perf_counter() - t0
        rec.update(n=n3, nev=24, max_err=err, gate=1e-5,
                   single_card=dict(seconds=t_single, iterations=int(single.iterations),
                                    max_err=float(np.abs(np.sort(ev1)[:20] - exact).max())),
                   single_card_relative=dist_match("dist north star", ev, ev1, 1e-6),
                   eigenvalues=ev.tolist())
        del single
        log("DIST north_star " + json.dumps(rec))
        if not err <= 1e-5:
            raise RuntimeError(f"dist north star: max_err {err:.3e} > 1e-5")
        if rec["launches"]["dia_spmm_t"] <= 0 or rec["collectives"].get("all_gather", 0) <= 0:
            raise RuntimeError("dist north star: no K1 launch or no all_gather in the timed run")
        tally(rec)
        out["north_star"] = rec
        del A3, B3
        drop_setups()
        torch.cuda.empty_cache()

        # (b) the other DIA drivers
        A2 = problems.laplacian_dirichlet_2d(2048, dtype=torch.float32, device="cuda")
        res, rec = dist_record(torch, kernels, lambda: tdist.sharded_standard_largest(
            A2, nev=8, tol=2e-3, maxiter=4000, mesh=mesh), counts)
        ev = check_solve(torch, "dist largest", res, 2048**2, 8)
        err = float(np.abs(ev - eigenvalues_laplace_dirichlet_2d(2048)[::-1][:8]).max())
        rec.update(max_err=err, gate=4 * np.sqrt(2e-3),
                   single_card_relative=dist_match("dist largest", ev, refs["largest"], 1e-6))
        log("DIST largest " + json.dumps(rec))
        if not err <= 4 * np.sqrt(2e-3):
            raise RuntimeError(f"dist largest: max_err {err:.3e} > {4 * np.sqrt(2e-3):.3e}")
        tally(rec)
        out["largest"] = rec
        del A2, res
        A5 = problems.laplacian_dirichlet_2d(512, dtype=torch.float32, device="cuda")
        res, rec = dist_record(torch, kernels, lambda: tdist.sharded_standard_inverse(
            A5, nev=8, tol=1e-6, maxiter=200, mesh=mesh, inner="schwarz"), counts)
        ev = check_solve(torch, "dist inverse", res, 512**2, 8)
        err = float(np.abs(ev - eigenvalues_laplace_dirichlet_2d(512)[:8]).max())
        drop_setups()
        ev1 = standard_inverse(A5, nev=8, tol=1e-6, maxiter=200).eigenvalues.cpu().numpy()
        rec.update(max_err=err, gate=1e-5,
                   single_card_absolute=dist_match("dist inverse", ev, ev1, 1e-5, absolute=True),
                   single_card_relative=float(np.abs(np.sort(ev) - np.sort(ev1)).max()
                                              / np.abs(ev1).max()))
        log("DIST inverse " + json.dumps(rec))
        if not err <= 1e-5:
            raise RuntimeError(f"dist inverse: max_err {err:.3e} > 1e-5")
        tally(rec)
        out["inverse"] = rec
        del A5, res
        drop_setups()
        Ap = problems.laplacian_neumann_2d(256, dtype=torch.float32, device="cuda")
        Bp = problems.laplacian_b_2d(256, 3, dtype=torch.float32, device="cuda")
        res, rec = dist_record(torch, kernels, lambda: tdist.sharded_generalized_inverse(
            Ap, Bp, nev=8, tol=2e-3, maxiter=200, shift=1e-3, mesh=mesh), counts)
        ev = check_solve(torch, "dist parity", res, 256**2, 8)
        err = relerr(ev, refs["parity_oracle"][:8])
        rec.update(relerr=err, gate=5e-2, plateau=plateau(err, 2e-3),
                   single_card_relative=dist_match("dist parity", ev, refs["parity"], 2e-2))
        log("DIST parity " + json.dumps(rec))
        if not err <= 5e-2:
            raise RuntimeError(f"dist parity: relerr {err:.3e} > 5e-2")
        tally(rec)
        out["parity"] = rec
        del Ap, Bp, res
        drop_setups()
        torch.cuda.empty_cache()

        # (c) the general drivers: K2 on the rank's rows
        Sg = refs["graph"]
        t0 = time.perf_counter()
        plan = windowed.windowed_shard_plan(windowed.largest_operator(Sg), 1, 0, "cuda")
        t_plan = time.perf_counter() - t0
        res, rec = dist_record(torch, kernels, lambda: tdist.sharded_standard_largest_general(
            Sg, nev=4, tol=1e-3, maxiter=1000, mesh=mesh, plan=plan), counts)
        ev = check_solve(torch, "dist largest_general", res, Sg.shape[0], 4)
        Eg = ell_from_scipy(Sg, dtype=torch.float32, device="cuda")
        ev1 = standard_largest(Eg, nev=4, tol=1e-3, maxiter=1000).eigenvalues.cpu().numpy()
        rec.update(plan_seconds=t_plan, halo=plan.halo,
                   single_card_relative=dist_match("dist largest_general", ev, ev1, 1e-6))
        log("DIST largest_general " + json.dumps(rec))
        tally(rec)
        out["largest_general"] = rec
        del plan, res, Eg
        Sa96, Sb96 = refs["flagship_pencil"]
        p96 = np.asarray(reverse_cuthill_mckee(Sa96, symmetric_mode=True))
        Sa96, Sb96 = Sa96[p96][:, p96].tocsr(), Sb96[p96][:, p96].tocsr()
        for inner, extra in (("schwarz", {}), ("cg", dict(cg_rtol=1e-5, cg_maxiter=1000))):
            def run(inner=inner, extra=extra):
                return tdist.sharded_generalized_inverse_general(
                    Sa96, Sb96, nev=4, tol=2e-3, maxiter=300, shift=1e-3, mesh=mesh,
                    inner=inner, **extra)

            res, rec = dist_record(torch, kernels, run, counts)
            ev = check_solve(torch, f"dist generalized_general {inner}", res, Sa96.shape[0], 4)
            err = relerr(ev, refs["flagship4_oracle"])
            rec.update(relerr=err, gate=1e-2, plateau=plateau(err, 2e-3), inner=inner)
            log(f"DIST generalized_general {inner} " + json.dumps(rec))
            if not err <= 1e-2:
                raise RuntimeError(f"dist generalized_general {inner}: relerr {err:.3e} > 1e-2")
            tally(rec)
            out[f"generalized_general_{inner}"] = rec
            del res
            drop_setups()
        Sa5, Sb5 = refs["geneo_pencil"]
        res, rec = dist_record(torch, kernels, lambda: tdist.sharded_lobpcg_general(
            Sa5, Sb5, nev=8, tol=2e-3, maxiter=300, shift=1e-3, mesh=mesh, cg_rtol=1e-2,
            cg_maxiter=25), counts)
        ev = check_solve(torch, "dist lobpcg_general", res, Sa5.shape[0], 8)
        err = relerr(ev, refs["geneo_oracle"])
        rec.update(relerr=err, gate=1e-2, plateau=plateau(err, 2e-3))
        log("DIST lobpcg_general " + json.dumps(rec))
        if not err <= 1e-2:
            raise RuntimeError(f"dist lobpcg_general: relerr {err:.3e} > 1e-2")
        if rec["launches"]["ell_spmm_t"] <= 0:
            raise RuntimeError("dist lobpcg_general: K2 was launched no time")
        tally(rec)
        out["lobpcg_general"] = rec
        del res
        drop_setups()
        torch.cuda.empty_cache()

    # (d) the local applies split P ways in one process
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(20)
    split = []
    A3 = problems.laplacian_dirichlet_3d(216, dtype=torch.float32, device="cuda")
    for dtype, gate in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
        Ad = DIAMatrix(data=A3.data.to(dtype), offsets=A3.offsets, shape=A3.shape)
        X = torch.randn((24, A3.shape[0]), generator=gen, device="cuda").to(dtype)
        Y = kd.dia_spmm_t_cuda(Ad, X).float()
        for P in (2, 3, 4, 8):
            err = (dryrun.split_dia_apply_t(Ad, X, P).float() - Y).abs().max().item()
            split.append(dict(kernel="dia_spmm_t", operand="3d N=216 m=24", dtype=str(dtype),
                              P=P, max_abs_err=err, rel=err / Y.abs().max().item(), gate=gate))
        del Ad, X, Y
    try:
        dryrun.split_dia_apply_t(A3, torch.zeros((1, A3.shape[0]), device="cuda"), 216**2)
    except ValueError as e:
        guard = [str(e)]
    else:
        raise RuntimeError("the K1 route's bandwidth guard did not raise")
    del A3
    torch.cuda.empty_cache()
    S5 = refs["geneo_pencil"][0]
    p5 = np.asarray(reverse_cuthill_mckee(S5, symmetric_mode=True))
    for name, S, forms in (("elasticity N=512 scalar rcm m=8", S5[p5][:, p5].tocsr(),
                            (True, False)),
                           ("graph n=2^20 m=8", refs["graph"], (False,))):
        E = ell_from_scipy(S, dtype=torch.float32, device="cuda")
        X = torch.randn((8, S.shape[0]), generator=gen, device="cuda")
        Y = kg.ell_spmm_t_cuda(E, X)
        del E
        for P in (2, 3, 4, 8):
            plans = None
            for overlap in forms:
                Z, plans = dryrun.split_windowed_apply_t(S, X, P, overlap, plans)
                err = (Z - Y).abs().max().item()
                split.append(dict(kernel="ell_spmm_t", operand=name, P=P, overlap=overlap,
                                  halo=plans[0].halo, max_abs_err=err,
                                  rel=err / Y.abs().max().item(), gate=1e-6))
            del plans, Z
        del X, Y
    try:
        windowed.windowed_shard_plans(refs["graph"], 64, "cuda")
    except ValueError as e:
        guard.append(str(e))
    else:
        raise RuntimeError("the K2 route's bandwidth guard did not raise")
    for row in split:
        log("DIST split " + json.dumps(row))
        if not row["rel"] <= row["gate"]:
            raise RuntimeError(f"dist split: {row}")
    log("DIST guards " + json.dumps(guard))
    out["split_seconds"] = time.perf_counter() - t0
    dist.destroy_process_group()
    log("DIST " + json.dumps(dict(seconds=time.perf_counter() - t_phase,
                                  split_seconds=out["split_seconds"], launches=launches)))
    if launches["dia_spmm_t"] <= 0 or launches["ell_spmm_t"] <= 0:
        raise RuntimeError(f"dist: a kernel of the path was launched no time {launches}")
    return out, launches


#: phase 21 (c): the hooked CG inverse (the plain loop) against the plain
#: factory's (the fused step), f32 cg25, relative to Y's largest value: the
#: dots' summation order alone differs (tests/test_torch_cg_fused.py's X_TOL);
#: against the plain loop itself the bits must be equal
HOOKS_CG_Y_TOL = 1e-5


def phase_hooks(torch, kernels, problems, DIAMatrix, mg_inverse_factory, A96, B96, graph):
    """Phase 21: the JAX package's public hook keywords at full width
    (``HOOKS`` lines), each call beside the same call without hooks.

    (a) The north-star operand, one level: ``lobpcg_generalized`` on the 3D
    Laplacian 216^3 f32, nev 24, ``ortho_block`` 24, ``ortho_iterations`` 1,
    identity B, the V(1,1) bf16 V-cycle, from one start block: plain
    (``b_identity``, the V-cycle factory, q0 (n, 24)), then matrix-free
    (``apply_a`` K1 through ``spmm_t``, ``apply_b`` and ``gram_reduce`` the
    identity, a factory that returns the V-cycle built on the operand
    whatever it is handed, q0 (24, n)), each run twice and the second
    timed. Gates: equal iterations, eigenvalues within 1e-6 relative (equal
    bits expected, reported), K1 launched in the hooked run, both within
    the north star's 1e-5 of the closed form. (b) ``generalized_inverse`` on
    the flagship pencil ``elasticity_2d(96)`` at nev 4 (phase 8's call, K3
    in the inner CG) with ``gram_reduce`` alone and q0 transposed: the
    plain call's iterations and bits (the inner CG takes no ``gram_reduce``,
    so both run the fused step). (c) ``cg_inverse_factory(apply_a=,
    gram_reduce=)`` (K2 through ``spmm_t``) on the 2^20 graph, cg25 (rtol
    1e-2, 25 steps): the bits of the plain loop ``_cg_loop`` on the same
    operand and block, which the hooked call runs with ``gram_reduce``; and
    within ``HOOKS_CG_Y_TOL`` of the largest value of the factory without
    hooks, whose CG takes the fused step (``cg_solve_t.fused`` counts it)
    and sums its dots in another order. No product of the phase may take a
    plain version."""
    from dune_eigensolver_tpu_torch import (
        cg_inverse_factory,
        ell_from_scipy,
        generalized_inverse,
        lobpcg_generalized,
        spmm_t,
    )
    from dune_eigensolver_tpu_torch.factorize.cg import _cg_loop, cg_solve_t
    from dune_eigensolver_tpu_torch.oracle.analytic import eigenvalues_laplace_dirichlet_3d

    t_phase = time.perf_counter()
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(21)

    def identity(g):
        return g

    drop_setups()
    torch.cuda.empty_cache()
    with PlainProductsRefused():
        # (a) the north-star operand, one level, plain and matrix-free
        N = 216
        A = problems.laplacian_dirichlet_3d(N, dtype=torch.float32, device="cuda")
        n = A.shape[0]
        B = DIAMatrix(data=torch.ones((1, n), device="cuda"), offsets=(0,), shape=A.shape)
        prec = mg_inverse_factory(nu1=1, nu2=1, dtype=torch.bfloat16)
        pair = prec(A)  # the V-cycle on A' = A (shift 0)
        q0 = torch.randn((n, 24), generator=gen, device="cuda")
        kw = dict(nev=24, tol=2e-3, maxiter=300, shift=0.0, ortho_iterations=1, ortho_block=24)
        exact = eigenvalues_laplace_dirichlet_3d(N, count=20)
        runs = {
            "plain": lambda: lobpcg_generalized(A, B, precond=prec, b_identity=True, q0=q0, **kw),
            "matrix_free": lambda: lobpcg_generalized(
                A, B, apply_a=lambda Xt: spmm_t(A, Xt), apply_b=identity, gram_reduce=identity,
                precond=lambda _handed: pair, q0=q0.T.contiguous(), **kw),
        }
        res = {}
        for name, run in runs.items():
            res[name], rec = timed_twice(torch, run, kernels)
            ev = check_solve(torch, f"hooks north star {name}", res[name], n, 24)
            rec.update(n=n, nev=24, max_err=float(np.abs(np.sort(ev)[:20] - exact).max()))
            log(f"HOOKS north star {name} " + json.dumps(rec))
            out[f"north_star_{name}"] = rec
        a, b = out["north_star_plain"], out["north_star_matrix_free"]
        ev_p, ev_h = res["plain"].eigenvalues, res["matrix_free"].eigenvalues
        rel = float(((ev_h - ev_p).abs().max() / ev_p.abs().max()).item())
        bits = bool(torch.equal(ev_h, ev_p) and torch.equal(res["matrix_free"].eigenvectors,
                                                            res["plain"].eigenvectors))
        log("HOOKS north star " + json.dumps(dict(iterations=[a["iterations"], b["iterations"]],
                                                  relative_difference=rel, equal_bits=bits)))
        if (a["iterations"] != b["iterations"] or not rel <= 1e-6
                or b["launches"]["dia_spmm_t"] <= 0 or not max(a["max_err"], b["max_err"]) <= 1e-5):
            raise RuntimeError(f"hooks north star: {a} against {b}, relative {rel:.3e}")
        out["north_star_equal_bits"] = bits
        del A, B, prec, pair, q0, runs, res, ev_p, ev_h
        drop_setups()
        torch.cuda.empty_cache()

        # (b) gram_reduce alone on the flagship pencil, K3 in the inner CG
        inv = cg_inverse_factory(rtol=1e-5, maxiter=1000)
        q0 = torch.randn((A96.shape[0], 8), generator=gen, device="cuda")
        common = dict(nev=4, tol=2e-3, maxiter=300, shift=1e-3, inverse=inv)
        got = {}
        for name, run in (
            ("plain", lambda: generalized_inverse(A96, B96, q0=q0, **common)),
            ("gram_reduce", lambda: generalized_inverse(A96, B96, q0=q0.T.contiguous(),
                                                        gram_reduce=identity, **common)),
        ):
            torch.cuda.synchronize()
            set_counts(kernels)
            t0 = time.perf_counter()
            got[name] = run()
            got[name].eigenvalues.cpu()
            out[f"flagship_{name}"] = rec = dict(
                seconds=time.perf_counter() - t0, iterations=int(got[name].iterations),
                launches=read_counts(kernels))
            check_solve(torch, f"hooks flagship {name}", got[name], A96.shape[0], 4)
            log(f"HOOKS flagship nev=4 {name} " + json.dumps(rec))
        same = (torch.equal(got["plain"].eigenvalues, got["gram_reduce"].eigenvalues)
                and torch.equal(got["plain"].eigenvectors, got["gram_reduce"].eigenvectors))
        if (not same or out["flagship_plain"]["iterations"] != out["flagship_gram_reduce"]["iterations"]
                or out["flagship_gram_reduce"]["launches"]["bsr_spmm_t"] <= 0):
            raise RuntimeError(f"hooks flagship: equal bits {same}, {out}")
        del got, q0
        drop_setups()

        # (c) the CG inverse with the operator and the reduction as hooks
        Ag = ell_from_scipy(graph, dtype=torch.float32, device="cuda")
        Xt = torch.randn((8, Ag.shape[0]), generator=gen, device="cuda")
        aux, fn = cg_inverse_factory(rtol=1e-2, maxiter=25)(Ag)
        solve = cg_inverse_factory(rtol=1e-2, maxiter=25, apply_a=lambda V: spmm_t(Ag, V),
                                   gram_reduce=identity)(Ag)
        Y = {}
        for name, run in (("plain", lambda: fn(aux, Xt)), ("hooks", lambda: solve(Xt)),
                          ("loop", lambda: _cg_loop(lambda V: spmm_t(Ag, V), Xt, aux[1], 1e-2,
                                                    25, None, None, None)[0])):
            torch.cuda.synchronize()
            set_counts(kernels)
            fused = cg_solve_t.fused
            t0 = time.perf_counter()
            Y[name] = run()
            torch.cuda.synchronize()
            out[f"cg_{name}"] = rec = dict(seconds=time.perf_counter() - t0,
                                          launches=read_counts(kernels),
                                          cg_fused=cg_solve_t.fused - fused)
            log(f"HOOKS cg graph n=2^20 m=8 {name} " + json.dumps(rec))
        same = bool(torch.equal(Y["hooks"], Y["loop"]))
        rel = float(((Y["hooks"] - Y["plain"]).abs().max() / Y["plain"].abs().max()).item())
        log("HOOKS cg " + json.dumps(dict(loop_equal_bits=same, fused_relative_difference=rel)))
        if not (same and rel <= HOOKS_CG_Y_TOL and torch.isfinite(Y["hooks"]).all()
                and out["cg_hooks"]["launches"]["ell_spmm_t"] > 0
                and out["cg_plain"]["cg_fused"] == 1 and out["cg_hooks"]["cg_fused"] == 0):
            raise RuntimeError(f"hooks cg: loop bits equal {same}, fused relative {rel:.3e}, "
                               f"or no K2 or no fused step {out}")
        del Ag, Xt, aux, fn, solve, Y
    out["seconds"] = time.perf_counter() - t_phase
    log("HOOKS " + json.dumps(dict(seconds=out["seconds"],
                                   north_star_equal_bits=out["north_star_equal_bits"])))
    torch.cuda.empty_cache()
    return out


def main():
    import torch

    # --- phase 1: device ---
    phase_seconds, phase_t0 = {}, [time.perf_counter()]

    def phase_done(name):  # the seconds since the last phase ended
        now = time.perf_counter()
        phase_seconds[name] = now - phase_t0[0]
        phase_t0[0] = now

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import dune_eigensolver_tpu_torch  # noqa: F401  (sets TF32 off)
    from dune_eigensolver_tpu_torch import cli
    from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory
    from dune_eigensolver_tpu_torch.kernels import cg_step as cs
    from dune_eigensolver_tpu_torch.kernels import dia_spmm as kd
    from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
    from dune_eigensolver_tpu_torch.kernels import mg_tail as mt
    from dune_eigensolver_tpu_torch.oracle.analytic import eigenvalues_laplace_dirichlet_3d
    from dune_eigensolver_tpu_torch.solvers import lobpcg_nested
    from dune_eigensolver_tpu_torch.sparse import DIAMatrix, ell_from_scipy, problems, rcm_pencil
    from dune_eigensolver_tpu_torch.utils import native

    from dune_eigensolver_tpu_torch.experiments import kernel_variants as kv
    from dune_eigensolver_tpu_torch.experiments import pipeline_probe as pp

    kernels = {"dia_spmm_t": kd.dia_spmm_t_cuda, "ell_spmm_t": kg.ell_spmm_t_cuda,
               "bsr_spmm_t": kg.bsr_spmm_t_cuda, "spmm_c": kv.spmm_c, "spmm_b": kv.spmm_b,
               "spmm_d": kv.spmm_d, "ident": pp.ident, "identd": pp.identd,
               "ident_alias": pp.ident_alias,
               **{name: getattr(cs, name + "_cuda") for name in CG_STEP_KERNELS},
               "mg_tail": mt.mg_tail_cuda}

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")

    phase_done("phase 1")
    # --- phase 2: build ---
    logs = {}
    for name, csrc in (("solver", native.SOLVER), ("studies", native.STUDIES)):
        t0 = time.perf_counter()
        path, logs[name] = native.build(csrc)
        native.load(csrc)
        log(f"build {name}: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(path, ROOT)}")
    build_log = logs["solver"] + logs["studies"]
    t0 = time.perf_counter()
    host_path, host_log = native.build_host()
    native.load_host()
    log(f"build host helper (g++): {time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(host_path, ROOT)} {host_log.strip()}")
    for line in build_log.splitlines():
        if ("registers" in line or "spill" in line or "error" in line.lower()
                or "dia_spmm_t" in line or "bsr_spmm_t" in line or "ell_spmm_t" in line):
            log("  ptxas: " + line.strip())

    regs = ell_registers(build_log)
    k2 = {k: v for k, v in ell_registers(logs["solver"]).items()
          if k.startswith(("v=0 rows=8 kc=9 cap=6 f32 int32", "v=0 rows=8 kc=9 cap=5 f32 int16",
                           "v=0 rows=4 kc=9 cap=3 f64"))}
    log("REGISTERS " + json.dumps(dict(k2=k2, ell_body=regs)))

    phase_done("phase 2")
    # --- phase 3: kernel against plain version ---
    # phase 7's oracle on the host, in a worker process beside phases 3-6
    oracle_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    geneo_ref = oracle_pool.submit(geneo_oracle, 512)
    records = phase_kernel(torch, kd, problems)

    phase_done("phase 3")
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
    by_width = collections.Counter()
    for call, c in kd.dia_spmm_t_cuda.calls.items():
        by_width[call.n, call.width] += c
    taken = {f"n={n} width={w}": c for (n, w), c in sorted(by_width.items())}
    fine = {w: c for (n, w), c in by_width.items() if n == N3**3}
    if set(fine) != {4} or sum(by_width.values()) != launches:
        raise RuntimeError(f"the 216^3 solve's fine-level launches did not all take 4 columns "
                           f"a thread: {taken} of {launches} launches")
    peak = torch.cuda.max_memory_allocated()
    exact = eigenvalues_laplace_dirichlet_3d(N3, count=20)
    err = check_result(torch, res, N3, 20, 1e-5, exact)
    if launches <= 0:
        raise RuntimeError("the 216^3 solve launched the DIA kernel no time")
    mg_tail_launches = mt.mg_tail_cuda.launches
    if mg_tail_launches <= 0:
        raise RuntimeError("the 216^3 solve launched the multigrid tail kernel no time")
    log("SOLVE " + json.dumps(dict(
        n=N3**3, nev=20, seconds=t_solve, first_run_seconds=t_first,
        iterations=int(res.iterations), converged=bool(res.converged),
        max_err=err, dia_spmm_launches=launches, dia_spmm_taken=taken, peak_bytes=peak,
        first_run_peak_bytes=peak_first, mg_tail_launches=mg_tail_launches,
    )))
    # the timed result's block, kept on the host for phase 19's refinement
    north = dict(V=res.eigenvectors.cpu(), max_err=err, N=N3)
    del res

    phase_done("phase 4")
    # --- phase 5: spread and profile ---
    reps = []
    for _ in range(2):
        t0 = time.perf_counter()
        run().eigenvalues.cpu()
        reps.append(time.perf_counter() - t0)
    log(f"REPEAT seconds {json.dumps(reps)}")
    profile_solve(torch, "north star", run, t_solve)
    del run
    torch.cuda.empty_cache()

    phase_done("phase 5")
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
    # f64 copies (the f64 instantiations of K2 and K3)
    A512_64, E512_64, graph64 = (to_f64(M) for M in (A512, E512, A_graph))
    log(f"gather operands: {time.perf_counter() - t0:.1f} s host setup; "
        f"elasticity n={A512.shape[0]} nnz={A512.nnz}, graph n={A_graph.shape[0]} "
        f"nnz={A_graph.nnz} k={A_graph.k}, mean slots a warp of the ELL kernel runs "
        f"{A_graph.warp_slots.float().mean().item():.4f}")
    gather = phase_gather(torch, kg, [
        ("bsr elasticity N=512 m=8", A512, 8),
        ("bsr elasticity N=512 m=24", A512, 24),
        ("bsr elasticity N=96 m=128", A96, 128),
        ("ell graph n=2^20 m=8", A_graph, 8),
        ("ell graph n=2^20 m=24", A_graph, 24),
        ("ell elasticity N=512 scalar m=8", E512, 8),
        ("ell elasticity N=512 scalar m=24", E512, 24),
        ("ell graph n=100003 m=8", A_odd, 8),
        ("bsr elasticity N=1024 scaled m=8 (matvec)", B1024, 8),
        ("ell elasticity N=1024 scalar scaled m=8 (matvec)", E1024, 8),
        ("ell graph n=2^20 m=8 f64", graph64, 8),
        ("ell elasticity N=512 scalar m=8 f64", E512_64, 8),
        ("bsr elasticity N=512 m=8 f64", A512_64, 8),
    ])
    # the index stream each ELL container holds for the kernel: int32
    # columns for the graph (its rows reach ~95k columns away), int16
    # offsets for the mesh-ordered elasticity operands
    taken = {r["case"]: r.get("index_bytes") for r in gather if r["kernel"] == "ell_spmm_t_cuda"}
    for case, want in (("ell graph n=2^20 m=8", 4), ("ell elasticity N=512 scalar m=24", 2),
                       ("ell elasticity N=1024 scalar scaled m=8 (matvec)", 2)):
        if taken[case] != want:
            raise RuntimeError(f"{case}: the ELL kernel read {taken[case]}-byte indices, "
                               f"expected {want}")
    del A_odd
    torch.cuda.empty_cache()
    phase_reread(torch, kd, kg, problems, A512)
    gen = torch.Generator(device="cuda").manual_seed(4)
    library = phase_library(torch, [
        (name, A, torch.randn((m, A.shape[1]), generator=gen, device="cuda", dtype=A.dtype),
         kernel)
        for name, A, m, kernel in (
            ("bsr elasticity N=512 m=8", A512, 8, kg.bsr_spmm_t_cuda),
            ("ell graph n=2^20 m=8", A_graph, 8, kg.ell_spmm_t_cuda),
            ("bsr elasticity N=96 m=128", A96, 128, kg.bsr_spmm_t_cuda),
            ("ell graph n=2^20 m=24", A_graph, 24, kg.ell_spmm_t_cuda),
            ("ell elasticity N=512 scalar m=8", E512, 8, kg.ell_spmm_t_cuda),
            ("bsr elasticity N=512 m=24", A512, 24, kg.bsr_spmm_t_cuda),
            ("bsr elasticity N=1024 scaled m=8 (matvec)", B1024, 8, kg.bsr_spmm_t_cuda),
            ("ell elasticity N=512 scalar m=24", E512, 24, kg.ell_spmm_t_cuda),
            ("ell elasticity N=1024 scalar scaled m=8 (matvec)", E1024, 8, kg.ell_spmm_t_cuda),
            ("ell graph n=2^20 m=8 f64", graph64, 8, kg.ell_spmm_t_cuda),
            ("ell elasticity N=512 scalar m=8 f64", E512_64, 8, kg.ell_spmm_t_cuda),
            ("bsr elasticity N=512 m=8 f64", A512_64, 8, kg.bsr_spmm_t_cuda),
        )
    ])
    del E512, B1024, E1024, A512_64, E512_64, graph64
    torch.cuda.empty_cache()

    phase_done("phase 6")
    # --- phase 22: the CG step's kernels against their plain versions ---
    cg_rows = phase_cg_step(torch, A512, B512)

    phase_done("phase 22")
    # --- phase 23: the multigrid tail's kernel against the eager tail ---
    mg_rows = phase_mg_tail(torch)

    phase_done("phase 23")
    # --- phases 7-9: the general-sparsity path ---
    geneo = phase_geneo(torch, kernels, A512, B512, geneo_ref)
    oracle_pool.shutdown()
    geneo_pencil = (A512.to_scipy(), B512.to_scipy())  # phase 20's general drivers
    del A512, B512
    torch.cuda.empty_cache()
    flagship = phase_flagship(torch, kernels, A96, B96)
    S20 = problems.unstructured_laplacian(20_000, extra_edges=1_000, seed=5, fmt="scipy")
    graph_small = (S20, rcm_pencil(S20, dtype=torch.float32, device="cuda")[0])
    graph = phase_graph(torch, kernels, A_graph, graph_small)
    graph_scipy = A_graph.to_scipy()  # phase 20's general drivers
    del A_graph

    del graph_small
    torch.cuda.empty_cache()

    phase_done("phases 7-9")
    # --- phases 10-11: the new kernels against their plain versions ---
    x8, d5, copy_errs = phase_copy_check(torch, pp)
    phase_variant_check(torch, kv, kd, problems, DIAMatrix)

    phase_done("phases 10-11")
    # --- phase 12: the measurement path through its entry points ---
    cli_launches, roofline, variants = phase_measure(torch, kernels, pp, kv)
    copy_gbps = roofline["copy_gbps"]
    copies = copy_kernel_rows(torch, pp, x8, d5, copy_errs, roofline["best_ident_tile"],
                              copy_gbps)
    del x8, d5
    torch.cuda.empty_cache()

    phase_done("phase 12")
    # --- phase 13: the library call beside the DIA kernel, at phase 3's shapes ---
    for name, dim, N, m, dtype, _ in phase_kernel_cases(torch):
        build = problems.laplacian_dirichlet_2d if dim == 2 else problems.laplacian_dirichlet_3d
        A32 = build(N, dtype=torch.float32, device="cuda")
        A = DIAMatrix(data=A32.data.to(dtype), offsets=A32.offsets, shape=A32.shape)
        del A32
        X = torch.randn((m, A.shape[0]), generator=gen, device="cuda").to(dtype)
        library.update(phase_library(torch, [(name, A, X, kd.dia_spmm_t_cuda)]))
        del A, X
        torch.cuda.empty_cache()

    phase_done("phase 13")
    # --- phases 15-16: the gather-kernel study path ---
    from dune_eigensolver_tpu_torch.experiments import gather_ablate as ga
    from dune_eigensolver_tpu_torch.experiments import gather_probe as gp

    study_kernels = {"ell_spmm_t": kg.ell_spmm_t_cuda, "ablate_full": ga.ablate_full,
                     "ablate_nogather": ga.ablate_nogather, "ablate_nodyn": ga.ablate_nodyn,
                     "ablate_nofma": ga.ablate_nofma, **gp.KERNELS}
    phase_study_check(torch, ga, gp)
    study_launches, k2_by_operand, ablate_ops, ablate_rows, forms = phase_study(
        torch, study_kernels, ga, gp, copy_gbps)
    e512 = next(A for name, A in ablate_ops if name == "elasticity_512")
    ablate_library = phase_library(torch, [
        ("ell elasticity N=512 scalar scaled m=8", e512,
         torch.randn((8, e512.shape[0]), generator=gen, device="cuda"), ga.ablate_full),
    ])["ell elasticity N=512 scalar scaled m=8"]
    del e512
    torch.cuda.empty_cache()

    phase_done("phases 15-16")
    # --- phase 17: the standard entry points and the CLI's protocols ---
    standard = phase_standard(torch, kernels, problems)

    phase_done("phase 17")
    # --- phase 18: the direct engines, the reference's default inverse ---
    direct = phase_direct(torch, kernels, problems, flagship, A96, B96)
    flagship_pencil = (A96.to_scipy(), B96.to_scipy())  # phase 20's general drivers
    del A96, B96
    torch.cuda.empty_cache()

    phase_done("phase 18")
    # --- phase 19: the solver extras and float64 through the entry points ---
    extras, f64_launches = phase_extras(torch, kernels, cli, problems, DIAMatrix, lobpcg_nested,
                                        mg_inverse_factory, north, geneo)

    phase_done("phase 19")
    # --- phase 20: the distributed layer, world size 1 under NCCL ---
    dist_refs = dict(largest=standard["largest"], parity=direct["parity"]["eigenvalues"],
                     parity_oracle=extras["parity_oracle"], graph=graph_scipy,
                     flagship_pencil=flagship_pencil, flagship4_oracle=flagship[1]["oracle"],
                     geneo_pencil=geneo_pencil, geneo_oracle=geneo["oracle"])
    _, dist_launches = phase_dist(torch, kernels, problems, DIAMatrix, dist_refs)
    del dist_refs, flagship_pencil, geneo_pencil

    phase_done("phase 20")
    # --- phase 21: the JAX package's public hooks at full width ---
    A96, B96 = problems.elasticity_2d(96, dtype=torch.float32, device="cuda")
    phase_hooks(torch, kernels, problems, DIAMatrix, mg_inverse_factory, A96, B96, graph_scipy)
    del A96, B96, graph_scipy

    phase_done("phase 21")
    # --- phase 14: the kernel table ---
    def entry(name, source, replaces, launches, rec, nbytes, flops, library_ms, **more):
        b_ms, b_by = bound(nbytes, flops,
                           F64_FLOPS_PER_S if rec.get("dtype") == "float64" else F32_FLOPS_PER_S)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms, "shape": rec["case"],
                "copy_bound_ms": nbytes / copy_gbps / 1e6,
                "share_of_copy_bound": nbytes / copy_gbps / 1e6 / rec["ms"],
                "cli_launches": cli_launches.get(name), **more,
                **({"device_share_of_copy_bound": nbytes / copy_gbps / 1e6 / more["device_ms"]}
                   if "device_ms" in more else {})}

    def gather_entry(name, source, replaces, launches, rec, per_index, **more):
        # coefficients once, one index per ``per_index`` of them (a scalar
        # in ELL, of the width K2 read; a 2x2 block in BSR, int32), X and Y
        # once
        index_bytes = rec.get("index_bytes", 4)
        itemsize = 8 if rec.get("dtype") == "float64" else 4
        nbytes = ((rec["nnz"] + 2 * rec["n"] * rec["m"]) * itemsize
                  + rec["nnz"] // per_index * index_bytes)
        return entry(name, source, replaces, launches, rec, nbytes,
                     2.0 * rec["nnz"] * rec["m"], library[rec["case"]], **more)

    csrc = "dune_eigensolver_tpu_torch/csrc/"
    studies = csrc + "experiments/"
    gathered = {r["case"]: r for r in gather}
    k1 = next(r for r in records if r["case"] == "3d N=216 m=24 f32")
    k1_bytes = (7 * k1["n"] + 2 * k1["n"] * k1["m"]) * 4
    k1_nnz = sum(k1["n"] - abs(o) for o in (-N3 * N3, -N3, -1, 0, 1, N3, N3 * N3))
    table = [
        entry("dia_spmm_t", csrc + "dia_spmm.cu", "dune_eigensolver_tpu/kernels/dia_spmm.py:288",
              launches, k1, k1_bytes, 2.0 * k1_nnz * k1["m"], library[k1["case"]],
              device_ms=k1["device_ms"], width=k1["width"],
              direct_launches={k: direct[k]["launches"]["dia_spmm_t"]
                               for k in ("parity", "band_1024")},
              dist_launches=dist_launches["dia_spmm_t"]),
        gather_entry("ell_spmm_t", csrc + "ell_spmm.cu",
                     "dune_eigensolver_tpu/kernels/gather_spmm.py:792",
                     graph["launches"]["ell_spmm_t"], gathered["ell graph n=2^20 m=8"], 1,
                     device_ms=gathered["ell graph n=2^20 m=8"]["device_ms"],
                     direct_launches={"rcm_ell_4": direct["rcm_ell_4"]["launches"]["ell_spmm_t"]},
                     dist_launches=dist_launches["ell_spmm_t"]),
        # the CLI's matvec operand; elasticity_2d(512) scalar at m=8, whose
        # launches are those of ablate_table on that operand (scaled: the
        # same pattern), and at m=24, which no path launches
        gather_entry("ell_spmm_t", csrc + "ell_spmm.cu",
                     "dune_eigensolver_tpu/kernels/gather_spmm.py:792",
                     cli_launches["ell_spmm_t"],
                     gathered["ell elasticity N=1024 scalar scaled m=8 (matvec)"], 1,
                     device_ms=gathered["ell elasticity N=1024 scalar scaled m=8 (matvec)"][
                         "device_ms"]),
        gather_entry("ell_spmm_t", csrc + "ell_spmm.cu",
                     "dune_eigensolver_tpu/kernels/gather_spmm.py:792",
                     k2_by_operand["elasticity_512"], gathered["ell elasticity N=512 scalar m=8"],
                     1, device_ms=gathered["ell elasticity N=512 scalar m=8"]["device_ms"]),
        gather_entry("ell_spmm_t", csrc + "ell_spmm.cu",
                     "dune_eigensolver_tpu/kernels/gather_spmm.py:792",
                     0, gathered["ell elasticity N=512 scalar m=24"], 1,
                     device_ms=gathered["ell elasticity N=512 scalar m=24"]["device_ms"],
                     note="no path launches K2 at this shape"),
        gather_entry("bsr_spmm_t", csrc + "bsr_spmm.cu",
                     "dune_eigensolver_tpu/kernels/gather_spmm.py:845",
                     geneo["launches"]["bsr_spmm_t"], gathered["bsr elasticity N=512 m=8"], 4,
                     device_ms=gathered["bsr elasticity N=512 m=8"]["device_ms"]),
        # the flagship's shape: the rows split over the grid's second dimension
        gather_entry("bsr_spmm_t", csrc + "bsr_spmm.cu",
                     "dune_eigensolver_tpu/kernels/gather_spmm.py:845",
                     flagship[0]["launches"]["bsr_spmm_t"], gathered["bsr elasticity N=96 m=128"],
                     4, device_ms=gathered["bsr elasticity N=96 m=128"]["device_ms"],
                     direct_launches={k: direct[k]["launches"]["bsr_spmm_t"]
                                      for k in ("rcm_124", "rcm_4")}),
    ]
    # the f64 instantiations: launches are phase 19's (refinement, the f64
    # CLI), timed at phase 3's and phase 6's f64 shapes
    k1f = next(r for r in records if r["case"] == "3d N=216 m=24 f64")
    table += [
        entry("dia_spmm_t", csrc + "dia_spmm.cu", "dune_eigensolver_tpu/kernels/dia_spmm.py:288",
              f64_launches["dia_spmm_t"], k1f, (7 * k1f["n"] + 2 * k1f["n"] * k1f["m"]) * 8,
              2.0 * k1_nnz * k1f["m"], library[k1f["case"]], device_ms=k1f["device_ms"],
              width=k1f["width"]),
        gather_entry("ell_spmm_t", csrc + "ell_spmm.cu",
                     "dune_eigensolver_tpu/kernels/gather_spmm.py:792", f64_launches["ell_spmm_t"],
                     gathered["ell graph n=2^20 m=8 f64"], 1,
                     device_ms=gathered["ell graph n=2^20 m=8 f64"]["device_ms"]),
        gather_entry("bsr_spmm_t", csrc + "bsr_spmm.cu",
                     "dune_eigensolver_tpu/kernels/gather_spmm.py:845", f64_launches["bsr_spmm_t"],
                     gathered["bsr elasticity N=512 m=8 f64"], 4,
                     device_ms=gathered["bsr elasticity N=512 m=8 f64"]["device_ms"]),
    ]
    # the CG step: launches from the GenEO solve (the cell's path), the
    # flagship's nev=124 run beside
    for name in CG_STEP_KERNELS:
        rec = cg_rows[name]
        table.append(entry(name, csrc + "cg_step.cu",
                           "none: dune_eigensolver_tpu/factorize/cg.py's loop is XLA operations",
                           geneo["launches"][name], rec, rec["nbytes"], rec["flops"], None,
                           device_ms=rec["ms"], eager_ms=rec["eager_ms"],
                           dot_relerr=rec["dot_relerr"],
                           flagship_launches=flagship[0]["launches"][name]))
    # the multigrid tail: launches from the 216^3 solve (phase 4), time by
    # replay at its three entries (phase 23); the bytes b in and out once
    for rec in mg_rows:
        table.append(entry("mg_tail", csrc + "mg_tail.cu",
                           "none: dune_eigensolver_tpu/factorize/multigrid.py's levels are XLA "
                           "operations", mg_tail_launches,
                           dict(rec, case=f"{rec['vcycle']} V-cycle, (24, 27^3) bf16",
                                ms=rec["replay_ms"], plain_ms=rec["eager_device_ms"],
                                max_abs_err=None),
                           rec["bytes"], 0, None, relmax=rec["relmax"],
                           inplace_ms=rec["inplace_ms"], levels_ms=rec["levels_replay_ms"],
                           eager_wall_ms=rec["eager_wall_ms"],
                           eager_device_ops=rec["eager_device_ops"]))
    n2, m2 = 2048**2, 8
    v_bytes = (5 * n2 + 2 * n2 * m2) * 4  # bytes_spmm_dia
    v_flops = 2.0 * (5 * n2 - 2 * 2048 - 2) * m2
    def staged(rec):
        # a staged body's setting and its time by replay
        return dict(device_ms=rec["ms"], route=rec["route"], width=rec["width"],
                    threads=rec["threads"], tile=rec["tile"], rows=rec["rows"],
                    staged_per_consumed=rec["staged_per_consumed"], k1_bits=rec["k1_bits"])

    def best_of(group):
        b = variants["best"][group]
        return dict(tile=b["tile"], rows=b["rows"], ms=b["ms"], route=b["route"],
                    width=b["width"], threads=b["threads"],
                    staged_per_consumed=b["staged_per_consumed"], max_abs_err=b["max_abs_err"],
                    copy_share=v_bytes / copy_gbps / 1e6 / b["ms"])

    for name, variant, line in (("spmm_c", "C r1-style", 51), ("spmm_b", "B s=2 d=1", 109),
                                ("spmm_d", "D rolling", 175)):
        rec = dict(variants[variant], plain_ms=variants["plain"]["ms"],
                   case=f"2d N=2048 m=8 f32 tile {variants[variant]['tile']} rows "
                   f"{variants[variant]['rows']} ({variant})")
        more = staged(rec)
        if name == "spmm_b":
            # the three rings at the table's tile, each at the rows that fit,
            # and each ring's fastest setting of the sweep
            rings = [f"B s={s} d={q}" for s, q in kv.B_RINGS]
            more.update(rings_ms={r: variants[r]["ms"] for r in rings},
                        rings_rows={r: variants[r]["rows"] for r in rings},
                        best={r: best_of(r) for r in rings})
        elif name == "spmm_c":
            more["best"] = best_of("C")
        else:
            inplace = variants["D in-place"]
            more.update(best=best_of("D"),
                        in_place=dict(ms=inplace["ms"], max_abs_err=inplace["max_abs_err"],
                                      copy_share=v_bytes / copy_gbps / 1e6 / inplace["ms"]))
        table.append(entry(name, studies + "dia_stage_" + name[-1] + ".cu" if name != "spmm_b"
                           else studies + "dia_variants.cu", f"experiments/kernel_variants.py:{line}",
                           cli_launches[name], rec, v_bytes, v_flops,
                           library["2d N=2048 m=8 f32"], **more))
    for name, line in (("ident", 42), ("identd", 57), ("ident_alias", 113)):
        rec = copies[name]
        more = {k: rec[k] for k in ("tile", "body", "device_ms", "library_device_ms",
                                    "device_streamed_gbps")
                if k in rec}
        table.append(entry(name, studies + "copy_probe.cu", f"experiments/pipeline_probe.py:{line}",
                           cli_launches[name], rec, rec["nbytes"], rec["flops"],
                           rec["library_ms"], **more))
    # the ablation on the reference's operand (elasticity_2d(512) scaled,
    # int16 offsets); the graph's numbers beside. ``full``'s row in ABLATE
    # times K2 itself; the ablation source's full body is timed by the
    # sweep, here at K2's setting
    e_rows = {r["variant"]: r for r in ablate_rows
              if r["operand"] == "elasticity_512" and "variant" in r}
    sweep_ms = {}
    for r in (r for r in ablate_rows if "kc" in r):
        sweep_ms.setdefault(r["operand"], {})[f"rows={r['rows']} kc={r['kc']}"] = r["us"] / 1e3
    graph_rows = {r["variant"]: r for r in ablate_rows
                  if r["operand"] != "elasticity_512" and "variant" in r}
    full = e_rows["full"]
    k2_key = "rows={} kc={}".format(*ga.K2_SETTING)
    for v in ga.VARIANTS:
        row = e_rows[v]
        ms = sweep_ms["elasticity_512"][k2_key] if v == "full" else row["us"] / 1e3
        what = f"K2's body at rows {ga.K2_SETTING[0]} kc {ga.K2_SETTING[1]}" if v == "full" else v
        rec = dict(max_abs_err=row["max_abs_err"], ms=ms, plain_ms=row["plain_us"] / 1e3,
                   case=f"ell elasticity N=512 scalar scaled k={row['k']} m={row['m']} f32 "
                   f"({what}; {ms / (full['us'] / 1e3):.3f} of K2's time)")
        flops = row["n"] * row["m"] if v == "nofma" else 2.0 * row["nnz"] * row["m"]
        # ms: device time by replay; eager_ms: the reference's chain of
        # launches (K2's own for ``full``)
        more = dict(k2_ms=full["us"] / 1e3, share_of_k2=ms / (full["us"] / 1e3),
                    index_bytes=row["index_bytes"], eager_ms=row["eager_us"] / 1e3)
        if v == "full":
            more["sweep_ms"] = sweep_ms
        else:
            g = graph_rows[v]
            more.update(graph_ms=g["us"] / 1e3, graph_share_of_k2=g["share"],
                        graph_copy_share=g["copy_share"],
                        graph_streamed_bytes=g["streamed_bytes"],
                        graph_streamed_gbps=g["streamed_gbps"])
        # what the body moves (K2's body at (8, 9) moves K2's)
        more.update(streamed_bytes=row["streamed_bytes"],
                    streamed_gbps=row["streamed_bytes"] / ms / 1e6)
        # nofma's function as one PyTorch call, Xt + data_t[0]
        library_ms = (ablate_library if v == "full" else
                      row["library_us"] / 1e3 if row["library_us"] is not None else None)
        table.append(entry(f"ablate_{v}", studies + "ell_ablate.cu", "experiments/gather_ablate.py:35",
                           study_launches[f"ablate_{v}"], rec, row["nbytes"], flops,
                           library_ms, **more))
    for name, lines in PROBE_LINES.items():
        row = forms[name]
        # ms: the device time by replay (the host's launch of one of these
        # kernels through its wrapper takes about as long); eager_ms beside
        rec = dict(max_abs_err=row["max_abs_err"], ms=row["us"] / 1e3,
                   plain_ms=row["plain_us"] / 1e3,
                   case="x".join(str(d) for d in row["shape"]) + " f32")
        flops = row["nbytes"] // 9 if name == "int8_widen" else 0  # one add per 9 bytes
        # nbytes: the function's (a block selection: one block in, one out)
        more = {"eager_ms": row["eager_us"] / 1e3,
                "library_eager_ms": row["library_eager_us"] / 1e3}
        fn = gp.KERNELS[name]
        more.update({k: getattr(fn, k) for k in ("body", "width") if hasattr(fn, k)})
        table.append(entry(name, studies + "gather_probe.cu",
                           "experiments/mosaic_gather_probe.py:" + lines,
                           study_launches[name], rec, row["nbytes"], flops,
                           row["library_us"] / 1e3, share_of_form_copy=row["share"],
                           streamed_bytes=row["streamed_bytes"],
                           streamed_gbps=row["streamed_bytes"] / row["us"] / 1e3, **more))
    phase_done("phase 14")
    log("PHASES " + json.dumps(dict(seconds=phase_seconds, total=sum(phase_seconds.values()))))
    log(json.dumps({"kernels": table}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
