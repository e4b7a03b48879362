"""Command-line interface: the kernel benchmarks of the reference program.

Counterpart of the JAX package's ``cli.py`` (itself the counterpart of
src/dune-eigensolver.cc): the same greppable result lines and the same INI
+ ``key=value`` configuration (``ParameterTree``, config.py). Ported
protocols:

* ``mgs``     — orthonormalization benchmark (cc:164-311) with the roofline
  models of bench/models.py; line ``P_n_m_i_perfn_perfb``.
* ``matvec``  — SpMM benchmark (cc:315-427); lines
  ``RESULT <variant> <n> <nnz> <m> <GFLOPs> <GBs>``. Variants: ``plain``
  (column layout), ``plain_t`` and ``cuda_t`` (the DIA kernel) on the 2D
  Laplacian; ``bsr_plain``/``bsr_cuda`` and ``ell_plain``/``ell_cuda`` on
  the elasticity operator and its scalar expansion. With ``ev.device=cpu``
  only the plain variants run. A variant that fails raises.

``largest``, ``smallest``, ``eigenvalues`` and ``scaling`` are not ported
yet; asking for one prints that and returns 2.

Everything runs on the current CUDA device unless ``ev.device=cpu``.

Usage: ``python -m dune_eigensolver_tpu_torch [ini-file] [sec.key=value ...]
[--test mgs|matvec|all]``
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from dune_eigensolver_tpu_torch.config import ParameterTree
from dune_eigensolver_tpu_torch.utils.device import resolve


def _log(ptree, level, *msg):
    if int(ptree["ev.verbose"]) >= level:
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

TESTS = {
    "mgs": mgs_performance_test,
    "matvec": matvec_performance_test,
}

#: the reference's other protocols, with what each waits for
NOT_PORTED = ("largest", "smallest", "eigenvalues", "scaling")


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
        if name in NOT_PORTED:
            print(f"test {name!r} not ported yet (ROADMAP queue 1 items 9, 13, 14); "
                  f"choose from {sorted(TESTS)} or 'all'")
            return 2
        if name not in TESTS:
            print(f"unknown test {name!r}; choose from {sorted(TESTS)} or 'all'")
            return 2

    device = _device(ptree)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    _log(ptree, 1, f"device: {kind} platform={device.type}")
    _log(ptree, 2, repr(ptree))
    for name in names:
        _log(ptree, 1, f"== {name} ==")
        TESTS[name](ptree)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
