"""Ablation of the ELL SpMM kernel: where do its microseconds go?

Counterpart of ``experiments/gather_ablate.py``, which times the TPU gather
kernel against degraded copies of its body. The TPU body's mechanisms do
not exist on this card, so what is ablated is the port's own kernel as
first written (K2's first version), one mechanism at a time
(``csrc/ell_ablate.cu``). Unlike the reference's variants, each one here is
a defined function with a plain version (``variant_reference``), so the card
can check it:

  full      Y[r,i] = sum_j data[i,j] X[r, cols[i,j]]   timed as the
            current ``ell_spmm_t_cuda``, called, not copied
  nogather  Y[r,i] = sum_j data[i,j] X[r, i']           no irregular address
  nodyn     Y[r,i] = sum_j data[i,j] X[r, (i'+j) mod ncols]   no index stream
  nofma     Y[r,i] = X[r, i'] + data[i,0]               no inner loop

with i' = min(i, ncols - 1). Where the TPU experiment swept the row tile,
this one sweeps what the first version had instead: the register chunk KC
and the threads of a block, on the ablation source's copy of that body
(``ablate_full``), which gives K2's bits (the redesigned K2's too, on
finite X). The degraded variants' shares are taken against the current
K2's time.

    python -m dune_eigensolver_tpu_torch.experiments.gather_ablate [Nel]
        [--device cpu] [--m M] [--graph-n N]

prints, for the reference's operand (``elasticity_2d(Nel)`` scaled by its
max row sum, as scalar ELL, k = 18) and for the RCM-ordered unstructured
graph Laplacian (k = 7), greppable lines

    ABLATE variant=<v> us=<t> gbps=<least bytes of v's function / t>
           share=<t / t of full> operand=<name>
    ABLATE kc=<KC> threads=<T> us=<t> operand=<name>

Every wrapper counts its launches and has no fallback: a CPU tensor raises.
On ``--device cpu`` only the plain versions run (and the output says so).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from dune_eigensolver_tpu_torch.bench.timing import bench_loop
from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
from dune_eigensolver_tpu_torch.sparse.formats import ELLMatrix, ell_from_scipy
from dune_eigensolver_tpu_torch.utils.device import resolve

VARIANTS = ("full", "nogather", "nodyn", "nofma")
KCS = (8, 16, 24, 32)  # the register chunks csrc/ell_ablate.cu is built for
THREADS = (128, 256, 512)


def _own_column(A: ELLMatrix) -> torch.Tensor:
    """i' = min(i, ncols - 1) for every row i."""
    n, n_cols = A.shape
    return torch.arange(n, device=A.device).clamp(max=n_cols - 1)


def variant_reference(A: ELLMatrix, Xt: torch.Tensor, variant: str) -> torch.Tensor:
    """The function variant ``variant`` computes, in plain PyTorch
    (accumulating in at least f32, as ``ell_spmm_t_reference``)."""
    if variant == "full":
        return kg.ell_spmm_t_reference(A, Xt)
    own = _own_column(A)
    if variant == "nogather":
        acc = kg._acc_dtype(Xt.dtype)
        return (A.data.to(acc).sum(dim=1)[None, :] * Xt[:, own].to(acc)).to(Xt.dtype)
    if variant == "nodyn":
        slots = torch.arange(A.k, device=A.device)
        cols = ((own[:, None] + slots[None, :]) % A.shape[1]).to(torch.int32)
        return kg.ell_spmm_t_reference(dataclasses.replace(A, cols=cols), Xt)
    if variant == "nofma":
        return Xt[:, own] + A.data[:, 0][None, :].to(Xt.dtype)
    raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")


def variant_bytes(A: ELLMatrix, m: int, variant: str) -> int:
    """Least bytes the variant's FUNCTION must move, f32: X read and Y
    written once, and of the operator what the function depends on (all
    coefficients and indices; coefficients alone; column 0 alone)."""
    n, n_cols = A.shape
    operator = {"full": 2 * A.nnz, "nogather": A.nnz, "nodyn": A.nnz, "nofma": n}[variant]
    return 4 * (operator + m * (n + n_cols))


def _launch(variant: str, A: ELLMatrix, Xt: torch.Tensor, kc: int, threads: int) -> torch.Tensor:
    what = f"ablate_{variant}"
    n, n_cols = A.shape
    kg._check_cuda_operands(what, A.data, A.cols, Xt, n_cols)
    if A.k < 1 or n < 1:
        raise ValueError(f"{what}: the operand has no stored entries")
    if variant == "nodyn" and A.k > n_cols:
        raise ValueError(f"{what}: k = {A.k} exceeds the {n_cols} columns")
    if kc not in (0, *KCS) or threads not in THREADS:
        raise ValueError(f"{what}: kc {kc} not in {KCS} or threads {threads} not in {THREADS}")
    data_t, cols_t = A.kernel_streams[0], A.column_stream  # K2's first version reads int32
    return kg._launch("ell_ablate_launch", Xt, (Xt.shape[0], n), VARIANTS.index(variant), kc,
                      threads, data_t.data_ptr(), cols_t.data_ptr(), n, A.k, n_cols)


def ablate_full(A: ELLMatrix, Xt: torch.Tensor, kc: int = 0, threads: int = 256) -> torch.Tensor:
    """Yt = (A @ Xt.T).T by the ablation source's copy of K2's first body
    with ``kc`` (coefficient, column) pairs in registers (0: the first
    version's choice for this k) and ``threads`` threads a block."""
    Y = _launch("full", A, Xt, kc, threads)
    ablate_full.launches += 1
    return Y


def ablate_nogather(A: ELLMatrix, Xt: torch.Tensor) -> torch.Tensor:
    """The kernel body without its irregular X addresses (module docstring)."""
    Y = _launch("nogather", A, Xt, 0, 256)
    ablate_nogather.launches += 1
    return Y


def ablate_nodyn(A: ELLMatrix, Xt: torch.Tensor) -> torch.Tensor:
    """The kernel body without its index stream (module docstring)."""
    Y = _launch("nodyn", A, Xt, 0, 256)
    ablate_nodyn.launches += 1
    return Y


def ablate_nofma(A: ELLMatrix, Xt: torch.Tensor) -> torch.Tensor:
    """The streams alone, without the inner loop (module docstring)."""
    Y = _launch("nofma", A, Xt, 0, 256)
    ablate_nofma.launches += 1
    return Y


ablate_full.launches = 0
ablate_nogather.launches = 0
ablate_nodyn.launches = 0
ablate_nofma.launches = 0

#: the kernel each variant's row of the table times
VARIANT_KERNELS = {"full": kg.ell_spmm_t_cuda, "nogather": ablate_nogather,
                   "nodyn": ablate_nodyn, "nofma": ablate_nofma}


def check_variants(A: ELLMatrix, Xt: torch.Tensor) -> dict:
    """Every variant's kernel against its plain version on the card;
    returns ``{variant: max|err|}`` and raises on a mismatch. ``full``: K2's
    first body at every (KC, threads) must give the bits of the current K2
    (on finite X: the slots K2 skips are padding); sums in another order
    than the plain version's stay within 1e-5 of the largest row's sum of
    |data| |X|; ``nofma`` is one add per entry, exact."""
    absA = dataclasses.replace(A, data=A.data.abs())
    current = kg.ell_spmm_t_cuda(A, Xt)
    for kc in (0, *KCS):
        for threads in THREADS:
            if not torch.equal(ablate_full(A, Xt, kc, threads), current):
                raise RuntimeError(f"ablate_full kc={kc} threads={threads}: differs from "
                                   "ell_spmm_t_cuda")
    errs = {}
    for variant, kernel in VARIANT_KERNELS.items():
        err = (kernel(A, Xt) - variant_reference(A, Xt, variant)).abs().max().item()
        tol = 0.0 if variant == "nofma" else (
            1e-5 * variant_reference(absA, Xt.abs(), variant).max().item())
        if not err <= tol:
            raise RuntimeError(f"ablate {variant}: max|err| {err:.3e} > tol {tol:.3e}")
        errs[variant] = err
    return errs


def run_variant(A: ELLMatrix, Xt: torch.Tensor, variant: str) -> float:
    """Seconds per application of ``variant``: the best chain of 40, as the
    reference's ``run_variant``. On a CPU tensor the plain version."""
    if Xt.is_cuda:
        kernel = VARIANT_KERNELS[variant]
        step = lambda x, A_: kernel(A_, x)  # noqa: E731
    else:
        step = lambda x, A_: variant_reference(A_, x, variant)  # noqa: E731
    return bench_loop(step, Xt, K=40, reps=4, op_args=(A,))


def ablate_operands(device, Nel: int = 512, graph_n: int = 2**20):
    """``[(name, ELLMatrix)]``, square, f32, each scaled by its max row sum
    so that chained applications stay bounded: the reference's operand
    (``elasticity_2d(Nel)``, scalar-expanded) and the unstructured graph
    Laplacian in RCM order."""
    from dune_eigensolver_tpu_torch.sparse import problems
    from dune_eigensolver_tpu_torch.sparse.reorder import rcm_pencil

    def scaled(S):
        return S / float(np.abs(S).sum(axis=1).max())

    Ab, _ = problems.elasticity_2d(Nel, dtype=torch.float64, device="cpu")
    E = ell_from_scipy(scaled(Ab.to_scipy()), dtype=torch.float32, device=device)
    S = problems.unstructured_laplacian(graph_n, extra_edges=graph_n // 20, seed=5, fmt="scipy")
    G = rcm_pencil(scaled(S), dtype=torch.float32, device=device)[0]
    return [(f"elasticity_{Nel}", E), (f"graph_{graph_n}", G)]


def ablate_table(device, Nel: int = 512, m: int = 8, graph_n: int = 2**20, operands=None):
    """Time the four variants, then the (KC, threads) sweep of the full
    body, on both operands (``operands``: those of ``ablate_operands``, for
    a caller that has built them); print the ``ABLATE`` lines and return
    the rows as dicts. On the card every variant is first held to its plain
    version (``check_variants``), whose time is taken too (``plain_us``,
    best chain of 5). On the CPU the plain versions are timed and there is
    no sweep."""
    device = resolve(device)
    rows = []
    for name, A in operands or ablate_operands(device, Nel, graph_n):
        n = A.shape[0]
        gen = torch.Generator(device=device).manual_seed(1)
        Xt = torch.randn((m, n), generator=gen, dtype=torch.float32, device=device)
        errs = check_variants(A, Xt) if device.type == "cuda" else {}
        t_full = None
        for variant in VARIANTS:
            t = run_variant(A, Xt, variant)
            t_full = t if t_full is None else t_full
            t_plain = t if device.type != "cuda" else bench_loop(
                lambda x, A_: variant_reference(A_, x, variant), Xt, K=5, reps=2, op_args=(A,))
            row = dict(operand=name, n=n, k=A.k, nnz=A.nnz, m=m, variant=variant, us=t * 1e6,
                       plain_us=t_plain * 1e6, nbytes=variant_bytes(A, m, variant),
                       gbps=variant_bytes(A, m, variant) / t / 1e9, share=t / t_full,
                       max_abs_err=errs.get(variant))
            print(f"ABLATE variant={variant} us={row['us']:.1f} gbps={row['gbps']:.1f} "
                  f"share={row['share']:.3f} operand={name}", flush=True)
            rows.append(row)
        if device.type != "cuda":
            continue
        for kc in KCS:
            for threads in THREADS:
                t = bench_loop(lambda x, A_: ablate_full(A_, x, kc, threads), Xt, K=40, reps=4,
                               op_args=(A,))
                print(f"ABLATE kc={kc} threads={threads} us={t * 1e6:.1f} operand={name}",
                      flush=True)
                rows.append(dict(operand=name, n=n, k=A.k, nnz=A.nnz, m=m, kc=kc,
                                 threads=threads, us=t * 1e6))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("Nel", nargs="?", type=int, default=512, help="elements per side")
    ap.add_argument("--device", default=None, help="cpu for the plain versions; default the card")
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--graph-n", type=int, default=2**20, help="rows of the graph operand")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    else:
        print("device: cpu (plain versions; no time here is the card's)", flush=True)
    ablate_table(device, args.Nel, args.m, args.graph_n)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
