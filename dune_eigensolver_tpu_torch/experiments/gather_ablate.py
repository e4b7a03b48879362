"""Ablation of the ELL SpMM kernel: where do its microseconds go?

Counterpart of ``experiments/gather_ablate.py``, which times the shipped
TPU gather kernel against degraded copies of its body. The TPU body's
mechanisms do not exist on this card, so what is ablated is the body the
port's K2 ships (``csrc/ell_body.cuh``, instantiated by
``csrc/experiments/ell_ablate.cu`` in the studies' library), one mechanism
at a time. Unlike the reference's
variants, each one here is a defined function with a plain version
(``variant_reference``), so the card can check it:

  full      Y[r,i] = sum_j data[i,j] X[r, cols[i,j]]   timed as
            ``ell_spmm_t_cuda``, called, not copied
  nogather  Y[r,i] = sum_j data[i,j] X[r, i']           no irregular address
  nodyn     Y[r,i] = sum_j data[i,j] X[r, (i'+j) mod ncols]   no index stream
  nofma     Y[r,i] = X[r, i'] + data[i,0]               no inner loop

with i' = min(i, ncols - 1), each at K2's constants and on K2's index
stream. As the reference's BlockSpecs bring every variant its blocks of
coefficients and indices, ``nogather`` and ``nofma`` load every slot K2
loads, to the warp counts (``variant_streamed_bytes``): ``nogather`` adds
each index, masked to 0, to its column, ``nofma`` folds coefficients and
indices into a value it stores only where no fold can reach. So ptxas
keeps the loads; ``slot_loads`` counts them in the SASS and
``slot_load_faults`` states the rule they are held to. Where the TPU experiment swept the row tile, this one sweeps K2's
two knobs on the same body (``ablate_full``): the rows of X in flight and
the register chunk, ``SWEEP``; every setting gives K2's bits. Shares are
taken against K2's time and against the copy bound (the variant's least bytes over the measured copy
rate).

    python -m dune_eigensolver_tpu_torch.experiments.gather_ablate [Nel]
        [--device cpu] [--m M] [--graph-n N]

prints, for the reference's operand (``elasticity_2d(Nel)`` scaled by its
max row sum, as scalar ELL, k = 18) and for the RCM-ordered unstructured
graph Laplacian (k = 7), greppable lines

    ABLATE variant=<v> us=<t> gbps=<least bytes of v's function / t>
           streamed_bytes=<bytes v's body moves> streamed_gbps=<those / t>
           share=<t / t of K2> copy_share=<copy bound / t> operand=<name>
    ABLATE rows=<R> kc=<KC> us=<t> share=<t / t of K2> operand=<name>

(``us`` on the card: device time by CUDA-graph replay).

Every wrapper counts its launches and has no fallback: a CPU tensor raises.
On ``--device cpu`` only the plain versions run (and the output says so,
with ``copy_share=n/a``).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses

import numpy as np
import torch

from dune_eigensolver_tpu_torch.bench.timing import bench_loop, copy_rate, replay_ms
from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
from dune_eigensolver_tpu_torch.sparse.formats import WARP_ROWS, ELLMatrix, ell_from_scipy
from dune_eigensolver_tpu_torch.utils import native
from dune_eigensolver_tpu_torch.utils.device import resolve

VARIANTS = ("full", "nogather", "nodyn", "nofma")
#: K2's (rows of X in flight, register chunk): ELL_ROWS, ELL_KC of csrc/ell_body.cuh
K2_SETTING = (8, 9)
#: the (rows, kc) settings of K2's body that csrc/experiments/ell_sweep_r{1,4,8}.cu build
SWEEP = tuple((rows, kc) for rows in (1, 4, 8) for kc in (6, 8, 9, 12))

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: (variant, rows, kc, data_t, index_t, index_bytes, warp_slots, n, k, ncols, x, y, m, stream)
_lib = native.Launchers({"ell_ablate_launch": [_I, _I, _I, _P, _P, _I, _P, _L, _I, _L, _P, _P,
                                               _I, _P]}, native.STUDIES)


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


def variant_bytes(A: ELLMatrix, m: int, variant: str, index_bytes: int = 4) -> int:
    """Least bytes the variant's FUNCTION must move, f32: X read and Y
    written once, and of the operator what the function depends on (all
    coefficients and indices, ``index_bytes`` each; coefficients alone;
    column 0 alone)."""
    n, n_cols = A.shape
    if variant == "full":
        return 4 * (A.nnz + m * (n + n_cols)) + index_bytes * A.nnz
    operator = {"nogather": A.nnz, "nodyn": A.nnz, "nofma": n}[variant]
    return 4 * (operator + m * (n + n_cols))


def variant_streamed_bytes(A: ELLMatrix, m: int, variant: str, index_bytes: int = 4) -> int:
    """Bytes the variant's BODY moves, f32: X read and Y written once, and
    of the operator every slot up to its warp's count (``A.warp_slots``)
    that the body loads: coefficient and index (``index_bytes``) for
    ``full``, ``nogather`` and ``nofma``, the coefficient alone for
    ``nodyn``. ``nofma`` reads ``data[i, 0]`` also where its warp's count
    is 0. ``variant_bytes`` is the least the function needs, the bound."""
    n, n_cols = A.shape
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")
    per_row = A.warp_slots.to(torch.int64).repeat_interleave(WARP_ROWS)[:n]
    slots = int(per_row.sum())
    coefficients = int(per_row.clamp(min=1).sum()) if variant == "nofma" else slots
    indices = 0 if variant == "nodyn" else slots
    return 4 * (coefficients + m * (n + n_cols)) + index_bytes * indices


def slot_loads(path=None) -> dict:
    """The global loads ptxas kept in each instantiation of K2's body at
    K2's setting in f32, ``{(variant, index bytes): count}``, from the SASS
    of the library at ``path`` (the built studies' library by default, whose
    sweep holds K2's own setting; ``utils/native.py::sass_global_loads``).
    The sweep's other settings and the f64 body are left out. Raises
    without cuobjdump."""
    import re

    pat = re.compile(r"ell_spmm_t_kernelILi(\d)ELi(\d+)ELi(\d+)ELi\d+E([fd])([si])E")
    loads = {}
    for name, count in native.sass_global_loads("ell_spmm_t_kernel", path,
                                                native.STUDIES).items():
        v, rows, kc, value, index = pat.search(name).groups()
        if (int(rows), int(kc)) == K2_SETTING and value == "f":
            loads[(VARIANTS[int(v)], 2 if index == "s" else 4)] = count  # V: ell_body.cuh
    return loads


#: the global loads of ``nofma``'s epilogue in the SASS (sm_90a): the warp
#: count, ``data[i, 0]`` and four of X (ptxas unrolls the loop over the
#: rows of X four times); the first ``nofma``, whose slot loop ptxas had
#: removed, had exactly these
NOFMA_EPILOGUE_LOADS = 6


def slot_load_faults(loads: dict) -> list:
    """What ``slot_loads``' counts break of the rule that the degraded
    bodies keep their slot loads (empty where it holds): at each index
    width ``nogather`` has exactly K2's (``full``'s) count, since it loads
    what K2 loads and only its addresses differ, and ``nofma`` has at least
    two loads beyond its epilogue's ``NOFMA_EPILOGUE_LOADS``, a coefficient
    and an index in its slot loop. A body whose slot loads ptxas removed
    has fewer: ``nogather`` without its index loads (and with its loads of
    one X address merged), ``nofma`` without its slot loop."""
    faults = []
    for index_bytes in (2, 4):
        got = {v: loads.get((v, index_bytes)) for v in VARIANTS}
        if None in got.values():
            faults.append(f"index {index_bytes} bytes: an instantiation is missing: {got}")
            continue
        if got["nogather"] != got["full"]:
            faults.append(f"index {index_bytes} bytes: nogather has {got['nogather']} global "
                          f"loads, K2 {got['full']}")
        if got["nofma"] < NOFMA_EPILOGUE_LOADS + 2:
            faults.append(f"index {index_bytes} bytes: nofma has {got['nofma']} global loads, "
                          f"fewer than its epilogue's {NOFMA_EPILOGUE_LOADS} and a slot's 2")
    return faults


def _check(what: str, A: ELLMatrix, Xt: torch.Tensor):
    n, n_cols = A.shape
    kg._check_cuda_operands(what, A.data, A.cols, Xt, n_cols)
    if Xt.dtype != torch.float32:
        raise TypeError(f"{what}: dtype {Xt.dtype}; the ablation kernels take float32")
    if A.k < 1 or n < 1:
        raise ValueError(f"{what}: the operand has no stored entries")


def _launch(variant: str, A: ELLMatrix, Xt: torch.Tensor, rows: int, kc: int) -> torch.Tensor:
    what = f"ablate_{variant}"
    if (rows, kc) not in SWEEP or (variant != "full" and (rows, kc) != K2_SETTING):
        raise ValueError(f"{what}: (rows, kc) = ({rows}, {kc}) is not built; the full body "
                         f"has {SWEEP}, the other variants K2's {K2_SETTING}")
    _check(what, A, Xt)
    n, n_cols = A.shape
    if variant == "nodyn" and A.k > n_cols:
        raise ValueError(f"{what}: k = {A.k} exceeds the {n_cols} columns")
    data_t, index_t = A.kernel_streams  # the index stream K2 reads
    return kg._launch("ell_ablate_launch", Xt, (Xt.shape[0], n), VARIANTS.index(variant), rows,
                      kc, data_t.data_ptr(), index_t.data_ptr(), index_t.element_size(),
                      A.warp_slots.data_ptr(), n, A.k, n_cols, lib=_lib)


def ablate_full(A: ELLMatrix, Xt: torch.Tensor, rows: int = K2_SETTING[0],
                kc: int = K2_SETTING[1]) -> torch.Tensor:
    """Yt = (A @ Xt.T).T by K2's body with ``rows`` rows of X in flight and
    ``kc`` pairs in registers, a setting of ``SWEEP``: K2's bits."""
    Y = _launch("full", A, Xt, rows, kc)
    ablate_full.launches += 1
    return Y


def ablate_nogather(A: ELLMatrix, Xt: torch.Tensor) -> torch.Tensor:
    """K2's body without its irregular X addresses (module docstring)."""
    Y = _launch("nogather", A, Xt, *K2_SETTING)
    ablate_nogather.launches += 1
    return Y


def ablate_nodyn(A: ELLMatrix, Xt: torch.Tensor) -> torch.Tensor:
    """K2's body without its index stream (module docstring)."""
    Y = _launch("nodyn", A, Xt, *K2_SETTING)
    ablate_nodyn.launches += 1
    return Y


def ablate_nofma(A: ELLMatrix, Xt: torch.Tensor) -> torch.Tensor:
    """K2's streams alone, without the inner loop (module docstring)."""
    Y = _launch("nofma", A, Xt, *K2_SETTING)
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
    returns ``{variant: max|err|}`` and raises on a mismatch. The full body
    at every setting of ``SWEEP`` must give K2's bits (on finite X: the
    slots K2 skips are padding); sums in another
    order than the plain version's stay within 1e-5 of the largest row's
    sum of |data| |X|; ``nofma`` is one add per entry, exact."""
    absA = dataclasses.replace(A, data=A.data.abs())
    current = kg.ell_spmm_t_cuda(A, Xt)
    for rows, kc in SWEEP:
        if not torch.equal(ablate_full(A, Xt, rows, kc), current):
            raise RuntimeError(f"ablate_full rows={rows} kc={kc}: differs from ell_spmm_t_cuda")
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


def ablate_table(device, Nel: int = 512, m: int = 8, graph_n: int = 2**20, operands=None,
                 copy_gbps=None):
    """Time the four variants and the (rows, kc) sweep of the full body on both operands (``operands``: those of
    ``ablate_operands``, for a caller that has built them); print the
    ``ABLATE`` lines and return the rows as dicts. On the card every
    variant is first held to its plain version (``check_variants``), whose
    time is taken too (``plain_us``, best chain of 5); ``us`` is the device
    time by CUDA-graph replay (these kernels take about as long as the
    host's launch through a wrapper), the reference's chain of launches
    beside it (``eager_us``, ``run_variant``), and each variant's copy
    bound is its least bytes (``full``: at the index width K2 reads) over
    ``copy_gbps`` (measured here when not given). Each variant's row also
    holds what its body moves (``streamed_bytes``, ``streamed_gbps``) and,
    for ``nofma`` on a square operand, the device time of its function as
    one PyTorch call, ``Xt + data_t[0]`` (``library_us``). On the CPU the plain
    versions are timed by ``run_variant``, with no copy share and no
    sweep."""
    device = resolve(device)
    cuda = device.type == "cuda"
    if cuda and copy_gbps is None:
        copy_gbps = copy_rate(device)
    rows = []
    for name, A in operands or ablate_operands(device, Nel, graph_n):
        n = A.shape[0]
        gen = torch.Generator(device=device).manual_seed(1)
        Xt = torch.randn((m, n), generator=gen, dtype=torch.float32, device=device)
        errs = check_variants(A, Xt) if cuda else {}
        index_bytes = A.kernel_streams[1].element_size()
        base = dict(operand=name, n=n, k=A.k, nnz=A.nnz, m=m, index_bytes=index_bytes)
        t_full = None
        for variant in VARIANTS:
            t_eager = run_variant(A, Xt, variant)
            t = replay_ms(lambda: VARIANT_KERNELS[variant](A, Xt)) / 1e3 if cuda else t_eager
            t_full = t if t_full is None else t_full
            t_plain = bench_loop(lambda x, A_: variant_reference(A_, x, variant), Xt, K=5,
                                 reps=2, op_args=(A,)) if cuda else t
            nbytes = variant_bytes(A, m, variant, index_bytes)
            streamed = variant_streamed_bytes(A, m, variant, index_bytes)
            row = dict(base, variant=variant, us=t * 1e6, plain_us=t_plain * 1e6, nbytes=nbytes,
                       gbps=nbytes / t / 1e9, streamed_bytes=streamed,
                       streamed_gbps=streamed / t / 1e9, share=t / t_full,
                       copy_share=nbytes / copy_gbps / 1e9 / t if cuda else None,
                       eager_us=t_eager * 1e6 if cuda else None, max_abs_err=errs.get(variant),
                       library_us=None)
            if cuda and variant == "nofma" and n == A.shape[1]:
                # the function as one PyTorch call (square: i' = i); it reads
                # column 0 alone, where the body streams every slot on purpose
                data0 = A.kernel_streams[0][0]
                row["library_us"] = replay_ms(lambda: Xt + data0) * 1e3
            copy_share = f"{row['copy_share']:.3f}" if cuda else "n/a"
            print(f"ABLATE variant={variant} us={row['us']:.1f} gbps={row['gbps']:.1f} "
                  f"streamed_bytes={streamed} streamed_gbps={row['streamed_gbps']:.1f} "
                  f"share={row['share']:.3f} copy_share={copy_share} operand={name}", flush=True)
            rows.append(row)
        if not cuda:
            continue
        for r, kc in SWEEP:
            t = replay_ms(lambda: ablate_full(A, Xt, r, kc)) / 1e3
            print(f"ABLATE rows={r} kc={kc} us={t * 1e6:.1f} share={t / t_full:.3f} "
                  f"operand={name}", flush=True)
            rows.append(dict(base, rows=r, kc=kc, us=t * 1e6, share=t / t_full))
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
