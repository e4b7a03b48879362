"""DIA SpMM staging variants on the card, beside the shipped kernel.

Counterpart of ``experiments/kernel_variants.py``, the experiment that
chose the TPU kernel's design. All variants compute the function of
``kernels/dia_spmm.py`` (one plain version serves them all,
``dia_spmm_t_reference``) on a ``DIAMatrix`` and a plain (m, n) f32 tensor:

  A  the shipped kernel, ``dia_spmm_t_cuda`` (csrc/dia_spmm.cu)
  C  ``spmm_c``: a (rows, T + 2H) window per tile, two slots
  B  ``spmm_b(nslots, depth)``: a ring of windows with ``depth`` copies in
     flight
  D  ``spmm_d``: a rolling cache of X tiles, each read from device memory
     once; ``alias=True`` writes Y over X

The kernels are in ``csrc/dia_variants.cu``. Each wrapper counts its
launches and has no fallback: a CPU tensor raises. ``main`` prints the copy
rate and every variant's time and GB/s under ``bytes_spmm_dia`` on the 2D
N=2048 m=8 operand scaled by 1/8, the plain version among them; on
``--device cpu`` only the plain version runs (and the output says so).

    python -m dune_eigensolver_tpu_torch.experiments.kernel_variants [T]
        [--device cpu] [--N N] [--m M] [--rows R]

A block has 227 KB of shared memory, so T is 2048 here (the TPU ran
32768), the m rows are split ``rows`` to a block, and the 3D operands,
whose +-N^2 offsets exceed any window these kernels can hold, are not
studied: as in the reference the operand is the 2D Laplacian.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from dune_eigensolver_tpu_torch.bench.models import bytes_spmm_dia
from dune_eigensolver_tpu_torch.bench.timing import bench_loop
from dune_eigensolver_tpu_torch.kernels.dia_spmm import (
    dia_spmm_t_cuda,
    dia_spmm_t_reference,
)
from dune_eigensolver_tpu_torch.sparse.formats import DIAMatrix
from dune_eigensolver_tpu_torch.utils.device import resolve

_MAX_DIAG = 16  # DV_MAX_DIAG in csrc/dia_variants.cu
_D_RING = 4  # DV_D_RING in csrc/dia_variants.cu: tiles of X a block of D holds


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _check(what: str, A: DIAMatrix, Xt: torch.Tensor, tile: int, rows: int):
    data = A.data
    if Xt.ndim != 2 or A.shape != (Xt.shape[1],) * 2 or data.shape != (len(A.offsets), Xt.shape[1]):
        raise ValueError(f"{what}: {A.shape} @ X^T with Xt {tuple(Xt.shape)}")
    if not (Xt.is_cuda and data.is_cuda) or Xt.device != data.device:
        raise ValueError(
            f"{what}: operands on {data.device} and {Xt.device}; both must be on one "
            "CUDA device (the plain version is dia_spmm_t_reference)"
        )
    if Xt.dtype != torch.float32 or data.dtype != torch.float32:
        raise TypeError(f"{what}: dtypes {data.dtype}/{Xt.dtype}; the kernel takes float32")
    if not (Xt.is_contiguous() and data.is_contiguous()):
        raise ValueError(f"{what}: operands must be contiguous")
    if not 1 <= len(A.offsets) <= _MAX_DIAG:
        raise ValueError(f"{what}: {len(A.offsets)} diagonals, at most {_MAX_DIAG}")
    if tile < 4 or tile % 4 or rows < 1:
        raise ValueError(f"{what}: tile {tile} must be a positive multiple of 4, rows {rows} >= 1")


def _blocks_per_group(what: str, variant: int, A: DIAMatrix, Xt: torch.Tensor, tile: int,
                      rows: int, slots: int, window: int) -> int:
    """How many blocks walk the tiles of one row group: as many as the card
    holds at once over all groups (the kernel's registers and its ``slots``
    windows of ``rows * window`` floats decide), at most one per tile.
    Raises ``ValueError`` when the windows exceed a block's shared memory."""
    from dune_eigensolver_tpu_torch.utils import native

    with torch.cuda.device(Xt.device):
        per_sm = native.load().dia_variant_blocks_per_sm(
            variant, len(A.offsets), slots, rows, window)
    if per_sm < 0:
        native.check(-per_sm, "dia_variant_blocks_per_sm")
    if per_sm == 0:
        raise ValueError(
            f"{what}: {slots} windows of {rows} x {window} floats are "
            f"{slots * rows * window * 4} bytes of shared memory, more than a block may "
            "have; take fewer rows or a smaller tile"
        )
    sms = torch.cuda.get_device_properties(Xt.device).multi_processor_count
    groups = -(-Xt.shape[0] // rows)
    ntiles = -(-Xt.shape[1] // tile)
    return min(ntiles, max(1, per_sm * sms // groups))


def _run(name: str, A: DIAMatrix, Xt: torch.Tensor, out: torch.Tensor, head, tail):
    """Launch ``name`` as (data, x, y, *head, n, m, ndiag, offsets, *tail,
    stream); raise on a CUDA error."""
    from dune_eigensolver_tpu_torch.utils import native

    lib = native.load()
    offs = (ctypes.c_int * len(A.offsets))(*A.offsets)
    m, n = Xt.shape
    with torch.cuda.device(Xt.device):
        err = getattr(lib, name)(
            A.data.data_ptr(), Xt.data_ptr(), out.data_ptr(), *head, n, m, len(A.offsets),
            offs, *tail, torch.cuda.current_stream().cuda_stream,
        )
    native.check(err, name)


def spmm_c(A: DIAMatrix, Xt: torch.Tensor, tile: int = 2048, rows: int = 2) -> torch.Tensor:
    """Yt = (A @ Xt.T).T by variant C (double-buffered (rows, T + 2H)
    windows). Raises if two windows exceed a block's shared memory."""
    _check("spmm_c", A, Xt, tile, rows)
    halo = max(abs(o) for o in A.offsets)
    H = _round_up(max(halo, 32), 32)
    nwalk = _blocks_per_group("spmm_c", 0, A, Xt, tile, rows, 2, tile + 2 * H)
    Y = torch.empty_like(Xt)
    _run("dia_c_launch", A, Xt, Y, (), (tile, H, rows, nwalk))
    spmm_c.launches += 1
    return Y


def spmm_b(A: DIAMatrix, Xt: torch.Tensor, nslots: int = 2, depth: int = 1,
           tile: int = 2048, rows: int = 2) -> torch.Tensor:
    """Yt = (A @ Xt.T).T by variant B: a ring of ``nslots`` windows of width
    T + span + 256 from fl_base, ``depth`` copies in flight."""
    _check("spmm_b", A, Xt, tile, rows)
    if not 1 <= depth < nslots <= 4:
        raise ValueError(f"spmm_b: need 1 <= depth < nslots <= 4, got ({nslots}, {depth})")
    first = min(A.offsets)
    fl_base = (first // 128) * 128
    W = _round_up(tile + max(A.offsets) - first + 256, 128)
    ntiles = -(-Xt.shape[1] // tile)
    tpc = -(-ntiles // _blocks_per_group("spmm_b", 1, A, Xt, tile, rows, nslots, W))
    Y = torch.empty_like(Xt)
    _run("dia_b_launch", A, Xt, Y, (), (tile, fl_base, W, rows, tpc, nslots, depth))
    spmm_b.launches += 1
    return Y


def spmm_d(A: DIAMatrix, Xt: torch.Tensor, alias: bool = False, tile: int = 2048,
           rows: int = 2) -> torch.Tensor:
    """Yt = (A @ Xt.T).T by variant D (rolling cache of four X tiles: three
    in use, one in flight ahead). With ``alias`` the result is
    written over ``Xt``, which is returned; the chunk-boundary tiles are
    saved to a side buffer first (see the source). Raises ``ValueError``
    when an offset exceeds the tile."""
    _check("spmm_d", A, Xt, tile, rows)
    halo = max(abs(o) for o in A.offsets)
    if halo > tile:
        raise ValueError(
            f"spmm_d: max|offset| {halo} exceeds the tile {tile}; the rolling cache "
            "holds one tile to each side"
        )
    m, n = Xt.shape
    ntiles = -(-n // tile)
    tpc = -(-ntiles // _blocks_per_group("spmm_d", 2, A, Xt, tile, rows, _D_RING, tile))
    if alias:
        nchunks = -(-ntiles // tpc)
        side = torch.empty((nchunks, 2, m, tile), dtype=Xt.dtype, device=Xt.device)
        Y, side_ptr = Xt, side.data_ptr()
    else:
        Y, side_ptr = torch.empty_like(Xt), None
    _run("dia_d_launch", A, Xt, Y, (side_ptr,), (tile, rows, tpc))
    spmm_d.launches += 1
    return Y


spmm_c.launches = 0
spmm_b.launches = 0
spmm_d.launches = 0

B_RINGS = ((2, 1), (3, 2), (4, 3))


def variant_steps(tile: int = 2048, rows: int = 2):
    """``[(label, step)]`` with ``step(Xt, A) -> Yt``: the shipped kernel and
    every variant, in the order ``main`` prints them."""
    steps = [
        ("A shipped", lambda x, A: dia_spmm_t_cuda(A, x)),
        ("D rolling", lambda x, A: spmm_d(A, x, tile=tile, rows=rows)),
        ("D in-place", lambda x, A: spmm_d(A, x, alias=True, tile=tile, rows=rows)),
    ]
    for s, q in B_RINGS:
        steps.append((f"B s={s} d={q}",
                      lambda x, A, s=s, q=q: spmm_b(A, x, s, q, tile=tile, rows=rows)))
    steps.append(("C r1-style", lambda x, A: spmm_c(A, x, tile=tile, rows=rows)))
    return steps


def variant_table(device, N: int = 2048, m: int = 8, tile: int = 2048, rows: int = 2,
                  mb: int = 256):
    """Yield ``(label, seconds, GB/s, max|err|)``: the copy rate first, then
    the plain version, then each variant on the 2D N x N Laplacian scaled by
    1/8 (bounded under chaining), GB/s under ``bytes_spmm_dia``. ``max|err|``
    is a kernel's largest deviation from the plain version over one
    application and the 2-chain (``None`` for the other rows); a kernel
    beyond 1e-5 of max|Y| raises. On the CPU no kernel runs."""
    from dune_eigensolver_tpu_torch.sparse import problems

    device = resolve(device)
    buf = torch.ones((mb * 1024 * 1024 // 4,), dtype=torch.float32, device=device)
    t = bench_loop(lambda v: v + 1.0, buf, K=30)
    yield "copy", t, 2 * buf.numel() * 4 / t / 1e9, None
    del buf
    A = problems.laplacian_dirichlet_2d(N, dtype=torch.float32, device=device)
    A = DIAMatrix(data=A.data / 8.0, offsets=A.offsets, shape=A.shape)
    n = A.shape[0]
    nbytes = bytes_spmm_dia(n, len(A.offsets), m, 4)
    gen = torch.Generator(device=device).manual_seed(0)
    Xt = torch.randn((m, n), generator=gen, dtype=torch.float32, device=device)
    t = bench_loop(lambda x, A_: dia_spmm_t_reference(A_, x), Xt, op_args=(A,))
    yield "plain", t, nbytes / t / 1e9, None
    if device.type == "cpu":
        return
    ref = dia_spmm_t_reference(A, Xt)
    ref2 = dia_spmm_t_reference(A, ref)
    for label, step in variant_steps(tile, rows):
        # one application against the plain version, then the 2-chain (the
        # in-place form must survive feeding on its own output)
        y1 = step(Xt.clone(), A)
        y2 = step(y1.clone(), A)
        err = max((y1 - ref).abs().max().item(), (y2 - ref2).abs().max().item())
        if not err <= 1e-5 * ref.abs().max().item():
            raise RuntimeError(f"{label}: max|err| {err:.3e} against the plain version")
        t = bench_loop(step, Xt, op_args=(A,))
        yield f"{label} T={tile}", t, nbytes / t / 1e9, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("T", nargs="?", type=int, default=2048, help="tile (columns per block step)")
    ap.add_argument("--device", default=None, help="cpu for the plain version; default the card")
    ap.add_argument("--N", type=int, default=2048)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--rows", type=int, default=2, help="rows of X per block")
    ap.add_argument("--mb", type=int, default=256, help="size of the copy buffer")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    else:
        print("device: cpu (plain version only; no rate here is the card's)", flush=True)
    for label, t, gbps, err in variant_table(device, args.N, args.m, args.T, args.rows, args.mb):
        checked = "" if err is None else f"  (max|err| {err:.1e})"
        print(f"{label}: {t * 1e6:.0f}us  {gbps:.1f} GB/s{checked}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
