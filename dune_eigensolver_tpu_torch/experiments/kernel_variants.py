"""DIA SpMM staging variants on the card, beside the shipped kernel.

Counterpart of ``experiments/kernel_variants.py``, the experiment that
chose the TPU kernel's design. All variants compute the function of
``kernels/dia_spmm.py`` (one plain version serves them all,
``dia_spmm_t_reference``) on a ``DIAMatrix`` and a plain (m, n) f32 tensor:

  A  the shipped kernel, ``dia_spmm_t_cuda`` (csrc/dia_spmm.cu)
  C  ``spmm_c``: a (rows, T + 2H) window per tile, two slots
  B  ``spmm_b(nslots, depth)``: a ring of windows with ``depth`` copies in
     flight, fed by Hopper's bulk copies where n % 4 == 0 (``route``
     "bulk"), else by its first version's cp.async (``route`` "first"); the
     geometry is ``ring_geometry``
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
studied: as in the reference the operand is the 2D Laplacian. B's bulk
body takes larger tiles: ``variant_table`` sweeps ``RING_TILES`` x
``RING_ROWS`` x ``B_RINGS`` wherever the ring fits and prints, for each
setting, W / T, the bytes of X staged per byte consumed.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses

import torch

from dune_eigensolver_tpu_torch.bench.models import bytes_spmm_dia
from dune_eigensolver_tpu_torch.bench.timing import bench_loop, copy_rate, in_turns, replay_ms
from dune_eigensolver_tpu_torch.kernels.dia_spmm import (
    dia_spmm_t_cuda,
    dia_spmm_t_reference,
)
from dune_eigensolver_tpu_torch.sparse.formats import DIAMatrix
from dune_eigensolver_tpu_torch.utils.device import resolve

_MAX_DIAG = 16  # DV_MAX_DIAG in csrc/dia_variants.cu
_D_RING = 4  # DV_D_RING in csrc/dia_variants.cu: tiles of X a block of D holds
_MAX_SLOTS = 4  # DV_MAX_SLOTS in csrc/dia_variants.cu
#: shared memory one block may have on sm_90 (227 KB), static and dynamic
SMEM_BYTES = 232_448
#: shared memory of one SM (228 KB) and what the card keeps back a block
_SM_SMEM_BYTES, _BLOCK_RESERVE = 233_472, 1024
#: the bulk body's static shared memory: one 8-byte mbarrier a slot
_BAR_BYTES = 8 * _MAX_SLOTS

B_RINGS = ((2, 1), (3, 2), (4, 3))
RING_TILES = (2048, 4096, 8192, 16384)
RING_ROWS = (1, 2)


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


@dataclasses.dataclass(frozen=True)
class Ring:
    """The geometry of variant B for one operand and setting (``ring_geometry``)."""

    tile: int
    rows: int
    nslots: int
    depth: int
    fl_base: int  # window start relative to its tile, floor(min offset / 128) * 128
    window: int  # W = round_up(T + span + 256, 128)
    route: str  # "bulk": bulk copies (n % 4 == 0); "first": cp.async
    slot_bytes: int  # one window of ``rows`` rows
    smem_bytes: int  # what a block holds: nslots windows (and the barriers)

    @property
    def fits(self) -> bool:
        return self.smem_bytes <= SMEM_BYTES

    @property
    def threads(self) -> int:
        """Threads a block: the bulk body's are all compute threads, so where
        its shared memory leaves one block an SM it takes 512, else 256 (the
        first version stages with every thread and keeps 256)."""
        two = 2 * (self.smem_bytes + _BLOCK_RESERVE) <= _SM_SMEM_BYTES
        return 512 if self.route == "bulk" and not two else 256

    @property
    def staged_per_consumed(self) -> float:
        """Bytes of X a window stages per byte of X its tile consumes."""
        return self.window / self.tile

    def tiles_per_chunk(self, n: int, walkers: int) -> int:
        """Consecutive tiles a persistent block walks when ``walkers`` blocks
        share the tiles of one row group (at most one block a tile)."""
        ntiles = -(-n // self.tile)
        return -(-ntiles // max(1, min(walkers, ntiles)))


def ring_geometry(offsets, n: int, tile: int = 2048, rows: int = 2, nslots: int = 2,
                  depth: int = 1, check: bool = True) -> Ring:
    """Variant B's geometry, as the reference's ``spmm_b`` computes it
    (fl_base and W), with the route the launcher takes for n and the shared
    memory the ring needs. Raises ``ValueError`` for a ring outside
    ``1 <= depth < nslots <= 4`` and, with ``check``, for one whose
    ``nslots`` windows exceed a block's shared memory (``Ring.fits``). The
    route is a rule on the shape: bulk copies need 16-byte sizes and
    addresses, so n % 4 == 0."""
    if not 1 <= depth < nslots <= _MAX_SLOTS:
        raise ValueError(f"spmm_b: need 1 <= depth < nslots <= {_MAX_SLOTS}, got "
                         f"({nslots}, {depth})")
    if tile < 4 or tile % 4 or rows < 1:
        raise ValueError(f"spmm_b: tile {tile} must be a positive multiple of 4, rows {rows} >= 1")
    first = min(offsets)
    fl_base = (first // 128) * 128
    W = _round_up(tile + max(offsets) - first + 256, 128)
    route = "bulk" if n % 4 == 0 else "first"
    slot_bytes = rows * W * 4
    g = Ring(tile, rows, nslots, depth, fl_base, W, route, slot_bytes,
             nslots * slot_bytes + (_BAR_BYTES if route == "bulk" else 0))
    if check and not g.fits:
        raise ValueError(
            f"spmm_b: {nslots} windows of {rows} x {W} floats are {g.smem_bytes} bytes of "
            f"shared memory, more than a block may have ({SMEM_BYTES}); take fewer rows or "
            "a smaller tile")
    return g


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


def _ring(what: str, A: DIAMatrix, Xt: torch.Tensor, nslots: int, depth: int, tile: int,
          rows: int, route: str) -> torch.Tensor:
    _check(what, A, Xt, tile, rows)
    n = Xt.shape[1]
    g = ring_geometry(A.offsets, n, tile, rows, nslots, depth)
    threads = g.threads if route == "bulk" else 256
    variant = 3 if route == "first" else 4 if threads == 512 else 1
    walkers = _blocks_per_group(what, variant, A, Xt, tile, rows, nslots, g.window)
    Y = torch.empty_like(Xt)
    _run("dia_b_launch", A, Xt, Y, (), (tile, g.fl_base, g.window, rows,
                                        g.tiles_per_chunk(n, walkers), nslots, depth,
                                        int(route == "bulk"), threads))
    return Y


def spmm_b(A: DIAMatrix, Xt: torch.Tensor, nslots: int = 2, depth: int = 1,
           tile: int = 2048, rows: int = 2) -> torch.Tensor:
    """Yt = (A @ Xt.T).T by variant B: a ring of ``nslots`` windows of width
    T + span + 256 from fl_base, ``depth`` in flight; bulk copies where
    n % 4 == 0, else the first version's cp.async (``spmm_b.taken`` counts
    the routes). Raises if the ring exceeds a block's shared memory."""
    route = "bulk" if Xt.shape[-1] % 4 == 0 else "first"
    Y = _ring("spmm_b", A, Xt, nslots, depth, tile, rows, route)
    spmm_b.launches += 1
    spmm_b.taken[route] += 1
    return Y


def spmm_b_first(A: DIAMatrix, Xt: torch.Tensor, nslots: int = 2, depth: int = 1,
                 tile: int = 2048, rows: int = 2) -> torch.Tensor:
    """Variant B by its first version at any n (every thread stages with
    cp.async): the body ``spmm_b`` takes off the 16-byte grid, called here
    on the grid too so that the two are timed in turns."""
    Y = _ring("spmm_b_first", A, Xt, nslots, depth, tile, rows, "first")
    spmm_b_first.launches += 1
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
spmm_b.taken = collections.Counter()
spmm_b_first.launches = 0
spmm_d.launches = 0

#: E2's first version, timed in turns with its bulk body
FIRST_VERSIONS = {"spmm_b": spmm_b_first}


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


def ring_settings(offsets, n: int):
    """Every ``(nslots, depth, tile, rows)`` of the bulk body's sweep
    (``B_RINGS`` x ``RING_TILES`` x ``RING_ROWS``) with its ``Ring``, in
    that order, those that do not fit a block's shared memory included."""
    for s, q in B_RINGS:
        for tile in RING_TILES:
            for rows in RING_ROWS:
                yield (s, q, tile, rows), ring_geometry(offsets, n, tile, rows, s, q, check=False)


def variant_table(device, N: int = 2048, m: int = 8, tile: int = 2048, rows: int = 2,
                  mb: int = 256):
    """Yield one dict a row (``label``, ``seconds``, ``gbps``,
    ``max_abs_err``): the copy rate first, then the plain version, then
    each variant at ``tile`` and ``rows`` on the 2D N x N Laplacian scaled
    by 1/8 (bounded under chaining), GB/s under ``bytes_spmm_dia``; then
    variant B over its sweep (``ring_settings``: ``sweep`` rows, with
    ``seconds`` None where the ring does not fit), then for each ring its
    fastest setting again (``best`` rows, not timed again). B's rows are
    timed by CUDA-graph replay (the others by chains of launches) and carry
    their ``route``, ``threads``, ``tile``, ``rows`` and
    ``staged_per_consumed`` (W / T); at ``tile`` they are timed in turns
    with B's first version (``first_seconds``, ``spmm_b_first``), itself
    checked like the others.
    ``max_abs_err`` is a kernel's largest deviation from the plain version
    over one application and the 2-chain (``None`` for the other rows); a
    kernel beyond 1e-5 of max|Y| raises. On the CPU no kernel runs."""
    from dune_eigensolver_tpu_torch.sparse import problems

    device = resolve(device)
    gbps = copy_rate(device, mb)
    yield dict(label="copy", seconds=2 * mb * 1024 * 1024 / gbps / 1e9, gbps=gbps,
               max_abs_err=None)
    A = problems.laplacian_dirichlet_2d(N, dtype=torch.float32, device=device)
    A = DIAMatrix(data=A.data / 8.0, offsets=A.offsets, shape=A.shape)
    n = A.shape[0]
    nbytes = bytes_spmm_dia(n, len(A.offsets), m, 4)
    gen = torch.Generator(device=device).manual_seed(0)
    Xt = torch.randn((m, n), generator=gen, dtype=torch.float32, device=device)
    t = bench_loop(lambda x, A_: dia_spmm_t_reference(A_, x), Xt, op_args=(A,))
    yield dict(label="plain", seconds=t, gbps=nbytes / t / 1e9, max_abs_err=None)
    if device.type == "cpu":
        return
    ref = dia_spmm_t_reference(A, Xt)
    ref2 = dia_spmm_t_reference(A, ref)

    def check(label, step):
        # one application against the plain version, then the 2-chain (the
        # in-place form must survive feeding on its own output)
        y1 = step(Xt.clone(), A)
        y2 = step(y1.clone(), A)
        err = max((y1 - ref).abs().max().item(), (y2 - ref2).abs().max().item())
        if not err <= 1e-5 * ref.abs().max().item():
            raise RuntimeError(f"{label}: max|err| {err:.3e} against the plain version")
        return err

    def checked(label, step):
        err = check(label, step)
        t = bench_loop(step, Xt, op_args=(A,))
        return dict(label=label, seconds=t, gbps=nbytes / t / 1e9, max_abs_err=err)

    def replayed(step):
        return replay_ms(lambda: step(Xt, A)) / 1e3

    rings = {f"B s={s} d={q}": (s, q) for s, q in B_RINGS}
    for label, step in variant_steps(tile, rows):
        if label not in rings:
            yield checked(f"{label} T={tile}", step)
            continue
        # B by replay, in turns with its first version at the same setting
        s, q = rings[label]
        first = lambda x, A_, s=s, q=q: spmm_b_first(A_, x, s, q, tile=tile, rows=rows)  # noqa: E731
        err, first_err = check(f"{label} T={tile}", step), check(f"{label} first", first)
        t, t_first = in_turns([step, first], replayed)
        g = ring_geometry(A.offsets, n, tile, rows, s, q)
        yield dict(label=f"{label} T={tile}", seconds=t, gbps=nbytes / t / 1e9, max_abs_err=err,
                   route=g.route, threads=g.threads, tile=tile, rows=rows,
                   staged_per_consumed=g.staged_per_consumed, first_seconds=t_first,
                   first_max_abs_err=first_err)
    best = {}
    for (s, q, T, r), g in ring_settings(A.offsets, n):
        label = f"B s={s} d={q} T={T} rows={r}"
        more = dict(sweep=True, nslots=s, depth=q, tile=T, rows=r, route=g.route,
                    threads=g.threads, staged_per_consumed=g.staged_per_consumed,
                    smem_bytes=g.smem_bytes)
        if not g.fits:
            yield dict(label=label, seconds=None, gbps=None, max_abs_err=None, **more)
            continue
        step = lambda x, A_, s=s, q=q, T=T, r=r: spmm_b(A_, x, s, q, tile=T, rows=r)  # noqa: E731
        err, t = check(label, step), replayed(step)
        row = dict(label=label, seconds=t, gbps=nbytes / t / 1e9, max_abs_err=err, **more)
        if (s, q) not in best or row["seconds"] < best[(s, q)]["seconds"]:
            best[(s, q)] = row
        yield row
    for (s, q), row in best.items():
        yield dict(row, label=f"B s={s} d={q} best", sweep=False, best=True)


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
    for row in variant_table(device, args.N, args.m, args.T, args.rows, args.mb):
        if row["seconds"] is None:
            print(f"{row['label']}: does not fit ({row['smem_bytes']} bytes of shared memory; "
                  f"W/T {row['staged_per_consumed']:.2f})", flush=True)
            continue
        err = row["max_abs_err"]
        checked = "" if err is None else f"  (max|err| {err:.1e})"
        ring = (f"  [{row['route']}, {row['threads']} threads, W/T "
                f"{row['staged_per_consumed']:.2f}]" if "route" in row else "")
        if "first_seconds" in row:
            ring += f"  first version {row['first_seconds'] * 1e6:.0f}us in turns"
        print(f"{row['label']}: {row['seconds'] * 1e6:.0f}us  {row['gbps']:.1f} GB/s{checked}{ring}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
