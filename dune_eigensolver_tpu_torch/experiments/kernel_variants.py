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

C, D and B's bulk route run one compute body, K1's moved onto the staged
window (csrc/experiments/dia_body.cuh): the tile's coefficients staged with it, 4 or 1
columns a thread (``stage_width``), K1's bits. C and D stage with bulk
copies from a producer warp where n % 4 == 0 (``route`` "bulk"), else with
the compute threads' cp.async (``route`` "async"); their geometry is
``stage_geometry``. B's first version, the route off the 16-byte grid,
runs the port's first compute body (coefficients from device memory per row
group, one column a thread).

The kernels are in ``csrc/experiments/dia_variants.cu``, ``dia_stage_c.cu``
and ``dia_stage_d.cu``, in the studies' library. Each wrapper counts its
launches and has no fallback: a CPU tensor raises. ``main`` prints the copy rate and every variant's
time and GB/s under ``bytes_spmm_dia`` on the 2D N=2048 m=8 operand scaled
by 1/8, the plain version among them; on ``--device cpu`` only the plain
version runs (and the output says so).

    python -m dune_eigensolver_tpu_torch.experiments.kernel_variants [T]
        [--device cpu] [--N N] [--m M] [--rows R]

A block has 227 KB of shared memory, so T is 2048 here (the TPU ran
32768), the m rows are split ``rows`` to a block, and the 3D operands,
whose +-N^2 offsets exceed any window these kernels can hold, are not
studied: as in the reference the operand is the 2D Laplacian.
``variant_table`` sweeps B over ``RING_TILES`` x ``RING_ROWS`` x
``B_RINGS``, C over ``C_TILES`` x ``STAGE_ROWS`` and D over ``D_TILES`` x
``STAGE_ROWS`` wherever the staging fits, and prints for each setting the
bytes of X staged per byte consumed.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses

import torch

from dune_eigensolver_tpu_torch.bench.models import bytes_spmm_dia
from dune_eigensolver_tpu_torch.bench.timing import bench_loop, copy_rate, replay_ms
from dune_eigensolver_tpu_torch.kernels.dia_spmm import (
    dia_spmm_t_cuda,
    dia_spmm_t_reference,
)
from dune_eigensolver_tpu_torch.sparse.formats import DIAMatrix
from dune_eigensolver_tpu_torch.utils import native
from dune_eigensolver_tpu_torch.utils.device import resolve

_MAX_DIAG = 16  # DV_MAX_DIAG in csrc/experiments/dia_body.cuh
_D_RING = 4  # DV_D_RING there: tiles of X a block of D holds
_MAX_SLOTS = 4  # DV_MAX_SLOTS there
#: shared memory one block may have on sm_90 (227 KB), static and dynamic
SMEM_BYTES = 232_448
#: shared memory of one SM (228 KB) and what the card keeps back a block
_SM_SMEM_BYTES, _BLOCK_RESERVE = 233_472, 1024
#: the bulk bodies' static shared memory, their 8-byte mbarriers: B a full
#: barrier a ring slot and two for its coefficient slots, C a full and an
#: empty one a slot, D the same for its ring and its coefficient slots
_BAR_BYTES = {"b": 8 * (_MAX_SLOTS + 2), "c": 8 * 4, "d": 8 * (2 * _D_RING + 4)}
#: the launchers' route flags
_ROUTES = {"bulk": 1, "async": 2}

B_RINGS = ((2, 1), (3, 2), (4, 3))
RING_TILES = (2048, 4096, 8192, 16384)
RING_ROWS = (1, 2)
#: the sweep of C and D (``stage_settings``); D needs T >= max|off|, 2048
#: on the table's operand
C_TILES = (1024, 2048, 4096)
D_TILES = (2048, 4096)
STAGE_ROWS = (1, 2, 4, 8)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_OFFS = ctypes.POINTER(_I)
_lib = native.Launchers({
    # (data, x, y, [side,] n, m, ndiag, offsets, ...): C's T, H, rows, nwalk, route, width,
    # threads, stream; B's T, lo, W, rows, tpc, nslots, depth, body, threads, width,
    # stream; D's T, rows, tpc, route, width, threads, stream
    "dia_c_stage_launch": [_P, _P, _P, _L, _I, _I, _OFFS, _I, _I, _I, _I, _I, _I, _I, _P],
    "dia_b_launch": [_P, _P, _P, _L, _I, _I, _OFFS, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "dia_d_stage_launch": [_P, _P, _P, _P, _L, _I, _I, _OFFS, _I, _I, _I, _I, _I, _I, _P],
    # -> blocks per SM, 0, or -error: B's first version's (ndiag, slots, rows, window);
    # a staged body's (variant, route, width, ndiag, threads, bytes)
    "dia_variant_blocks_per_sm": [_I, _I, _I, _I],
    "dia_stage_blocks_per_sm": [_I, _I, _I, _I, _I, _L],
}, native.STUDIES)


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


def stage_width(offsets, n: int, tile: int) -> int:
    """Columns a thread of the staged body owns: 4 or 1.

    4 needs what K1's 4-wide kernel needs (``kernels/dia_spmm.py::
    dia_vector_width``): a stencil of 5 or 7 diagonals whose middle three
    are (-1, 0, 1) (the +-1 neighbours come by warp shuffle) and whose
    others are multiples of 4 (one aligned 16-byte shared-memory load each),
    and n % 4 == 0; and a tile that is a multiple of 128, so that a warp's 32
    vectors lie in one row of the tile. Anything else takes 1, which has no
    condition. Both give K1's bits."""
    offsets = tuple(int(o) for o in offsets)
    c = len(offsets) // 2
    if (len(offsets) in (5, 7) and offsets[c - 1 : c + 2] == (-1, 0, 1) and n % 4 == 0
            and tile % 128 == 0 and all(o % 4 == 0 for o in offsets[: c - 1] + offsets[c + 2 :])):
        return 4
    return 1


def _threads(route: str, smem_bytes: int) -> int:
    """Compute threads a block of a bulk body: where its shared memory leaves
    one block an SM it takes 512, else 256 (the cp.async bodies, whose
    threads stage, keep 256)."""
    two = 2 * (smem_bytes + _BLOCK_RESERVE) <= _SM_SMEM_BYTES
    return 512 if route == "bulk" and not two else 256


@dataclasses.dataclass(frozen=True)
class Ring:
    """The geometry of variant B for one operand and setting (``ring_geometry``)."""

    tile: int
    rows: int
    nslots: int
    depth: int
    fl_base: int  # window start relative to its tile, floor(min offset / 128) * 128
    window: int  # W = round_up(T + span + 256, 128)
    route: str  # "bulk": bulk copies (n % 4 == 0); "first": its first version's cp.async
    slot_bytes: int  # one window of ``rows`` rows
    smem_bytes: int  # what a block holds: nslots windows (and the bulk body's coefficients)
    width: int = 1  # columns a thread of the bulk body (``stage_width``); the first version 1

    @property
    def fits(self) -> bool:
        return self.smem_bytes <= SMEM_BYTES

    @property
    def threads(self) -> int:
        """Threads a block: the bulk body's are all compute threads, so where
        its shared memory leaves one block an SM it takes 512, else 256 (the
        first version stages with every thread and keeps 256)."""
        return _threads(self.route, self.smem_bytes)

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
    memory the ring needs: the bulk body stages two (ndiag, T) coefficient
    tiles beside the ring. Raises ``ValueError`` for a ring outside
    ``1 <= depth < nslots <= 4`` and, with ``check``, for one whose shared
    memory exceeds a block's (``Ring.fits``). The route is a rule on the
    shape: bulk copies need 16-byte sizes and addresses, so n % 4 == 0
    takes them, any other n the first version's cp.async."""
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
    smem = nslots * slot_bytes
    width = 1
    if route == "bulk":
        smem += 2 * len(offsets) * tile * 4 + _BAR_BYTES["b"]
        width = stage_width(offsets, n, tile)
    g = Ring(tile, rows, nslots, depth, fl_base, W, route, slot_bytes, smem, width)
    if check and not g.fits:
        raise ValueError(
            f"spmm_b: {nslots} windows of {rows} x {W} floats and the coefficients are "
            f"{g.smem_bytes} bytes of shared memory, more than a block may have ({SMEM_BYTES}); "
            "take fewer rows or a smaller tile")
    return g


@dataclasses.dataclass(frozen=True)
class Stage:
    """The geometry of the staged C or D for one operand and setting
    (``stage_geometry``)."""

    variant: str  # "c" or "d"
    tile: int
    rows: int
    halo: int  # C: H, max|off| rounded up to 32 (the window's halo); D: max|off|
    window: int  # floats a row of one X slot: C T + 2H, D T
    slots: int  # X slots: C 2, D its ring of 4
    route: str  # "bulk": bulk copies (n % 4 == 0); "async": cp.async
    width: int  # columns a thread (``stage_width``)
    dynamic_bytes: int  # the X slots and two (ndiag, T) coefficient tiles
    smem_bytes: int  # and the bulk body's mbarriers

    @property
    def fits(self) -> bool:
        return self.smem_bytes <= SMEM_BYTES

    @property
    def threads(self) -> int:
        """Compute threads a block (the bulk body adds a producer warp)."""
        return _threads(self.route, self.smem_bytes)

    def tiles_per_chunk(self, n: int, walkers: int) -> int:
        """Consecutive tiles a persistent block walks when ``walkers`` blocks
        share the tiles of one row group (at most one block a tile)."""
        ntiles = -(-n // self.tile)
        return -(-ntiles // max(1, min(walkers, ntiles)))

    def staged_per_consumed(self, tiles_per_chunk: int = 1) -> float:
        """Bytes of X staged per byte of X a tile consumes: C (T + 2H) / T,
        every tile re-reading its halos; D 1 + 2 / tiles_per_chunk, the two
        warm-up tiles of a chunk."""
        if self.variant == "c":
            return self.window / self.tile
        return 1 + 2 / tiles_per_chunk


def stage_route(n: int) -> str:
    """The staging route of C and D: bulk copies need 16-byte sizes and
    addresses, so n % 4 == 0 takes them; any other n the cp.async body."""
    return "bulk" if n % 4 == 0 else "async"


def stage_geometry(variant: str, offsets, n: int, tile: int = 2048, rows: int = 2,
                   check: bool = True) -> Stage:
    """The staged C's (``variant`` "c") or D's ("d") geometry on an operand
    of these offsets and n at this tile and rows: window, route, width and
    shared memory. Raises ``ValueError`` for a tile off 4, for D when an
    offset exceeds the tile, and, with ``check``, for a setting whose shared
    memory exceeds a block's (``Stage.fits``)."""
    what = f"spmm_{variant}"
    if variant not in ("c", "d"):
        raise ValueError(f"stage_geometry: variant {variant!r}, not 'c' or 'd'")
    if tile < 4 or tile % 4 or rows < 1:
        raise ValueError(f"{what}: tile {tile} must be a positive multiple of 4, rows {rows} >= 1")
    halo = max(abs(o) for o in offsets)
    if variant == "c":
        H = _round_up(max(halo, 32), 32)
        window, slots = tile + 2 * H, 2
    else:
        if halo > tile:
            raise ValueError(f"{what}: max|offset| {halo} exceeds the tile {tile}; the rolling "
                             "cache holds one tile to each side")
        H, window, slots = halo, tile, _D_RING
    route = stage_route(n)
    width = stage_width(offsets, n, tile) if route == "bulk" else 1
    dynamic = (slots * rows * window + 2 * len(offsets) * tile) * 4
    g = Stage(variant, tile, rows, H, window, slots, route, width, dynamic,
              dynamic + (_BAR_BYTES[variant] if route == "bulk" else 0))
    if check and not g.fits:
        raise ValueError(
            f"{what}: {slots} windows of {rows} x {window} floats and two coefficient tiles are "
            f"{g.smem_bytes} bytes of shared memory, more than a block may have ({SMEM_BYTES}); "
            "take fewer rows or a smaller tile")
    return g


def stage_settings(variant: str, offsets, n: int):
    """Every ``(tile, rows)`` of C's (``C_TILES`` x ``STAGE_ROWS``) or D's
    (``D_TILES`` x ``STAGE_ROWS``) sweep with its ``Stage``, in that order,
    those that do not fit a block's shared memory included."""
    for tile in C_TILES if variant == "c" else D_TILES:
        for rows in STAGE_ROWS:
            yield (tile, rows), stage_geometry(variant, offsets, n, tile, rows, check=False)


def _sms(Xt: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(Xt.device).multi_processor_count


def _walkers(per_sm: int, what: str, nbytes: int, Xt: torch.Tensor, tile: int, rows: int) -> int:
    """How many blocks walk the tiles of one row group: as many as the card
    holds at once over all groups, at most one per tile."""
    if per_sm < 0:
        native.check(-per_sm, "blocks_per_sm")
    if per_sm == 0:
        raise ValueError(
            f"{what}: {nbytes} bytes of shared memory a block, more than a block may have; "
            "take fewer rows or a smaller tile")
    groups = -(-Xt.shape[0] // rows)
    ntiles = -(-Xt.shape[1] // tile)
    return min(ntiles, max(1, per_sm * _sms(Xt) // groups))


def _first_walkers(what: str, A: DIAMatrix, Xt: torch.Tensor, tile: int, rows: int,
                   slots: int, window: int) -> int:
    """``_walkers`` for B's first version, whose registers and ``slots``
    windows of ``rows * window`` floats decide how many blocks an SM holds.
    Raises ``ValueError`` when the windows exceed a block's shared
    memory."""
    with torch.cuda.device(Xt.device):
        per_sm = _lib().dia_variant_blocks_per_sm(len(A.offsets), slots, rows, window)
    return _walkers(per_sm, what, slots * rows * window * 4, Xt, tile, rows)


def _stage_blocks(what: str, variant: int, route: str, width: int, threads: int, nbytes: int,
                  A: DIAMatrix, Xt: torch.Tensor, tile: int, rows: int) -> int:
    """``_walkers`` for a staged body (variant 0 C, 1 B, 2 D) whose block
    takes ``nbytes`` of dynamic shared memory."""
    with torch.cuda.device(Xt.device):
        per_sm = _lib().dia_stage_blocks_per_sm(
            variant, _ROUTES[route], width, len(A.offsets), threads, nbytes)
    return _walkers(per_sm, what, nbytes, Xt, tile, rows)


def _run(name: str, A: DIAMatrix, Xt: torch.Tensor, out: torch.Tensor, head, tail):
    """Launch ``name`` as (data, x, y, *head, n, m, ndiag, offsets, *tail,
    stream); raise on a CUDA error."""
    lib = _lib()
    offs = (ctypes.c_int * len(A.offsets))(*A.offsets)
    m, n = Xt.shape
    with torch.cuda.device(Xt.device):
        err = getattr(lib, name)(
            A.data.data_ptr(), Xt.data_ptr(), out.data_ptr(), *head, n, m, len(A.offsets),
            offs, *tail, torch.cuda.current_stream().cuda_stream,
        )
    native.check(err, name)


def spmm_c(A: DIAMatrix, Xt: torch.Tensor, tile: int = 2048, rows: int = 2) -> torch.Tensor:
    """Yt = (A @ Xt.T).T by variant C on the staged body: double-buffered
    (rows, T + 2H) windows with their coefficient tiles, by bulk copies
    where n % 4 == 0, else by cp.async (``stage_geometry``;
    ``spmm_c.taken`` counts the launches by (route, width)). Raises if the
    two slots exceed a block's shared memory."""
    _check("spmm_c", A, Xt, tile, rows)
    g = stage_geometry("c", A.offsets, Xt.shape[1], tile, rows)
    nwalk = _stage_blocks("spmm_c", 0, g.route, g.width, g.threads, g.dynamic_bytes, A, Xt,
                          tile, rows)
    Y = torch.empty_like(Xt)
    _run("dia_c_stage_launch", A, Xt, Y, (),
         (tile, g.halo, rows, nwalk, _ROUTES[g.route], g.width, g.threads))
    spmm_c.launches += 1
    spmm_c.taken[g.route, g.width] += 1
    return Y


def spmm_b(A: DIAMatrix, Xt: torch.Tensor, nslots: int = 2, depth: int = 1,
           tile: int = 2048, rows: int = 2) -> torch.Tensor:
    """Yt = (A @ Xt.T).T by variant B: a ring of ``nslots`` windows of width
    T + span + 256 from fl_base, ``depth`` in flight; bulk copies and the
    staged body where n % 4 == 0, else the first version's cp.async
    (``spmm_b.taken`` counts the routes, ``spmm_b.width`` holds the last
    launch's columns a thread). Raises if the ring exceeds a block's shared
    memory."""
    _check("spmm_b", A, Xt, tile, rows)
    n = Xt.shape[1]
    g = ring_geometry(A.offsets, n, tile, rows, nslots, depth)
    if g.route == "first":
        walkers = _first_walkers("spmm_b", A, Xt, tile, rows, nslots, g.window)
    else:
        walkers = _stage_blocks("spmm_b", 1, g.route, g.width, g.threads,
                                g.smem_bytes - _BAR_BYTES["b"], A, Xt, tile, rows)
    Y = torch.empty_like(Xt)
    _run("dia_b_launch", A, Xt, Y, (), (tile, g.fl_base, g.window, rows,
                                        g.tiles_per_chunk(n, walkers), nslots, depth,
                                        int(g.route == "bulk"), g.threads, g.width))
    spmm_b.launches += 1
    spmm_b.taken[g.route] += 1
    spmm_b.width = g.width
    return Y


def _side(Xt: torch.Tensor, tile: int, tpc: int) -> torch.Tensor:
    """The in-place D's buffer of every chunk's two boundary tiles."""
    m, n = Xt.shape
    nchunks = -(-(-(-n // tile)) // tpc)
    return torch.empty((nchunks, 2, m, tile), dtype=Xt.dtype, device=Xt.device)


def spmm_d(A: DIAMatrix, Xt: torch.Tensor, alias: bool = False, tile: int = 2048,
           rows: int = 2) -> torch.Tensor:
    """Yt = (A @ Xt.T).T by variant D on the staged body (rolling cache of
    four X tiles: three in use, one in flight ahead; the coefficient tiles
    two deep beside it), by bulk copies where n % 4 == 0, else by cp.async
    (``stage_geometry``; ``spmm_d.taken`` counts the launches by (route,
    width)). With ``alias`` the result is written over ``Xt``, which is
    returned; the chunk-boundary tiles are saved to a side buffer first.
    Raises ``ValueError`` when an offset exceeds the tile or the staging
    exceeds a block's shared memory."""
    _check("spmm_d", A, Xt, tile, rows)
    n = Xt.shape[1]
    g = stage_geometry("d", A.offsets, n, tile, rows)
    walkers = _stage_blocks("spmm_d", 2, g.route, g.width, g.threads, g.dynamic_bytes, A, Xt,
                            tile, rows)
    tpc = g.tiles_per_chunk(n, walkers)
    Y, side = (Xt, _side(Xt, tile, tpc)) if alias else (torch.empty_like(Xt), None)
    _run("dia_d_stage_launch", A, Xt, Y, (None if side is None else side.data_ptr(),),
         (tile, rows, tpc, _ROUTES[g.route], g.width, g.threads))
    spmm_d.launches += 1
    spmm_d.taken[g.route, g.width] += 1
    spmm_d.tiles_per_chunk = tpc
    return Y


spmm_c.launches = 0
spmm_c.taken = collections.Counter()
spmm_b.launches = 0
spmm_b.taken = collections.Counter()
spmm_b.width = None  # of the last launch
spmm_d.launches = 0
spmm_d.taken = collections.Counter()
spmm_d.tiles_per_chunk = None  # of the last launch


def variant_steps(tile: int = 2048, rows: int = 2, ring_rows=None):
    """``[(label, step)]`` with ``step(Xt, A) -> Yt``: the shipped kernel
    and every variant, in the order ``main`` prints them. B's ring (s, q)
    takes ``ring_rows[(s, q)]`` rows where that is given (its coefficient
    tiles leave fewer rows room), else ``rows``."""
    ring_rows = ring_rows or {}
    steps = [
        ("A shipped", lambda x, A: dia_spmm_t_cuda(A, x)),
        ("D rolling", lambda x, A: spmm_d(A, x, tile=tile, rows=rows)),
        ("D in-place", lambda x, A: spmm_d(A, x, alias=True, tile=tile, rows=rows)),
    ]
    for s, q in B_RINGS:
        r = ring_rows.get((s, q), rows)
        steps.append((f"B s={s} d={q}",
                      lambda x, A, s=s, q=q, r=r: spmm_b(A, x, s, q, tile=tile, rows=r)))
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


def table_ring_rows(offsets, n: int, tile: int, rows: int):
    """The rows each ring of B takes in the table: the most, up to ``rows``,
    whose staging fits a block at ``tile``."""
    return {(s, q): max([1] + [r for r in range(1, rows + 1)
                               if ring_geometry(offsets, n, tile, r, s, q, check=False).fits])
            for s, q in B_RINGS}


def variant_table(device, N: int = 2048, m: int = 8, tile: int = 2048, rows: int = 2,
                  mb: int = 256):
    """Yield one dict a row (``label``, ``seconds``, ``gbps``,
    ``max_abs_err``): the copy rate first, then the plain version, then
    the shipped kernel and each variant at ``tile`` and ``rows`` (B's rings
    at ``table_ring_rows``) on the 2D N x N Laplacian scaled by 1/8
    (bounded under chaining), GB/s under ``bytes_spmm_dia``; then the
    sweeps (``sweep`` rows, with ``seconds`` None where the staging does not
    fit): B over ``ring_settings``, C and D over ``stage_settings``; then
    each ring's, C's and D's fastest setting again (``best`` rows, not timed
    again). Every kernel row is timed by CUDA-graph replay (the plain
    version by chains of launches); each variant's row carries its
    ``scheme`` ("B", "C" or "D"), ``route``, ``width``, ``threads``,
    ``tile``, ``rows`` and ``staged_per_consumed``. ``max_abs_err`` is a
    kernel's largest deviation from the plain version over one application
    and the 2-chain (``None`` for the copy and plain rows); a kernel beyond
    1e-5 of max|Y| raises, and so does a staged body whose result is not
    the shipped kernel's bits (``k1_bits``). On the CPU no kernel runs."""
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
    k1 = dia_spmm_t_cuda(A, Xt)
    k1_2 = dia_spmm_t_cuda(A, k1)

    def check(label, step):
        # one application against the plain version and K1, then the 2-chain
        # (the in-place form must survive feeding on its own output)
        y1 = step(Xt.clone(), A)
        y2 = step(y1.clone(), A)
        err = max((y1 - ref).abs().max().item(), (y2 - ref2).abs().max().item())
        if not err <= 1e-5 * ref.abs().max().item():
            raise RuntimeError(f"{label}: max|err| {err:.3e} against the plain version")
        if not (torch.equal(y1, k1) and torch.equal(y2, k1_2)):
            raise RuntimeError(f"{label}: not the shipped kernel's bits")
        return err

    def replayed(step):
        x = Xt.clone()  # an in-place step works on its own copy
        return replay_ms(lambda: step(x, A)) / 1e3

    def geometry(variant, T, r, ring=None, launched=True):
        if variant == "B":
            g = ring_geometry(A.offsets, n, T, r, *ring, check=False)
            spc = g.staged_per_consumed
        else:
            g = stage_geometry(variant.lower(), A.offsets, n, T, r, check=False)
            if variant == "C":
                spc = g.staged_per_consumed()
            else:  # D's chunks: those of its last launch (the check's)
                spc = g.staged_per_consumed(spmm_d.tiles_per_chunk) if launched else None
        return dict(route=g.route, width=g.width, threads=g.threads, staged_per_consumed=spc,
                    smem_bytes=g.smem_bytes)

    t = replayed(variant_steps()[0][1])
    yield dict(label=f"A shipped T={tile}", seconds=t, gbps=nbytes / t / 1e9, max_abs_err=None)
    ring_rows = table_ring_rows(A.offsets, n, tile, rows)
    rings = {f"B s={s} d={q}": (s, q) for s, q in B_RINGS}
    for label, step in variant_steps(tile, rows, ring_rows)[1:]:
        err = check(f"{label} T={tile}", step)
        t = replayed(step)
        ring = rings.get(label)
        r = ring_rows[ring] if ring else rows
        yield dict(label=f"{label} T={tile}", seconds=t, gbps=nbytes / t / 1e9, max_abs_err=err,
                   k1_bits=True, scheme=label[0], tile=tile, rows=r,
                   **geometry(label[0], tile, r, ring))

    def settings():
        for (s, q, T, r), g in ring_settings(A.offsets, n):
            yield (f"B s={s} d={q}", f"B s={s} d={q} T={T} rows={r}", g.fits, "B", T, r, (s, q),
                   lambda x, A_, s=s, q=q, T=T, r=r: spmm_b(A_, x, s, q, tile=T, rows=r))
        for variant, fn in (("C", spmm_c), ("D", spmm_d)):
            for (T, r), g in stage_settings(variant.lower(), A.offsets, n):
                yield (variant, f"{variant} T={T} rows={r}", g.fits, variant, T, r, None,
                       lambda x, A_, fn=fn, T=T, r=r: fn(A_, x, tile=T, rows=r))

    best = {}
    for group, label, fits, variant, T, r, ring, step in settings():
        more = dict(sweep=True, scheme=variant, tile=T, rows=r)
        if ring:
            more.update(nslots=ring[0], depth=ring[1])
        if not fits:
            yield dict(label=label, seconds=None, gbps=None, max_abs_err=None, **more,
                       **geometry(variant, T, r, ring, launched=False))
            continue
        err = check(label, step)
        t = replayed(step)
        row = dict(label=label, seconds=t, gbps=nbytes / t / 1e9, max_abs_err=err, k1_bits=True,
                   **more, **geometry(variant, T, r, ring))
        if group not in best or row["seconds"] < best[group]["seconds"]:
            best[group] = row
        yield row
    for group, row in best.items():
        yield dict(row, label=f"{group} best", sweep=False, best=True)


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
            spc = row["staged_per_consumed"]
            print(f"{row['label']}: does not fit ({row['smem_bytes']} bytes of shared memory"
                  + ("" if spc is None else f"; staged/consumed {spc:.2f}") + ")", flush=True)
            continue
        err = row["max_abs_err"]
        checked = "" if err is None else f"  (max|err| {err:.1e})"
        staged = (f"  [{row['route']}, width {row['width']}, {row['threads']} threads, rows "
                  f"{row['rows']}, staged/consumed {row['staged_per_consumed']:.2f}]"
                  if "route" in row else "")
        print(f"{row['label']}: {row['seconds'] * 1e6:.0f}us  {row['gbps']:.1f} GB/s{checked}"
              f"{staged}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
