"""Gather and run-time indexing probes on the card, and what each form costs.

Counterpart of ``experiments/mosaic_gather_probe.py``, which asks the TPU
toolchain which in-kernel gathers and dynamic indexings it lowers (there the
(8, 256) gather FAILS by design, and the answer shaped the whole windowed
kernel). On this card every form exists, so each probe must print ``OK``;
what a redesign of the ELL/BSR kernels needs to know is what each costs,
which ``form_table`` measures against a copy. The eleven probes keep the
reference's names, inputs and functions:

  gather_1vreg_8x128, gather_2sublane_16x128, gather_2lane_8x256
      ``gather_lanes_smem``: out[r, c] = x[r, seg(c) + idx[r, c]] through
      shared memory; gather_1vreg_8x128 also through warp shuffles
      (``gather_lanes_shfl``); ``gather_lanes_global`` is the L1/L2 form
  dyn_scratch_load_3d       ``block_select_scratch``: block p through a
                            shared-memory scratch, p read by the kernel and
                            put in the bulk copies' source address (where
                            ``scratch_body`` says "bulk"; its first version,
                            which stages all blocks, is timed beside)
  dyn_input_load_3d, vmem_scalar_index   ``block_select``: x[p]
  dyn_lane_slice_aligned    ``lane_slice``: x[:, p*bw:(p+1)*bw]
                            (both one row-copy kernel, float4 moves where
                            ``slice_vector_width`` allows; their first
                            versions, ``FIRST_VERSIONS``, are timed beside)
  dyn_roll_lane             ``roll_lanes``: roll by a run-time shift
  gather_sublane_axis0      ``gather_axis0``: out[r, c] = x[idx[r, c], c]
                            (x's block of all rows staged in shared memory
                            by bulk copies where ``axis0_body`` says
                            "bulk"; its first version, through L1/L2, is
                            timed beside)
  int8_widen                ``int8_widen``: x + float(int8)
  int8_gather_idx           ``gather_lanes_int8``: the same with int8 indices

The kernels are in ``csrc/gather_probe.cu``. Each wrapper counts its
launches and has no fallback: a CPU tensor raises. Beside each stands its
plain PyTorch version (``*_reference``); ``main`` takes those, and only for
``--device cpu``. Indices outside their range are clamped by kernel and
plain version alike.

    python -m dune_eigensolver_tpu_torch.experiments.gather_probe
        [--device cpu] [--width W]

prints ``PROBE <name>: OK | WRONG-RESULT | FAIL <error>`` for each probe,
``probe done``, and then ``FORM name=<form> shape=<..> us=<t> plain_us=<t>
library_us=<t> gbps=<the function's bytes / t> share=<gbps / the copy's>``
lines at (8, W).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dune_eigensolver_tpu_torch.bench.timing import bench_loop, in_turns, replay_ms
from dune_eigensolver_tpu_torch.utils.device import resolve

FORMS = ("smem", "shfl", "global")  # how the row gather brings x to the thread


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def gather_lanes_reference(x: torch.Tensor, idx: torch.Tensor, seg: int) -> torch.Tensor:
    """out[r, c] = x[r, seg*(c // seg) + idx[r, c]] in plain PyTorch."""
    rows, width = x.shape
    j = idx.long().clamp(0, seg - 1).reshape(rows, width // seg, seg)
    return torch.gather(x.reshape(rows, width // seg, seg), 2, j).reshape(rows, width)


def _block_index(p: torch.Tensor, nb: int) -> int:
    return min(max(int(p.reshape(-1)[0]), 0), nb - 1)


def lane_slice_reference(x: torch.Tensor, p: torch.Tensor, bw: int) -> torch.Tensor:
    """x[:, p*bw:(p+1)*bw] for x (rows, nb*bw), p the first entry of ``p``."""
    q = _block_index(p, x.shape[1] // bw)
    return x[:, q * bw:(q + 1) * bw].clone()


def block_select_reference(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x[p] for x (nb, rows, bw), p the first entry of ``p``."""
    return x[_block_index(p, x.shape[0])].clone()


def roll_lanes_reference(x: torch.Tensor, s: torch.Tensor, seg: int) -> torch.Tensor:
    """Each segment of ``seg`` columns rolled left by s: out[r, c] =
    x[r, seg(c) + (c + s) mod seg]."""
    rows, width = x.shape
    shift = -int(s.reshape(-1)[0])
    return torch.roll(x.reshape(rows, width // seg, seg), shift, dims=2).reshape(rows, width)


def gather_axis0_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, c] = x[idx[r, c], c] in plain PyTorch."""
    return torch.gather(x, 0, idx.long().clamp(0, x.shape[0] - 1))


def int8_widen_reference(x: torch.Tensor, i8: torch.Tensor) -> torch.Tensor:
    """x + float(i8) in plain PyTorch (one call: the sum promotes int8 to
    x's float32)."""
    return x + i8


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(what: str, x: torch.Tensor, others=(), ints=()):
    """f32 ``x`` and ``others``, integer ``ints``, all contiguous on one CUDA
    device."""
    for t in (x, *others, *ints):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(
                f"{what}: tensor on {t.device}; the kernel takes tensors of one "
                "CUDA device (the plain version is *_reference)"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    for t in (x, *others):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: dtype {t.dtype}; the kernel takes float32")


def _seg_ok(what: str, width: int, seg: int):
    if seg < 1 or seg & (seg - 1) or width % seg:
        raise ValueError(f"{what}: seg {seg} must be a power of two that divides {width}")


def _run(name: str, x: torch.Tensor, *args) -> None:
    from dune_eigensolver_tpu_torch.utils import native

    lib = native.load()
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    native.check(err, name)


def _gather_lanes(form: str, x: torch.Tensor, idx: torch.Tensor, seg: int) -> torch.Tensor:
    what = f"gather_lanes_{form}"
    _check(what, x, ints=(idx,))
    if x.ndim != 2 or idx.shape != x.shape:
        raise ValueError(f"{what}: x {tuple(x.shape)} and idx {tuple(idx.shape)} must be one 2-D shape")
    _seg_ok(what, x.shape[1], seg)
    if idx.dtype != (torch.int8 if form == "int8" else torch.int32):
        raise TypeError(f"{what}: idx dtype {idx.dtype}")
    out = torch.empty_like(x)
    _run("gather_lanes_launch", x, FORMS.index("smem" if form == "int8" else form),
         idx.element_size(), x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0],
         x.shape[1], seg)
    return out


def gather_lanes_smem(x: torch.Tensor, idx: torch.Tensor, seg: int) -> torch.Tensor:
    """out[r, c] = x[r, seg(c) + idx[r, c]], int32 idx: a block stages its
    columns in shared memory and reads smem[idx]."""
    out = _gather_lanes("smem", x, idx, seg)
    gather_lanes_smem.launches += 1
    return out


def gather_lanes_shfl(x: torch.Tensor, idx: torch.Tensor, seg: int = 128) -> torch.Tensor:
    """The same for seg = 128 by warp shuffles: a warp holds a segment in
    four registers a lane, four ``__shfl_sync`` rounds an output."""
    if seg != 128:
        raise ValueError("gather_lanes_shfl: the shuffle form takes seg = 128")
    out = _gather_lanes("shfl", x, idx, seg)
    gather_lanes_shfl.launches += 1
    return out


def gather_lanes_global(x: torch.Tensor, idx: torch.Tensor, seg: int) -> torch.Tensor:
    """The same with every thread reading x through L1/L2 directly."""
    out = _gather_lanes("global", x, idx, seg)
    gather_lanes_global.launches += 1
    return out


def gather_lanes_int8(x: torch.Tensor, idx: torch.Tensor, seg: int) -> torch.Tensor:
    """The shared-memory form with int8 indices, widened in registers."""
    out = _gather_lanes("int8", x, idx, seg)
    gather_lanes_int8.launches += 1
    return out


def _index_ok(what: str, x: torch.Tensor, p: torch.Tensor):
    _check(what, x, ints=(p,))
    if p.dtype != torch.int32 or p.numel() < 1:
        raise TypeError(f"{what}: the index must be a non-empty int32 tensor")


#: ``block_select_launch``'s form of each body that takes x (rows, nb*bw)
SCRATCH_FORMS = {"first": 1, "bulk": 2}


def scratch_body(bw: int, align: int = 16) -> str:
    """Which body of the scratch selection runs: "bulk" (block p's row
    segments through a ring of shared-memory stages by bulk copies) where
    every segment starts and ends on 16 bytes, that is ``bw`` is a multiple
    of 4 and both tensors' addresses are multiples of ``align`` with 16
    dividing it (the row stride nb*bw then is one too); "rows" (the row
    copy of ``lane_slice``, one float a thread) else, which has no
    condition. A dispatch between two bodies that give the same bits; the
    launcher refuses "bulk" elsewhere."""
    if align % 16 == 0 and bw % 4 == 0:
        return "bulk"
    return "rows"


def _scratch(fn, x: torch.Tensor, p: torch.Tensor, bw: int, first: bool) -> torch.Tensor:
    what = fn.__name__
    _index_ok(what, x, p)
    if x.ndim != 2 or bw < 1 or x.shape[1] % bw:
        raise ValueError(f"{what}: x {tuple(x.shape)} is not (rows, nb * {bw})")
    nb = x.shape[1] // bw
    if first and nb * min(bw, 2048) * 4 > 227 * 1024:
        raise ValueError(f"{what}: {nb} blocks exceed a block's shared memory")
    out = torch.empty((x.shape[0], bw), dtype=x.dtype, device=x.device)
    ptrs = x.data_ptr() | out.data_ptr() | 16
    fn.body = "first" if first else scratch_body(bw, align=ptrs & -ptrs)
    if fn.body == "rows":
        _run("slice_rows_launch", x, 1, x.data_ptr(), p.data_ptr(), out.data_ptr(), x.shape[0],
             bw, nb, nb * bw, bw)
    else:
        _run("block_select_launch", x, SCRATCH_FORMS[fn.body], x.data_ptr(), p.data_ptr(),
             out.data_ptr(), x.shape[0], bw, nb, 0, 0)
    fn.launches += 1
    return out


def block_select_scratch(x: torch.Tensor, p: torch.Tensor, bw: int = 128) -> torch.Tensor:
    """x[:, p*bw:(p+1)*bw] for x (rows, nb*bw) through a shared-memory
    scratch that holds block p alone: the kernel reads p from ``p`` (int32,
    on the card) and puts it in the source address of the bulk copies that
    fill the scratch (the body ``scratch_body`` chooses, in
    ``block_select_scratch.body``)."""
    return _scratch(block_select_scratch, x, p, bw, first=False)


def block_select_scratch_first(x: torch.Tensor, p: torch.Tensor, bw: int = 128
                               ) -> torch.Tensor:
    """``block_select_scratch`` by its first version, which stages a chunk
    of all nb blocks in shared memory and copies out block p; kept to be
    timed in turns with the bulk copy."""
    return _scratch(block_select_scratch_first, x, p, bw, first=True)


def slice_vector_width(bw: int, row_stride: int, block_stride: int, align: int = 16) -> int:
    """How many floats a thread of the row-copy kernel moves at once: 4 (one
    ``float4``) where every row of the selected block and of the output
    starts on 16 bytes, that is ``bw`` and both strides are multiples of 4
    and both tensors' addresses are multiples of ``align`` with 16 dividing
    it; 1 (one float) else, which has no condition. A dispatch between two
    specialisations that give the same bits."""
    if align % 16 == 0 and bw % 4 == 0 and row_stride % 4 == 0 and block_stride % 4 == 0:
        return 4
    return 1


def _lane_strides(what: str, x: torch.Tensor, p: torch.Tensor, bw: int):
    """(rows, bw, nb, row_stride, block_stride) of a selection from x (rows,
    nb*bw)."""
    _index_ok(what, x, p)
    if x.ndim != 2 or bw < 1 or x.shape[1] % bw:
        raise ValueError(f"{what}: x {tuple(x.shape)} is not (rows, nb * {bw})")
    return x.shape[0], bw, x.shape[1] // bw, x.shape[1], bw


def _block_strides(what: str, x: torch.Tensor, p: torch.Tensor):
    """The same for x (nb, rows, bw)."""
    _index_ok(what, x, p)
    if x.ndim != 3:
        raise ValueError(f"{what}: x {tuple(x.shape)} is not (nb, rows, bw)")
    nb, rows, bw = x.shape
    return rows, bw, nb, bw, rows * bw


def _select(fn, x, p, rows, bw, nb, row_stride, block_stride, first=False) -> torch.Tensor:
    """Block p of x, its rows ``row_stride`` apart, by the row copy
    (``slice_rows_launch``; its width recorded in ``fn.width``) or, with
    ``first``, by its first version; counted on wrapper ``fn``."""
    out = torch.empty((rows, bw), dtype=x.dtype, device=x.device)
    if first:
        _run("block_select_launch", x, 0, x.data_ptr(), p.data_ptr(), out.data_ptr(), rows, bw,
             nb, row_stride, block_stride)
    else:
        ptrs = x.data_ptr() | out.data_ptr() | 16
        fn.width = slice_vector_width(bw, row_stride, block_stride, align=ptrs & -ptrs)
        _run("slice_rows_launch", x, fn.width, x.data_ptr(), p.data_ptr(), out.data_ptr(), rows,
             bw, nb, row_stride, block_stride)
    fn.launches += 1
    return out


def lane_slice(x: torch.Tensor, p: torch.Tensor, bw: int = 128) -> torch.Tensor:
    """x[:, p*bw:(p+1)*bw] for x (rows, nb*bw), straight from device memory
    at the offset the kernel reads from ``p``: one run of bw floats a row,
    float4 moves where ``slice_vector_width`` allows."""
    return _select(lane_slice, x, p, *_lane_strides("lane_slice", x, p, bw))


def block_select(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x[p] for x (nb, rows, bw), p read by the kernel from the first entry
    of ``p`` (int32, on the card; pass a view to read another entry); the
    same row-copy kernel as ``lane_slice``."""
    return _select(block_select, x, p, *_block_strides("block_select", x, p))


def lane_slice_first(x: torch.Tensor, p: torch.Tensor, bw: int = 128) -> torch.Tensor:
    """``lane_slice`` by its first version (one float a thread over the
    flat output), kept to be timed in turns with the row copy."""
    return _select(lane_slice_first, x, p, *_lane_strides("lane_slice_first", x, p, bw),
                   first=True)


def block_select_first(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``block_select`` by its first version."""
    return _select(block_select_first, x, p, *_block_strides("block_select_first", x, p),
                   first=True)


def roll_lanes(x: torch.Tensor, s: torch.Tensor, seg: int) -> torch.Tensor:
    """Each ``seg`` columns rolled left by the shift the kernel reads from
    ``s`` (int32, on the card), through shared memory."""
    _index_ok("roll_lanes", x, s)
    if x.ndim != 2:
        raise ValueError(f"roll_lanes: x {tuple(x.shape)} must be 2-D")
    _seg_ok("roll_lanes", x.shape[1], seg)
    out = torch.empty_like(x)
    _run("roll_lanes_launch", x, x.data_ptr(), s.data_ptr(), out.data_ptr(), x.shape[0],
         x.shape[1], seg)
    roll_lanes.launches += 1
    return out


#: ``gather_axis0_launch``'s flag of each body
AXIS0_BODIES = {"first": 0, "bulk": 1}
AXIS0_TILE = 512  # columns a block of the bulk body owns (``GA_TILE``)
#: rows whose (rows, AXIS0_TILE) f32 block, with its 16-byte barrier, fits
#: a block's 227 KB of shared memory (``GA_MAX_ROWS``)
AXIS0_MAX_ROWS = (227 * 1024 - 16) // (AXIS0_TILE * 4)


def axis0_body(rows: int, width: int, align: int = 16) -> str:
    """Which body of the gather across rows runs: "bulk" (a block stages x's
    rows x 512 block by bulk copies and gathers in shared memory, four
    columns a thread) where every row segment and every index and output
    vector lies on 16 bytes, that is ``width`` is a multiple of 4 and the
    three tensors' addresses are multiples of ``align`` with 16 dividing
    it, and the block of all ``rows`` fits in shared memory; "first" (the
    first version, one float a thread through L1/L2, which has no
    condition) else. A dispatch between two bodies that give the same bits;
    the launcher refuses "bulk" elsewhere."""
    if align % 16 == 0 and width % 4 == 0 and 1 <= rows <= AXIS0_MAX_ROWS:
        return "bulk"
    return "first"


def _axis0(fn, x: torch.Tensor, idx: torch.Tensor, first: bool) -> torch.Tensor:
    what = fn.__name__
    _check(what, x, ints=(idx,))
    if x.ndim != 2 or idx.shape != x.shape or idx.dtype != torch.int32:
        raise ValueError(f"{what}: x and int32 idx must be one 2-D shape")
    out = torch.empty_like(x)
    ptrs = x.data_ptr() | idx.data_ptr() | out.data_ptr() | 16
    fn.body = "first" if first else axis0_body(x.shape[0], x.shape[1], align=ptrs & -ptrs)
    _run("gather_axis0_launch", x, AXIS0_BODIES[fn.body], x.data_ptr(), idx.data_ptr(),
         out.data_ptr(), x.shape[0], x.shape[1])
    fn.launches += 1
    return out


def gather_axis0(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, c] = x[idx[r, c], c] by the CUDA kernel: x's block of all rows
    staged once in shared memory by bulk copies where ``axis0_body`` says
    "bulk", else the first version (the body taken in
    ``gather_axis0.body``)."""
    return _axis0(gather_axis0, x, idx, first=False)


def gather_axis0_first(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``gather_axis0`` by its first version (one float a thread, x read
    through L1/L2), kept to be timed in turns with the bulk body."""
    return _axis0(gather_axis0_first, x, idx, first=True)


def int8_widen(x: torch.Tensor, i8: torch.Tensor) -> torch.Tensor:
    """x + float(i8) by the CUDA kernel (char4 loads where aligned)."""
    _check("int8_widen", x, ints=(i8,))
    if i8.shape != x.shape or i8.dtype != torch.int8:
        raise ValueError("int8_widen: i8 must be int8 of x's shape")
    out = torch.empty_like(x)
    _run("int8_widen_launch", x, x.data_ptr(), i8.data_ptr(), out.data_ptr(), x.numel())
    int8_widen.launches += 1
    return out


#: every kernel wrapper of this module, by the name the tables use
KERNELS = {fn.__name__: fn for fn in (
    gather_lanes_smem, gather_lanes_shfl, gather_lanes_global, gather_lanes_int8,
    block_select_scratch, lane_slice, block_select, roll_lanes, gather_axis0, int8_widen)}
#: the first versions of the redesigned kernels, by the name of the kernel
#: they preceded; no probe runs them, only ``form_table``'s timing in turns
FIRST_VERSIONS = {"lane_slice": lane_slice_first, "block_select": block_select_first,
                  "block_select_scratch": block_select_scratch_first,
                  "gather_axis0": gather_axis0_first}
for _fn in (*KERNELS.values(), *FIRST_VERSIONS.values()):
    _fn.launches = 0
lane_slice.width = block_select.width = None  # the vector width of the last launch
for _fn in (block_select_scratch, block_select_scratch_first, gather_axis0, gather_axis0_first):
    _fn.body = None  # the body of the last launch


# ---------------------------------------------------------------------------
# The eleven probes
# ---------------------------------------------------------------------------


def probe(name, fn) -> str:
    """The reference's protocol: run ``fn``, which returns elementwise
    ``result == expected``; print and return the verdict."""
    try:
        out = fn()
        ok = bool(np.asarray(out).all())
        verdict = "OK" if ok else "WRONG-RESULT"
    except Exception as e:  # the probe's purpose: report what a form does, and go on
        verdict = "FAIL " + repr(e).replace("\n", " ")[:160]
    print(f"PROBE {name}: {verdict}", flush=True)
    return verdict


def _on(device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _flipped_lanes(rows: int, seg: int, width: int) -> np.ndarray:
    """The reference's index block: lane c of every segment reads lane
    seg - 1 - c."""
    return np.broadcast_to(np.flip(np.arange(seg, dtype=np.int32)), (rows, width // seg, seg)
                           ).reshape(rows, width)


def _arange(*shape) -> np.ndarray:
    return np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)


def _gather_probe(device, rows, width, seg, form, int8=False):
    x = _arange(rows, width)
    idx = _flipped_lanes(rows, seg, width)
    want = np.take_along_axis(x.reshape(rows, -1, seg), idx.reshape(rows, -1, seg).astype(np.int64),
                              axis=2).reshape(rows, width)
    xt, it = _on(device, x), _on(device, idx.astype(np.int8) if int8 else idx)
    if device.type == "cuda":
        out = KERNELS["gather_lanes_" + ("int8" if int8 else form)](xt, it, seg)
    else:
        out = gather_lanes_reference(xt, it, seg)
    return out.cpu().numpy() == want


def gather_1vreg(device, rows=8, width=128, form="smem"):
    """1. lane gather: source (8, 128), idx (8, 128)."""
    return _gather_probe(device, rows, width, 128, form)


def gather_2sublane(device, rows=16, width=128):
    """2. the same on (16, 128)."""
    return _gather_probe(device, rows, width, 128, "smem")


def gather_2lane(device, rows=8, width=256):
    """7. gather over 256 lanes, (8, 256): FAILS on the TPU by design, must
    be OK here."""
    return _gather_probe(device, rows, width, 256, "smem")


def int8_gather_idx(device, rows=8, width=128):
    """11. int8 indices widened in the kernel, then gathered."""
    return _gather_probe(device, rows, width, 128, "smem", int8=True)


def dyn_scratch_load(device, rows=8, width=512, bw=128, p=2):
    """3. dynamic leading-dim load from a scratch of nb (rows, bw) blocks."""
    x = _arange(rows, width)
    xt, pt = _on(device, x), _on(device, np.array([p], np.int32))
    out = block_select_scratch(xt, pt, bw) if device.type == "cuda" else \
        lane_slice_reference(xt, pt, bw)
    return out.cpu().numpy() == x[:, p * bw:(p + 1) * bw]


def dyn_input_load(device, rows=8, width=512, bw=128, p=1):
    """4. dynamic leading-dim load straight from a (nb, rows, bw) input."""
    x = _arange(width // bw, rows, bw)
    xt, pt = _on(device, x), _on(device, np.array([p], np.int32))
    out = block_select(xt, pt) if device.type == "cuda" else block_select_reference(xt, pt)
    return out.cpu().numpy() == x[p]


def dyn_lane_slice(device, rows=8, width=512, bw=128, p=3):
    """5. dynamic slice along the row at a bw-aligned offset."""
    x = _arange(rows, width)
    xt, pt = _on(device, x), _on(device, np.array([p], np.int32))
    out = lane_slice(xt, pt, bw) if device.type == "cuda" else lane_slice_reference(xt, pt, bw)
    return out.cpu().numpy() == x[:, p * bw:(p + 1) * bw]


def dyn_roll(device, rows=8, width=256, s=37):
    """6. roll along the row by a shift read at run time."""
    x = _arange(rows, width)
    xt, st = _on(device, x), _on(device, np.array([s], np.int32))
    out = roll_lanes(xt, st, width) if device.type == "cuda" else \
        roll_lanes_reference(xt, st, width)
    return out.cpu().numpy() == np.roll(x, -s, axis=1)


def gather_sublane_axis(device, rows=8, width=128):
    """8. gather across rows (axis 0)."""
    x = _arange(rows, width)
    idx = np.broadcast_to((np.arange(rows, dtype=np.int32)[:, None] + 3) % rows, (rows, width))
    xt, it = _on(device, x), _on(device, idx)
    out = gather_axis0(xt, it) if device.type == "cuda" else gather_axis0_reference(xt, it)
    return out.cpu().numpy() == np.take_along_axis(x, idx.astype(np.int64), axis=0)


def vmem_scalar_index(device, rows=8, width=512, bw=128):
    """9. a block index read from entry (1, 2) of an int32 array on the
    device."""
    nb = width // bw
    x = _arange(nb, rows, bw)
    bases = (np.broadcast_to(np.arange(8, dtype=np.int32), (8, 8)).T % nb).astype(np.int32)
    xt, bt = _on(device, x), _on(device, bases)
    q = bt[1, 2:3]  # a view: the kernel reads the entry itself
    out = block_select(xt, q) if device.type == "cuda" else block_select_reference(xt, q)
    return out.cpu().numpy() == x[bases[1, 2]]


def int8_widen_probe(device, rows=8, width=128):
    """10. int8 block widened in the kernel."""
    x = np.ones((rows, width), np.float32)
    i8 = (np.arange(rows * width, dtype=np.int32) % 128).astype(np.int8).reshape(rows, width)
    xt, it = _on(device, x), _on(device, i8)
    out = int8_widen(xt, it) if device.type == "cuda" else int8_widen_reference(xt, it)
    return out.cpu().numpy() == 1.0 + i8.astype(np.float32)


#: (name, function) in the reference's order
PROBES = (
    ("gather_1vreg_8x128", gather_1vreg),
    ("gather_2sublane_16x128", gather_2sublane),
    ("dyn_scratch_load_3d", dyn_scratch_load),
    ("dyn_input_load_3d", dyn_input_load),
    ("dyn_lane_slice_aligned", dyn_lane_slice),
    ("dyn_roll_lane", dyn_roll),
    ("gather_2lane_8x256", gather_2lane),
    ("gather_sublane_axis0", gather_sublane_axis),
    ("vmem_scalar_index", vmem_scalar_index),
    ("int8_widen", int8_widen_probe),
    ("int8_gather_idx", int8_gather_idx),
)


def run_probes(device) -> dict:
    """Run the eleven probes (and, on the card, the shuffle form of the
    first); print their lines and ``probe done``; return ``{name:
    verdict}``."""
    device = resolve(device)
    verdicts = {name: probe(name, lambda fn=fn: fn(device)) for name, fn in PROBES}
    if device.type == "cuda":
        name = "gather_1vreg_8x128_shfl"
        verdicts[name] = probe(name, lambda: gather_1vreg(device, form="shfl"))
    print("probe done", flush=True)
    return verdicts


# ---------------------------------------------------------------------------
# What each form costs
# ---------------------------------------------------------------------------


ROWS, SEG = 8, 128  # the timed shape's rows (a multivector's) and the gathers' segment


def form_table(device, width: int = 4_194_304):
    """Yield one dict per form at (8, width) f32: the copy first (``x +
    1.0``, whose GB/s the shares are taken against), then the gather along
    the row in segments of 128 by shuffles, through shared memory, through
    L1/L2 and with int8 indices, the gather across rows, the roll, the int8
    widen-add, and the three selections of one of four blocks.
    ``us``: the kernel's device time, by replaying a CUDA graph of ten
    calls (``bench.timing.replay_ms``: these kernels take less time than the
    host needs to launch one through its wrapper); ``eager_us``: best chain
    of 30 launched from the host, which that host time can bound;
    ``plain_us``: best chain of 30 of the plain version (the selections'
    and the roll's read the index on the host, which no graph can hold);
    ``library_us``: the device time, by
    replay, of one PyTorch call that computes the function on arguments
    prepared outside the timing (indices already int64, block index and
    shift already on the host); the copy's row is ``x + 1.0`` by replay;
    ``library_eager_us``: the library call's best chain of 30, to stand
    beside ``eager_us``. On the CPU every time is the best chain of 30 (and
    the eager keys are None). ``nbytes``: the bytes
    the function must move (inputs read once, output written once; for a
    block selection one block in, one out), ``gbps`` those over the time and
    ``share`` that over the copy's; ``streamed_bytes``: what the kernel
    moves by design (here the function's bytes for every form);
    ``first_streamed_bytes``: what a first version moves beyond them (the
    scratch form's stages all four blocks; None on the other rows). On the
    card each kernel is first held to its plain version (``max_abs_err``,
    which must be 0: these kernels only move values, and the widen-add is
    one f32 add); the three selections and the gather across rows are timed
    in turns with their first versions (``FIRST_VERSIONS``, held to the same
    bits): kernel, first, first, kernel, the best of each, the first's in
    ``first_us`` (None on every other row), by replay too. On the CPU only
    the plain versions run and ``us`` is None. Prints each row as a
    ``FORM`` line."""
    device = resolve(device)
    on_card = device.type == "cuda"
    rng = np.random.default_rng(0)
    x = _on(device, rng.standard_normal((ROWS, width)).astype(np.float32))
    f4 = ROWS * width * 4
    lanes = _on(device, rng.integers(0, SEG, (ROWS, width)).astype(np.int32))
    across = _on(device, rng.integers(0, ROWS, (ROWS, width)).astype(np.int32))
    i8 = _on(device, rng.integers(-128, 128, (ROWS, width)).astype(np.int8))
    blk, shift = 2, 37
    p = _on(device, np.array([blk], np.int32))
    s = _on(device, np.array([shift], np.int32))
    bw = width // 4
    x3 = x.reshape(ROWS, 4, bw).transpose(0, 1).contiguous()  # (4, ROWS, bw)
    lanes64 = lanes.long().reshape(ROWS, width // SEG, SEG)
    across64 = across.long()

    def lanes_plain(v, i):
        return gather_lanes_reference(v, i, SEG)

    def lanes_library(v, i):
        return torch.gather(v.view(ROWS, width // SEG, SEG), 2, lanes64)

    def slice_library(v, q):
        return v[:, blk * bw:(blk + 1) * bw].clone()

    firsts = {"lane_slice": lambda v, q: lane_slice_first(v, q, bw),
              "block_select": block_select_first,
              "block_select_scratch": lambda v, q: block_select_scratch_first(v, q, bw),
              "gather_axis0": gather_axis0_first}

    # name, kernel, plain version, the one library call, x0, further
    # arguments, bytes the function moves, bytes the kernel streams
    forms = [
        ("gather_lanes_shfl", gather_lanes_shfl, lanes_plain, lanes_library, x, (lanes,),
         3 * f4, 3 * f4),
        ("gather_lanes_smem", lambda v, i: gather_lanes_smem(v, i, SEG), lanes_plain,
         lanes_library, x, (lanes,), 3 * f4, 3 * f4),
        ("gather_lanes_global", lambda v, i: gather_lanes_global(v, i, SEG), lanes_plain,
         lanes_library, x, (lanes,), 3 * f4, 3 * f4),
        ("gather_lanes_int8", lambda v, i: gather_lanes_int8(v, i, SEG), lanes_plain,
         lanes_library, x, (lanes.to(torch.int8),), 2 * f4 + f4 // 4, 2 * f4 + f4 // 4),
        ("gather_axis0", gather_axis0, gather_axis0_reference,
         lambda v, i: torch.gather(v, 0, across64), x, (across,), 3 * f4, 3 * f4),
        ("roll_lanes", lambda v, s_: roll_lanes(v, s_, SEG),
         lambda v, s_: roll_lanes_reference(v, s_, SEG),
         lambda v, s_: torch.roll(v.view(ROWS, width // SEG, SEG), -shift, 2), x, (s,),
         2 * f4, 2 * f4),
        ("int8_widen", int8_widen, int8_widen_reference, int8_widen_reference, x, (i8,),
         2 * f4 + f4 // 4, 2 * f4 + f4 // 4),
        # the function is one block in, one out, and the scratch form moves
        # just that; its first version stages all four blocks
        ("block_select_scratch", lambda v, q: block_select_scratch(v, q, bw),
         lambda v, q: lane_slice_reference(v, q, bw), slice_library, x, (p,),
         2 * (f4 // 4), 2 * (f4 // 4)),
        ("lane_slice", lambda v, q: lane_slice(v, q, bw),
         lambda v, q: lane_slice_reference(v, q, bw), slice_library, x, (p,),
         2 * (f4 // 4), 2 * (f4 // 4)),
        ("block_select", block_select, block_select_reference, lambda v, q: v[blk].clone(), x3,
         (p,), 2 * (f4 // 4), 2 * (f4 // 4)),
    ]

    def keep(fn):  # the output may have another shape than x: hand x on
        def step(v, *a):
            fn(v, *a)
            return v
        return step

    def device_s(fn, *a):  # one call's device time, seconds
        return replay_ms(lambda: fn(*a)) * 1e-3

    def eager_us(fn, x0, args):  # best chain of 30 launched from the host, µs
        return bench_loop(keep(fn), x0, K=30, op_args=args) * 1e6

    def copy(v):
        return v + 1.0

    t_copy = device_s(copy, x) if on_card else bench_loop(copy, x, K=30)
    copy_gbps = 2 * f4 / t_copy / 1e9
    row = dict(name="copy", shape=(ROWS, width), us=t_copy * 1e6 if on_card else None,
               eager_us=None, plain_us=t_copy * 1e6, library_us=t_copy * 1e6,
               library_eager_us=eager_us(copy, x, ()) if on_card else None, first_us=None,
               max_abs_err=None, nbytes=2 * f4, streamed_bytes=2 * f4, first_streamed_bytes=None,
               gbps=copy_gbps, share=1.0)
    _print_form(row)
    yield row
    for name, kernel, plain, library, x0, args, nbytes, streamed in forms:
        want = plain(x0, *args)
        if not torch.equal(library(x0, *args).view(want.shape), want):
            raise RuntimeError(f"form {name}: library call and plain version differ")
        t = err = t_first = t_eager = t_library_eager = None
        if on_card:
            err = (kernel(x0, *args) - want).abs().max().item()
            if err != 0.0:
                raise RuntimeError(f"form {name}: kernel and plain version differ by {err:.3e}")
            if name in firsts:
                if not torch.equal(firsts[name](x0, *args), want):
                    raise RuntimeError(f"form {name}: first version and plain version differ")
                t, t_first = in_turns([kernel, firsts[name]], lambda fn: device_s(fn, x0, *args))
            else:
                t = device_s(kernel, x0, *args)
            t_eager, t_library_eager = (eager_us(fn, x0, args) for fn in (kernel, library))
        del want
        t_plain = bench_loop(keep(plain), x0, K=30, op_args=args)
        if on_card:
            t_library = device_s(library, x0, *args)
        else:
            t_library = bench_loop(keep(library), x0, K=30, op_args=args)
        best = t if on_card else t_plain
        row = dict(name=name, shape=tuple(x0.shape), us=None if t is None else t * 1e6,
                   eager_us=t_eager, plain_us=t_plain * 1e6, library_us=t_library * 1e6,
                   library_eager_us=t_library_eager,
                   first_us=None if t_first is None else t_first * 1e6, max_abs_err=err,
                   nbytes=nbytes, streamed_bytes=streamed,
                   first_streamed_bytes=f4 + f4 // 4 if name == "block_select_scratch" else None,
                   gbps=nbytes / best / 1e9,
                   share=nbytes / best / 1e9 / copy_gbps)
        _print_form(row)
        yield row


def _print_form(row) -> None:
    us = "plain-only" if row["us"] is None else f"{row['us']:.1f}"
    shape = "x".join(str(d) for d in row["shape"])
    print(f"FORM name={row['name']} shape={shape} us={us} plain_us={row['plain_us']:.1f} "
          f"library_us={row['library_us']:.1f} gbps={row['gbps']:.1f} share={row['share']:.3f}"
          + "".join(f" {k}={row[k]:.1f}" for k in ("eager_us", "library_eager_us")
                    if row[k] is not None), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu for the plain versions; default the card")
    ap.add_argument("--width", type=int, default=4_194_304, help="columns of the timed shape")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)} platform=cuda", flush=True)
    else:
        print("device: cpu platform=cpu (plain versions; no time here is the card's)", flush=True)
    run_probes(device)
    for _ in form_table(device, args.width):
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
