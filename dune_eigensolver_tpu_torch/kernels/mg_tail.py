"""The multigrid V-cycle's coarse tail in one launch: ``factorize/multigrid.py``'s
``_vcycle_coarse`` from the first level whose working set fits one thread
block's shared memory, down to the coarsest CG and back up.

Replaces no TPU kernel: the JAX package's ``factorize/multigrid.py`` leaves
these levels to XLA. The eager recursion launches ~2,400 tiny PyTorch
operations a V-cycle; the kernel (``csrc/mg_tail.cu``) runs them in one, a
thread block a row of the (m, *dims) block, every level in shared memory.

* ``tail_bytes`` / ``fits`` / ``tail_start`` — the fit rule, from shapes and
  the level type alone: the shared memory a row's tail takes from a level
  down (the kernel's layout), whether it fits a limit, and the first level
  from which it does.
* ``takes`` — whether ``_vcycle_coarse`` hands a level's tail to the kernel:
  a CUDA tensor of a type in ``TAIL_DTYPES`` whose tail fits the device's
  opt-in shared memory a block. Anything else stays eager.
* ``mg_tail_reference`` — the plain version: the eager recursion itself.
* ``mg_tail_cuda`` — the kernel's wrapper; counts ``mg_tail_cuda.launches``.
  Each elementwise operation rounds as the eager path's (bf16 on bf16 levels,
  f32 in the CG); only the coarsest CG's dots are summed in another order, a
  fixed one, so the bits repeat from run to run.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

#: the level types the kernel is instantiated for (the coarsest CG is f32 in each)
TAIL_DTYPES = (torch.bfloat16, torch.float32, torch.float64)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
#: the most levels a tail may hold (TAIL_MAX_LEVELS in the source)
MAX_LEVELS = 16
#: the coarsest CG's two rows of per-warp partial sums (2 * TAIL_WARPS floats)
_CG_PARTS = 2 * 32 * 4

_OPTIN = {}  # device index -> opt-in shared memory a block, bytes


def _align16(nbytes: int) -> int:
    return (nbytes + 15) & ~15


def tail_bytes(dims: Sequence[Tuple[int, ...]], dtype: torch.dtype) -> int:
    """Shared memory (bytes) of one row's tail over the levels ``dims``, the
    coarsest last: three arrays of the level type (b, x, a temporary) a
    level above the coarsest, then the coarsest's b in the level type,
    the CG's x, r, p, Ap in f32, each array on 16 bytes, and the CG's
    partial sums."""
    es = dtype.itemsize
    total = sum(3 * _align16(math.prod(d) * es) for d in dims[:-1])
    nc = math.prod(dims[-1])
    return total + _align16(nc * es) + 4 * _align16(nc * 4) + _CG_PARTS


def fits(dims: Sequence[Tuple[int, ...]], dtype: torch.dtype, limit: int) -> bool:
    """Whether a tail over the levels ``dims`` fits ``limit`` bytes and
    ``MAX_LEVELS``."""
    return len(dims) <= MAX_LEVELS and tail_bytes(dims, dtype) <= limit


def tail_start(levels: Sequence[Tuple[int, ...]], level: int, dtype: torch.dtype,
               limit: int) -> Optional[int]:
    """The first level from ``level`` on whose tail fits ``limit`` bytes, or
    None: where ``_vcycle_coarse`` enters the kernel."""
    return next((s for s in range(level, len(levels)) if fits(levels[s:], dtype, limit)), None)


def smem_optin(device: torch.device) -> int:
    """The shared memory a block may opt in to on ``device`` (bytes), read
    from the device once."""
    from dune_eigensolver_tpu_torch.utils import native

    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _OPTIN:
        v = native.load().mg_tail_smem_optin(index)
        if v < 0:
            native.check(-v, "mg_tail_smem_optin")
        _OPTIN[index] = v
    return _OPTIN[index]


def takes(b: torch.Tensor, levels: Sequence[Tuple[int, ...]], level: int) -> bool:
    """Whether the tail of ``levels`` from ``level`` on runs as the kernel: a
    CUDA ``b`` of a type in ``TAIL_DTYPES`` whose tail fits its device."""
    if not (b.is_cuda and b.dtype in TAIL_DTYPES):
        return False
    return fits(levels[level:], b.dtype, smem_optin(b.device))


def mg_tail_reference(levels, level, b, a_fine, sigma, nu1, nu2, omega, coarse_iters):
    """The plain version: ``_vcycle_coarse``'s eager recursion from ``level``
    to the coarsest level, on any device."""
    from dune_eigensolver_tpu_torch.factorize import multigrid

    return multigrid._vcycle_coarse(levels, level, b, a_fine, sigma, nu1, nu2, omega,
                                    coarse_iters, tail=False)


def mg_tail_cuda(levels, level, b, a_fine, sigma, nu1, nu2, omega, coarse_iters):
    """``mg_tail_reference`` by the kernel, on the current stream: the
    correction at ``levels[level]`` for the right-hand sides ``b`` (m,
    *levels[level]), of b's type. ``a_fine`` (fastest axis first) and
    ``sigma`` are 0-d f32 tensors on b's device (``_sampled_coeffs``)."""
    from dune_eigensolver_tpu_torch.utils import native

    tail = tuple(tuple(d) for d in levels[level:])
    nd = len(tail[0])
    if not (b.is_cuda and b.dtype in TAIL_DTYPES):
        raise TypeError(f"mg_tail_cuda: b {b.dtype} on {b.device}")
    if nd not in (2, 3) or tuple(b.shape[1:]) != tail[0] or b.shape[0] < 1:
        raise ValueError(f"mg_tail_cuda: b {tuple(b.shape)} for the level {tail[0]}")
    if len(a_fine) != nd or any(
            t.dtype != torch.float32 or t.ndim != 0 or t.device != b.device
            for t in (*a_fine, sigma)):
        raise ValueError(f"mg_tail_cuda: the coefficients must be {nd} + 1 0-d float32 "
                         f"tensors on {b.device}")
    nbytes = tail_bytes(tail, b.dtype)
    dims = [v for d in tail for v in ((1,) + d if nd == 2 else d)]
    b = b.contiguous()
    out = torch.empty_like(b)
    lib = native.load()
    with torch.cuda.device(b.device):
        err = lib.mg_tail_launch(
            _DTYPE_CODE[b.dtype], b.data_ptr(), out.data_ptr(), b.shape[0], nd, len(tail),
            level, (ctypes.c_int * len(dims))(*dims),
            *(t.data_ptr() for t in a_fine), *([None] * (3 - nd)),
            sigma.data_ptr(), nu1, nu2, float(omega), coarse_iters, nbytes,
            torch.cuda.current_stream().cuda_stream)
    native.check(err, "mg_tail_launch")
    mg_tail_cuda.launches += 1
    return out


mg_tail_cuda.launches = 0
