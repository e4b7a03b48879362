"""The blocked orthonormalization's tall-skinny products ``C = Y X^T`` in one
launch: ``ops/ortho.py::gram_product``'s path for CUDA rows.

Replaces no TPU kernel: the JAX package's ``ops/ortho.py`` leaves its Grams
and projections to XLA at ``Precision.HIGHEST``. cuBLAS gives these outputs,
(8, 8) to (48, 24), one or a few tiles and leaves most of the card idle over
the long n axis; the kernel (``csrc/ortho_gram.cu``) spreads n over every SM,
stages the rows in shared memory and sums in a fixed order.

* ``ortho_gram_reference`` — the plain version, ``Y @ X.T`` in the Gram's
  type: the semantics, and the CPU path.
* ``takes`` — the rule ``gram_product`` reads, from what it can observe
  alone: 2-D CUDA float32 rows on one device into a float32 Gram, each row
  contiguous along the same n (any row stride, so row slices go as they
  are), at most ``MAX_TILES`` 8 x 8 register tiles (so (48, 24), (120, 8)
  and (24, 40) go, (72, 72) does not), and n at least ``MIN_N``, below
  which cuBLAS's one launch is as fast (so the GenEO flagship's n = 18,050
  goes). Other types (the float64 Gram of
  ``ortho_block='full'``, float64 rows) stay with ``torch.matmul``.
* ``ortho_gram_cuda`` — the kernel's wrapper; counts
  ``ortho_gram_cuda.launches`` and raises on anything ``takes`` refuses. The
  products are f32 FMAs, never TF32; the sums have another order than
  cuBLAS's, a fixed one, so the bits repeat from run to run.

The partial sums and the tickets of a launch live in a scratch buffer kept
for each device and stream, grown to the largest product asked for (a few
hundred KB at the cells' shapes).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dune_eigensolver_tpu_torch.utils import native

#: the side of a warp's register tile (OG_TILE in the source)
TILE = 8
#: the most tiles (one warp each) a product may have: the block's thread
#: limit over 32 (OG_MAX_THREADS in the source)
MAX_TILES = 20
#: the shortest rows the kernel takes: below, cuBLAS's one launch is as fast.
#: The kernel costs ~8-13 us at n = 8,192, and leads cuBLAS at every shape
#: from n = 18,050 on (``bench/ortho_gram.py --crossover``, H100 80GB HBM3:
#: at 8,192 (24, 24) and (48, 24) read 12.0 / 13.0 us against cuBLAS's 11.3
#: / 12.1)
MIN_N = 16_384
#: blocks a launch may use for each SM of the card (the partial sums' room)
BLOCKS_PER_SM = 2
#: blocks a group of the kernel's two-level sum of the blocks' partial sums
GROUP = 16

_SCRATCH = {}  # (device index, stream) -> (part bytes, ctl)
_SMS = {}  # device index -> SMs

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_lib = native.Launchers({
    # (y, ys, x, xs, a, b, n, out, part, ctl, max_blocks, group, stream)
    "ortho_gram_launch": [_P, _L, _P, _L, _I, _I, _L, _P, _P, _P, _I, _I, _P],
})


def fits(a: int, b: int, n: int, dtype: torch.dtype, out_dtype: torch.dtype) -> bool:
    """Whether the kernel takes an (a, b) product of ``dtype`` rows of
    length n into an ``out_dtype`` Gram: float32 into float32, at most
    ``MAX_TILES`` register tiles, n at least ``MIN_N``."""
    return (dtype == torch.float32 and out_dtype == torch.float32 and a >= 1 and b >= 1
            and -(-a // TILE) * -(-b // TILE) <= MAX_TILES and n >= MIN_N)


def ortho_gram_reference(Y: torch.Tensor, X: torch.Tensor,
                         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``Y @ X.T`` (a, b) in ``out_dtype`` (default Y's), each operand cast
    to it first: the plain version."""
    dt = out_dtype or Y.dtype
    return Y.to(dt) @ X.to(dt).T


def takes(Y: torch.Tensor, X: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> bool:
    """Whether ``ortho_gram_cuda`` takes ``Y @ X.T`` in ``out_dtype``
    (module docstring)."""
    dt = out_dtype or Y.dtype
    if not (Y.is_cuda and Y.ndim == 2 and X.ndim == 2 and X.device == Y.device
            and X.dtype == Y.dtype):
        return False
    (a, n), (b, nx) = Y.shape, X.shape
    if not (n == nx and fits(a, b, n, Y.dtype, dt)):
        return False
    # rows contiguous along n, and apart from each other
    return all(t.stride(1) == 1 and (t.shape[0] == 1 or t.stride(0) >= n)
               for t in (Y, X))


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _row_stride(t: torch.Tensor) -> int:
    """The row stride the kernel reads: a one-row operand's is its length."""
    return t.stride(0) if t.shape[0] > 1 else max(t.stride(0), t.shape[1])


def _scratch(device: torch.device, stream: int, blocks: int, values: int):
    """(part, ctl) of ``device`` and ``stream`` for a launch of at most
    ``blocks`` blocks and ``values`` float32 outputs: part holds the blocks'
    and their groups' sums, ctl the tickets (zero between launches). One
    pair a stream, whose launches are ordered. A CUDA graph's capture may
    reuse it but not make it (its zero fill would only run at the replay)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    groups = -(-blocks // GROUP)
    nbytes = (blocks + groups) * values * 4
    got = _SCRATCH.get((index, stream))
    if got is None or got[0].numel() < nbytes or got[1].numel() < 1 + groups:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("ortho_gram_cuda: launch once on the capturing stream outside "
                               "the capture first, so the scratch is made")
        ctl = torch.zeros(1 + groups, dtype=torch.int32, device=device)
        got = (torch.empty(nbytes, dtype=torch.uint8, device=device), ctl)
        _SCRATCH[(index, stream)] = got
    return got


def ortho_gram_cuda(Y: torch.Tensor, X: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``ortho_gram_reference`` by the kernel, on the current stream: C (a,
    b), contiguous, float32. Y and X are only read."""
    dt = out_dtype or Y.dtype
    if not takes(Y, X, dt):
        raise ValueError(f"ortho_gram_cuda: Y {tuple(Y.shape)} strides {Y.stride()}, X "
                         f"{tuple(X.shape)} strides {X.stride()}, {Y.dtype} on {Y.device} -> "
                         f"{dt}: not a product the kernel takes (kernels/ortho_gram.py::takes)")
    (a, n), b = Y.shape, X.shape[0]
    blocks = BLOCKS_PER_SM * _sms(Y.device)
    out = torch.empty((a, b), dtype=dt, device=Y.device)
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream().cuda_stream
        part, ctl = _scratch(Y.device, stream, blocks, a * b)
        err = _lib().ortho_gram_launch(
            Y.data_ptr(), _row_stride(Y), X.data_ptr(), _row_stride(X), a, b, n, out.data_ptr(),
            part.data_ptr(), ctl.data_ptr(), blocks, GROUP, stream)
    native.check(err, "ortho_gram_launch")
    ortho_gram_cuda.launches += 1
    return out


ortho_gram_cuda.launches = 0
