"""Tall-skinny DIA SpMM in the transposed (m, n) layout.

Counterpart of ``dune_eigensolver_tpu/kernels/dia_spmm.py``:

* ``dia_spmm_t_reference`` — plain PyTorch, the semantics: the JAX
  package's ``dia_spmm_t_xla`` with the Pallas kernel's accumulation rule
  (f32 accumulation for bf16/f16 storage, f64 for f64, output in the
  input's dtype).
* ``dia_spmm_t_cuda`` — wrapper of the hand-written CUDA kernel
  ``csrc/dia_spmm.cu`` (replaces the Pallas ``_kernel``/``padded_spmm``).
  It counts its launches in ``dia_spmm_t_cuda.launches``, records the
  vector width of the last one in ``dia_spmm_t_cuda.width`` and tallies
  them by shape in ``dia_spmm_t_cuda.calls``, a ``collections.Counter``
  keyed by ``DiaCall(n, m, dtype, ndiag, width)``.
* ``dia_vector_width`` — which of the kernel's specialisations (4, 2 or 1
  columns a thread) an operand takes, from its shape alone.

``sparse/spmm.py::spmm_t`` dispatches between the two by device.

The TPU kernel's guarded layout (``PaddedLayout``/``PaddedDIA``) is not
ported: the CUDA kernel masks its own bounds, so X stays a plain
contiguous (m, n) tensor.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Sequence, Tuple

import torch

from dune_eigensolver_tpu_torch.sparse.formats import DIAMatrix
from dune_eigensolver_tpu_torch.utils import native

_P, _I = ctypes.c_void_p, ctypes.c_int
#: (dtype, data, x, y, n, m, ndiag, offsets, width, stream)
_lib = native.Launchers({"dia_spmm_t_launch": [_I, _P, _P, _P, ctypes.c_longlong, _I, _I,
                                               ctypes.POINTER(_I), _I, _P]})

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_MAX_DIAG = 16  # DIA_MAX_DIAG in csrc/dia_spmm.cu

#: the key of ``dia_spmm_t_cuda.calls``: what sets a launch's bytes
DiaCall = collections.namedtuple("DiaCall", "n m dtype ndiag width")


def dia_spmm_t_reference(A: DIAMatrix, Xt: torch.Tensor) -> torch.Tensor:
    """Yt = (A @ Xt.T).T with Xt (m, n), in plain PyTorch: a sum of
    shifted slices of the zero-padded X in offset order. Accumulates in f32
    for bf16/f16 storage (as the Pallas kernel does) and returns Xt's
    dtype."""
    m, n = Xt.shape
    if A.shape[1] != n:
        raise ValueError(f"dia_spmm_t_reference: {A.shape} @ X^T with Xt {Xt.shape}")
    low = Xt.dtype in (torch.bfloat16, torch.float16)
    acc_dt = torch.float32 if low else Xt.dtype
    halo = max((abs(o) for o in A.offsets), default=0)
    Xp = torch.nn.functional.pad(Xt, (halo, halo))
    acc = torch.zeros((m, n), dtype=acc_dt, device=Xt.device)
    for d, off in enumerate(A.offsets):
        win = Xp[:, halo + off : halo + off + n]
        acc = acc + A.data[d].to(acc_dt)[None, :] * win.to(acc_dt)
    return acc.to(Xt.dtype)


#: diagonal counts the vector kernels are instantiated for (launch_vec in
#: csrc/dia_spmm.cu): the 2D and 3D stencils around (-1, 0, 1)
_STENCIL_COUNTS = (5, 7)


def dia_vector_width(offsets: Sequence[int], n: int, dtype: torch.dtype,
                     align: int = 16) -> int:
    """How many consecutive columns a thread of the CUDA kernel owns on this
    operand: 4, 2 or 1, moved as one request of as many elements.

    A width V > 1 needs a stencil the vector kernels are built for (5 or 7
    diagonals whose middle three are (-1, 0, 1): the kernel takes the +-1
    neighbours from the centre vector and its neighbouring lanes),
    ``n % V == 0`` (so that every row of X, Y and ``data`` starts on a
    vector boundary), every other offset a multiple of V (so that a diagonal
    is one aligned vector load), a 4- or 2-byte type (float64 takes width
    1: the kernel has no vector body for 8-byte items), and operands whose
    addresses are multiples of ``align`` bytes with ``V * itemsize``
    dividing it. Everything else takes width 1, which has no condition. The choice depends on shapes
    alone; it is a dispatch between hand-written specialisations that all
    give the same bits."""
    return _vector_width(tuple(int(o) for o in offsets), int(n),
                         torch.finfo(dtype).bits // 8, int(align))


@functools.lru_cache(maxsize=None)
def _vector_width(offsets: Tuple[int, ...], n: int, itemsize: int, align: int) -> int:
    if itemsize > 4:
        return 1
    c = len(offsets) // 2
    if len(offsets) in _STENCIL_COUNTS and offsets[c - 1 : c + 2] == (-1, 0, 1):
        far = offsets[: c - 1] + offsets[c + 2 :]
        for width in (4, 2):
            if (n % width == 0 and align % (width * itemsize) == 0
                    and all(o % width == 0 for o in far)):
                return width
    return 1


def dia_spmm_t_cuda(A: DIAMatrix, Xt: torch.Tensor) -> torch.Tensor:
    """Yt = (A @ Xt.T).T by the CUDA kernel, on the current stream.

    Takes f32, bf16 or f64, with ``A.data`` and ``Xt`` of one dtype, on one CUDA
    device, both contiguous; raises on anything else and on a launch the
    CUDA runtime refuses. The specialisation is ``dia_vector_width``'s, recorded
    in ``dia_spmm_t_cuda.width``."""
    data = A.data
    m, n = Xt.shape
    if A.shape != (n, n) or data.shape != (len(A.offsets), n):
        raise ValueError(f"dia_spmm_t_cuda: {A.shape} @ X^T with Xt {Xt.shape}")
    if not (Xt.is_cuda and data.is_cuda) or Xt.device != data.device:
        raise ValueError(
            f"dia_spmm_t_cuda: operands on {data.device} and {Xt.device}; "
            "both must be on one CUDA device"
        )
    if Xt.dtype not in _KERNEL_DTYPES or data.dtype != Xt.dtype:
        raise TypeError(
            f"dia_spmm_t_cuda: dtypes {data.dtype}/{Xt.dtype}; the kernel "
            "takes float32, bfloat16 or float64, the same for both operands"
        )
    if not (Xt.is_contiguous() and data.is_contiguous()):
        raise ValueError("dia_spmm_t_cuda: operands must be contiguous")
    ndiag = len(A.offsets)
    if not 1 <= ndiag <= _MAX_DIAG:
        raise ValueError(f"dia_spmm_t_cuda: {ndiag} diagonals, at most {_MAX_DIAG}")
    lib = _lib()
    Y = torch.empty_like(Xt)
    offs = (ctypes.c_int * ndiag)(*A.offsets)
    # the largest power of two, up to 16, dividing every operand's address
    ptrs = data.data_ptr() | Xt.data_ptr() | Y.data_ptr() | 16
    width = dia_vector_width(A.offsets, n, Xt.dtype, align=ptrs & -ptrs)
    with torch.cuda.device(Xt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dia_spmm_t_launch(
            _KERNEL_DTYPES[Xt.dtype], data.data_ptr(), Xt.data_ptr(),
            Y.data_ptr(), n, m, ndiag, offs, width, stream,
        )
    native.check(err, "dia_spmm_t_launch")
    dia_spmm_t_cuda.launches += 1
    dia_spmm_t_cuda.width = width
    dia_spmm_t_cuda.calls[DiaCall(n, m, Xt.dtype, ndiag, width)] += 1
    return Y


dia_spmm_t_cuda.launches = 0
dia_spmm_t_cuda.width = None  # of the last launch
dia_spmm_t_cuda.calls = collections.Counter()  # launches by DiaCall

