"""General-sparsity SpMM (ELL and block-ELL) in the transposed (m, n) layout.

Counterpart of ``dune_eigensolver_tpu/kernels/gather_spmm.py``:

* ``ell_spmm_t_reference`` / ``bsr_spmm_t_reference`` — plain PyTorch, the
  semantics: torch translations of the JAX package's ``ell_spmm_t`` and
  ``bsr_spmm_t`` (``sparse/spmm.py``), a gather plus an einsum that
  accumulates in at least f32 (f32 for bf16/f16 storage, as the Pallas
  kernels do; f64 for f64), output in X's dtype.
* ``ell_spmm_t_cuda`` — wrapper of ``csrc/ell_spmm.cu``, which replaces the
  Pallas ``_seg_kernel`` (launched by ``windowed_spmm_t``).
* ``bsr_spmm_t_cuda`` — wrapper of ``csrc/bsr_spmm.cu``, which replaces the
  Pallas ``_blk_kernel`` (same launcher), for square b x b blocks with
  b in ``BSR_KERNEL_BLOCKS``.

Each wrapper counts its launches in ``<wrapper>.launches`` (and by dtype
in ``<wrapper>.by_dtype``);
``sparse/spmm.py::spmm_t`` dispatches between plain version and kernel by
device. The TPU side's windowed/segment planner (``WindowedELL``,
``WindowedBSR``, the COO tail, ``WindowedLayout``) is not ported: a CUDA
thread gathers X straight from device memory through the caches, so the
containers feed the kernels as they are (in the ``(k, n)`` stream layout
of ``ELLMatrix.kernel_streams``/``BSRMatrix.kernel_streams``; the ELL
kernel also reads ``ELLMatrix.warp_slots``).
"""

from __future__ import annotations

import collections

import torch

from dune_eigensolver_tpu_torch.sparse.formats import BSRMatrix, ELLMatrix

BSR_KERNEL_BLOCKS = (2, 4)  # the b the BSR kernel is instantiated for
#: the value types the ELL and BSR kernels are instantiated for (the TPU
#: gather kernels stream f32; the card adds f64)
GATHER_KERNEL_DTYPES = (torch.float32, torch.float64)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def ell_spmm_t_reference(A: ELLMatrix, Xt: torch.Tensor) -> torch.Tensor:
    """Yt = (A @ Xt.T).T with Xt (m, n_cols), in plain PyTorch."""
    if A.shape[1] != Xt.shape[1]:
        raise ValueError(f"ell_spmm_t_reference: {A.shape} @ X^T with Xt {tuple(Xt.shape)}")
    acc = _acc_dtype(Xt.dtype)
    gathered = Xt[:, A.cols.long()].to(acc)  # (m, n, k)
    return torch.einsum("nk,mnk->mn", A.data.to(acc), gathered).to(Xt.dtype)


def bsr_spmm_t_reference(A: BSRMatrix, Xt: torch.Tensor) -> torch.Tensor:
    """Yt = (A @ Xt.T).T with A in block-ELL form and Xt (m, n_cols), in
    plain PyTorch."""
    if A.shape[1] != Xt.shape[1]:
        raise ValueError(f"bsr_spmm_t_reference: {A.shape} @ X^T with Xt {tuple(Xt.shape)}")
    _, bc = A.block
    m = Xt.shape[0]
    acc = _acc_dtype(Xt.dtype)
    Xb = Xt.reshape(m, A.shape[1] // bc, bc)
    gathered = Xb[:, A.bcols.long()].to(acc)  # (m, nbr, k, bc)
    Yb = torch.einsum("rkab,mrkb->mra", A.bdata.to(acc), gathered)
    return Yb.reshape(m, A.shape[0]).to(Xt.dtype)


def _check_cuda_operands(what: str, coef: torch.Tensor, index: torch.Tensor,
                         Xt: torch.Tensor, n_cols: int):
    """The checks both wrappers make before anything is loaded."""
    if Xt.ndim != 2 or Xt.shape[1] != n_cols or Xt.shape[0] < 1:
        raise ValueError(f"{what}: Xt {tuple(Xt.shape)} does not have {n_cols} columns")
    if not (Xt.is_cuda and coef.is_cuda) or Xt.device != coef.device:
        raise ValueError(
            f"{what}: operands on {coef.device} and {Xt.device}; "
            "both must be on one CUDA device"
        )
    if Xt.dtype not in GATHER_KERNEL_DTYPES or coef.dtype != Xt.dtype:
        raise TypeError(
            f"{what}: dtypes {coef.dtype}/{Xt.dtype}; the kernel takes float32 or "
            "float64, the same for both operands"
        )
    if index.dtype != torch.int32 or index.device != coef.device:
        raise TypeError(f"{what}: indices must be int32 beside the coefficients")
    if not Xt.is_contiguous():
        raise ValueError(f"{what}: Xt must be contiguous")


def _launch(name: str, Xt: torch.Tensor, y_shape, *args) -> torch.Tensor:
    """Run launcher ``name`` with ``args`` then (X, Y, m, stream) on a new
    (m, n) output; raise on a CUDA error."""
    from dune_eigensolver_tpu_torch.utils import native

    lib = native.load()
    Y = torch.empty(y_shape, dtype=Xt.dtype, device=Xt.device)
    with torch.cuda.device(Xt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*args, Xt.data_ptr(), Y.data_ptr(), Xt.shape[0], stream)
    native.check(err, name)
    return Y


def ell_spmm_t_cuda(A: ELLMatrix, Xt: torch.Tensor) -> torch.Tensor:
    """Yt = (A @ Xt.T).T by the CUDA ELL kernel, on the current stream.
    f32 or f64 (operands of one dtype), one CUDA device, contiguous Xt;
    raises on anything else and
    on a launch CUDA refuses. Each warp of 32 rows runs its slots up to
    ``A.warp_slots`` (the trailing padding is skipped): on finite X the
    plain version's function; a non-finite X value in the column of a
    padding slot past its warp's count does not reach Y (ROADMAP queue 3).
    The kernel reads the index stream of ``A.kernel_streams``: int16
    offsets ``cols - row`` where they fit, else int32 columns."""
    n, n_cols = A.shape
    _check_cuda_operands("ell_spmm_t_cuda", A.data, A.cols, Xt, n_cols)
    data_t, index_t = A.kernel_streams
    Y = _launch("ell_spmm_t_launch", Xt, (Xt.shape[0], n), Xt.element_size(), data_t.data_ptr(),
                index_t.data_ptr(), index_t.element_size(), A.warp_slots.data_ptr(), n, A.k,
                n_cols)
    ell_spmm_t_cuda.launches += 1
    ell_spmm_t_cuda.by_dtype[Xt.dtype] += 1
    return Y


def bsr_spmm_t_cuda(A: BSRMatrix, Xt: torch.Tensor) -> torch.Tensor:
    """Yt = (A @ Xt.T).T by the CUDA BSR kernel, on the current stream.
    Square b x b blocks with b in ``BSR_KERNEL_BLOCKS``, f32 or f64
    (operands of one dtype), one CUDA device, contiguous Xt whose rows are
    aligned to b items (16 bytes at most: the kernel's widest load); raises
    on anything else and on a launch CUDA refuses."""
    br, bc = A.block
    if br != bc or br not in BSR_KERNEL_BLOCKS:
        raise ValueError(
            f"bsr_spmm_t_cuda: blocks {A.block}; the kernel takes square "
            f"blocks of size {BSR_KERNEL_BLOCKS} (make_engine routes others to ELL)"
        )
    _check_cuda_operands("bsr_spmm_t_cuda", A.bdata, A.bcols, Xt, A.shape[1])
    bdata_t, bcols_t = A.kernel_streams
    align = min(Xt.element_size() * br, 16)
    if Xt.data_ptr() % align or bdata_t.data_ptr() % 16:
        raise ValueError(f"bsr_spmm_t_cuda: Xt rows or blocks not aligned to {br} items")
    Y = _launch("bsr_spmm_t_launch", Xt, (Xt.shape[0], A.shape[0]), Xt.element_size(), br,
                bdata_t.data_ptr(), bcols_t.data_ptr(), A.nbr, A.bcols.shape[1],
                A.shape[1])
    bsr_spmm_t_cuda.launches += 1
    bsr_spmm_t_cuda.by_dtype[Xt.dtype] += 1
    return Y


ell_spmm_t_cuda.launches = 0
bsr_spmm_t_cuda.launches = 0
ell_spmm_t_cuda.by_dtype = collections.Counter()
bsr_spmm_t_cuda.by_dtype = collections.Counter()
