"""The Jacobi-CG step's vector algebra, fused, in the transposed (m, n)
layout: ``factorize/cg.py``'s path for a CUDA iterate.

Replaces no TPU kernel: the JAX package's ``factorize/cg.py`` runs the loop
as XLA operations. The kernels (``csrc/cg_step.cu``) are bound by bytes;
they keep Z and the scaled temporaries out of device memory and the step
lengths and the stop flag on the card, so a step is the operator's SpMM and
three launches, and the host reads one flag.

* ``cg_setup_reference`` / ``cg_pap_reference`` / ``cg_update_reference`` /
  ``cg_direction_reference`` — plain PyTorch, the semantics: each repeats
  ``factorize/cg.py::_cg_loop``'s arithmetic, operation for operation, so on
  the CPU their chain gives ``_cg_loop``'s bits.
* ``cg_setup_cuda`` / ``cg_pap_cuda`` / ``cg_update_cuda`` /
  ``cg_direction_cuda`` — wrappers of the kernels, each counting its
  launches in ``<wrapper>.launches``. Each elementwise operation rounds as
  the plain version's; the dots are summed in another, fixed, order, so the
  bits repeat from run to run.

An apply: setup (R = B copied, X = 0, P = Z = R d, rz, the targets, the
flag), then a step: direction from the second step on (P = Z + beta P), the
operator's AP = A P, pap (alpha), update (X, R, rz, beta, the flag). d is
the reciprocal diagonal (Jacobi) or None (Z = R); the kernels take it
contiguous. X, R and P are the apply's own contiguous tensors, updated in
place.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from dune_eigensolver_tpu_torch.utils import native

#: the iterate dtypes the kernels are instantiated for
CG_STEP_DTYPES = (torch.float32, torch.float64)
#: rows of ``CgState.vec``: the m-vectors rz, alpha, beta, the stop targets,
#: and two rows of sums the kernels use as scratch (S_SUM in the source)
RZ, ALPHA, BETA, TARGET = range(4)
SLOTS = 6


@dataclasses.dataclass
class CgState:
    """An apply's step lengths, on its device. ``vec`` (SLOTS, m) in the
    iterate's dtype, rows ``RZ``, ``ALPHA``, ``BETA``, ``TARGET``; ``ctl``
    int32 (2,): the stop flag the host reads, then the kernels' ticket;
    ``part``: the kernels' partial sums (None for the plain versions)."""

    vec: torch.Tensor
    ctl: torch.Tensor
    part: Optional[torch.Tensor] = None

    def going(self) -> bool:
        """Whether some row's residual is above its target: the one host
        read of a step."""
        return bool(self.ctl[0])


def _rowdot(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    return torch.sum((U * V).to(torch.promote_types(U.dtype, torch.float32)), dim=1)


def _precond(R: torch.Tensor, inv_diag: Optional[torch.Tensor]) -> torch.Tensor:
    return R if inv_diag is None else R * inv_diag[None, :]


def _flag(R: torch.Tensor, st: CgState) -> None:
    st.ctl[0] = torch.any(torch.sqrt(_rowdot(R, R)) > st.vec[TARGET])


def cg_setup_reference(B: torch.Tensor, inv_diag: Optional[torch.Tensor], rtol: float):
    """(X, R, P, state) of an apply on B (m, n), in plain PyTorch."""
    m, _ = B.shape
    X = torch.zeros_like(B, memory_format=torch.contiguous_format)
    R = B.clone(memory_format=torch.contiguous_format)
    P = _precond(R, inv_diag).clone(memory_format=torch.contiguous_format)
    st = CgState(vec=torch.zeros((SLOTS, m), dtype=B.dtype, device=B.device),
                 ctl=torch.zeros(2, dtype=torch.int32, device=B.device))
    st.vec[RZ] = _rowdot(R, P)
    bnorm = torch.sqrt(_rowdot(B, B))
    # rows with zero rhs are converged by definition
    st.vec[TARGET] = rtol * torch.where(bnorm > 0, bnorm, 1.0)
    _flag(R, st)
    return X, R, P, st


def cg_pap_reference(P: torch.Tensor, AP: torch.Tensor, st: CgState) -> None:
    """alpha = rz / P.AP (0 where P.AP <= 0) into ``st``."""
    pap = _rowdot(P, AP)
    st.vec[ALPHA] = torch.where(pap > 0, st.vec[RZ] / torch.where(pap > 0, pap, 1.0), 0.0)


def cg_update_reference(X, R, P, AP, inv_diag: Optional[torch.Tensor], st: CgState) -> None:
    """X += alpha P and R -= alpha AP in place; beta, rz and the flag into
    ``st``."""
    alpha = st.vec[ALPHA][:, None]
    X.copy_(X + P * alpha)
    R.copy_(R - AP * alpha)
    rz_new = _rowdot(R, _precond(R, inv_diag))
    rz = st.vec[RZ]
    st.vec[BETA] = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
    st.vec[RZ] = rz_new
    _flag(R, st)


def cg_direction_reference(R, P, inv_diag: Optional[torch.Tensor], st: CgState) -> None:
    """P = R d + beta P in place."""
    P.copy_(_precond(R, inv_diag) + P * st.vec[BETA][:, None])


def takes(B: torch.Tensor, inv_diag: Optional[torch.Tensor]) -> bool:
    """Whether the kernels take an apply on B: a non-empty 2-D CUDA tensor
    of a dtype in ``CG_STEP_DTYPES``, and ``inv_diag`` None or a vector of
    B's dtype on B's device (any other makes the plain loop's Z another
    dtype)."""
    if not (B.is_cuda and B.dtype in CG_STEP_DTYPES and B.ndim == 2 and B.numel() > 0):
        return False
    return inv_diag is None or (
        inv_diag.dtype == B.dtype and inv_diag.device == B.device
        and inv_diag.shape == B.shape[1:]
    )


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _dptr(what: str, d: Optional[torch.Tensor]) -> Optional[int]:
    """The reciprocal diagonal's address; the kernels read it contiguous."""
    if d is not None and not d.is_contiguous():
        raise ValueError(f"{what}: inv_diag of strides {d.stride()}, expected contiguous")
    return _ptr(d)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_lib = native.Launchers({
    # (value_bytes, b, b_sr, b_sc, d, x, r, p, state, part, ctl, n, m, rtol, stream)
    "cg_setup_launch": [_I, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _L, _I, ctypes.c_double,
                        _P],
    # (value_bytes, p, ap, ap_sr, ap_sc, state, part, ctl, n, m, stream)
    "cg_pap_launch": [_I, _P, _P, _L, _L, _P, _P, _P, _L, _I, _P],
    # (value_bytes, x, r, p, ap, ap_sr, ap_sc, d, state, part, ctl, n, m, stream)
    "cg_update_launch": [_I, _P, _P, _P, _P, _L, _L, _P, _P, _P, _P, _L, _I, _P],
    # (value_bytes, r, p, d, state, n, m, stream)
    "cg_direction_launch": [_I, _P, _P, _P, _P, _L, _I, _P],
    # the partial sums' room a row
    "cg_max_blocks": [],
})


def _launch(name: str, dev: torch.device, *args) -> None:
    """Run launcher ``name`` with ``args`` then the current stream; raise on
    a CUDA error."""
    lib = _lib()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    native.check(err, name)


def _check_ap(what: str, P: torch.Tensor, AP: torch.Tensor) -> None:
    if AP.shape != P.shape or AP.dtype != P.dtype or AP.device != P.device:
        raise ValueError(f"{what}: AP {tuple(AP.shape)} {AP.dtype} on {AP.device} for P "
                         f"{tuple(P.shape)} {P.dtype} on {P.device}")


def cg_setup_cuda(B: torch.Tensor, inv_diag: Optional[torch.Tensor], rtol: float):
    """``cg_setup_reference`` by the kernel, on the current stream. B keeps
    any strides; the caller's B is only read."""
    if not takes(B, inv_diag):
        raise TypeError(f"cg_setup_cuda: B {B.dtype} on {B.device}, inv_diag "
                        f"{None if inv_diag is None else (inv_diag.dtype, inv_diag.device)}")
    m, n = B.shape
    X, R, P = (torch.empty((m, n), dtype=B.dtype, device=B.device) for _ in range(3))
    st = CgState(
        vec=torch.empty((SLOTS, m), dtype=B.dtype, device=B.device),
        ctl=torch.empty(2, dtype=torch.int32, device=B.device),
        part=torch.empty(2 * m * _lib().cg_max_blocks(), dtype=B.dtype, device=B.device),
    )
    _launch("cg_setup_launch", B.device, B.element_size(), B.data_ptr(), B.stride(0),
            B.stride(1), _dptr("cg_setup_cuda", inv_diag), X.data_ptr(), R.data_ptr(),
            P.data_ptr(), st.vec.data_ptr(), st.part.data_ptr(), st.ctl.data_ptr(), n, m,
            float(rtol))
    cg_setup_cuda.launches += 1
    return X, R, P, st


def cg_pap_cuda(P: torch.Tensor, AP: torch.Tensor, st: CgState) -> None:
    """``cg_pap_reference`` by the kernel; AP keeps any strides."""
    _check_ap("cg_pap_cuda", P, AP)
    m, n = P.shape
    _launch("cg_pap_launch", P.device, P.element_size(), P.data_ptr(), AP.data_ptr(),
            AP.stride(0), AP.stride(1), st.vec.data_ptr(), st.part.data_ptr(),
            st.ctl.data_ptr(), n, m)
    cg_pap_cuda.launches += 1


def cg_update_cuda(X, R, P, AP, inv_diag: Optional[torch.Tensor], st: CgState) -> None:
    """``cg_update_reference`` by the kernel; Z stays in registers."""
    _check_ap("cg_update_cuda", P, AP)
    m, n = P.shape
    _launch("cg_update_launch", P.device, P.element_size(), X.data_ptr(), R.data_ptr(),
            P.data_ptr(), AP.data_ptr(), AP.stride(0), AP.stride(1),
            _dptr("cg_update_cuda", inv_diag), st.vec.data_ptr(), st.part.data_ptr(),
            st.ctl.data_ptr(), n, m)
    cg_update_cuda.launches += 1


def cg_direction_cuda(R, P, inv_diag: Optional[torch.Tensor], st: CgState) -> None:
    """``cg_direction_reference`` by the kernel."""
    m, n = P.shape
    _launch("cg_direction_launch", P.device, P.element_size(), R.data_ptr(), P.data_ptr(),
            _dptr("cg_direction_cuda", inv_diag), st.vec.data_ptr(), n, m)
    cg_direction_cuda.launches += 1


cg_setup_cuda.launches = 0
cg_pap_cuda.launches = 0
cg_update_cuda.launches = 0
cg_direction_cuda.launches = 0
