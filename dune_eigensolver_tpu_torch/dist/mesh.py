"""Process groups for row-partitioned execution.

Counterpart of the JAX package's ``dist/mesh.py``. There a 1D device mesh
carries a ``shard_map`` that runs the whole solve as one program in one
process. Here the solve runs SPMD on ``torch.distributed``: one process per
rank, every rank calling the same driver on the same global operand and
taking its own rows. The mesh is a small handle on a process group: its
ranks, this process's place in it, and the device its tensors live on.

Backends follow the device: CUDA tensors go over NCCL, CPU tensors over
gloo. Nothing falls back: a CUDA tensor handed to a gloo group, or a CPU
tensor to an NCCL group, raises (``check_device``), and a failed NCCL
start raises from ``init_process_group`` itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from dune_eigensolver_tpu_torch.utils.device import resolve

ROW_AXIS = "rows"

#: the backend that carries each device type's tensors
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(device=None, **kw) -> torch.device:
    """Start the default process group (wraps ``init_process_group``) with
    the backend of ``device``: NCCL for a CUDA device, gloo for the CPU.
    ``device=None`` is the current CUDA device and raises without one
    (``utils/device.py::resolve``). ``kw`` goes to ``init_process_group``
    (``init_method``/``store``, ``world_size``, ``rank``, ``timeout``).
    Under NCCL the communicator is built here (``device_id``), so a failed
    start raises now instead of at the first collective. Returns the
    device."""
    device = resolve(device)
    backend = _BACKEND.get(device.type)
    if backend is None:
        raise ValueError(f"init_distributed: no backend for device {device}")
    if backend == "nccl":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        kw.setdefault("device_id", device)
    dist.init_process_group(backend=backend, **kw)
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1D row mesh (JAX's axis ``ROW_AXIS``): ``size`` ranks (global
    ranks ``ranks``) of the process group ``group`` (``None``: the default
    group), this process its ``rank``-th member (-1 when it is not a
    member), tensors on ``device``."""

    group: Optional[object]
    ranks: Tuple[int, ...]
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def member(self) -> bool:
        return self.rank >= 0


def _group_device(group) -> torch.device:
    backend = dist.get_backend(group)
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"make_mesh: backend {backend!r} is neither nccl nor gloo")


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1D mesh over the first ``n_devices`` ranks of the default group
    (all of them by default). Row partitioning: the matrix and multivector
    rows split, the m (RHS) dimension stays local, so every Gram is a local
    product and one ``all_reduce``.

    A mesh smaller than the world is a new group (``dist.new_group``), so
    every rank of the world must call ``make_mesh`` with the same
    ``n_devices``; ranks outside it get a mesh with ``member`` False. Asked
    for more ranks than the world holds, raises ``ValueError`` (JAX
    ``mesh.py:28-38``); with no process group, ``RuntimeError``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call init_distributed (or "
            "torch.distributed.init_process_group) first"
        )
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(
            f"make_mesh: requested {n_devices} ranks but only {world} are in "
            f"the process group (backend {dist.get_backend()!r})"
        )
    if n_devices < 1:
        raise ValueError(f"make_mesh: requested {n_devices} ranks")
    me = dist.get_rank()
    ranks = tuple(range(n_devices))
    group = None if n_devices == world else dist.new_group(list(ranks))
    return Mesh(group=group, ranks=ranks, rank=ranks.index(me) if me in ranks else -1,
                device=_group_device(None))


def check_device(mesh: Mesh, device, what: str) -> None:
    """Raise unless ``device``'s tensors are what the mesh's backend
    carries (CUDA on NCCL, CPU on gloo) and the mesh holds this process."""
    device = torch.device(device)
    if not mesh.member:
        raise ValueError(f"{what}: this process (rank {dist.get_rank()}) is not in the mesh")
    backend = dist.get_backend(mesh.group)
    if _BACKEND.get(device.type) != backend:
        raise ValueError(
            f"{what}: tensors on {device} cannot go over a {backend} group "
            f"(CUDA tensors need nccl, CPU tensors gloo; there is no fallback)"
        )
