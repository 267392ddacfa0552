"""The data axis over the ranks of a ``torch.distributed`` process group, and
the collectives the train step and the frame-batch renderer use.

``gloo`` collectives run on CPU copies (gloo gathers no CUDA tensors); NCCL's
on the tensors' own device. Every collective is called by every rank in the
same order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the data axis (``DATA_AXIS``, the only one):
    ``rank`` of ``world``, its
    ``device``, the group's ``backend`` and ``group`` (None: the default
    group)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any = None

    @property
    def is_main(self) -> bool:
        """The rank that writes logs, checkpoints, renders and videos."""
        return self.rank == 0


def default_backend(device=None, nproc_per_node: int = 1) -> str:
    """``nccl`` when each rank has a GPU of its own, ``gloo`` when the ranks
    share a device or run on the CPU (NCCL refuses two ranks on one GPU)."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return "gloo"
    if not torch.cuda.is_available() or torch.cuda.device_count() < nproc_per_node:
        return "gloo"
    return "nccl"


def make_mesh(device=None) -> Optional[Mesh]:
    """The data axis over the initialized default process group, or None
    (the single-device path) when no group exists or its world is 1.
    ``device``: this rank's device (default: the current CUDA device under
    NCCL, else the CPU)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    if world < 2:
        return None
    backend = str(dist.get_backend())
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    return Mesh(rank=dist.get_rank(), world=world, device=torch.device(device),
                backend=backend)


def shard_slice(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous rows of ``n``; ``n`` must split evenly."""
    if n % mesh.world:
        raise ValueError(f"{n} rows do not split over {mesh.world} ranks")
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(x, mesh: Optional[Mesh]):
    """This rank's contiguous rows of a global batch (leading axis); ``x``
    unchanged when ``mesh`` is None."""
    if mesh is None or x is None:
        return x
    return x[shard_slice(x.shape[0], mesh)]


def _staged(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x.detach().cpu() if mesh.backend == "gloo" else x.detach().contiguous()


def all_reduce_mean(flat: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean over the ranks of ``flat`` (every rank's the same shape),
    as a new tensor on ``flat``'s device; ``flat`` itself without a mesh."""
    if mesh is None:
        return flat
    buf = _staged(flat, mesh).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(flat.device).div_(mesh.world)


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the leading axis in rank order
    (equal shapes), on ``x``'s device; ``x`` itself without a mesh."""
    if mesh is None:
        return x
    src = _staged(x, mesh).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(x.device)


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (nothing without a mesh)."""
    if mesh is not None:
        if mesh.backend == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index or 0])
        else:
            dist.barrier(group=mesh.group)
