"""Bringing up the process group, and host-local input sharding.

``initialize_multihost`` joins a ``torch.distributed`` group from an explicit
coordinator address or from the environment ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); every process then loads
the (small) pose table and may take only its slice of the images
(``host_local_slice``), and ``make_global_batch`` assembles a global batch
from each process's share.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, all_gather_rows, default_backend

TIMEOUT = timedelta(minutes=10)


def local_rank() -> int:
    """This process's index on its node (``LOCAL_RANK``, else the rank)."""
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device=None) -> bool:
    """Join the process group: True once joined (or when a group exists
    already), False for a single-process run (no coordinator and no
    ``torchrun`` environment). ``coordinator_address``: ``host:port`` of
    rank 0, with ``num_processes`` and ``process_id``. ``backend``: default
    :func:`~.mesh.default_backend` of ``device``."""
    if dist.is_initialized():
        return True
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if coordinator_address is None and not env:
        return False
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    if backend is None:
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = default_backend(device, per_node)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    return True


def _rank_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_local_slice(n_items: int) -> slice:
    """This process's contiguous slice of an ``n_items``-long dataset axis."""
    p, n = _rank_world()
    per = -(-n_items // n)
    return slice(p * per, min((p + 1) * per, n_items))


def make_global_batch(local_batch, mesh: Optional[Mesh]) -> torch.Tensor:
    """The rank-ordered concatenation of every process's ``local_batch``
    along the leading axis, on every rank (``local_batch`` alone without a
    mesh). The shards must be equal, as a global array's shards are."""
    x = local_batch if isinstance(local_batch, torch.Tensor) else torch.as_tensor(
        np.asarray(local_batch))
    if mesh is None:
        return x
    shape = torch.tensor(list(x.shape), dtype=torch.int64)
    shapes = all_gather_rows(shape[None], mesh)
    if not bool((shapes == shapes[0]).all()):
        raise ValueError(f"unequal shards across ranks: {shapes.tolist()}")
    return all_gather_rows(x, mesh)
