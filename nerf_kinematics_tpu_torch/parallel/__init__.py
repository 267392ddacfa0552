"""Parallelism: data parallelism over the ray batch with ``torch.distributed``.

Every rank holds the whole model and training state (replicated), draws the
global ray batch and the global random draws from the same generator, and
computes its contiguous share of the rays (``shard_batch``); the flat
gradient and the loss metrics are averaged over the ranks once a step
(``all_reduce_mean``) before the optimizer, so N ranks take the step one
device takes. Serving splits the frame axis (``all_gather_rows``).
"""

from .mesh import (
    DATA_AXIS,
    Mesh,
    all_gather_rows,
    all_reduce_mean,
    barrier,
    default_backend,
    make_mesh,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "make_mesh",
    "shard_batch",
    "all_reduce_mean",
    "all_gather_rows",
    "barrier",
    "default_backend",
]
