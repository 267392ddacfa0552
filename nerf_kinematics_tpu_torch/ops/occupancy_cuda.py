"""Visual-hull occupancy lookup: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``nerf_kinematics_tpu/ops/occupancy_pallas.py::
occupancy_at_hull_pallas``. Kernel source: ``csrc/occupancy_hull.cu``.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import cuda_lib


def occupancy_at_hull_cuda_ref(proj2: torch.Tensor,
                               xt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``min(Pxy[x,y], Pxz[x,z], Pyz[y,z])`` at cell
    ``floor(clip(u*R, 0, R-1))``, the projections rounded to bf16. A pair
    that reads a NaN coordinate is 0, as in the reference, whose one-hot row
    of a NaN matches no cell; the cell of a NaN is taken at 0 so that no
    index is made from it. +-inf clamp to the end cells."""
    R = proj2.shape[-1]
    u = xt * float(R)
    nan = torch.isnan(u)
    u = torch.where(nan, torch.zeros_like(u), u)
    idx = torch.floor(torch.clamp(u, 0.0, float(R - 1))).to(torch.int64)
    ix, iy, iz = idx[0], idx[1], idx[2]
    nx, ny, nz = nan[0], nan[1], nan[2]
    p2 = proj2.to(torch.bfloat16).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=xt.device)
    a = torch.where(nx | ny, zero, p2[0][ix, iy])
    b = torch.where(nx | nz, zero, p2[1][ix, iz])
    c = torch.where(ny | nz, zero, p2[2][iy, iz])
    return torch.minimum(a, torch.minimum(b, c))


def occupancy_at_hull_cuda(proj2: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """``proj2``: (3, R, R) pair-projections; ``xt``: (3, N) unit coords.
    Returns (N,) hull occupancy. A CUDA tensor goes through the kernel; a
    CPU tensor through the plain version."""
    if not xt.is_cuda:
        return occupancy_at_hull_cuda_ref(proj2, xt)
    sp = profiling.begin("launch.occupancy_at_hull")
    R = proj2.shape[-1]
    cuda_lib.check_tensor(xt, "xt", (3, None))
    cuda_lib.check_tensor(proj2, "proj2", (3, R, R), xt.device)
    n = xt.shape[1]
    sc = profiling.begin("launch.scratch")
    out = torch.empty((n,), dtype=torch.float32, device=xt.device)
    profiling.end(sc)
    if not n:
        profiling.end(sp)
        return out
    lib = cuda_lib.load_library()
    call = profiling.begin("launch.call")
    code = lib.nkt_occupancy_at_hull(
        xt.data_ptr(), proj2.data_ptr(), out.data_ptr(), n, R,
        cuda_lib.sm_count(xt.device), cuda_lib.current_stream(xt.device),
    )
    profiling.end(call)
    cuda_lib.launched(sp, "occupancy_at_hull", "kernel", n)
    cuda_lib.raise_on_error(
        code, "occupancy_at_hull",
        f"R = {R}: the kernel holds the three projections in bf16 in a "
        "block's shared memory, which takes R <= 196")
    return out
