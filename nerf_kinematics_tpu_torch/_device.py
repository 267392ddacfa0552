"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU: entry points run on the card unless the caller
    asks for the CPU explicitly (``device="cpu"``, what the CPU tests pass).
    Raises when no CUDA device exists and none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly to "
                "run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
