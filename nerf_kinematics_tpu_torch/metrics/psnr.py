"""PSNR metrics: float images in [0, 1] (PSNR = -10 log10(MSE)) and uint8
images (peak 255)."""

from __future__ import annotations

import numpy as np
import torch


def mse_to_psnr(mse, max_val: float = 1.0):
    mse = torch.as_tensor(mse, dtype=torch.float32)
    return 20.0 * float(np.log10(max_val)) - 10.0 * torch.log10(
        torch.clamp(mse, min=1e-12)
    )


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def psnr(pred, target, max_val: float = 1.0) -> float:
    """PSNR between two images/arrays of the same shape and scale."""
    pred, target = _np(pred), _np(target)
    if pred.shape != target.shape:
        raise ValueError(f"shape mismatch {pred.shape} vs {target.shape}")
    mse = float(np.mean((pred - target) ** 2))
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(max_val) - 10.0 * np.log10(mse))


def psnr_uint8(pred, target) -> float:
    """uint8 pixels, peak 255."""
    return psnr(pred, target, max_val=255.0)
