"""Accumulating render buffer: multi-sample accumulation and tonemapping
(instant-ngp's ``src/render_buffer.cu``: spp accumulation, tonemap before
display or save). ``accumulate`` averages successive stochastic renders of
one view (different sample jitters); ``tonemap`` maps linear radiance to
display sRGB.

Counterpart of ``nerf_kinematics_tpu/rendering/render_buffer.py``: the same
functional buffer, as a tuple of tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RenderBuffer(NamedTuple):
    accum: torch.Tensor  # (H, W, 3) running sum of linear radiance
    spp: torch.Tensor  # int32 scalar: samples accumulated

    @property
    def resolved(self) -> torch.Tensor:
        return self.accum / torch.clamp(self.spp, min=1)


def new_buffer(h: int, w: int, device=None) -> RenderBuffer:
    return RenderBuffer(torch.zeros((h, w, 3), dtype=torch.float32, device=device),
                        torch.zeros((), dtype=torch.int32, device=device))


def accumulate(buf: RenderBuffer, frame: torch.Tensor) -> RenderBuffer:
    return RenderBuffer(buf.accum + frame, buf.spp + 1)


def tonemap(linear: torch.Tensor, exposure: float = 0.0, srgb: bool = True) -> torch.Tensor:
    """Exposure and the sRGB transfer; clamps to [0, 1]."""
    x = linear * (2.0**exposure)
    if srgb:
        x = torch.where(
            x <= 0.0031308, 12.92 * x,
            1.055 * torch.pow(torch.clamp(x, min=1e-8), 1 / 2.4) - 0.055)
    return torch.clamp(x, 0.0, 1.0)
