"""Per-frame sharpness scoring: variance of the 3x3 Laplacian.

Reference semantics: parser_instant_ngp.py:49-60 — grayscale image filtered
with the [0,1,0;1,-4,1;0,1,0] kernel through PIL (whose 'L'-mode kernel filter
clamps results to [0, 255]), then the variance of the filtered image.

Counterpart of ``nerf_kinematics_tpu/poses/sharpness.py``, which calls
Pillow. Here the image is decoded by ``io/image.py::read_image_u8`` (the
port's own PNG codec; anything else through a Pillow imported there), taken
to gray with Pillow's integer formula for ``convert("L")`` and filtered as
``ImageFilter.Kernel`` filters: the same bits as Pillow, without it for PNG.
"""

from __future__ import annotations

import numpy as np

from ..io.image import read_image_u8


def to_gray_u8(img: np.ndarray) -> np.ndarray:
    """(H, W[, C]) uint8 -> (H, W) uint8 as Pillow's ``convert("L")``: RGB(A)
    by L = (19595 R + 38470 G + 7471 B + 2^15) >> 16, alpha ignored; gray
    (+ alpha) keeps its gray channel."""
    img = np.asarray(img)
    if img.ndim == 2:
        return img
    if img.shape[2] in (1, 2):
        return img[:, :, 0]
    rgb = img[:, :, :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def compute_sharpness(image_path) -> float:
    """Sharpness score = variance of the clamped 3x3 Laplacian of the
    grayscale image."""
    return compute_sharpness_array(to_gray_u8(read_image_u8(str(image_path))))


def compute_sharpness_array(gray: np.ndarray) -> float:
    """Pure-numpy equivalent for in-memory grayscale uint8 arrays (used by
    tests and batch pipelines). Matches PIL semantics: interior-only 3x3
    convolution with edge rows/cols passed through unchanged, result clamped
    to [0, 255]."""
    g = gray.astype(np.float64)
    out = g.copy()
    interior = (
        g[:-2, 1:-1] + g[2:, 1:-1] + g[1:-1, :-2] + g[1:-1, 2:] - 4.0 * g[1:-1, 1:-1]
    )
    out[1:-1, 1:-1] = interior
    return float(np.clip(np.round(out), 0, 255).var())
