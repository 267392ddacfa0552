"""Camera intrinsics and the dataset container shared by the renderers and
the trainer."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Intrinsics:
    fl_x: float
    fl_y: float
    cx: float
    cy: float
    width: int
    height: int
    # OpenCV lens distortion (radial k1/k2, tangential p1/p2).
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @property
    def focal(self) -> float:
        return self.fl_x

    @property
    def distortion(self):
        """(k1, k2, p1, p2) if any is nonzero, else None: ray generators
        skip the iterative undistortion for the common pinhole case."""
        d = (self.k1, self.k2, self.p1, self.p2)
        return d if any(d) else None

    def scaled(self, factor: float) -> "Intrinsics":
        """Intrinsics after resizing the image by 1/factor. Distortion acts
        on normalized coordinates, so its coefficients do not change."""
        return Intrinsics(
            fl_x=self.fl_x / factor,
            fl_y=self.fl_y / factor,
            cx=self.cx / factor,
            cy=self.cy / factor,
            width=int(self.width / factor),
            height=int(self.height / factor),
            k1=self.k1, k2=self.k2, p1=self.p1, p2=self.p2,
        )


@dataclass
class NerfDataset:
    """Images + poses + intrinsics + split indices, ready for upload.

    images: (N, H, W, 3) float32 in [0, 1] (alpha pre-composited).
    poses:  (N, 4, 4) float32 camera-to-world, OpenGL convention.
    """

    images: np.ndarray
    poses: np.ndarray
    intrinsics: Intrinsics
    near: float
    far: float
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    render_poses: Optional[np.ndarray] = None  # novel-view path (video orbits)
    use_ndc: bool = False
    aabb_scale: float = 1.0

    @property
    def H(self) -> int:
        return self.images.shape[1]

    @property
    def W(self) -> int:
        return self.images.shape[2]

    def split(self, name: str):
        idx = {"train": self.train_idx, "val": self.val_idx, "test": self.test_idx}[name]
        return self.images[idx], self.poses[idx]


def dataset_from_arrays(images, poses, intrinsics: Intrinsics, near: float,
                        far: float, n_val: int = 1,
                        aabb_scale: float = 1.0) -> NerfDataset:
    """An in-memory dataset: the last ``n_val`` views are held out for
    validation, the rest train. ``images`` (N, H, W, 3) and ``poses``
    (N, 4, 4) may be numpy arrays or tensors."""
    to_np = lambda a: np.asarray(
        a.detach().cpu().numpy() if hasattr(a, "detach") else a, np.float32)
    images, poses = to_np(images), to_np(poses)
    n = images.shape[0]
    if not 0 <= n_val < n:
        raise ValueError(f"n_val={n_val} must leave at least one of {n} views")
    if images.shape[1:3] != (intrinsics.height, intrinsics.width):
        raise ValueError("image size does not match the intrinsics")
    idx = np.arange(n, dtype=np.int64)
    return NerfDataset(
        images=images, poses=poses, intrinsics=intrinsics, near=float(near),
        far=float(far), train_idx=idx[: n - n_val], val_idx=idx[n - n_val :],
        aabb_scale=float(aabb_scale),
    )
