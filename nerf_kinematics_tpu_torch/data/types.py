"""Camera intrinsics container shared by the renderers."""

from __future__ import annotations

from dataclasses import dataclass


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
