"""PyTorch/CUDA port of ``nerf_kinematics_tpu`` (the JAX reference package).

Same sub-package and module names as the reference so a reader finds the
counterpart (``ops/sampling.py`` <-> ``ops/sampling.py``). This package imports
``torch`` and numpy only -- never JAX, and nothing from the reference package.

Ported so far: the fast-engine (NGP-class) serving path -- config, weights
bridge, CP-grid encoder, fused point pipeline, hull occupancy proposal,
samplers, compositing, the standard and the fast full-image renderers and the
inference half of ``NGPEngine``. Training is ported in a later slice.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
