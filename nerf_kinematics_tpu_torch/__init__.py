"""PyTorch/CUDA port of ``nerf_kinematics_tpu`` (the JAX reference package).

Same sub-package and module names as the reference so a reader finds the
counterpart (``ops/sampling.py`` <-> ``ops/sampling.py``). This package imports
``torch`` and numpy only -- never JAX, and nothing from the reference package.

Ported so far: both engines, training and rendering. The fast engine
(NGP-class, ``train/ngp_engine.py``): CP-grid encoder, fused point pipeline
and its gradients, hull occupancy proposal, the standard and the fast
full-image renderers, the train step and the trainer. The classic engine
(``train/loop.py::ClassicNerf``): ``FlexibleNeRF``, positional encoding, the
fused classic point pipeline and its gradient, merged hierarchical sampling,
NDC rays, legacy checkpoints. The blender, llff and instant-ngp loaders,
the command lines (``cli/run_nerf.py``, ``cli/ngp_run.py``,
``cli/plot_metrics.py``, ``cli/make_scene.py``), snapshots and the bench
(``python -m nerf_kinematics_tpu_torch.bench``); the synthetic scenes and
orbit poses, the hash encoder, contracted scenes and mesh export; the robot
path: the pose converter (``poses/``, ``cli/parse_poses.py``), the robot
loader (``data/robot.py``), the parallax diagnosis (``metrics/parallax.py``)
and the full pipeline (``cli/full_pipeline.py``); the other pose sources:
COLMAP import (``poses/colmap.py``, ``cli/colmap2nerf.py``), SfM with its
bundle adjustment on the device (``poses/sfm.py``, ``cli/sfm2nerf.py``) and
photometric pose refinement (``poses/refine.py``). The grid / projected
occupancy proposals and multi-GPU training come in later slices
(``ROADMAP.md``).
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
