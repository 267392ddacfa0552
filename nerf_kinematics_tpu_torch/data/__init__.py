"""Dataset loaders, keyed by the config's ``dataset.type``: ``blender``
(nerf_synthetic layout), ``llff`` (forward-facing, NDC), ``ngp``
(instant-ngp transforms.json), ``robot`` (a forward-kinematics capture:
``poses.txt`` and indexed images) and ``synthetic`` (the procedural sphere,
rendered on the given device).

Counterpart of ``nerf_kinematics_tpu/data/__init__.py``.
"""

from .blender import load_blender
from .llff import load_llff
from .ngp_transforms import load_ngp_transforms
from .robot import load_robot
from .synthetic import make_synthetic_scene
from .types import NerfDataset


LOADERS = {
    "blender": load_blender,
    "llff": load_llff,
    "ngp": load_ngp_transforms,
    "robot": load_robot,
    "synthetic": make_synthetic_scene,
}


def load_dataset(cfg, *, white_background: bool = False, device=None) -> NerfDataset:
    """Load the dataset a ``DatasetConfig`` describes, through
    ``cfg.cachedir`` when it is set. ``white_background`` is the train
    settings' flag (``nerf.train.white_background``): blender RGBA ground
    truth is composited onto white when it is set, as the renderer
    composites. ``device`` is where the ``synthetic`` scene is rendered
    (``None``: the GPU); the loaders from disk read on the host."""
    if cfg.type not in LOADERS:
        raise ValueError(f"unknown dataset type {cfg.type!r}; have {sorted(LOADERS)}")
    from .cache import cache_path, load_cached, save_cached

    kwargs = {"white_background": white_background} if cfg.type == "blender" else {}
    path = cache_path(cfg, extra=kwargs or None)
    if path is not None:
        cached = load_cached(path)
        if cached is not None:
            return cached
    ds = LOADERS[cfg.type](cfg, **kwargs, device=device)
    if path is not None:
        save_cached(path, ds)
    return ds


__all__ = ["NerfDataset", "LOADERS", "load_dataset", "load_blender", "load_llff",
           "load_ngp_transforms", "load_robot", "make_synthetic_scene"]
