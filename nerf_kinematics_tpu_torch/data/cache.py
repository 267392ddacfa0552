"""Dataset caching (the ``dataset.cachedir`` knob): the decoded dataset
(images, poses, intrinsics, splits) as one ``.npz``, so that repeated runs
skip decoding and resizing. Rays are generated on the device by the train
step, so no ray cache is kept.

Same file and key as ``nerf_kinematics_tpu/data/cache.py``: a cache written
by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np

from .types import Intrinsics, NerfDataset


def _cache_key(cfg, extra=None) -> str:
    d = dataclasses.asdict(cfg)
    if extra:
        d["__extra__"] = extra
    payload = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def cache_path(cfg, extra=None) -> Optional[str]:
    """Cache file for cfg; ``extra`` folds loader kwargs that affect decoded
    pixels (e.g. white_background) into the key."""
    cachedir = getattr(cfg, "cachedir", None)
    if not cachedir:
        return None
    return os.path.join(cachedir, f"dataset_{_cache_key(cfg, extra)}.npz")


def save_cached(path: str, ds: NerfDataset) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path,
        images=ds.images,
        poses=ds.poses,
        intrinsics=np.array(
            [ds.intrinsics.fl_x, ds.intrinsics.fl_y, ds.intrinsics.cx,
             ds.intrinsics.cy, ds.intrinsics.width, ds.intrinsics.height,
             ds.intrinsics.k1, ds.intrinsics.k2, ds.intrinsics.p1,
             ds.intrinsics.p2]
        ),
        near=ds.near,
        far=ds.far,
        train_idx=ds.train_idx,
        val_idx=ds.val_idx,
        test_idx=ds.test_idx,
        render_poses=ds.render_poses if ds.render_poses is not None else np.zeros(0),
        use_ndc=ds.use_ndc,
        aabb_scale=ds.aabb_scale,
    )


def load_cached(path: str) -> Optional[NerfDataset]:
    if not os.path.isfile(path):
        return None
    try:
        z = np.load(path, allow_pickle=False)
        intr = z["intrinsics"]
        rp = z["render_poses"]
        return NerfDataset(
            images=z["images"],
            poses=z["poses"],
            intrinsics=Intrinsics(
                float(intr[0]), float(intr[1]), float(intr[2]), float(intr[3]),
                int(intr[4]), int(intr[5]),
                # Older caches predate the distortion fields (length 6).
                *(float(v) for v in intr[6:10]),
            ),
            near=float(z["near"]),
            far=float(z["far"]),
            train_idx=z["train_idx"],
            val_idx=z["val_idx"],
            test_idx=z["test_idx"],
            render_poses=rp if rp.size else None,
            use_ndc=bool(z["use_ndc"]),
            aabb_scale=float(z["aabb_scale"]),
        )
    except (OSError, KeyError, ValueError):
        return None
