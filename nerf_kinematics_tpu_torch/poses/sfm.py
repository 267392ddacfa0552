"""Minimal incremental structure-from-motion: COLMAP-free pose recovery.

A self-contained incremental SfM that recovers camera poses for an
unordered or video image set with cv2 feature matching and a bundle
adjustment written in PyTorch (the optimisation COLMAP hands to ceres),
which runs on the device (``device=None``: the GPU).

Pipeline (classic incremental SfM, sized for O(50)-image captures like the
fox49 set):
  1. SIFT features on downscaled images; ratio-test matching over a
     sliding window of neighbouring frames (video ordering) plus a few
     long-range pairs for loop closure.
  2. Focal self-calibration: reconstruct a small subset at each of a few
     FOV candidates, keep the one that reprojects best after a short
     fixed-focal bundle adjustment (the global one refines it).
  3. Initial pair: most matches with enough parallax → recoverPose →
     triangulate.
  4. Incremental registration: next image = most 2D-3D correspondences →
     solvePnPRansac → triangulate newly-covered tracks (multi-view DLT).
  5. Global bundle adjustment: axis-angle cameras + points + shared
     log-focal, Huber reprojection loss, Adam with optax's defaults over a
     cosine-decayed rate, a fixed iteration budget. Gauge fixed by freezing
     camera 0.

Outputs world→camera extrinsics in the same convention as COLMAP's
images.txt, so the reorientation/export path of ``poses/colmap.py``
(``colmap_pose_to_c2w`` + up-vector / center-of-attention normalization)
converts them into instant-ngp transforms.json frames.

Counterpart of ``nerf_kinematics_tpu/poses/sfm.py``: the front-end is the
same numpy + cv2 code (cv2 imported at call time; the bundle adjustment
does not need it), ``bundle_adjust`` the same loss, gauge and optimiser in
f32 with numpy float64 arrays in and out.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..train.loop import CLASSIC_ADAM, AdamState, adam_update



# ---------------------------------------------------------------------------
# Front-end: features + matching
# ---------------------------------------------------------------------------

def _cv2():
    """cv2, imported at call time: it is an optional dependency of the
    front-end only (the bundle adjustment does not need it)."""
    try:
        import cv2
    except Exception as e:
        raise RuntimeError(
            "opencv (cv2) is required for the SfM front-end; it was not "
            "importable in this environment"
        ) from e
    return cv2


def _load_gray(path: str, max_dim: int) -> Tuple[np.ndarray, float]:
    """Grayscale image downscaled so max(H, W) <= max_dim; returns the
    inverse scale (multiply detected coords by it → original pixels)."""
    cv2 = _cv2()
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    h, w = img.shape
    s = max(h, w) / float(max_dim)
    if s > 1.0:
        img = cv2.resize(img, (int(round(w / s)), int(round(h / s))),
                         interpolation=cv2.INTER_AREA)
        return img, s
    return img, 1.0


def detect_features(
    paths: Sequence[str], max_dim: int = 1024, n_features: int = 4096
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """SIFT keypoints (original-resolution pixel coords) + descriptors."""
    cv2 = _cv2()
    sift = cv2.SIFT_create(nfeatures=n_features)
    kps, descs = [], []
    for p in paths:
        img, s = _load_gray(p, max_dim)
        kp, de = sift.detectAndCompute(img, None)
        if de is None:
            kp, de = [], np.zeros((0, 128), np.float32)
        pts = np.array([k.pt for k in kp], np.float64).reshape(-1, 2) * s
        kps.append(pts)
        descs.append(de)
    return kps, descs


def match_pair(
    d1: np.ndarray, d2: np.ndarray, ratio: float = 0.75
) -> Tuple[np.ndarray, np.ndarray]:
    """Lowe-ratio kNN matching → (idx1, idx2) arrays."""
    cv2 = _cv2()
    if len(d1) < 2 or len(d2) < 2:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    bf = cv2.BFMatcher(cv2.NORM_L2)
    knn = bf.knnMatch(d1, d2, k=2)
    i1, i2 = [], []
    for pair in knn:
        if len(pair) == 2 and pair[0].distance < ratio * pair[1].distance:
            i1.append(pair[0].queryIdx)
            i2.append(pair[0].trainIdx)
    return np.asarray(i1, np.int64), np.asarray(i2, np.int64)


def build_pairs(n: int, window: int = 6, long_range_stride: int = 10):
    """Frame pairs to match: sliding window (video ordering) + coarse
    long-range pairs for loop closure."""
    pairs = [(i, j) for i in range(n) for j in range(i + 1, min(i + 1 + window, n))]
    for i in range(0, n, long_range_stride):
        for j in range(i + window + 1, n, long_range_stride):
            pairs.append((i, j))
    return sorted(set(pairs))


# ---------------------------------------------------------------------------
# Track graph (union-find over per-image features)
# ---------------------------------------------------------------------------

class _UnionFind:
    def __init__(self):
        self.parent: Dict[tuple, tuple] = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        if p != x:
            p = self.parent[x] = self.find(p)
        return p

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_tracks(
    matches: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]]
) -> List[Dict[int, int]]:
    """Merge pairwise matches into tracks: each track maps img → feature
    index. Tracks observing an image twice (contradiction) are dropped."""
    uf = _UnionFind()
    for (i, j), (ii, jj) in matches.items():
        for a, b in zip(ii, jj):
            uf.union((i, int(a)), (j, int(b)))
    groups: Dict[tuple, Dict[int, int]] = {}
    bad = set()
    for node in list(uf.parent):
        root = uf.find(node)
        g = groups.setdefault(root, {})
        img, feat = node
        if img in g and g[img] != feat:
            bad.add(root)
        g[img] = feat
    return [g for r, g in groups.items() if r not in bad and len(g) >= 2]


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------

def _K(focal: float, w: int, h: int) -> np.ndarray:
    return np.array(
        [[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]], np.float64
    )


def triangulate_dlt(
    Ps: Sequence[np.ndarray], uvs: Sequence[np.ndarray]
) -> np.ndarray:
    """Multi-view DLT: X minimizing sum of algebraic errors over all
    observations (Ps: 3x4 projection matrices, uvs: pixel coords)."""
    A = []
    for P, uv in zip(Ps, uvs):
        A.append(uv[0] * P[2] - P[0])
        A.append(uv[1] * P[2] - P[1])
    _, _, vt = np.linalg.svd(np.asarray(A))
    X = vt[-1]
    return X[:3] / X[3]


def _reproj_err(P: np.ndarray, X: np.ndarray, uv: np.ndarray) -> float:
    x = P @ np.append(X, 1.0)
    if x[2] <= 1e-9:
        return np.inf
    return float(np.linalg.norm(x[:2] / x[2] - uv))


# ---------------------------------------------------------------------------
# Bundle adjustment (PyTorch, on the device)
# ---------------------------------------------------------------------------

def _rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (N, 3) -> rotation matrices (N, 3, 3)."""
    # Smooth norm: sqrt(|r|^2 + eps) keeps the gradient finite at theta = 0
    # (the gauge camera's rotvec is exactly zero; d|x|/dx is NaN there).
    theta = torch.sqrt(torch.sum(rvec**2, dim=-1, keepdim=True) + 1e-16)
    k = rvec / theta
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    K = torch.stack([
        torch.stack([zero, -kz, ky], -1),
        torch.stack([kz, zero, -kx], -1),
        torch.stack([-ky, kx, zero], -1),
    ], -2)
    t = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)


def cosine_decay_lr(lr: float, iters: int, count, alpha: float = 0.01) -> torch.Tensor:
    """``optax.cosine_decay_schedule(lr, iters, alpha)`` at ``count`` (an
    integer tensor), in f32 as optax computes it."""
    c = torch.clamp(count.to(torch.float32), max=float(iters))
    cosine = 0.5 * (1.0 + torch.cos(math.pi * c / float(iters)))
    return lr * ((1.0 - alpha) * cosine + alpha)


def _replay(step, iters: int, state) -> None:
    """``iters`` calls of ``step`` on the GPU as replays of one CUDA graph
    (an iteration is about a hundred small launches). The graph is captured
    after three warm-up calls on a side stream, as capture requires;
    ``state`` (every tensor ``step`` changes in place) is put back after
    them, so the replays start from where the caller left it."""
    saved = [t.detach().clone() for t in state]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    with torch.no_grad():
        for t, v in zip(state, saved):
            t.copy_(v)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    with torch.no_grad():
        for t, v in zip(state, saved):
            t.copy_(v)
    for _ in range(iters):
        graph.replay()


def bundle_adjust(
    rvecs: np.ndarray,
    tvecs: np.ndarray,
    points: np.ndarray,
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    uv: np.ndarray,
    focal: float,
    cx: float,
    cy: float,
    iters: int = 2000,
    lr: float = 1e-3,
    huber_delta: float = 3.0,
    optimize_focal: bool = True,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float, float]:
    """Joint refinement of cameras, points, and (optionally) the shared
    focal length: Huber reprojection loss, Adam with optax's defaults
    (``train/loop.py``'s, as the classic engine takes it) over a
    cosine-decayed learning rate, ``iters`` steps on ``device`` (None: the
    GPU) in f32.

    Gauge: camera 0 is frozen (its gradient is masked), pinning the global
    rotation/translation; overall scale is left free -- the exporter
    normalizes scale anyway (target_avg_distance).

    Returns (rvecs, tvecs, points, focal, final_mean_reproj_px), numpy
    float64 as given.
    """
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    params = [
        torch.tensor(np.asarray(rvecs), **f32),
        torch.tensor(np.asarray(tvecs), **f32),
        torch.tensor(np.asarray(points), **f32),
        torch.tensor([np.log(focal)], **f32),
    ]
    for p in params:
        p.requires_grad_(True)
    ci = torch.as_tensor(np.asarray(cam_idx), dtype=torch.long, device=dev)
    pi = torch.as_tensor(np.asarray(pt_idx), dtype=torch.long, device=dev)
    obs = torch.tensor(np.asarray(uv), **f32)

    def residuals(r, t, X, lf):
        # index_select: its gradient is one index_add, where an indexing
        # expression's sorts the indices first
        R = _rodrigues(r).index_select(0, ci)             # (K, 3, 3)
        Xk = X.index_select(0, pi)                          # (K, 3)
        xc = (R * Xk[:, None, :]).sum(-1) + t.index_select(0, ci)  # camera frame
        z = torch.clamp(xc[:, 2], min=1e-6)
        f = torch.exp(lf[0])
        u = f * xc[:, 0] / z + cx
        v = f * xc[:, 1] / z + cy
        return torch.stack([u, v], -1) - obs

    def loss_fn(*p):
        r = residuals(*p)
        # Smooth distance (gradient of an exact norm is NaN at 0, which a
        # perfectly-fit observation reaches); Huber: quadratic core, linear
        # tail (robust to residual outliers).
        d = torch.sqrt(torch.sum(r**2, dim=-1) + 1e-12)
        quad = 0.5 * d**2
        lin = huber_delta * (d - 0.5 * huber_delta)
        return torch.mean(torch.where(d <= huber_delta, quad, lin))

    # The gauge: camera 0's rotation and translation, and the focal unless
    # it is optimised, get no gradient.
    keep = [torch.ones_like(p) for p in params]
    keep[0][0] = 0.0
    keep[1][0] = 0.0
    if not optimize_focal:
        keep[3].zero_()
    # Cosine-decayed Adam: large early steps to move cameras, fine late
    # steps to polish sub-pixel reprojection. The step counts live on the
    # device: an iteration reads nothing back from it.
    opts = [AdamState(torch.zeros_like(p), torch.zeros_like(p),
                      torch.zeros((), dtype=torch.long, device=dev)) for p in params]

    def schedule(count):
        return cosine_decay_lr(lr, iters, count)

    def step():
        loss = loss_fn(*params)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g, k, opt in zip(params, grads, keep, opts):
                adam_update(p, g * k, opt, schedule, None, CLASSIC_ADAM)

    if dev.type == "cuda" and iters > 0:
        _replay(step, iters, params + [t for o in opts for t in (o.mu, o.nu, o.count)])
    else:
        for _ in range(iters):
            step()

    with torch.no_grad():
        res = residuals(*params).cpu().numpy()
    r, t, X = (p.detach().cpu().numpy().astype(np.float64) for p in params[:3])
    f = float(np.exp(params[3].detach().cpu().numpy())[0])
    mean_px = float(np.linalg.norm(res, axis=-1).mean())
    return r, t, X, f, mean_px


# ---------------------------------------------------------------------------
# Incremental reconstruction
# ---------------------------------------------------------------------------

@dataclass
class SfmResult:
    """world→camera extrinsics per registered image (COLMAP convention:
    x_cam = R @ X + t), shared pinhole intrinsics, sparse points."""

    image_names: List[str]
    registered: List[int]                 # indices into image_names
    R: np.ndarray                         # (N, 3, 3) for registered order
    t: np.ndarray                         # (N, 3)
    focal: float
    width: int
    height: int
    points: np.ndarray                    # (M, 3)
    mean_reproj_px: float
    track_lengths: np.ndarray = field(default_factory=lambda: np.zeros(0))

    def c2w(self) -> np.ndarray:
        """(N, 4, 4) camera→world in NeRF/instant-ngp axes (via the same
        conversion as COLMAP imports — poses/colmap.py)."""
        out = np.zeros((len(self.R), 4, 4))
        for i, (R, t) in enumerate(zip(self.R, self.t)):
            c2w = np.eye(4)
            c2w[:3, :3] = R.T
            c2w[:3, 3] = -R.T @ t
            c2w[:3, 1:3] *= -1.0
            out[i] = c2w
        return out


def _rotvec_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → axis-angle via cv2.Rodrigues."""
    cv2 = _cv2()
    rv, _ = cv2.Rodrigues(np.ascontiguousarray(R))
    return rv.reshape(3)


def _pick_focal(
    kps, matches, tracks, obs_of, w, h,
    fov_candidates: Sequence[float],
    min_pnp_points: int,
    reproj_px: float,
    verbose: bool = False,
    device=None,
) -> float:
    """Self-calibration by MULTI-view consistency: two views fit almost any
    focal (the calibrated-E inlier count barely discriminates), but a
    3+-view reconstruction at the wrong focal cannot reproject consistently.
    For each candidate FOV: reconstruct a small image subset, run a short
    fixed-focal bundle adjustment, and score by mean reprojection error."""
    n_imgs = 1 + max(max(i, j) for i, j in matches)
    subset = set(range(min(n_imgs, 8)))
    best, best_err = None, np.inf
    for fov in fov_candidates:
        focal = 0.5 * w / np.tan(np.radians(fov) / 2.0)
        K = _K(focal, w, h)
        try:
            Rw, tw, pt3d = _reconstruct(
                kps, matches, tracks, obs_of, K,
                min_pnp_points=min_pnp_points, reproj_px=reproj_px,
                subset=subset, verbose=False, device=device,
            )
        except _ReconstructionError:
            continue
        if len(Rw) < 3 or len(pt3d) < 30:
            continue
        rv, tv, X0, cam_idx, pt_idx, uv, registered = _gather_ba_inputs(
            Rw, tw, pt3d, tracks, kps
        )
        _, _, _, _, err = bundle_adjust(
            rv, tv, X0, cam_idx, pt_idx, uv, focal, w / 2.0, h / 2.0,
            iters=400, optimize_focal=False, device=device,
        )
        if verbose:
            print(f"sfm: focal candidate fov {fov:.0f} deg → "
                  f"{len(Rw)} cams, {err:.2f}px post-BA")
        if err < best_err:
            best, best_err = focal, err
    if best is None:
        raise _ReconstructionError(
            "self-calibration failed: no focal candidate produced a "
            "3-view-consistent reconstruction"
        )
    return float(best)


class _ReconstructionError(RuntimeError):
    pass


def _reconstruct(
    kps, matches, tracks, obs_of, K,
    min_pnp_points: int, reproj_px: float,
    subset=None, verbose: bool = False, names=None,
    refine_every: int = 8,
    device=None,
):
    """Incremental reconstruction at fixed intrinsics: init pair →
    recoverPose → triangulate → PnP-register remaining images, with a short
    bundle adjustment every ``refine_every`` registrations (chained PnP
    drifts; without intermediate refinement the reprojection gate starts
    rejecting every new triangulation on real captures). Returns
    (Rw, tw, pt3d): world→camera per registered image + track id → 3D."""
    cv2 = _cv2()
    usable = {
        p: m for p, m in matches.items()
        if subset is None or (p[0] in subset and p[1] in subset)
    }
    if not usable:
        raise _ReconstructionError("no usable pairs")

    # ---- initial pair: among the best-MATCHED pairs (dense two-view
    # geometry), the one with the most parallax. Ranking by flow alone
    # prefers sparse long-range pairs whose few inliers cannot seed
    # registration of their neighbours.
    ranked = sorted(usable, key=lambda p: -len(usable[p][0]))
    dense = [p for p in ranked[: max(10, len(ranked) // 5)]
             if len(usable[p][0]) >= 50]
    if not dense:
        raise _ReconstructionError("no pair with enough matches")

    def pair_quality(p):
        ii, jj = usable[p]
        flow = np.linalg.norm(kps[p[0]][ii] - kps[p[1]][jj], axis=1)
        return float(np.median(flow)) * np.sqrt(len(ii))

    init_pair = max(dense, key=pair_quality)
    i0, j0 = init_pair
    ii, jj = usable[init_pair]
    p1, p2 = kps[i0][ii], kps[j0][jj]
    E, inl = cv2.findEssentialMat(p1, p2, K, method=cv2.RANSAC,
                                  prob=0.9999, threshold=1.5)
    if E is None or inl is None:
        raise _ReconstructionError("essential matrix estimation failed")
    inl = inl.ravel().astype(bool)
    _, R2, t2, _ = cv2.recoverPose(E, p1[inl], p2[inl], K)
    if verbose:
        print(f"sfm: init pair ({i0},{j0}) with {inl.sum()} E-inliers")

    Rw = {i0: np.eye(3), j0: R2}
    tw = {i0: np.zeros(3), j0: t2.ravel()}
    pt3d: Dict[int, np.ndarray] = {}  # track id → 3D point

    def P_of(i):
        return K @ np.hstack([Rw[i], tw[i].reshape(3, 1)])

    def try_triangulate(tid):
        """(Re)triangulate a track from all registered observations."""
        tr = tracks[tid]
        regs = [im for im in tr if im in Rw]
        if len(regs) < 2:
            return
        Ps = [P_of(im) for im in regs]
        uvs = [kps[im][tr[im]] for im in regs]
        X = triangulate_dlt(Ps, uvs)
        # Cheirality + reprojection gating on every registered view.
        for im, uv in zip(regs, uvs):
            xc = Rw[im] @ X + tw[im]
            if xc[2] <= 1e-6 or _reproj_err(P_of(im), X, uv) > reproj_px:
                pt3d.pop(tid, None)
                return
        pt3d[tid] = X

    for a, b in zip(ii[inl], jj[inl]):
        tid = obs_of.get((i0, int(a)))
        if tid is not None:
            try_triangulate(tid)

    # ---- incremental registration ---------------------------------------
    def refine():
        """Short fixed-focal BA over the current reconstruction, writing the
        refined cameras/points back and re-gating stale triangulations."""
        if len(Rw) < 3 or len(pt3d) < 3 * min_pnp_points:
            return
        rv, tv, X0, ci, pi, uv, regs = _gather_ba_inputs(
            Rw, tw, pt3d, tracks, kps
        )
        focal = float(K[0, 0])
        rv, tv, X1, _, _ = bundle_adjust(
            rv, tv, X0, ci, pi, uv, focal, K[0, 2], K[1, 2],
            iters=300, optimize_focal=False, device=device,
        )
        for k, im in enumerate(regs):
            Rw[im] = cv2.Rodrigues(rv[k])[0]
            tw[im] = tv[k]
        for k, tid in enumerate(sorted(pt3d)):
            pt3d[tid] = X1[k]
        # Drop points the refined cameras no longer agree on, retry the
        # tracks that previously failed the gate.
        for tid in list(pt3d):
            try_triangulate(tid)
        for tid in range(len(tracks)):
            if tid not in pt3d:
                try_triangulate(tid)

    since_refine = 0
    while True:
        # Candidate with the most visible triangulated tracks.
        counts: Dict[int, int] = {}
        for tid, X in pt3d.items():
            for im, feat in tracks[tid].items():
                if im not in Rw and (subset is None or im in subset):
                    counts[im] = counts.get(im, 0) + 1
        counts = {im: c for im, c in counts.items() if c >= min_pnp_points}
        if not counts:
            # One refinement pass may rescue gated-out points and unlock
            # further registrations; stop only if it does not.
            if since_refine > 0:
                since_refine = 0
                refine()
                continue
            break
        nxt = max(counts, key=counts.get)
        obj, img_pts = [], []
        for tid, X in pt3d.items():
            feat = tracks[tid].get(nxt)
            if feat is not None:
                obj.append(X)
                img_pts.append(kps[nxt][feat])
        ok, rvec, tvec, inliers = cv2.solvePnPRansac(
            np.asarray(obj, np.float64), np.asarray(img_pts, np.float64), K,
            None, reprojectionError=reproj_px * 2, iterationsCount=200,
            flags=cv2.SOLVEPNP_SQPNP,
        )
        if not ok or inliers is None or len(inliers) < min_pnp_points:
            if since_refine > 0:
                since_refine = 0
                refine()
                continue
            break
        Rn, _ = cv2.Rodrigues(rvec)
        Rw[nxt] = Rn
        tw[nxt] = tvec.ravel()
        # Triangulate everything the new image can see.
        for feat in range(len(kps[nxt])):
            tid = obs_of.get((nxt, feat))
            if tid is not None and tid not in pt3d:
                try_triangulate(tid)
        since_refine += 1
        if since_refine >= refine_every:
            since_refine = 0
            refine()
        if verbose:
            label = names[nxt] if names else str(nxt)
            print(f"sfm: registered image {nxt} ({label}) — "
                  f"{len(Rw)} cameras, {len(pt3d)} points")

    return Rw, tw, pt3d


def _gather_ba_inputs(Rw, tw, pt3d, tracks, kps):
    """Flatten a reconstruction into bundle_adjust operands."""
    registered = sorted(Rw)
    cam_of = {im: k for k, im in enumerate(registered)}
    tids = sorted(pt3d)
    pid_of = {tid: k for k, tid in enumerate(tids)}
    cam_idx, pt_idx, uv = [], [], []
    for tid in tids:
        for im, feat in tracks[tid].items():
            if im in Rw:
                cam_idx.append(cam_of[im])
                pt_idx.append(pid_of[tid])
                uv.append(kps[im][feat])
    rv = np.stack([_rotvec_np(Rw[im]) for im in registered])
    tv = np.stack([tw[im] for im in registered])
    X0 = np.stack([pt3d[tid] for tid in tids])
    return (rv, tv, X0, np.asarray(cam_idx), np.asarray(pt_idx),
            np.asarray(uv, np.float64), registered)


def run_sfm(
    image_paths: Sequence[str],
    max_dim: int = 1024,
    window: int = 6,
    fov_candidates: Sequence[float] = (45.0, 55.0, 65.0, 75.0, 85.0),
    min_pnp_points: int = 12,
    reproj_px: float = 4.0,
    ba_iters: int = 3000,
    verbose: bool = True,
    device=None,
) -> SfmResult:
    """Full pipeline: features → matches → focal self-calibration →
    incremental registration → global bundle adjustment on ``device``."""
    cv2 = _cv2()
    names = [os.path.basename(p) for p in image_paths]
    n = len(image_paths)
    if n < 2:
        raise ValueError("need at least two images")

    kps, descs = detect_features(image_paths, max_dim=max_dim)
    probe = cv2.imread(image_paths[0])
    h, w = probe.shape[:2]

    matches = {}
    for (i, j) in build_pairs(n, window=window):
        ii, jj = match_pair(descs[i], descs[j])
        if len(ii) >= 16:
            matches[(i, j)] = (ii, jj)
    if verbose:
        total = sum(len(v[0]) for v in matches.values())
        print(f"sfm: {len(matches)} matched pairs, {total} raw matches")

    tracks = build_tracks(matches)
    # Observation lookup: (img, feat) → track id.
    obs_of: Dict[Tuple[int, int], int] = {}
    for tid, tr in enumerate(tracks):
        for img, feat in tr.items():
            obs_of[(img, feat)] = tid

    focal = _pick_focal(kps, matches, tracks, obs_of, w, h, fov_candidates,
                        min_pnp_points, reproj_px, verbose=verbose, device=device)
    K = _K(focal, w, h)
    if verbose:
        fov = np.degrees(2 * np.arctan(0.5 * w / focal))
        print(f"sfm: self-calibrated focal {focal:.1f}px (fov_x {fov:.1f} deg)")

    Rw, tw, pt3d = _reconstruct(
        kps, matches, tracks, obs_of, K,
        min_pnp_points=min_pnp_points, reproj_px=reproj_px,
        verbose=verbose, names=names, device=device,
    )

    rv, tv, X0, cam_idx, pt_idx, uv, registered = _gather_ba_inputs(
        Rw, tw, pt3d, tracks, kps
    )
    rv, tv, X, focal, mean_px = bundle_adjust(
        rv, tv, X0, cam_idx, pt_idx, uv,
        focal, w / 2.0, h / 2.0, iters=ba_iters, device=device,
    )
    if verbose:
        print(f"sfm: BA done — focal {focal:.1f}px, "
              f"mean reprojection {mean_px:.2f}px over {len(uv)} observations")

    R = np.stack([cv2.Rodrigues(r)[0] for r in rv])
    lengths = np.asarray([len(tracks[tid]) for tid in sorted(pt3d)])
    return SfmResult(
        image_names=names, registered=registered, R=R, t=tv, focal=focal,
        width=w, height=h, points=X, mean_reproj_px=mean_px,
        track_lengths=lengths,
    )


# ---------------------------------------------------------------------------
# transforms.json export (instant-ngp convention, colmap2nerf-compatible)
# ---------------------------------------------------------------------------

def sfm_to_transforms(
    result: SfmResult,
    image_paths: Sequence[str],
    aabb_scale: float = 16.0,
    target_avg_distance: float = 4.0,
    with_sharpness: bool = True,
    out_path: Optional[str] = None,
    verbose: bool = True,
) -> dict:
    """SfmResult → transforms.json dict with the SAME normalization as the
    COLMAP import path (up-vector → +Z, center of attention at origin,
    average camera distance rescaled) — poses/colmap.py semantics."""
    from .colmap import _closest_point_to_rays, _rotation_aligning
    from .sharpness import compute_sharpness

    poses = result.c2w()

    up = poses[:, :3, 1].sum(0)
    up /= np.linalg.norm(up)
    Rfix = np.eye(4)
    Rfix[:3, :3] = _rotation_aligning(up, np.array([0.0, 0.0, 1.0]))
    poses = Rfix @ poses

    center = _closest_point_to_rays(poses[:, :3, 3], -poses[:, :3, 2])
    poses[:, :3, 3] -= center
    avg = np.linalg.norm(poses[:, :3, 3], axis=1).mean()
    poses[:, :3, 3] *= target_avg_distance / avg
    if verbose:
        print(f"sfm export: up {np.round(up, 3)}, center {np.round(center, 3)}, "
              f"avg distance {avg:.3f} → {target_avg_distance}")

    w, h, f = result.width, result.height, result.focal
    out = {
        "camera_angle_x": float(2 * np.arctan(0.5 * w / f)),
        "camera_angle_y": float(2 * np.arctan(0.5 * h / f)),
        "fl_x": f, "fl_y": f,
        "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0,
        "cx": w / 2.0, "cy": h / 2.0, "w": w, "h": h,
        "aabb_scale": aabb_scale,
        "frames": [],
    }
    # Portable file_paths: relative to the output JSON when one is being
    # written (the loader's _resolve tries json_dir-relative first), so a
    # committed transforms.json doesn't bake this machine's absolute paths.
    base = os.path.dirname(os.path.abspath(out_path)) if out_path else None
    for k, img_i in enumerate(result.registered):
        p = str(image_paths[img_i])
        rel = os.path.relpath(os.path.abspath(p), base) if base else p
        frame = {"file_path": rel if base and not rel.startswith("..") else p}
        if with_sharpness and os.path.isfile(image_paths[img_i]):
            frame["sharpness"] = compute_sharpness(image_paths[img_i])
        frame["transform_matrix"] = poses[k].tolist()
        out["frames"].append(frame)

    if out_path:
        import json

        with open(out_path, "w") as fp:
            json.dump(out, fp, indent=2)
        if verbose:
            print(f"wrote {out_path} ({len(out['frames'])} frames)")
    return out
