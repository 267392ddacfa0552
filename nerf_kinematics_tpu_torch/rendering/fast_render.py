"""Serving-rate full-image rendering for the fused NGP path.

Every shape stays static and the work per pixel is cut four ways:

  1. **Shared coarse pass**: the "where is the surface" pass (occupancy
     proposal + coarse network evaluation) runs once per ``stride x stride``
     pixel block instead of per pixel. stride=2 quarters the coarse cost.
  2. **PDF smoothing**: the block-shared fine-sampling PDF is blurred one
     bin wide and floored before inverse-CDF sampling, so a depth edge
     crossing a block still places fine samples on both surfaces.
  3. **One fused forward per pass**: the whole image's fine pass is a single
     channels-first fused-kernel call and one compositing region.
  4. **Foreground compaction** (``fg_fraction < 1``): one top-k over the
     coarse pass's per-block local contrast selects the fixed fraction of
     blocks that get the fine pass at all; the others keep their coarse
     composite.

The fine pass still evaluates the full per-pixel budget at per-pixel ray
directions; only sample placement is block-shared.

Spans (``utils/profiling.py``), children of the caller's ``frame``:
``frame.rays`` (view directions, block layout), ``frame.proposal``,
``frame.coarse``, ``frame.pdf`` (fine placement), ``frame.select`` (block
scores and top-K), ``frame.fine`` and ``frame.paste`` (the image's layout).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from ..ops.sampling import sample_pdf
from ..ops.volume_render import raw2outputs_cf
from ..utils import profiling


@dataclass(frozen=True)
class FastRenderSettings:
    num_coarse: int = 48       # proposal-placed samples in the shared pass
    num_fine: int = 48         # per-pixel fine samples (the output pass)
    stride: int = 2            # coarse pass runs once per stride^2 block
    pdf_blur: bool = True      # one-bin triangular blur of the shared PDF
    pdf_floor: float = 0.01    # uniform floor (fraction of per-ray max)
    white_background: bool = False
    # Fraction of blocks (ranked by coarse-pass local contrast) that get the
    # fine pass; the rest keep their coarse composite. 1.0 disables it.
    fg_fraction: float = 1.0


def _blur_floor_pdf(w: torch.Tensor, blur: bool, floor: float) -> torch.Tensor:
    """(R, S) weights -> smoothed, floored PDF for fine placement."""
    if blur:
        wl = torch.cat([w[..., :1], w[..., :-1]], dim=-1)
        wr = torch.cat([w[..., 1:], w[..., -1:]], dim=-1)
        w = 0.5 * w + 0.25 * (wl + wr)
    if floor > 0.0:
        w = w + floor * torch.amax(w, dim=-1, keepdim=True)
    return w


def _window_range(img: torch.Tensor) -> torch.Tensor:
    """(Hq, Wq, 3) -> (Hq, Wq): the largest per-channel (max - min) over the
    3x3 neighbourhood, windows clipped at the border."""
    x = img.permute(2, 0, 1)[None]  # (1, 3, Hq, Wq)
    # max_pool2d pads with -inf, which is what a clipped window needs.
    mx = F.max_pool2d(x, 3, stride=1, padding=1)
    mn = -F.max_pool2d(-x, 3, stride=1, padding=1)
    return (mx - mn)[0].amax(dim=0)


def render_image_fast(
    apply_cf: Callable,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near,
    far,
    settings: FastRenderSettings,
    proposal_fn: Callable,
    viewdirs=None,
):
    """Render an (H, W) image through the shared-coarse fast path.

    ``apply_cf``: the engine's channels-first fused entry ((pts (..., 3),
    vd) -> (4, N)). ``proposal_fn``: (rays_o, rays_d) -> (N, num_coarse)
    proposal depths (the engine's occupancy proposal closed over the grid).
    Deterministic. Returns the ``render_image`` dict ({"rgb", "disp", "acc",
    "depth"})."""
    H, W = rays_o.shape[:2]
    s = settings.stride
    if H % s or W % s:
        raise ValueError("stride must divide the image")
    Hq, Wq = H // s, W // s
    sp = profiling.begin("frame.rays")
    if viewdirs is None:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    # Block-major layout: (Hq, s, Wq, s, 3) -> (Hq*Wq, s*s, 3); the shared
    # coarse ray is each block's first pixel.
    def blockify(x):
        return (
            x.reshape(Hq, s, Wq, s, 3)
            .permute(0, 2, 1, 3, 4)
            .reshape(Hq * Wq, s * s, 3)
        )

    def unblock(x):
        tail = x.shape[1:]
        extra = tuple(range(4, 4 + len(tail)))
        return (
            x.reshape(Hq, Wq, s, s, *tail)
            .permute(0, 2, 1, 3, *extra)
            .reshape(H, W, *tail)
        )

    with torch.no_grad():
        ob, db, vb = blockify(rays_o), blockify(rays_d), blockify(viewdirs)
        oq, dq = ob[:, 0, :], db[:, 0, :]
        profiling.end(sp)

        # ---- shared coarse pass (per block) ----------------------------
        sp = profiling.begin("frame.proposal")
        z_q = proposal_fn(oq, dq)                           # (Nq, Sc)
        profiling.end(sp)
        sp = profiling.begin("frame.coarse")
        pts_q = oq[:, None, :] + dq[:, None, :] * z_q[..., None]
        vd_q = vb[:, 0:1, :].expand(pts_q.shape)
        raw_q = apply_cf(pts_q, vd_q)                       # (4, Nq*Sc)
        out_q = raw2outputs_cf(
            raw_q, z_q, dq, white_background=settings.white_background
        )
        profiling.end(sp)

        # ---- per-pixel fine placement from the shared PDF --------------
        sp = profiling.begin("frame.pdf")
        w = _blur_floor_pdf(out_q.weights, settings.pdf_blur, settings.pdf_floor)
        mids = 0.5 * (z_q[..., 1:] + z_q[..., :-1])
        z_fine = sample_pdf(
            mids, w[..., 1:-1], settings.num_fine, deterministic=True
        )                                                   # (Nq, Sf) sorted
        profiling.end(sp)

        Nq = Hq * Wq
        Sf = settings.num_fine

        if settings.fg_fraction < 1.0:
            # ---- foreground compaction: fine pass on the top-K blocks --
            # The block score is the local contrast of the coarse
            # composite: excluded blocks inherit their block-constant
            # coarse color, so the error of excluding one is its
            # intra-block detail, which lives where the coarse image has
            # structure. Opacity is no usable score: a trained model fills
            # free space with background-colored fog (acc ~ 1 everywhere).
            K = max(1, int(round(settings.fg_fraction * Nq)))
            sp = profiling.begin("frame.select")
            score = _window_range(out_q.rgb.reshape(Hq, Wq, 3)).reshape(Nq)
            idx = torch.topk(score, K).indices
            profiling.end(sp)
            sp = profiling.begin("frame.fine")
            n_pk = K * s * s
            z_k = z_fine[idx][:, None, :].expand(K, s * s, Sf).reshape(n_pk, Sf)
            of = ob[idx].reshape(n_pk, 3)
            df = db[idx].reshape(n_pk, 3)
            vf = vb[idx].reshape(n_pk, 3)
            pts = of[:, None, :] + df[:, None, :] * z_k[..., None]
            vd = vf[:, None, :].expand(pts.shape)
            raw = apply_cf(pts, vd)
            out = raw2outputs_cf(
                raw, z_k, df, white_background=settings.white_background
            )
            profiling.end(sp)

            def paste(coarse_field, fine_field):
                """Coarse per-block value broadcast to pixels, fine results
                scattered over the selected blocks."""
                tail = coarse_field.shape[1:]
                base = coarse_field[:, None].expand(Nq, s * s, *tail).clone()
                base[idx] = fine_field.reshape(K, s * s, *tail)
                return base.reshape(Nq * s * s, *tail)

            sp = profiling.begin("frame.paste")
            maps = {
                "rgb": unblock(paste(out_q.rgb, out.rgb)),
                "disp": unblock(paste(out_q.disp, out.disp)),
                "acc": unblock(paste(out_q.acc, out.acc)),
                "depth": unblock(paste(out_q.depth, out.depth)),
            }
            profiling.end(sp)
            return maps

        sp = profiling.begin("frame.fine")
        n_pix = Nq * s * s
        z_all = z_fine[:, None, :].expand(Nq, s * s, Sf).reshape(n_pix, Sf)

        # ---- fine pass: full per-pixel budget, per-pixel directions ----
        of = ob.reshape(n_pix, 3)
        df = db.reshape(n_pix, 3)
        vf = vb.reshape(n_pix, 3)
        pts = of[:, None, :] + df[:, None, :] * z_all[..., None]
        vd = vf[:, None, :].expand(pts.shape)
        raw = apply_cf(pts, vd)
        out = raw2outputs_cf(
            raw, z_all, df, white_background=settings.white_background
        )
        profiling.end(sp)

        sp = profiling.begin("frame.paste")
        maps = {
            "rgb": unblock(out.rgb),
            "disp": unblock(out.disp),
            "acc": unblock(out.acc),
            "depth": unblock(out.depth),
        }
        profiling.end(sp)
        return maps
