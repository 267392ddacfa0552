"""Training orchestration: dataset -> engine -> loop with validation,
checkpointing (auto-resume), metric logging and throughput counters.

``print_every`` console scalars, ``validate_every`` full held-out-image
renders with PSNR, ``save_every`` checkpoints named by iteration, scalars
train/val x loss/psnr plus rays per second in ``metrics.jsonl``.

Steps are enqueued in chunks sized to the smallest event cadence; the host
reads the device (metrics, validation, checkpoints) on those cadences only.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..data.types import NerfDataset
from ..io.checkpoint import CheckpointManager
from ..metrics.psnr import psnr
from ..metrics.writer import ScalarWriter
from .config import Config
from .loop import TrainState, build_shuffled_ray_buffer, eval_params

log = logging.getLogger("nerf_kinematics_tpu_torch.train")


@dataclass
class TrainResult:
    state: TrainState
    last_metrics: dict = field(default_factory=dict)
    val_psnr: Optional[float] = None
    rays_per_sec: Optional[float] = None
    # every step's train loss, in order (read from the device per chunk)
    losses: list = field(default_factory=list)
    # (iteration, "full" | "incremental", seconds) of every occupancy refresh
    occupancy_refreshes: list = field(default_factory=list)
    # (steps, seconds) of every chunk of steps, host clock around the one
    # read of the device that ends it
    chunk_seconds: list = field(default_factory=list)


class Trainer:
    """Fits the fast engine to a dataset. ``device=None`` means the GPU."""

    def __init__(self, cfg: Config, dataset: Optional[NerfDataset] = None,
                 device=None):
        if dataset is None:
            raise NotImplementedError(
                "loading a dataset from cfg.dataset.basedir is not ported yet "
                "(ROADMAP A.2: loaders and the scene generator); pass a "
                "NerfDataset (data/types.py::dataset_from_arrays)")
        if cfg.engine != "ngp":
            raise NotImplementedError(
                "the classic engine is not ported yet (ROADMAP A.4)")
        from .ngp_engine import NGPEngine

        self.cfg = cfg
        self.dataset = ds = dataset
        bound = max(ds.aabb_scale / 2.0, 1.0)
        self.engine = NGPEngine(cfg, scene_bound=bound, device=device)
        self.device = self.engine.device

        exp = cfg.experiment
        self.rundir = os.path.join(exp.logdir, exp.id)
        os.makedirs(self.rundir, exist_ok=True)
        self.writer = ScalarWriter(self.rundir)
        self.ckpt = CheckpointManager(os.path.join(self.rundir, "checkpoints"))

        self._train_step = self.engine.make_train_step(
            ds.intrinsics, ds.near, ds.far, ds.use_ndc)
        self._render = self.engine.make_render_fn(
            ds.intrinsics, ds.near, ds.far, ds.use_ndc)
        self._train_many = None
        self._train_many_chunk = None

        # Device-resident training data (train split only).
        imgs, poses = ds.split("train")
        self.images = torch.as_tensor(imgs, dtype=torch.float32, device=self.device)
        self.poses = torch.as_tensor(poses, dtype=torch.float32, device=self.device)
        self.ray_buf = None
        if cfg.nerf.train.pixel_sampler in ("shuffled", "shuffled_epoch"):
            self._build_ray_buf(seed=cfg.experiment.randomseed)

    def _build_ray_buf(self, seed: int) -> None:
        self.ray_buf = build_shuffled_ray_buffer(
            self.images, self.poses, self.dataset.intrinsics, seed=seed)

    # ------------------------------------------------------------------
    def init_or_resume(self) -> TrainState:
        state = self.engine.init_state()
        restored, step = self.ckpt.restore(state, layout=self.engine.layout)
        if restored is not None:
            log.info("resumed from checkpoint at step %d", step)
            return restored
        return state

    def _render_view(self, state: TrainState, i: int):
        pose = torch.as_tensor(self.dataset.poses[i], device=self.device)
        with self.engine.bound(eval_params(state)):
            return self._render(pose, state.aux)

    def validate(self, state: TrainState) -> dict:
        ds = self.dataset
        if len(ds.val_idx) == 0:
            return {}
        i = int(ds.val_idx[0])
        pred = self._render_view(state, i)["rgb"].cpu().numpy()
        gt = ds.images[i]
        return {
            "val_loss": float(np.mean((pred - gt) ** 2)),
            "val_psnr": psnr(pred, gt),
            "val_image": pred,
        }

    def evaluate_split(self, state: TrainState, split: str = "val") -> dict:
        """Render + PSNR every image of a split; per-frame and mean PSNR."""
        ds = self.dataset
        idx = {"train": ds.train_idx, "val": ds.val_idx, "test": ds.test_idx}[split]
        scores = [
            psnr(self._render_view(state, int(i))["rgb"].cpu().numpy(),
                 ds.images[int(i)])
            for i in idx
        ]
        return {
            "per_frame": scores,
            "mean_psnr": float(np.mean(scores)) if scores else float("nan"),
        }

    def fit(self, max_iters: Optional[int] = None,
            state: Optional[TrainState] = None) -> TrainResult:
        """Run training to ``train_iters`` (or ``max_iters``). ``state``
        overrides init_or_resume."""
        cfg, exp = self.cfg, self.cfg.experiment
        total = max_iters if max_iters is not None else exp.train_iters
        if state is None:
            state = self.init_or_resume()
        start_step = int(state.step)

        n_rays = cfg.nerf.num_random_rays
        t0 = time.perf_counter()
        result = TrainResult(state)

        ngp = self.engine.ngp_config
        occ_every = ngp.occ_update_every if ngp.use_occupancy else 0

        cadences = [
            c for c in (exp.print_every, exp.validate_every, exp.save_every,
                        occ_every, total - start_step)
            if c and c > 0
        ]
        chunk = max(min(cadences), 1) if cadences else 1
        if chunk > 1 and self._train_many_chunk != chunk:
            ds = self.dataset
            self._train_many = self.engine.make_train_many(
                ds.intrinsics, ds.near, ds.far, ds.use_ndc, steps_per_call=chunk)
            self._train_many_chunk = chunk

        # "shuffled_epoch": the buffer is re-permuted with a fresh seed each
        # time training has consumed one epoch's worth of rays.
        reshuffle = cfg.nerf.train.pixel_sampler == "shuffled_epoch"
        epoch_steps = 0
        if reshuffle and self.ray_buf is not None:
            epoch_steps = max(int(self.ray_buf["target"].shape[0]) // n_rays, 1)

        it = start_step
        while it < total:
            if reshuffle and epoch_steps and it > start_step:
                epoch_now = it // epoch_steps
                if (it - chunk) // epoch_steps != epoch_now:
                    self._build_ray_buf(
                        seed=exp.randomseed + 1000 * (1 + epoch_now))
            k = min(chunk, total - it)
            t_chunk = time.perf_counter()
            if k == chunk and chunk > 1:
                state, metrics = self._train_many(
                    state, self.images, self.poses, self.ray_buf)
                step_losses = metrics.pop("losses")
            else:
                each = []
                for _ in range(k):
                    state, metrics = self._train_step(
                        state, self.images, self.poses, self.ray_buf)
                    each.append(metrics["loss"])
                step_losses = torch.stack(each)
            it += k
            # one read of the device per chunk
            result.losses.extend(step_losses.tolist())
            result.chunk_seconds.append((k, time.perf_counter() - t_chunk))

            if occ_every and (it % occ_every) < k and it >= occ_every:
                # Full sweep on the first refresh and every occ_full_every
                # steps; the cheap incremental decay + requery between.
                full_every = ngp.occ_full_every
                full = it < occ_every + k or not full_every or (
                    (it % full_every) < k)
                t_occ = time.perf_counter()
                state = self.engine.update_occupancy(state, full=full)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                result.occupancy_refreshes.append(
                    (it, "full" if full else "incremental",
                     time.perf_counter() - t_occ))

            if exp.print_every > 0 and ((it % exp.print_every) < k or it == total):
                result.last_metrics = {key: float(v) for key, v in metrics.items()}
                dt = time.perf_counter() - t0
                result.rays_per_sec = (it - start_step) * n_rays / max(dt, 1e-9)
                m = result.last_metrics
                log.info("iter %d/%d loss %.5f psnr %.2f | %.0f rays/s",
                         it, total, m["loss"], m["psnr"], result.rays_per_sec)
                self.writer.scalar("train/loss", m["loss"], it)
                self.writer.scalar("train/psnr", m["psnr"], it)
                self.writer.scalar("perf/rays_per_sec", result.rays_per_sec, it)
                # metrics.jsonl doubles as the run's liveness heartbeat
                self.writer.flush()

            if exp.validate_every > 0 and ((it % exp.validate_every) < k or it == total):
                v = self.validate(state)
                if v:
                    result.val_psnr = v["val_psnr"]
                    self.writer.scalar("val/loss", v["val_loss"], it)
                    self.writer.scalar("val/psnr", v["val_psnr"], it)
                    log.info("iter %d validation psnr %.2f dB", it, result.val_psnr)

            if exp.save_every > 0 and ((it % exp.save_every) < k or it == total):
                self.save_checkpoint(state, it, result.last_metrics,
                                     result.val_psnr)

        # Final mean over the whole validation split: the per-step val/psnr
        # scalar is view 0 only.
        if len(self.dataset.val_idx) > 1:
            mean = self.evaluate_split(state, "val")["mean_psnr"]
            self.writer.scalar("val/psnr_mean", mean, it)
            log.info("final val mean psnr %.2f dB over %d views", mean,
                     len(self.dataset.val_idx))
        self.writer.flush()
        result.state = state
        return result

    def save_checkpoint(self, state: TrainState, it: int, metrics: dict,
                        val_psnr: Optional[float] = None) -> None:
        """Write a checkpoint of iteration ``it``. (The reference's legacy
        export is of the classic engine only and is not ported.)"""
        self.ckpt.save(it, state, metrics, layout=self.engine.layout)
        log.info("saved checkpoint at iter %d", it)

    def close(self):
        self.writer.close()
        self.ckpt.close()
