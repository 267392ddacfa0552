"""Training orchestration: dataset -> engine -> loop with validation,
checkpointing (auto-resume), metric logging and throughput counters.

``print_every`` console scalars, ``validate_every`` full held-out-image
renders with PSNR, ``save_every`` checkpoints named by iteration, scalars
train/val x loss/psnr plus rays per second in ``metrics.jsonl``.

Steps are enqueued in chunks sized to the smallest event cadence; the host
reads the device (metrics, validation, checkpoints) on those cadences only.
Each chunk is a span ``fit.chunk`` (``utils/profiling.py``; request id: its
first step) with the children ``fit.enqueue`` (the steps' calls, each step
a span ``step``), ``fit.read`` (the one read of the losses, where the host
waits for the device), ``fit.refresh`` (an occupancy refresh and its
synchronisation) and ``fit.events`` (print, validation, checkpoint, where a
cadence fires).

With ``use_mesh`` and a process group of two or more ranks
(``parallel/``), every rank trains the replicated state on its share of
each step's rays; rank 0 alone writes metrics, checkpoints and validation
renders, and the others meet it at a barrier after each checkpoint and at
the end of ``fit``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..data.types import NerfDataset
from ..io.checkpoint import CheckpointManager
from ..metrics.psnr import psnr
from ..metrics.writer import ScalarWriter
from ..parallel.mesh import barrier, make_mesh
from ..utils import profiling
from ..utils.logging import get_logger
from .config import Config
from .loop import ClassicNerf, TrainState, build_shuffled_ray_buffer, eval_params

log = get_logger("train")


@dataclass
class TrainResult:
    state: TrainState
    last_metrics: dict = field(default_factory=dict)
    val_psnr: Optional[float] = None
    rays_per_sec: Optional[float] = None
    # every step's train loss, in order (read from the device per chunk)
    losses: list = field(default_factory=list)
    # (iteration, "full" | "incremental", seconds) of every occupancy refresh:
    # the span fit.refresh's two clock reads
    occupancy_refreshes: list = field(default_factory=list)
    # (steps, seconds) of every chunk of steps, from the start of its enqueue
    # to the end of the one read of the device that ends it (the spans
    # fit.enqueue's start and fit.read's end)
    chunk_seconds: list = field(default_factory=list)


class _NoWriter:
    """The metrics writer of a rank that writes none."""

    def scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    """Fits the engine ``cfg.engine`` names ("ngp" or "classic") to a
    dataset: the one given, or the one ``cfg.dataset`` describes on disk
    (``data/__init__.py::load_dataset``). ``device=None`` means the GPU.
    ``export_legacy`` (classic engine only) writes the reference's
    ``checkpoint{iter}.ckpt`` next to each checkpoint, with the weights
    validation scores. ``use_mesh``: split each step's rays over the ranks
    of the process group (``parallel/mesh.py::make_mesh``; ``self.mesh`` is
    None, the single-device path, without a group of two or more)."""

    def __init__(self, cfg: Config, dataset: Optional[NerfDataset] = None,
                 device=None, export_legacy: bool = False, use_mesh: bool = False):
        if dataset is None:
            from ..data import load_dataset

            dataset = load_dataset(
                cfg.dataset, white_background=cfg.nerf.train.white_background,
                device=device)
        self.cfg = cfg
        self.dataset = ds = dataset
        self.mesh = make_mesh(resolve_device(device)) if use_mesh else None
        if cfg.engine == "ngp":
            from .ngp_engine import NGPEngine

            bound = max(ds.aabb_scale / 2.0, 1.0)
            self.engine = NGPEngine(cfg, scene_bound=bound, device=device,
                                    mesh=self.mesh)
        elif cfg.engine == "classic":
            self.engine = ClassicNerf(cfg, device=device, mesh=self.mesh)
        else:
            raise ValueError(f"unknown engine {cfg.engine!r}")
        self.export_legacy = export_legacy and cfg.engine == "classic"
        self.device = self.engine.device
        # the rank that writes metrics, checkpoints and renders
        self.is_main = self.mesh is None or self.mesh.is_main

        exp = cfg.experiment
        self.rundir = os.path.join(exp.logdir, exp.id)
        if self.is_main:
            os.makedirs(self.rundir, exist_ok=True)
        self.writer = ScalarWriter(self.rundir) if self.is_main else _NoWriter()
        self.ckpt = CheckpointManager(os.path.join(self.rundir, "checkpoints"),
                                      create=self.is_main)

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

        # occupancy refreshes: the fast engine's only
        ngp = getattr(self.engine, "ngp_config", None)
        occ_every = ngp.occ_update_every if ngp is not None and ngp.use_occupancy else 0

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
            first = it + 1
            t_chunk = time.time_ns()
            span = profiling.begin("fit.chunk", first, t_chunk)
            sp = profiling.begin("fit.enqueue", first, t_chunk)
            if k == chunk and chunk > 1:
                state, metrics = self._train_many(
                    state, self.images, self.poses, self.ray_buf, first_step=first)
                step_losses = metrics.pop("losses")
            else:
                each = []
                for j in range(k):
                    state, metrics = self._train_step(
                        state, self.images, self.poses, self.ray_buf,
                        step_id=first + j)
                    each.append(metrics["loss"])
                step_losses = torch.stack(each)
            profiling.end(sp)
            it += k
            # one read of the device per chunk
            sp = profiling.begin("fit.read", first)
            result.losses.extend(step_losses.tolist())
            t_read = time.time_ns()
            profiling.end(sp, t_read)
            result.chunk_seconds.append((k, (t_read - t_chunk) * 1e-9))

            if occ_every and (it % occ_every) < k and it >= occ_every:
                # Full sweep on the first refresh and every occ_full_every
                # steps; the cheap incremental decay + requery between.
                full_every = ngp.occ_full_every
                full = it < occ_every + k or not full_every or (
                    (it % full_every) < k)
                t_occ = time.time_ns()
                sp = profiling.begin("fit.refresh", first, t_occ)
                state = self.engine.update_occupancy(state, full=full)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t_done = time.time_ns()
                profiling.end(sp, t_done)
                result.occupancy_refreshes.append(
                    (it, "full" if full else "incremental", (t_done - t_occ) * 1e-9))

            if exp.print_every > 0 and ((it % exp.print_every) < k or it == total):
                sp = profiling.begin("fit.events", first)
                result.last_metrics = {key: float(v) for key, v in metrics.items()}
                dt = time.perf_counter() - t0
                result.rays_per_sec = (it - start_step) * n_rays / max(dt, 1e-9)
                m = result.last_metrics
                if self.is_main:
                    log.info("iter %d/%d loss %.5f psnr %.2f | %.0f rays/s",
                             it, total, m["loss"], m["psnr"], result.rays_per_sec)
                self.writer.scalar("train/loss", m["loss"], it)
                self.writer.scalar("train/psnr", m["psnr"], it)
                self.writer.scalar("perf/rays_per_sec", result.rays_per_sec, it)
                # metrics.jsonl doubles as the run's liveness heartbeat
                self.writer.flush()
                profiling.end(sp)

            if (self.is_main and exp.validate_every > 0
                    and ((it % exp.validate_every) < k or it == total)):
                sp = profiling.begin("fit.events", first)
                v = self.validate(state)
                if v:
                    result.val_psnr = v["val_psnr"]
                    self.writer.scalar("val/loss", v["val_loss"], it)
                    self.writer.scalar("val/psnr", v["val_psnr"], it)
                    log.info("iter %d validation psnr %.2f dB", it, result.val_psnr)
                profiling.end(sp)

            if exp.save_every > 0 and ((it % exp.save_every) < k or it == total):
                sp = profiling.begin("fit.events", first)
                self.save_checkpoint(state, it, result.last_metrics,
                                     result.val_psnr)
                profiling.end(sp)
            profiling.end(span)

        # Final mean over the whole validation split: the per-step val/psnr
        # scalar is view 0 only.
        if self.is_main and len(self.dataset.val_idx) > 1:
            mean = self.evaluate_split(state, "val")["mean_psnr"]
            self.writer.scalar("val/psnr_mean", mean, it)
            log.info("final val mean psnr %.2f dB over %d views", mean,
                     len(self.dataset.val_idx))
        self.writer.flush()
        barrier(self.mesh)
        result.state = state
        return result

    def save_checkpoint(self, state: TrainState, it: int, metrics: dict,
                        val_psnr: Optional[float] = None) -> None:
        """Write a checkpoint of iteration ``it`` and, with ``export_legacy``,
        the reference's ``checkpoint{it}.ckpt`` of the weights validation
        scores (the EMA shadow when the run keeps one). Under a mesh rank 0
        writes and every rank waits for it."""
        if not self.is_main:
            barrier(self.mesh)
            return
        self.ckpt.save(it, state, metrics, layout=self.engine.layout)
        if self.export_legacy:
            from ..io.torch_compat import export_legacy_checkpoint

            model = self.engine.model
            with self.engine.bound(eval_params(state)):
                coarse = model.coarse.state_dict()
                fine = model.fine.state_dict() if model.fine is not None else None
                export_legacy_checkpoint(
                    os.path.join(self.rundir, f"checkpoint{it}.ckpt"), it,
                    coarse, fine, loss=metrics.get("loss"), psnr=val_psnr)
        log.info("saved checkpoint at iter %d", it)
        barrier(self.mesh)

    def close(self):
        self.writer.close()
        self.ckpt.close()
