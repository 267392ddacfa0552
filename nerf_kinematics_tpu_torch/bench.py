"""Benchmark of the port: the fast engine's training throughput on the
lego-class machina workload (400x400, 100 + 8 views, white background),
``configs/machina_ngp.yml`` as shipped, on one GPU.

    python -m nerf_kinematics_tpu_torch.bench [--data cache/machina400]
    python -m nerf_kinematics_tpu_torch.bench --device cpu --data <tiny scene>

Prints ONE JSON line with the JAX package's bench keys where they apply
(``bench.py`` at the repository root):

  * ``value``: training rays/s, from the steady-state step time, the
    difference of two ``make_train_many`` lengths (8 and 40 steps a call,
    three timed calls each after two warm-ups, each call ended by a read of
    its loss), so the per-call cost drops out; ``samples_per_sec_per_chip``,
    ``step_ms``;
  * ``analytic_tflops_per_chip``, ``mfu_hw_pct`` and ``mfu_useful_pct``:
    the analytic FLOPs of a step (``utils/flops.py``: the executed encoder
    contraction, and the encoder at its two touched rows) over the H100's
    dense bf16 peak, 989 TFLOP/s (``utils/flops.py::PEAK_FLOPS``, which
    ``chip_smoke.py`` shares);
  * ``vs_baseline`` / ``vs_t4``: samples/s over instant-ngp's published T4
    figure, 56.78 steps/s x 2^18 samples a step (its Colab notebook, cell
    23), the figure the JAX bench cites; ``vs_a100_est`` over 5x that;
  * ``time_to_25db_s``: train in chunks of 250 steps (cap 4000) from the
    JAX package's seed-42 initial weights (``fixtures/machina_ngp_init42
    .npz``; about half of all fresh seeds fall into an all-white state on
    these images, in both packages, PERF.md), a full occupancy sweep after
    each chunk, until the first val view renders at 25 dB;
  * frame rates of the standard renderer (48 + 48 samples; the shipped
    64 + 128 evaluation budget as ``render_eval_*``) and the fast serving
    renderer (48 / 64, foreground fraction 0.35), per frame (one
    synchronisation a frame), sustained (16 frames in flight, one
    synchronisation) and on the device (CUDA events around the 16); at
    800 x 800 and the 1440^2 of a 1080p frame's pixel count, from the
    25 dB state;
  * ``device``: ``nvidia-smi``'s name and power limit of the card.

The scene in ``--data`` is used as it is (its generator's parameters are
reported as ``scene``); where it holds none, the port generates machina400
there (``data/machina.py``, under a minute on the card). ``--device cpu``
runs the JAX bench's CPU scale (16 + 16 samples, 512 rays, 2 and 6 steps a
call) on the scene in ``--data`` (a 10-view 64 px machina scene in a
temporary directory when none is given), with no render rows, no time to
25 dB and ``mfu_*`` null. Nothing falls back to the CPU by itself: without a GPU and without
``--device cpu`` it raises. It writes no ``BENCH_r*.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "machina_ngp.yml")
DATASET_DIR = os.path.join(REPO, "cache", "machina400")
# instant-ngp on a T4 in samples/s: 56.78 steps/s x 2^18 samples a step
BASELINE_SAMPLES_PER_SEC = 56.78 * 262_144
# an A100 at 5x the T4 (fp16 FLOP/s 312 / 65, HBM 1555 / 320 GB/s)
A100_OVER_T4 = 5.0
QUALITY_TARGET_DB = 25.0
T25_CHUNK, T25_CHUNKS = 250, 16
CPU_SCENE = {"resolution": 64, "n_train": 7, "n_val": 2, "n_test": 1, "n_samples": 64}


def nvidia_smi_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``'s first line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Training throughput of the port")
    p.add_argument("--data", default=None,
                   help=f"machina scene directory (default {DATASET_DIR}; "
                        "generated when it holds none)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' for the toy scale)")
    return p


class _Clock:
    """Host seconds of a block that ends with the device's work done."""

    def __init__(self, device):
        self.device = device

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, fn, reps: int = 1):
        self.sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        self.sync()
        return (time.perf_counter() - t0) / reps


def _frame_rates(fn, clock, n: int = 16) -> dict:
    """ms a frame: one synchronisation a frame (5 frames), ``n`` frames in
    flight with one synchronisation, and the device's time of those ``n``
    (CUDA events)."""
    fn()
    clock.sync()
    out = {"ms": float(np.mean([clock(fn) for _ in range(5)])) * 1e3,
           "sustained_ms": clock(fn, n) * 1e3}
    if clock.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize(clock.device)
        out["device_ms"] = start.elapsed_time(end) / n
    return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from ._device import resolve_device
    from .data import load_dataset
    from .data.machina import write_machina_dataset
    from .io.convert import params_from_npz
    from .io.fixture import MACHINA_NGP_INIT42
    from .rendering.renderer import RenderSettings
    from .train.config import load_config
    from .train.trainer import Trainer
    from .utils.flops import PEAK_FLOPS, train_step_flops, train_step_useful_flops

    device = resolve_device(args.device)
    on_gpu = device.type == "cuda"
    clock = _Clock(device)
    cfg = load_config(CONFIG)
    if on_gpu:
        reps_small, reps_big = 8, 40
        workload = "machina400 (lego-class, 400x400, 100 + 8 views)"
    else:
        small = RenderSettings(num_coarse=16, num_fine=16, perturb=True,
                               white_background=True)
        cfg = cfg.replace(nerf=dataclasses.replace(
            cfg.nerf, train=small, validation=dataclasses.replace(small, perturb=False),
            num_random_rays=512))
        reps_small, reps_big = 2, 6
        workload = "machina (CPU scale)"

    with tempfile.TemporaryDirectory() as tmp:
        data = args.data or (DATASET_DIR if on_gpu else os.path.join(tmp, "machina"))
        marker = os.path.join(data, ".machina.json")
        if not os.path.isfile(marker):
            write_machina_dataset(data, device=device, **({} if on_gpu else CPU_SCENE))
        with open(marker) as f:
            scene = json.load(f)
        dataset = load_dataset(dataclasses.replace(cfg.dataset, basedir=data),
                               white_background=cfg.nerf.train.white_background)
        trainer = Trainer(cfg.replace(experiment=dataclasses.replace(
            cfg.experiment, logdir=os.path.join(tmp, "logs"))), dataset=dataset,
            device=device)
        engine, ds = trainer.engine, trainer.dataset
        engine.load_flax_params(params_from_npz(MACHINA_NGP_INIT42))
        init = engine.init_state(keep_weights=True).params.clone()

        def fresh():
            engine.layout.bind(engine.model, init)
            return engine.init_state(keep_weights=True)

        images, poses, ray_buf = trainer.images, trainer.poses, trainer.ray_buf
        n_rays = cfg.nerf.num_random_rays
        samples_per_ray = cfg.nerf.train.num_coarse + cfg.nerf.train.num_fine

        # ---- steady-state step time ---------------------------------------
        times = {}
        with torch.no_grad():
            for n in (reps_small, reps_big):
                many = engine.make_train_many(ds.intrinsics, ds.near, ds.far,
                                              ds.use_ndc, steps_per_call=n)
                s = fresh()
                for _ in range(2):
                    s, m = many(s, images, poses, ray_buf)
                    float(m["loss"])
                t0 = time.perf_counter()
                for _ in range(3):
                    s, m = many(s, images, poses, ray_buf)
                    float(m["loss"])
                times[n] = (time.perf_counter() - t0) / 3
        step_s = (times[reps_big] - times[reps_small]) / (reps_big - reps_small)
        flops = train_step_flops(cfg, n_rays)
        useful = train_step_useful_flops(cfg, n_rays)
        rays_per_sec = n_rays / step_s
        samples_per_sec = rays_per_sec * samples_per_ray
        peak = PEAK_FLOPS["bf16"] if on_gpu else None

        out = {
            "metric": "train_rays_per_sec_per_chip",
            "value": rays_per_sec,
            "unit": "rays/s",
            "vs_baseline": samples_per_sec / BASELINE_SAMPLES_PER_SEC,
            "samples_per_sec_per_chip": samples_per_sec,
            "samples_per_ray": samples_per_ray,
            "step_ms": step_s * 1e3,
            "step_ms_by_call": {str(k): v * 1e3 for k, v in times.items()},
            "analytic_tflops_per_chip": flops / step_s / 1e12,
            "mfu_hw_pct": flops / step_s / peak * 100.0 if peak else None,
            "mfu_useful_pct": useful / step_s / peak * 100.0 if peak else None,
            "vs_t4": samples_per_sec / BASELINE_SAMPLES_PER_SEC,
            "vs_a100_est": samples_per_sec / (A100_OVER_T4 * BASELINE_SAMPLES_PER_SEC),
            "device_kind": torch.cuda.get_device_name(device) if on_gpu else "cpu",
            "device": nvidia_smi_line() if on_gpu else "cpu",
            "workload": workload,
            "scene": scene,
            "fused_train": engine.ngp_config.fused_train,
            "baseline_derivation": "T4 56.78 steps/s x 2^18 samples/step "
                                   "= 14.88M samples/s (cell 23); ratio in samples/s",
            "time_to_25db_s": None,
            "time_to_25db_post_compile_s": None,
        }
        if on_gpu:
            out.update(_gpu_rows(trainer, fresh, clock, step_s))
        trainer.close()
    print(json.dumps(out), flush=True)
    return out


def _gpu_rows(trainer, fresh, clock, step_s: float) -> dict:
    """The frame rates and the time to 25 dB, on the GPU."""
    from .metrics.psnr import psnr
    from .rendering.fast_render import FastRenderSettings
    from .train.loop import eval_params

    cfg, engine, ds = trainer.cfg, trainer.engine, trainer.dataset
    rows = {}
    val = cfg.nerf.validation
    val48 = dataclasses.replace(val, num_coarse=48, num_fine=48)
    fast_settings = FastRenderSettings(num_coarse=48, num_fine=64, fg_fraction=0.35,
                                       white_background=val.white_background)
    vi = int(ds.val_idx[0])
    vpose = torch.as_tensor(ds.poses[vi], device=trainer.device)
    gt = ds.images[vi]

    # ---- 400 px frames from the initial weights and the fresh grid -------
    state = fresh()
    render = engine.make_render_fn(ds.intrinsics, ds.near, ds.far, ds.use_ndc,
                                   settings=val48)
    render_eval = engine.make_render_fn(ds.intrinsics, ds.near, ds.far, ds.use_ndc)
    fast = engine.make_fast_render_fn(ds.intrinsics, ds.near, ds.far, ds.use_ndc,
                                      settings=fast_settings)
    with torch.no_grad(), engine.bound(eval_params(state)):
        for name, fn in (("render", render), ("render_eval", render_eval),
                         ("render_fast", fast)):
            r = _frame_rates(lambda fn=fn: fn(vpose, state.aux)["rgb"], clock)
            rows[f"{name}_ms_per_frame_400px"] = r["ms"]
            rows[f"{name}_fps_400px"] = 1e3 / r["ms"]
            if name != "render_eval":
                rows[f"{name}_fps_400px_sustained"] = 1e3 / r["sustained_ms"]
                rows[f"{name}_fps_400px_device"] = 1e3 / r["device_ms"]

    # ---- time to 25 dB --------------------------------------------------
    many = engine.make_train_many(ds.intrinsics, ds.near, ds.far, ds.use_ndc,
                                  steps_per_call=T25_CHUNK)
    state = fresh()
    curve = []
    t25 = t25_post = None
    t_start, t_post = time.perf_counter(), None
    for it in range(1, T25_CHUNKS + 1):
        with torch.no_grad():
            state, _ = many(state, trainer.images, trainer.poses, trainer.ray_buf)
            state = engine.update_occupancy(state)
            with engine.bound(eval_params(state)):
                img = render_eval(vpose, state.aux)["rgb"].float().cpu().numpy()
        db = float(psnr(img, gt))
        curve.append([it * T25_CHUNK, db])
        if t_post is None:
            t_post = time.perf_counter()
        if db >= QUALITY_TARGET_DB:
            now = time.perf_counter()
            t25 = now - t_start
            t25_post = max(now - t_post, 0.0) + T25_CHUNK * step_s
            break
    rows.update({"time_to_25db_s": t25, "time_to_25db_post_compile_s": t25_post,
                 "time_to_25db_curve": curve})
    if t25 is None:
        return rows

    # ---- 800 px and 1440^2 frames from the 25 dB state --------------------
    p = eval_params(state)
    intr8 = ds.intrinsics.scaled(ds.W / 800.0)
    render8 = engine.make_render_fn(intr8, ds.near, ds.far, ds.use_ndc, settings=val48)
    fast8 = engine.make_fast_render_fn(intr8, ds.near, ds.far, ds.use_ndc,
                                       settings=fast_settings)
    intr14 = ds.intrinsics.scaled(ds.W / 1440.0)
    fast14 = engine.make_fast_render_fn(
        intr14, ds.near, ds.far, ds.use_ndc,
        settings=FastRenderSettings(num_coarse=48, num_fine=48, fg_fraction=0.2,
                                    white_background=val.white_background))
    std14 = engine.make_render_fn(intr14, ds.near, ds.far, ds.use_ndc, settings=val48)
    img = lambda fn: fn(vpose, state.aux)["rgb"].float().cpu().numpy()
    with torch.no_grad(), engine.bound(p):
        rows["render_fast_vs_std_psnr_800px"] = float(psnr(img(fast8), img(render8)))
        for name, fn in (("render", render8), ("render_fast", fast8)):
            r = _frame_rates(lambda fn=fn: fn(vpose, state.aux)["rgb"], clock, n=8)
            rows[f"{name}_fps_800px_sustained"] = 1e3 / r["sustained_ms"]
            rows[f"{name}_fps_800px_device"] = 1e3 / r["device_ms"]
        rows["render_fast_vs_std_psnr_1080p_eq"] = float(psnr(img(fast14), img(std14)))
        r = _frame_rates(lambda: fast14(vpose, state.aux)["rgb"], clock, n=8)
        rows["render_fast_fps_1080p_eq_device"] = 1e3 / r["device_ms"]
        rows["render_fast_fps_1080p_eq_sustained"] = 1e3 / r["sustained_ms"]
    return rows


if __name__ == "__main__":
    main()
