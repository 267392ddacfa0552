#!/usr/bin/env python3
"""Where the hash encoder's time goes on the card: ``ops/hashgrid.py`` at the
reference-exact grid (L 8, F 4, T 2^19) and one training step of
``configs/fox_ngp.yml`` with ``encoder: hash`` on the halo scene.

    python3 scripts/torch_hash_profile.py              # the GPU
    python3 scripts/torch_hash_profile.py --points 65536 --rays 1024 --size 32

Prints one JSON object: the encoder's forward and backward at ``--points``
points (CUDA-event medians), the parts of the table gradient (the stable
sort, the run lengths, the segmented sum, the scatter into the table), and
the step's time by the host clock with the device's time by kernel from
``torch.profiler`` (the top kernels, and the device's busy share of the
step's wall time).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerf_kinematics_tpu_torch.ops import hashgrid  # noqa: E402


def cuda_ms(fn, reps=5, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def encoder_parts(n: int, dev) -> dict:
    cfg = hashgrid.HashGridConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    table = hashgrid.init_table(cfg, gen).requires_grad_(True)
    x = torch.rand((n, 3), generator=gen, device=dev)
    g = torch.randn((n, cfg.out_dim), generator=gen, device=dev)
    out = {"points": n, "taps": n * cfg.n_levels * 8}
    out["forward_ms"] = cuda_ms(lambda: hashgrid.hash_encode(table.detach(), x, cfg))

    def fwd_bwd():
        y = hashgrid.hash_encode(table, x, cfg)
        (gt,) = torch.autograd.grad(y, table, g)
        return gt

    out["forward_backward_ms"] = cuda_ms(fwd_bwd)
    # the table gradient's parts on this call's taps
    captured = {}
    orig = hashgrid._Gather.backward

    def spy(ctx, grad):
        captured["idx"], captured["grad"] = ctx.saved_tensors[0], grad
        return orig(ctx, grad)

    hashgrid._Gather.backward = staticmethod(spy)
    try:
        fwd_bwd()
    finally:
        hashgrid._Gather.backward = staticmethod(orig)
    idx, grad = captured["idx"], captured["grad"].contiguous()
    rows = cfg.n_levels * cfg.table_size
    order = torch.argsort(idx.to(torch.int32), stable=True)
    keys, counts = torch.unique_consecutive(idx[order], return_counts=True)
    gs = hashgrid.take_rows(grad, order)
    sums = torch.segment_reduce(gs, "sum", lengths=counts)
    out["table_grad_ms"] = cuda_ms(lambda: hashgrid.table_grad(grad, idx, rows))
    out["sort_ms"] = cuda_ms(lambda: torch.argsort(idx.to(torch.int32), stable=True))
    out["sort_int64_ms"] = cuda_ms(lambda: torch.argsort(idx, stable=True))
    out["unique_consecutive_ms"] = cuda_ms(
        lambda: torch.unique_consecutive(idx[order], return_counts=True))
    out["gather_sorted_ms"] = cuda_ms(lambda: hashgrid.take_rows(grad, order))
    out["gather_sorted_advanced_indexing_ms"] = cuda_ms(lambda: grad[order])
    out["gather_sorted_index_select_ms"] = cuda_ms(lambda: grad.index_select(0, order))
    out["segment_reduce_ms"] = cuda_ms(lambda: torch.segment_reduce(gs, "sum", lengths=counts))

    def scatter():
        t = torch.zeros((rows, grad.shape[1]), device=dev)
        t[keys] = sums
        return t

    out["scatter_ms"] = cuda_ms(scatter)
    out["rows_touched"] = int(keys.numel())
    out["largest_run"] = int(counts.max())
    # the same sum with atomics, for scale (not used by the port)
    out["index_add_ms"] = cuda_ms(
        lambda: torch.zeros((rows, grad.shape[1]), device=dev).index_add_(0, idx, grad))
    # determinism of the fixed-order sum
    out["table_grad_bit_identical"] = bool(torch.equal(
        hashgrid.table_grad(grad, idx, rows), hashgrid.table_grad(grad, idx, rows)))
    return out


def step_profile(rays: int, size: int, views: int, dev) -> dict:
    import dataclasses

    from nerf_kinematics_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_kinematics_tpu_torch.train.config import load_config
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "fox_ngp.yml"))
    ds = make_synthetic_scene(variant="halo", n_views=views, resolution=size, device=dev)
    out = {"rays": rays}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = cfg.replace(
            ngp=dataclasses.replace(cfg.ngp, encoder="hash"),
            experiment=dataclasses.replace(cfg.experiment, logdir=tmp, print_every=0,
                                           validate_every=0, save_every=0),
            nerf=dataclasses.replace(cfg.nerf, num_random_rays=rays))
        trainer = Trainer(cfg, ds, device=dev)
        state = trainer.engine.init_state()
        args = (trainer.images, trainer.poses, trainer.ray_buf)
        step = trainer._train_step
        for _ in range(3):
            state, _ = step(state, *args)
        torch.cuda.synchronize()
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            state, m = step(state, *args)
            float(m["loss"])
            walls.append((time.perf_counter() - t0) * 1e3)
        out["step_ms_host"] = statistics.median(walls)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                state, m = step(state, *args)
            float(m["loss"])
            wall = (time.perf_counter() - t0) * 1e3
        from torch.autograd import DeviceType

        rows = []
        dev_total = 0.0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:  # an operator: its kernels count
                continue
            d = getattr(e, "self_device_time_total", None)
            if d is None:
                d = getattr(e, "self_cuda_time_total", 0.0)
            dev_total += d
            rows.append((d / 5e3, e.count // 5, e.key))
        rows.sort(reverse=True)
        out["profiled_ms_per_step_host"] = wall / 5
        out["device_ms_per_step"] = dev_total / 5e3
        out["device_busy_share"] = dev_total / 1e3 / wall if wall else None
        out["top_kernels"] = [{"kernel": k[:90], "device_ms": round(d, 4), "launches": n}
                              for d, n, k in rows[:20]]
        trainer.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=1 << 20)
    ap.add_argument("--rays", type=int, default=16384)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--views", type=int, default=49)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    from nerf_kinematics_tpu_torch.bench import nvidia_smi_line

    report = {"device": nvidia_smi_line(), "encoder": encoder_parts(args.points, dev)}
    report["step"] = step_profile(args.rays, args.size, args.views, dev)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
