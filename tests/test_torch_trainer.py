"""The port's Trainer on a tiny in-memory dataset on the CPU: the loss
falls, full and incremental occupancy refreshes come at the reference's
cadence, checkpoints round-trip leaf for leaf, ``metrics.jsonl`` is written;
plus the channels-last compositing the unfused route needs, against the JAX
package's."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.ops import volume_render as jvr
from nerf_kinematics_tpu_torch.data.machina import machina_intrinsics, orbit_poses
from nerf_kinematics_tpu_torch.data.types import dataset_from_arrays
from nerf_kinematics_tpu_torch.io.checkpoint import CheckpointManager
from nerf_kinematics_tpu_torch.ops import volume_render as tvr
from nerf_kinematics_tpu_torch.train import config as tcfg
from nerf_kinematics_tpu_torch.train.trainer import Trainer

SIZE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: several intra-op threads per test worker only
    fight over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _raw(logdir, fused="on", fused_train="auto", ema=0.0, iters=40):
    return {
        "engine": "ngp",
        "ngp": {
            "encoder": "cp_pallas", "n_levels": 3, "n_components": 16,
            "table_size": 48, "base_resolution": 8, "max_resolution": 32,
            "density_width": 32, "density_out": 16, "color_width": 32,
            "color_layers": 3, "use_occupancy": True, "occ_resolution": 16,
            "occ_bins": 8, "fused": fused, "fused_train": fused_train,
            "occ_update_every": 8, "occ_full_every": 32,
            "occ_incremental_cells": 512,
        },
        "dataset": {"near": 2.0, "far": 6.0},
        "experiment": {"logdir": str(logdir), "id": "tiny", "print_every": 8,
                       "validate_every": 16, "save_every": 16,
                       "train_iters": iters, "randomseed": 3},
        "nerf": {
            "train": {"num_coarse": 8, "num_fine": 8, "white_background": True,
                      "num_random_rays": 128, "pixel_sampler": "shuffled"},
            "validation": {"num_coarse": 8, "num_fine": 8, "perturb": False,
                           "white_background": True},
            "coarse_loss_weight": 0.0, "ema_decay": ema,
        },
        "optimizer": {"lr": 0.01},
        "scheduler": {"lr_decay": 6, "lr_decay_factor": 0.33},
    }


def _dataset(n_views=5, n_val=1):
    """Flat-colored views with a horizontal ramp: something a tiny model
    fits within a few dozen steps."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.6, (n_views, 1, 1, 3))
    ramp = 0.3 * np.linspace(0, 1, SIZE)[None, None, :, None]
    images = np.broadcast_to(base + ramp, (n_views, SIZE, SIZE, 3)).astype(np.float32)
    return dataset_from_arrays(images, orbit_poses(n_views), machina_intrinsics(SIZE),
                               2.0, 6.0, n_val=n_val)


def _expected_refreshes(total, chunk, occ_every, full_every):
    """The reference's rule (train/trainer.py): a refresh whenever a chunk
    crosses a multiple of occ_every; full at the first one and whenever the
    chunk crosses a multiple of occ_full_every."""
    out, it = [], 0
    while it < total:
        k = min(chunk, total - it)
        it += k
        if (it % occ_every) < k and it >= occ_every:
            full = it < occ_every + k or (it % full_every) < k
            out.append((it, "full" if full else "incremental"))
    return out


@pytest.mark.parametrize("route", [("on", "auto"), ("on", "off"), ("off", "auto")],
                         ids=["fused_objective", "fused_vjp", "unfused"])
def test_fit_trains_refreshes_and_checkpoints(route, tmp_path):
    ema = 0.95 if route == ("on", "auto") else 0.0
    cfg = tcfg.config_from_dict(_raw(tmp_path, *route, ema=ema))
    tr = Trainer(cfg, _dataset(), device="cpu")
    assert tr.ray_buf["rays_o"].shape == (4 * SIZE * SIZE, 3)
    res = tr.fit()
    assert len(res.losses) == 40 and np.isfinite(res.losses).all()
    assert np.mean(res.losses[-8:]) < 0.25 * np.mean(res.losses[:4])
    assert int(res.state.step) == 40 == int(res.state.opt_state.count)
    assert [(i, kind) for i, kind, _ in res.occupancy_refreshes] == \
        _expected_refreshes(40, 8, 8, 32)
    assert [(i, kind) for i, kind, _ in res.occupancy_refreshes][:4] == [
        (8, "full"), (16, "incremental"), (24, "incremental"), (32, "full")]
    assert res.val_psnr is not None and res.val_psnr > 10.0
    assert set(res.last_metrics) == {"loss", "loss_coarse", "loss_fine", "psnr"}
    assert res.rays_per_sec > 0
    assert (res.state.ema is not None) == bool(ema)

    # metrics.jsonl: one JSON object per line, the four scalars on their cadences
    with open(os.path.join(tr.rundir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    by_tag = {}
    for r in recs:
        by_tag.setdefault(r["tag"], []).append(r["step"])
    assert by_tag["train/loss"] == [8, 16, 24, 32, 40] == by_tag["train/psnr"]
    assert by_tag["val/psnr"] == [16, 32, 40] and "perf/rays_per_sec" in by_tag

    # checkpoints at 16, 32 and the end; the latest restores leaf for leaf
    assert tr.ckpt.steps() == [16, 32, 40]
    fresh = tr.engine.init_state(seed=99)
    assert not torch.equal(fresh.params, res.state.params)
    back, step = tr.ckpt.restore(fresh, layout=tr.engine.layout)
    assert step == 40 and back is fresh
    for a, b in ((back.params, res.state.params), (back.opt_state.mu, res.state.opt_state.mu),
                 (back.opt_state.nu, res.state.opt_state.nu),
                 (back.opt_state.count, res.state.opt_state.count),
                 (back.step, res.state.step), (back.aux.density, res.state.aux.density),
                 (back.generator.get_state(), res.state.generator.get_state())):
        assert torch.equal(a, b)
    assert (back.ema is None) == (res.state.ema is None)
    if ema:
        assert torch.equal(back.ema, res.state.ema)
        assert not torch.equal(back.ema, back.params)
    # a restored state trains on exactly as the one that was saved
    step_fn = tr.engine.make_train_step(tr.dataset.intrinsics, 2.0, 6.0, False)
    a, _ = step_fn(back, tr.images, tr.poses, tr.ray_buf)
    b, _ = step_fn(res.state, tr.images, tr.poses, tr.ray_buf)
    assert torch.equal(a.params, b.params)
    ev = tr.evaluate_split(res.state, "val")
    assert len(ev["per_frame"]) == 1 and np.isfinite(ev["mean_psnr"])
    tr.close()


def test_fit_resumes_and_uneven_cadence(tmp_path):
    """A second Trainer on the same run directory resumes from the latest
    checkpoint; a total that no cadence divides ends with single steps."""
    raw = _raw(tmp_path, iters=16)
    tr = Trainer(tcfg.config_from_dict(raw), _dataset(), device="cpu")
    first = tr.fit()
    tr.close()
    raw["experiment"]["train_iters"] = 29
    tr2 = Trainer(tcfg.config_from_dict(raw), _dataset(), device="cpu")
    state = tr2.init_or_resume()
    assert int(state.step) == 16 and torch.equal(state.params, first.state.params)
    res = tr2.fit(state=state)
    assert int(res.state.step) == 29 and len(res.losses) == 13
    assert tr2.ckpt.steps() == [16, 29]
    assert [i for i, _, _ in res.occupancy_refreshes] == [24]
    assert tr2.validate(res.state)["val_image"].shape == (SIZE, SIZE, 3)
    tr2.close()


def test_what_the_trainer_does_not_load_yet(tmp_path):
    """Without a dataset the trainer loads ``cfg.dataset`` from disk
    (tests/test_torch_data.py trains so) or makes the synthetic scene on
    its device; the loader still to port says so and names its ROADMAP
    item."""
    import dataclasses

    cfg = tcfg.config_from_dict(_raw(tmp_path))
    c = cfg.replace(dataset=dataclasses.replace(cfg.dataset, type="robot"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(c, device="cpu")
    c = cfg.replace(dataset=dataclasses.replace(cfg.dataset, type="synthetic"))
    syn = Trainer(c, device="cpu")  # the sphere, 12 views of 64 px, on the CPU
    assert syn.dataset.images.shape == (12, 64, 64, 3) and syn.images.shape[0] == 10
    syn.close()
    for kind in ("blender", "ngp"):  # the ngp loader is ported: no transforms.json
        missing = dataclasses.replace(cfg.dataset, basedir=str(tmp_path / "nothing"),
                                      type=kind)
        with pytest.raises(FileNotFoundError):
            Trainer(cfg.replace(dataset=missing), device="cpu")
    with pytest.raises(ValueError, match="engine"):
        Trainer(cfg.replace(engine="nerfacto"), _dataset(), device="cpu")
    with pytest.raises(ValueError, match="n_val"):
        _dataset(n_views=2, n_val=2)
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.latest_step() is None and mgr.restore(None) == (None, None)


@pytest.mark.parametrize("white", [True, False], ids=["white", "black"])
@pytest.mark.parametrize("noise_std", [0.0, 0.5], ids=["clean", "noisy"])
def test_raw2outputs_matches_jax(noise_std, white, monkeypatch):
    """Channels-last compositing with the ReLU on sigma: negative raw
    densities contribute nothing; the noise is added before the ReLU."""
    import jax

    rng = np.random.default_rng(41)
    R, S = 37, 9
    rgb = rng.standard_normal((R, S, 3)).astype(np.float32)
    sigma = (3.0 * rng.standard_normal((R, S))).astype(np.float32)
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=1).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    noise = rng.standard_normal((R, S)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    want = jvr.raw2outputs(jnp.asarray(rgb), jnp.asarray(sigma), jnp.asarray(z),
                           jnp.asarray(d), noise_std=noise_std, white_background=white,
                           noise_key=jax.random.PRNGKey(0))
    got = tvr.raw2outputs(torch.tensor(rgb), torch.tensor(sigma), torch.tensor(z),
                          torch.tensor(d), noise_std=noise_std, white_background=white,
                          noise=torch.tensor(noise))
    for name in ("rgb", "disp", "acc", "weights", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=2e-5, atol=2e-6, err_msg=name)
    assert (got.weights.numpy()[sigma + noise_std * noise <= 0] == 0).all()
    if noise_std:
        with pytest.raises(ValueError, match="generator or noise"):
            tvr.raw2outputs(torch.tensor(rgb), torch.tensor(sigma), torch.tensor(z),
                            torch.tensor(d), noise_std=noise_std)
