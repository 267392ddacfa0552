"""The classic engine's training and rendering against the JAX package's, on
the CPU: one whole ``ClassicNerf`` train step on both routes (the fused route
against the reference's ``fused: on`` in interpret mode, the module route
against ``fused: off``) from the same weights, pixels, depth jitter and
density noise; the classic Adam against optax; the evaluation render of a
16x16 view; ``Trainer.fit`` with ``engine: classic``, its checkpoints and
legacy export; the full-width configuration ``chip_smoke.py`` drives.

Tolerances. Losses rtol 1e-5. Gradients, read from Adam's first moment after
one step (0.1 g): rtol 5e-4 / atol 5e-7, the reference's gradient tolerance
(``tests/test_classic_fused.py``) scaled by 0.1. The first Adam update is
``lr * g / (|g| + 1e-8)``: where |g| > 1e-5 both packages move a parameter by
lr * sign(g) to 1e-3, so updated parameters agree to 1e-6 there and by at
most 2 lr elsewhere (``ROADMAP.md`` section C). Optimizer alone: rtol 1e-5
over five steps. Render: atol 1e-4 on rgb and acc, rtol 1e-4 on depth.
"""

import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.data.types import Intrinsics as JIntrinsics
from nerf_kinematics_tpu.train import config as jcfg
from nerf_kinematics_tpu.train.loop import ClassicNerf as JClassic
from nerf_kinematics_tpu_torch.data.machina import machina_intrinsics, orbit_poses
from nerf_kinematics_tpu_torch.data.types import dataset_from_arrays
from nerf_kinematics_tpu_torch.io import convert
from nerf_kinematics_tpu_torch.io.torch_compat import import_legacy_checkpoint
from nerf_kinematics_tpu_torch.train import config as tcfg
from nerf_kinematics_tpu_torch.train import loop as tloop
from nerf_kinematics_tpu_torch.train.loop import ClassicNerf
from nerf_kinematics_tpu_torch.train.trainer import Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_RAYS, N_COARSE, N_FINE, SIZE = 64, 8, 6, 16
NEAR, FAR = 2.0, 6.0
MODEL = dict(hidden_size=32, num_encoding_fn_xyz=4, num_encoding_fn_dir=2, num_layers=8,
             skip_connect_every=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _raw(fused="on", logdir="logs", iters=24, noise=0.2, fine=True):
    models = {"coarse": dict(MODEL, fused=fused)}
    if fine:
        models["fine"] = dict(MODEL, fused=fused)
    return {
        "dataset": {"near": NEAR, "far": FAR},
        "experiment": {"logdir": str(logdir), "id": "tiny_classic", "print_every": 8,
                       "validate_every": 8, "save_every": 16, "train_iters": iters,
                       "randomseed": 5},
        "models": models,
        "nerf": {
            "train": {"num_coarse": N_COARSE, "num_fine": N_FINE, "perturb": True,
                      "radiance_field_noise_std": noise, "white_background": True,
                      "num_random_rays": N_RAYS},
            "validation": {"num_coarse": N_COARSE, "num_fine": N_FINE, "perturb": False,
                           "white_background": True},
        },
        "optimizer": {"lr": 5e-3},
        "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1},
    }


def _scene(n_views=3):
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.6, (n_views, 1, 1, 3))
    ramp = 0.3 * np.linspace(0, 1, SIZE)[None, None, :, None]
    images = np.broadcast_to(base + ramp, (n_views, SIZE, SIZE, 3)).astype(np.float32)
    return images, orbit_poses(n_views).astype(np.float32)


def _draws(n_img, seed=7):
    rng = np.random.default_rng(seed)
    return {
        "pixels": [rng.integers(0, n_img, N_RAYS), rng.integers(0, SIZE, N_RAYS),
                   rng.integers(0, SIZE, N_RAYS)],
        "u_coarse": rng.uniform(size=(N_RAYS, N_COARSE)).astype(np.float32),
        "u_fine": rng.uniform(size=(N_RAYS, N_FINE)).astype(np.float32),
        "noise_coarse": rng.standard_normal((N_RAYS, N_COARSE)).astype(np.float32),
        "noise_fine": rng.standard_normal((N_RAYS, N_COARSE + N_FINE)).astype(np.float32),
    }


def _patch_jax_draws(monkeypatch, d):
    """The reference draws with jax.random; hand it the test's numbers."""
    ints = list(d["pixels"])
    uni = {(N_RAYS, N_COARSE): d["u_coarse"], (N_RAYS, N_FINE): d["u_fine"]}
    nrm = {(N_RAYS, N_COARSE): d["noise_coarse"], (N_RAYS, N_COARSE + N_FINE): d["noise_fine"]}
    calls = []

    def randint(key, shape, minval, maxval, dtype=jnp.int32):
        calls.append(maxval)
        return jnp.asarray(ints[len(calls) - 1], dtype)

    monkeypatch.setattr(jax.random, "randint", randint)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), dtype=jnp.float32, **kw:
                        jnp.asarray(uni[tuple(shape)], dtype))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(nrm[tuple(shape)], dtype))
    return calls


class _Pair:
    """Both engines on the reference's freshly initialised weights."""

    def __init__(self, fused, **kw):
        raw = _raw(fused, **kw)
        self.je = JClassic(jcfg.config_from_dict(raw))
        self.jstate = self.je.init_state(seed=9)
        self.te = ClassicNerf(tcfg.config_from_dict(raw), device="cpu")
        self.te.load_flax_params(jax.tree_util.tree_map(np.array, self.jstate.params))
        self.tstate = self.te.init_state(seed=9, keep_weights=True)
        ti = machina_intrinsics(SIZE)
        self.tintr = ti
        self.jintr = JIntrinsics(fl_x=ti.fl_x, fl_y=ti.fl_y, cx=ti.cx, cy=ti.cy,
                                 width=SIZE, height=SIZE)

    def flat(self, tree):
        named = convert.classic_named_from_flax(jax.tree_util.tree_map(np.asarray, tree))
        return self.te.layout.flatten({k: torch.tensor(v) for k, v in named.items()}).numpy()


@pytest.mark.parametrize("route", ["fused", "module"])
def test_train_step_matches_jax(route, monkeypatch):
    pr = _Pair("on" if route == "fused" else "off")
    jc, tc = pr.je.cf_apply_fns(), pr.te.cf_apply_fns()
    assert (jc[0] is not None) == (tc[0] is not None) == (route == "fused")
    images, poses = _scene()
    d = _draws(len(images))
    calls = _patch_jax_draws(monkeypatch, d)
    jstep = pr.je.make_train_step(pr.jintr, NEAR, FAR, False, donate=False)
    jnew, jm = jstep(pr.jstate, jnp.asarray(images), jnp.asarray(poses))
    assert calls == [len(images), SIZE, SIZE]  # image, row, column

    before = pr.tstate.clone()
    tstep = pr.te.make_train_step(pr.tintr, NEAR, FAR, False)
    tnew, tm = tstep(pr.tstate, torch.tensor(images), torch.tensor(poses),
                     pixels=[torch.tensor(p) for p in d["pixels"]],
                     **{k: torch.tensor(d[k]) for k in
                        ("u_coarse", "u_fine", "noise_coarse", "noise_fine")})
    assert tnew is pr.tstate and int(tnew.step) == 1 == int(jnew.step)
    for k in ("loss", "loss_coarse", "loss_fine", "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    # coarse weight 1: the coarse pass trains too
    np.testing.assert_allclose(float(tm["loss"]), float(tm["loss_coarse"] + tm["loss_fine"]),
                               rtol=1e-6)

    layout = pr.te.layout
    big = [np.asarray(l) for l in jax.tree_util.tree_leaves(jnew.opt_state)
           if np.size(l) == layout.total]
    assert len(big) == 2  # mu, nu of the flattened Adam
    mu = convert.flat_from_reference(big[0], layout).numpy()
    nu = convert.flat_from_reference(big[1], layout).numpy()
    np.testing.assert_allclose(tnew.opt_state.mu.numpy(), mu, rtol=5e-4, atol=5e-7)
    np.testing.assert_allclose(np.sqrt(tnew.opt_state.nu.numpy()), np.sqrt(nu),
                               rtol=5e-4, atol=5e-7)
    g = 10.0 * mu  # the gradient, from its first moment
    names = [e[0] for e in layout.entries]
    live = {n for n, _, off, k in layout.entries if np.abs(g[off:off + k]).max() > 0}
    assert {"coarse.layer1.weight", "fine.layer1.weight", "coarse.fc_rgb.weight",
            "fine.fc_alpha.weight"} <= live, sorted(set(names) - live)
    p_new = pr.flat(jnew.params)
    sure = np.abs(g) > 1e-5
    assert sure.mean() > 0.5
    diff = np.abs(tnew.params.numpy() - p_new)
    assert diff[sure].max() <= 1e-6
    assert diff.max() <= 2 * 5e-3 + 1e-6
    assert int(tnew.opt_state.count) == 1 and tnew.ema is None


def test_classic_adam_matches_optax_and_the_engines_keep_their_own():
    """optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8, no decay) over five
    updates; the fast engine keeps b2 0.99, eps 1e-15 and its decay."""
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    assert ClassicNerf.adam == tloop.CLASSIC_ADAM == tloop.AdamConfig(0.9, 0.999, 1e-8, 0.0)
    assert NGPEngine.adam == tloop.NGP_ADAM == tloop.AdamConfig(0.9, 0.99, 1e-15, 1e-6)
    raw = _raw("on")
    raw["scheduler"]["lr_decay"] = 1  # 0.1^(step/1000): visible within five steps
    pr = _Pair("on")
    je = JClassic(jcfg.config_from_dict(raw))
    te = ClassicNerf(tcfg.config_from_dict(raw), device="cpu")
    te.load_flax_params(jax.tree_util.tree_map(np.array, pr.jstate.params))
    state = te.init_state(keep_weights=True)
    params, opt_state = pr.jstate.params, je.optimizer.init(pr.jstate.params)
    sched = tloop.lr_schedule(te.cfg)
    rng = np.random.default_rng(4)
    import optax

    for step in range(5):
        g_named = {n: (rng.standard_normal(s) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
                   for n, s, _, _ in te.layout.entries}
        jg = jax.tree_util.tree_map(jnp.asarray, convert.classic_params_to_flax(
            {k: torch.tensor(v) for k, v in g_named.items()}))
        updates, opt_state = je.optimizer.update(jg, opt_state, params)
        params = optax.apply_updates(params, updates)
        tloop.adam_update(state.params, te.layout.flatten(
            {k: torch.tensor(v) for k, v in g_named.items()}), state.opt_state, sched,
            None, te.adam)
        np.testing.assert_allclose(state.params.numpy(), pr.flat(params), rtol=1e-5,
                                   atol=1e-7, err_msg=f"step {step}")
    assert int(state.opt_state.count) == 5
    # the classic layout has no decay: nothing there is a `.kernel`
    assert not te.layout.decay_mask(weight_decay=1.0).any()
    # the flat-order bridge transposes the Linear weights and is its own inverse
    v = np.arange(te.layout.total, dtype=np.float32)
    back = convert.flat_to_reference(convert.flat_from_reference(v, te.layout), te.layout)
    assert np.array_equal(back, v)


def test_render_matches_jax():
    pr = _Pair("on")
    pose = orbit_poses(3)[1].astype(np.float32)
    jr = pr.je.make_render_fn(pr.jintr, NEAR, FAR, False)(pr.jstate.params, jnp.asarray(pose))
    render = pr.te.make_render_fn(pr.tintr, NEAR, FAR)
    with pr.te.bound(pr.tstate.params):
        tr = render(torch.tensor(pose))
    assert tr["rgb"].shape == (SIZE, SIZE, 3)
    np.testing.assert_allclose(tr["rgb"].numpy(), np.asarray(jr["rgb"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tr["acc"].numpy(), np.asarray(jr["acc"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tr["depth"].numpy(), np.asarray(jr["depth"]), rtol=1e-4,
                               atol=1e-4)
    # the module route renders the same image
    mod = _Pair("off")
    with mod.te.bound(mod.tstate.params):
        tm = mod.te.make_render_fn(mod.tintr, NEAR, FAR, chunk_rays=100)(torch.tensor(pose))
    np.testing.assert_allclose(tm["rgb"].numpy(), tr["rgb"].numpy(), rtol=0, atol=1e-5)


def test_ndc_step_and_render_run():
    """The NDC warp feeds the step and the renderer (forward-facing scenes)."""
    pr = _Pair("on", noise=0.0)
    images, poses = _scene()
    step = pr.te.make_train_step(pr.tintr, 0.0, 1.0, use_ndc=True)
    state, m = step(pr.tstate, torch.tensor(images), torch.tensor(poses))
    assert np.isfinite(float(m["loss"]))
    out = pr.te.make_render_fn(pr.tintr, 0.0, 1.0, use_ndc=True)(torch.tensor(poses[0]))
    assert torch.isfinite(out["rgb"]).all()


def test_fit_trains_checkpoints_and_exports_legacy(tmp_path):
    images, poses = _scene(5)
    ds = dataset_from_arrays(images, poses, machina_intrinsics(SIZE), NEAR, FAR, n_val=1)
    cfg = tcfg.config_from_dict(_raw("auto", logdir=tmp_path))
    assert cfg.engine == "classic"
    tr = Trainer(cfg, ds, device="cpu", export_legacy=True)
    assert isinstance(tr.engine, ClassicNerf) and tr.ray_buf is None
    res = tr.fit()
    assert len(res.losses) == 24 and np.isfinite(res.losses).all()
    assert np.mean(res.losses[-6:]) < 0.5 * np.mean(res.losses[:3])
    assert res.occupancy_refreshes == [] and res.val_psnr is not None
    assert int(res.state.step) == 24 == int(res.state.opt_state.count)
    assert tr.ckpt.steps() == [16, 24]  # every 16 steps, and the last
    fresh = tr.engine.init_state(seed=99)
    back, at = tr.ckpt.restore(fresh, layout=tr.engine.layout)
    assert at == 24 and torch.equal(back.params, res.state.params)
    assert torch.equal(back.opt_state.nu, res.state.opt_state.nu)
    # the legacy file holds the trained weights under the reference's names
    assert sorted(os.listdir(tr.rundir)).count("checkpoint24.ckpt") == 1
    legacy = import_legacy_checkpoint(os.path.join(tr.rundir, "checkpoint24.ckpt"))
    assert legacy["step"] == 24 and legacy["psnr"] == pytest.approx(res.val_psnr)
    with tr.engine.bound(res.state.params):
        for net, sd in (("coarse", legacy["state_coarse"]), ("fine", legacy["state_fine"])):
            want = getattr(tr.engine.model, net).state_dict()
            assert set(sd) == set(want) and all(torch.equal(sd[k], want[k]) for k in sd)
    # an NGP-only Trainer option stays off for the classic engine
    assert not Trainer(cfg.replace(engine="ngp", ngp=None), ds, device="cpu",
                       export_legacy=True).export_legacy
    tr.close()


def test_chip_smoke_config_is_machina_classic():
    """chip_smoke.py drives machina_classic from a dict (no PyYAML on the
    card): it must equal the shipped YAML."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = tcfg.load_config(ROOT / "configs" / "machina_classic.yml")
    got = tcfg.config_from_dict(smoke.CLASSIC_CONFIG)
    assert got == want
    assert got.model_coarse.hidden_size == 128 and got.nerf.train.radiance_field_noise_std == 0.2
    # the full-width model: 84 548 parameters a network
    eng = ClassicNerf(got, device="cpu")
    assert eng.layout.total == 2 * 84548
