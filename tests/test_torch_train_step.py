"""One train step of the port against the JAX engine's, on the CPU: the same
parameters, ray buffer, window offset and depth jitter go through both, on
the three routes (fused objective; autograd through the fused forward;
autograd through the unfused model), with and without the occupancy grid.

Tolerances. The comparison is of the algorithm, so it runs with f32 tables
and weights (``cp.use_bf16`` false): loss and loss_coarse rtol 1e-5;
gradients rtol 1e-3 / atol 1e-6
(as ``tests/test_fused_train.py::test_fused_objective_matches_autodiff``);
Adam's first moment and the root of its second, both a tenth of the gradient
after one step, rtol 1e-3 / atol 1e-7. With eps = 1e-15 the first Adam update
is ``-lr * sign(g)`` for any non-zero gradient, so where the two packages'
gradients agree in sign the updated parameters agree to 1e-6, and only
entries whose gradient is below the gradients' own tolerance (2e-6) may
differ, by at most 2 * lr. The optimizer alone is held to optax over five
steps of well-scaled gradients at rtol 1e-5. One case repeats the shipped
route with bf16 operands: a last-bit difference of a sample depth can flip
the bf16 rounding of an activation, and a table row collects only a few
points, so its gradients get an atol of 2e-2 of the leaf's largest entry and
its losses rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.data.types import Intrinsics as JIntrinsics
from nerf_kinematics_tpu.ops.occupancy import OccupancyGrid as JGrid
from nerf_kinematics_tpu.train import config as jcfg
from nerf_kinematics_tpu.train.ngp_engine import NGPEngine as JEngine
from nerf_kinematics_tpu_torch.data.machina import machina_intrinsics
from nerf_kinematics_tpu_torch.io import convert
from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
from nerf_kinematics_tpu_torch.train import config as tcfg
from nerf_kinematics_tpu_torch.train import loop as tloop
from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

N_RAYS, N_COARSE, N_FINE, OCC = 128, 8, 6, 16
NEAR, FAR = 2.0, 6.0
ROUTES = {"fused_objective": ("on", "auto"), "fused_vjp": ("on", "off"),
          "unfused": ("off", "auto"), "full": ("on", "full")}
ONE_CALL = ("fused_objective", "full")  # routes with a fused objective


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: several intra-op threads per test worker only
    fight over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _raw(fused="on", fused_train="auto", use_occ=True, ema=0.0, lr_decay=6,
         bf16=True):
    return {
        "engine": "ngp",
        "ngp": {
            "encoder": "cp_pallas", "n_levels": 3, "n_components": 16,
            "table_size": 48, "base_resolution": 8, "max_resolution": 32,
            "density_width": 32, "density_out": 16, "color_width": 32,
            "color_layers": 3, "use_occupancy": use_occ, "occ_resolution": OCC,
            "occ_bins": 8, "fused": fused, "fused_train": fused_train,
            "occ_incremental_cells": 300, "cp": {"use_bf16": bf16},
        },
        "dataset": {"near": NEAR, "far": FAR},
        "nerf": {
            "train": {"num_coarse": N_COARSE, "num_fine": N_FINE,
                      "white_background": True, "num_random_rays": N_RAYS,
                      "pixel_sampler": "shuffled"},
            "validation": {"num_coarse": N_COARSE, "num_fine": N_FINE,
                           "perturb": False, "white_background": True},
            "coarse_loss_weight": 0.0, "ema_decay": ema,
        },
        "optimizer": {"lr": 0.01},
        "scheduler": {"lr_decay": lr_decay, "lr_decay_factor": 0.33},
    }


def _draws(seed=5, n_total=300):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n_total, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d *= rng.uniform(0.9, 1.1, (n_total, 1)).astype(np.float32)
    o = -4.0 * d + 0.15 * rng.standard_normal((n_total, 3)).astype(np.float32)
    return {
        "ray_buf": {"rays_o": o.astype(np.float32), "rays_d": d,
                    "target": rng.uniform(size=(n_total, 3)).astype(np.float32)},
        "offset": 37,
        "u_coarse": rng.uniform(size=(N_RAYS, N_COARSE)).astype(np.float32),
        "u_fine": rng.uniform(size=(N_RAYS, N_FINE)).astype(np.float32),
    }


def _grid():
    lin = (np.arange(OCC) + 0.5) / OCC * 2 - 1
    xs, ys, zs = np.meshgrid(lin, lin, lin, indexing="ij")
    r = np.sqrt(xs**2 + 1.3 * ys**2 + 0.8 * zs**2)
    return np.where(r < 0.7, 20.0 * (1.0 - r), 0.02).astype(np.float32)


def _patch_jax_draws(monkeypatch, draws):
    """The reference draws with jax.random; hand it the test's numbers."""
    by_shape = {(N_RAYS, N_COARSE): draws["u_coarse"], (N_RAYS, N_FINE): draws["u_fine"]}

    def uniform(key, shape=(), dtype=jnp.float32, **kw):
        return jnp.asarray(by_shape[tuple(shape)], dtype)

    def randint(key, shape, minval, maxval, dtype=jnp.int32):
        assert tuple(shape) == ()
        return jnp.asarray(draws["offset"], dtype)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "randint", randint)


class _Pair:
    """Both engines on the same freshly initialised weights and grid."""

    def __init__(self, route, use_occ=True, ema=0.0, bf16=True):
        fused, fused_train = ROUTES[route]
        raw = _raw(fused, fused_train, use_occ, ema, bf16=bf16)
        self.je = JEngine(jcfg.config_from_dict(raw), scene_bound=1.0)
        self.jstate = self.je.init_state(seed=9)
        tree = jax.tree_util.tree_map(np.array, self.jstate.params["coarse"])
        self.te = NGPEngine(tcfg.config_from_dict(raw), scene_bound=1.0, device="cpu")
        self.te.load_flax_params(tree)
        self.tstate = self.te.init_state(seed=9, keep_weights=True)
        if use_occ:
            dens = _grid()
            self.jstate = self.jstate._replace(aux=JGrid(jnp.asarray(dens), jnp.float32(1.0)))
            self.tstate.aux = grid_from_numpy(dens, 1.0)
        ti = machina_intrinsics(16)
        self.tintr = ti
        self.jintr = JIntrinsics(fl_x=ti.fl_x, fl_y=ti.fl_y, cx=ti.cx, cy=ti.cy,
                                 width=16, height=16)

    def named(self, tree):
        return convert.named_from_flax(jax.tree_util.tree_map(np.asarray, tree))

    def jax_moments(self, opt_state):
        P = self.te.layout.total
        big = [np.asarray(l) for l in jax.tree_util.tree_leaves(opt_state)
               if np.size(l) == P]
        assert len(big) == 2  # mu, nu of the flattened Adam
        counts = [int(l) for l in jax.tree_util.tree_leaves(opt_state) if np.ndim(l) == 0]
        return big[0], big[1], counts


# the whole-step route needs the hull proposal: with the grid only
CASES = [(r, occ, False) for r in sorted(ROUTES) for occ in (True, False)
         if occ or r != "full"]
CASES.append(("fused_objective", True, True))  # the shipped route in bf16 mode
CASES.append(("full", True, True))


@pytest.mark.parametrize(
    "route,use_occ,bf16", CASES,
    ids=[f"{r}-{'occ' if o else 'no_occ'}-{'bf16' if b else 'f32'}" for r, o, b in CASES])
def test_train_step_matches_jax(route, use_occ, bf16, monkeypatch):
    ema = 0.9 if (route == "fused_objective" and use_occ) else 0.0
    pr = _Pair(route, use_occ, ema, bf16)
    draws = _draws()
    _patch_jax_draws(monkeypatch, draws)
    settings = pr.je.cfg.nerf.train
    assert (pr.je.fused_objective_fn(NEAR, FAR, settings) is not None) == (
        route in ONE_CALL)
    assert (pr.te.fused_objective_fn(NEAR, FAR, pr.te.cfg.nerf.train) is not None) == (
        route in ONE_CALL)

    # ---- the whole step ---------------------------------------------------
    jbuf = {k: jnp.asarray(v) for k, v in draws["ray_buf"].items()}
    jstep = pr.je.make_train_step(pr.jintr, NEAR, FAR, False, donate=False)
    jnew, jm = jstep(pr.jstate, None, None, jbuf)

    tbuf = {k: torch.tensor(v) for k, v in draws["ray_buf"].items()}
    tstep = pr.te.make_train_step(pr.tintr, NEAR, FAR, False)
    before = pr.tstate.clone()
    tnew, tm = tstep(pr.tstate, None, None, tbuf, offset=draws["offset"],
                     u_coarse=torch.tensor(draws["u_coarse"]),
                     u_fine=torch.tensor(draws["u_fine"]))
    assert tnew is pr.tstate and int(tnew.step) == 1 == int(jnew.step)
    rtol = 1e-4 if bf16 else 1e-5
    for k in ("loss", "loss_coarse", "loss_fine", "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, err_msg=k)
    assert float(tm["loss"]) == float(tm["loss_fine"])  # coarse weight 0

    # ---- gradients, leaf by leaf -----------------------------------------
    sl = slice(draws["offset"], draws["offset"] + N_RAYS)
    o, d, t = (draws["ray_buf"][k][sl] for k in ("rays_o", "rays_d", "target"))
    vdn = d / np.linalg.norm(d, axis=-1, keepdims=True)
    jbatch = tuple(jnp.asarray(a) for a in (o, d, vdn, t))
    key = jax.random.PRNGKey(0)
    jobj = pr.je.fused_objective_fn(NEAR, FAR, settings)
    if jobj is not None:
        (_, (jlc, jlf)), jg = jobj(pr.jstate.params, jbatch, key, pr.jstate.aux)
    else:
        from nerf_kinematics_tpu.rendering.renderer import render_rays

        def loss_fn(params):
            cf_c, cf_f = pr.je.cf_apply_fns()
            coarse, fine = render_rays(
                params["coarse"], pr.je.apply_coarse, jbatch[0], jbatch[1], NEAR, FAR,
                settings, key=key, use_viewdirs=True, viewdirs=jbatch[2],
                proposal_fn=pr.je.proposal_for(pr.jstate.aux, NEAR, FAR, settings),
                apply_coarse_cf=cf_c, apply_fine_cf=cf_f)
            return jnp.mean((fine.rgb - jbatch[3]) ** 2)

        jg = jax.grad(loss_fn)(pr.jstate.params)
    jgrads = pr.named(jg["coarse"])
    objective = tloop.build_objective(pr.te, NEAR, FAR)
    pr.te.layout.bind(pr.te.model, before.params)
    tbatch = tuple(torch.tensor(a) for a in (o, d, vdn, t))
    (_, (tlc, tlf)), tgrads = objective(
        tbatch, before.aux, before.generator,
        u_coarse=torch.tensor(draws["u_coarse"]), u_fine=torch.tensor(draws["u_fine"]))
    np.testing.assert_allclose(float(tlf), float(jm["loss_fine"]), rtol=rtol)
    np.testing.assert_allclose(float(tlc), float(jm["loss_coarse"]), rtol=rtol)
    assert set(tgrads) == set(jgrads)
    live = 0
    for name, want in jgrads.items():
        got = tgrads[name].numpy()
        assert got.shape == want.shape, name
        atol = 2e-2 * np.abs(want).max() if bf16 else 1e-6
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=atol, err_msg=name)
        live += np.abs(want).max() > 0
    assert live >= 5
    if bf16:
        return  # the optimizer is compared on the f32 cases

    # ---- updated parameters, Adam's moments, EMA --------------------------
    layout = pr.te.layout
    g_flat = layout.flatten({k: torch.tensor(v) for k, v in jgrads.items()}).numpy()
    p_new = layout.flatten({k: torch.tensor(v) for k, v in
                            pr.named(jnew.params["coarse"]).items()}).numpy()
    sure = np.abs(g_flat) > 2e-6
    assert sure.mean() > 0.2
    diff = np.abs(tnew.params.numpy() - p_new)
    assert diff[sure].max() <= 1e-6
    assert diff.max() <= 2 * 0.01 + 1e-6
    moved = np.abs(tnew.params.numpy() - before.params.numpy())
    np.testing.assert_allclose(moved[sure], 0.01, rtol=1e-4)  # lr * sign(g)
    mu, nu, counts = pr.jax_moments(jnew.opt_state)
    # mu = 0.1 g and sqrt(nu) = 0.1 |g|: a tenth of the gradients' tolerance
    np.testing.assert_allclose(tnew.opt_state.mu.numpy(),
                               convert.flat_from_reference(mu, layout).numpy(),
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(np.sqrt(tnew.opt_state.nu.numpy()),
                               np.sqrt(convert.flat_from_reference(nu, layout).numpy()),
                               rtol=1e-3, atol=1e-7)
    assert int(tnew.opt_state.count) == 1 and set(counts) == {1}
    if ema:
        e_new = layout.flatten({k: torch.tensor(v) for k, v in
                                pr.named(jnew.ema["coarse"]).items()}).numpy()
        d_e = np.abs(tnew.ema.numpy() - e_new)
        assert d_e[sure].max() <= 1e-6 and d_e.max() <= 0.1 * 0.02 + 1e-6
        assert tloop.eval_params(tnew) is tnew.ema
    else:
        assert tnew.ema is None and jnew.ema is None
        assert tloop.eval_params(tnew) is tnew.params


def test_adam_matches_optax_over_steps():
    """Masked coupled decay before Adam, bias correction, eps outside the
    root, the schedule at the count before the increment: five updates from
    the same well-scaled gradients."""
    raw = _raw(lr_decay=1)  # 0.33^(step/1000): visible within five steps
    je = JEngine(jcfg.config_from_dict(raw), scene_bound=1.0)
    jstate = je.init_state(seed=3)
    te = NGPEngine(tcfg.config_from_dict(raw), scene_bound=1.0, device="cpu")
    te.load_flax_params(jax.tree_util.tree_map(np.array, jstate.params["coarse"]))
    tstate = te.init_state(seed=3, keep_weights=True)
    layout = te.layout
    sched = tloop.lr_schedule(te.cfg)
    mask = layout.decay_mask()
    names = [e[0] for e in layout.entries]
    assert mask[layout.entries[names.index("density_0.kernel")][2]] == tloop.WEIGHT_DECAY
    assert mask[layout.entries[names.index("density_0.bias")][2]] == 0
    assert mask[layout.entries[names.index("cp_lines")][2]] == 0
    # blow the kernels up so that the 1e-6 decay term shows at rtol 1e-5
    big = jax.tree_util.tree_map(lambda p: p * 1e3, jstate.params)
    opt_state = je.optimizer.init(big)
    params = big
    tstate.params.mul_(1e3)
    rng = np.random.default_rng(4)
    import optax

    for step in range(5):
        g_named = {n: (rng.standard_normal(s) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
                   for n, s, _, _ in layout.entries}
        jgrads = {"coarse": jax.tree_util.tree_map(
            jnp.asarray, convert.params_to_flax({k: torch.tensor(v) for k, v in g_named.items()}))}
        updates, opt_state = je.optimizer.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tloop.adam_update(tstate.params, layout.flatten(
            {k: torch.tensor(v) for k, v in g_named.items()}), tstate.opt_state, sched, mask)
        want = layout.flatten({k: torch.tensor(v) for k, v in convert.named_from_flax(
            jax.tree_util.tree_map(np.asarray, params["coarse"])).items()}).numpy()
        np.testing.assert_allclose(tstate.params.numpy(), want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"step {step}")
    assert int(tstate.opt_state.count) == 5
    np.testing.assert_allclose(float(sched(torch.tensor(3000))), 0.01 * 0.33**3.0, rtol=1e-5)
    np.testing.assert_allclose(sched(3000), 0.01 * 0.33**3.0, rtol=1e-12)
    # the flat-order bridge is its own inverse
    v = np.arange(layout.total, dtype=np.float32)
    back = convert.flat_to_reference(convert.flat_from_reference(v, layout), layout)
    assert np.array_equal(back, v)
    st = convert.adam_state_from_reference(v, 2 * v, 7, layout)
    assert int(st.count) == 7 and torch.equal(st.nu, 2 * st.mu)


def test_update_grid_incremental_matches_jax(monkeypatch):
    pr = _Pair("fused_objective")
    rng = np.random.default_rng(6)
    n_cells = pr.te.ngp_config.occ_incremental_cells
    idx = rng.integers(0, OCC**3, n_cells)
    idx[:20] = idx[20:40]  # cells drawn twice: the scatter takes the max
    u = rng.uniform(size=(n_cells, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, dtype=jnp.int32: jnp.asarray(idx, dtype))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, **kw: jnp.asarray(u).reshape(shape))
    want = np.asarray(pr.je.update_occupancy(pr.jstate, full=False).aux.density)
    old = pr.tstate.aux.density.clone()
    got = pr.te.update_occupancy(pr.tstate.aux, full=False, idx=torch.tensor(idx),
                                 u=torch.tensor(u)).density.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    untouched = np.ones(OCC**3, bool)
    untouched[idx] = False
    np.testing.assert_allclose(got.reshape(-1)[untouched],
                               0.95 * old.numpy().reshape(-1)[untouched], rtol=1e-6)
    assert (got.reshape(-1)[idx] >= 0.95 * old.numpy().reshape(-1)[idx] - 1e-6).all()
    # through the state, with the state's generator: the grid changes, the
    # parameters do not
    p0 = pr.tstate.params.clone()
    st = pr.te.update_occupancy(pr.tstate, full=False)
    assert st is pr.tstate and torch.equal(st.params, p0)
    assert not np.array_equal(st.aux.density.numpy(), old.numpy())


def test_fused_objective_eligibility():
    """The same routes as the reference's
    tests/test_fused_train.py::test_fused_objective_eligibility."""
    def engine(**kw):
        raw = _raw(**{k: v for k, v in kw.items() if k in ("fused", "fused_train")})
        cfg = tcfg.config_from_dict(raw)
        if "n_rays" in kw:
            cfg = cfg.replace(nerf=dataclasses.replace(cfg.nerf, num_random_rays=kw["n_rays"]))
        if "cw" in kw:
            cfg = cfg.replace(nerf=dataclasses.replace(cfg.nerf, coarse_loss_weight=kw["cw"]))
        return NGPEngine(cfg, scene_bound=1.0, device="cpu")

    obj = lambda e: e.fused_objective_fn(NEAR, FAR, e.cfg.nerf.train)
    assert obj(engine(fused_train="auto")) is not None
    assert obj(engine(fused_train="off")) is None
    assert obj(engine(fused_train="auto", n_rays=200)) is None
    with pytest.raises(ValueError, match="fused_train"):
        obj(engine(fused_train="on", n_rays=200))
    assert obj(engine(fused_train="auto", cw=0.1)) is None
    assert obj(engine(fused="off", fused_train="auto")) is None
    # the whole step in one call (ported: row 8) is the explicit opt-in
    assert obj(engine(fused_train="full")).__name__ == "objective_full"
    assert obj(engine(fused_train="full", n_rays=200)) is None
    assert obj(engine(fused_train="auto")).__name__ == "objective"


@pytest.mark.parametrize("sampler", ["random", "shuffled"])
def test_samplers_and_train_many(sampler):
    """Both pixel samplers feed the step; a chunk of steps keeps its metrics
    on the device and lowers the loss; the generator's draws are reproducible
    from a cloned state."""
    raw = _raw()
    raw["nerf"]["train"]["pixel_sampler"] = sampler
    te = NGPEngine(tcfg.config_from_dict(raw), scene_bound=1.0, device="cpu")
    state = te.init_state(seed=2)
    intr = machina_intrinsics(16)
    rng = np.random.default_rng(8)
    images = torch.tensor(np.broadcast_to(
        rng.uniform(0.2, 0.8, (4, 1, 1, 3)), (4, 16, 16, 3)).astype(np.float32).copy())
    from nerf_kinematics_tpu_torch.data.machina import orbit_poses

    poses = torch.tensor(orbit_poses(4))
    buf = tloop.build_shuffled_ray_buffer(images, poses, intr, seed=1) \
        if sampler == "shuffled" else None
    if buf is not None:
        assert buf["rays_o"].shape == (4 * 256, 3)
        again = tloop.build_shuffled_ray_buffer(images, poses, intr, seed=1)
        assert torch.equal(again["target"], buf["target"])
        ident = tloop.build_shuffled_ray_buffer(images, poses, intr,
                                                perm=torch.arange(4 * 256))
        assert torch.equal(ident["target"], images.reshape(-1, 3))
    twin = state.clone()
    many = te.make_train_many(intr, NEAR, FAR, False, steps_per_call=6)
    state, metrics = many(state, images, poses, buf)
    assert isinstance(metrics["loss"], torch.Tensor) and metrics["losses"].shape == (6,)
    assert int(state.step) == 6 and torch.isfinite(metrics["losses"]).all()
    assert float(metrics["losses"][-1]) < float(metrics["losses"][0])
    step = te.make_train_step(intr, NEAR, FAR, False)
    for _ in range(6):
        twin, m = step(twin, images, poses, buf)
    assert torch.equal(twin.params, state.params)
    np.testing.assert_allclose(float(m["psnr"]),
                               -10 * np.log10(max(float(m["loss_fine"]), 1e-12)), rtol=1e-5)
    if sampler == "shuffled":
        with pytest.raises(ValueError, match="ray_buf"):
            step(twin, images, poses, None)
