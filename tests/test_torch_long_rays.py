"""Fine rays longer than the bf16 gradient kernel's tile, on the CPU.

The reference takes a fine ray of any length S (``ngp_fused_train_cf``
asks only that N be a multiple of S * 128), and so does the port: where a
ray is longer than a tile of the tile kernel (``ops/ngp_fused_cuda.py::
bwd_plan``, 64 points at these widths), the kernel runs its forward
alone, the rays' kernel and its VJP (``long_rays``). On the CPU the
wrappers take their plain versions, so these tests hold the engine's fused
objectives and the plain row 7 at S = 65 against the JAX package: one
train step on the ``on`` and the ``full`` route in both modes (tolerances
as in ``tests/test_torch_train_step.py``), and the exact zeros and signs of
the plain row 7's gradient against the reference kernel's (interpret
mode).
The kernel itself runs on the card (``chip_smoke.py``'s ``grad_kernels``
phase holds it to the plain version at long rays).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_kernels as tk
import test_torch_train_step as ts
from nerf_kinematics_tpu.ops import ngp_fused_pallas as jf
from nerf_kinematics_tpu.ops.cp_grid import CPGridConfig as JCP
from nerf_kinematics_tpu_torch.io import convert
from nerf_kinematics_tpu_torch.ops import ngp_fused_cuda as nf
from nerf_kinematics_tpu_torch.ops.cp_grid import CPGridConfig

# test_torch_train_step.py's widths with an encoding of 3 x 96: above 256
# channels a tile holds 64 points (the reference's slow steps grow with S)
C_WIDE = 96
SHAPES = [(3 * C_WIDE, 32), (32, 32), (32, 16), (32, 32), (32, 32), (32, 3)]
S_LONG = 65


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: several intra-op threads per test worker only
    fight over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_s_long_is_longer_than_a_tile():
    plan = nf.bwd_plan(SHAPES, 3, C_WIDE, 3, S_LONG)
    assert plan.points == 64 < S_LONG and plan.long_rays
    assert (plan.rays, plan.tile_points) == (0, plan.points)
    assert not nf.bwd_plan(SHAPES, 3, C_WIDE, 3, plan.points).long_rays


def _step_with_long_rays(route, bf16, monkeypatch):
    """One step of the engine's fused objective (``on``: two calls;
    ``full``: the whole step) with fine rays of 65 samples against the
    JAX engine's step with the same draws: the losses, and the gradient
    leaf by leaf as Adam's first moment after the step holds it (a tenth of
    the gradient and of the decay term); in f32 mode also the updated
    parameters, as ``tests/test_torch_train_step.py`` holds them."""
    raw = ts._raw

    def wide(*args, **kw):
        out = raw(*args, **kw)
        out["ngp"]["n_components"] = C_WIDE
        return out

    monkeypatch.setattr(ts, "_raw", wide)
    monkeypatch.setattr(ts, "N_FINE", S_LONG)
    pr = ts._Pair(route, use_occ=True, bf16=bf16)
    assert pr.te.ngp_config.cp.out_dim == 3 * C_WIDE
    draws = ts._draws()
    ts._patch_jax_draws(monkeypatch, draws)
    settings = pr.te.cfg.nerf.train
    assert settings.num_fine == S_LONG
    assert pr.je.fused_objective_fn(ts.NEAR, ts.FAR, pr.je.cfg.nerf.train) is not None
    assert pr.te.fused_objective_fn(ts.NEAR, ts.FAR, settings) is not None

    jbuf = {k: jnp.asarray(v) for k, v in draws["ray_buf"].items()}
    jstep = pr.je.make_train_step(pr.jintr, ts.NEAR, ts.FAR, False, donate=False)
    jnew, jm = jstep(pr.jstate, None, None, jbuf)
    tbuf = {k: torch.tensor(v) for k, v in draws["ray_buf"].items()}
    tstep = pr.te.make_train_step(pr.tintr, ts.NEAR, ts.FAR, False)
    before = pr.tstate.params.clone()
    tnew, tm = tstep(pr.tstate, None, None, tbuf, offset=draws["offset"],
                     u_coarse=torch.tensor(draws["u_coarse"]),
                     u_fine=torch.tensor(draws["u_fine"]))
    rtol = 1e-4 if bf16 else 1e-5
    for k in ("loss", "loss_coarse", "loss_fine", "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, err_msg=k)

    layout = pr.te.layout
    mu, _, counts = pr.jax_moments(jnew.opt_state)
    want = layout.views(convert.flat_from_reference(mu, layout))
    got = layout.views(tnew.opt_state.mu)
    assert int(tnew.opt_state.count) == 1 and set(counts) == {1}
    live = 0
    for name, w in want.items():
        w, g = w.numpy(), got[name].numpy()
        atol = 2e-2 * np.abs(w).max() if bf16 else 1e-7
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=atol, err_msg=name)
        live += np.abs(w).max() > 0
    assert live >= 5
    if bf16:
        return
    p_new = layout.flatten({k: torch.tensor(v) for k, v in
                            pr.named(jnew.params["coarse"]).items()}).numpy()
    sure = np.abs(convert.flat_from_reference(mu, layout).numpy()) > 2e-7
    assert sure.mean() > 0.1  # the wide tables' rarely tapped rows are small
    diff = np.abs(tnew.params.numpy() - p_new)
    assert diff[sure].max() <= 1e-6 and diff.max() <= 2 * 0.01 + 1e-6
    moved = np.abs(tnew.params.numpy() - before.numpy())
    np.testing.assert_allclose(moved[sure], 0.01, rtol=1e-4)  # lr * sign(g)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("route", ["fused_objective", "full"])
def test_train_step_with_long_rays_matches_jax(route, bf16, monkeypatch):
    """``fused_train: on`` (row 7) and ``full`` (row 8, its fine stage),
    a fine ray of 65 samples."""
    _step_with_long_rays(route, bf16, monkeypatch)


def test_plain_row7_zeros_and_signs_match_the_reference():
    """The plain row 7 (what the card's kernel is held to) at S = 65 in
    bf16 mode at an encoding of 3 x 96, on a table with a dead row
    (``fold_cap``; a ray longer than a tile there): every gradient
    entry that the reference kernel gives as exactly 0 is exactly 0, and
    no other; no entry has the other sign. With the fast engine's Adam
    (eps 1e-15) the step of an entry is about lr * sign(g) however small g
    is, so these decide the update where the gradients' tolerance cannot."""
    cp = dict(tk.CPS["fold_cap"], n_components=C_WIDE, use_bf16=True)
    R, S = 128, S_LONG
    rng = np.random.default_rng(35)
    params = tk._params(rng, cp)
    params["db"][-1][0] += 1.5
    xt, vd = tk._points(rng, R * S)
    vd = np.repeat(vd[:, :R], S, axis=1)
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=1).astype(np.float32)
    norm = rng.uniform(0.9, 1.1, (R, 1)).astype(np.float32)
    dists = np.concatenate([z[:, 1:] - z[:, :-1], np.full((R, 1), 1e10, np.float32)],
                           axis=1) * norm
    dists = dists.reshape(1, -1).astype(np.float32)
    tgt = rng.uniform(size=(3, R)).astype(np.float32)
    inv = 1.0 / (3.0 * R)
    _, _, d_j = jf.ngp_fused_train_cf(
        tk._to(params, jnp.asarray), jnp.asarray(tk._bsm(xt, S)),
        jnp.asarray(tk._bsm(vd, S)), jnp.asarray(tk._bsm(dists, S)), jnp.asarray(tgt),
        JCP(**cp), S, True, inv, interpret=True)
    d_j = dict(d_j, lines=jf.fold_dlines(d_j["lines"], JCP(**cp)))
    _, _, d_t = nf.ngp_fused_train_cf(
        tk._to(params, torch.tensor), torch.tensor(xt), torch.tensor(vd),
        torch.tensor(dists), torch.tensor(tgt), CPGridConfig(**cp), S, True, inv)
    zeros = 0
    for (name, a), (_, b) in zip(tk._leaves(tk._to(d_t, lambda t: t.numpy())),
                                 tk._leaves(d_j)):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(a == 0, b == 0, err_msg=name)
        assert not (np.sign(a) * np.sign(b) < 0).any(), name
        zeros += int((b == 0).sum())
    assert zeros > 1000  # the dead row, never-tapped rows, dead ReLUs
