"""The classic engine's model pieces against the JAX package, on the CPU:
positional encoding, ``FlexibleNeRF`` on weights carried across from the flax
``init``, the parameter and legacy-checkpoint bridges, and ``ndc_rays``.

Tolerances. Encoding: atol 1e-5 (the sin and cos of the two frameworks reduce
arguments of up to 2^(L-1) |x| ~ 3000 rad differently: a few 1e-6 apart).
Module in f32: rtol 2e-5 / atol 2e-6, as the reference's own classic tests
(``tests/test_classic_fused.py``). Module in bf16: every layer rounds its
output to bf16 (3 significant digits) and the two frameworks may round a sum
differently, so atol 2e-2 on the outputs, as ``test_torch_model.py`` for the
fast engine's bf16 module. ``ndc_rays``: rtol 1e-6 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.cameras.rays import ndc_rays as j_ndc_rays
from nerf_kinematics_tpu.io import torch_compat as j_compat
from nerf_kinematics_tpu.models.flexible_nerf import FlexibleNeRF as JFlexibleNeRF
from nerf_kinematics_tpu.models.flexible_nerf import FlexibleNeRFConfig as JFCfg
from nerf_kinematics_tpu.ops.classic_fused_pallas import _pe_rows as j_pe_rows
from nerf_kinematics_tpu.ops.positional_encoding import positional_encoding as j_pe
from nerf_kinematics_tpu_torch.cameras.rays import ndc_rays
from nerf_kinematics_tpu_torch.io import convert, torch_compat
from nerf_kinematics_tpu_torch.models.flexible_nerf import FlexibleNeRF, FlexibleNeRFConfig
from nerf_kinematics_tpu_torch.ops.positional_encoding import (
    encoding_dim, encoding_rows, positional_encoding)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: several intra-op threads per test worker only
    fight over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SMALL = dict(hidden_size=32, num_encoding_fn_xyz=4, num_encoding_fn_dir=2)


def _points(n, seed=3, scale=1.5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    vd = rng.standard_normal((n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return x, vd


def _pair(**kw):
    """The flax module and the port's on the same weights (biases given
    values, so a dropped bias would show)."""
    jcfg = JFCfg(**kw)
    jm = JFlexibleNeRF(jcfg)
    x0 = np.zeros((1, 3), np.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(5), x0, x0 if jcfg.use_viewdirs else None))
    rng = np.random.default_rng(6)
    for leaf in tree["params"].values():
        leaf["bias"] = (0.2 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32)
    tm = FlexibleNeRF(FlexibleNeRFConfig(**kw))
    sd = {k: torch.tensor(v) for k, v in
          torch_compat.flax_to_torch_state_dict(tree).items()}
    tm.load_state_dict(sd)
    return jm, tree, tm


@pytest.mark.parametrize("log_sampling", [True, False], ids=["log", "linear"])
@pytest.mark.parametrize("include_input", [True, False], ids=["with_input", "no_input"])
def test_positional_encoding_matches_jax(log_sampling, include_input):
    x, _ = _points(97, scale=6.0)
    for L in (0, 4, 10):
        want = np.asarray(j_pe(jnp.asarray(x), L, include_input, log_sampling))
        got = positional_encoding(torch.tensor(x), L, include_input, log_sampling)
        assert got.shape == want.shape == (97, encoding_dim(3, L, include_input))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        # the fused kernel's channels-first rows
        got_cf = encoding_rows(torch.tensor(x.T), L, include_input, log_sampling)
        assert got_cf.shape[0] == encoding_dim(3, L, include_input)
        if L or include_input:
            want_cf = np.asarray(j_pe_rows(jnp.asarray(x.T), L, include_input, log_sampling))
            np.testing.assert_allclose(got_cf.numpy(), want_cf, rtol=0, atol=1e-5)


def test_config_properties_match_jax():
    for kw in ({}, SMALL, dict(num_layers=12, include_input_xyz=False)):
        j, t = JFCfg(**kw), FlexibleNeRFConfig(**kw)
        assert (t.dim_xyz, t.dim_dir, t.trunk_depth) == (j.dim_xyz, j.dim_dir, j.trunk_depth)


CASES = {
    "f32": (dict(SMALL), 2e-5, 2e-6),
    "bf16": (dict(SMALL, compute_dtype="bfloat16"), 0.0, 2e-2),
    "skip_fires": (dict(SMALL, num_layers=12), 2e-5, 2e-6),
    "no_viewdirs": (dict(SMALL, use_viewdirs=False), 2e-5, 2e-6),
    "full_width": ({}, 2e-5, 2e-6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flexible_nerf_matches_flax(case):
    kw, rtol, atol = CASES[case]
    jm, tree, tm = _pair(**kw)
    x, vd = _points(300 if case == "full_width" else 120)
    vd_j = jnp.asarray(vd) if tm.config.use_viewdirs else None
    rgb_j, sig_j = jm.apply(tree, jnp.asarray(x), vd_j)
    with torch.no_grad():
        rgb_t, sig_t = tm(torch.tensor(x), torch.tensor(vd) if vd_j is not None else None)
    assert rgb_t.shape == (len(x), 3) and sig_t.shape == (len(x),)
    assert rgb_t.dtype == sig_t.dtype == torch.float32
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=rtol, atol=atol)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=rtol, atol=atol)
    # the parameter names are the reference checkpoints'
    names = set(tm.state_dict())
    if case == "full_width":
        assert {"layer1.weight", "layers_xyz.2.weight", "fc_alpha.bias", "fc_feat.weight",
                "layers_dir.0.weight", "fc_rgb.weight"} <= names
        assert tuple(tm.layers_dir[0].weight.shape) == (64, 155)
        assert tuple(tm.layer1.weight.shape) == (128, 63)
    if case == "skip_fires":
        assert tm.layers_xyz[3].weight.shape[1] == 32 + tm.config.dim_xyz
    if case == "no_viewdirs":
        assert "fc_out.weight" in names and "fc_rgb.weight" not in names


def test_init_scale_is_the_reference_dense_layers():
    """Truncated lecun-normal weights (std in^-1/2), zero biases."""
    tm = FlexibleNeRF(FlexibleNeRFConfig(), generator=torch.Generator().manual_seed(0))
    for lin in tm.linears:
        fan_in = lin.weight.shape[1]
        w = lin.weight.detach().numpy()
        assert np.abs(w).max() <= 2.0 * fan_in**-0.5 / 0.87962566103423978 + 1e-6
        if w.size > 1000:
            np.testing.assert_allclose(w.std(), fan_in**-0.5, rtol=0.1)
        assert not lin.bias.detach().any()


def test_parameter_bridges_round_trip():
    """flax {coarse, fine} trees <-> ClassicModel state dict; the legacy
    mapping matches the reference's own."""
    from nerf_kinematics_tpu_torch.train.loop import ClassicModel

    cfg = FlexibleNeRFConfig(**SMALL)
    jm = JFlexibleNeRF(JFCfg(**SMALL))
    x0 = np.zeros((1, 3), np.float32)
    tree = {net: jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(k), x0, x0))
            for k, net in enumerate(("coarse", "fine"))}
    sd = convert.classic_params_from_flax(tree)
    model = ClassicModel(cfg, cfg)
    model.load_state_dict(sd)  # every name and shape fits
    w = tree["coarse"]["params"]["layers_dir_0"]["kernel"]
    assert torch.equal(sd["coarse.layers_dir.0.weight"], torch.tensor(w.T))
    back = convert.classic_params_to_flax(model.state_dict())
    for net in ("coarse", "fine"):
        for mod, leaves in tree[net]["params"].items():
            for leaf, arr in leaves.items():
                assert np.array_equal(back[net]["params"][mod][leaf], arr), (net, mod, leaf)
    # the same mapping as the reference's torch_compat
    ref_sd = j_compat.flax_to_torch_state_dict(tree["fine"])
    ours = torch_compat.flax_to_torch_state_dict(tree["fine"])
    assert set(ref_sd) == set(ours)
    assert all(np.array_equal(ref_sd[k], ours[k]) for k in ours)


def test_legacy_checkpoints_cross_between_packages(tmp_path):
    """A file the JAX package exports loads in the port, and the other way
    round, to the bit."""
    jm = JFlexibleNeRF(JFCfg(**SMALL))
    x0 = np.zeros((1, 3), np.float32)
    pc = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), x0, x0))
    pf = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2), x0, x0))
    path = tmp_path / "checkpoint7.ckpt"
    j_compat.export_legacy_checkpoint(path, 7, pc, pf, loss=0.5, psnr=21.0)
    got = torch_compat.import_legacy_checkpoint(path)
    assert got["step"] == 7 and got["loss"] == 0.5 and got["psnr"] == 21.0
    model = FlexibleNeRF(FlexibleNeRFConfig(**SMALL))
    model.load_state_dict(got["state_fine"])
    want = j_compat.flax_to_torch_state_dict(pf)
    assert all(np.array_equal(got["state_fine"][k].numpy(), v) for k, v in want.items())

    path2 = tmp_path / "checkpoint9.ckpt"
    # (the reference's import reads loss and psnr as floats: give both)
    torch_compat.export_legacy_checkpoint(path2, 9, model.state_dict(), None, loss=0.25,
                                          psnr=30.0)
    back = j_compat.import_legacy_checkpoint(path2)
    assert back["step"] == 9 and back["params_fine"] is None and back["loss"] == 0.25
    for mod, leaves in pf["params"].items():
        for leaf, arr in leaves.items():
            assert np.array_equal(back["params_coarse"]["params"][mod][leaf], arr)
    torch_compat.export_legacy_checkpoint(path2, 9, model.state_dict())
    again = torch_compat.import_legacy_checkpoint(path2)
    assert again["state_fine"] is None and again["psnr"] is None and again["loss"] is None


def test_ndc_rays_matches_jax():
    rng = np.random.default_rng(11)
    o = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(-0.2, 0.2, 64)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    for H, W, focal, near in ((48, 64, 55.0, 1.0), (40, 40, 30.5, 0.7)):
        jo, jd = j_ndc_rays(H, W, focal, near, jnp.asarray(o), jnp.asarray(d))
        to, td = ndc_rays(H, W, focal, near, torch.tensor(o), torch.tensor(d))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    # batched (H, W, 3) rays keep their shape
    to, td = ndc_rays(4, 5, 3.0, 1.0, torch.tensor(o[:20]).reshape(4, 5, 3),
                      torch.tensor(d[:20]).reshape(4, 5, 3))
    assert to.shape == td.shape == (4, 5, 3)
