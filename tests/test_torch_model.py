"""``NGPModel`` parity: the flax module against the port's ``nn.Module`` on
bridged weights, ``__call__`` and ``density``.

Tolerances: f32 compute atol 1e-5; bf16 compute atol 2e-2 on logits and
features (a bf16 ``Dense`` rounds its outputs to bf16, 3 significant digits,
and the two frameworks may round a sum differently), sigma rtol 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.models.ngp import NGPConfig as JNGPConfig
from nerf_kinematics_tpu.models.ngp import NGPModel as JNGPModel
from nerf_kinematics_tpu.ops.cp_grid import CPGridConfig as JCP
from nerf_kinematics_tpu_torch.io.convert import params_from_flax
from nerf_kinematics_tpu_torch.models.ngp import NGPConfig, NGPModel
from nerf_kinematics_tpu_torch.ops.cp_grid import CPGridConfig

CP = dict(n_levels=3, n_components=8, base_resolution=8, max_resolution=128,
          table_size=32)
NET = dict(density_width=32, density_out=16, color_width=32, color_layers=3)


def _pair(encoder, compute_dtype, use_bf16, fold="periodic"):
    cp = dict(CP, use_bf16=use_bf16, fold=fold)
    jm = JNGPModel(JNGPConfig(encoder=encoder, cp=JCP(**cp), compute_dtype=compute_dtype, **NET))
    x0 = np.zeros((1, 3), np.float32)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(5), x0, x0))
    # init biases are zero: give them values so a dropped bias would show
    rng = np.random.default_rng(6)
    for name, leaf in tree["params"].items():
        if isinstance(leaf, dict):
            leaf["bias"] = (0.2 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32)
    tm = NGPModel(NGPConfig(encoder=encoder, cp=CPGridConfig(**cp), compute_dtype=compute_dtype, **NET))
    tm.load_state_dict(params_from_flax(tree))
    return jm, tree, tm


def _inputs(n=150):
    rng = np.random.default_rng(7)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    vd = rng.standard_normal((n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return x, vd


@pytest.mark.parametrize("encoder,fold", [("cp_pallas", "periodic"), ("cp_pallas", "hash"),
                                          ("cp", "periodic")])
@pytest.mark.parametrize("compute_dtype,use_bf16,atol", [
    ("float32", False, 1e-5), ("bfloat16", True, 2e-2)], ids=["f32", "bf16"])
def test_call_and_density_match_flax(encoder, fold, compute_dtype, use_bf16, atol):
    jm, tree, tm = _pair(encoder, compute_dtype, use_bf16, fold)
    x, vd = _inputs()
    rgb_j, sig_j = jm.apply(tree, jnp.asarray(x), jnp.asarray(vd))
    sd_j, feat_j = jm.apply(tree, jnp.asarray(x), method=JNGPModel.density)
    with torch.no_grad():
        rgb_t, sig_t = tm(torch.tensor(x), torch.tensor(vd))
        sd_t, feat_t = tm.density(torch.tensor(x))
    assert rgb_t.dtype == torch.float32 and sig_t.dtype == torch.float32
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=atol)
    np.testing.assert_allclose(feat_t.float().numpy(), np.asarray(feat_j, np.float32),
                               rtol=0, atol=atol)
    rtol = 2e-2 if use_bf16 else 1e-5
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(sd_t.numpy(), np.asarray(sd_j), rtol=rtol, atol=1e-6)


def test_missing_viewdirs_mean_plus_z():
    jm, tree, tm = _pair("cp_pallas", "float32", False)
    x, _ = _inputs(40)
    rgb_j, _ = jm.apply(tree, jnp.asarray(x))
    with torch.no_grad():
        rgb_t, _ = tm(torch.tensor(x))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=1e-5)


def test_parameter_names_follow_the_tree():
    _, tree, tm = _pair("cp_pallas", "float32", False)
    names = set(tm.state_dict())
    want = {"cp_lines"} | {f"{k}.{leaf}" for k, v in tree["params"].items()
                          if isinstance(v, dict) for leaf in v}
    assert names == want
    assert tm.cp_lines.shape == (3, 3, 32, 8)


def test_unported_encoder_says_so():
    # the hash encoder is ported (tests/test_torch_hashgrid.py); an unknown
    # name is refused
    from nerf_kinematics_tpu_torch.ops.hashgrid import HashGridConfig

    hashed = NGPModel(NGPConfig(encoder="hash", grid=HashGridConfig(n_levels=2,
                                                                    log2_table_size=10)))
    assert hashed.hash_table.shape == (2, 1024, 4) and hashed.density_0.kernel.shape[0] == 8
    with pytest.raises(ValueError):
        NGPModel(NGPConfig(encoder="nope"))
    assert NGPConfig(encoder="auto").resolved_encoder() in ("cp", "cp_pallas")
    assert NGPConfig(encoder="cp", cp=CPGridConfig(**CP)).encoding_dim == 24
