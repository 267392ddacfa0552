"""Weights carried across: flax tree -> port -> flax tree is bit-exact, and
the committed fixture holds the flagship model's arrays."""

import jax
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.models.ngp import NGPConfig as JNGPConfig
from nerf_kinematics_tpu.models.ngp import NGPModel as JNGPModel
from nerf_kinematics_tpu.ops.cp_grid import CPGridConfig as JCP
from nerf_kinematics_tpu_torch.io.convert import (
    grid_from_numpy, params_from_flax, params_to_flax)
from nerf_kinematics_tpu_torch.io.fixture import (
    MACHINA_NGP, Fixture, read_fixture, write_fixture)
from nerf_kinematics_tpu_torch.models.ngp import NGPConfig, NGPModel
from nerf_kinematics_tpu_torch.ops.cp_grid import CPGridConfig


def _flax_tree(encoder):
    cp = JCP(n_levels=2, n_components=8, base_resolution=8, max_resolution=64,
             table_size=32)
    cfg = JNGPConfig(encoder=encoder, cp=cp, density_width=16, density_out=8,
                     color_width=16, color_layers=3)
    x = np.zeros((1, 3), np.float32)
    tree = JNGPModel(cfg).init(jax.random.PRNGKey(3), x, x)
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): v for k, v in flat}


@pytest.mark.parametrize("encoder", ["cp_pallas", "cp"])
def test_flax_round_trip_is_bit_exact(encoder):
    tree = _flax_tree(encoder)
    sd = params_from_flax(tree)
    back = params_to_flax(sd, encoder=encoder)
    a, b = _leaves(tree), _leaves(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        assert np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)), k


def test_state_dict_loads_into_the_module():
    tree = _flax_tree("cp_pallas")
    cp = CPGridConfig(n_levels=2, n_components=8, base_resolution=8,
                      max_resolution=64, table_size=32)
    model = NGPModel(NGPConfig(encoder="cp_pallas", cp=cp, density_width=16,
                               density_out=8, color_width=16, color_layers=3))
    model.load_state_dict(params_from_flax(tree))  # strict: names and shapes
    assert torch.equal(model.density_0.kernel.detach(),
                       torch.tensor(tree["params"]["density_0"]["kernel"]))


def test_fixture_holds_the_flagship_arrays():
    fx = read_fixture(MACHINA_NGP)
    p = fx.params["params"]
    shapes = {
        "cp_lines": (4, 3, 192, 64),
        "density_0": (256, 64), "density_1": (64, 64), "density_out": (64, 16),
        "color_0": (32, 64), "color_1": (64, 64), "color_2": (64, 64),
        "color_out": (64, 3),
    }
    for name, shape in shapes.items():
        arr = p[name] if name == "cp_lines" else p[name]["kernel"]
        assert arr.shape == shape and arr.dtype == np.float32
        if name != "cp_lines":
            assert p[name]["bias"].shape == (shape[1],)
    assert fx.grid_density.shape == (96, 96, 96)
    assert fx.grid_bound == 1.0
    assert fx.poses.shape == (4, 4, 4)
    g = fx.golden
    assert g["fast_rgb"].shape == g["eval_rgb"].shape == (2, 100, 100, 3)
    assert g["fast_rgb"].dtype == np.float16
    grid = grid_from_numpy(fx.grid_density, fx.grid_bound)
    assert grid.resolution == 96 and grid.density.dtype == torch.float32


def test_fixture_write_read_round_trip(tmp_path):
    fx = read_fixture(MACHINA_NGP)
    small = Fixture(params=_flax_tree("cp_pallas"),
                    grid_density=np.ones((4, 4, 4), np.float32), grid_bound=1.5,
                    config=fx.config, intrinsics=fx.intrinsics, poses=fx.poses,
                    step=7, golden={"fast_rgb": np.zeros((1, 2, 2, 3), np.float16)})
    path = str(tmp_path / "f.npz")
    write_fixture(path, small)
    back = read_fixture(path)
    assert back.config == fx.config and back.step == 7 and back.grid_bound == 1.5
    a, b = _leaves(small.params), _leaves(back.params)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert back.golden["fast_rgb"].shape == (1, 2, 2, 3)
