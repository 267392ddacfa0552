"""Configuration parity: every fast-engine YAML loads to equal fields in the
JAX package and in the PyTorch port, the fixture carries the flagship
configuration, and the CP grid's derived sizes agree."""

import dataclasses
import glob
import os

import pytest
import yaml

from nerf_kinematics_tpu.ops.cp_grid import CPGridConfig as JCP
from nerf_kinematics_tpu.ops.cp_grid import fold_salt as j_fold_salt
from nerf_kinematics_tpu.train import config as jcfg
from nerf_kinematics_tpu_torch.io.fixture import MACHINA_NGP, read_fixture
from nerf_kinematics_tpu_torch.ops.cp_grid import CPGridConfig as TCP
from nerf_kinematics_tpu_torch.ops.cp_grid import fold_salt as t_fold_salt
from nerf_kinematics_tpu_torch.train import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ngp_configs():
    out = []
    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "*.yml"))):
        with open(path) as f:
            if yaml.safe_load(f).get("engine") == "ngp":
                out.append(path)
    assert len(out) >= 4
    return out


@pytest.mark.parametrize("path", _ngp_configs(), ids=os.path.basename)
def test_ngp_yaml_loads_to_equal_fields(path):
    j, t = jcfg.load_config(path), tcfg.load_config(path)
    assert jcfg.config_to_dict(j) == tcfg.config_to_dict(t)
    assert dataclasses.asdict(j.ngp) == dataclasses.asdict(t.ngp)
    assert j.engine == t.engine == "ngp"
    assert j.nerf.coarse_loss_weight == t.nerf.coarse_loss_weight
    assert j.nerf.ema_decay == t.nerf.ema_decay
    assert list(j.ngp.cp.resolutions) == list(t.ngp.cp.resolutions)
    # the JSON form (what fixture files carry) round-trips to an equal Config
    assert tcfg.config_from_json(tcfg.config_to_json(t)) == t


def test_fixture_carries_the_flagship_config():
    fx = read_fixture(MACHINA_NGP)
    want = tcfg.load_config(os.path.join(ROOT, "configs", "machina_ngp.yml"))
    assert fx.config == want
    assert fx.step == 10000
    assert (fx.intrinsics.width, fx.intrinsics.height) == (400, 400)


@pytest.mark.parametrize("fold", ["periodic", "hash"])
@pytest.mark.parametrize("fold_cap", [0, 24, 128])
@pytest.mark.parametrize("T", [32, 100, 192, 256])
def test_cp_grid_config_properties_equal(T, fold_cap, fold):
    for base, top, L in [(8, 64, 3), (32, 1024, 4), (16, 16, 1), (31, 500, 5)]:
        kw = dict(n_levels=L, n_components=8, base_resolution=base,
                  max_resolution=top, table_size=T, fold=fold, fold_cap=fold_cap)
        j, t = JCP(**kw), TCP(**kw)
        assert list(j.resolutions) == list(t.resolutions)
        assert (j.out_dim, j.dup_rows, j.n_params) == (t.out_dim, t.dup_rows, t.n_params)
        for R in list(j.resolutions) + [1, T - 1, T, T + 1]:
            assert j.level_rows(R) == t.level_rows(R)
            assert j.level_fold(R) == t.level_fold(R)
            assert j.level_rows_dup(R) == t.level_rows_dup(R)
    for l in range(8):
        for a in range(3):
            assert j_fold_salt(l, a) == t_fold_salt(l, a)
