"""The plain reference against the program on the CPU at tiny sizes.

With the program's bf16 rounding switched off (``ngp.use_bf16: false``,
``compute_dtype: float32``) and the hull lookup's bf16 projections read in
f32, the program's plain versions compute the reference's equations: one
train step and one frame then agree to float32 rounding. As configured
(bf16), they agree as closely as bf16 rounding allows."""

import copy

import pytest
import torch

from benchmark.reference import ngp as ref

from . import _tiny


def _f32(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["yaml"]["ngp"]["use_bf16"] = False
    cfg["yaml"]["ngp"]["compute_dtype"] = "float32"
    return cfg


@pytest.fixture
def f32_program(monkeypatch):
    """The program at f32 throughout: tiny configurations without bf16, and
    the hull lookup reading its projections unrounded."""
    from nerf_kinematics_tpu_torch.ops import occupancy

    def hull_f32(proj2, xt):
        R = proj2.shape[-1]
        idx = torch.floor(torch.clamp(xt * float(R), 0.0, float(R - 1))).to(torch.int64)
        ix, iy, iz = idx[0], idx[1], idx[2]
        return torch.minimum(proj2[0][ix, iy], torch.minimum(proj2[1][ix, iz],
                                                             proj2[2][iy, iz]))

    monkeypatch.setattr(occupancy, "occupancy_at_hull_cuda", hull_f32)
    monkeypatch.setattr(_tiny, "config", lambda name, inner=_tiny.config: _f32(inner(name)))


@pytest.mark.parametrize("cell", ["machina_ngp.train", "fox_ngp.train"])
def test_train_steps_match_at_f32(cell, scenes_dir, f32_program):
    run = _tiny.run(cell)
    for name, (value, _) in run.checks.items():
        assert value < 2e-4, (name, value)


def test_frame_matches_at_f32(scenes_dir, f32_program):
    run = _tiny.run("machina_ngp.serve_800")
    assert run.readings["frames"]
    for stats in run.readings["frames"].values():
        assert stats["frame_rmse"] < 1e-5, stats


@pytest.mark.parametrize("cell", ["machina_ngp.train", "fox_ngp.train",
                                  "machina_ngp.serve_800"])
def test_bf16_program_is_near_the_reference(cell, scenes_dir):
    run = _tiny.run(cell)
    assert run.attempted > 0 and run.failed == 0
    for name, (value, _) in run.checks.items():
        assert value < 0.06, (name, value)


def test_field_matches_the_programs_plain_version():
    from nerf_kinematics_tpu_torch.ops.cp_grid import CPGridConfig
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import ngp_fused_apply_cf_ref

    from benchmark.harness import manifest

    spec = ref.model_spec(manifest.config("fox_ngp")["sizes"])
    g = torch.Generator().manual_seed(3)
    cp = spec["cp"]
    params = {"cp_lines": 0.5 + 0.1 * torch.randn(
        (cp["n_levels"], 3, cp["table_size"], cp["n_components"]), generator=g)}
    for name, (i, o) in zip(spec["density_names"] + spec["color_names"],
                            spec["density_dims"] + spec["color_dims"]):
        params[name + ".kernel"] = torch.randn((i, o), generator=g) / i**0.5
        params[name + ".bias"] = 0.1 * torch.randn((o,), generator=g)
    x = torch.rand((500, 3), generator=g) * 1.02 - 0.01
    vd = torch.nn.functional.normalize(torch.randn((500, 3), generator=g), dim=-1)
    logits, sigma = ref.field(params, x, vd, spec)
    kernel = {"lines": params["cp_lines"],
              "dW": [params[n + ".kernel"] for n in spec["density_names"]],
              "db": [params[n + ".bias"][:, None] for n in spec["density_names"]],
              "cW": [params[n + ".kernel"] for n in spec["color_names"]],
              "cb": [params[n + ".bias"][:, None] for n in spec["color_names"]]}
    cfg = CPGridConfig(**{k: cp[k] for k in ("n_levels", "n_components", "base_resolution",
                                             "max_resolution", "table_size", "fold")},
                       use_bf16=False)
    out = ngp_fused_apply_cf_ref(kernel, x.T.contiguous(), vd.T.contiguous(), cfg)
    torch.testing.assert_close(out[:3].T, logits, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out[3], sigma, rtol=1e-5, atol=1e-6)


def test_the_fp8_control_rounds():
    t = torch.tensor([0.1, 1.0, 3.3, 1000.0])
    assert torch.equal(ref.fp8(t), torch.tensor([0.1015625, 1.0, 3.25, 448.0]))
