"""The benchmark's work counts against the program's own FLOP arithmetic
(``nerf_kinematics_tpu_torch/utils/flops.py``), for both configurations."""

import pytest

from benchmark.harness import manifest, work
from benchmark.reference import ngp as ref


def _spec(name):
    return ref.model_spec(manifest.config(name)["sizes"])


def _port_ngp(name):
    from nerf_kinematics_tpu_torch.train.config import config_from_dict

    return config_from_dict(manifest.config(name)["yaml"]).ngp


@pytest.mark.parametrize("name", ["machina_ngp", "fox_ngp"])
def test_encoder_and_mlp_counts_are_flops_py(name):
    from nerf_kinematics_tpu_torch.utils import flops

    spec, ngp = _spec(name), _port_ngp(name)
    assert work.encoder_flops(spec) == flops.cp_encoder_useful_flops_per_point(
        ngp.cp, trained=False)
    assert 2 * work.encoder_flops(spec) == flops.cp_encoder_useful_flops_per_point(
        ngp.cp, trained=True)
    for dims in (spec["density_dims"], spec["color_dims"]):
        widths = [dims[0][0]] + [b for _, b in dims]
        assert work.mlp_flops(dims) == flops._mlp_fwd(widths)


@pytest.mark.parametrize("name", ["machina_ngp", "fox_ngp"])
def test_mlp_widths_are_the_models(name):
    """flops.py's MLPs carry one layer more than the model has (it counts
    ``density_layers`` hidden layers and an output, and ``color_layers``
    likewise); the benchmark counts the layers the model runs."""
    from nerf_kinematics_tpu_torch.models.ngp import NGPModel
    from nerf_kinematics_tpu_torch.utils import flops

    spec, ngp = _spec(name), _port_ngp(name)
    model = NGPModel(ngp)
    dims = [tuple(getattr(model, n).kernel.shape)
            for n in model.density_names + model.color_names]
    assert dims == spec["density_dims"] + spec["color_dims"]
    assert work.n_params(spec) == sum(p.numel() for p in model.parameters())
    assert flops.ngp_useful_flops_per_point(ngp, trained=True) > work.point_flops(
        spec, trained=True)


def test_machina_step_and_frame():
    spec = _spec("machina_ngp")
    step = work.train_step(spec, 8192, 48, 48)
    # 393 216 coarse points density-only forward, as many fine trained
    assert step["flops"] == 393216 * (3072 + 43008) + 393216 * (2 * 3072 + 3 * (43008 + 20864))
    frame = work.frame(spec, 400 * 400, 56000 * 4, 48, 64)
    assert frame["flops"] == (160000 * 48 + 224000 * 64) * (3072 + 43008 + 20864)
    assert work.least_seconds(step) == step["flops"] / work.PEAK_FLOPS_BF16
