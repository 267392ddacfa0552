"""The PyTorch port stands alone: it never imports JAX or the JAX package,
its entry points ask for the GPU unless told otherwise, a CPU tensor never
reaches the CUDA library's loader, and every ported kernel has its source."""

import dataclasses
import pathlib
import re

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "nerf_kinematics_tpu_torch"

FORBIDDEN = [
    # any import of JAX or its ecosystem, or of msgpack (the snapshots
    # carry their own reader and writer)
    re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|msgpack)\b", re.M),
    re.compile(r"\b(import_module|__import__)\(\s*['\"](jax|flax|optax|orbax|msgpack)"),
    # the reference package's name followed by anything but `_torch`:
    # `nerf_kinematics_tpu.x` or `nerf_kinematics_tpu import`
    re.compile(r"nerf_kinematics_tpu(?!_torch)(\.\w|\s+import)"),
]


def _port_files():
    files = sorted(PORT.rglob("*.py")) + sorted((PORT / "csrc").glob("*.cu*"))
    files += [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    names = {str(f.relative_to(ROOT)) for f in files}
    for new in ("train/loop.py", "train/trainer.py", "io/checkpoint.py",
                "metrics/writer.py", "csrc/ngp_fused_bwd.cu", "csrc/ngp_fused.cuh",
                "csrc/classic_fused.cu", "ops/classic_fused_cuda.py",
                "models/flexible_nerf.py", "ops/positional_encoding.py",
                "io/torch_compat.py", "csrc/ngp_fused_full.cu", "io/image.py",
                "data/machina.py", "data/blender.py", "data/llff.py",
                "data/machina_llff.py", "data/cache.py", "data/__init__.py",
                "cli/make_scene.py", "cli/run_nerf.py", "cli/ngp_run.py",
                "cli/plot_metrics.py", "io/snapshot.py", "io/__init__.py",
                "data/ngp_transforms.py", "utils/__init__.py", "utils/logging.py",
                "utils/guards.py", "utils/profiling.py", "utils/flops.py",
                "bench.py", "train/config.py", "poses/__init__.py", "poses/orbit.py",
                "data/synthetic.py", "rendering/render_buffer.py", "ops/contraction.py",
                "ops/hashgrid.py", "export/__init__.py", "export/mesh.py",
                "poses/parser.py", "poses/normalize.py", "poses/sharpness.py",
                "poses/camera_path.py", "poses/pipeline.py", "data/robot.py",
                "metrics/parallax.py", "cli/parse_poses.py", "cli/full_pipeline.py"):
        assert f"nerf_kinematics_tpu_torch/{new}" in names
    return files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    text = path.read_text()
    for pat in FORBIDDEN:
        m = pat.search(text)
        assert m is None, f"{path}: forbidden import {m.group(0)!r}"
    # the card has no Pillow, no PyYAML and no matplotlib: imported inside a
    # function only
    m = re.search(r"^(import|from)\s+(PIL|yaml|matplotlib)\b", text, re.M)
    assert m is None, f"{path}: module-level import {m.group(0)!r}"


def test_entry_points_ask_for_the_gpu(monkeypatch):
    from nerf_kinematics_tpu_torch import resolve_device
    from nerf_kinematics_tpu_torch.train.config import Config
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        NGPEngine(Config(engine="ngp"), scene_bound=1.0)
    assert resolve_device("cpu") == torch.device("cpu")
    assert NGPEngine(Config(engine="ngp"), device="cpu").device.type == "cpu"
    from nerf_kinematics_tpu_torch.train.loop import ClassicNerf

    with pytest.raises(RuntimeError, match="CUDA"):
        ClassicNerf(Config())
    assert ClassicNerf(Config(), device="cpu").device.type == "cpu"


def test_cpu_tensors_never_touch_the_library_loader(monkeypatch):
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.ops.cp_grid import CPGridConfig, init_stacked_lines
    from nerf_kinematics_tpu_torch.ops.cp_grid_cuda import (
        cp_encode_cuda, cp_encode_cuda_bwd)
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (
        ngp_fused_apply_cf, ngp_fused_apply_cf_bwd, ngp_fused_sigma_cf,
        ngp_fused_train_cf)
    from nerf_kinematics_tpu_torch.ops.occupancy_cuda import occupancy_at_hull_cuda

    def boom(*a, **k):
        raise AssertionError("the CUDA library was asked for on the CPU")

    monkeypatch.setattr(cuda_lib, "load_library", boom)
    monkeypatch.setattr(cuda_lib, "build_library", boom)
    cuda_lib.reset_launch_counts()
    cfg = CPGridConfig(n_levels=2, n_components=8, base_resolution=8,
                       max_resolution=64, table_size=32)
    g = torch.Generator().manual_seed(0)
    lines = init_stacked_lines(cfg, g)
    x = torch.rand((50, 3), generator=g)
    assert cp_encode_cuda(lines, x, cfg).shape == (50, 16)
    params = {
        "lines": lines,
        "dW": [torch.randn(16, 16, generator=g), torch.randn(16, 4, generator=g)],
        "db": [torch.zeros(16, 1), torch.zeros(4, 1)],
        "cW": [torch.randn(20, 16, generator=g), torch.randn(16, 3, generator=g)],
        "cb": [torch.zeros(16, 1), torch.zeros(3, 1)],
    }
    vd = torch.nn.functional.normalize(torch.randn(3, 50, generator=g), dim=0)
    assert ngp_fused_apply_cf(params, x.T.contiguous(), vd, cfg).shape == (4, 50)
    assert ngp_fused_sigma_cf(params, x.T.contiguous(), cfg).shape == (4, 50)
    proj = torch.rand((3, 16, 16), generator=g)
    assert occupancy_at_hull_cuda(proj, x.T.contiguous()).shape == (50,)
    # the gradient wrappers too, directly and through autograd
    xt = x.T.contiguous()
    assert cp_encode_cuda_bwd(lines, x, torch.ones(50, 16), cfg).shape == lines.shape
    # the classic engine's kernels, directly and through autograd
    from nerf_kinematics_tpu_torch.ops.classic_fused_cuda import (
        classic_fused_apply_cf, classic_fused_apply_cf_bwd)
    from nerf_kinematics_tpu_torch.train.config import Config
    from nerf_kinematics_tpu_torch.train.loop import ClassicNerf

    ccfg = dataclasses.replace(Config().model_coarse, hidden_size=32,
                               num_encoding_fn_xyz=3, num_encoding_fn_dir=1)
    eng = ClassicNerf(Config(model_coarse=ccfg, model_fine=None), device="cpu")
    cparams = ClassicNerf._fused_params(eng.model_coarse)
    out = classic_fused_apply_cf(cparams, x.T.contiguous(), vd, ccfg)
    assert out.shape == (4, 50)
    out.sum().backward()
    assert eng.model_coarse.layer1.weight.grad is not None
    dc = classic_fused_apply_cf_bwd({k: [t.detach() for t in v] for k, v in cparams.items()},
                                    x.T.contiguous(), vd, torch.ones(4, 50), ccfg)
    assert dc["W"][0].shape == (ccfg.dim_xyz, 32) and dc["b"][-1].shape == (3, 1)
    d = ngp_fused_apply_cf_bwd(params, xt, vd, torch.ones(4, 50), cfg)
    assert d["lines"].shape == lines.shape and d["db"][0].shape == (16, 1)
    err, maps, d = ngp_fused_train_cf(params, xt, vd, torch.full((1, 50), 0.1),
                                      torch.rand(3, 10, generator=g), cfg, 5, True, 1 / 30)
    assert err.shape == (1, 10) and maps.shape == (4, 10) and len(d["cW"]) == 2
    live = {k: (v.clone().requires_grad_() if k == "lines"
                else [t.clone().requires_grad_() for t in v]) for k, v in params.items()}
    xg = xt.clone().requires_grad_()
    ngp_fused_apply_cf(live, xg, vd, cfg).sum().backward()
    cp_encode_cuda(live["lines"], xg.T, cfg).sum().backward()
    assert live["lines"].grad is not None and live["cb"][1].grad is not None
    assert xg.grad is None  # positions get no gradient, on the CPU either
    # launches are counted where a kernel is launched, and nowhere else
    assert all(v == 0 for v in cuda_lib.LAUNCHES.values())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    from nerf_kinematics_tpu_torch.ops import cuda_lib

    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_lib.check_tensor(torch.zeros(3, 4), "xt", (3, None))


@pytest.mark.parametrize("kernel,source", [
    ("nkt_hull_kernel", "occupancy_hull.cu"),
    ("nkt_fused_sigma_kernel", "ngp_fused.cu"),
    ("nkt_fused_apply_kernel", "ngp_fused.cu"),
    ("nkt_cp_encode_kernel", "cp_encode.cu"),
    ("nkt_cp_encode_bwd_kernel", "cp_encode.cu"),
    ("nkt_fused_apply_save_kernel", "ngp_fused_bwd.cu"),
    ("nkt_train_rays_kernel", "ngp_fused_bwd.cu"),
    ("nkt_fused_point_bwd_kernel", "ngp_fused_bwd.cu"),
    ("nkt_wgrad_kernel", "ngp_fused_bwd.cu"),
    ("nkt_reduce_partials_kernel", "ngp_fused_bwd.cu"),
    ("nkc_pack_kernel", "classic_fused.cu"),
    ("nkc_forward_kernel", "classic_fused.cu"),
    ("nkc_bwd_tile_kernel", "classic_fused.cu"),
    ("nkc_tc_forward_kernel", "classic_fused.cu"),
    ("nkc_tc_bwd_tile_kernel", "classic_fused.cu"),
    ("nkc_tc_wgrad_kernel", "classic_fused.cu"),
    ("nkf_propose_kernel", "ngp_fused_full.cu"),
    ("nkf_fine_inputs_kernel", "ngp_fused_full.cu"),
])
def test_every_ported_kernel_has_cuda_source(kernel, source):
    text = (PORT / "csrc" / source).read_text()
    assert re.search(r"__global__\s+void\s+(__launch_bounds__\([^)]*\)\s+)?" + kernel, text)
    assert "torch/extension.h" not in text
    # the loader binds a C entry point of that file
    assert 'extern "C"' in text


def test_ctypes_structs_mirror_the_cuda_structs():
    """Field order and array sizes of the argument structs, read from the
    CUDA sources, match the ctypes mirrors."""
    from nerf_kinematics_tpu_torch.ops import cuda_lib

    def c_fields(text, struct):
        body = re.search(r"struct %s \{(.*?)\n\};" % struct, text, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        names = []
        for decl in body.split(";"):
            decl = decl.strip()
            if not decl:
                continue
            for part in decl.split(","):
                names.append(re.search(r"(\w+)\s*(\[.*\])?\s*$", part.strip()).group(1))
        return names

    common = (PORT / "csrc" / "nkt_common.cuh").read_text()
    fused = (PORT / "csrc" / "ngp_fused.cuh").read_text()
    bwd = (PORT / "csrc" / "ngp_fused_bwd.cu").read_text()
    assert c_fields(common, "CPLevels") == [f[0] for f in cuda_lib.CPLevels._fields_]
    assert c_fields(fused, "FusedArgs") == [f[0] for f in cuda_lib.FusedArgs._fields_]
    assert c_fields(fused, "BwdArgs") == [f[0] for f in cuda_lib.BwdArgs._fields_]
    full = (PORT / "csrc" / "ngp_fused_full.cu").read_text()
    assert c_fields(full, "FullArgs") == [f[0] for f in cuda_lib.FullArgs._fields_]
    assert f"#define NKF_MAX_BINS {cuda_lib.MAX_BINS}" in full
    assert f"#define NKF_MAX_SAMPLES {cuda_lib.MAX_SAMPLES}" in full
    # the whole step calls rows 2 and 7 through their C entry points
    for fn in ("nkt_fused_forward", "nkt_fused_train"):
        assert f'extern "C" int {fn}(' in full
    assert f"#define NKT_MAX_LEVELS {cuda_lib.MAX_LEVELS}" in common
    assert f"#define NKT_MAX_LAYERS {cuda_lib.MAX_LAYERS}" in fused
    assert f"#define NKT_W {cuda_lib.MAX_WIDTH}" in fused
    classic = (PORT / "csrc" / "classic_fused.cu").read_text()
    assert c_fields(classic, "ClassicArgs") == [f[0] for f in cuda_lib.ClassicArgs._fields_]
    assert f"#define NKC_MAX_LAYERS {cuda_lib.CLASSIC_MAX_LAYERS}" in classic
    assert f"#define NKC_PACK_Y {cuda_lib.CLASSIC_PACK_Y}" in classic
    assert f"#define NKC_MAX_FREQS {cuda_lib.CLASSIC_MAX_FREQS}" in classic
    from nerf_kinematics_tpu_torch.ops.classic_fused_cuda import TILE

    assert f"#define NKC_P {TILE}" in classic
    # the classic kernels' weight gradients call the launcher of the NGP file
    for fn in ("nkt_wgrad_launch", "nkt_reduce_partials_launch"):
        assert f'extern "C" int {fn}(' in bwd and f'extern "C" int {fn}(' in classic


@pytest.mark.parametrize(
    "path", sorted((PORT / "ops").glob("*_cuda.py")) + [PORT / "ops" / "cuda_lib.py"],
    ids=lambda p: p.name)
def test_no_wrapper_catches_a_build_or_a_launch(path):
    """For a CUDA tensor a wrapper launches its kernel or raises: nothing in
    the wrappers' modules or the loader catches an exception."""
    assert path.exists()
    text = path.read_text()
    assert re.search(r"^\s*(try\s*:|except\b)", text, re.M) is None


def test_flat_gradient_layout_matches_the_cuda_source():
    """``_grad_layout`` (host) and ``make_rows`` (device side) order the MLP
    leaves the same way: per density layer W then b, then the color layers."""
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import _grad_layout

    params = {"dW": [torch.zeros(6, 4), torch.zeros(4, 2)],
              "db": [torch.zeros(4, 1), torch.zeros(2, 1)],
              "cW": [torch.zeros(5, 3)], "cb": [torch.zeros(3, 1)]}
    assert [(k, i) for k, i, _ in _grad_layout(params)] == [
        ("dW", 0), ("db", 0), ("dW", 1), ("db", 1), ("cW", 0), ("cb", 0)]
    text = (PORT / "csrc" / "ngp_fused.cuh").read_text()
    body = text[text.index("static SaveRows make_rows"):]
    d = body.index("a.nd; ++li")
    c = body.index("a.nc; ++li")
    assert d < body.index("r.dw_off[li] = flat") < body.index("r.db_off[li] = flat") < c
    assert c < body.index("r.cw_off[li] = flat") < body.index("r.cb_off[li] = flat")
