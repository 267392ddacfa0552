"""The PyTorch port stands alone: it never imports JAX or the JAX package,
its entry points ask for the GPU unless told otherwise, a CPU tensor never
reaches the CUDA library's loader, and every ported kernel has its source."""

import pathlib
import re

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "nerf_kinematics_tpu_torch"

FORBIDDEN = [
    # any import of JAX or its ecosystem
    re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax)\b", re.M),
    re.compile(r"\b(import_module|__import__)\(\s*['\"](jax|flax|optax|orbax)"),
    # the reference package's name followed by anything but `_torch`:
    # `nerf_kinematics_tpu.x` or `nerf_kinematics_tpu import`
    re.compile(r"nerf_kinematics_tpu(?!_torch)(\.\w|\s+import)"),
]


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    text = path.read_text()
    for pat in FORBIDDEN:
        m = pat.search(text)
        assert m is None, f"{path}: forbidden import {m.group(0)!r}"


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


def test_cpu_tensors_never_touch_the_library_loader(monkeypatch):
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.ops.cp_grid import CPGridConfig, init_stacked_lines
    from nerf_kinematics_tpu_torch.ops.cp_grid_cuda import cp_encode_cuda
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (
        ngp_fused_apply_cf, ngp_fused_sigma_cf)
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
    fused = (PORT / "csrc" / "ngp_fused.cu").read_text()
    assert c_fields(common, "CPLevels") == [f[0] for f in cuda_lib.CPLevels._fields_]
    assert c_fields(fused, "FusedArgs") == [f[0] for f in cuda_lib.FusedArgs._fields_]
    assert f"#define NKT_MAX_LEVELS {cuda_lib.MAX_LEVELS}" in common
    assert f"#define NKT_MAX_LAYERS {cuda_lib.MAX_LAYERS}" in fused
    assert f"#define NKT_W {cuda_lib.MAX_WIDTH}" in fused
