"""The block plan of bf16 mode's gradient kernel (rows 6-8's fine stage,
``csrc/ngp_fused_bwd.cu::nkt_fused_tile_kernel``), on the CPU: what a tile
holds at the shipped configs' widths and sample counts, that it fits one
block's shared memory, the scratch the wrapper allocates in each mode, and
that the host's plan and the CUDA source's read the same constants. The
kernel itself runs only on the card (``chip_smoke.py``); the wrapper there
compares this plan with the library's ``nkt_fused_bwd_plan`` at every call.
"""

import pathlib
import re

import pytest
import torch

from nerf_kinematics_tpu_torch.ops import cuda_lib
from nerf_kinematics_tpu_torch.ops import ngp_fused_cuda as nf
from nerf_kinematics_tpu_torch.ops.cp_grid import CPGridConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = (ROOT / "nerf_kinematics_tpu_torch" / "csrc" / "ngp_fused_bwd.cu").read_text()

COLOR = [(32, 64), (64, 64), (64, 64), (64, 3)]
# (levels, channels) of the encoder and the density MLP of each config
CONFIGS = {
    "machina": (4, 64, [(256, 64), (64, 64), (64, 16)]),
    "fox": (5, 96, [(480, 64), (64, 64), (64, 16)]),
    "wheel": (4, 32, [(128, 64), (64, 64), (64, 16)]),
}
SAMPLES = [24, 27, 32, 48, 64]


def _plan(name, S=0):
    L, C, dens = CONFIGS[name]
    return nf.bwd_plan(dens + COLOR, len(dens), C, L, S)


def _params(name):
    L, C, dens = CONFIGS[name]
    shapes = dens + COLOR
    z = lambda s: torch.zeros(s)
    return ({"lines": z((L, 3, 8, C)),
             "dW": [z(s) for s in dens], "db": [z((s[1], 1)) for s in dens],
             "cW": [z(s) for s in COLOR], "cb": [z((s[1], 1)) for s in COLOR]},
            CPGridConfig(n_levels=L, n_components=C), shapes)


@pytest.mark.parametrize("S", SAMPLES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_tile_holds_whole_rays(name, S):
    p = _plan(name, S)
    assert p.points % 16 == 0 and 16 <= p.points <= nf.BWD_MAX_POINTS
    assert p.rays >= 1 and p.tile_points == p.rays * S <= p.points
    # as many whole rays as the tile's rows take
    assert p.points - p.tile_points < S


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_vjp_tiles_by_points(name):
    p = _plan(name)
    assert p.rays == 0 and p.tile_points == p.points


@pytest.mark.parametrize("S", [0] + SAMPLES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_plan_fits_one_block(name, S):
    p = _plan(name, S)
    assert p.smem <= cuda_lib.SMEM_LIMIT == 232448
    assert p.smem == p.weight_bytes + p.acc_bytes + p.points * p.point_bytes
    # one more m-tile of points would not fit, unless the tile is at its cap
    # (64 points where layer 0's dW takes more than 16 m-tiles a warp)
    cap = nf.BWD_WIDE_POINTS if p.acc0_regs > 64 else nf.BWD_MAX_POINTS
    assert (p.points == cap
            or p.smem + 16 * p.point_bytes > cuda_lib.SMEM_LIMIT)
    # layer 0's weight gradient in registers: its K0 x 64 over 8 warps, a
    # warp an 8-column n-tile of every 16-row m-tile
    L, C, dens = CONFIGS[name]
    assert p.acc0_regs // 4 == -(-L * C // 16) and p.acc0_regs <= 128
    assert p.acc0_regs * 32 * nf.BWD_WARPS >= L * C * dens[0][1]
    # the two level tiles of the encoder lie under the inputs of layers 2..
    assert 4 * p.level_ld <= p.input_bytes - 2 * p.x_ld[1]


def test_the_flagship_tile():
    """machina_ngp.yml: 96 points, two rays of 48 a tile."""
    p = _plan("machina", 48)
    assert (p.points, p.rays, p.tile_points) == (96, 2, 96)
    assert _plan("fox", 64).tile_points == 64


def test_a_ray_longer_than_a_tile_is_refused():
    """No longer: a ray longer than a tile takes the VJP's tiles (the
    long-ray path). Layers the tile kernel does not take still are."""
    p = _plan("fox", 65)
    assert p.long_rays and (p.rays, p.tile_points) == (0, p.points) == (0, 64)
    with pytest.raises(ValueError, match="not taken"):
        nf.bwd_plan([(256, 64), (64, 64), (64, 16)] + COLOR[:-1] + [(64, 4)], 3, 64, 4)


@pytest.mark.parametrize("longer", [1, 32, 160])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_ray_longer_than_a_tile_takes_the_vjp_tiles(name, longer):
    """S > P: the VJP's plan (tiles of P points, no rays), marked as the
    long-ray path; a ray of exactly P samples still fits one tile."""
    vjp = _plan(name)
    p = _plan(name, vjp.points + longer)
    assert p.long_rays and not vjp.long_rays
    assert p.as_tuple() == vjp.as_tuple()
    fits = _plan(name, vjp.points)
    assert not fits.long_rays and (fits.rays, fits.tile_points) == (1, vjp.points)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("n", [999, 393216])
def test_bf16_mode_allocates_no_act_or_gs(name, n):
    params, cfg, shapes = _params(name)
    s = nf.grad_scratch(params, cfg, n)
    assert (s.act_rows, s.gs_rows, s.ld) == (0, 0, 0)
    assert s.total == sum(k * j + j for k, j in shapes)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("n", [999, 393216])
def test_f32_mode_layout_is_unchanged(name, n):
    params, cfg, shapes = _params(name)
    s = nf.grad_scratch(params, CPGridConfig(n_levels=cfg.n_levels,
                                             n_components=cfg.n_components,
                                             use_bf16=False), n)
    assert s.act_rows == sum(k for k, _ in shapes)
    assert s.gs_rows == sum(j for _, j in shapes)
    assert s.ld == n and s.act_dtype == torch.float32
    sizes = SRC[SRC.index('extern "C" void nkt_fused_bwd_sizes('):]
    sizes = sizes[:sizes.index("\n}\n")]
    f32 = sizes[sizes.index("} else {"):]
    for line in ("out[0] = rows.act_rows;", "out[1] = rows.gs_rows;",
                 "out[4] = args->n;", "out[5] = 4;"):
        assert line in f32


def test_the_source_reads_the_same_constants():
    consts = dict(re.findall(r"#define (NKB_\w+) (\d+)", SRC))
    assert int(consts["NKB_WARPS"]) == nf.BWD_WARPS
    assert int(consts["NKB_MAX_MT"]) * 16 == nf.BWD_MAX_POINTS
    assert int(consts["NKB_WIDE_MT"]) * 16 == nf.BWD_WIDE_POINTS
    assert int(consts["NKB_GLD"]) == nf.BWD_GLD
    assert int(consts["NKB_F32"]) == nf.BWD_F32
    # an instance of the kernel for up to 16 m-tiles of layer 0's dW a warp
    # and one for up to 32, each with arrays for its largest tile, and
    # machina's and fox's tiles with arrays of their own size
    launch = SRC[SRC.index("static int launch_tile_for("):]
    launch = launch[:launch.index("\n}\n")]
    assert re.findall(r"launch_tile<(\w+), (\w+)>", launch) == [
        ("16", "6"), ("30", "4"), ("16", "NKB_MAX_MT"), ("32", "NKB_WIDE_MT")]
    assert "if (pl.mt0 <= 16) return launch_tile<16, NKB_MAX_MT>" in launch
    for name in ("machina", "fox"):
        p = _plan(name)
        assert (f"if (pl.mt0 == {p.acc0_regs // 4} && mp == {p.points // 16}) "
                f"return launch_tile<{p.acc0_regs // 4}, {p.points // 16}>") in launch
    for name in CONFIGS:
        p = _plan(name)
        mt0, mp = p.acc0_regs // 4, p.points // 16
        assert mp <= (4 if mt0 > 16 else 8) and mt0 <= (16 if mp > 4 else 32)
    # and the f32 path keeps its sequence: bf16 mode returns before it
    run = SRC[SRC.index("static int run_backward(const BwdArgs& b"):]
    assert run.index("return run_backward_tile(") < run.index("nkt_fused_apply_save_kernel<<<")


@pytest.mark.parametrize("S", [0, 48, 128])
def test_grad_bytes_of_the_flagship(S):
    """The bytes a call moves by the kernel's own count at 393 216 points
    (8192 x 48, or 3072 x 128): the inputs, the weights each block stages,
    the encoding's slots (written and read back once), denc (written, and
    read by row 5's kernel) and the partial rows; no activations or
    cotangents. A ray longer than a tile (S = 128) runs the tile kernel
    twice and moves the forward's outputs and the rays' cotangent."""
    params, _, shapes = _params("machina")
    cfg = CPGridConfig(n_levels=4, n_components=64)
    n = 393216
    parts = nf.grad_bytes(params, cfg, n, S, n_sm=132)
    assert set(parts) == {"inputs", "line_tables", "outputs", "weights",
                          "encoding_slots", "denc", "partials", "ray_kernel"}
    twice = 2 if S > 96 else 1
    assert parts["denc"] == 2 * n * 256 * 4
    assert parts["encoding_slots"] == twice * 2 * n * 256 * 2
    assert parts["inputs"] == twice * n * 24 + (n * 4 + n // S * 12 if S else n * 16)
    assert parts["ray_kernel"] == (4 * n * 16 if S > 96 else 0)
    total = sum(k * j + j for k, j in shapes)
    assert parts["partials"] == 2 * 132 * total * 4 + total * 4
    assert parts["weights"] == twice * 132 * _plan("machina", S).weight_bytes


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("mode", ["auto", "on", "full"])
def test_a_fine_ray_longer_than_a_tile_takes_the_fused_objective(mode, bf16):
    """As the reference, the engine takes a fine ray of any length into the
    fused objective: the two-call one for ``auto`` and ``on``, the whole
    step for ``full``, in both modes; a ray longer than the gradient
    kernel's tile takes its long-ray path there, and nothing raises."""
    from nerf_kinematics_tpu_torch.train import config as tcfg
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    def objective(num_fine):
        raw = {
            "engine": "ngp",
            "ngp": {"encoder": "cp_pallas", "n_levels": 3, "n_components": 16,
                    "table_size": 48, "base_resolution": 8, "max_resolution": 32,
                    "density_width": 32, "density_out": 16, "color_width": 32,
                    "color_layers": 3, "use_occupancy": True, "occ_resolution": 16,
                    "fused": "on", "fused_train": mode, "cp": {"use_bf16": bf16}},
            "dataset": {"near": 2.0, "far": 6.0},
            "nerf": {"train": {"num_coarse": 8, "num_fine": num_fine,
                               "num_random_rays": 256},
                     "coarse_loss_weight": 0.0},
        }
        eng = NGPEngine(tcfg.config_from_dict(raw), scene_bound=1.0, device="cpu")
        return eng.fused_objective_fn(2.0, 6.0, eng.cfg.nerf.train)

    shapes = [(48, 32), (32, 32), (32, 16), (32, 32), (32, 32), (32, 3)]
    tile = nf.bwd_plan(shapes, 3, 16, 3).points
    assert nf.bwd_plan(shapes, 3, 16, 3, tile + 1).long_rays
    want = "objective_full" if mode == "full" else "objective"
    for S in (tile, tile + 1, 2 * tile + 7):
        assert objective(S).__name__ == want
