"""Where a training run ends, the JAX package beside the port on the CPU, at
test size: the Tier-1 form of the two witness scripts
(``scripts/torch_halo_witness.py``, ``scripts/torch_classic_seed_witness.py``),
which answer ROADMAP C.1 and C.2 at a larger size.

Both frameworks start from the JAX engine's initial weights (the port takes
them through ``load_flax_params``) and see the same images. On the halo
scene each draws its own rays, so the steps differ batch by batch and only
the end state is compared; the classic engine's steps run in lockstep, the
port given JAX's draws at every step, so the two runs differ by rounding
alone.

Margins, from what the scripts measured (PERF.md section 6, C.1 and C.2):

- the halo scene (``configs/fox_ngp.yml``'s recipe at the widths of
  ``tests/test_torch_contraction.py``'s halo test: MLPs 32 wide, the hash
  grid L 4, F 2, T 2^12, a CP encoder of L 3, C 16, T 48; 9 views of 32^2,
  512 rays, 150 steps, the refreshes scaled): the held-out mean PSNR within
  1.0 dB (the witness's criterion for a fault of the port; 0.35 and 0.15 dB
  measured on the two routes), the share of the density grid above 2.5
  within 0.15 (0.0 and 0.086 measured: at this size the hash grid's share
  moves with the draws);
- the classic engine from seed 42 (``configs/machina_classic.yml``'s recipe
  with 32-wide MLPs on machina at 24^2, 13 views, 64 rays of 32 + 32
  samples, 150 steps, ``lockstep()`` of the script): the first loss equal
  to 1e-5 relative (the draws reproduced; 4.7e-7 measured), both leave the
  all-white image (the last validation of val view 0 at least 3 dB above
  its PSNR), the last window's mean loss within 5 % (1.0 % measured), and
  the two last validations within 1.0 dB, the witness's criterion for a
  fault of the port. With the same draws f32 rounding alone parts them by
  0.52 dB here (JAX 17.15, the port 16.63), and by 0.51, -0.04 and
  -0.41 dB at 32, 128 and 256 rays.
"""

import importlib.util
import json
import pathlib
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
MARGIN_DB = 1.0
SHARE_MARGIN = 0.15
LEFT_WHITE_DB = 3.0
FIRST_LOSS_RTOL = 1e-5
LAST_LOSS_RTOL = 0.05


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("route", ["unfused", "hash"])
def test_halo_scene_ends_where_jax_ends(route):
    w = _script("torch_halo_witness")
    steps = 150
    raw = w.route_raw(w.fox_raw(), route, steps, rays=512)
    ngp = raw["ngp"]
    ngp.update(density_width=32, density_layers=2, color_width=32, color_layers=2,
               occ_resolution=32)
    ngp["cp"] = {"n_levels": 3, "n_components": 16, "table_size": 48,
                 "base_resolution": 8, "max_resolution": 32}
    ngp["grid"] = {"n_levels": 4, "n_features": 2, "log2_table_size": 12,
                   "base_resolution": 4, "max_resolution": 64}
    for k in ("train", "validation"):
        raw["nerf"][k]["num_coarse"] = 32
    out = w.witness(raw, views=9, size=32, steps=steps, seed=42, every=50, thresh=2.5,
                    grid_res=32)
    jax_out, port = out["jax"], out["port"]
    assert len(port["loss_by_window"]) == len(jax_out["loss_by_window"]) == 3
    assert abs(out["gap_db"]) <= MARGIN_DB, out
    assert abs(port["grid_share_above_thresh"] - jax_out["grid_share_above_thresh"]) \
        <= SHARE_MARGIN, out
    # both trained: the last window's loss under the first's
    for o in (jax_out, port):
        assert o["loss_by_window"][-1] < o["loss_by_window"][0], out


def test_classic_seed_42_ends_where_jax_ends(tmp_path):
    w = _script("torch_classic_seed_witness")
    basedir = w.write_scene(str(tmp_path), resolution=48, views=(10, 2, 1), samples=32)
    out = w.lockstep(str(tmp_path), basedir, steps=150, every=50, rays=64,
                     hidden_size=32, num_coarse=32, num_fine=32)
    assert out["first_loss_rel"] <= FIRST_LOSS_RTOL, out
    jcurve, tcurve = out["jax"]["val_psnr_db"], out["port"]["val_psnr_db"]
    assert sorted(jcurve) == sorted(tcurve) == [50, 100, 150]
    for curve in (jcurve, tcurve):
        assert curve[150] >= out["all_white_val_psnr_db"] + LEFT_WHITE_DB, out
    jl, tl = out["jax"]["loss_by_window"][-1], out["port"]["loss_by_window"][-1]
    assert abs(tl - jl) <= LAST_LOSS_RTOL * jl, out
    assert abs(out["gap_db"]) <= MARGIN_DB, out


# The card's state of configs/fox_ngp.yml's ``fused: off`` route: JAX against
# the port parts by bf16 rounding (the layers of both round the same values;
# f32 sums in another order can move a rounding by one bf16 step): 9.3e-4
# measured on the content crop. The card's central crop against the port's
# plain versions on the CPU: 9.3e-10 measured (that crop is nearly black).
CROP_TOL = 2e-3
CARD_CROP_TOL = 1e-5
CONTENT_CROP = (0, 48)  # a 32^2 window of held-out view 0 on a satellite


def test_card_halo_state_renders_in_both_packages():
    """The card's trained ``fused: off`` state of ``configs/fox_ngp.yml`` on
    the halo scene (``nerf_kinematics_tpu_torch/fixtures/
    halo_fox_unfused_1000.npz``, ``torch_halo_witness.py record``): 32^2
    crops of held-out view 0 through the JAX package's ``make_render_fn``
    and the port's, from the same parameters and grid, against each other,
    and the card's own render of its crop against the port's."""
    import numpy as np

    from nerf_kinematics_tpu_torch.io.fixture import intrinsics_from_row, read_halo_state

    w = _script("torch_halo_witness")
    st = read_halo_state()
    meta = json.loads(str(st["meta"]))
    raw = w.route_raw(w.fox_raw(), "unfused", 1000, int(meta["rays"]))
    te, tstate, je, jstate = w.replay_pair(raw, st, bound=16.0)
    near, far = (float(v) for v in st["near_far"])
    scene = types.SimpleNamespace(near=near, far=far)
    pose = st["crop_pose"]
    view = intrinsics_from_row(st["intrinsics"])
    for at in (tuple(int(v) for v in st["crop_at"]), CONTENT_CROP):
        intr = w.crop_intrinsics(view, *at)
        port = w.port_render(te, tstate.params, tstate.aux, intr, scene, pose).numpy()
        jax_img = w.jax_render(je, jstate, intr, scene, pose)
        assert port.shape == jax_img.shape == (w.CROP, w.CROP, 3)
        assert np.isfinite(port).all()
        assert np.abs(port - jax_img).max() <= CROP_TOL, at
        if at == CONTENT_CROP:
            assert port.std() > 0.1  # the satellite's edge, not a flat window
        else:
            assert np.abs(port - st["card_crop"]).max() <= CARD_CROP_TOL
