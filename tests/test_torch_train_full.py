"""The whole-step train kernel (``ngp_fused_train_full_cf``) and the engine's
``ngp.fused_train: full`` objective of the port against the JAX package's, on
the CPU: the same weights, rays, targets, occupancy grid and inverse-CDF
positions go through the reference's Pallas kernel in interpret mode and
through the port's plain version.

Shape as ``tests/test_fused_train.py``: 256 rays, 8 coarse and 6 fine
samples, a 16^3 occupancy grid, 8 proposal bins. Tolerances as that test
holds the reference's kernel against autodiff: losses rtol 1e-5, gradients
rtol 1e-3 / atol 1e-6; err, maps and err_c per ray rtol 1e-5 / atol 1e-7
(1e-4 with bf16 operands, where the two frameworks may round one activation
of a ray differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.ops.ngp_fused_pallas import ngp_fused_train_full_cf as j_full
from nerf_kinematics_tpu.ops.occupancy import OccupancyGrid as JGrid
from nerf_kinematics_tpu.ops.occupancy import pair_projections as j_proj
from nerf_kinematics_tpu.train import config as jcfg
from nerf_kinematics_tpu.train.ngp_engine import NGPEngine as JEngine
from nerf_kinematics_tpu_torch.io import convert
from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (
    ngp_fused_train_full_cf, ngp_fused_train_full_cf_ref)
from nerf_kinematics_tpu_torch.ops.occupancy import pair_projections
from nerf_kinematics_tpu_torch.train import config as tcfg
from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

N_RAYS, N_COARSE, N_FINE, OCC, BINS = 256, 8, 6, 16, 8
NEAR, FAR = 0.5, 3.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: several intra-op threads per test worker only
    fight over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _raw(white=True, bf16=True, fused_train="full", perturb=True):
    return {
        "engine": "ngp",
        "ngp": {
            "encoder": "cp_pallas", "n_levels": 3, "n_components": 16,
            "table_size": 48, "base_resolution": 8, "max_resolution": 32,
            "density_width": 32, "density_out": 16, "color_width": 32,
            "color_layers": 3, "use_occupancy": True, "occ_resolution": OCC,
            "occ_bins": BINS, "fused": "on", "fused_train": fused_train,
            "cp": {"use_bf16": bf16},
        },
        "dataset": {"near": NEAR, "far": FAR},
        "nerf": {
            "train": {"num_coarse": N_COARSE, "num_fine": N_FINE,
                      "white_background": white, "num_random_rays": N_RAYS,
                      "perturb": perturb},
            "validation": {"num_coarse": N_COARSE, "num_fine": N_FINE,
                           "perturb": False, "white_background": white},
            "coarse_loss_weight": 0.0,
        },
    }


def _grid():
    """An ellipsoid of high density in a thin fog: a hull proposal that
    shapes the coarse PDF (an all-occupied grid is the uniform floor)."""
    lin = (np.arange(OCC) + 0.5) / OCC * 2 - 1
    xs, ys, zs = np.meshgrid(lin, lin, lin, indexing="ij")
    r = np.sqrt(xs**2 + 1.3 * ys**2 + 0.8 * zs**2)
    return np.where(r < 0.7, 20.0 * (1.0 - r), 0.02).astype(np.float32)


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    o = (0.1 * rng.standard_normal((N_RAYS, 3))).astype(np.float32)
    d = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d *= rng.uniform(0.9, 1.1, (N_RAYS, 1)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return {
        "o": o, "d": d, "vd": vd,
        "target": rng.uniform(size=(N_RAYS, 3)).astype(np.float32),
        # raw uniforms U: the objectives turn them into arange(n)/n + U/n
        "u_coarse": rng.uniform(size=(N_RAYS, N_COARSE)).astype(np.float32),
        "u_fine": rng.uniform(size=(N_RAYS, N_FINE)).astype(np.float32),
    }


def _stratified(u):
    n = u.shape[1]
    return (np.arange(n, dtype=np.float32) / np.float32(n) + u / np.float32(n)).astype(np.float32)


class _Pair:
    """Both engines on the same freshly initialised weights and grid."""

    def __init__(self, **kw):
        raw = _raw(**kw)
        self.je = JEngine(jcfg.config_from_dict(raw), scene_bound=1.0)
        self.jstate = self.je.init_state(seed=9)
        self.jgrid = JGrid(jnp.asarray(_grid()), jnp.float32(1.0))
        tree = jax.tree_util.tree_map(np.array, self.jstate.params["coarse"])
        self.te = NGPEngine(tcfg.config_from_dict(raw), scene_bound=1.0, device="cpu")
        self.te.load_flax_params(tree)
        self.tgrid = grid_from_numpy(_grid(), 1.0)

    def jgrads(self, d_fused):
        tree = self.je._fused_grads_to_tree(d_fused)
        return convert.named_from_flax(jax.tree_util.tree_map(np.asarray, tree))

    def tgrads(self, d_fused):
        return {k: v.numpy() for k, v in self.te._fused_grads_to_tree(d_fused).items()}


def _compare_grads(got, want):
    assert set(got) == set(want)
    live = 0
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        np.testing.assert_allclose(got[name], w, rtol=1e-3, atol=1e-6, err_msg=name)
        live += np.abs(w).max() > 0
    assert live >= 5


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("white", [True, False], ids=["white", "black"])
def test_train_full_plain_version_matches_the_reference_kernel(white, bf16):
    pr = _Pair(white=white, bf16=bf16)
    x = _inputs()
    uc, uf = _stratified(x["u_coarse"]).T.copy(), _stratified(x["u_fine"]).T.copy()
    inv = 1.0 / (3.0 * N_RAYS)
    statics = dict(near=NEAR, far=FAR, bound=1.0, occ_floor=pr.te.ngp_config.occ_floor)
    ej, mj, ecj, dj = j_full(
        pr.je._fused_params(pr.jstate.params["coarse"]),
        *(jnp.asarray(x[k].T) for k in ("o", "d", "vd", "target")),
        jnp.asarray(uc), jnp.asarray(uf), j_proj(pr.jgrid), pr.je.ngp_config.cp,
        N_FINE, N_COARSE, BINS, white, inv, interpret=True, **statics)
    et, mt, ect, dt = ngp_fused_train_full_cf(
        pr.te._fused_params(detach=True),
        *(torch.tensor(x[k].T.copy()) for k in ("o", "d", "vd", "target")),
        torch.tensor(uc), torch.tensor(uf), pair_projections(pr.tgrid),
        pr.te.ngp_config.cp, N_FINE, N_COARSE, BINS, white, inv, **statics)
    assert et.shape == (1, N_RAYS) and mt.shape == (4, N_RAYS) and ect.shape == (1, N_RAYS)
    # bf16: a last-bit difference of a depth can flip the rounding of one
    # activation of one ray (1.3e-5 of that ray's error measured)
    rtol = 1e-4 if bf16 else 1e-5
    for got, want, name in ((et, ej, "err"), (mt, mj, "maps"), (ect, ecj, "err_c")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=1e-7,
                                   err_msg=name)
    np.testing.assert_allclose(float(et.sum()) * inv, float(jnp.sum(ej)) * inv, rtol=1e-5)
    # some rays cross the ellipsoid: the proposal has something to place
    assert float(mt[3].max()) > 0.5
    _compare_grads(pr.tgrads(dt), pr.jgrads(dj))


def test_train_full_plain_helpers_follow_the_reference():
    """The CDF adds 1e-5 and accumulates w / tot bin by bin; the inverse
    clips the bin count to [1, M] and divides by 1 where a bin has no mass."""
    from nerf_kinematics_tpu.ops import ngp_fused_pallas as jp
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (
        _cdf_rows_ref, _inv_cdf_rows_ref)

    rng = np.random.default_rng(3)
    w = rng.uniform(size=(128, 7)).astype(np.float32)
    w[:5] = 0.0  # empty rays: the +1e-5 keeps them uniform
    w[5:9, 2:5] = 0.0  # bins with no mass inside a ray
    cdf_j = jp._cdf_rows([jnp.asarray(w[:, k][None]) for k in range(7)])
    cdf_t = _cdf_rows_ref(torch.tensor(w))
    np.testing.assert_array_equal(cdf_t.numpy(), np.asarray(cdf_j).T)
    edges = np.sort(rng.uniform(0.5, 3.0, (128, 8)), axis=1).astype(np.float32)
    u = np.sort(rng.uniform(size=(128, 5)), axis=1).astype(np.float32)
    u[0, :] = [0.0, 0.25, 0.5, 0.75, 1.0]  # both ends of the CDF
    got = _inv_cdf_rows_ref(cdf_t, torch.tensor(edges), torch.tensor(u)).numpy()
    want = np.stack([np.asarray(r)[0] for r in jp._inv_cdf_rows(
        jnp.asarray(np.asarray(cdf_j)), jnp.asarray(edges.T), jnp.asarray(u.T), 5)], axis=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


@pytest.mark.parametrize("perturb", [True, False], ids=["perturb", "deterministic"])
@pytest.mark.parametrize("white", [True, False], ids=["white", "black"])
def test_full_objective_matches_jax(white, perturb, monkeypatch):
    """The engine's objective on ``ngp.fused_train: full``: the same draws
    (handed to JAX by patching its uniform draws) give the same losses and
    the same named gradients."""
    pr = _Pair(white=white, bf16=False, perturb=perturb)
    x = _inputs(seed=8)
    by_shape = {(N_RAYS, N_COARSE): x["u_coarse"], (N_RAYS, N_FINE): x["u_fine"]}
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), dtype=jnp.float32, **kw:
                        jnp.asarray(by_shape[tuple(shape)], dtype))
    jobj = pr.je.fused_objective_fn(NEAR, FAR, pr.je.cfg.nerf.train)
    jbatch = tuple(jnp.asarray(x[k]) for k in ("o", "d", "vd", "target"))
    (jl, (jlc, jlf)), jg = jobj(pr.jstate.params, jbatch, jax.random.PRNGKey(0), pr.jgrid)
    tobj = pr.te.fused_objective_fn(NEAR, FAR, pr.te.cfg.nerf.train)
    tbatch = tuple(torch.tensor(x[k]) for k in ("o", "d", "vd", "target"))
    (tl, (tlc, tlf)), tg = tobj(tbatch, pr.tgrid, torch.Generator().manual_seed(0),
                                u_coarse=torch.tensor(x["u_coarse"]),
                                u_fine=torch.tensor(x["u_fine"]))
    for got, want in ((tl, jl), (tlc, jlc), (tlf, jlf)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(tl) == float(tlf)
    want = convert.named_from_flax(jax.tree_util.tree_map(np.asarray, jg["coarse"]))
    _compare_grads({k: v.numpy() for k, v in tg.items()}, want)
    # without draws passed in, the step's generator supplies them: one
    # generator state, one result
    a = tobj(tbatch, pr.tgrid, torch.Generator().manual_seed(4))
    b = tobj(tbatch, pr.tgrid, torch.Generator().manual_seed(4))
    assert float(a[0][0]) == float(b[0][0])


def test_full_route_eligibility():
    """The reference's rules: ``full`` needs the hull proposal on a linear
    scene with a static depth range, and an otherwise eligible step."""
    import dataclasses

    te = NGPEngine(tcfg.config_from_dict(_raw()), scene_bound=1.0, device="cpu")
    settings = te.cfg.nerf.train
    assert te.fused_objective_fn(NEAR, FAR, settings).__name__ == "objective_full"
    with pytest.raises(ValueError, match="static near/far"):
        te.fused_objective_fn(torch.tensor(NEAR), FAR, settings)
    no_occ = dataclasses.replace(te.ngp_config, use_occupancy=False)
    with pytest.raises(ValueError, match="hull"):
        NGPEngine(te.cfg.replace(ngp=no_occ), device="cpu").fused_objective_fn(
            NEAR, FAR, settings)
    # an ineligible step shape takes autograd, as with "auto"
    odd = te.cfg.replace(nerf=dataclasses.replace(te.cfg.nerf, num_random_rays=200))
    assert NGPEngine(odd, device="cpu").fused_objective_fn(NEAR, FAR, settings) is None
    on = tcfg.config_from_dict(_raw(fused_train="on"))
    assert NGPEngine(on, device="cpu").fused_objective_fn(
        NEAR, FAR, settings).__name__ == "objective"
    with pytest.raises(ValueError, match="3 coarse samples"):
        ngp_fused_train_full_cf(None, torch.zeros(3, 4), None, None, torch.zeros(3, 4),
                                torch.zeros(2, 4), torch.zeros(6, 4), None, None,
                                6, 2, 8, True, 1.0, NEAR, FAR, 1.0, 0.01)


def test_train_full_plain_version_is_the_cpu_route(monkeypatch):
    """A CPU tensor takes the plain version, the library is never asked for,
    and nothing is counted as a launch."""
    from nerf_kinematics_tpu_torch.ops import cuda_lib

    def boom(*a, **k):
        raise AssertionError("the CUDA library was asked for on the CPU")

    monkeypatch.setattr(cuda_lib, "load_library", boom)
    monkeypatch.setattr(cuda_lib, "build_library", boom)
    pr = _Pair(bf16=True)
    x = _inputs(seed=2)
    cuda_lib.reset_launch_counts()
    args = (pr.te._fused_params(detach=True),
            *(torch.tensor(x[k].T.copy()) for k in ("o", "d", "vd", "target")),
            torch.tensor(_stratified(x["u_coarse"]).T.copy()),
            torch.tensor(_stratified(x["u_fine"]).T.copy()),
            pair_projections(pr.tgrid), pr.te.ngp_config.cp, N_FINE, N_COARSE,
            BINS, True, 1.0 / (3 * N_RAYS), NEAR, FAR, 1.0, 0.01)
    a = ngp_fused_train_full_cf(*args)
    b = ngp_fused_train_full_cf_ref(*args)
    assert all(torch.equal(p, q) for p, q in zip(a[:3], b[:3]))
    assert torch.equal(a[3]["lines"], b[3]["lines"])
    assert cuda_lib.LAUNCHES["ngp_fused_train_full_cf"] == 0


def test_init42_fixture_is_the_jax_initial_state():
    """``fixtures/machina_ngp_init42.npz`` holds the JAX package's
    ``NGPEngine(machina_ngp).init_state(42)`` weights exactly, and the port
    loads them into its model leaf for leaf."""
    from nerf_kinematics_tpu.train.config import load_config
    from nerf_kinematics_tpu_torch.io.convert import params_from_npz
    from nerf_kinematics_tpu_torch.io.fixture import MACHINA_NGP_INIT42

    jstate = JEngine(load_config("configs/machina_ngp.yml"), 1.0).init_state(42)
    want = jax.tree_util.tree_leaves_with_path(jstate.params["coarse"])
    got = params_from_npz(MACHINA_NGP_INIT42)
    assert len(jax.tree_util.tree_leaves(got)) == len(want)
    for path, leaf in want:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf, np.float32),
                                      err_msg=jax.tree_util.keystr(path))
    from nerf_kinematics_tpu_torch.io.fixture import read_fixture

    eng = NGPEngine(read_fixture().config, 1.0, device="cpu")
    eng.load_flax_params(got)
    back = convert.params_to_flax(eng.model.state_dict())
    for path, leaf in want:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf, np.float32))
