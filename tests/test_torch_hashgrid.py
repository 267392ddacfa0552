"""The hash encoder on the CPU, mirroring tests/test_hashgrid.py: the port's
``hash_encode`` against the scalar spec ``hash_encode_ref`` and against the
JAX package's ``hash_encode`` (an XLA gather there), forward and table
gradient, on dense and hashed levels; the fixed-order table gradient; the
``NGPModel`` with ``encoder: hash`` against flax through ``io/convert.py``.

Tolerances. Forward: rtol 1e-4 / atol 1e-5 against the f64 spec (as the
reference's own test), atol 2e-6 against JAX on O(1) tables (both f32, the
same products; the corner sum may round differently). Table gradient
against ``jax.grad``: rtol 1e-5 / atol 1e-6 (the sums of a row's taps run
in another order). The model in f32: atol 1e-5, as
tests/test_torch_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.models.ngp import NGPConfig as JNGPConfig
from nerf_kinematics_tpu.models.ngp import NGPModel as JNGPModel
from nerf_kinematics_tpu.ops import hashgrid as jh
from nerf_kinematics_tpu_torch.io.convert import params_from_flax, params_to_flax
from nerf_kinematics_tpu_torch.models import ngp as tngp
from nerf_kinematics_tpu_torch.ops import hashgrid as th

# dense levels (res 4, 8) and hashed ones (res 16, 32) at T = 2^10
SMALL = dict(n_levels=4, n_features=2, log2_table_size=10, base_resolution=4,
             max_resolution=32)
# every level hashed, coordinates up to 2^11 (the reference's finest)
FINE = dict(n_levels=2, n_features=4, log2_table_size=12, base_resolution=1024,
            max_resolution=2048)
CONFIGS = {"small": SMALL, "fine": FINE}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _table(cfg, seed=0):
    """O(1) entries, so that a wrong row or weight shows."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (cfg.n_levels, cfg.table_size, cfg.n_features)).astype(np.float32)


def _x(n=64, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)  # some outside the box
    x[:4] = [[1.0, 1.0, 1.0], [1.0, 0.3, 0.7], [0.25, 1.0, 0.5], [0.0, 0.0, 0.0]]
    return x


# ------------------------------------------------------------------ config

def test_reference_dims():
    cfg = th.HashGridConfig()
    assert cfg.out_dim == 32 and cfg.table_size == 524288
    assert cfg.n_params == 8 * 524288 * 4
    assert cfg.resolutions == jh.HashGridConfig().resolutions
    assert 1.9 < cfg.per_level_scale < 2.1 and cfg.resolutions[0] == 16
    cfg4 = th.HashGridConfig(max_resolution=4096)
    assert cfg4.per_level_scale == jh.HashGridConfig(max_resolution=4096).per_level_scale
    assert th.HashGridConfig(n_levels=1).per_level_scale == 1.0
    for res in cfg.resolutions:
        if (res + 1) ** 3 <= cfg.table_size:
            assert res <= 79  # the dense cutoff for T = 2^19


def test_config_moved_and_re_exported():
    assert tngp.HashGridConfig is th.HashGridConfig
    ngp = tngp.NGPConfig.from_cfg({"encoder": "hash", "n_levels": 5, "grid": {"n_levels": 8}})
    assert ngp.grid == th.HashGridConfig(n_levels=8) and ngp.encoding_dim == 32


def test_init_table_is_uniform_in_1e4_from_the_generator():
    cfg = th.HashGridConfig(**SMALL)
    a = th.init_table(cfg, torch.Generator().manual_seed(3))
    b = th.init_table(cfg, torch.Generator().manual_seed(3))
    assert a.shape == (4, 1024, 2) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert a.abs().max() <= 1e-4 and a.min() < -9e-5 and a.max() > 9e-5
    assert abs(float(a.mean())) < 5e-6


def test_hash_is_the_reference_uint32_hash():
    """int64 products masked to T - 1 give the reference's wrapping uint32
    multiply-xor for every corner coordinate below 2^12."""
    rng = np.random.default_rng(2)
    c = rng.integers(0, 4097, (4096, 3))
    c[:3] = [[4096, 4096, 4096], [0, 0, 0], [1, 4095, 2048]]
    for log2_t in (10, 19, 22):
        got = th._level_indices(torch.tensor(c), 2048, 1 << log2_t).numpy()
        want = np.asarray(jh._level_indices(jnp.asarray(c, jnp.int32), 2048, 1 << log2_t))
        assert np.array_equal(got, want)
    dense = th._level_indices(torch.tensor(c % 9), 8, 1024).numpy()
    assert np.array_equal(dense, (c % 9) @ np.array([1, 9, 81]))


# ------------------------------------------------------------------ forward

@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_matches_scalar_reference_and_jax(which):
    cfg = th.HashGridConfig(**CONFIGS[which])
    table, x = _table(cfg), _x()
    got = th.hash_encode(torch.tensor(table), torch.tensor(x), cfg).numpy()
    slow = th.hash_encode_ref(table, x, cfg)
    np.testing.assert_allclose(got, slow, rtol=1e-4, atol=1e-5)
    # the port's spec is the reference's spec
    np.testing.assert_array_equal(slow, jh.hash_encode_ref(table, x, jh.HashGridConfig(**CONFIGS[which])))
    want = np.asarray(jh.hash_encode(jnp.asarray(table), jnp.asarray(x),
                                     jh.HashGridConfig(**CONFIGS[which])))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_batch_shape_preserved():
    cfg = th.HashGridConfig(**SMALL)
    out = th.hash_encode(torch.tensor(_table(cfg)), torch.zeros(5, 7, 3), cfg)
    assert out.shape == (5, 7, cfg.out_dim)


def test_continuity_across_cells_and_at_the_upper_face():
    cfg = th.HashGridConfig(**SMALL)
    table = torch.tensor(_table(cfg))
    enc = lambda p: th.hash_encode(table, torch.tensor(p, dtype=torch.float32), cfg).numpy()
    eps = 1e-5
    np.testing.assert_allclose(enc([[0.5 - eps, 0.3, 0.7]]), enc([[0.5 + eps, 0.3, 0.7]]),
                               atol=1e-3)
    np.testing.assert_allclose(enc([[1.0 - 1e-6, 0.4, 0.6]]), enc([[1.0, 0.4, 0.6]]),
                               atol=1e-3)


def test_clamps_out_of_box():
    cfg = th.HashGridConfig(**SMALL)
    table = torch.tensor(_table(cfg))
    inside = th.hash_encode(table, torch.tensor([[0.0, 0.0, 0.0]]), cfg)
    outside = th.hash_encode(table, torch.tensor([[-5.0, -1.0, -0.1]]), cfg)
    assert torch.equal(inside, outside)


def test_nan_coordinate_matches_jax():
    """A NaN coordinate: both packages give NaN in every feature of the
    point (each corner's weight has a NaN factor, at every level), and the
    table gradient is NaN on the rows of the eight corners it taps at every
    level, finite elsewhere: the cell of the NaN axis is 0 in both (the
    port's clamp takes the integer of a NaN to 0, XLA makes 0 of it on the
    CPU)."""
    cfg = th.HashGridConfig(**SMALL)
    jcfg = jh.HashGridConfig(**SMALL)
    table = _table(cfg)
    x = _x(8)
    x[3, 1] = np.nan
    t = torch.tensor(table, requires_grad=True)
    got = th.hash_encode(t, torch.tensor(x), cfg)
    want = np.asarray(jh.hash_encode(jnp.asarray(table), jnp.asarray(x), jcfg))
    assert np.isnan(got[3].detach().numpy()).all() and np.isnan(want[3]).all()
    np.testing.assert_allclose(np.delete(got.detach().numpy(), 3, 0), np.delete(want, 3, 0),
                               atol=2e-6)
    g = np.ones(got.shape, np.float32)
    got.backward(torch.tensor(g))
    jg = np.asarray(jax.grad(lambda tb: jnp.sum(jh.hash_encode(tb, jnp.asarray(x), jcfg)))(
        jnp.asarray(table)))
    tg = t.grad.numpy()
    assert np.array_equal(np.isnan(tg), np.isnan(jg)) and np.isnan(tg).any()
    fin = ~np.isnan(tg)
    np.testing.assert_allclose(tg[fin], jg[fin], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- gradient

@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_table_gradient_matches_jax(which):
    cfg = th.HashGridConfig(**CONFIGS[which])
    jcfg = jh.HashGridConfig(**CONFIGS[which])
    table, x = _table(cfg), _x(200)
    x[100:150] = x[50:100]  # points that share rows: sums of several taps
    cot = np.random.default_rng(4).standard_normal((200, cfg.out_dim)).astype(np.float32)
    t = torch.tensor(table, requires_grad=True)
    th.hash_encode(t, torch.tensor(x), cfg).backward(torch.tensor(cot))
    jg = jax.grad(lambda tb: jnp.sum(jh.hash_encode(tb, jnp.asarray(x), jcfg) * cot))(
        jnp.asarray(table))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    touched = (t.grad.numpy() != 0).any(-1)
    assert 0 < touched.sum() <= 200 * cfg.n_levels * 8


def test_gradients_flow_to_touched_entries_only():
    cfg = th.HashGridConfig(**SMALL)
    t = torch.tensor(_table(cfg), requires_grad=True)
    (th.hash_encode(t, torch.tensor([[0.5, 0.5, 0.5]]), cfg) ** 2).sum().backward()
    g = t.grad.numpy()
    assert np.isfinite(g).all()
    assert 0 < (g != 0).sum() <= cfg.n_levels * 8 * cfg.n_features


def test_table_gradient_is_a_fixed_order_sum():
    """The transpose of the gather adds each row's taps in their order in
    ``idx``: the same bits on every call, and equal to a sequential sum."""
    rng = np.random.default_rng(5)
    idx = torch.tensor(rng.integers(0, 40, 3000))
    grad = torch.tensor(rng.standard_normal((3000, 3)).astype(np.float32))
    a = th.table_grad(grad, idx, 50)
    assert torch.equal(a, th.table_grad(grad, idx, 50))
    want = np.zeros((50, 3), np.float32)
    for i, r in enumerate(idx.numpy()):
        want[r] += grad[i].numpy()  # the same order: ascending position
    assert np.array_equal(a.numpy(), want)
    assert (a[40:] == 0).all()


@pytest.mark.parametrize("features,offset", [(1, 0), (2, 0), (4, 0), (4, 1), (3, 0), (8, 0)])
def test_take_rows_moves_whole_rows_bit_for_bit(features, offset):
    """The 4-, 8- and 16-byte rows go through a 1-D gather of one element a
    row; other widths and unaligned rows through the row gather: the same
    bits either way, a NaN's payload included."""
    rng = np.random.default_rng(features)
    flat = torch.tensor(rng.standard_normal(offset + 64 * features).astype(np.float32))
    t = flat[offset:].reshape(64, features)
    t.view(torch.int32)[5, 0] = 0x7FC00123  # a NaN with a payload
    idx = torch.tensor(rng.integers(0, 64, 500))
    idx[:3] = 5
    got = th.take_rows(t, idx)
    assert got.shape == (500, features) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), t[idx].view(torch.int32))


def test_point_gradient_flows_through_the_weights():
    """As the reference's autodiff: the features' gradient with respect to
    the points comes through the trilinear weights (the cell index is not
    differentiable)."""
    cfg = th.HashGridConfig(**SMALL)
    jcfg = jh.HashGridConfig(**SMALL)
    table = _table(cfg)
    x = np.random.default_rng(8).uniform(0.05, 0.95, (32, 3)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    th.hash_encode(torch.tensor(table), xt, cfg).sum().backward()
    jg = jax.grad(lambda p: jnp.sum(jh.hash_encode(jnp.asarray(table), p, jcfg)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------- model

NET = dict(density_width=32, density_out=16, color_width=32, color_layers=3)


def _pair():
    jm = JNGPModel(JNGPConfig(encoder="hash", grid=jh.HashGridConfig(**SMALL), **NET))
    x0 = np.zeros((1, 3), np.float32)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(5), x0, x0))
    rng = np.random.default_rng(6)
    tree["params"]["hash_table"] = rng.uniform(
        -1, 1, tree["params"]["hash_table"].shape).astype(np.float32)
    for leaf in tree["params"].values():
        if isinstance(leaf, dict):
            leaf["bias"] = (0.2 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32)
    tm = tngp.NGPModel(tngp.NGPConfig(encoder="hash", grid=th.HashGridConfig(**SMALL), **NET))
    tm.load_state_dict(params_from_flax(tree))
    return jm, tree, tm


def test_model_with_hash_encoder_matches_flax():
    jm, tree, tm = _pair()
    assert set(tm.state_dict()) == {"hash_table"} | {
        f"{k}.{leaf}" for k, v in tree["params"].items() if isinstance(v, dict) for leaf in v}
    assert not hasattr(tm, "cp_lines")
    rng = np.random.default_rng(7)
    x = rng.uniform(0.0, 1.0, (150, 3)).astype(np.float32)
    vd = rng.standard_normal((150, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    rgb_j, sig_j = jm.apply(tree, jnp.asarray(x), jnp.asarray(vd))
    sd_j, feat_j = jm.apply(tree, jnp.asarray(x), method=JNGPModel.density)
    with torch.no_grad():
        rgb_t, sig_t = tm(torch.tensor(x), torch.tensor(vd))
        sd_t, feat_t = tm.density(torch.tensor(x))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(feat_t.numpy(), np.asarray(feat_j), atol=1e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sd_t.numpy(), np.asarray(sd_j), rtol=1e-5, atol=1e-6)


def test_model_table_gradient_matches_flax():
    jm, tree, tm = _pair()
    rng = np.random.default_rng(9)
    x = rng.uniform(0.0, 1.0, (100, 3)).astype(np.float32)
    vd = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (100, 1))

    def loss(p):
        rgb, sigma = jm.apply(p, jnp.asarray(x), jnp.asarray(vd))
        return jnp.sum(rgb**2) + jnp.sum(jnp.log(sigma))

    jg = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, tree))
    rgb, sigma = tm(torch.tensor(x), torch.tensor(vd))
    (torch.sum(rgb**2) + torch.sum(torch.log(sigma))).backward()
    want = np.asarray(jg["params"]["hash_table"])
    np.testing.assert_allclose(tm.hash_table.grad.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_hash_tree_round_trip_is_bit_exact():
    _, tree, tm = _pair()
    back = params_to_flax(tm.state_dict(), encoder="hash")["params"]
    assert set(back) == set(tree["params"])
    assert np.array_equal(back["hash_table"].view(np.uint32),
                          tree["params"]["hash_table"].view(np.uint32))
    with pytest.raises(ValueError, match="encoder"):
        params_to_flax(tm.state_dict(), encoder="nope")


def test_encoders_the_model_refuses():
    with pytest.raises(ValueError):
        tngp.NGPModel(tngp.NGPConfig(encoder="nope"))
    from nerf_kinematics_tpu_torch.train.config import Config
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    # the fused kernels take the CP encoder only
    cfg = Config(engine="ngp", ngp=tngp.NGPConfig(encoder="hash", fused="on",
                                                  grid=th.HashGridConfig(**SMALL)))
    with pytest.raises(ValueError, match="hash"):
        NGPEngine(cfg, device="cpu")
    auto = Config(engine="ngp", ngp=tngp.NGPConfig(encoder="hash", grid=th.HashGridConfig(**SMALL)))
    assert not NGPEngine(auto, device="cpu").fused
