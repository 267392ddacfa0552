"""Snapshots go both ways between the packages: the JAX package's
``save_snapshot`` (flax msgpack) read by the port's own msgpack reader, the
port's file read by the JAX package, with equal arrays, dtypes and
metadata, and equal msgpack bytes for the same tree. Garbage is rejected, as
in ``tests/test_io.py``. The fast engine's parameters cross through
``io/convert.py``."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from nerf_kinematics_tpu.io.snapshot import load_snapshot as j_load
from nerf_kinematics_tpu.io.snapshot import save_snapshot as j_save
from nerf_kinematics_tpu.train import config as jcfg
from nerf_kinematics_tpu.train.ngp_engine import NGPEngine as JEngine
from nerf_kinematics_tpu_torch.io import load_snapshot, save_snapshot
from nerf_kinematics_tpu_torch.io.snapshot import MAGIC, packb, unpackb
from nerf_kinematics_tpu_torch.train import config as tcfg
from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

RAW = {"engine": "ngp",
       "ngp": {"encoder": "cp_pallas", "n_levels": 2, "n_components": 8, "table_size": 16,
               "base_resolution": 8, "max_resolution": 16, "density_width": 16,
               "color_width": 16, "use_occupancy": True, "occ_resolution": 8}}


def _tree(rng):
    return {
        "params": {"b": rng.standard_normal((2, 3)).astype(np.float32),
                   "a": {"k": np.arange(5, dtype=np.int32),
                         "empty": np.zeros((0, 4), np.float64)}},
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**40, -1, -32, -33,
                 -128, -129, -2**15 - 1, -2**31 - 1, -2**40],
        "f": 1.5, "s": "x" * 40, "long": "y" * 70000, "n": None, "t": True, "no": False,
        "u8": np.arange(300, dtype=np.uint8), "f16": np.ones(5, np.float16),
        "mask": np.array([True, False]), "bin": b"\x00\x01" * 200,
        "many": {f"k{i:02d}": i for i in range(20)},
    }


def _same(a, b, path="tree"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_msgpack_bytes_equal_flax():
    tree = _tree(np.random.default_rng(0))
    assert packb(tree) == serialization.msgpack_serialize(tree)
    _same(tree, unpackb(serialization.msgpack_serialize(tree)))
    _same(tree, serialization.msgpack_restore(packb(tree)))
    # a numpy scalar (flax's extension type 3) and bf16 arrays
    assert unpackb(serialization.msgpack_serialize({"s": np.float32(2.5)}))["s"] == 2.5
    bf = unpackb(serialization.msgpack_serialize({"w": jnp.arange(4, dtype=jnp.bfloat16)}))
    assert bf["w"].dtype == torch.bfloat16 and bf["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    back = serialization.msgpack_restore(packb({"w": torch.arange(4, dtype=torch.bfloat16)}))
    assert back["w"].dtype == jnp.bfloat16 and back["w"].tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="trailing"):
        unpackb(packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        unpackb(packb("abc")[:-1])
    with pytest.raises(TypeError):
        packb({1: 2})


def test_the_jax_packages_snapshot_reads_in_the_port(tmp_path):
    tree = _tree(np.random.default_rng(1))
    path = str(tmp_path / "jax.nktsnap")
    j_save(path, tree, {"step": 7, "scene": "lego"})
    got, meta = load_snapshot(path)
    assert meta == {"step": 7, "scene": "lego"}
    _same(tree, got)


def test_the_ports_snapshot_reads_in_the_jax_package(tmp_path):
    tree = _tree(np.random.default_rng(2))
    tree["tensor"] = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    path = str(tmp_path / "port.nktsnap")
    save_snapshot(path, tree, {"step": 3, "engine": "ngp"})
    got, meta = j_load(path)
    assert meta == {"step": 3, "engine": "ngp"}
    want = dict(tree, tensor=tree["tensor"].numpy())
    _same(want, jax.tree_util.tree_map(lambda x: x, got, is_leaf=lambda x: isinstance(
        x, (list, np.ndarray))))
    # the same bytes as the JAX package writes for the same tree
    j_save(str(tmp_path / "jax.nktsnap"), want, {"step": 3, "engine": "ngp"})
    assert (tmp_path / "jax.nktsnap").read_bytes() == (tmp_path / "port.nktsnap").read_bytes()


def test_snapshot_rejects_garbage(tmp_path):
    p = tmp_path / "bad.snap"
    p.write_bytes(b"not a snapshot")
    with pytest.raises(ValueError):
        load_snapshot(str(p))
    q = tmp_path / "bad_payload.snap"
    q.write_bytes(MAGIC + (2).to_bytes(8, "little") + b"{}" + zlib.compress(b"\xc1"))
    with pytest.raises(ValueError, match="unknown type byte"):
        load_snapshot(str(q))


@pytest.mark.parametrize("encoder", ["cp", "cp_pallas"])
def test_engine_parameters_cross_both_ways(encoder, tmp_path):
    """The JAX engine's parameter tree in a JAX snapshot loads into the
    port's engine, and the port's tree, saved, is the JAX tree again."""
    from nerf_kinematics_tpu_torch.cli.ngp_run import snapshot_tree, state_from_snapshot

    raw = dict(RAW, ngp=dict(RAW["ngp"], encoder=encoder))
    je = JEngine(jcfg.config_from_dict(raw), scene_bound=1.0)
    jstate = je.init_state(seed=3)
    jparams = jax.device_get(jstate.params)
    path = str(tmp_path / "j.nktsnap")
    j_save(path, {"params": jparams}, {"step": 11, "engine": "ngp"})

    te = NGPEngine(tcfg.config_from_dict(raw), scene_bound=1.0, device="cpu")
    state = state_from_snapshot(te, *load_snapshot(path))
    assert int(state.step) == 11 and state.aux is not None
    back = str(tmp_path / "t.nktsnap")
    save_snapshot(back, snapshot_tree(te, state), {"step": int(state.step), "engine": "ngp"})
    payload, meta = j_load(back)
    assert meta == {"step": 11, "engine": "ngp"}
    _same(jax.tree_util.tree_map(np.asarray, jparams), payload["params"])
    # the grid travels too: a fresh one here
    np.testing.assert_array_equal(payload["occupancy"]["density"], state.aux.density.numpy())
