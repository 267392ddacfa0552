"""Data parallelism of the port (``parallel/``) on the CPU: two ranks of a
``gloo`` group in worker processes (tests/_torch_mesh_worker.py, one launch
for the module, 120 s at most) against one process and against the JAX
package's 8-device mesh; mirrors tests/test_sharding.py.

Tolerances. The ranks' mean of the per-rank gradients is the one device's
gradient summed in another order, so a 2-rank step is held to one device at
f32 rounding (loss rtol 1e-6, parameters where |g| > 2e-6 to 1e-6). Against
JAX's mesh step the rules of ROADMAP "Rules for parity tests" hold: loss
rtol 1e-5, parameters atol 1e-5 where |g| > 2e-6. Frame-sharded serving is
bit-equal to one rank. ``Trainer.fit`` of the NGP hull config (refreshes
included) keeps tests/test_sharding.py's bounds.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as w
from nerf_kinematics_tpu_torch.parallel import mesh as pm

G_LIVE = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """JAX's classic step on its 8-device mesh from its seed-0 weights, the
    global draws made here with numpy and handed to ``jax.random``."""
    from nerf_kinematics_tpu.data.types import Intrinsics as JIntrinsics
    from nerf_kinematics_tpu.parallel import make_mesh, replicated_sharding
    from nerf_kinematics_tpu.train import config as jcfg
    from nerf_kinematics_tpu.train.loop import ClassicNerf as JClassic
    from nerf_kinematics_tpu_torch.train.loop import ClassicNerf

    assert len(jax.devices()) == 8
    ds = w.scene()
    raw = w.config(w.CLASSIC_RAW)  # the port's Config, for its layout
    te = ClassicNerf(raw, device="cpu")
    jraw = dict(w.CLASSIC_RAW, dataset={"near": 0.5, "far": 3.5})
    je = JClassic(jcfg.config_from_dict(jraw), mesh=make_mesh())
    j0 = je.init_state(0)
    te.load_flax_params(jax.tree_util.tree_map(np.asarray, j0.params))
    params0 = te.layout.flatten({n: p.detach() for n, p in te.model.named_parameters()})
    n, S = 256, 16
    rng = np.random.default_rng(21)
    n_img = len(ds.train_idx)
    pixels = np.stack([rng.integers(0, n_img, n), rng.integers(0, 16, n),
                       rng.integers(0, 16, n)]).astype(np.int64)
    u = rng.uniform(size=(n, S)).astype(np.float32)
    ints, unis = [pixels[0], pixels[1], pixels[2]], [u]
    saved = jax.random.randint, jax.random.uniform, jax.random.normal
    jax.random.randint = lambda key, shape, minval, maxval, dtype=jnp.int32: jnp.asarray(
        ints.pop(0), dtype)
    jax.random.uniform = lambda key, shape=(), dtype=jnp.float32, **kw: jnp.asarray(
        unis.pop(0), dtype)
    jax.random.normal = lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype)
    try:
        ji = ds.intrinsics
        jintr = JIntrinsics(fl_x=ji.fl_x, fl_y=ji.fl_y, cx=ji.cx, cy=ji.cy,
                            width=ji.width, height=ji.height)
        rep = replicated_sharding(je.mesh)
        imgs, poses = ds.split("train")
        step = je.make_train_step(jintr, ds.near, ds.far, False, donate=False)
        j1, jm = step(jax.device_put(j0, rep), jax.device_put(jnp.asarray(imgs), rep),
                      jax.device_put(jnp.asarray(poses), rep))
    finally:
        jax.random.randint, jax.random.uniform, jax.random.normal = saved
    assert not ints and not unis, "the JAX step left draws unused"

    def flat(tree):
        te.load_flax_params(jax.tree_util.tree_map(np.asarray, tree))
        return te.layout.flatten({k: p.detach() for k, p in
                                  te.model.named_parameters()}).numpy().copy()

    from nerf_kinematics_tpu_torch.io.convert import flat_from_reference

    big = [np.asarray(l) for l in jax.tree_util.tree_leaves(j1.opt_state)
           if np.size(l) == te.layout.total]
    assert len(big) == 2  # mu, nu of the flattened Adam
    path = str(tmp_path_factory.mktemp("mesh_inputs") / "inputs.npz")
    np.savez(path, classic_params0=params0.numpy(), classic_pixels=pixels,
             classic_u_coarse=u)
    return {"loss": float(jm["loss"]), "params": flat(j1.params),
            "g": flat_from_reference(big[0], te.layout).numpy() / 0.1, "inputs": path}


@pytest.fixture(scope="module")
def ranks(jax_step, tmp_path_factory):
    """The module's one 2-rank launch: every scenario."""
    out = str(tmp_path_factory.mktemp("mesh_ranks"))
    spec = {"scenarios": ["world", "classic_step", "classic_fit", "ngp_fit", "serve"],
            "inputs": jax_step["inputs"], "ngp_logdir": os.path.join(out, "mesh_logs")}
    return w.launch(spec, out, world=2, timeout=120), spec


def test_mesh_has_two_ranks(ranks):
    """Each worker's mesh is (its rank, 2); without a group, or with a
    group of one, there is none."""
    import torch.distributed as dist

    res, _ = ranks
    assert [r["world"].tolist() for r in res] == [[2, 0], [2, 1]]
    assert pm.make_mesh() is None
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{w.free_port()}",
                            world_size=1, rank=0)
    try:
        assert pm.make_mesh("cpu") is None
    finally:
        dist.destroy_process_group()
    assert pm.default_backend("cpu") == "gloo"


def test_sharded_matches_single_device(ranks, jax_step):
    """The port's 2-rank classic step, given JAX's global draws (each rank
    slices its rows), against JAX's 8-device mesh step from the same
    weights; and against the port's own single-device step."""
    res, spec = ranks
    for r in res:
        np.testing.assert_allclose(float(r["classic_step_loss"]), jax_step["loss"],
                                   rtol=1e-5)
    assert np.array_equal(res[0]["classic_step_params"], res[1]["classic_step_params"])
    live = np.abs(jax_step["g"]) > G_LIVE
    assert live.mean() > 0.2
    got = res[0]["classic_step_params"]
    np.testing.assert_allclose(got[live], jax_step["params"][live], rtol=0, atol=1e-5)
    one = w.classic_step(spec, None, 0)
    np.testing.assert_allclose(float(res[0]["classic_step_loss"]),
                               float(one["classic_step_loss"]), rtol=1e-6)
    mine = np.abs(one["classic_step_mu"]) > 0.1 * G_LIVE
    np.testing.assert_allclose(got[mine], one["classic_step_params"][mine], rtol=0,
                               atol=1e-6)


def test_sharded_training_step_runs_and_converges(ranks):
    res, _ = ranks
    losses = res[0]["classic_fit_losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert np.array_equal(losses, res[1]["classic_fit_losses"])
    assert np.array_equal(res[0]["classic_fit_params"], res[1]["classic_fit_params"])
    one = w.classic_fit({}, None, 0)["classic_fit_losses"]
    np.testing.assert_allclose(losses, one, rtol=1e-4)


def test_batch_sharding_distributes_rows():
    """Rank r of 8 holds rows r * n / 8 .. (r + 1) * n / 8; their
    concatenation is the batch; an uneven batch is refused."""
    x = torch.arange(64.0).reshape(8, 8)
    shards = [pm.shard_batch(x, pm.Mesh(r, 8, torch.device("cpu"), "gloo"))
              for r in range(8)]
    assert all(s.shape == (1, 8) for s in shards)
    assert torch.equal(torch.cat(shards), x)
    assert pm.shard_batch(x, None) is x
    with pytest.raises(ValueError, match="split"):
        pm.shard_batch(torch.zeros(6, 2), pm.Mesh(0, 4, torch.device("cpu"), "gloo"))


def test_multihost_helpers_single_process():
    from nerf_kinematics_tpu_torch.parallel.multihost import (
        host_local_slice, initialize_multihost, make_global_batch)

    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE") if k in os.environ}
    try:
        assert initialize_multihost() is False  # no coordinator: single process
    finally:
        os.environ.update(env)
    sl = host_local_slice(10)
    assert (sl.start, sl.stop) == (0, 10)
    local = np.arange(16.0).reshape(8, 2)
    assert np.array_equal(make_global_batch(local, None).numpy(), local)
    assert pm.all_reduce_mean(torch.ones(3), None).sum() == 3.0
    assert pm.all_gather_rows(torch.ones(2, 1), None).shape == (2, 1)


def test_ngp_hull_fit_parity_mesh_vs_single(ranks, tmp_path):
    """``Trainer.fit`` of the NGP hull config (a full sweep, then
    incremental refreshes) on two ranks against one process: the grids,
    losses and parameters agree, the ranks hold the same state, and rank 0
    alone wrote the metrics."""
    res, spec = ranks
    one = w.ngp_fit({"ngp_logdir": str(tmp_path)}, None, 0)
    g2 = res[0]["ngp_fit_grid"]
    assert not np.allclose(g2, 1.0), "occupancy grid never updated"
    assert res[0]["ngp_fit_refreshes"].tolist() == [[8, 1], [16, 0], [24, 0]]
    np.testing.assert_allclose(one["ngp_fit_grid"], g2, atol=1e-4)
    np.testing.assert_allclose(one["ngp_fit_losses"], res[0]["ngp_fit_losses"],
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(one["ngp_fit_params"], res[0]["ngp_fit_params"], atol=2e-4)
    for k in ("ngp_fit_params", "ngp_fit_grid", "ngp_fit_losses"):
        assert np.array_equal(res[0][k], res[1][k]), k
    assert np.isfinite(res[0]["ngp_fit_val_psnr"])
    assert np.isnan(res[1]["ngp_fit_val_psnr"])  # rank 1 renders no validation
    rundir = os.path.join(spec["ngp_logdir"], "mesh-ngp")
    with open(os.path.join(rundir, "metrics.jsonl")) as f:
        mesh_lines = f.read().splitlines()
    with open(os.path.join(str(tmp_path), "mesh-ngp", "metrics.jsonl")) as f:
        one_lines = f.read().splitlines()
    assert len(mesh_lines) == len(one_lines) > 0


def test_frame_sharded_serving_equals_one_rank(ranks):
    """``make_fast_render_batch`` with each rank rendering two of four frames
    and gathering the rest: every map equal to one rank's, bit for bit, on
    both ranks."""
    res, _ = ranks
    one = w.serve({}, None, 0)
    assert set(one) == {k for k in res[0] if k.startswith("serve_")}
    for k, v in one.items():
        assert v.shape[0] == 4
        assert np.array_equal(res[0][k], v) and np.array_equal(res[1][k], v), k


def test_uneven_splits_are_refused():
    """A ray count that does not split over the ranks, a per-rank count off
    the fused objective's 128-ray blocks, and a frame batch that does not
    split all raise."""
    from nerf_kinematics_tpu_torch.train.loop import ClassicNerf
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    ds = w.scene()
    three = pm.Mesh(0, 3, torch.device("cpu"), "gloo")
    eng = ClassicNerf(w.config(w.CLASSIC_RAW), device="cpu", mesh=three)
    with pytest.raises(ValueError, match="split"):
        eng.make_train_step(ds.intrinsics, ds.near, ds.far, False)
    two = pm.Mesh(0, 2, torch.device("cpu"), "gloo")
    eng = NGPEngine(w.config(w.NGP_FUSED_RAW), 1.0, device="cpu", mesh=two)
    assert eng.fused_objective_fn(ds.near, ds.far, eng.cfg.nerf.train) is not None
    raw = dict(w.NGP_FUSED_RAW, nerf=dict(w.NGP_FUSED_RAW["nerf"], train=dict(
        w.NGP_FUSED_RAW["nerf"]["train"], num_random_rays=128)))
    eng = NGPEngine(w.config(raw), 1.0, device="cpu", mesh=two)
    with pytest.raises(ValueError, match="128"):
        eng.fused_objective_fn(ds.near, ds.far, eng.cfg.nerf.train)
    batch = eng.make_fast_render_batch(ds.intrinsics, ds.near, ds.far)
    with pytest.raises(ValueError, match="pad"):
        batch(torch.as_tensor(ds.poses[:3]), eng.init_aux())


_BUILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    cuda_lib._nvcc = lambda: {stub!r}
    print(cuda_lib.build_library(), cuda_lib.BUILD_INFO["cached"])
""")

_STUB = textwrap.dedent("""\
    #!{python}
    import os, sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    if "-c" in args:
        with open(os.environ["NKT_STUB_LOG"], "a") as f:
            f.write(f"{{os.getppid()}} {{os.path.basename(out)}}\\n")
        time.sleep(1.0)
    with open(out, "w") as f:
        f.write("stub")
""")


def test_library_build_takes_turns_across_processes(tmp_path):
    """Two processes build the CUDA library into one directory at once (a
    stub stands in for nvcc): exactly one compiles, the other waits on the
    directory's lock and finds its library; both return the same path."""
    stub = tmp_path / "nvcc"
    stub.write_text(_STUB.format(python=sys.executable))
    stub.chmod(0o755)
    log = tmp_path / "compiles.log"
    env = dict(os.environ, NKT_TORCH_BUILD_DIR=str(tmp_path / "build"),
               NKT_STUB_LOG=str(log))
    code = _BUILD.format(root=w.ROOT, stub=str(stub))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out.split())
    assert outs[0][0] == outs[1][0] and os.path.isfile(outs[0][0])
    assert sorted(o[1] for o in outs) == ["False", "True"]
    lines = log.read_text().splitlines()
    assert len({l.split()[0] for l in lines}) == 1  # one process compiled
    n_sources = len([n for n in os.listdir(os.path.join(
        w.ROOT, "nerf_kinematics_tpu_torch", "csrc")) if n.endswith(".cu")])
    assert len(lines) == n_sources
