"""The port's spans (``utils/profiling.py``) on the CPU: nothing recorded or
allocated outside a profile; under one, ``Trainer.fit``'s chunks, steps and
objectives and the fast renderer's frames nest as documented, each child
inside its parent, with the steps' and frames' numbers as request ids; the
kernel wrappers' launch helper; the Chrome trace on the profiler's clock;
``idle_by_span`` on synthetic traces."""

import json
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nerf_kinematics_tpu_torch.data.machina import machina_intrinsics, orbit_poses
from nerf_kinematics_tpu_torch.data.types import dataset_from_arrays
from nerf_kinematics_tpu_torch.ops import cuda_lib
from nerf_kinematics_tpu_torch.rendering.fast_render import FastRenderSettings
from nerf_kinematics_tpu_torch.train import config as tcfg
from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine
from nerf_kinematics_tpu_torch.train.trainer import Trainer
from nerf_kinematics_tpu_torch.utils import profiling

SIZE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: several intra-op threads per test worker only
    fight over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def _raw(logdir, fused="on", fused_train="auto"):
    return {
        "engine": "ngp",
        "ngp": {
            "encoder": "cp_pallas", "n_levels": 3, "n_components": 16,
            "table_size": 48, "base_resolution": 8, "max_resolution": 32,
            "density_width": 32, "density_out": 16, "color_width": 32,
            "color_layers": 3, "use_occupancy": True, "occ_resolution": 16,
            "occ_bins": 8, "fused": fused, "fused_train": fused_train,
            "occ_update_every": 4, "occ_full_every": 32,
            "occ_incremental_cells": 512,
        },
        "dataset": {"near": 2.0, "far": 6.0},
        "experiment": {"logdir": str(logdir), "id": "tiny", "print_every": 4,
                       "validate_every": 0, "save_every": 0, "train_iters": 8,
                       "randomseed": 3},
        "nerf": {
            "train": {"num_coarse": 8, "num_fine": 8, "white_background": True,
                      "num_random_rays": 128, "pixel_sampler": "shuffled"},
            "validation": {"num_coarse": 8, "num_fine": 8, "perturb": False,
                           "white_background": True},
            "coarse_loss_weight": 0.0,
        },
        "optimizer": {"lr": 0.01},
        "scheduler": {"lr_decay": 6, "lr_decay_factor": 0.33},
    }


def _dataset(n_views=5):
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.6, (n_views, 1, 1, 3))
    ramp = 0.3 * np.linspace(0, 1, SIZE)[None, None, :, None]
    images = np.broadcast_to(base + ramp, (n_views, SIZE, SIZE, 3)).astype(np.float32)
    return dataset_from_arrays(images, orbit_poses(n_views), machina_intrinsics(SIZE),
                               2.0, 6.0, n_val=1)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _closed(name):
    return [s for s in profiling.spans() if s.name == name and s.end_ns]


def _children(recs, i):
    return [r for r in recs if r.parent == i]


def _inside(recs):
    """Every closed span lies inside its parent."""
    for r in recs:
        assert r.end_ns >= r.start_ns > 0, r
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, (r, p)


# ---------------------------------------------------------------- off

def test_off_spans_record_and_allocate_nothing():
    from nerf_kinematics_tpu_torch.utils import profiling as mod

    for _ in range(100):   # warm every code path first
        profiling.end(profiling.begin("launch.call", 7))
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(10000):
            sp = profiling.begin("launch.call", 7)
            profiling.end(sp)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [s for s in after.compare_to(before, "filename")
             if s.traceback[0].filename == mod.__file__ and s.count_diff > 0]
    assert grown == []
    assert sp == -1 and profiling.spans() == []


def test_spans_record_only_inside_a_profile():
    profiling.end(profiling.begin("before"))
    with _cpu_profile():
        a = profiling.begin("a", 5)
        b = profiling.begin("a.child")
        profiling.end(b)
        profiling.end(a)
    profiling.end(profiling.begin("after"))
    recs = profiling.spans()
    assert [(r.name, r.parent, r.rid) for r in recs] == [("a", -1, 5), ("a.child", 0, 5)]
    _inside(recs)


def test_open_spans_clear_and_a_full_buffer(monkeypatch):
    with _cpu_profile():
        outer = profiling.begin("outer")
        profiling.begin("left_open")          # an exception skipped its end
        profiling.end(outer)
        assert _closed("outer") and not _closed("left_open")
        assert profiling.spans()[1].end_ns == 0
        stale = profiling.begin("stale")
        profiling.clear()
        profiling.end(stale)                  # a token from before clear(): ignored
        assert profiling.spans() == []
        monkeypatch.setattr(profiling, "CAPACITY", 2)
        for _ in range(5):
            profiling.end(profiling.begin("x"))
    assert len(_closed("x")) == 2 and profiling.dropped() == 3


# ---------------------------------------------------------------- Trainer.fit

STEP_CHILDREN = ["step.batch", "step.draws", "step.objective", "step.update"]
OBJECTIVE_CHILDREN = {
    "auto": ["obj.proposal", "obj.coarse", "obj.fine_inputs", "obj.fine"],
    "full": ["obj.proposal", "obj.fine_inputs", "obj.fine"],
    "off": ["obj.forward", "obj.backward"],
}


@pytest.mark.parametrize("route", ["auto", "full", "off"])
def test_fit_records_chunks_steps_and_objectives(route, tmp_path):
    cfg = tcfg.config_from_dict(_raw(tmp_path, fused_train=route))
    tr = Trainer(cfg, dataset=_dataset(), device="cpu")
    state = tr.engine.init_state()
    with _cpu_profile():
        res = tr.fit(max_iters=8, state=state)
    recs = profiling.spans()
    _inside(recs)
    chunks = [i for i, r in enumerate(recs) if r.name == "fit.chunk"]
    assert [recs[i].rid for i in chunks] == [1, 5]
    steps = []
    for c in chunks:
        kids = [r.name for r in _children(recs, c)]
        # a refresh after each chunk of occ_update_every steps, a print too
        assert kids == ["fit.enqueue", "fit.read", "fit.refresh", "fit.events"]
        enqueue = recs.index(next(r for r in _children(recs, c) if r.name == "fit.enqueue"))
        steps += [i for i, r in enumerate(recs) if r.parent == enqueue]
    assert [recs[i].name for i in steps] == ["step"] * 8
    assert [recs[i].rid for i in steps] == list(range(1, 9))
    for i in steps:
        kids = _children(recs, i)
        assert [r.name for r in kids] == STEP_CHILDREN
        assert all(r.rid == recs[i].rid for r in kids)
        objective = recs.index(kids[2])
        assert [r.name for r in _children(recs, objective)] == OBJECTIVE_CHILDREN[route]
    # the result's clock reads are the spans'
    reads = _closed("fit.read")
    enq = _closed("fit.enqueue")
    assert [s for _, s in res.chunk_seconds] == [
        (r.end_ns - e.start_ns) * 1e-9 for e, r in zip(enq, reads)]
    assert [s for _, _, s in res.occupancy_refreshes] == [
        (r.end_ns - r.start_ns) * 1e-9 for r in _closed("fit.refresh")]


def test_fit_records_nothing_untraced(tmp_path):
    cfg = tcfg.config_from_dict(_raw(tmp_path))
    tr = Trainer(cfg, dataset=_dataset(), device="cpu")
    res = tr.fit(max_iters=4, state=tr.engine.init_state())
    assert profiling.spans() == []
    assert len(res.chunk_seconds) == 1 and len(res.occupancy_refreshes) == 1


# ---------------------------------------------------------------- frames

@pytest.mark.parametrize("fg", [1.0, 0.5], ids=["every_block", "top_blocks"])
def test_fast_render_records_frames_and_stages(fg, tmp_path):
    cfg = tcfg.config_from_dict(_raw(tmp_path))
    eng = NGPEngine(cfg, scene_bound=1.0, device="cpu")
    eng.init_state()
    render = eng.make_fast_render_fn(
        machina_intrinsics(SIZE), 2.0, 6.0,
        settings=FastRenderSettings(num_coarse=8, num_fine=8, fg_fraction=fg))
    poses = orbit_poses(3)
    render(poses[0], eng.init_aux())          # call 0, untraced
    with _cpu_profile():
        for p in poses[1:]:
            render(p, eng.init_aux())
    recs = profiling.spans()
    _inside(recs)
    frames = [i for i, r in enumerate(recs) if r.name == "frame"]
    assert [recs[i].rid for i in frames] == [1, 2]
    stages = ["frame.rays", "frame.rays", "frame.proposal", "frame.coarse", "frame.pdf"]
    stages += (["frame.select"] if fg < 1 else []) + ["frame.fine", "frame.paste"]
    for i in frames:
        kids = _children(recs, i)
        assert [r.name for r in kids] == stages
        assert all(r.rid == recs[i].rid for r in kids)


# ---------------------------------------------------------------- launches

def test_launch_helper_counts_and_closes_the_wrapper_span():
    before = dict(cuda_lib.LAUNCHES)
    pts = cuda_lib.POINTS.copy()
    try:
        with _cpu_profile():
            sp = profiling.begin(cuda_lib.LAUNCH_SPAN["ngp_fused_train_cf"])
            call = profiling.begin("launch.call")
            profiling.end(call)
            cuda_lib.launched(sp, "ngp_fused_train_cf", "bf16", 384, in_fused=384)
            sp = profiling.begin("launch.cp_encode")
            cuda_lib.launched(sp, "cp_encode", "f32", 10)
        assert cuda_lib.LAUNCHES["ngp_fused_train_cf"] == before["ngp_fused_train_cf"] + 1
        assert cuda_lib.LAUNCHES["cp_encode"] == before["cp_encode"] + 1
        assert cuda_lib.POINTS["ngp_fused_train_cf", "bf16"] == pts["ngp_fused_train_cf",
                                                                    "bf16"] + 384
        assert cuda_lib.POINTS["cp_encode_bwd_in_fused", "bf16"] == pts[
            "cp_encode_bwd_in_fused", "bf16"] + 384
        assert cuda_lib.POINTS["cp_encode", "f32"] == pts["cp_encode", "f32"] + 10
        assert ("cp_encode_bwd_in_fused", "f32") not in cuda_lib.POINTS or cuda_lib.POINTS[
            "cp_encode_bwd_in_fused", "f32"] == pts["cp_encode_bwd_in_fused", "f32"]
        recs = profiling.spans()
        assert [(r.name, r.parent) for r in recs] == [
            ("launch.ngp_fused_train_cf", -1), ("launch.call", 0), ("launch.cp_encode", -1)]
        assert all(r.end_ns for r in recs)
        assert set(cuda_lib.LAUNCH_SPAN) == set(cuda_lib.LAUNCHES)
    finally:
        cuda_lib.LAUNCHES.update(before)
        cuda_lib.POINTS.clear()
        cuda_lib.POINTS.update(pts)


# ---------------------------------------------------------------- the trace

def test_device_trace_writes_spans_on_the_profilers_clock(tmp_path):
    a = torch.ones(128, 128)
    with profiling.device_trace(str(tmp_path / "t")):
        sp = profiling.begin("around.mm", 3)
        (a @ a).sum()
        profiling.end(sp)
    with open(tmp_path / "t" / "trace.json") as f:
        trace = json.load(f)
    ev = trace["traceEvents"]
    span = next(e for e in ev if e.get("cat") == "program_span" and e["name"] == "around.mm")
    mm = next(e for e in ev if e.get("name") == "aten::mm" and e.get("ph") == "X")
    assert span["args"]["rid"] == 3
    assert span["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= span["ts"] + span["dur"]
    assert any(e.get("ph") == "M" and e["args"].get("name") == "program spans" for e in ev)


def test_device_trace_clears_the_recorder(tmp_path):
    with _cpu_profile():
        profiling.end(profiling.begin("earlier"))
    with profiling.device_trace(str(tmp_path / "t")):
        profiling.end(profiling.begin("inside"))
    assert [r.name for r in profiling.spans()] == ["inside"]


RECS = [("step", 100, 200), ("step.objective", 120, 180), ("launch.x", 130, 150),
        ("launch.call", 140, 150), ("step", 200, 300)]


@pytest.mark.parametrize("device,window,want", [
    # idle 100-130 (step 100-120, objective 120-130), 150-200 (objective
    # 150-180, step 180-200), 250-320 (step 250-300, none 300-320)
    ([(90, 100), (130, 150), (200, 250)], (90, 320),
     {"step": 90, "step.objective": 40, profiling.NO_SPAN: 20}),
    # busy all through: no idle
    ([(0, 400)], (90, 320), {}),
    # idle inside the innermost span alone, overlapping device intervals
    ([(0, 141), (135, 145), (146, 400)], (90, 320), {"launch.call": 1}),
    # a device idle the whole window
    ([], (140, 160), {"launch.call": 10, "step.objective": 10}),
], ids=["nested", "busy", "innermost", "idle"])
def test_idle_by_span_on_synthetic_traces(device, window, want):
    got = profiling.idle_by_span(device, window, RECS)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-9)


def test_idle_by_span_reads_the_last_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "t")):
        profiling.end(profiling.begin("host_only"))
    got = profiling.idle_by_span()
    assert got and all(v >= 0 for v in got.values())
    assert set(got) <= {"host_only", profiling.NO_SPAN}


# ---------------------------------------------------------------- the breakdown script

def _breakdown_script():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "torch_span_breakdown.py"
    spec = importlib.util.spec_from_file_location("torch_span_breakdown", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_breakdown_script_matches_kernels_to_their_calls_in_order():
    S = profiling.Span
    recs = [S("launch.call", 1000, 2000, -1, -1), S("launch.call", 3000, 4000, -1, -1)]
    # two launches in the first call, one in the second, one outside any call
    launches = [500, 1100, 1500, 3200]
    ops = [("nkt_a", 2500, 2600), ("at::native::x", 1200, 1300),
           ("nkt_b", 2700, 2800), ("nkt_c", 2900, 3000)]
    got = _breakdown_script().clock_check(ops, launches, recs)
    # nkt_c starts 100 ns before the call that launched it (3000 ns)
    assert (got["kernels"], got["launched"], got["before_2us"]) == (3, 3, 0)
    assert got["least_us"] == pytest.approx(-0.1)
    # and 300 ns before its own launch record (3200 ns): the clocks apart
    assert got["device_after_launch_least_us_by_s"] == [pytest.approx(-0.3)]


def test_breakdown_script_host_self_cover_and_idle():
    S = profiling.Span
    recs = [S("step", 0, 100, -1, 1), S("step.batch", 0, 30, 0, 1),
            S("step.objective", 30, 90, 0, 1), S("step", 100, 200, -1, 2),
            S("step.objective", 100, 200, 3, 2), S("open", 150, 0, 3, 2)]
    idle = {"step.objective": 2e-6, profiling.NO_SPAN: 2e-6}
    got = _breakdown_script().breakdown(recs, 2, idle)
    assert got["host_ms"]["step"] == pytest.approx(100e-6)
    assert got["self_ms"]["step"] == pytest.approx(5e-6)
    assert got["cover"]["step"] == pytest.approx(0.95)
    assert got["idle_ms"]["step.objective"] == pytest.approx(1e-3)
    assert got["idle_in_spans"] == pytest.approx(0.5)
