"""The readers of the program's spans (``metrics/step_host_ms.train.py``,
``launch_host_ms_per_step.train.py``, ``chunk_read_ms.train.py``,
``frame_host_ms.serve.py``, ``launch_host_ms_per_frame.serve.py``): None
with no spans and with a program that has no span recorder, the right mean
or sum on a synthetic recorder's content, and their entries in
BENCHMARK.json under the manifest's rules."""

from types import SimpleNamespace

import pytest

from benchmark.harness import manifest, spans
from benchmark.tests import test_bench_manifest as rules
from nerf_kinematics_tpu_torch.utils import profiling

TRAIN = ["machina_ngp.train", "fox_ngp.train"]
SERVE = ["machina_ngp.serve_800"]
READERS = {
    "step_host_ms.train": TRAIN,
    "launch_host_ms_per_step.train": TRAIN,
    "chunk_read_ms.train": TRAIN,
    "frame_host_ms.serve": SERVE,
    "launch_host_ms_per_frame.serve": SERVE,
}
MS = 1_000_000


def _span(name, start_ms, end_ms, parent=-1):
    return profiling.Span(name, int(start_ms * MS), int(end_ms * MS), parent, -1)


# Two steps of a chunk, a refresh's launch and an open span; then a frame.
RECORDS = [
    _span("fit.chunk", 0, 40),                       # 0
    _span("fit.enqueue", 0, 20, 0),                  # 1
    _span("step", 1, 9, 1),                          # 2
    _span("launch.ngp_fused_sigma_cf", 2, 3, 2),     # 3
    _span("launch.scratch", 2.2, 2.4, 3),            # 4
    _span("launch.call", 2.5, 2.9, 3),               # 5
    _span("step", 10, 14, 1),                        # 6
    _span("launch.ngp_fused_train_cf", 11, 13.5, 6),  # 7
    _span("launch.call", 12, 13, 7),                 # 8
    _span("fit.read", 20, 26, 0),                    # 9
    _span("fit.refresh", 26, 30, 0),                 # 10
    _span("launch.ngp_fused_sigma_cf", 27, 27.5, 10),  # 11
    _span("step", 31, 0, 0),                         # 12: open
    _span("frame", 50, 62),                          # 13
    _span("frame.coarse", 51, 55, 13),               # 14
    _span("launch.ngp_fused_apply_cf", 52, 54, 14),  # 15
    _span("frame", 70, 80),                          # 16
    _span("fit.read", 80, 84),                       # 17
]


def _ctx(steps=0, frames=0):
    return SimpleNamespace(steps=steps, frames=frames)


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(RECORDS))


@pytest.fixture
def no_spans(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_spans(name, no_spans):
    assert manifest.metric_reader(name).read(_ctx(steps=512, frames=24)) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_for_a_program_without_the_recorder(name, monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert manifest.metric_reader(name).read(_ctx(steps=512, frames=24)) is None


@pytest.mark.parametrize("name,ctx,want", [
    ("step_host_ms.train", _ctx(steps=2), (8 + 4) / 2),
    # the wrappers' spans alone, not their children: 1 + 2.5 + 0.5 + 2
    ("launch_host_ms_per_step.train", _ctx(steps=2), 6.0 / 2),
    ("chunk_read_ms.train", _ctx(steps=2), (6 + 4) / 2),
    ("frame_host_ms.serve", _ctx(frames=2), (12 + 10) / 2),
    ("launch_host_ms_per_frame.serve", _ctx(frames=2), 6.0 / 2),
])
def test_readers_on_a_synthetic_recorder(name, ctx, want, synthetic):
    assert manifest.metric_reader(name).read(ctx) == pytest.approx(want)


def test_launch_ms_needs_units():
    rec = SimpleNamespace(spans=lambda: list(RECORDS))
    assert spans.launch_ms(0, rec) is None
    assert spans.mean_ms("nothing", rec) is None
    assert spans.mean_ms("step", rec) == pytest.approx(6.0)


def test_entries_follow_the_manifest_rules():
    per = {e["name"]: e for e in manifest.manifest()["per_layer"]}
    layers = {e["layer"] for n, e in per.items() if n not in READERS}
    for name, cells in READERS.items():
        e = per[name]
        assert (e["unit"], e["better"], e["source"]) == ("ms", "lower", "program_span")
        assert e["workloads"] == cells and e["layer"] in layers
        assert e["moves"] == ("train_rays_per_s" if cells == TRAIN else "frames_per_s")
    names = list(per)
    assert names[-len(READERS):] == list(READERS)   # appended at the end
    rules.test_top_level_keys_and_command()
    rules.test_entries_have_their_keys_and_names(
        "per_layer", {"name", "unit", "better", "source", "layer", "moves"})
    rules.test_metrics_sources_bounds_and_units()
    rules.test_every_cell_has_its_files_and_metrics()
