"""BENCHMARK.json against the benchmark's contract, and each file it names
against the program's own reading of the same configuration."""

import json
import os
import re

import pytest

from benchmark.harness import manifest
from benchmark.reference import fixture
from benchmark.reference import ngp as ref

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
B = manifest.manifest()


def test_top_level_keys_and_command():
    assert set(B) == TOP
    assert B["paths"] == ["benchmark"]
    assert B["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    # a full check of 24 cells fits its 43200 seconds
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(B)) <= 64 * 1024


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_their_keys_and_names(group, keys):
    names = [e["name"] for e in B[group]]
    assert len(names) == len(set(names))
    for e in B[group]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_metrics_sources_bounds_and_units():
    e2e = {e["name"]: e for e in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in B["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in B["per_layer"]:
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert e["moves"] in e2e
        if "roofline" in e["name"] or "mfu" in e["name"]:
            assert e["unit"] == "%"
    layers = {}
    for e in B["per_layer"]:
        layers.setdefault(e["layer"], []).append(e["name"])
    assert all(len(v) >= 1 for v in layers.values())


def test_every_cell_has_its_files_and_metrics():
    cells = {w["name"]: w for w in B["workloads"]}
    configs = {c["name"] for c in B["configs"]}
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(1, len(cells) // 4)
    for name, w in cells.items():
        wl = manifest.workload(name)
        assert (wl["config"], wl["traffic"], wl["chips"]) == (w["config"], w["traffic"],
                                                              w["chips"])
        assert w["config"] in configs
        manifest.traffic(w["traffic"])
        e2e = [n for n, _ in manifest.cell_metrics(name, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.cell_metrics(name, True)
    for e in B["per_layer"]:
        manifest.metric_reader(e["name"])
        moves = next(m for m in B["end_to_end"] if m["name"] == e["moves"])
        for c in e.get("workloads", cells):
            assert c in cells
            assert c in moves.get("workloads", cells), (e["name"], c)
            assert "workloads" not in moves or c in moves["workloads"]


@pytest.mark.parametrize("entry", B["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    path = os.path.join(manifest.REPO_DIR, entry["file"])
    assert entry["file"].startswith("benchmark/")
    with open(path) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    spec = ref.model_spec(cfg["sizes"])
    for rel in cfg["start"].values():
        leaves, _, _ = fixture.read_start(os.path.join(manifest.REPO_DIR, rel), spec)
        assert {k: v.shape for k, v in leaves.items()} == dict(fixture.leaf_shapes(spec)), rel


@pytest.mark.parametrize("name", [c["name"] for c in B["configs"]])
def test_sizes_are_what_the_program_reads(name):
    """The reference reads ``sizes``; the program reads ``yaml``. They
    state one model."""
    from nerf_kinematics_tpu_torch.train.config import config_from_dict

    cfg = manifest.config(name)
    n = config_from_dict(cfg["yaml"]).ngp
    s = cfg["sizes"]
    assert (n.cp.n_levels, n.cp.n_components, n.cp.base_resolution, n.cp.max_resolution,
            n.cp.table_size, n.cp.fold) == tuple(s["cp"][k] for k in (
                "n_levels", "n_components", "base_resolution", "max_resolution",
                "table_size", "fold"))
    for k in ("density_width", "density_layers", "density_out", "color_width",
              "color_layers", "sh_degree", "compute_dtype", "occ_resolution", "occ_bins",
              "occ_floor", "occ_incremental_cells", "occ_full_every", "occ_update_every"):
        assert getattr(n, k) == s[k], k
    from nerf_kinematics_tpu_torch.train.loop import NGP_ADAM

    assert (NGP_ADAM.b1, NGP_ADAM.b2, NGP_ADAM.eps, NGP_ADAM.weight_decay) == tuple(
        s["adam"][k] for k in ("b1", "b2", "eps", "weight_decay"))
    assert n.cp.use_bf16 and n.compute_dtype == "bfloat16"
