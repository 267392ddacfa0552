"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as files of their own (and entries in BENCHMARK.json), and
the harness finds each by name, without an edit to a file already there."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

from benchmark.harness import manifest


def _digests(root):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x not in ("cache", "__pycache__")]
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_config_traffic_and_metric_added_as_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(os.path.join(manifest.REPO_DIR, "BENCHMARK.json"), root)
    before = _digests(root / "benchmark")
    bench = root / "benchmark"

    cfg = json.loads((bench / "configs" / "machina_ngp.json").read_text())
    cfg.update(name="machina_ngp_wide")
    cfg["yaml"]["nerf"]["train"]["num_random_rays"] = 4096
    (bench / "configs" / "machina_ngp_wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "train_chunks.json").read_text())
    traffic["checked_steps"] = 2
    (bench / "traffic" / "train_two.json").write_text(json.dumps(traffic))
    (bench / "workloads" / "machina_ngp_wide.train.json").write_text(json.dumps(
        {"config": "machina_ngp_wide", "traffic": "train_two", "chips": 1,
         "limits": {"loss_gap": 1, "grad_gap": 1, "change_gap": 1}}))
    (bench / "metrics" / "steps_traced.train.py").write_text(textwrap.dedent('''
        """Steps in the traced window."""


        def read(ctx):
            return ctx.steps or None
    '''))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="machina_ngp_wide",
                             file="benchmark/configs/machina_ngp_wide.json"))
    b["workloads"].append({"name": "machina_ngp_wide.train", "config": "machina_ngp_wide",
                           "traffic": "train_two", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append("machina_ngp_wide.train")
    b["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "whole step or frame",
                           "moves": "train_rays_per_s",
                           "workloads": ["machina_ngp_wide.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    code = textwrap.dedent(f'''
        import sys
        sys.path[:0] = [{str(root)!r}, {manifest.REPO_DIR!r}]
        from benchmark.harness import manifest
        assert manifest.BENCH_DIR == {str(bench)!r}
        wl = manifest.workload("machina_ngp_wide.train")
        assert manifest.config(wl["config"])["yaml"]["nerf"]["train"]["num_random_rays"] == 4096
        assert manifest.traffic(wl["traffic"])["checked_steps"] == 2
        names = [n for n, _ in manifest.cell_metrics("machina_ngp_wide.train", True)]
        assert names == ["steps_traced.train"], names
        e2e = [n for n, _ in manifest.cell_metrics("machina_ngp_wide.train", False)]
        assert e2e == ["train_rays_per_s", "setup_s"], e2e

        class Ctx:
            steps = 7
        assert manifest.metric_reader("steps_traced.train").read(Ctx()) == 7
        print("found")
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "found" in out.stdout, out.stderr
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
