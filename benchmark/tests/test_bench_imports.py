"""No module the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program either (whole top-level names)."""

import ast
import os

import pytest

from benchmark.harness import manifest

NEVER = {"jax", "jaxlib", "flax", "nerf_kinematics_tpu"}
PROGRAM = "nerf_kinematics_tpu_torch"


def _modules():
    for root, dirs, files in os.walk(manifest.BENCH_DIR):
        dirs[:] = [d for d in dirs if d not in ("cache", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


MODULES = sorted(_modules())


def test_every_module_is_scanned():
    names = {os.path.relpath(p, manifest.BENCH_DIR) for p in MODULES}
    assert {"run.py", "calibrate.py", "harness/cells.py", "reference/ngp.py"} <= names
    assert any(n.startswith("metrics/") for n in names)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: os.path.relpath(p, manifest.BENCH_DIR))
def test_no_jax(path):
    assert not set(_imports(path)) & NEVER


@pytest.mark.parametrize("path", [p for p in MODULES if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(_imports(path))
    assert set(_imports(path)) <= {"__future__", "math", "typing", "numpy", "torch"}


def test_the_name_check_compares_whole_names(monkeypatch):
    import sys

    from benchmark import run

    monkeypatch.setitem(sys.modules, "nerf_kinematics_tpu_torch_x", object())
    assert "nerf_kinematics_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nerf_kinematics_tpu.ops", object())
    assert run.forbidden_modules() == ["nerf_kinematics_tpu"]
