"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``card`` that need a CUDA device (they skip without one, decided inside the
``card`` fixture).

    python -m pytest benchmark/tests -q             # here: the CPU tests
    python3 -m pytest benchmark/tests -q -m card    # on the GPU machine
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def scenes_dir(tmp_path_factory, monkeypatch):
    from benchmark.harness import scene

    d = tmp_path_factory.getbasetemp() / "scenes"
    monkeypatch.setattr(scene, "SCENES_DIR", str(d))
    return d
