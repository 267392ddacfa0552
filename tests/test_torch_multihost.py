"""Two OS processes over ``gloo`` on the CPU against one (the port's
``parallel/multihost.py``); mirrors tests/test_multihost.py. Each process
loads only its slice of the training images and assembles the global batch
(``make_global_batch``), then trains the fused NGP config two steps; the
loss must be one process's. Checkpoints cross topologies: a 2-process save
restored in one process, and a 1-process save restored in two, take the
same next step as the 1-process round trip (loss rtol 1e-5, the reference
test's bound). One 2-rank launch serves both tests (120 s at most).
"""

import os

import numpy as np
import pytest
import torch

import _torch_mesh_worker as w


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """The 1-process baseline (a save at step 2 in ``one/``, its restore and
    one step), then the 2-rank launch: host-local training with a save at
    step 2 in ``two/``, and the restore of ``one/``'s checkpoint and one
    step."""
    root = tmp_path_factory.mktemp("multihost")
    one_dir, two_dir = str(root / "one"), str(root / "two")
    base = w.host_local({"save_dir": one_dir, "restore_dir": one_dir}, None, 0)
    ranks = w.launch({"scenarios": ["host_local"], "save_dir": two_dir,
                      "restore_dir": one_dir}, str(root / "ranks"), world=2, timeout=120)
    return base, ranks, two_dir


def test_two_process_training_matches_single_process(legs):
    base, ranks, _ = legs
    losses = [float(r["host_local_loss2"]) for r in ranks]
    assert losses[0] == losses[1]  # every process sees the same averaged loss
    assert losses[0] == pytest.approx(float(base["host_local_loss2"]), rel=1e-5)


def test_checkpoint_round_trip_across_topologies(legs):
    """Baseline 1-process save -> 1-process restore + step; cross A: 2-process
    save -> 1-process restore + step; cross B: 1-process save -> 2-process
    restore + step. Only rank 0 wrote the 2-process checkpoint."""
    base, ranks, two_dir = legs
    baseline = float(base["restored_step_loss"])
    ckpts = sorted(os.listdir(os.path.join(two_dir, "host-local", "checkpoints")))
    assert ckpts == ["ckpt_00000002.pt"]
    cross_a = w.restore_and_step(two_dir, w.scene(), None)
    assert cross_a == pytest.approx(baseline, rel=1e-5)
    cross_b = [float(r["restored_step_loss"]) for r in ranks]
    assert cross_b[0] == cross_b[1]
    assert cross_b[0] == pytest.approx(baseline, rel=1e-5)
    assert np.isfinite(baseline)
