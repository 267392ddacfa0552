"""A run with the timed path broken underneath must read ``correct`` false.

Each fault that a cell can have is planted in the program (``cells.planted``)
and the rest of a run is driven as ``run.py`` drives it, at a tiny size on
the CPU (the look for a GPU is skipped), under the cell's own limits:

  * training: a step that leaves its state unchanged; half of the batch
    left out, the mean taken over the rest;
  * serving: an answer altered where it is produced (the frame of the
    previous request); half of the frame left out.

The exchange between chips does not exist in these one-chip cells."""

import pytest

from . import _tiny

FAULTS = [("machina_ngp.train", "unchanged"), ("machina_ngp.train", "half"),
          ("fox_ngp.train", "unchanged"), ("fox_ngp.train", "half"),
          ("machina_ngp.serve_800", "altered"), ("machina_ngp.serve_800", "half_frame")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_reads_not_correct(cell, fault, scenes_dir):
    run = _tiny.run(cell, fault=fault, seconds=0.3)
    assert run.checks
    assert not run.correct, run.checks


def test_faults_are_removed_after_the_run(scenes_dir):
    from nerf_kinematics_tpu_torch.train import loop, ngp_engine

    before = (loop.adam_update, loop.build_objective, ngp_engine.render_image_fast)
    _tiny.run("machina_ngp.train", fault="unchanged")
    assert (loop.adam_update, loop.build_objective, ngp_engine.render_image_fast) == before
