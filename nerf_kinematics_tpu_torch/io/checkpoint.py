"""Checkpoints of a training state, with auto-resume.

One ``torch.save`` file per saved iteration, ``ckpt_{iteration:08d}.pt``:
the flat parameter buffer with the layout's names and shapes, Adam's moments
and count, the step, the generator's state, the occupancy grid and the EMA
shadow, plus the metrics handed to :meth:`CheckpointManager.save`.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from ..ops.occupancy import OccupancyGrid
from ..train.loop import TrainState

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Checkpoints under ``directory``; ``create=False`` (a rank that only
    reads them) leaves the directory to the writer."""

    def __init__(self, directory: str, create: bool = True):
        self.directory = directory
        if create:
            os.makedirs(directory, exist_ok=True)

    def steps(self):
        if not os.path.isdir(self.directory):
            return []
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, it: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(it):08d}.pt")

    def save(self, it: int, state: TrainState, metrics: Optional[dict] = None,
             layout=None) -> str:
        """Write the state of iteration ``it`` (reads the device: one
        synchronisation). ``layout``: the engine's ``ParamLayout``, stored so
        a restore can refuse another model's file."""
        cpu = lambda t: None if t is None else t.detach().cpu()
        payload = {
            "iteration": int(it),
            "step": cpu(state.step),
            "params": cpu(state.params),
            "mu": cpu(state.opt_state.mu),
            "nu": cpu(state.opt_state.nu),
            "count": cpu(state.opt_state.count),
            "generator": state.generator.get_state(),
            "aux": None if state.aux is None else {
                "density": cpu(state.aux.density), "bound": cpu(state.aux.bound)},
            "ema": cpu(state.ema),
            "layout": None if layout is None else [
                (name, list(shape)) for name, shape, _, _ in layout.entries],
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }
        path = self._path(it)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        return path

    def restore(self, state: TrainState, it: Optional[int] = None, layout=None):
        """Load iteration ``it`` (default: the latest) into ``state`` in
        place, so the model's views of ``state.params`` stay valid. Returns
        ``(state, step)``, or ``(None, None)`` when there is no checkpoint."""
        it = self.latest_step() if it is None else it
        if it is None:
            return None, None
        payload = torch.load(self._path(it), map_location="cpu",
                             weights_only=True)
        if layout is not None and payload["layout"] is not None:
            want = [(name, list(shape)) for name, shape, _, _ in layout.entries]
            if [tuple(e) for e in payload["layout"]] != [tuple(e) for e in want]:
                raise ValueError("the checkpoint holds another model's parameters")
        if payload["params"].shape != state.params.shape:
            raise ValueError(
                f"checkpoint has {payload['params'].numel()} parameters, the "
                f"state {state.params.numel()}")
        with torch.no_grad():
            state.params.copy_(payload["params"])
            state.opt_state.mu.copy_(payload["mu"])
            state.opt_state.nu.copy_(payload["nu"])
            state.opt_state.count.copy_(payload["count"])
            state.step.copy_(payload["step"])
        state.generator.set_state(payload["generator"])
        dev = state.params.device
        aux = payload["aux"]
        state.aux = None if aux is None else OccupancyGrid(
            aux["density"].to(dev), aux["bound"].to(dev))
        if payload["ema"] is None:
            # a run that now keeps a shadow starts it from the live weights
            state.ema = None if state.ema is None else state.params.clone()
        else:
            state.ema = payload["ema"].to(dev)
        return state, int(payload["iteration"])

    def close(self) -> None:
        pass
