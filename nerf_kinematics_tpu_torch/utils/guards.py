"""Numerical-health guards: ``assert_finite_tree``, a host-side audit of a
tree of tensors (tests, checkpoint boundaries), and ``checked_step``, which
runs a step under ``torch.autograd.detect_anomaly`` and raises on the first
non-finite value it produces. A debug tool: anomaly mode records a stack for
every autograd node and checks every backward output.

Counterpart of ``nerf_kinematics_tpu/utils/guards.py`` (``checkify`` there).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) of dicts, lists, tuples and dataclasses (a TrainState)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    else:
        yield path or "<root>", tree


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    if isinstance(leaf, np.ndarray):
        return not np.issubdtype(leaf.dtype, np.floating) or bool(np.isfinite(leaf).all())
    if isinstance(leaf, float):
        return bool(np.isfinite(leaf))
    return True


def assert_finite_tree(tree: Any, name: str = "tree") -> None:
    """Raise FloatingPointError naming every floating leaf (tensor, array
    or float) that holds a NaN or an inf."""
    bad = [path for path, leaf in _leaves(tree) if not _finite(leaf)]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def checked_step(step_fn: Callable) -> Callable:
    """Wrap a step: it runs under ``torch.autograd.detect_anomaly`` (a
    backward that produces a NaN raises there), and every floating output
    is checked; the first non-finite one raises FloatingPointError."""

    def wrapper(*args, **kwargs):
        with torch.autograd.detect_anomaly(check_nan=True):
            out = step_fn(*args, **kwargs)
        assert_finite_tree(out, getattr(step_fn, "__name__", "step") + " output")
        return out

    return wrapper
