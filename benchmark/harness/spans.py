"""What the readers of the program's own spans share
(``metrics/step_host_ms.train.py`` and the others whose source is
``program_span``): the port's span recorder,
``nerf_kinematics_tpu_torch/utils/profiling.py``, which records only while a
``torch.profiler`` profile runs and so holds exactly the traced window's
spans. A program without the recorder (or with no span of the name) gives
None."""

from __future__ import annotations

LAUNCH = "launch."   # a kernel wrapper's span: launch.<LAUNCHES key>


def closed(recorder=None) -> list:
    """(span, its parent's name or "") of each closed span of the recorder
    (an object whose ``spans()`` lists records with ``name``, ``start_ns``,
    ``end_ns`` (0 while open) and ``parent``, an index into that list; the
    port's by default)."""
    if recorder is None:
        try:
            from nerf_kinematics_tpu_torch.utils import profiling as recorder
        except ImportError:
            return []
    read = getattr(recorder, "spans", None)
    if read is None:
        return []
    every = read()
    return [(s, every[s.parent].name if s.parent >= 0 else "") for s in every if s.end_ns]


def mean_ms(name: str, recorder=None):
    """Mean milliseconds of the closed spans named ``name``."""
    d = [s.end_ns - s.start_ns for s, _ in closed(recorder) if s.name == name]
    return 1e-6 * sum(d) / len(d) if d else None


def launch_ms(per: int, recorder=None):
    """Milliseconds of the kernel wrappers' spans (``launch.<name>``, not
    their children ``launch.operands`` and the others) over ``per`` steps or
    frames."""
    d = [s.end_ns - s.start_ns for s, parent in closed(recorder)
         if s.name.startswith(LAUNCH) and not parent.startswith(LAUNCH)]
    return 1e-6 * sum(d) / per if d and per else None
