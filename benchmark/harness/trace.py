"""The device trace of a traced window and what the readers take from it.

``torch.profiler`` records the device's activity alone (no host operator
events, so the host runs as it does untraced). Each device operation is kept
as (name, start, end) in seconds; kernels are told from copies and fills by
name.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field
from typing import List, Tuple

_TEMPLATE = re.compile(r"<[^<>]*>")
# The program's own CUDA kernels (csrc/) carry these prefixes.
PORT_PREFIXES = ("nkt_", "nkc_", "nkf_")


def base_name(name: str) -> str:
    """A kernel's name without its return type, namespace-less template
    arguments and parameters: ``void at::native::f<4, g>(int)`` ->
    ``at::native::f``; a copy or fill by its kind (``Memcpy DtoH``)."""
    if not is_kernel(name):
        return name.split(" (")[0]
    s = name.replace("(anonymous namespace)", "anon")
    while True:
        t = _TEMPLATE.sub("", s)
        if t == s:
            break
        s = t
    s = s.split("(")[0].strip()
    return s.split()[-1] if s else name


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def is_port_kernel(name: str) -> bool:
    return base_name(name).startswith(PORT_PREFIXES)


@dataclass
class Trace:
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    window_s: float = 0.0

    @property
    def kernels(self):
        return [o for o in self.ops if is_kernel(o[0])]

    def busy_intervals(self):
        out = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def seconds_of(self, names) -> float:
        """Device seconds of the kernels whose base name is in ``names``."""
        names = set(names)
        return sum(e - s for n, s, e in self.kernels if base_name(n) in names)

    def top_ops(self, k: int = 10):
        by = {}
        for n, s, e in self.ops:
            b = base_name(n)
            by[b] = by.get(b, 0.0) + (e - s)
        return sorted(([n, v] for n, v in by.items()), key=lambda t: -t[1])[:k]

    def idle_gaps(self, k: int = 10):
        """Idle time between device operations, by the operation that ended
        it (what the host had to enqueue before the device went on)."""
        ops = sorted(self.ops, key=lambda o: o[1])
        by, end = {}, None
        for n, s, e in ops:
            if end is not None and s > end:
                key = "before " + base_name(n)
                by[key] = by.get(key, 0.0) + (s - end)
            end = e if end is None else max(end, e)
        return sorted(([n, v] for n, v in by.items()), key=lambda t: -t[1])[:k]


@contextlib.contextmanager
def device_trace(out: Trace, enabled: bool = True):
    """Record the device's operations inside the block into ``out.ops``."""
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield out
    for e in prof.events():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        tr = e.time_range
        out.ops.append((e.name, tr.start * 1e-6, tr.end * 1e-6))


@dataclass
class ReadContext:
    """What a per-layer metric's reader reads: the traced window's device
    operations, its length, the work done in it, and the benchmark's own
    spans and the program's own records of the window."""

    kind: str
    trace: Trace
    steps: int = 0
    frames: int = 0
    work: dict = field(default_factory=dict)     # {"field": {...}, "model": {...}}
    refresh_s: list = field(default_factory=list)
    call_s: list = field(default_factory=list)
