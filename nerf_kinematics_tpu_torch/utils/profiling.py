"""The program's spans and the operator's trace.

Spans. ``begin(name, rid)`` opens a span and returns its token, ``end(token)``
closes it; a span opened while another is open is its child. Each record
holds its name, its start and end (``time.time_ns()``, the clock that
``torch.profiler`` stamps its events with), its parent and a request id (a
step's number, a frame's number, a chunk's first step; a child without one
takes its parent's, -1 for none). Spans record only while a
``torch.profiler`` profile runs: outside one, ``begin`` reads one flag and
returns -1, and ``end(-1)`` returns at once, so nothing is allocated.
The records live in one bounded buffer (``CAPACITY`` spans); those beyond
it are dropped and counted (:func:`dropped`). The program's spans nest in
one stack: the train step, the renderer and the kernels' wrappers run on
the thread that calls them, or on autograd's device thread while the
caller waits in ``backward``.

Call sites keep the pattern

    sp = profiling.begin("frame.coarse")
    ...
    profiling.end(sp)

(no ``with`` block: a context manager would be made on every call, traced
or not). A span left open by an exception stays open (its end 0) and is
skipped by :func:`spans`' readers; the next ``end`` of an enclosing span
takes it off the stack.

``device_trace(logdir)`` is the operator's trace: a ``torch.profiler``
profile of the block (the device's kernels and copies; no host operators,
which would slow the host that paces the device: the spans name its work)
written as a Chrome trace to ``logdir/trace.json`` with the program's spans
as a host track of their own, on the same clock. After the block,
:func:`idle_by_span` gives the device's idle time to the innermost span open
at each moment.

Counterpart of ``nerf_kinematics_tpu/utils/profiling.py`` (``jax.profiler``
there).
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
from array import array
from time import time_ns
from typing import List, NamedTuple

import torch
import torch.autograd.profiler as _prof

CAPACITY = 1 << 19          # spans the buffer holds (about 20 MB)
NO_SPAN = "(no span)"       # idle time outside every span

_names: List[str] = []
_start = array("q")
_end = array("q")
_parent = array("q")
_rid = array("q")
_stack: List[int] = []      # open spans, innermost last (indices)
_base = 0                   # tokens handed out before the last clear()
_dropped = 0
_last = {"device": [], "window": None}   # the last device_trace's device intervals


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int     # 0 while open
    parent: int     # index in spans(), -1 for none
    rid: int


def begin(name: str, rid: int = -1, t: int = 0) -> int:
    """Open span ``name`` (at ``t`` ns if given, else now); its token, or -1
    outside a profile or with the buffer full."""
    if not _prof._is_profiler_enabled:
        return -1
    return _open(name, rid, t or time_ns())


def end(span: int, t: int = 0) -> None:
    """Close the span of token ``span`` (at ``t`` ns if given, else now)."""
    if span >= 0:
        _close(span, t or time_ns())


def _open(name: str, rid: int, t: int) -> int:
    global _dropped
    i = len(_names)
    if i >= CAPACITY:
        _dropped += 1
        return -1
    parent = _stack[-1] if _stack else -1
    _names.append(name)
    _start.append(t)
    _end.append(0)
    _parent.append(parent)
    _rid.append(rid if rid >= 0 or parent < 0 else _rid[parent])
    _stack.append(i)
    return _base + i


def _close(span: int, t: int) -> None:
    i = span - _base
    if i < 0 or i not in _stack:   # cleared since, or closed already
        return
    while _stack.pop() != i:       # spans an exception left open
        pass
    _end[i] = t


def clear() -> None:
    """Drop every record, open or closed, and the dropped count."""
    global _base, _dropped
    _base += len(_names)
    del _names[:], _stack[:]
    for a in (_start, _end, _parent, _rid):
        del a[:]
    _dropped = 0


def dropped() -> int:
    """Spans not recorded since the last clear() because the buffer was full."""
    return _dropped


def spans() -> List[Span]:
    """The records since the last clear(), in the order they were opened (a
    record's ``parent`` indexes this list)."""
    return [Span(*r) for r in zip(_names, _start, _end, _parent, _rid)]


# ------------------------------------------------------------ the operator's trace

def _device_intervals(prof) -> list:
    """(start, end) ns of every device operation the profile recorded."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()):
            out.append((e.start_ns(), e.end_ns()))
    return out


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the block with ``torch.profiler`` (the GPU's operations; the
    host's operators where there is no GPU) into ``logdir/trace.json`` (open
    in Perfetto or chrome://tracing), with the program's spans of the block
    as the track "program spans". Clears the span buffer on entry. Yields
    the profiler, whose ``key_averages()`` holds the per-operation times;
    after the block :func:`idle_by_span` reads its device intervals."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    gpu = torch.cuda.is_available()
    clear()
    with profile(activities=[ProfilerActivity.CUDA if gpu else ProfilerActivity.CPU]) as prof:
        t0 = time_ns()
        yield prof
        if gpu:
            torch.cuda.synchronize()
        t1 = time_ns()
    _last["device"], _last["window"] = _device_intervals(prof), (t0, t1)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path)


def _add_spans(path: str) -> None:
    """Append the closed spans to the Chrome trace at ``path`` as their own
    track (pid of this process, tid 0), in the trace's microseconds."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                   "args": {"name": "program spans"}})
    for i, s in enumerate(spans()):
        if s.end_ns:
            events.append({"ph": "X", "cat": "program_span", "name": s.name,
                           "pid": pid, "tid": 0, "ts": (s.start_ns - base) / 1e3,
                           "dur": (s.end_ns - s.start_ns) / 1e3,
                           "args": {"rid": s.rid, "index": i, "parent": s.parent}})
    with open(path, "w") as f:
        json.dump(trace, f)


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(recs) -> list:
    """(start, end, name) pieces of time, each given to the innermost span
    open over it: the one opened last among those open. ``recs``: (name,
    start, end) in the order opened."""
    order = sorted(range(len(recs)), key=lambda i: (recs[i][1], i))
    bounds = sorted({t for _, a, b in recs for t in (a, b)})
    heap, out, j = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while j < len(order) and recs[order[j]][1] <= a:
            heapq.heappush(heap, (-recs[order[j]][1], -order[j]))
            j += 1
        while heap and recs[-heap[0][1]][2] <= a:
            heapq.heappop(heap)
        if heap:
            out.append((a, b, recs[-heap[0][1]][0]))
    return out


def idle_by_span(device=None, window=None, recs=None) -> dict:
    """Seconds of device idle time within ``window`` (start, end) ns, by the
    name of the innermost span open at each moment (``NO_SPAN`` outside
    every span). ``device``: the device's (start, end) ns intervals;
    ``recs``: (name, start, end) spans in the order opened. By default the
    last :func:`device_trace`'s device and window, and the closed spans."""
    if device is None:
        device, window = _last["device"], window or _last["window"]
    if recs is None:
        recs = [(s.name, s.start_ns, s.end_ns) for s in spans() if s.end_ns]
    if window is None:
        return {}
    w0, w1 = window
    idle, t = [], w0
    for s, e in _union(device):
        if s > t:
            idle.append((t, min(s, w1)))
        t = max(t, e)
        if t >= w1:
            break
    if t < w1:
        idle.append((t, w1))
    idle = [(a, b) for a, b in idle if b > a]
    out, k = {}, 0
    pieces = _innermost(recs)
    for a, b in idle:
        covered = 0
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        m = k
        while m < len(pieces) and pieces[m][0] < b:
            lo, hi = max(a, pieces[m][0]), min(b, pieces[m][1])
            if hi > lo:
                out[pieces[m][2]] = out.get(pieces[m][2], 0.0) + (hi - lo) * 1e-9
                covered += hi - lo
            m += 1
        if b - a > covered:
            out[NO_SPAN] = out.get(NO_SPAN, 0.0) + (b - a - covered) * 1e-9
    return out
