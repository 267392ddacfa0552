"""Where a training cell's host time goes, chunk by chunk.

Runs one training run as ``benchmark/run.py`` does, with ``Trainer.fit``
wrapped so that each call (one chunk of the window, or a checked step of
set-up) records its wall time, the main thread's CPU time, the process's
CPU time and the thread's voluntary and involuntary context switches. A
mode changes what might pace the host:

  * ``dflt``: as a run is;
  * ``pin``: the process on one core (``os.sched_setaffinity``);
  * ``gc``: Python's garbage collector frozen and switched off.

    python3 benchmark/host_probe.py <mode> <out.json> --workload <cell> \\
        --seed <n> --seconds <s> --trace 0

The run's own output is as ``run.py``'s; the records go to ``out.json``.
"""

from __future__ import annotations

import gc
import json
import os
import resource
import sys
import time

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mode, out_path, rest = argv[0], argv[1], argv[2:]
    if mode == "pin":
        os.sched_setaffinity(0, {sorted(os.sched_getaffinity(0))[-1]})
    if REPO_DIR not in sys.path:
        sys.path.insert(0, REPO_DIR)
    from benchmark import run as bench_run
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    records = []
    fit = Trainer.fit

    def timed_fit(self, *args, **kwargs):
        w, p, t = time.perf_counter(), time.process_time(), time.thread_time()
        ru = resource.getrusage(resource.RUSAGE_THREAD)
        result = fit(self, *args, **kwargs)
        ru2 = resource.getrusage(resource.RUSAGE_THREAD)
        records.append({"wall": time.perf_counter() - w, "proc": time.process_time() - p,
                        "thread": time.thread_time() - t,
                        "ivcsw": ru2.ru_nivcsw - ru.ru_nivcsw,
                        "vcsw": ru2.ru_nvcsw - ru.ru_nvcsw})
        return result

    Trainer.fit = timed_fit
    if mode == "gc":
        gc.collect()
        gc.freeze()
        gc.disable()
    try:
        rc = bench_run.main(rest)
    finally:
        Trainer.fit = fit
    with open(out_path, "w") as f:
        json.dump({"mode": mode, "rc": rc, "calls": records}, f)
    return rc


if __name__ == "__main__":
    sys.exit(main())
