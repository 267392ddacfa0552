"""Scalar metric writer: one JSON object per line in ``metrics.jsonl``
(``{"tag", "value", "step", "ts"}``), the run's machine-readable record and
its liveness heartbeat."""

from __future__ import annotations

import json
import os
import time


class ScalarWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}
        self._jsonl.write(json.dumps(rec) + "\n")

    def flush(self) -> None:
        self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
