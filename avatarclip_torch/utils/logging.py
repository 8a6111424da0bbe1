"""Run metrics as JSONL (the port's own copy of the JAX package's
``utils/logging.MetricsLogger``, without the tensorboard sink).

The reference logs scalars to tensorboard (reference:
AvatarGen/AppearanceGen/main.py:232-238, 542-547). Here the sink is a
dependency-free ``logs/metrics.jsonl`` (greppable, plottable).
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, scalars: dict) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
