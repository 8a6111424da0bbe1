"""Step statistics of the timed window (CUDA events: one at the window's
start, one after each step, read after the window's synchronise)."""

from __future__ import annotations

import numpy as np


def mean_ms(run):
    """The window's elapsed device time over its steps."""
    return sum(run.steps_ms) / len(run.steps_ms) if run.steps_ms else None


def p95_ms(run):
    """The 95th percentile of the steps' intervals (linear interpolation)."""
    return float(np.percentile(np.asarray(run.steps_ms), 95)) if run.steps_ms else None
