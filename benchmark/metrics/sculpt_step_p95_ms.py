"""sculpt_step_p95_ms: the 95th percentile over the window's steps."""

from benchmark.metrics._steps import p95_ms


def read(run):
    return p95_ms(run)
