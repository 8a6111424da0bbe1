"""sculpt_step_ms: the mean time of a step, the window's elapsed device time over
its steps."""

from benchmark.metrics._steps import mean_ms


def read(run):
    return mean_ms(run)
