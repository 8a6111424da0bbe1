"""The whole step's model FLOPs (no recompute) a step over the traced
time a step, as a share of the peak of the configuration's compute type."""

from benchmark.metrics._layers import mfu_pct


def read(run):
    return mfu_pct(run)
