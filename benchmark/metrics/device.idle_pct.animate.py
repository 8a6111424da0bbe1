"""The device's idle share of the traced window, in %."""

from benchmark.metrics._layers import idle_pct


def read(run):
    return idle_pct(run)
