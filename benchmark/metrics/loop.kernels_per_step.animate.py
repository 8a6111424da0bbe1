"""Device operations launched a step in the traced window: what a CUDA
graph or launch fusion removes."""

from benchmark.metrics._layers import kernels_per_step


def read(run):
    return kernels_per_step(run)
