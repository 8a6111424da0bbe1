"""B5's share of its roofline: the soft raster's bound on the live
(pixel, face) pairs (float32 operations, special functions or bytes) over
its kernels' device time, the kernels named in soft.kernels.txt."""

from benchmark.metrics._layers import roofline_pct


def read(run):
    return roofline_pct(run, "soft", "soft_bound_ms_step")
