"""B1's share of its roofline: the per-ray NeuS pair's bound (bf16 tensor
cores or bytes, a step's 12,544 x 64 points) over its kernels' device
time, the kernels named in neus_ray.kernels.txt."""

from benchmark.metrics._layers import roofline_pct


def read(run):
    return roofline_pct(run, "neus_ray", "neus_ray_bound_ms_step")
