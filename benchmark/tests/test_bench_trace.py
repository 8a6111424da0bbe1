"""The traced window's reduction on a made-up profile: the device's busy
time is the union of its operations, annotations on its timeline are left
out, and the breakdown sums operations by name and idle gaps by the
innermost host op."""

from types import SimpleNamespace

import pytest

from benchmark.harness import trace as tr
from benchmark.metrics import _layers


class Ev:
    def __init__(self, name, dev, kind, start, dur):
        self._n, self._d, self._k, self._s, self._u = name, dev, kind, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def activity_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))


EVENTS = [
    Ev("void neus::neus_tc_fwd_kernel<false>(neus::Dims, float*)", "CUDA", "kernel", 1000, 400),
    Ev("void at::native::vectorized_elementwise_kernel<4>(int)", "CUDA", "kernel", 1200, 400),  # overlaps
    Ev("Memcpy HtoD (Pageable -> Device)", "CUDA", "gpu_memcpy", 2000, 100),
    Ev("bench.step", "CUDA", "gpu_user_annotation", 0, 5000),  # not device work
    Ev("aten::mm", "CPU", "cpu_op", 1500, 600),
    Ev("aten::matmul", "CPU", "cpu_op", 1400, 1000),
    Ev("cudaLaunchKernel", "CPU", "cuda_runtime", 1700, 10),
]


def test_busy_is_the_union_of_device_operations():
    t = tr.from_profiler(profile(EVENTS), 3e-6, 2)
    assert len(t.device) == 3
    assert t.busy_s == pytest.approx(700e-9)
    assert [h[2] for h in t.host] == ["aten::matmul", "aten::mm"]
    run = SimpleNamespace(trace=t, ctx={"model_flops_step": 3.0, "peak_flops": 1e6})
    assert _layers.idle_pct(run) == pytest.approx(100 * (1 - 700 / 3000))
    assert _layers.kernels_per_step(run) == 1.5
    assert _layers.mfu_pct(run) == pytest.approx(100 * 3.0 / (3e-6 / 2) / 1e6)


def test_breakdown_names_operations_and_gaps():
    t = tr.from_profiler(profile(EVENTS), 3e-6, 2)
    ops = dict(tr.device_ops(t))
    assert ops["neus::neus_tc_fwd_kernel"] == pytest.approx(400e-9)
    assert "at::native::vectorized_elementwise_kernel" in ops
    gaps = tr.idle_gaps(t)
    assert gaps == [["aten::mm", pytest.approx(400e-9)]]
