"""The traced window's reduction: torch.profiler's raw events, read from
its kineto results without building the profiler's own tables, turned into
the device's operations (and the host's ops, where the CPU was traced), the
device's busy time as the union of its operations' intervals, and the
breakdown.

The window itself is traced on the device alone (CUPTI's kernels, copies
and fills), since tracing the host's ops costs microseconds an op and the
pose step launches some 13,000 of them; the idle gaps' host ops come from a
few steps traced with the host after the window."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window_s: float  # the window's length on the device clock (the CUDA events)
    steps: int
    device: list = field(default_factory=list)  # (start_ns, dur_ns, name) by start: kernels, copies, fills
    host: list = field(default_factory=list)  # (start_ns, dur_ns, name) of the host's ops, where traced
    kinds: dict = field(default_factory=dict)  # the profile's events by activity kind

    def busy_intervals(self) -> list[tuple[int, int]]:
        out: list[list[int]] = []
        for s, d, _ in self.device:
            e = s + d
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def kernels_named(self, names: list[str]) -> list[tuple[int, int, str]]:
        """The device operations whose name contains any of ``names``."""
        return [e for e in self.device if any(n in e[2] for n in names)]


def _kind(ev) -> str:
    kind = getattr(ev, "activity_type", "")
    return str(kind() if callable(kind) else kind).lower()


def _is_cuda(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def from_profiler(prof, window_s: float, steps: int) -> Trace:
    """The device's kernels, copies and fills (and the host's ops, where
    the profile traced the CPU) of a profile that spans the window alone;
    annotations on the device's timeline are left out."""
    events = prof.profiler.kineto_results.events()
    kinds: dict[str, int] = {}
    for e in events:
        k = _kind(e)
        kinds[k] = kinds.get(k, 0) + 1
    typed = any(x in k for k in kinds for x in DEVICE_KINDS)  # the torch build names activity kinds
    device, host = [], []
    for e in events:
        k = _kind(e)
        if _is_cuda(e):
            if getattr(e, "is_user_annotation", lambda: False)():
                continue
            if not typed or any(x in k for x in DEVICE_KINDS):
                device.append((e.start_ns(), e.duration_ns(), e.name()))
        elif not typed or "cpu_op" in k:
            host.append((e.start_ns(), e.duration_ns(), e.name()))
    device.sort()
    host.sort()
    return Trace(window_s, steps, device, host, kinds)


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "").strip()
    cut = min([i for i in (name.find("<"), name.find("(")) if i > 0] or [len(name)])
    return name[:cut][:96] or "unnamed"


def device_ops(trace: Trace, top: int = 10) -> list:
    """The device operations that took most time, summed by short name."""
    by_op: dict[str, float] = {}
    for _, d, n in trace.device:
        k = short_name(n)
        by_op[k] = by_op.get(k, 0.0) + d * 1e-9
    return [[k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """The device's idle gaps between its first and last operation, summed
    by the innermost host op running at each gap's midpoint ("no host op"
    where none was)."""
    starts = [s for s, _, _ in trace.host]
    gaps: dict[str, float] = {}
    busy = trace.busy_intervals()
    for (_, prev), (a, _) in zip(busy[:-1], busy[1:]):
        mid = (prev + a) // 2
        label, best = "no host op", None
        i = bisect.bisect_right(starts, mid)
        for s, d, n in trace.host[max(0, i - 4000):i]:
            if s <= mid < s + d and (best is None or d < best):
                label, best = n, d
        gaps[label] = gaps.get(label, 0.0) + (a - prev) * 1e-9
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]
