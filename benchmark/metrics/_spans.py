"""The device's idle time in the traced window, split by the program's layer
that the host was in (the program's spans, avatarclip_torch/utils/trace.py).

The spans are stamped with ``time.time_ns()``, the clock of the profile's
device events, so both lie on one timeline. The window runs from the
device's first operation to the end of its last; spans are cut to it. At
each instant the host's innermost span is the shortest one open on any
thread (a kernel's backward on autograd's worker thread inside the main
thread's ``backward``). Each idle interval of the device, between two busy
intervals, is split over that timeline by overlap; the parts are summed by
the span name's first segment (``loop``, ``render``, ``clip``,
``backward``), and the idle time under no span is ``UNSPANNED``. Values are
ms a step (over the trace's steps). A program without the spans (no
``avatarclip_torch.utils.trace`` loaded, or no span in the window) reads
nothing.
"""

from __future__ import annotations

import heapq
import sys

UNSPANNED = "unspanned"
TRACE_MODULE = "avatarclip_torch.utils.trace"


def program_spans() -> list | None:
    """The program's recorded spans, or None where it records none."""
    mod = sys.modules.get(TRACE_MODULE)
    read = getattr(mod, "spans", None)
    return list(read()) if read is not None else None


def innermost(spans: list, w0: int, w1: int) -> list[tuple[int, int, str]]:
    """(start, end, name) of the innermost span, piecewise over [w0, w1]:
    at each instant the shortest span open on any thread; time under no
    span is left out. ``spans``: objects with name, t0_ns, t1_ns."""
    cut = [(max(s.t0_ns, w0), min(s.t1_ns, w1), s.t1_ns - s.t0_ns, s.name)
           for s in spans if s.t1_ns > w0 and s.t0_ns < w1 and s.t1_ns > s.t0_ns]
    bounds = sorted({t for a, b, _, _ in cut for t in (a, b)})
    starts = sorted(range(len(cut)), key=lambda i: cut[i][0])
    heap: list[tuple[int, int]] = []  # (duration, index) of the open spans
    out: list[tuple[int, int, str]] = []
    k = 0
    for t, nxt in zip(bounds[:-1], bounds[1:]):
        while k < len(starts) and cut[starts[k]][0] <= t:
            i = starts[k]
            heapq.heappush(heap, (cut[i][2], i))
            k += 1
        while heap and cut[heap[0][1]][1] <= t:
            heapq.heappop(heap)
        if not heap:
            continue
        name = cut[heap[0][1]][3]  # the top is open: the shortest open span
        if out and out[-1][2] == name and out[-1][1] == t:
            out[-1] = (out[-1][0], nxt, name)
        else:
            out.append((t, nxt, name))
    return out


def split_idle(trace, spans: list) -> dict[str, int] | None:
    """ns of device idle time under each layer (and ``UNSPANNED``) over the
    window of ``trace`` (harness/trace.py's Trace); None where no span
    meets the window."""
    busy = trace.busy_intervals()
    if not busy:
        return None
    line = innermost(spans, busy[0][0], busy[-1][1])
    if not line:
        return None
    out: dict[str, int] = {UNSPANNED: 0}
    j = 0
    for (_, a), (b, _) in zip(busy[:-1], busy[1:]):  # the idle interval [a, b)
        covered = 0
        while j < len(line) and line[j][1] <= a:
            j += 1
        k = j
        while k < len(line) and line[k][0] < b:
            s, e, name = line[k]
            d = min(e, b) - max(s, a)
            if d > 0:
                layer = name.split(".", 1)[0]
                out[layer] = out.get(layer, 0) + d
                covered += d
            k += 1
        out[UNSPANNED] += (b - a) - covered
    return out


def idle_by_layer(run) -> dict[str, float] | None:
    """ms of device idle time a step under each layer and ``UNSPANNED``, and
    ``"idle"`` the whole; None without a trace or the program's spans.
    Computed once a run, and printed to standard error."""
    if "_idle_by_layer" in run.__dict__:
        return run.__dict__["_idle_by_layer"]
    t, spans, out = run.trace, program_spans(), None
    ns = split_idle(t, spans) if t is not None and t.steps and spans else None
    if ns is not None:
        out = {k: v * 1e-6 / t.steps for k, v in ns.items()}
        out["idle"] = sum(ns.values()) * 1e-6 / t.steps
        print("[bench] device idle ms a step by the host's layer (program spans): "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(out.items())), file=sys.stderr, flush=True)
    run.__dict__["_idle_by_layer"] = out
    return out


def idle_ms(run, layer: str) -> float | None:
    """ms a step the device idled while the host was in ``layer``."""
    by = idle_by_layer(run)
    return None if by is None else by.get(layer, 0.0)
