"""The program's spans on the card, beside the device's trace, for one cell:

    python3 benchmark/spans_report.py --workload <cell> --seed <n> --seconds 30 \
        [--steps 3] [--out <file.json>]

Sets the cell up as run.py does (set-up, checked steps, warm-up), then:

1. ``window``: ``--seconds`` of steps traced on the device alone, as the
   cells' traced window is, with the program's spans on. The device's idle
   time a step split by the host's layer (metrics/_spans.py) beside the
   window's idle time a step (its length less the union of the device's
   operations); each span's host self time (its time less its children's
   on its thread) a step, by third of the window.
2. ``steps``: ``--steps`` more steps traced on the host and the device.
   The clock check: each launch of the port's own kernels (the runtime call
   joined to its kernel by correlation id) against the span that the
   program opens around it; and the host's blocking calls of one step
   (synchronisations and copies), each under its innermost span and op.

One JSON object on standard output (and in ``--out``).
"""

from __future__ import annotations

import argparse
import bisect
import json
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

# the port's kernels (csrc/) on the cells' paths, and the span each is launched in
KERNEL_SPANS = (
    (r"neus_tc_fwd_kernel|neus_ray_fwd_kernel", ("render.neus_core",)),
    (r"neus_tc_bwd_kernel|neus_ray_bwd_kernel|wgrad_kernel", ("backward.neus_core",)),
    (r"reduce_partials_kernel", ("render.neus_core", "backward.neus_core")),
    (r"face_ranges_kernel|zbuffer_binned_kernel", ("render.gt_raster",)),
    (r"soft_fwd_kernel|soft_fwd_reduce_kernel", ("render.soft",)),
    (r"soft_bwd_kernel|soft_bwd_reduce_kernel", ("backward.soft",)),
)
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
BLOCKING = re.compile(r"Synchronize|Memcpy")


def log(msg: str) -> None:
    print(f"[spans] {msg}", file=sys.stderr, flush=True)


def self_times(spans) -> dict[int, int]:
    """ns of each span's own time (less its children's on its thread), by
    the span's index in ``spans``."""
    out = {}
    by_thread: dict[int, list[int]] = {}
    for i, s in enumerate(spans):
        by_thread.setdefault(s.thread, []).append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (spans[i].t0_ns, -spans[i].t1_ns))
        stack: list[int] = []
        for i in idx:
            s = spans[i]
            while stack and spans[stack[-1]].t1_ns <= s.t0_ns:
                stack.pop()
            out[i] = s.t1_ns - s.t0_ns
            if stack:
                out[stack[-1]] -= s.t1_ns - s.t0_ns
            stack.append(i)
    return out


def by_third(spans, w0: int, w1: int) -> dict:
    """ms of host self time a step, per span name, in each third of [w0, w1]
    (a step's spans are in the third its ``loop.step`` span starts in)."""
    own = self_times(spans)
    third = (w1 - w0) / 3 or 1
    k = lambda t: min(2, max(0, int((t - w0) // third)))
    of_step = {s.step: k(s.t0_ns) for s in spans if s.name == "loop.step"}
    steps = [0, 0, 0]
    for j in of_step.values():
        steps[j] += 1
    out: dict[str, list[float]] = {}
    for i, s in enumerate(spans):
        out.setdefault(s.name, [0.0, 0.0, 0.0])[of_step.get(s.step, k(s.t0_ns))] += own[i] * 1e-6
    return {"steps": steps, "ms_a_step": {n: [v[j] / max(steps[j], 1) for j in range(3)]
                                          for n, v in sorted(out.items())}}


def window_report(drv, seconds: float, torch) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import trace as trace_mod
    from benchmark.metrics import _spans
    from avatarclip_torch.utils import trace

    trace.clear()
    stream = torch.cuda.current_stream()
    events = [torch.cuda.Event(enable_timing=True)]
    prof = profile(activities=[ProfilerActivity.CUDA], record_shapes=False, with_stack=False)
    prof.start()
    events[0].record(stream)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        drv.step()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        events.append(ev)
    torch.cuda.synchronize()
    prof.stop()
    steps_ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
    t = trace_mod.from_profiler(prof, sum(steps_ms) / 1e3, len(steps_ms))
    del prof
    spans = trace.spans()
    run = type("Run", (), {})()
    run.trace, run.steps_ms = t, steps_ms
    by = _spans.idle_by_layer(run)
    busy = t.busy_intervals()
    w0, w1 = busy[0][0], busy[-1][1]
    inside = [s for s in spans if s.t1_ns > w0 and s.t0_ns < w1]
    k = len(steps_ms) // 3
    return {
        "steps": len(steps_ms), "step_ms": sum(steps_ms) / len(steps_ms),
        "step_ms_by_third": [sum(steps_ms[i * k:(i + 1) * k]) / max(k, 1) for i in range(3)],
        "window_idle_ms_a_step": (t.window_s - t.busy_s) * 1e3 / t.steps,
        "idle_pct": 100.0 * (1.0 - t.busy_s / t.window_s),
        "idle_by_layer_ms_a_step": by, "spans": len(spans), "spans_in_window": len(inside),
        "self_time_by_third": by_third(inside, w0, w1),
    }


def _innermost(intervals, starts, t):
    """The shortest (start, end, name) of ``intervals`` (sorted by start,
    their starts in ``starts``) that holds ``t``; None where none does."""
    best = None
    for s, e, n in intervals[max(0, bisect.bisect_right(starts, t) - 4000):bisect.bisect_right(starts, t)]:
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, n)
    return best


def steps_report(drv, n: int, torch) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from avatarclip_torch.utils import trace

    trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=False,
                 with_stack=False) as prof:
        for _ in range(n):
            drv.step()
        torch.cuda.synchronize()
    spans = trace.spans()
    runtime, kernels, ops = {}, [], []
    for e in prof.profiler.kineto_results.events():  # by device and name: torch builds type them apart
        name = e.name()
        if getattr(e, "is_user_annotation", lambda: False)():
            continue
        if "CUDA" in str(e.device_type()):
            if not name.startswith(("Memcpy", "Memset")):
                kernels.append(e)
        elif name.startswith("cu"):  # the CUDA runtime's and driver's calls
            runtime.setdefault(e.correlation_id(), []).append(e)
        else:
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), name, e.start_thread_id()))
    # the clock check
    checked, inside, early, missing, per_kernel = 0, 0, 0, 0, {}
    for ke in kernels:
        allowed = next((names for pat, names in KERNEL_SPANS if re.search(pat, ke.name())), None)
        if allowed is None:
            continue
        launch = next((r for r in runtime.get(ke.correlation_id(), []) if r.name() in LAUNCHES), None)
        if launch is None:
            missing += 1
            continue
        checked += 1
        lt = launch.start_ns()
        home = [s for s in spans if s.name in allowed and s.t0_ns <= lt <= s.t1_ns]
        ok = bool(home)
        inside += ok
        if ok and ke.start_ns() < min(s.t0_ns for s in home):
            early += 1
        row = per_kernel.setdefault(re.search(r"[a-z_0-9]*kernel", ke.name()).group(0), [0, 0])
        row[0] += 1
        row[1] += ok
    # the blocking calls, each under its innermost span (any thread) and op (its thread)
    sp = sorted((s.t0_ns, s.t1_ns, s.name) for s in spans)
    sp_starts = [s[0] for s in sp]
    ops.sort()
    op_by_thread: dict[int, list] = {}
    for o in ops:
        op_by_thread.setdefault(o[3], []).append(o[:3])
    op_starts = {k: [o[0] for o in v] for k, v in op_by_thread.items()}
    blocking: dict[tuple, list] = {}
    for evs in runtime.values():
        for r in evs:
            if not BLOCKING.search(r.name()):
                continue
            t = r.start_ns()
            s = _innermost(sp, sp_starts, t)
            tid = r.start_thread_id()
            o = _innermost(op_by_thread.get(tid, []), op_starts.get(tid, []), t)
            key = (s[2] if s else "unspanned", o[2] if o else "no op", r.name())
            row = blocking.setdefault(key, [0, 0.0])
            row[0] += 1
            row[1] += r.duration_ns() * 1e-3
    return {
        "steps": n,
        "clock": {"launches_checked": checked, "inside_their_span": inside,
                  "inside_pct": 100.0 * inside / checked if checked else None,
                  "kernel_before_span_start": early, "launch_not_found": missing,
                  "by_kernel": per_kernel},
        "blocking_a_step": [{"span": k[0], "op": k[1], "call": k[2], "count": v[0] / n, "host_us": v[1] / n}
                            for k, v in sorted(blocking.items(), key=lambda kv: -kv[1][1])],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from benchmark.run import run_env

    run_env()  # the environment of the cells' runs
    import torch

    from benchmark.harness import registry

    if not torch.cuda.is_available():
        print("spans_report.py runs on a CUDA card", file=sys.stderr)
        return 2
    wl = registry.workload(args.workload)
    cfg = registry.config(wl["config"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    drv = registry.driver(wl["driver"])(cfg, wl, args.seed, dev, {})
    drv.setup()
    drv.first_steps()
    drv.warmup()
    torch.cuda.synchronize()
    out = {"workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(0)}
    out["window"] = window_report(drv, args.seconds, torch)
    log(f"window: {json.dumps(out['window'])}")
    out["steps"] = steps_report(drv, args.steps, torch)
    drv.release()
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
