"""The benchmark of avatarclip_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, the benchmark's
folder and avatarclip_torch. The run sets the cell up from the seed (the
program's objects, the weights, the inputs), takes the cell's first steps
for the check, warms every shape the cell uses, then times a window of
``--seconds``: a CUDA event at the window's start and after each step,
read after one synchronise at its end. With ``--trace 1`` torch.profiler
traces the window's device activity, the cell's per-layer metrics are read
from it, and 3 more steps traced with the host's ops label the device's
idle gaps; with ``--trace 0`` the run reports its end-to-end metrics. After the window the program's
state is freed and the plain reference follows the first steps; the
compared numbers and their limits end standard error and the result line.
The last line of standard output is the result, one JSON object.

Exits with 2 and prints no result where there is no CUDA card (or fewer
than the cell asks for), and with 3 where the process holds jax, jaxlib,
flax or avatarclip_tpu once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "avatarclip_tpu")


def log(msg: str) -> None:
    print(f"[bench] {msg}", flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


LABELLED_STEPS = 3  # steps traced with the host's ops after the window, to label the idle gaps


def run_env() -> None:
    """Every kernel cache inside the checkout, at fixed paths, Python's
    bytecode among them (an installation that keeps none recompiles torch
    at each import); no library loads JAX by itself; one host thread for
    torch's CPU work. The program's entry points leave torch's default pool
    (a thread a core), whose idle threads spin beside the dispatching one:
    on a shared host that made the cells' steps ~10% slower and their runs
    spread two to four times as wide, too wide for any bound."""
    cache = CHECKOUT / ".bench_cache"
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(cache / "pycache")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"


def build_seconds() -> dict:
    """The seconds nvcc took for each CUDA library this process built
    (none where the checkout had them already)."""
    build = sys.modules.get("avatarclip_torch.ops._build")
    return dict(build.build_seconds) if build is not None else {}


class Run:
    """What the metric readers read: the window's step times, the set-up,
    the trace (traced runs only) and the driver's counts."""

    def __init__(self, steps_ms, setup_s, trace, ctx, workload, config):
        self.steps_ms, self.setup_s, self.trace = steps_ms, setup_s, trace
        self.ctx, self.workload, self.config = ctx, workload, config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    run_env()
    sys.path.insert(0, str(CHECKOUT))
    from benchmark.harness import registry

    bench = registry.benchmark_file()
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    wl = registry.workload(args.workload)
    cfg = registry.config(cell["config"])
    e2e, per_layer = registry.cell_metrics(bench, args.workload)
    wanted = per_layer if args.trace else e2e
    readers = {m["name"]: registry.reader(m["name"]) for m in wanted}
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(f"{args.workload} seed {args.seed}, {args.seconds} s, trace {args.trace}; "
        f"{torch.cuda.get_device_name(0)}")
    parts: dict[str, float] = {"import": time.perf_counter() - T_START}
    drv = registry.driver(wl["driver"])(cfg, wl, args.seed, device, parts)
    drv.setup()
    drv.first_steps()
    drv.warmup()
    torch.cuda.synchronize()
    for k, v in parts.items():
        log(f"set-up {k}: {v:.3f} s")
    built = build_seconds()
    log(f"set-up build (nvcc, inside the parts above): {sum(built.values()):.3f} s, "
        f"{', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'every library already built'}; "
        f"set-up without it: {time.perf_counter() - T_START - sum(built.values()):.3f} s")
    torch.cuda.reset_peak_memory_stats()

    prof = None
    if args.trace:  # the window on the device's timeline alone (harness/trace.py)
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA], record_shapes=False, with_stack=False)
        prof.start()
    stream = torch.cuda.current_stream()
    events = [torch.cuda.Event(enable_timing=True)]
    setup_s = time.perf_counter() - T_START
    events[0].record(stream)
    t0, cpu0 = time.perf_counter(), time.process_time()
    while time.perf_counter() - t0 < args.seconds:
        drv.step()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        events.append(ev)
    torch.cuda.synchronize()
    host_s, cpu_s = time.perf_counter() - t0, time.process_time() - cpu0
    if prof is not None:
        prof.stop()
    steps_ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
    peak = int(torch.cuda.max_memory_allocated(device))
    failed = drv.window_done()
    log(f"window: {len(steps_ms)} steps, {sum(steps_ms) / 1e3:.3f} s on the device clock, "
        f"{host_s:.3f} s on the host's, {cpu_s:.3f} s of the process's CPU; peak {peak / 2**30:.3f} GiB; mean step "
        f"{sum(steps_ms) / max(len(steps_ms), 1):.4f} ms")
    k = len(steps_ms) // 3
    if k:
        log("mean step ms by third of the window: " + ", ".join(
            f"{sum(steps_ms[i * k:(i + 1) * k]) / k:.2f}" for i in range(3)))
    groups: dict[str, list[float]] = {}
    for label, ms in zip(drv.step_labels(), steps_ms):
        groups.setdefault(label, []).append(ms)
    log("step ms by kind: " + ", ".join(f"{k} {sum(v) / len(v):.2f} x {len(v)}" for k, v in sorted(groups.items())))

    trace = None
    from benchmark.harness import trace as trace_mod

    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(cell["chips"]),
                   "memory_peak_bytes": peak}
    breakdown = None
    if prof is not None:
        t = time.perf_counter()
        trace = trace_mod.from_profiler(prof, sum(steps_ms) / 1e3, len(steps_ms))
        del prof
        log(f"trace: {len(trace.device)} device operations in {trace.steps} steps, read in "
            f"{time.perf_counter() - t:.1f} s; event kinds {trace.kinds}")
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        breakdown = {"device_ops": trace_mod.device_ops(trace)}
    ctx = drv.context(trace)
    run = Run(steps_ms, setup_s, trace, ctx, wl, cfg)
    metrics = {}
    units = {m["name"]: m["unit"] for m in wanted}
    for name, read in readers.items():
        v = read(run)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": units[name]}
    del trace, run
    if breakdown is not None:  # a few more steps, the host's ops traced too, for the idle gaps' labels
        from torch.profiler import ProfilerActivity, profile

        n = LABELLED_STEPS
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=False,
                     with_stack=False) as p2:
            for _ in range(n):
                drv.step()
            torch.cuda.synchronize()
        labelled = trace_mod.from_profiler(p2, 0.0, n)
        breakdown["idle_gaps"] = trace_mod.idle_gaps(labelled)
        del p2, labelled
    gc.collect()

    drv.release()
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = drv.check()
    log(f"reference and comparison: {time.perf_counter() - t:.1f} s")
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and failed == 0

    found = forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)} after the window", file=sys.stderr)
        return 3
    result = {"correct": bool(correct), "attempted": len(steps_ms), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
