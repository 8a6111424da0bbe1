"""Time B1's tensor-core pair (the bf16 operand mode) at the train_clip
step's shapes and split each of its kernels' time into phases.

    python -m avatarclip_torch.tools.profile_b1 [--rays 12544] [--reps 7]

Run from the root of a checkout on a CUDA card. It builds the 4x256 / 2x256
nets of chip_smoke.neus_problem at bf16 (seed 1), then:

* times the forward and backward entry points of the pair
  (``fused_neus.neus_ray_tc_fwd`` / ``neus_ray_tc_bwd``, weights packed
  once) with CUDA events and prints the median and the range over ``--reps``
  calls;
* loads a second build of ``csrc/fused_neus_ray_tc.cu`` with
  ``-DNEUS_TC_PROF``, runs each kernel once, and prints its cycles by phase
  (``neus_tc.cuh``: thread 0 of every CTA stamps clock64 at each phase
  boundary, so a phase's share is of the CTAs' summed cycles; the
  milliseconds beside it are that share of the median time);
* prints the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

PHASES = ("other", "product k-loops", "weight grads", "stage copies", "column passes", "compositing",
          "product epilogues", "log stores")
N_PHASE = 24  # neus_tc.cuh's PH_N: PHASES, then the epilogues by tag
TAGS = ("sdf primal hidden", "skip primal", "head primal", "colour primal", "colour reverse",
        "colour input reverse", "tangent hidden", "tangent skip", "head reverse", "sdf reverse pairs",
        "embedding reverse", "gradient sweep")


def median_ms(fn, reps: int) -> tuple[float, float, float]:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), min(times), max(times)


def kernel_times(fn, reps: int = 3) -> None:
    """Device milliseconds a call of fn by kernel (torch.profiler)."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        ms = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0)) / 1e3 / reps
        if ms > 0.01:
            rows.append((ms, ev.key[:60], ev.count // reps))
    rows.sort(reverse=True)
    print("[profile_b1] backward by kernel (device ms a call, launches): "
          + "; ".join(f"{k} {ms:.3f} x{n}" for ms, k, n in rows[:8]))


def print_build(name: str) -> None:
    """ptxas's registers and spills of a build."""
    from avatarclip_torch.ops import _build

    log = _build.BUILD / f"{name}.log"
    if log.exists():
        info = [ln.split("ptxas info    :")[-1].strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[profile_b1] build {name}: " + " | ".join(info))


def problem(n_rays: int, dev):
    """The pair's inputs, packed weights and cotangents at 256 wide, bf16."""
    import torch

    sys.path.insert(0, os.getcwd())
    from chip_smoke import neus_problem

    from avatarclip_torch.ops import fused_neus as fn

    fields, (rays_o, rays_d, mid, dists), probes, _ = neus_problem(
        256, n_rays, dev, seed=1, dtype="bfloat16")
    spec = fn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, mid.shape[1])
    with torch.no_grad():
        weights = fn.dense_weights(fields.sdf, fields.color)
        flat = torch.cat([w.reshape(-1) for w in weights])
        pk, pack = fn.pack_tc(spec, weights)
        inv_s = fields.variance.inv_s().reshape(()).float().contiguous()
    args = (flat, pk, pack, rays_o, rays_d, mid, dists, inv_s, 0.4)
    cots = (probes[0].contiguous(), probes[1].contiguous(), probes[2].contiguous(),
            torch.tensor([0.5, 0.0], device=dev))
    return spec, args, cots


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=112 * 112)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--define", action="append", default=[],
                    help="a macro for both builds of the pair (a variant under test)")
    ap.add_argument("--no-phases", action="store_true", help="time only: no profiling build")
    ap.add_argument("--chunk", type=int, default=0,
                    help="the backward's rays a CTA a chunk (fused_neus.RAYS_PER_CTA_CHUNK)")
    a = ap.parse_args()
    defs = tuple(a.define)
    import torch

    from avatarclip_torch.ops import _build
    from avatarclip_torch.ops import fused_neus as fn

    if not torch.cuda.is_available():
        raise SystemExit("profile_b1: needs a CUDA card")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    spec, args, cots = problem(a.rays, dev)
    if a.chunk:
        fn.RAYS_PER_CTA_CHUNK = a.chunk
    tag = "".join(f"_{d.lower()}" for d in defs)
    if defs:
        timed = fn.type_tc(_build.load_variant("fused_neus_ray_tc" + tag, "fused_neus_ray_tc.cu", defs))
        fn._tc_lib = lambda: timed

    def fwd():
        return fn.neus_ray_tc_fwd(spec, *args)

    res = fwd()

    def bwd():
        return fn.neus_ray_tc_bwd(spec, *args, res[3], res[4], *cots)

    times = {"forward": median_ms(fwd, a.reps), "backward": median_ms(bwd, a.reps)}
    for k, (med, lo, hi) in times.items():
        print(f"[profile_b1] {a.rays} rays x 64, 4x256 / 2x256, bf16{' ' + ','.join(defs) if defs else ''}"
              f"{f' chunk {a.chunk}' if a.chunk else ''}: {k} median {med:.3f} ms "
              f"over {a.reps} calls (range {lo:.3f}-{hi:.3f})")
    kernel_times(bwd)
    if a.no_phases:
        print_build("fused_neus_ray_tc" + tag)
        print(f"[profile_b1] device {smi}")
        return
    lib = fn.type_tc(_build.load_variant("fused_neus_ray_tc_prof" + tag, "fused_neus_ray_tc.cu",
                                         ("NEUS_TC_PROF",) + defs))
    for name in ("fused_neus_ray_tc" + tag, "fused_neus_ray_tc_prof" + tag):
        print_build(name)
    lib.neus_tc_phases.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    base = fn._tc_lib
    fn._tc_lib = lambda: lib
    try:
        fwd()
        bwd()
        torch.cuda.synchronize()
    finally:
        fn._tc_lib = base
    n_cta = fn.n_cta_tc(dev, a.rays)
    kernels = [("forward", 0, times["forward"][0]), ("backward (per-ray kernel, last chunk)", 1,
                                                      times["backward"][0])]
    for name, k, ms in kernels:
        buf = (ctypes.c_longlong * (n_cta * N_PHASE))()
        _build.check(lib.neus_tc_phases(k, buf, n_cta), "neus_tc_phases")
        tot = [sum(buf[c * N_PHASE + i] for c in range(n_cta)) for i in range(N_PHASE)]
        all_ = max(sum(tot[:len(PHASES)]), 1)
        rows = [f"{PHASES[i]} {tot[i] / all_:.1%} ({tot[i] / all_ * ms:.2f} ms)"
                for i in range(len(PHASES)) if tot[i]]
        print(f"[profile_b1] {name} phases (profiling build, shares of {all_ / n_cta:.4g} "
              f"cycles a CTA): " + ", ".join(rows))
        rows = [f"{TAGS[i]} {tot[8 + i] / all_ * ms:.2f} ms" for i in range(len(TAGS)) if tot[8 + i]]
        print(f"[profile_b1] {name} epilogues by product: " + ", ".join(rows))
    print(f"[profile_b1] device {smi}")


if __name__ == "__main__":
    main()
