"""Time the tensor-core NeuS kernels (the bf16 operand mode) at the main
path's shapes and split each kernel's time into phases: B1's pair at the
train_clip step's rays, B3's forward at the validation chunk, B6's backward
(b6) and forward (b6f) and B7's backward (b7b) at the background step's
points.

    python -m avatarclip_torch.tools.profile_b1 [--kernel all|b1|b3|b6|b6f|b7b ...] [--reps 7]

Run from the root of a checkout on a CUDA card. It builds the 4x256 / 2x256
nets of chip_smoke.neus_problem at bf16, then, for each kernel asked for:

* times its entry point (``fused_neus.neus_ray_tc_fwd`` / ``neus_ray_tc_bwd``
  at ``--rays`` x 64, ``neus_point_fwd`` at 16,384 x 64, ``fused_sdf.sdf_bwd``
  and ``sdf_fwd`` and ``fused_color.color_bwd`` at 802,816 points; weights
  packed once, but B7's, which its wrapper packs) with CUDA events and prints the
  median and the range over ``--reps`` calls; the backwards' device time by
  kernel (the per-tile kernel, the weight-gradient GEMM, the partial sums)
  by torch.profiler;
* loads a second build of ``csrc/fused_neus_ray_tc.cu`` with
  ``-DNEUS_TC_PROF``, runs the kernel once, and prints its cycles by phase
  (``neus_tc.cuh``: thread 0 of every CTA stamps clock64 at each phase
  boundary, so a phase's share is of the CTAs' summed cycles; the
  milliseconds beside it are that share of the median time). Thread 0 is
  a thread of consumer warpgroup 0 and that warpgroup's producer: its
  k-loops leave out its waits for a slot's copy to land and its issuing of
  the copies, two phases of their own;
* prints the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

PHASES = ("other", "product k-loops", "weight grads", "producer issuing copies",
          "column passes", "compositing / per-point I/O", "product epilogues", "log stores")
N_PHASE = 24  # neus_tc.cuh's PH_N: PHASES, the epilogues by tag, then PH_FULL
PH_FULL = 20  # neus_tc.cuh's: waits for a slot's weights to land
TAGS = ("sdf primal hidden", "skip primal", "head primal", "colour primal", "colour reverse",
        "colour input reverse", "tangent hidden", "tangent skip", "head reverse", "sdf reverse pairs",
        "embedding reverse", "gradient sweep")
PK_RAY_FWD, PK_RAY_BWD, PK_WGRAD, PK_POINT_FWD, PK_SDF_BWD, PK_SDF_FWD, PK_COL_BWD = range(7)  # neus_tc.cuh's PK_*
B3_RAYS = 16384  # the validation chunk
B6_RAYS = 112 * 112  # the background step's rays: 802,816 points


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


def kernel_times(tag: str, fn, reps: int = 3) -> dict:
    """Device milliseconds a call of fn by kernel (torch.profiler), printed
    and returned by kernel name."""
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
    print(f"[profile] {tag} by kernel (device ms a call, launches): "
          + "; ".join(f"{k} {ms:.3f} x{n}" for ms, k, n in rows[:8]))
    return {k: ms for ms, k, _ in rows}


def print_build(name: str) -> None:
    """ptxas's registers and spills of a build."""
    from avatarclip_torch.ops import _build

    log = _build.BUILD / f"{name}.log"
    if log.exists():
        info = [ln.split("ptxas info    :")[-1].strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[profile] build {name}: " + " | ".join(info))


def _nets(n_rays: int, dev, seed: int):
    sys.path.insert(0, os.getcwd())
    from chip_smoke import neus_problem

    return neus_problem(256, n_rays, dev, seed=seed, dtype="bfloat16")


def b1_problem(n_rays: int, dev) -> dict:
    """B1's pair: (name, PK slot, call) of its forward and backward."""
    import torch

    from avatarclip_torch.ops import fused_neus as fn

    fields, (rays_o, rays_d, mid, dists), probes, _ = _nets(n_rays, dev, 1)
    spec = fn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, mid.shape[1])
    with torch.no_grad():
        weights = fn.dense_weights(fields.sdf, fields.color)
        flat = torch.cat([w.reshape(-1) for w in weights])
        pk, pack = fn.pack_tc(spec, weights)
        inv_s = fields.variance.inv_s().reshape(()).float().contiguous()
    args = (flat, pk, pack, rays_o, rays_d, mid, dists, inv_s, 0.4)
    cots = (probes[0].contiguous(), probes[1].contiguous(), probes[2].contiguous(),
            torch.tensor([0.5, 0.0], device=dev))
    res = fn.neus_ray_tc_fwd(spec, *args)
    return {"shape": f"{n_rays} rays x 64", "ctas": fn.n_cta_tc(dev, n_rays), "calls": [
        ("B1 forward", PK_RAY_FWD, lambda: fn.neus_ray_tc_fwd(spec, *args)),
        ("B1 backward (per-ray kernel, last chunk)", PK_RAY_BWD,
         lambda: fn.neus_ray_tc_bwd(spec, *args, res[3], res[4], *cots))]}


def b3_problem(dev) -> dict:
    import torch

    from avatarclip_torch.ops import fused_neus as fn

    fields, (rays_o, rays_d, mid, dists), _, _ = _nets(B3_RAYS, dev, 2)
    spec = fn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, mid.shape[1])
    with torch.no_grad():
        weights = fn.dense_weights(fields.sdf, fields.color)
        flat = torch.cat([w.reshape(-1) for w in weights])
        packed = fn.pack_tc(spec, weights)
        inv_s = fields.variance.inv_s().reshape(()).float().contiguous()
    return {"shape": f"{B3_RAYS} rays x 64", "ctas": fn.n_cta_tc(dev, B3_RAYS), "calls": [
        ("B3 forward", PK_POINT_FWD,
         lambda: fn.neus_point_fwd(spec, flat, rays_o, rays_d, mid, dists, inv_s, 0.4, packed))]}


def b6_problem(dev) -> dict:
    import torch

    from avatarclip_torch.ops import fused_neus as fn
    from avatarclip_torch.ops import fused_sdf as fs

    fields, (ro, rd, mid, _), _, _ = _nets(B6_RAYS, dev, 6)
    pts = (ro[:, None] + rd[:, None] * mid[..., None]).reshape(-1, 3).contiguous()
    P = pts.shape[0]
    spec = fs.spec_from_config(fields.sdf.cfg)
    with torch.no_grad():
        weights = fs.dense_weights(fields.sdf)
        flat = torch.cat([w.reshape(-1) for w in weights])
        packed = fn.pack_tc(spec, weights)
    g = torch.Generator().manual_seed(5)
    cots = [(0.5 + torch.rand(P, k, generator=g)).to(dev) for k in (1, spec.feat_dim, 3)]
    return {"shape": f"{P} points", "ctas": fn.n_cta_tc(dev, -(-P // fs.BLOCK)), "calls": [
        ("B6 backward (per-tile kernel, last chunk)", PK_SDF_BWD,
         lambda: fs.sdf_bwd(spec, flat, pts, *cots, packed=packed))]}


def b6f_problem(dev) -> dict:
    import torch

    from avatarclip_torch.ops import fused_neus as fn
    from avatarclip_torch.ops import fused_sdf as fs

    fields, (ro, rd, mid, _), _, _ = _nets(B6_RAYS, dev, 6)
    pts = (ro[:, None] + rd[:, None] * mid[..., None]).reshape(-1, 3).contiguous()
    spec = fs.spec_from_config(fields.sdf.cfg)
    with torch.no_grad():
        weights = fs.dense_weights(fields.sdf)
        flat = torch.cat([w.reshape(-1) for w in weights])
        packed = fn.pack_tc(spec, weights)
    return {"shape": f"{pts.shape[0]} points", "ctas": fn.n_cta_tc(dev, -(-pts.shape[0] // fs.BLOCK)),
            "calls": [("B6 forward", PK_SDF_FWD, lambda: fs.sdf_fwd(spec, flat, pts, packed))]}


def b7b_problem(dev) -> dict:
    """B7's backward at path (e)'s mode: no_view_dir with the extra head."""
    import torch

    from avatarclip_torch.ops import fused_neus as fn
    from avatarclip_torch.ops import fused_color as fc

    fields, inputs, _, _ = _nets(B6_RAYS, dev, 10)
    from chip_smoke import colour_inputs, colour_net  # importable once _nets put the checkout on the path

    ins = colour_inputs(fields, inputs)
    del fields
    net = colour_net("no_view_dir", True, dev, seed=11, dtype="bfloat16")
    spec = fc.spec_from_config(net.cfg)
    flat = torch.cat([w.detach().reshape(-1) for w in fc.dense_weights(net, spec)])
    P = ins[0].shape[0]
    cot = (0.5 + torch.rand(P, spec.rgb_width, generator=torch.Generator().manual_seed(8))).to(dev)
    n_cta, _, _ = fn.tc_bwd_chunking(dev, fn._tc_lib(), spec.dims(), -(-P // fc.BLOCK))
    return {"shape": f"{P} points", "ctas": n_cta, "calls": [
        ("B7 backward (per-tile kernel, last chunk)", PK_COL_BWD,
         lambda: fc.color_bwd(spec, flat, *ins, cot))]}


def phases(lib, name: str, k: int, n_cta: int, ms: float) -> None:
    from avatarclip_torch.ops import _build

    buf = (ctypes.c_longlong * (n_cta * N_PHASE))()
    _build.check(lib.neus_tc_phases(k, buf, n_cta), "neus_tc_phases")
    tot = [sum(buf[c * N_PHASE + i] for c in range(n_cta)) for i in range(N_PHASE)]
    named = list(enumerate(PHASES)) + [(PH_FULL, "waits on full slots")]
    all_ = max(sum(tot[i] for i, _ in named), 1)
    rows = [f"{name} {tot[i] / all_:.1%} ({tot[i] / all_ * ms:.2f} ms)" for i, name in named if tot[i]]
    print(f"[profile] {name} phases (profiling build, shares of {all_ / n_cta:.4g} cycles a CTA): "
          + ", ".join(rows))
    rows = [f"{TAGS[i]} {tot[8 + i] / all_ * ms:.2f} ms" for i in range(len(TAGS)) if tot[8 + i]]
    print(f"[profile] {name} epilogues by product: " + ", ".join(rows))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", nargs="+", choices=("all", "b1", "b3", "b6", "b6f", "b7b"),
                    default=["all"])
    ap.add_argument("--rays", type=int, default=112 * 112, help="B1's rays")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--define", action="append", default=[],
                    help="a macro for both builds of the kernels (a variant under test)")
    ap.add_argument("--no-phases", action="store_true", help="time only: no profiling build")
    ap.add_argument("--chunk", type=int, default=0,
                    help="the backwards' tiles a CTA a chunk (fused_neus.RAYS_PER_CTA_CHUNK)")
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
    if a.chunk:
        fn.RAYS_PER_CTA_CHUNK = a.chunk
    tag = "".join(f"_{d.lower()}" for d in defs)
    if defs:
        timed = fn.type_tc(_build.load_variant("fused_neus_ray_tc" + tag, "fused_neus_ray_tc.cu", defs))
        fn._tc_lib = lambda: timed
    want = ("b1", "b3", "b6", "b6f", "b7b") if "all" in a.kernel else a.kernel
    makers = {"b1": lambda: b1_problem(a.rays, dev), "b3": lambda: b3_problem(dev),
              "b6": lambda: b6_problem(dev), "b6f": lambda: b6f_problem(dev),
              "b7b": lambda: b7b_problem(dev)}
    problems = []
    for k in want:
        prob = makers[k]()
        for i, (name, slot, call) in enumerate(prob["calls"]):
            med, lo, hi = median_ms(call, a.reps)
            print(f"[profile] {name}, {prob['shape']}, 4x256 / 2x256, bf16"
                  f"{' ' + ','.join(defs) if defs else ''}{f' chunk {a.chunk}' if a.chunk else ''}: "
                  f"median {med:.3f} ms over {a.reps} calls (range {lo:.3f}-{hi:.3f})")
            if "backward" in name:  # the phases split the per-tile kernel's device time
                by_kernel = kernel_times(name.split(" (")[0], call)
                med = sum(ms for k, ms in by_kernel.items() if "bwd_kernel" in k) or med
            prob["calls"][i] = (name, slot, call, med)
        problems.append(prob)
    if a.no_phases:
        print_build("fused_neus_ray_tc" + tag)
        print(f"[profile] device {smi}")
        return
    lib = fn.type_tc(_build.load_variant("fused_neus_ray_tc_prof" + tag, "fused_neus_ray_tc.cu",
                                         ("NEUS_TC_PROF",) + defs))
    for name in ("fused_neus_ray_tc" + tag, "fused_neus_ray_tc_prof" + tag):
        print_build(name)
    lib.neus_tc_phases.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    base = fn._tc_lib
    fn._tc_lib = lambda: lib
    try:
        for prob in problems:
            for name, slot, call, med in prob["calls"]:
                call()
                torch.cuda.synchronize()
                phases(lib, name, slot, prob["ctas"], med)
    finally:
        fn._tc_lib = base
    print(f"[profile] device {smi}")


if __name__ == "__main__":
    main()
