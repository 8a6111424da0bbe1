"""Time the animate steps on the card: PoseOptimizer (one soft render of 5
views x 224^2 a step) and MotionOptimizer (2 strided frames x 224^2), on
the 13,776-face procedural body with CLIP ViT-B/32, VPoser and the motion
VAE at their widths (seeded random weights where no checkpoint exists).

    python3 avatarclip_torch/tools/profile_animate.py [--root DIR] [--steps 20]

Run as a script from the root of a checkout on a CUDA card. ``--root DIR``
imports ``avatarclip_torch`` from another checkout (a parent commit
unpacked into an ignored directory) instead of this one, so that two
versions can be run in turns in one call (parent, change, change, parent).
For each step kind it runs 3 warm-up steps (the first builds the kernels),
then ``--steps`` steps each ended by a synchronise, and prints their
median wall time; then 5 steps under torch.profiler: the device's busy
time by kernel, its share of the window's wall time, and the share of the
busy time in the soft aggregation's kernels (names with ``soft_``). One
JSON line per run, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

TEXT = "a rendered 3d man is arguing"


def _profile(step, n: int = 5) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    dev = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
        if t > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev.append((t / 1e3 / n, e.key))
    busy = sum(t for t, _ in dev)
    soft = sum(t for t, k in dev if "soft_" in k)
    dev.sort(reverse=True)
    return {"profiled_wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall if busy else None,
            "soft_ms": soft, "soft_share_of_busy": soft / busy if busy else None,
            "top": [[k[:60], t] for t, k in dev[:6]]}


def _time(step, n: int) -> dict:
    import torch

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(times), "min_ms": min(times), "max_ms": max(times),
            **_profile(step)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import avatarclip_torch
    from avatarclip_torch import assets
    from avatarclip_torch.pipelines import animate, synthetic

    if not torch.cuda.is_available():
        raise SystemExit("profile_animate: needs a CUDA device")
    if not os.path.abspath(avatarclip_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"avatarclip_torch came from {avatarclip_torch.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as data:
        v, f = assets._procedural_humanoid(n_seg=41, n_ring=28)
        synthetic.write_template_obj(data, v, f)
        os.environ["AVATARCLIP_TPU_DATA"] = data
        assets.load_smpl.cache_clear()
        ctx = animate.AnimateContext(device="cuda")
        if ctx.faces.shape[0] != f.shape[0]:
            raise SystemExit(f"posed {ctx.faces.shape[0]} faces, not the written body's {f.shape[0]}")
        tf = ctx.get_text_feature(TEXT)
        gen = animate.build_pose_generator({"type": "PoseOptimizer", "topk": 1, "num_iteration": 1}, ctx=ctx)
        var = gen.draw_init().to(ctx.device).requires_grad_(True)
        opt = gen.make_optimizer(var)
        pose = _time(lambda: gen.step(var, opt, tf, gen.draw_step()), args.steps)
        mgen = animate.build_motion_generator({"type": "MotionOptimizer", "num_iteration": 1}, ctx=ctx)
        p63 = torch.from_numpy(np.random.default_rng(0).normal(0.0, 0.2, (5, 63)).astype(np.float32)).to(ctx.device)
        lat = mgen.draw_init().to(ctx.device).requires_grad_(True)
        mopt = torch.optim.Adam([lat], lr=0.01)
        motion = _time(lambda: mgen.step(lat, mopt, p63, tf, mgen.draw_step()), args.steps)
    print(json.dumps({"root": args.root, "device": smi, "steps": args.steps,
                      "pose_step": pose, "motion_step": motion}))


if __name__ == "__main__":
    main()
