"""Time the hard z-buffer's entry (``raster_zbuffer.zbuffer_select_tiled``,
B2, or with ``--brute`` the brute-force ``zbuffer_select``, #15) on the card
at the shapes the paths give it: the train_clip GT render (the template at
256^2), an animate scoring view (the 13,776-face body at 224^2),
visualize's 512^2 picture of that body, and a ShapeGen render (the
13,441-face body at 256^2).

    python3 avatarclip_torch/tools/profile_zbuffer.py [--root DIR] [--reps 200] [--brute]

Run as a script from the root of a checkout on a CUDA card. ``--root DIR``
imports ``avatarclip_torch`` from another checkout (a commit unpacked into
an ignored directory; it must have ``pipelines/synthetic.zbuffer_scenes``,
the scenes chip_smoke times too) instead of this one, so that two versions
can be run in turns in one call (parent, change, change, parent). For each
scene: the winners against the plain version (pixels that differ), the
mean time of a call over ``--reps`` calls by CUDA events after a warm-up,
and, under torch.profiler over 20 calls, the device time a call and the
device kernels a call (the entry's own launches and any torch ops it
makes). One JSON line per scene, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def _device_ms(fn, n: int = 20) -> tuple[float, float]:
    """(device ms a call, device kernels a call) under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
        if t > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            total += t
            count += e.count
    return total / 1e3 / n, count / n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--brute", action="store_true", help="time #15 instead of B2")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_zbuffer: needs a CUDA card")
    from avatarclip_torch.ops import raster_zbuffer as rz
    from avatarclip_torch.pipelines import synthetic
    from avatarclip_torch.render import raster

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as tmp:
        runner = synthetic.make_runner(os.path.join(tmp, "probe"), "full", res=256, device=dev)
        runner.init_smpl()
        scenes = synthetic.zbuffer_scenes(runner, dev)
    for name, (v, f, pose, res, focal) in scenes.items():
        proj = raster.project_vertices(v, pose, res, res, focal)
        coef, valid, _ = raster._face_coefficients(proj, f)
        sx, sy = proj.sx[f], proj.sy[f]

        def call():
            if args.brute:
                return rz.zbuffer_select(coef, valid, res, res)
            return rz.zbuffer_select_tiled(coef, valid, sx, sy, res, res)

        got = call()
        differ = int((got != rz.zbuffer_select_plain(coef, valid, res, res)).sum())
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            call()
        end.record()
        torch.cuda.synchronize()
        dev_ms, kernels = _device_ms(call)
        print(json.dumps({"root": os.path.abspath(args.root),
                          "kernel": "zbuffer_brute" if args.brute else "zbuffer_tiled", "scene": name, "faces": int(f.shape[0]), "res": res,
                          "pixels_differing_from_plain": differ,
                          "entry_ms": start.elapsed_time(end) / args.reps, "device_ms": dev_ms,
                          "device_kernels_a_call": kernels, "device": smi}), flush=True)


if __name__ == "__main__":
    main()
