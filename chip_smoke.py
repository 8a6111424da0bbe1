#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (avatarclip_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU or to a
kernel's plain version):
  1. the device: a CUDA card must be present; prints nvidia-smi's name and
     power limit;
  2. builds the CUDA kernels from avatarclip_torch/csrc (nvcc, sm_90a) and
     prints the build seconds;
  3. holds each kernel against its plain PyTorch version on the card (the
     tiled z-buffer on the template at 256^2 and 128^2 and on a random
     triangle soup, exactly but for near-ties; the NeuS megakernel pair
     forward and backward at 256 and 128 wide on 2,048 rays x 64 samples,
     against the plain version evaluated in float64, outputs to 1e-4 and
     gradients to 1e-3 of their largest magnitude) and times kernel and plain version
     at the main path's shapes (12,544 rays x 64 samples, 4x256 / 2x256 nets;
     a 256^2 template raster);
  4. runs the main path: ``avatarclip_torch.pipelines.appearance.main`` with
     ``--mode train_clip`` for 8 steps on the full-width synthetic conf, and
     checks the losses, the kernel launch counts and the steps taken.
Prints a {"kernels": [...]} JSON line, then as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_STEPS = 8
NEAR_TIE = 1e-6  # relative inverse-depth gap under which two winners may differ
OUT_TOL = 1e-4  # NeuS outputs, relative to the output's largest magnitude
GRAD_TOL = 1e-3  # NeuS gradients (f32 sums over 131k points), same measure


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max |b|)."""
    err = float((a.float() - b.float()).abs().max())
    return err, err / max(float(b.float().abs().max()), 1e-12)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds of fn() on the card (one warm-up, CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# B2: the tiled z-buffer
# ---------------------------------------------------------------------------


def check_zbuffer(runner, dev):
    import numpy as np
    import torch

    from avatarclip_torch.ops import raster_zbuffer as rz
    from avatarclip_torch.render import raster

    template_v, faces = runner._template
    ds = runner.dataset
    cases = []
    for it in (0, 1, 2):  # a face camera and two full-body cameras
        cam, _ = runner.sample_iteration_camera(it, (256,))
        pose = torch.as_tensor(cam["pose"], device=dev)
        for res in (256, 128):
            cases.append((f"template {res}^2 it{it}", template_v, faces, pose, res,
                          ds.focal * res / ds.W))
    g = np.random.default_rng(0)
    soup_v = torch.as_tensor(g.normal(0.0, 0.4, (600, 3)).astype(np.float32), device=dev)
    soup_f = torch.as_tensor(g.integers(0, 600, (2000, 3)), device=dev)
    eye = np.array([0.05, -0.1, 1.6], np.float32)
    soup_pose = torch.as_tensor(runner_lookat(eye), device=dev)
    cases.append(("triangle soup 200x232", soup_v, soup_f, soup_pose, (200, 232), 180.0))

    worst = 0.0  # largest inverse-depth gap between differing winners
    for name, v, f, pose, res, focal in cases:
        H, W = (res, res) if isinstance(res, int) else res
        proj = raster.project_vertices(v, pose, H, W, focal)
        coef, valid = raster._face_coefficients(proj, f)
        args = (coef, valid, proj.sx[f], proj.sy[f], H, W)
        got = rz.zbuffer_select_tiled(*args)
        want = rz.zbuffer_select_tiled_plain(*args)
        torch.cuda.synchronize()
        diff = (got != want).nonzero().flatten()
        if diff.numel():
            # only near-ties may differ: both faces cover the pixel and their
            # inverse depths agree to NEAR_TIE
            px, py = (diff % W).float(), (diff // W).float()
            if (got[diff] < 0).any() or (want[diff] < 0).any():
                fail(f"z-buffer {name}: coverage differs at {diff.numel()} pixels")
            izs = [rz.lin3(px, py, coef[i.long(), 0, 3], coef[i.long(), 1, 3], coef[i.long(), 2, 3])
                   for i in (got[diff], want[diff])]
            gap = (izs[0] - izs[1]).abs()
            if (gap > NEAR_TIE * izs[1].abs()).any():
                fail(f"z-buffer {name}: {diff.numel()} pixels differ beyond near-ties")
            worst = max(worst, float(gap.max()))
        print(f"[B2] {name}: {int((want >= 0).sum())} covered px, {diff.numel()} near-tie "
              f"differences, kernel == plain elsewhere")
    # time at the main path's GT raster: the template at 256^2
    cam, _ = runner.sample_iteration_camera(1, (256,))
    pose = torch.as_tensor(cam["pose"], device=dev)
    proj = raster.project_vertices(template_v, pose, 256, 256, ds.focal)
    coef, valid = raster._face_coefficients(proj, faces)
    args = (coef, valid, proj.sx[faces], proj.sy[faces], 256, 256)
    ms = cuda_ms(lambda: rz.zbuffer_select_tiled(*args), reps=20)
    plain_ms = cuda_ms(lambda: rz.zbuffer_select_tiled_plain(*args), reps=5)
    print(f"[B2] 256^2 template ({faces.shape[0]} faces): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "zbuffer_tiled", "route": "cuda",
            "source": "avatarclip_torch/csrc/raster_zbuffer.cu",
            "replaces": "avatarclip_tpu/ops/raster_zbuffer.py:266",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def runner_lookat(eye):
    import numpy as np

    from avatarclip_torch.render import cameras

    return cameras.lookat_np(eye, np.zeros(3, np.float32), np.array([0.0, 1.0, 0.0], np.float32))


# ---------------------------------------------------------------------------
# B1: the per-ray NeuS megakernel pair
# ---------------------------------------------------------------------------


def neus_problem(width: int, n_rays: int, dev, seed: int = 0):
    """Fields of the conf's shapes (4x256 / 2x256 at 256 wide, 3x128 / 1x128
    at 128 wide, extra colour head) with seeded, perturbed weights, and rays
    through the unit sphere with 64 sorted samples each. The nets are built
    without weight norm, so their parameters are the dense weights whose
    gradients the kernel computes (weight norm's chain rule is plain
    autograd outside the kernel and projects the dense gradient, which
    magnifies f32 summation-order noise)."""
    import torch

    from avatarclip_torch.fields import networks as nets

    g = torch.Generator().manual_seed(seed)
    if width == 256:
        s_cfg = nets.SDFConfig(d_out=257, d_hidden=256, n_layers=4, skip_in=(4,), multires=6,
                               weight_norm=False)
        c_cfg = nets.ColorConfig(d_feature=256, d_hidden=256, n_layers=2, extra_color=True,
                                 weight_norm=False)
    else:
        s_cfg = nets.SDFConfig(d_out=129, d_hidden=128, n_layers=3, skip_in=(3,), multires=6,
                               weight_norm=False)
        c_cfg = nets.ColorConfig(d_feature=128, d_hidden=128, n_layers=1, extra_color=True,
                                 weight_norm=False)
    fields = nets.NeuSFields(s_cfg, c_cfg, 0.3, g)
    with torch.no_grad():
        for p in fields.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    fields = fields.to(dev)
    S = 64
    eye = torch.tensor([0.0, 0.2, 2.2])
    tgt = 0.5 * (torch.rand(n_rays, 3, generator=g) - 0.5)
    rays_d = tgt - eye
    rays_d = rays_d / rays_d.norm(dim=-1, keepdim=True)
    rays_o = eye.expand(n_rays, 3).clone()
    z = torch.linspace(1.2, 3.2, S)[None] + 0.02 * torch.rand(n_rays, S, generator=g)
    z, _ = torch.sort(z, -1)
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full((n_rays, 1), 2.0 / 32)], -1)
    mid = z + dists * 0.5
    # positive cotangents, coherent across rays as a loss's are: with
    # random-sign ones a weight gradient is a random walk over 131k points,
    # and one ReLU of the colour net flipping between f32 and f64 moves it by
    # ~1/sqrt(131k) of its size
    probes = [0.5 + torch.rand(n_rays, 6, generator=g), 0.5 + torch.rand(n_rays, 3, generator=g),
              0.5 + torch.rand(n_rays, 1, generator=g), 0.5 + torch.rand((), generator=g)]
    return fields, [t.to(dev) for t in (rays_o, rays_d, mid, dists)], [t.to(dev) for t in probes]


def neus_loss(fn, fields, inputs, probes, cos_r=0.4):
    col, nw, ws, ge = fn(fields.sdf, fields.color, *inputs, fields.variance.inv_s(), cos_r)
    loss = (col * probes[0]).sum() + (nw * probes[1]).sum() + (ws * probes[2]).sum() + ge * probes[3]
    return (col, nw, ws, ge), loss


def neus_grads(fn, fields, inputs, probes):
    import torch

    ins = [t.clone().requires_grad_(True) for t in inputs]
    outs, loss = neus_loss(fn, fields, ins, probes)
    params = list(fields.parameters())
    grads = torch.autograd.grad(loss, params + ins)
    return [o.detach() for o in outs], grads


def check_neus(dev):
    import torch

    from avatarclip_torch.ops import fused_neus as fn

    worst_f, worst_b = 0.0, 0.0
    for width in (256, 128):
        fields, inputs, probes = neus_problem(width, 2048, dev)
        outs_k, grads_k = neus_grads(fn.point_eval_ray, fields, inputs, probes)
        outs_p, grads_p = neus_grads(fn.point_eval_ray_plain, fields, inputs, probes)
        # the plain version in float64 on the same (f32-valued) inputs is the
        # reference: it tells summation-order noise of either f32 side apart
        f64 = copy.deepcopy(fields).double()
        outs_r, grads_r = neus_grads(fn.point_eval_ray_plain, f64, [t.double() for t in inputs],
                                     [p.double() for p in probes])
        torch.cuda.synchronize()
        names = [n for n, _ in fields.named_parameters()] + ["rays_o", "rays_d", "mid_z", "dists"]
        rel_f = rel_b = rel_pb = 0.0
        for nm, a, b in zip(("colorW", "normals_w", "weight_sum", "gradient_error"), outs_k, outs_r):
            err, rel = rel_err(a, b)
            if not rel <= OUT_TOL or not torch.isfinite(a).all():
                fail(f"NeuS forward {width}-wide {nm}: rel err {rel:.2e} > {OUT_TOL}")
            worst_f, rel_f = max(worst_f, err), max(rel_f, rel)
        for nm, a, p, b in zip(names, grads_k, grads_p, grads_r):
            err, rel = rel_err(a, b)
            if not rel <= GRAD_TOL or not torch.isfinite(a).all():
                fail(f"NeuS backward {width}-wide d/d {nm}: rel err {rel:.2e} > {GRAD_TOL}")
            worst_b, rel_b = max(worst_b, err), max(rel_b, rel)
            rel_pb = max(rel_pb, rel_err(p, b)[1])
        rel_pf = max(rel_err(p, b)[1] for p, b in zip(outs_p, outs_r))
        print(f"[B1] {width}-wide, 2048 rays x 64 samples vs the plain version in f64: forward "
              f"and all {len(names)} gradients within tolerance; worst relative err kernel "
              f"fwd {rel_f:.3e} bwd {rel_b:.3e}, plain f32 fwd {rel_pf:.3e} bwd {rel_pb:.3e}; "
              f"kernel max abs err fwd {worst_f:.3e}, bwd {worst_b:.3e}")
        del f64, outs_r, grads_r

    # time at the main path's shapes: 12,544 rays x 64 samples, 4x256 / 2x256
    fields, inputs, probes = neus_problem(256, 12544, dev, seed=1)
    times = {}
    for name, f in (("kernel", fn.point_eval_ray), ("plain", fn.point_eval_ray_plain)):
        fwd_ms = cuda_ms(lambda: neus_loss(f, fields, inputs, probes), reps=3)
        bwd_total = 0.0
        for _ in range(3):
            ins = [t.clone().requires_grad_(True) for t in inputs]
            _, loss = neus_loss(f, fields, ins, probes)
            torch.cuda.synchronize()
            bwd_total += cuda_ms_once(lambda: torch.autograd.grad(loss, list(fields.parameters()) + ins))
        times[name] = (fwd_ms, bwd_total / 3)
        del ins, loss
        torch.cuda.empty_cache()
    print(f"[B1] 12544 rays x 64 samples, 4x256/2x256: forward kernel {times['kernel'][0]:.3f} ms "
          f"(plain {times['plain'][0]:.3f} ms); backward kernel {times['kernel'][1]:.3f} ms "
          f"(plain {times['plain'][1]:.3f} ms)")
    common = {"route": "cuda", "source": "avatarclip_torch/csrc/fused_neus_ray.cu"}
    return [
        {"name": "neus_ray_fwd", **common, "replaces": "avatarclip_tpu/ops/fused_neus.py:403",
         "max_abs_err": worst_f, "ms": times["kernel"][0], "plain_ms": times["plain"][0]},
        {"name": "neus_ray_bwd", **common, "replaces": "avatarclip_tpu/ops/fused_neus.py:620",
         "max_abs_err": worst_b, "ms": times["kernel"][1], "plain_ms": times["plain"][1]},
    ]


def cuda_ms_once(fn) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def run_main_path(tmp: str):
    import torch

    from avatarclip_torch.ops import fused_neus, raster_zbuffer
    from avatarclip_torch.pipelines import appearance, synthetic

    data = synthetic.write_synthetic_views(os.path.join(tmp, "views"), n_views=4, res=256)
    conf_path = os.path.join(tmp, "full.conf")
    with open(conf_path, "w") as f:
        f.write(synthetic.make_conf_text(os.path.join(tmp, "exp"), data, "full"))
    argv = ["--mode", "train_clip", "--conf", conf_path, "--set", f"train.end_iter={N_STEPS}"]
    for k in raster_zbuffer.LAUNCHES:
        raster_zbuffer.LAUNCHES[k] = 0
    for k in fused_neus.LAUNCHES:
        fused_neus.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    runner = appearance.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**raster_zbuffer.LAUNCHES, **fused_neus.LAUNCHES}

    if runner.iter_step != N_STEPS:
        fail(f"main path took {runner.iter_step} steps, expected {N_STEPS}")
    with open(os.path.join(tmp, "exp", "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != N_STEPS:
        fail(f"{len(recs)} metric records for {N_STEPS} steps")
    for r in recs:
        bad = [k for k, v in r.items() if not math.isfinite(v)]
        if bad:
            fail(f"step {r['step']}: non-finite {bad}")
    n_calib = 12 * 4 + 2  # coverage renders of the silhouette calibration
    want = {"neus_ray_fwd": N_STEPS, "neus_ray_bwd": N_STEPS, "zbuffer_tiled": N_STEPS + n_calib}
    if launches != want:
        fail(f"kernel launches {launches}, expected {want}")
    faces = [it for it in range(N_STEPS) if it % 4 == 0]
    if len(set(runner.step_sil_res)) < 2:
        fail(f"only one silhouette bucket used: {runner.step_sil_res}")
    median = statistics.median(runner.step_seconds[1:])
    print(f"[main] train_clip via appearance.main: {N_STEPS} steps in {wall:.3f} s, buckets "
          f"{runner.step_sil_res}, face-camera steps {faces}, launches {launches}")
    print(f"[main] losses finite; loss by step {[round(r['loss'], 6) for r in recs]}")
    print(f"[main] median step time excluding the first: {median * 1e3:.3f} ms "
          f"(first step {runner.step_seconds[0] * 1e3:.3f} ms)")
    return launches


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "avatarclip_torch", "csrc")):
        fail(f"no avatarclip_torch/csrc next to {__file__}: run from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}")
    dev = torch.device("cuda:0")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from avatarclip_torch.ops import _build, fused_neus

    t0 = time.perf_counter()
    _build.load("raster_zbuffer", "raster_zbuffer.cu")
    fused_neus._lib()
    print(f"[build] {time.perf_counter() - t0:.3f} s ({_build.build_seconds})")
    for name in ("raster_zbuffer", "fused_neus_ray"):
        log = (_build.BUILD / f"{name}.log")
        if log.exists():
            info = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln]
            print(f"[build] {name}: " + " | ".join(info[:6]))

    from avatarclip_torch.pipelines import synthetic

    with tempfile.TemporaryDirectory() as tmp:
        runner = synthetic.make_runner(os.path.join(tmp, "probe"), "full", res=256, device=dev)
        runner.init_smpl()
        kernels = [check_zbuffer(runner, dev)]
        del runner
        kernels += check_neus(dev)
        torch.cuda.empty_cache()
        launches = run_main_path(tmp)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
