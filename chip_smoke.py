#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (avatarclip_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py                  # everything below
    python3 chip_smoke.py --kernels-only   # phases 1-3 (build, check, time);
                                           # launches print as null

Phases (any failure exits non-zero; nothing falls back to the CPU or to a
kernel's plain version):
  1. the device: a CUDA card must be present; prints nvidia-smi's name and
     power limit;
  2. builds the CUDA kernels from avatarclip_torch/csrc (one nvcc per
     library for sm_90a, all at once) and the host marching-cubes library
     (g++), and prints the build seconds;
  3. holds each kernel against its plain PyTorch version on the card and
     times both at the main path's shapes:
     - B2, the tiled z-buffer: the template at 256^2 and 128^2 and a random
       triangle soup, exactly but for near-ties; timed on the 256^2 template;
     - B1, the per-ray NeuS pair, and B3, the point-level NeuS pair: forward
       and backward at 256 and 128 wide on 2,048 rays x 64 samples against
       the plain version evaluated in float64, outputs to 1e-4 and gradients
       to 1e-3 of their largest magnitude; B3's forward also under no_grad
       at the validation chunk of 16,384 rays x 64 and at a ragged 16,347
       (4x256 / 2x256 nets); B1 timed at the training step's 12,544 rays x
       64, B3 at 16,384 rays x 64;
     - B4, the compositing pair: rgb width 6 and 3 on 2,048 rays x 64 against
       float64, same tolerances, and its forward under no_grad at 16,384 and
       16,347 rays; timed at 16,384 rays x 64;
     each kernel's bound is max(FLOPs / peak, bytes / 3.35 TB/s) for the
     work of that call (f32 CUDA-core peak 67 TFLOP/s, the type the kernels
     compute in; the bf16 tensor-core bound at 989 TFLOP/s is printed too);
  4. fits the full-width SDF to the template body and writes it as the
     conf's ``train.pretrain`` (the confs start from a NeuS pretrained on
     the template, which the repo does not ship; an untrained net's meshes
     are many times denser than an avatar's), then runs the main path
     through ``avatarclip_torch.pipelines.appearance.main`` on the
     full-width synthetic conf (60 views) with that pretrain, each path with
     the launch counts set to 0 just before it and read just after:
     a. ``--mode train_clip`` for 8 steps with val_freq = val_mesh_freq =
        save_freq = 8 (asynchronous validation on, as in the confs): step 8
        validates an image (camera 58), extracts and bakes a 256^3 mesh and
        saves a checkpoint;
     b. ``--mode validate_mesh --is_continue``: the 512^3 extraction with
        its colour baking, then the cast-light head render;
     and checks the losses, the artifacts, and the launch counts against the
     chunk counts predicted from the ray counts.
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
N_VIEWS = 60  # train_clip validates camera 58
NEAR_TIE = 1e-6  # relative inverse-depth gap under which two winners may differ
OUT_TOL = 1e-4  # kernel outputs, relative to the output's largest magnitude
GRAD_TOL = 1e-3  # kernel gradients (f32 sums over 131k points), same measure
PEAK_F32 = 67e12  # H100 SXM, FLOP/s outside the tensor cores
PEAK_BF16 = 989e12  # H100 SXM, dense bf16 tensor cores
HBM = 3.35e12  # bytes/s
VAL_CHUNK = 16384  # render_rays_chunked's chunk: max(batch_size, 16384)
PRETRAIN_L1 = 0.05  # the template fit's last mean |sdf - target| (CPU fits end near 0.02)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max |b|)."""
    a, b = a.detach().float(), b.detach().float()
    err = float((a - b).abs().max())
    return err, err / max(float(b.abs().max()), 1e-12)


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


def cuda_ms_once(fn) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: max(FLOPs / f32 peak, bytes / HBM
    rate), which of the two bounds it, and the FLOPs bound at the bf16
    tensor-core peak."""
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / HBM * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "bound_ms_bf16_tc": flops / PEAK_BF16 * 1e3}


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
    sx, sy = proj.sx[faces], proj.sy[faces]
    args = (coef, valid, sx, sy, 256, 256)
    ms = cuda_ms(lambda: rz.zbuffer_select_tiled(*args), reps=20)
    plain_ms = cuda_ms(lambda: rz.zbuffer_select_tiled_plain(*args), reps=5)
    # the work this image needs: every (pixel, valid face) pair inside the
    # face's screen bbox gets 3 edge tests and an inverse depth (~17 FLOPs)
    nx = (sx.amax(1).clamp(0, 255).floor() - sx.amin(1).clamp(0, 255).ceil() + 1).clamp_min(0)
    ny = (sy.amax(1).clamp(0, 255).floor() - sy.amin(1).clamp(0, 255).ceil() + 1).clamp_min(0)
    pairs = float((nx * ny * valid.float()).sum())
    F = faces.shape[0]
    b = bound(17.0 * pairs, F * (48 + 4 + 24) + 256 * 256 * 4)
    print(f"[B2] 256^2 template ({F} faces, {pairs:.0f} bbox pixel-face pairs): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.5f} ms ({b['bound_by']})")
    return {"name": "zbuffer_tiled", "route": "cuda",
            "source": "avatarclip_torch/csrc/raster_zbuffer.cu",
            "replaces": "avatarclip_tpu/ops/raster_zbuffer.py:266",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **b}


def runner_lookat(eye):
    import numpy as np

    from avatarclip_torch.render import cameras

    return cameras.lookat_np(eye, np.zeros(3, np.float32), np.array([0.0, 1.0, 0.0], np.float32))


# ---------------------------------------------------------------------------
# B1 and B3: the NeuS megakernel pairs
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
    P = n_rays * S
    probes = [0.5 + torch.rand(n_rays, 6, generator=g), 0.5 + torch.rand(n_rays, 3, generator=g),
              0.5 + torch.rand(n_rays, 1, generator=g), 0.5 + torch.rand((), generator=g)]
    point_probes = [0.5 + torch.rand(P, k, generator=g) for k in (1, 3, 6)]
    point_probes += [0.5 + torch.rand(P, generator=g) for _ in range(2)]
    point_probes.append(0.5 + torch.rand((), generator=g))
    return (fields, [t.to(dev) for t in (rays_o, rays_d, mid, dists)],
            [t.to(dev) for t in probes], [t.to(dev) for t in point_probes])


def neus_gemm_flops(spec) -> tuple[float, float]:
    """(forward, backward) GEMM FLOPs per point of the NeuS kernel pairs, from
    the network dims (the elementwise work, ~1-2% more, is not counted). The
    forward: SDF stack, the spatial-gradient reverse sweep, the colour MLP.
    The backward: SDF and colour primal stacks again (the gradient comes back
    as a residual), the colour reverse and the forward-over-reverse SDF pass."""
    d = spec.dims()
    E, H, NH, SW, F1, CW, HC, NHC, W = d.E, d.H, d.NH, d.SW, 1 + d.F, d.CW, d.HC, d.NHC, d.W
    sdf_fwd = 2 * E * H + (NH - 1) * 2 * H * H + 2 * H * SW + 2 * H * F1
    sweep = 2 * SW * H + (NH - 1) * 2 * H * H + 2 * H * E
    col_fwd = 2 * CW * HC + (NHC - 1) * 2 * HC * HC + 2 * HC * W
    col_rev = 4 * HC * W + (NHC - 1) * 4 * HC * HC + 4 * HC * CW
    sdf_rev = (2 * E * H + (NH - 1) * 2 * H * H + 2 * H * SW  # tangent forward
               + 4 * F1 * H + 8 * SW * H + 8 * H * E + (NH - 1) * 8 * H * H)
    return float(sdf_fwd + sweep + col_fwd), float(sdf_fwd + col_fwd + col_rev + sdf_rev)


def neus_grads(fn, fields, inputs, probes, n_out):
    """Outputs and gradients (parameters, then inputs) of sum(probe * out)."""
    import torch

    ins = [t.clone().requires_grad_(True) for t in inputs]
    outs = fn(fields.sdf, fields.color, *ins, fields.variance.inv_s(), 0.4)
    used = [o for i, o in enumerate(outs) if i in n_out]
    loss = sum((o * p).sum() for o, p in zip(used, probes))
    grads = torch.autograd.grad(loss, list(fields.parameters()) + ins)
    return [o.detach() for o in used], grads


def hold_against_f64(tag, kernel_fn, plain_fn, out_names, n_out, probe_idx, dev):
    """The kernel vs the plain version in f64 (and the plain version in f32
    beside it) at 256 and 128 wide on 2,048 rays x 64 samples."""
    import torch

    worst_f = worst_b = 0.0
    for width in (256, 128):
        fields, inputs, probes, point_probes = neus_problem(width, 2048, dev)
        probes = probes if probe_idx == "ray" else point_probes
        outs_k, grads_k = neus_grads(kernel_fn, fields, inputs, probes, n_out)
        outs_p, grads_p = neus_grads(plain_fn, fields, inputs, probes, n_out)
        # the plain version in float64 on the same (f32-valued) inputs is the
        # reference: it tells summation-order noise of either f32 side apart
        f64 = copy.deepcopy(fields).double()
        outs_r, grads_r = neus_grads(plain_fn, f64, [t.double() for t in inputs],
                                     [p.double() for p in probes], n_out)
        torch.cuda.synchronize()
        names = [n for n, _ in fields.named_parameters()] + ["rays_o", "rays_d", "mid_z", "dists"]
        rel_f = rel_b = rel_pb = 0.0
        for nm, a, b in zip(out_names, outs_k, outs_r):
            err, rel = rel_err(a, b.reshape(a.shape))
            if not rel <= OUT_TOL or not torch.isfinite(a).all():
                fail(f"{tag} forward {width}-wide {nm}: rel err {rel:.2e} > {OUT_TOL}")
            worst_f, rel_f = max(worst_f, err), max(rel_f, rel)
        for nm, a, p, b in zip(names, grads_k, grads_p, grads_r):
            err, rel = rel_err(a, b)
            if not rel <= GRAD_TOL or not torch.isfinite(a).all():
                fail(f"{tag} backward {width}-wide d/d {nm}: rel err {rel:.2e} > {GRAD_TOL}")
            worst_b, rel_b = max(worst_b, err), max(rel_b, rel)
            rel_pb = max(rel_pb, rel_err(p, b)[1])
        rel_pf = max(rel_err(p, b.reshape(p.shape))[1] for p, b in zip(outs_p, outs_r))
        print(f"[{tag}] {width}-wide, 2048 rays x 64 samples vs the plain version in f64: forward "
              f"and all {len(names)} gradients within tolerance; worst relative err kernel "
              f"fwd {rel_f:.3e} bwd {rel_b:.3e}, plain f32 fwd {rel_pf:.3e} bwd {rel_pb:.3e}; "
              f"kernel max abs err fwd {worst_f:.3e}, bwd {worst_b:.3e}")
        del f64, outs_r, grads_r
        torch.cuda.empty_cache()
    return worst_f, worst_b


def check_neus_ray(dev):
    import torch

    from avatarclip_torch.ops import fused_neus as fn

    worst_f, worst_b = hold_against_f64(
        "B1", fn.point_eval_ray, fn.point_eval_ray_plain,
        ("colorW", "normals_w", "weight_sum", "gradient_error"), (0, 1, 2, 3), "ray", dev)

    # time at the main path's shapes: 12,544 rays x 64 samples, 4x256 / 2x256
    R = 12544
    fields, inputs, probes, _ = neus_problem(256, R, dev, seed=1)
    times = {}
    for name, f in (("kernel", fn.point_eval_ray), ("plain", fn.point_eval_ray_plain)):
        fwd_ms = cuda_ms(lambda: neus_grads_loss(f, fields, inputs, probes), reps=3)
        bwd_total = 0.0
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            ins = [t.clone().requires_grad_(True) for t in inputs]
            loss = neus_grads_loss(f, fields, ins, probes)
            torch.cuda.synchronize()
            bwd_total += cuda_ms_once(lambda: torch.autograd.grad(loss, list(fields.parameters()) + ins))
        times[name] = (fwd_ms, bwd_total / 3, torch.cuda.max_memory_allocated() / 2**30)
        del ins, loss
        torch.cuda.empty_cache()
    spec = fn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, 64)
    P, n_w = R * 64, sum(t.numel() for t in fn.dense_weights(fields.sdf, fields.color))
    fl_f, fl_b = neus_gemm_flops(spec)
    Wd = spec.rgb_width
    b_f = bound(fl_f * P, 4 * (n_w + 6 * R + 2 * P + (Wd + 4) * R + 4 * P + 2))
    b_b = bound(fl_b * P, 4 * (n_w + 6 * R + 2 * P + 4 * P + (Wd + 4) * R + 2
                               + 6 * R + 2 * P + n_w + 1))
    print(f"[B1] {R} rays x 64 samples, 4x256/2x256: forward kernel {times['kernel'][0]:.3f} ms "
          f"(plain {times['plain'][0]:.3f} ms, bound {b_f['bound_ms']:.3f} ms {b_f['bound_by']}, "
          f"bf16 tensor-core bound {b_f['bound_ms_bf16_tc']:.3f} ms); backward kernel "
          f"{times['kernel'][1]:.3f} ms (plain {times['plain'][1]:.3f} ms, bound "
          f"{b_b['bound_ms']:.3f} ms {b_b['bound_by']}, bf16 {b_b['bound_ms_bf16_tc']:.3f} ms); "
          f"{fl_f:.0f} / {fl_b:.0f} GEMM FLOPs per point; peak memory kernel "
          f"{times['kernel'][2]:.2f} GiB, plain {times['plain'][2]:.2f} GiB")
    common = {"route": "cuda", "source": "avatarclip_torch/csrc/fused_neus_ray.cu",
              "library_ms": None}
    return [
        {"name": "neus_ray_fwd", **common, "replaces": "avatarclip_tpu/ops/fused_neus.py:403",
         "max_abs_err": worst_f, "ms": times["kernel"][0], "plain_ms": times["plain"][0], **b_f},
        {"name": "neus_ray_bwd", **common, "replaces": "avatarclip_tpu/ops/fused_neus.py:620",
         "max_abs_err": worst_b, "ms": times["kernel"][1], "plain_ms": times["plain"][1], **b_b},
    ]


def neus_grads_loss(fn, fields, inputs, probes):
    col, nw, ws, ge = fn(fields.sdf, fields.color, *inputs, fields.variance.inv_s(), 0.4)
    return (col * probes[0]).sum() + (nw * probes[1]).sum() + (ws * probes[2]).sum() + ge * probes[3]


def hold_point_fwd_at_chunk(fields, inputs) -> float:
    """B3 forward through its wrapper under no_grad, as validation runs it, at
    the main path's chunk (16,384 rays) and at a ragged last chunk (37 rays
    fewer), against the plain version in f64 (evaluated 4,096 rays at a
    time); the max abs error."""
    import torch

    from avatarclip_torch.ops import fused_neus as fn

    f64 = copy.deepcopy(fields).double()
    names = ("sdf", "grad", "rgb", "alpha", "cdf")
    worst = 0.0
    for R in (VAL_CHUNK, VAL_CHUNK - 37):
        ins = [t[:R].contiguous() for t in inputs]
        with torch.no_grad():
            got = fn.point_eval(fields.sdf, fields.color, *ins, fields.variance.inv_s(), 0.4)
            ref = [[] for _ in names]
            for a in range(0, R, 4096):
                part = fn.point_eval_plain(f64.sdf, f64.color, *[t[a:a + 4096].double() for t in ins],
                                           f64.variance.inv_s(), 0.4)
                for acc, t in zip(ref, part):
                    acc.append(t.detach())
            ref = [torch.cat(acc) for acc in ref]
            ro, rd, mid, _ = [t.double() for t in ins]
            r2 = ((ro[:, None] + rd[:, None] * mid[..., None]) ** 2).sum(-1).reshape(-1)
            relax = (r2 < 1.44).double()
            ge = (torch.sqrt((ref[1] ** 2).sum(-1) + 1e-12) - 1.0) ** 2
            ref.append((relax * ge).sum() / (relax.sum() + 1e-5))
        torch.cuda.synchronize()
        rels = []
        for nm, a, b in zip(names + ("gradient_error",), [got[i] for i in (0, 1, 2, 3, 4, 6)], ref):
            err, rel = rel_err(a, b.reshape(a.shape))
            if not rel <= OUT_TOL or not torch.isfinite(a).all():
                fail(f"B3 forward at {R} rays x 64, {nm}: rel err {rel:.2e} > {OUT_TOL}")
            worst = max(worst, err)
            rels.append(rel)
        print(f"[B3] forward under no_grad at {R} rays x 64 samples, 4x256/2x256, vs the plain "
              f"version in f64: worst relative err {max(rels):.3e}, max abs err {worst:.3e}")
        del got, ref
    del f64
    torch.cuda.empty_cache()
    return worst


def check_neus_point(dev):
    import torch

    from avatarclip_torch.ops import fused_neus as fn

    worst_f, worst_b = hold_against_f64(
        "B3", fn.point_eval, fn.point_eval_plain,
        ("sdf", "grad", "rgb", "alpha", "cdf", "gradient_error"), (0, 1, 2, 3, 4, 6), "point", dev)

    R = VAL_CHUNK
    fields, inputs, _, probes = neus_problem(256, R, dev, seed=2)
    worst_f = max(worst_f, hold_point_fwd_at_chunk(fields, inputs))

    # time at the validation chunk: 16,384 rays x 64 samples, 4x256 / 2x256;
    # the kernels through their wrappers, the plain version forward under
    # no_grad (as validation runs) and its backward through autograd
    spec = fn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, 64)
    weights = [w.detach().contiguous() for w in fn.dense_weights(fields.sdf, fields.color)]
    flat = torch.cat([w.reshape(-1) for w in weights])
    inv_s = fields.variance.inv_s().detach().reshape(()).contiguous()
    ro, rd, mid, dists = [t.contiguous() for t in inputs]
    fwd = lambda: fn.neus_point_fwd(spec, flat, ro, rd, mid, dists, inv_s, 0.4)
    sdf_o, _, _, grad, _, _, _ = fwd()
    P = R * 64
    cots = [probes[0].reshape(P), probes[3], probes[4], probes[1], probes[2],
            torch.stack([probes[5], torch.zeros((), device=dev)])]
    bwd = lambda: fn.neus_point_bwd(spec, flat, ro, rd, mid, dists, inv_s, 0.4, sdf_o, grad, *cots)
    torch.cuda.reset_peak_memory_stats()
    ms_f, ms_b = cuda_ms(fwd, reps=5), cuda_ms(bwd, reps=3)
    mem_k = torch.cuda.max_memory_allocated() / 2**30
    del sdf_o, grad
    with torch.no_grad():
        plain_f = cuda_ms(lambda: fn.point_eval_plain(fields.sdf, fields.color, ro, rd, mid, dists,
                                                      inv_s, 0.4), reps=3)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain_b = 0.0
    for _ in range(2):
        ins = [t.clone().requires_grad_(True) for t in inputs]
        outs = fn.point_eval_plain(fields.sdf, fields.color, *ins, fields.variance.inv_s(), 0.4)
        used = [outs[i] for i in (0, 1, 2, 3, 4, 6)]
        loss = sum((o * p).sum() for o, p in zip(used, probes))
        torch.cuda.synchronize()
        plain_b += cuda_ms_once(lambda: torch.autograd.grad(loss, list(fields.parameters()) + ins))
        del ins, outs, used, loss
    plain_b /= 2
    mem_p = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    n_w, Wd = flat.numel(), spec.rgb_width
    fl_f, fl_b = neus_gemm_flops(spec)
    b_f = bound(fl_f * P, 4 * (n_w + 6 * R + 2 * P + (7 + Wd) * P + 2))
    b_b = bound(fl_b * P, 4 * (n_w + 6 * R + 2 * P + 4 * P + (6 + Wd) * P + 2
                               + 6 * R + 2 * P + n_w + 1))
    print(f"[B3] {R} rays x 64 samples, 4x256/2x256: forward kernel {ms_f:.3f} ms (plain "
          f"{plain_f:.3f} ms, bound {b_f['bound_ms']:.3f} ms {b_f['bound_by']}, bf16 tensor-core "
          f"bound {b_f['bound_ms_bf16_tc']:.3f} ms); backward kernel {ms_b:.3f} ms (plain "
          f"{plain_b:.3f} ms, bound {b_b['bound_ms']:.3f} ms {b_b['bound_by']}, bf16 "
          f"{b_b['bound_ms_bf16_tc']:.3f} ms); peak memory kernel {mem_k:.2f} GiB, plain "
          f"{mem_p:.2f} GiB")
    common = {"route": "cuda", "source": "avatarclip_torch/csrc/fused_neus_point.cu",
              "library_ms": None}
    return [
        {"name": "neus_point_fwd", **common, "replaces": "avatarclip_tpu/ops/fused_neus.py:258",
         "max_abs_err": worst_f, "ms": ms_f, "plain_ms": plain_f, **b_f},
        {"name": "neus_point_bwd", **common, "replaces": "avatarclip_tpu/ops/fused_neus.py:534",
         "max_abs_err": worst_b, "ms": ms_b, "plain_ms": plain_b, **b_b},
    ]


# ---------------------------------------------------------------------------
# B4: the compositing pair
# ---------------------------------------------------------------------------


def composite_problem(R, S, W, dev, seed=0):
    import torch

    g = torch.Generator().manual_seed(seed)
    alpha = 0.15 * torch.rand(R, S, generator=g)
    alpha[::7, 20] = 1.0  # opaque samples: transmittance exactly ~1e-7 past them
    ins = [alpha, torch.rand(R, S, W, generator=g), torch.randn(R, S, 3, generator=g)]
    cots = [0.5 + torch.rand(R, S, generator=g)] + [0.5 + torch.rand(R, 3, generator=g)
                                                      for _ in range(3)]
    return [t.to(dev) for t in ins], [t.to(dev) for t in cots]


def composite_grads(fn, ins, cots):
    import torch

    xs = [t.clone().requires_grad_(True) for t in ins]
    outs = fn(*xs)
    return [o.detach() for o in outs], torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(outs, cots)), xs)


def check_composite(dev):
    import torch

    from avatarclip_torch.ops import fused_composite as fc

    worst_f = worst_b = 0.0
    for W in (6, 3):
        ins, cots = composite_problem(2048, 64, W, dev, seed=W)
        ok, gk = composite_grads(fc.composite, ins, cots)
        orf, grf = composite_grads(fc.composite_plain, [t.double() for t in ins],
                                   [c.double() for c in cots])
        torch.cuda.synchronize()
        for nm, a, b in zip(("weights", "color", "extra", "normals_w"), ok, orf):
            err, rel = rel_err(a, b)
            if not rel <= OUT_TOL:
                fail(f"B4 forward W={W} {nm}: rel err {rel:.2e} > {OUT_TOL}")
            worst_f = max(worst_f, err)
        for nm, a, b in zip(("alpha", "rgb", "grad"), gk, grf):
            err, rel = rel_err(a, b)
            if not rel <= GRAD_TOL:
                fail(f"B4 backward W={W} d/d {nm}: rel err {rel:.2e} > {GRAD_TOL}")
            worst_b = max(worst_b, err)
        print(f"[B4] rgb width {W}, 2048 rays x 64 samples vs the plain version in f64: within "
              f"tolerance; max abs err fwd {worst_f:.3e}, bwd {worst_b:.3e}")
    # the forward alone under no_grad, as validation runs it, at the main
    # path's chunk and at a ragged last chunk (not a multiple of a warp group)
    for R, W in ((VAL_CHUNK, 6), (VAL_CHUNK - 37, 6), (VAL_CHUNK - 37, 3)):
        ins, _ = composite_problem(R, 64, W, dev, seed=R + W)
        with torch.no_grad():
            got = fc.composite(*ins)
            ref = fc.composite_plain(*[t.double() for t in ins])
        torch.cuda.synchronize()
        for nm, a, b in zip(("weights", "color", "extra", "normals_w"), got, ref):
            err, rel = rel_err(a, b)
            if not rel <= OUT_TOL:
                fail(f"B4 forward at {R} rays, W={W}, {nm}: rel err {rel:.2e} > {OUT_TOL}")
            worst_f = max(worst_f, err)
        print(f"[B4] forward under no_grad at {R} rays x 64 samples, rgb width {W}, vs the plain "
              f"version in f64: within tolerance; max abs err fwd {worst_f:.3e}")
    R, S, W = VAL_CHUNK, 64, 6
    ins, cots = composite_problem(R, S, W, dev, seed=1)
    cots = [c.contiguous() for c in cots]
    # the kernels alone: their C entry points on preallocated outputs (the
    # wrappers' checks and allocations cost more host time than the kernel
    # takes on the card, which events would count as idle gaps)
    from avatarclip_torch.ops import _build

    lib, p, st = fc._lib(), _build.ptr, _build.stream_ptr(dev)
    outs_f = [p(t) for t in fc.composite_fwd(*ins)]
    outs_b = [p(t) for t in fc.composite_bwd(*ins, *cots)]
    args = [p(t) for t in ins]
    ms_f = cuda_ms(lambda: lib.composite_fwd(R, S, W, *args, *outs_f, st), reps=50)
    ms_b = cuda_ms(lambda: lib.composite_bwd(R, S, W, *args, *[p(c) for c in cots], *outs_b, st),
                   reps=50)
    wrap_f = cuda_ms(lambda: fc.composite_fwd(*ins), reps=20)
    plain_f = cuda_ms(lambda: fc.composite_plain(*ins), reps=20)
    # the plain backward alone: the graph is built first, then each rep
    # times autograd's VJP with the kernel's cotangents
    xs = [t.clone().requires_grad_(True) for t in ins]
    outs = fc.composite_plain(*xs)
    torch.cuda.synchronize()
    plain_b = cuda_ms(lambda: torch.autograd.grad(outs, xs, cots, retain_graph=True), reps=10)
    del outs, xs
    P = R * S
    b_f = bound(P * (4 + 2 * (W + 3)), 4 * (P * (1 + W + 3) + P + 9 * R))
    b_b = bound(P * (13 + 3 * (W + 3)), 4 * (P * (2 + W + 3) + 9 * R + P * (1 + W + 3)))
    print(f"[B4] {R} rays x {S} samples, rgb width {W}: forward kernel {ms_f:.4f} ms (through "
          f"the wrapper {wrap_f:.4f} ms; plain {plain_f:.4f} ms, bound {b_f['bound_ms']:.4f} ms "
          f"{b_f['bound_by']}); backward kernel "
          f"{ms_b:.4f} ms (plain {plain_b:.4f} ms, bound "
          f"{b_b['bound_ms']:.4f} ms {b_b['bound_by']})")
    common = {"route": "cuda", "source": "avatarclip_torch/csrc/fused_composite.cu",
              "library_ms": None}
    return [
        {"name": "composite_fwd", **common, "replaces": "avatarclip_tpu/ops/fused_composite.py:73",
         "max_abs_err": worst_f, "ms": ms_f, "plain_ms": plain_f, **b_f},
        {"name": "composite_bwd", **common, "replaces": "avatarclip_tpu/ops/fused_composite.py:82",
         "max_abs_err": worst_b, "ms": ms_b, "plain_ms": plain_b, **b_b},
    ]


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def zero_counts():
    from avatarclip_torch.ops import fused_composite, fused_neus, raster_zbuffer

    for m in (fused_composite, fused_neus, raster_zbuffer):
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0


def read_counts() -> dict:
    from avatarclip_torch.ops import fused_composite, fused_neus, raster_zbuffer

    return {**raster_zbuffer.LAUNCHES, **fused_neus.LAUNCHES, **fused_composite.LAUNCHES}


def ply_counts(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        head = f.read(4096).split(b"end_header")[0].decode()
    nv = int(head.split("element vertex")[1].split()[0])
    nf = int(head.split("element face")[1].split()[0])
    return nv, nf


def check_png(path: str):
    from avatarclip_torch.utils.png import read_png

    if not os.path.exists(path):
        fail(f"missing {path}")
    img = read_png(path)
    if img.std() == 0:
        fail(f"{path} is one constant colour")
    return img.shape


def run_main_path(tmp: str, pretrain: str):
    import torch

    from avatarclip_torch.pipelines import appearance, synthetic

    data = synthetic.write_synthetic_views(os.path.join(tmp, "views"), n_views=N_VIEWS, res=256)
    conf_path = os.path.join(tmp, "full.conf")
    exp = os.path.join(tmp, "exp")
    with open(conf_path, "w") as f:
        f.write(synthetic.make_conf_text(exp, data, "full"))
    sets = [f"train.end_iter={N_STEPS}", f"train.val_freq={N_STEPS}",
            f"train.val_mesh_freq={N_STEPS}", f"train.save_freq={N_STEPS}",
            f"train.pretrain={pretrain}"]
    argv = ["--conf", conf_path] + [a for kv in sets for a in ("--set", kv)]

    # a. train_clip with the step-8 validations
    zero_counts()
    t0 = time.perf_counter()
    runner = appearance.main(["--mode", "train_clip"] + argv)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches_a = read_counts()
    if runner.iter_step != N_STEPS:
        fail(f"main path took {runner.iter_step} steps, expected {N_STEPS}")
    if not runner.tc.async_validation:
        fail("the conf's validations are not asynchronous")
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != N_STEPS:
        fail(f"{len(recs)} metric records for {N_STEPS} steps")
    for r in recs:
        bad = [k for k, v in r.items() if not math.isfinite(v)]
        if bad:
            fail(f"step {r['step']}: non-finite {bad}")
    if not os.path.exists(os.path.join(exp, "checkpoints", f"ckpt_{N_STEPS:06d}")):
        fail("no step-8 checkpoint")
    name = f"{N_STEPS:08d}_0_58.png"
    shapes = [check_png(os.path.join(exp, sub, name))
              for sub in ("validations_fine", "validations_extra_fine", "normals")]
    mesh = os.path.join(exp, "meshes", f"{N_STEPS:08d}.ply")
    if not os.path.exists(mesh):
        fail("no step-8 mesh")
    nv256, nt256 = ply_counts(mesh)
    if nt256 <= 0:
        fail("the step-8 mesh has no triangles")
    lvl = runner.tc.validate_resolution_level
    img_rays = (runner.dataset.H // lvl) * (runner.dataset.W // lvl)
    chunks_a = math.ceil(img_rays / VAL_CHUNK) + 6 * math.ceil(nv256 / VAL_CHUNK)
    n_calib = 12 * 4 + 2  # coverage renders of the silhouette calibration
    want = {"neus_ray_fwd": N_STEPS, "neus_ray_bwd": N_STEPS, "zbuffer_tiled": N_STEPS + n_calib,
            "neus_point_fwd": chunks_a, "neus_point_bwd": 0,
            "composite_fwd": chunks_a, "composite_bwd": 0}
    if launches_a != want:
        fail(f"path a: kernel launches {launches_a}, expected {want}")
    faces = [it for it in range(N_STEPS) if it % 4 == 0]
    if len(set(runner.step_sil_res)) < 2:
        fail(f"only one silhouette bucket used: {runner.step_sil_res}")
    median = statistics.median(runner.step_seconds[1:])
    val = {n: round(s, 3) for n, _, s in runner.val_seconds}
    print(f"[main a] train_clip via appearance.main: {N_STEPS} steps + the step-{N_STEPS} "
          f"validations in {wall_a:.3f} s, buckets {runner.step_sil_res}, face-camera steps "
          f"{faces}, launches {launches_a}")
    print(f"[main a] losses finite; loss by step {[round(r['loss'], 6) for r in recs]}")
    print(f"[main a] median step time excluding the first: {median * 1e3:.3f} ms "
          f"(first step {runner.step_seconds[0] * 1e3:.3f} ms)")
    print(f"[main a] validation seconds (worker thread, synchronised): {val}; image "
          f"{img_rays} rays -> PNGs {shapes}; 256^3 mesh {nv256} vertices, {nt256} triangles, "
          f"{6 * nv256} bake rays; {chunks_a} chunks of <= {VAL_CHUNK} rays")
    del runner
    torch.cuda.empty_cache()

    # b. the validate_mesh CLI mode: 512^3 extraction, baking, cast light
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = appearance.main(["--mode", "validate_mesh", "--is_continue"] + argv)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches_b = read_counts()
    if runner.iter_step != N_STEPS:
        fail(f"validate_mesh did not resume the step-{N_STEPS} checkpoint")
    nv512, nt512 = ply_counts(mesh)
    if nt512 <= 0:
        fail("the 512^3 mesh has no triangles")
    cast = os.path.join(exp, "cast_light_texture_head_black.png")
    cast_shape = check_png(cast)
    cast_rays = cast_shape[0] * cast_shape[1]
    chunks_b = 6 * math.ceil(nv512 / VAL_CHUNK) + math.ceil(cast_rays / VAL_CHUNK)
    want = {"neus_ray_fwd": 0, "neus_ray_bwd": 0, "zbuffer_tiled": 0,
            "neus_point_fwd": chunks_b, "neus_point_bwd": 0,
            "composite_fwd": chunks_b, "composite_bwd": 0}
    if launches_b != want:
        fail(f"path b: kernel launches {launches_b}, expected {want}")
    print(f"[main b] validate_mesh via appearance.main in {wall_b:.3f} s: 512^3 mesh {nv512} "
          f"vertices, {nt512} triangles, {6 * nv512} bake rays; cast light {cast_shape}, "
          f"{cast_rays} rays; {chunks_b} chunks; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches_b}")
    return {k: launches_a[k] + launches_b[k] for k in launches_a}


def main() -> None:
    kernels_only = "--kernels-only" in sys.argv[1:]
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

    from avatarclip_torch.ops import _build

    t0 = time.perf_counter()
    libs = [("raster_zbuffer", "raster_zbuffer.cu"), ("fused_neus_ray", "fused_neus_ray.cu"),
            ("fused_neus_point", "fused_neus_point.cu"), ("fused_composite", "fused_composite.cu")]
    _build.load_all(libs)
    _build.load_host("marching_cubes", "marching_cubes.cpp")
    print(f"[build] {time.perf_counter() - t0:.3f} s in parallel ({_build.build_seconds})")
    for name, _ in libs:
        log = _build.BUILD / f"{name}.log"
        if log.exists():
            info = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln]
            print(f"[build] {name}: " + " | ".join(info[:8]))

    from avatarclip_torch.pipelines import synthetic

    with tempfile.TemporaryDirectory() as tmp:
        runner = synthetic.make_runner(os.path.join(tmp, "probe"), "full", res=256, device=dev)
        runner.init_smpl()
        kernels = [check_zbuffer(runner, dev)]
        pretrain = os.path.join(tmp, "pretrain.pth")
        if not kernels_only:
            t0 = time.perf_counter()
            loss = synthetic.fit_template_pretrain(runner, pretrain)
            torch.cuda.synchronize()
            print(f"[pretrain] full-width SDF fitted to the template body in "
                  f"{time.perf_counter() - t0:.3f} s, last L1 {loss:.4f}")
            if not loss <= PRETRAIN_L1:
                fail(f"the pretrain fit ended at L1 {loss:.4f} > {PRETRAIN_L1}")
        del runner
        kernels += check_neus_ray(dev)
        torch.cuda.empty_cache()
        kernels += check_neus_point(dev)
        kernels += check_composite(dev)
        torch.cuda.empty_cache()
        if kernels_only:  # no main path ran: no launch count to report
            launches = {k["name"]: None for k in kernels}
        else:
            launches = run_main_path(tmp, pretrain)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if any(m.split(".")[0] in ("jax", "avatarclip_tpu") for m in sys.modules):
        fail("jax or the JAX package was imported")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
