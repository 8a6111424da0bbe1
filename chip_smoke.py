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
     library for sm_90a, all at once) and the host marching-cubes and mesh
     libraries (g++), and prints the build seconds;
  3. holds each kernel against its plain PyTorch version on the card and
     times both at the main path's shapes:
     - B2, the tiled z-buffer: the template at 256^2 and 128^2, a random
       triangle soup, and the animate paths' 13,776-face body at the five
       224^2 scoring views and visualize's 512^2 camera, exactly but for
       near-ties; timed on the 256^2 template and the 512^2 body;
     - #15, the brute-force z-buffer: against the plain version and B2's
       winners, exactly but for near-ties, on the template at 256^2, a
       ragged triangle soup and the 13,441-face ShapeGen body at 256^2
       (and on path f's 109 renders); timed on that body beside B2;
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
     - B5, the soft aggregation pair: forward and backward against the plain
       version in float64 (outputs to 1e-4 of their largest magnitude, the
       rgb and silhouette to 2e-4 absolute, the gradients of the x, y and
       constant edge coefficients, ezf and colf each to 1e-3 of its own
       largest magnitude) at one PoseOptimizer step's shapes (5 views x
       224^2 x the 13,776-face body, sigma 0.5), at a ragged 200 x 136 x
       1,000 faces and on a compact 320^2 scene at sigma 0.1 where the culling
       table skips pairs; timed at the pose step's shapes, with its kept share
       and its bound (f32 operations, special functions and bytes);
     - B6, the standalone SDF pair (4x256), and B7, the colour pair (2x256):
       forward and backward on 2,048 rays x 64 samples' points and on a
       ragged 131,071 of them against the plain version in float64, with
       cotangents on every output; outputs to 1e-4 and each gradient column
       (d(points) or d(inputs), and each weight) to 1e-3 of its own largest
       magnitude, at every point (at B7's relu near-ties the f64 input
       cotangents take the masks the kernel took, ops/hold.py); B7 in
       no_view_dir with the extra head and in idr without it; both timed at
       path (e)'s 802,816 points a step (and held there in path e);
     - #12, the sdf-only forward, through its entry (backward: autograd of
       the plain version) against the plain version in float64 at 4x256
       and 3x128 on 2,048 rays x 56 sweep points and on a ragged 131,071
       points (the sdf to 1e-4, its VJP to 1e-3), and its forward at one
       train_clip step's 12,544 x 56 points; timed there and on a
       262,144-point grid chunk;
     each kernel's bound is max(FLOPs / peak, bytes / 3.35 TB/s) for the
     work of that call (f32 CUDA-core peak 67 TFLOP/s, the type the kernels
     compute in; the bf16 tensor-core bound at 989 TFLOP/s is printed too);
  4. fits the full-width SDF to the template body and writes it as the
     conf's ``train.pretrain`` (the confs start from a NeuS pretrained on
     the template, which the repo does not ship; an untrained net's meshes
     are many times denser than an avatar's), then runs the main paths,
     each with the launch counts set to 0 just before it and read just
     after:
     a. ``appearance.main --mode train_clip`` for 8 steps with val_freq =
        val_mesh_freq = save_freq = 8 (asynchronous validation on, as in the
        confs): step 8 validates an image (camera 58), extracts and bakes a
        256^3 mesh and saves a checkpoint;
     b. ``appearance.main --mode validate_mesh --is_continue``: the 512^3
        extraction with its colour baking, then the cast-light head render;
     a'. ``Runner.interpolate_view(0, 30)`` on a Runner resumed from (a)'s
        checkpoint: 60 renders at resolution level 4 and their reversal as a
        120-frame MP4;
     h. the sweep hook (``networks._SWEEP_KERNEL``) on against off on (a)'s
        checkpoint, computing in float32 as #12 does (the confs' bf16
        operands would measure the precision gap, not the kernel): the
        validate_mesh mode's 512^3 extraction (grids within
        1e-5, vertex counts within 0.1%, #12 once a grid chunk) and one
        train_clip step at the same seed (losses within 1e-4, #12 four
        times: the coarse query and three up-sample sweeps);
     c. ``animate.main`` in pose mode on the procedural body at SMPL's
        13,776 faces (written as the template OBJ): PoseOptimizer, 2
        restarts x 8 steps at 224^2 with CLIP ViT-B/32, the candidates'
        scoring and 512^2 pictures; then VPoserOptimizer and VPoserRealNVP
        through ``build_pose_generator``;
     d. ``animate.main`` in motion mode: VPoserCodebook candidates,
        MotionOptimizer for 8 steps, motion.npy and a 60-frame motion.mp4;
        then MotionInterpolation;
     e. the NeRF++ background: the full conf's nets (the fitted SDF) with a
        NeRF from confs/examples/hulk.conf's ``model.nerf`` block (seeded
        random init) and n_outside = 32 (the published NeuS womask conf;
        the repo's confs set 0): 8 photometric ``Runner.train`` steps of
        12,544 random rays (Adam over sdf, colour, variance and NeRF), the
        per-sample render through B6 and B7, then one 256^2 image in 16,384-ray
        chunks; then, outside the counts, B6 and B7 held as in phase 3 on
        the inputs and cotangents one more step gives them (802,816
        points) and, forward, on one more image's first chunk (1,048,576);
     f. ShapeGen through ``shape.main`` on a 6,890-vertex body (the SMPL
        vertex count the VAE fixes) written as the template OBJ: ``gen`` with
        a seeded VAE at the checkpoint's shapes (16 -> 8,192 -> 20,670,
        the decoder scaled to mm offsets), a seeded 256 x (16, 512) codebook
        and ViT-B/32 random init; ``render`` writes the 108 views at 256^2
        (B2, 1 + 108 launches), read back through the dataset loader;
     g. the export: ``drive.main`` (a 60-frame .pc2) and ``rigged.main``
        (a GLB with the motion baked, an FBX ASCII) on (b)'s 512^3 mesh and
        (d)'s motion, with each phase's seconds;
     and checks the losses, the artifacts, and the launch counts against
     the counts predicted from the ray, step and render counts (paths a-d
     launch B6 / B7 no time: the megakernels take those renders; no path
     launches #15, which no default path of the JAX package runs either);
     c, d and e also profile a few steps (device time by kernel, busy share).
Prints a {"kernels": [...]} JSON line, then as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
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
RENDER_TOL = 2e-4  # B5: absolute on the rgb and silhouette in [0, 1] (5% of an 8-bit level)
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
    from avatarclip_torch.pipelines import visualize
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
    # the animate paths' shapes: the 13,776-face body at the five 224^2
    # scoring azimuths (elevation 0, as sort_poses_by_score renders) and at
    # visualize's 512^2 frontal camera
    body_v, body_f, body_poses, body_focal = humanoid_views(dev, elev_std=0.0)
    for k, azim in enumerate((120, 150, 180, 210, 240)):
        cases.append((f"13,776-face body 224^2 azimuth {azim}", body_v[0], body_f, body_poses[k], 224,
                      body_focal))
    vis_pose, vis_focal = visualize.camera(dev, 512)
    cases.append(("13,776-face body 512^2 visualize camera", body_v[0], body_f, vis_pose, 512, vis_focal))

    worst = 0.0  # largest inverse-depth gap between differing winners
    for name, v, f, pose, res, focal in cases:
        H, W = (res, res) if isinstance(res, int) else res
        proj = raster.project_vertices(v, pose, H, W, focal)
        coef, valid, _ = raster._face_coefficients(proj, f)
        args = (coef, valid, proj.sx[f], proj.sy[f], H, W)
        want = rz.zbuffer_select_plain(coef, valid, H, W)
        gap, n = same_winners(f"z-buffer {name}", rz.zbuffer_select_tiled(*args), want, coef, W)
        worst = max(worst, gap)
        print(f"[B2] {name}: {int((want >= 0).sum())} covered px, {n} near-tie "
              f"differences, kernel == plain elsewhere")
    # time at the train_clip GT raster (the template at 256^2) and at the
    # animate paths' largest render (the body at 512^2)
    cam, _ = runner.sample_iteration_camera(1, (256,))
    ms, plain_ms, b = time_zbuffer("256^2 template", template_v, faces,
                                   torch.as_tensor(cam["pose"], device=dev), 256, ds.focal)
    ms_v, plain_ms_v, b_v = time_zbuffer("512^2 body, visualize camera", body_v[0], body_f, vis_pose, 512,
                                         vis_focal)
    return {"name": "zbuffer_tiled", "route": "cuda",
            "source": "avatarclip_torch/csrc/raster_zbuffer.cu",
            "replaces": "avatarclip_tpu/ops/raster_zbuffer.py:266",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **b,
            "ms_512_body": ms_v, "plain_ms_512_body": plain_ms_v, "bound_ms_512_body": b_v["bound_ms"],
            "bound_by_512_body": b_v["bound_by"]}


def same_winners(tag, got, want, coef, W) -> tuple[float, int]:
    """Two winner maps agree but at near-ties: where they differ both faces
    cover the pixel and their inverse depths agree to NEAR_TIE. The largest
    inverse-depth gap between differing winners and their count."""
    import torch

    from avatarclip_torch.ops import raster_zbuffer as rz

    torch.cuda.synchronize()
    diff = (got != want).nonzero().flatten()
    if not diff.numel():
        return 0.0, 0
    px, py = (diff % W).float(), (diff // W).float()
    if (got[diff] < 0).any() or (want[diff] < 0).any():
        fail(f"{tag}: coverage differs at {diff.numel()} pixels")
    izs = [rz.lin3(px, py, coef[i.long(), 0, 3], coef[i.long(), 1, 3], coef[i.long(), 2, 3])
           for i in (got[diff], want[diff])]
    gap = (izs[0] - izs[1]).abs()
    if (gap > NEAR_TIE * izs[1].abs()).any():
        fail(f"{tag}: {diff.numel()} pixels differ beyond near-ties")
    return float(gap.max()), diff.numel()


def time_zbuffer(name, v, faces, pose, res, focal, brute: bool = False):
    """B2's (or with ``brute`` #15's) and the plain version's milliseconds on
    one render, and the bound of the work that render needs: every (pixel,
    valid face) pair inside the face's screen bbox gets 3 edge tests and an
    inverse depth (~17 FLOPs). #15 computes B2's function, so it has B2's
    operations; it evaluates every (pixel, face) pair. The bytes are each
    kernel's own inputs and output: B2 reads coef (48 B a face), valid as
    int32 and the corners' screen coordinates (24 B) for its culling table;
    #15 reads coef and valid as bool (1 B)."""
    from avatarclip_torch.ops import raster_zbuffer as rz
    from avatarclip_torch.render import raster

    proj = raster.project_vertices(v, pose, res, res, focal)
    coef, valid, _ = raster._face_coefficients(proj, faces)
    sx, sy = proj.sx[faces], proj.sy[faces]
    if brute:
        ms = cuda_ms(lambda: rz.zbuffer_select(coef, valid, res, res), reps=20)
    else:
        ms = cuda_ms(lambda: rz.zbuffer_select_tiled(coef, valid, sx, sy, res, res), reps=20)
    plain_ms = cuda_ms(lambda: rz.zbuffer_select_plain(coef, valid, res, res), reps=5)
    nx = (sx.amax(1).clamp(0, res - 1).floor() - sx.amin(1).clamp(0, res - 1).ceil() + 1).clamp_min(0)
    ny = (sy.amax(1).clamp(0, res - 1).floor() - sy.amin(1).clamp(0, res - 1).ceil() + 1).clamp_min(0)
    pairs = float((nx * ny * valid.float()).sum())
    F = faces.shape[0]
    b = bound(17.0 * pairs, F * (48 + 1 if brute else 48 + 4 + 24) + res * res * 4)
    tag = "#15" if brute else "B2"
    print(f"[{tag}] {name} ({F} faces, {pairs:.0f} bbox pixel-face pairs, {res * res * F} pairs in all): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.5f} ms ({b['bound_by']})")
    return ms, plain_ms, b


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
# B5: the soft aggregation pair
# ---------------------------------------------------------------------------

# Operations per (pixel, face) pair, counted from csrc/fused_soft.cu. Every
# pair of a kept (tile, block) with a valid face: 3 edge distances (2 mul +
# 2 add each), 2 min, the scale and the x > -110 test. A live pair (x > -110,
# where the sigmoid is not exactly 0 in f32) adds, in the forward, |x|, 1 + e,
# the sigmoid select, softplus's max, add and subtract, w, 3 FMA (6) and den
# (14) with exp, reciprocal and log1p's log on the special-function unit;
# in the backward |x|, 1 + e, the select, dw (6), dd (7), the tie test (5),
# one edge's 3 sums (5), dezf (2), w (1) and dcolf (6), 35, with exp and
# reciprocal.
SOFT_OPS_PAIR = 16
SOFT_FWD_OPS_LIVE, SOFT_FWD_SFU_LIVE = 14, 3
SOFT_BWD_OPS_LIVE, SOFT_BWD_SFU_LIVE = 35, 2
SFU_PER_SM_CLOCK = 16  # H100: special-function results per SM per clock
N_SM = 132
X_DEAD = -110.0  # the kernels' live-pair threshold


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return float(out) * 1e6


def soft_bound(ops: float, sfu: float, nbytes: float, clock_hz: float) -> dict:
    """max(f32 operations / 67 TFLOP/s, special-function operations / (132
    SMs x 16 per clock x the SM clock), bytes / 3.35 TB/s)."""
    t = {"operations": ops / PEAK_F32 * 1e3, "special functions": sfu / (N_SM * SFU_PER_SM_CLOCK * clock_hz) * 1e3,
         "bytes": nbytes / HBM * 1e3}
    by = max(t, key=t.get)
    return {"bound_ms": t[by], "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_resource": by, "ops": ops, "sfu_ops": sfu, "bytes": nbytes}


def humanoid_views(dev, n_views=5, res=224, seed=0, elev_std=0.3):
    """The pose optimizer's five 224^2 views of the 13,776-face procedural
    body (SMPL's face count), posed as AnimateContext._pose_vertices poses
    it at the zero body pose, elevations ~ N(0, elev_std): (vertices (B, V,
    3), faces, poses (B, 4, 4), focal)."""
    import numpy as np
    import torch

    from avatarclip_torch import assets
    from avatarclip_torch.body import smpl
    from avatarclip_torch.pipelines import animate
    from avatarclip_torch.render import cameras

    v, f = assets._procedural_humanoid(n_seg=41, n_ring=28)
    model = smpl.approximate_model_from_mesh(v, f)
    go = torch.tensor([[np.pi / 2, 0.0, 0.0]])
    verts, _ = model.forward(body_pose=torch.zeros(1, 23, 3), global_orient=go)
    verts = (verts[0] @ torch.from_numpy(cameras.BODY_TO_WORLD).t()).to(dev)
    elevs = torch.randn(n_views, generator=torch.Generator().manual_seed(seed)) * elev_std
    azims = torch.tensor([120.0, 150.0, 180.0, 210.0, 240.0])[:n_views]
    poses = animate.view_poses(elevs.to(dev), azims.to(dev))
    focal = cameras.focal_from_fov(res, np.deg2rad(60.0))
    return verts.expand(n_views, -1, -1).contiguous(), torch.from_numpy(f).to(dev), poses, focal


def soup_views(dev, n_faces, seed, eyes, compact=False):
    """A triangle soup in front of cameras at ``eyes``: random small faces
    with 5% slivers and 5 degenerate (gated) faces, or with ``compact`` the
    clean scene of equilateral faces on which the table skips pairs."""
    import numpy as np
    import torch

    from avatarclip_torch.render import cameras

    g = np.random.default_rng(seed)
    c = g.uniform(-0.35 if compact else -0.6, 0.35 if compact else 0.6, (n_faces, 3)).astype(np.float32)
    c[:, 2] *= 0.3
    if compact:
        a = np.array([0.0, 2 * np.pi / 3, 4 * np.pi / 3], np.float32)
        offs = np.broadcast_to(0.05 * np.stack([np.cos(a), np.sin(a), np.zeros(3)], -1),
                               (n_faces, 3, 3)).astype(np.float32)
    else:
        offs = g.uniform(-0.08, 0.08, (n_faces, 3, 3)).astype(np.float32)
        k = n_faces // 20
        offs[:k, :, 0] *= 40.0
        offs[:k, :, 1] *= 0.02
        offs[k:k + 5] = 0.0
    v = torch.from_numpy((c[:, None] + offs).reshape(-1, 3)).to(dev)
    f = torch.arange(n_faces * 3, device=dev).reshape(n_faces, 3)
    poses = torch.stack([torch.from_numpy(cameras.lookat_np(np.asarray(e, np.float32), np.zeros(3, np.float32),
                                                            np.array([0, 1, 0], np.float32))) for e in eyes]).to(dev)
    return v.expand(len(eyes), -1, -1).contiguous(), f, poses


def soft_problem(verts, faces, poses, H, W, focal, sigma, gamma=0.005):
    from avatarclip_torch.ops import fused_soft as fs
    from avatarclip_torch.render import raster

    fi = raster.soft_face_inputs(verts, faces, poses, H, W, focal)
    faces_p, tab = fs.prepare(fi["coef"], fi["valid"], fi["edge_inv_len"], fi["iz_face"],
                              fi["colors_face"], H, W, sigma, gamma, fi["face_sx"], fi["face_sy"])
    return faces_p.detach().contiguous(), tab


def soft_loss(outs, probes):
    """A loss on the render as soft_render_mesh forms it: rgb and silhouette."""
    import torch

    sil_log, num, den = outs
    rgb = num / (den[..., None] + 1.0 + 1e-20)
    return (rgb * probes[0]).sum() + ((1.0 - torch.exp(sil_log)) * probes[1]).sum()


def soft_grads(fn, faces, probes, *args):
    import torch

    x = faces.clone().requires_grad_(True)
    outs = fn(x, *args)
    (g,) = torch.autograd.grad(soft_loss(outs, probes), [x])
    return [o.detach() for o in outs], g


def hold_soft(tag, faces, tab, H, W, sigma, dev) -> tuple[float, float]:
    """B5 through its autograd Function against the plain version in f64 on
    the same (f32-valued) packed faces: sil_log, num and den to OUT_TOL of
    their largest magnitude, the rgb and silhouette the render forms from
    them to RENDER_TOL absolute, and the gradients of the edge coefficients
    of x, of y and the constant ones, of ezf and of colf each to GRAD_TOL of
    its own largest magnitude (the x and y columns carry factors of the
    pixel coordinates, so one group would hide a wrong constant term)."""
    import torch

    from avatarclip_torch.ops import fused_soft as fs

    B, P = faces.shape[0], H * W
    g = torch.Generator().manual_seed(P)
    probes = [(0.5 + torch.rand(B, P, 3, generator=g)).to(dev), (0.5 + torch.rand(B, P, generator=g)).to(dev)]
    inv = 1.0 / sigma
    outs_k, g_k = soft_grads(lambda x: fs.aggregate(x, tab, H, W, inv), faces, probes)
    outs_r, g_r = soft_grads(lambda x: fs.aggregate_plain(x, H, W, inv), faces.double(),
                             [p.double() for p in probes])
    torch.cuda.synchronize()
    worst_f = worst_b = 0.0
    rels = {}
    for nm, a, b in zip(("sil_log", "num", "den"), outs_k, outs_r):
        err, rel = rel_err(a, b)
        if not rel <= OUT_TOL or not torch.isfinite(a).all():
            fail(f"B5 {tag} forward {nm}: rel err {rel:.2e} > {OUT_TOL}")
        rels[nm] = rel
    # what the render forms, rgb and the silhouette, is held absolutely: num
    # and den reach ~1e30 at saturated depth weights, so their relative
    # measure alone says little about the image
    for nm, a, b in (("rgb", outs_k[1] / (outs_k[2][..., None] + 1.0), outs_r[1] / (outs_r[2][..., None] + 1.0)),
                     ("silhouette", torch.exp(outs_k[0]), torch.exp(outs_r[0]))):
        err = rel_err(a, b)[0]
        if not err <= RENDER_TOL:
            fail(f"B5 {tag} forward {nm}: max abs err {err:.2e} > {RENDER_TOL}")
        worst_f = max(worst_f, err)
    for nm, cols in (("cs x", slice(0, 9, 3)), ("cs y", slice(1, 9, 3)), ("cs constant", slice(2, 9, 3)),
                     ("ezf", slice(9, 10)), ("colf", slice(10, 13))):
        err, rel = rel_err(g_k[..., cols], g_r[..., cols])
        if not rel <= GRAD_TOL or not torch.isfinite(g_k).all():
            fail(f"B5 {tag} backward d/d {nm}: rel err {rel:.2e} > {GRAD_TOL}")
        worst_b = max(worst_b, err)
        rels["d " + nm] = rel
    if g_k[..., 13:].abs().max() != 0:
        fail(f"B5 {tag}: the backward wrote the vmask or padding columns")
    print(f"[B5] {tag}: {B} views, {faces.shape[1]} padded faces, kept share "
          f"{float(tab.float().mean()):.4f}; vs the plain version in f64: forward and gradients "
          f"within tolerance; max abs err of rgb and silhouette {worst_f:.3e}, of the face "
          f"gradients {worst_b:.3e}; relative errs " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()))
    del outs_r, g_r
    torch.cuda.empty_cache()
    return worst_f, worst_b


def soft_pair_counts(faces, tab, H, W, sigma) -> tuple[float, float]:
    """(kept pairs, live pairs) of this input: the pairs of image pixels and
    valid faces in the table's kept (tile, block) pairs, and those with
    x > -110 (all of which are kept: the table is sound)."""
    import torch

    from avatarclip_torch.ops import fused_soft as fs

    B, Fp, _ = faces.shape
    n_ty, n_tx = fs.grid_dims(H, W)
    ty = torch.arange(n_ty * n_tx, device=faces.device) // n_tx
    tx = torch.arange(n_ty * n_tx, device=faces.device) % n_tx
    px_tile = ((H - ty * fs.TILE_H).clamp(max=fs.TILE_H) * (W - tx * fs.TILE_W).clamp(max=fs.TILE_W)).double()
    valid_blk = (faces[..., 13] != 0).reshape(B, -1, fs.FBLOCK).sum(-1).double()  # (B, n_fb)
    kept = float((tab.double() * px_tile[None, :, None] * valid_blk[:, None, :]).sum())
    live = 0.0
    px, py = fs._pixel_coords(H, W, faces.device, torch.float32)
    for f0 in range(0, Fp, 256):
        fc = faces[:, f0:f0 + 256]
        v = [(px * fc[:, None, :, 3 * e] + py * fc[:, None, :, 3 * e + 1]) + fc[:, None, :, 3 * e + 2]
             for e in range(3)]
        x = torch.minimum(torch.minimum(v[0], v[1]), v[2]) * (1.0 / sigma)
        live += float(((x > X_DEAD) & (fc[:, None, :, 13] != 0)).sum())
    return kept, live


def check_soft(dev):
    import torch

    from avatarclip_torch.ops import _build
    from avatarclip_torch.ops import fused_soft as fs

    worst_f = worst_b = 0.0
    # 1. one PoseOptimizer step's shapes: 5 views x 224^2 x 13,776 faces
    verts, faces, poses, focal = humanoid_views(dev)
    H = W = 224
    sigma = 0.5
    fp, tab = soft_problem(verts, faces, poses, H, W, focal, sigma)
    f_, b_ = hold_soft("pose step 224^2 x 13,776 faces, sigma 0.5", fp, tab, H, W, sigma, dev)
    worst_f, worst_b = max(worst_f, f_), max(worst_b, b_)
    # 2. ragged: partial tiles and a partial face block
    v2, f2, p2 = soup_views(dev, 1000, 5, [(0.0, 0.0, 2.0), (0.3, 0.2, 1.9)])
    fp2, tab2 = soft_problem(v2, f2, p2, 200, 136, 150.0, 0.5)
    f_, b_ = hold_soft("ragged 200x136 x 1,000 faces (1,024 padded)", fp2, tab2, 200, 136, 0.5, dev)
    worst_f, worst_b = max(worst_f, f_), max(worst_b, b_)
    # 3. compact scene at small sigma: the table skips most pairs
    v3, f3, p3 = soup_views(dev, 1500, 11, [(0.0, 0.0, 2.0)], compact=True)
    fp3, tab3 = soft_problem(v3, f3, p3, 320, 320, 320 * 0.5 / math.tan(math.radians(30.0)), 0.1)
    if not float(tab3.float().mean()) < 0.9:
        fail(f"B5: the compact scene keeps {float(tab3.float().mean()):.3f} of its pairs")
    f_, b_ = hold_soft("compact 320^2 x 1,500 faces, sigma 0.1", fp3, tab3, 320, 320, 0.1, dev)
    worst_f, worst_b = max(worst_f, f_), max(worst_b, b_)

    # time at size 1: the kernels alone, on preallocated outputs
    inv = 1.0 / sigma
    B, Fp, _ = fp.shape
    P = H * W
    g = torch.Generator().manual_seed(7)
    cots = [(torch.rand(B, P, generator=g) * 1e-3).to(dev), (torch.rand(B, P, 3, generator=g) * 1e-30).to(dev),
            (torch.rand(B, P, generator=g) * -1e-30).to(dev)]
    lib, p, st = fs._lib(), _build.ptr, _build.stream_ptr(dev)
    n_ty, n_tx = fs.grid_dims(H, W)
    outs = fs.soft_fwd(fp, tab, H, W, inv)
    dfp = fs.soft_bwd(fp, tab, *cots, H, W, inv)
    torch.cuda.synchronize()
    args = (B, H, W, n_tx, n_ty, Fp // fs.FBLOCK, inv, st)
    ms_f = cuda_ms(lambda: lib.soft_fwd(p(fp), p(tab), *[p(o) for o in outs], *args), reps=10)
    ms_b = cuda_ms(lambda: lib.soft_bwd(p(fp), p(tab), *[p(c) for c in cots], p(dfp), *args), reps=10)
    with torch.no_grad():
        plain_f = cuda_ms(lambda: fs.aggregate_plain(fp, H, W, inv), reps=2)
    x = fp.clone().requires_grad_(True)
    o = fs.aggregate_plain(x, H, W, inv)
    torch.cuda.synchronize()
    plain_b = cuda_ms(lambda: torch.autograd.grad(o, [x], cots, retain_graph=True), reps=2)
    del x, o
    torch.cuda.empty_cache()
    kept, live = soft_pair_counts(fp, tab, H, W, sigma)
    clock = sm_clock_hz()
    face_b, pix_b, tab_b = B * Fp * 64, B * P * 20, tab.numel() * 4
    b_f = soft_bound(kept * SOFT_OPS_PAIR + live * SOFT_FWD_OPS_LIVE, live * SOFT_FWD_SFU_LIVE,
                     face_b + tab_b + pix_b, clock)
    b_b = soft_bound(kept * SOFT_OPS_PAIR + live * SOFT_BWD_OPS_LIVE, live * SOFT_BWD_SFU_LIVE,
                     face_b + tab_b + pix_b + face_b, clock)
    print(f"[B5] pose step 5 x 224^2 x {Fp} padded faces: kept share {float(tab.float().mean()):.4f} "
          f"of (tile, block) pairs, {kept:.0f} kept pixel-face pairs, {live:.0f} live (x > -110, "
          f"{live / max(kept, 1):.4f} of kept); SM clock {clock / 1e6:.0f} MHz")
    print(f"[B5] forward kernel {ms_f:.4f} ms (plain {plain_f:.4f} ms, bound {b_f['bound_ms']:.4f} ms "
          f"by {b_f['bound_resource']}); backward kernel {ms_b:.4f} ms (plain {plain_b:.4f} ms, bound "
          f"{b_b['bound_ms']:.4f} ms by {b_b['bound_resource']}); one launch each per step")
    common = {"route": "cuda", "source": "avatarclip_torch/csrc/fused_soft.cu", "library_ms": None}
    return [
        {"name": "soft_fwd", **common, "replaces": "avatarclip_tpu/ops/fused_soft.py:106",
         "max_abs_err": worst_f, "ms": ms_f, "plain_ms": plain_f, **b_f},
        {"name": "soft_bwd", **common, "replaces": "avatarclip_tpu/ops/fused_soft.py:132",
         "max_abs_err": worst_b, "ms": ms_b, "plain_ms": plain_b, **b_b},
    ]


# ---------------------------------------------------------------------------
# B6 and B7: the standalone SDF pair and the colour pair
# ---------------------------------------------------------------------------

PATH_E_RAYS = 112 * 112  # path (e)'s rays a step: the train_clip budget
PATH_E_POINTS = PATH_E_RAYS * 64  # the per-sample branch's points a step


def ray_points(inputs):
    """The (R * S, 3) sample points of neus_problem's rays and their (R * S,
    3) directions."""
    ro, rd, mid, _ = inputs
    S = mid.shape[1]
    pts = (ro[:, None] + rd[:, None] * mid[..., None]).reshape(-1, 3).contiguous()
    return pts, rd[:, None].expand(-1, S, -1).reshape(-1, 3).contiguous()


REF_CHUNK = 131072  # points per chunk of a float64 reference


def hold_outputs(tag, names, got, ref) -> tuple[float, dict]:
    """Each output to OUT_TOL of its largest magnitude; the max abs error
    and each output's relative error."""
    import torch

    from avatarclip_torch.ops import hold

    worst, rels = 0.0, {}
    for nm, a, b, rel in zip(names, got, ref, hold.rel_errors(got, ref)):
        if not rel <= OUT_TOL:
            fail(f"{tag} forward {nm}: rel err {rel:.2e} > {OUT_TOL}")
        worst, rels[nm] = max(worst, float((a.detach().double() - b).abs().max())), rel
    torch.cuda.synchronize()
    return worst, rels


def hold_net(tag, fused, plain, net, ins, cots, in_names, out_names,
             relu_ties: bool = False) -> tuple[float, float]:
    """The kernel pair through its entry, at once on all the points, against
    the plain version in f64 (in REF_CHUNK-point chunks) on the same
    (f32-valued) inputs and net: each output to OUT_TOL and each gradient
    column (every parameter, every input) to GRAD_TOL of its own largest
    magnitude, at every point. ``relu_ties`` (the colour net): at the points
    with a relu near-tie the f64 input cotangents are those under the masks
    the kernel took (ops/hold.resolve_relu_ties). Returns the max abs errors
    (forward, backward)."""
    import torch

    from avatarclip_torch.ops import hold

    ok, gk = hold.net_grads(fused, net, ins, cots)
    ref = copy.deepcopy(net).double()
    ins64, cots64 = [t.double() for t in ins], [c.double() for c in cots]
    orf, grf = hold.net_grads(plain, ref, ins64, cots64, chunk=REF_CHUNK)
    worst_f, rels = hold_outputs(tag, out_names, ok, orf)
    names = [n for n, _ in net.named_parameters()] + list(in_names)
    note = ""
    if relu_ties:
        n_p = len(names) - len(in_names)
        plain_rel = hold.rel_errors(gk[n_p:], grf[n_p:])
        grf[n_p:], rep = hold.resolve_relu_ties(ref, ins64, cots64[0], gk[n_p:], grf[n_p:],
                                                chunk=REF_CHUNK)
        note = (f"{rep['near_tie_points']} points with a relu near-tie, {rep['taken_the_other_way']} "
                f"taken the other way by the kernel (at most {rep['most_ties_at_a_point']} near-ties a "
                f"point); d(inputs) against the plain f64 masks " + ", ".join(
                    f"{nm} {r:.2e}" for nm, r in zip(in_names, plain_rel)))
        if "worst_point_err_plain" in rep:
            note += (f"; the point farthest from them: {rep['worst_point_err_plain']:.2e} under f64's "
                     f"masks, {rep['worst_point_err_resolved']:.2e} with "
                     f"{rep['worst_point_units_flipped']} unit(s) flipped; ")
    worst_b = 0.0
    for nm, a, b, rel in zip(names, gk, grf, hold.rel_errors(gk, grf)):
        if not rel <= GRAD_TOL:
            fail(f"{tag} backward d/d {nm}: rel err {rel:.2e} > {GRAD_TOL}")
        worst_b, rels["d " + nm] = max(worst_b, float((a.double() - b).abs().max())), rel
    print(f"[{tag}] vs the plain version in f64: within tolerance at every point; {note}max abs err "
          f"fwd {worst_f:.3e}, bwd {worst_b:.3e}; relative errs "
          + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()))
    del ref, orf, grf, ok, gk
    torch.cuda.empty_cache()
    return worst_f, worst_b


def hold_forward(tag, fused, plain, net, ins, out_names) -> float:
    """The forward kernel alone (under no_grad, as a render chunk runs it)
    against the plain version in f64, each output to OUT_TOL of its largest
    magnitude; the max abs error."""
    import torch

    from avatarclip_torch.ops import hold

    with torch.no_grad():
        got = fused(net, *ins)
    got = got if isinstance(got, tuple) else (got,)
    ref = hold.net_outputs(plain, copy.deepcopy(net).double(), [t.double() for t in ins], chunk=REF_CHUNK)
    worst, rels = hold_outputs(tag, out_names, got, ref)
    print(f"[{tag}] forward under no_grad vs the plain version in f64: within tolerance; max abs err "
          f"{worst:.3e}; relative errs " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()))
    del got, ref
    torch.cuda.empty_cache()
    return worst


def time_plain(fn, args, params, cots, reps=2) -> tuple[float, float]:
    """The plain version's forward (building its graph, as training does)
    and autograd's VJP of it alone, in ms."""
    import torch

    fwd = cuda_ms(lambda: fn(*args), reps=reps)
    xs = [a.clone().requires_grad_(True) if torch.is_tensor(a) else a for a in args]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    wrt = params + [x for x in xs if torch.is_tensor(x)]
    torch.cuda.synchronize()
    bwd = cuda_ms(lambda: torch.autograd.grad(outs, wrt, cots, retain_graph=True, allow_unused=True),
                  reps=reps)
    del outs, xs
    torch.cuda.empty_cache()
    return fwd, bwd


def check_sdf(dev):
    import torch

    from avatarclip_torch.ops import fused_sdf as fs

    worst_f = worst_b = 0.0
    fields, inputs, _, _ = neus_problem(256, 2048, dev, seed=4)
    sdf = fields.sdf
    pts, _ = ray_points(inputs)
    g = torch.Generator().manual_seed(5)
    for P in (pts.shape[0], pts.shape[0] - 1):
        cots = [(0.5 + torch.rand(P, k, generator=g)).to(dev) for k in (1, 256, 3)]
        f_, b_ = hold_net(f"B6 4x256, {P} points", fs.sdf_with_gradient_fused,
                          fs.sdf_with_gradient_plain, sdf, [pts[:P].contiguous()], cots,
                          ("points",), ("sdf", "feature", "gradient"))
        worst_f, worst_b = max(worst_f, f_), max(worst_b, b_)

    # time at path (e)'s points: 12,544 rays x 64 samples
    fields, inputs, _, _ = neus_problem(256, PATH_E_RAYS, dev, seed=6)
    sdf = fields.sdf
    pts, _ = ray_points(inputs)
    P = pts.shape[0]
    spec = fs.spec_from_config(sdf.cfg)
    flat = torch.cat([w.detach().reshape(-1) for w in fs.dense_weights(sdf)])
    cots = [(0.5 + torch.rand(P, k, generator=g)).to(dev) for k in (1, 256, 3)]
    torch.cuda.reset_peak_memory_stats()
    ms_f = cuda_ms(lambda: fs.sdf_fwd(spec, flat, pts), reps=3)
    ms_b = cuda_ms(lambda: fs.sdf_bwd(spec, flat, pts, *cots), reps=3)
    mem_k = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    plain_f, plain_b = time_plain(lambda x: fs.sdf_with_gradient_plain(sdf, x), [pts],
                                  list(sdf.parameters()), cots)
    mem_p = torch.cuda.max_memory_allocated() / 2**30
    fl_f, fl_b = fs.flops_per_point(spec)
    n_w, F = flat.numel(), spec.feat_dim
    b_f = bound(fl_f * P, 4 * (n_w + 3 * P + (1 + F + 3) * P))
    b_b = bound(fl_b * P, 4 * (n_w + 3 * P + (1 + F + 3) * P + 3 * P + n_w))
    print(f"[B6] {P} points (path e's step), 4x256: forward kernel {ms_f:.3f} ms (plain "
          f"{plain_f:.3f} ms, bound {b_f['bound_ms']:.3f} ms {b_f['bound_by']}, bf16 tensor-core "
          f"bound {b_f['bound_ms_bf16_tc']:.3f} ms); backward kernel {ms_b:.3f} ms (plain "
          f"{plain_b:.3f} ms, bound {b_b['bound_ms']:.3f} ms {b_b['bound_by']}, bf16 "
          f"{b_b['bound_ms_bf16_tc']:.3f} ms); {fl_f:.0f} / {fl_b:.0f} GEMM FLOPs per point; peak "
          f"memory kernel {mem_k:.2f} GiB, plain {mem_p:.2f} GiB")
    common = {"route": "cuda", "source": "avatarclip_torch/csrc/fused_sdf.cu", "library_ms": None}
    return [
        {"name": "sdf_fwd", **common, "replaces": "avatarclip_tpu/ops/fused_sdf.py:261",
         "max_abs_err": worst_f, "ms": ms_f, "plain_ms": plain_f, **b_f},
        {"name": "sdf_bwd", **common, "replaces": "avatarclip_tpu/ops/fused_sdf.py:403",
         "max_abs_err": worst_b, "ms": ms_b, "plain_ms": plain_b, **b_b},
    ]


def colour_net(mode: str, extra: bool, dev, seed: int):
    """A 2x256 colour net (no weight norm, so its parameters are the dense
    weights the kernel differentiates) with seeded, perturbed weights."""
    import torch

    from avatarclip_torch.fields import networks as nets

    g = torch.Generator().manual_seed(seed)
    net = nets.ColorNetwork(nets.ColorConfig(mode=mode, d_in=9 if mode == "idr" else 6, d_feature=256,
                                             d_hidden=256, n_layers=2, extra_color=extra,
                                             weight_norm=False), g)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    return net.to(dev)


def colour_inputs(fields, inputs):
    """Points, unit normals, directions and the SDF net's feature at
    neus_problem's sample points (the colour net's inputs on the path)."""
    import torch

    pts, dirs = ray_points(inputs)
    with torch.no_grad():
        _, feat, grad = fields.sdf.sdf_with_gradient(pts)
    normals = grad / (grad.norm(dim=-1, keepdim=True) + 1e-6)
    return [pts, normals.detach().contiguous(), dirs, feat.detach().contiguous()]


def check_colour(dev):
    import torch

    from avatarclip_torch.ops import fused_color as fc

    worst_f = worst_b = 0.0
    fields, inputs, _, _ = neus_problem(256, 2048, dev, seed=7)
    ins = colour_inputs(fields, inputs)
    g = torch.Generator().manual_seed(8)
    for mode, extra in (("no_view_dir", True), ("idr", False)):
        net = colour_net(mode, extra, dev, seed=9)
        for P in (ins[0].shape[0], ins[0].shape[0] - 1):
            cots = [(0.5 + torch.rand(P, 6 if extra else 3, generator=g)).to(dev)]
            sub = [t[:P].contiguous() for t in ins]
            f_, b_ = hold_net(f"B7 {mode}{' + extra head' if extra else ''}, {P} points",
                              fc.color_apply_fused, fc.color_apply_plain, net, sub, cots,
                              ("points", "normals", "view_dirs", "features"), ("rgb",),
                              relu_ties=True)
            worst_f, worst_b = max(worst_f, f_), max(worst_b, b_)

    # time at path (e)'s points, in the path's mode (no_view_dir, extra head)
    fields, inputs, _, _ = neus_problem(256, PATH_E_RAYS, dev, seed=10)
    ins = colour_inputs(fields, inputs)
    del fields
    net = colour_net("no_view_dir", True, dev, seed=11)
    spec = fc.spec_from_config(net.cfg)
    flat = torch.cat([w.detach().reshape(-1) for w in fc.dense_weights(net, spec)])
    P = ins[0].shape[0]
    cot = (0.5 + torch.rand(P, 6, generator=g)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    ms_f = cuda_ms(lambda: fc.color_fwd(spec, flat, *ins), reps=3)
    ms_b = cuda_ms(lambda: fc.color_bwd(spec, flat, *ins, cot), reps=3)
    mem_k = torch.cuda.max_memory_allocated() / 2**30
    plain_f, plain_b = time_plain(lambda *xs: fc.color_apply_plain(net, *xs), ins,
                                  list(net.parameters()), [cot])
    fl_f, fl_b = fc.flops_per_point(spec)
    n_w, W = flat.numel(), spec.rgb_width
    n_in = 3 * spec.n_vectors + spec.d_feature  # the input floats a point the mode reads
    b_f = bound(fl_f * P, 4 * (n_w + n_in * P + W * P))
    b_b = bound(fl_b * P, 4 * (n_w + n_in * P + W * P + n_in * P + n_w))
    print(f"[B7] {P} points (path e's step), 2x256 no_view_dir + extra head: forward kernel "
          f"{ms_f:.3f} ms (plain {plain_f:.3f} ms, bound {b_f['bound_ms']:.3f} ms "
          f"{b_f['bound_by']}, bf16 tensor-core bound {b_f['bound_ms_bf16_tc']:.3f} ms); backward "
          f"kernel {ms_b:.3f} ms (plain {plain_b:.3f} ms, bound {b_b['bound_ms']:.3f} ms "
          f"{b_b['bound_by']}, bf16 {b_b['bound_ms_bf16_tc']:.3f} ms); {fl_f:.0f} / {fl_b:.0f} GEMM "
          f"FLOPs per point; peak memory kernel {mem_k:.2f} GiB")
    common = {"route": "cuda", "source": "avatarclip_torch/csrc/fused_color.cu", "library_ms": None}
    return [
        {"name": "color_fwd", **common, "replaces": "avatarclip_tpu/ops/fused_color.py:230",
         "max_abs_err": worst_f, "ms": ms_f, "plain_ms": plain_f, **b_f},
        {"name": "color_bwd", **common, "replaces": "avatarclip_tpu/ops/fused_color.py:244",
         "max_abs_err": worst_b, "ms": ms_b, "plain_ms": plain_b, **b_b},
    ]


# ---------------------------------------------------------------------------
# B8: #12, the sdf-only forward, and #15, the brute-force z-buffer
# ---------------------------------------------------------------------------

SWEEP_SAMPLES = 32 + 3 * 8  # a ray's sdf-only queries a render: 32 coarse, 3 up-sample batches of 8
GRID_CHUNK = 64 ** 3  # export/marching_cubes._eval_points' chunk


def sweep_points(inputs):
    """The first SWEEP_SAMPLES sample points of each of neus_problem's rays."""
    ro, rd, mid, _ = inputs
    return (ro[:, None] + rd[:, None] * mid[:, :SWEEP_SAMPLES, None]).reshape(-1, 3).contiguous()


def check_sdf_only(dev):
    """#12 through its entry (the kernel forward, autograd of the plain
    version backward) against the plain version in f64: at 4x256 and 3x128
    on 2,048 rays x 56 sweep points and at 4x256 on a ragged 131,071 points,
    the sdf to OUT_TOL and its VJP into every parameter and the points to
    GRAD_TOL; the forward at one train_clip step's 12,544 rays x 56 points.
    Timed there and on one 262,144-point grid chunk."""
    import torch

    from avatarclip_torch.ops import fused_sdf as fs

    worst_f = worst_b = 0.0
    g = torch.Generator().manual_seed(13)
    for width in (256, 128):
        fields, inputs, _, _ = neus_problem(width, 2048, dev, seed=12)
        sets = [sweep_points(inputs)]
        if width == 256:
            sets.append(ray_points(inputs)[0][:131071].contiguous())
        for pts in sets:
            P = pts.shape[0]
            cots = [(0.5 + torch.rand(P, 1, generator=g)).to(dev)]
            f_, b_ = hold_net(f"#12 {'4x256' if width == 256 else '3x128'}, {P} points", fs.sdf_value_fused,
                              fs.sdf_only_plain, fields.sdf, [pts], cots, ("points",), ("sdf",))
            worst_f, worst_b = max(worst_f, f_), max(worst_b, b_)

    fields, inputs, _, _ = neus_problem(256, PATH_E_RAYS, dev, seed=14)
    sdf = fields.sdf
    pts = sweep_points(inputs)
    P = pts.shape[0]
    worst_f = max(worst_f, hold_forward(f"#12 4x256, {P} points (a train_clip step's sweeps)",
                                        fs.sdf_value_fused, fs.sdf_only_plain, sdf, [pts], ("sdf",)))
    spec = fs.spec_from_config(sdf.cfg)
    flat = torch.cat([w.detach().reshape(-1) for w in fs.dense_weights(sdf)])
    grid = ((torch.rand(GRID_CHUNK, 3, generator=g) * 2 - 1) * 1.01).to(dev)
    times = {}
    for tag, x in (("step", pts), ("grid", grid)):
        n = x.shape[0]
        with torch.no_grad():
            times[tag] = (cuda_ms(lambda: fs.sdf_only_fwd(spec, flat, x), reps=5),
                          cuda_ms(lambda: fs.sdf_only_plain(sdf, x), reps=3),
                          bound(fs.sdf_only_flops_per_point(spec) * n, 4 * (flat.numel() + 4 * n)))
    (ms, plain_ms, b), (ms_g, plain_g, b_g) = times["step"], times["grid"]
    print(f"[#12] sdf-only forward, 4x256, {fs.sdf_only_flops_per_point(spec):.0f} GEMM FLOPs a point: "
          f"{P} points (a train_clip step's sweeps) kernel {ms:.3f} ms (plain, no grad, {plain_ms:.3f} ms; "
          f"bound {b['bound_ms']:.3f} ms {b['bound_by']}, bf16 tensor-core {b['bound_ms_bf16_tc']:.3f} ms); "
          f"{GRID_CHUNK}-point grid chunk kernel {ms_g:.3f} ms (plain {plain_g:.3f} ms, bound "
          f"{b_g['bound_ms']:.3f} ms); the VJP (autograd of the plain version) max abs err {worst_b:.3e}")
    del fields, inputs
    torch.cuda.empty_cache()
    return {"name": "sdf_only_fwd", "route": "cuda", "source": "avatarclip_torch/csrc/fused_sdf.cu",
            "replaces": "avatarclip_tpu/ops/fused_sdf.py:626", "max_abs_err": worst_f, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, **b, "ms_grid_chunk": ms_g,
            "plain_ms_grid_chunk": plain_g, "bound_ms_grid_chunk": b_g["bound_ms"]}


def hold_brute(tag, coef, valid, sx, sy, H, W) -> tuple[float, int, int, int]:
    """#15 against the plain version and against B2's winners on one render:
    the largest inverse-depth gap at a near-tie, the near-tie counts against
    each, the covered pixels."""
    from avatarclip_torch.ops import raster_zbuffer as rz

    got = rz.zbuffer_select(coef, valid, H, W)
    g1, n1 = same_winners(f"#15 {tag} vs plain", got, rz.zbuffer_select_plain(coef, valid, H, W), coef, W)
    g2, n2 = same_winners(f"#15 {tag} vs B2", got, rz.zbuffer_select_tiled(coef, valid, sx, sy, H, W), coef, W)
    return max(g1, g2), n1, n2, int((got >= 0).sum())


def check_zbuffer_brute(runner, dev):
    """#15 on the template at 256^2 (three training cameras), on a ragged
    triangle soup (200 x 232, 2,000 faces) and on the 13,441-face ShapeGen
    body at 256^2; timed on that body beside B2 (path f holds it on all of
    ShapeGen's views)."""
    import numpy as np
    import torch

    from avatarclip_torch.pipelines import shape, synthetic
    from avatarclip_torch.render import cameras, raster

    template_v, faces = runner._template
    cases = []
    for it in (0, 1, 2):
        cam, _ = runner.sample_iteration_camera(it, (256,))
        cases.append((f"template 256^2 it{it}", template_v, faces, torch.as_tensor(cam["pose"], device=dev),
                      (256, 256), runner.dataset.focal))
    g = np.random.default_rng(15)
    soup_v = torch.as_tensor(g.normal(0.0, 0.4, (700, 3)).astype(np.float32), device=dev)
    soup_f = torch.as_tensor(g.integers(0, 700, (2000, 3)), device=dev)
    soup_pose = torch.as_tensor(runner_lookat(np.array([0.05, -0.1, 1.6], np.float32)), device=dev)
    cases.append(("triangle soup 200x232, 2,000 faces", soup_v, soup_f, soup_pose, (200, 232), 180.0))
    v, f = synthetic.smpl_size_body()
    body_v = torch.as_tensor(v @ cameras.BODY_TO_WORLD.T, device=dev)
    body_f = torch.as_tensor(f, device=dev).long()
    body_pose = shape._eye_pose(0.0, float(np.deg2rad(-20.0)), 2.2).to(dev)
    body_focal = cameras.focal_from_fov(256, np.deg2rad(60.0))
    cases.append(("13,441-face body 256^2", body_v, body_f, body_pose, (256, 256), body_focal))
    worst = 0.0
    for name, v, f, pose, (H, W), focal in cases:
        proj = raster.project_vertices(v, pose, H, W, focal)
        coef, valid, _ = raster._face_coefficients(proj, f)
        gap, n1, n2, cov = hold_brute(name, coef, valid, proj.sx[f], proj.sy[f], H, W)
        worst = max(worst, gap)
        print(f"[#15] {name}: {cov} covered px; {n1} near-tie differences from the plain version, "
              f"{n2} from B2; equal elsewhere")
    ms, plain_ms, b = time_zbuffer("256^2, the 13,441-face body", body_v, body_f, body_pose, 256, body_focal,
                                   brute=True)
    ms_b2, _, _ = time_zbuffer("256^2, the 13,441-face body", body_v, body_f, body_pose, 256, body_focal)
    return {"name": "zbuffer_brute", "route": "cuda", "source": "avatarclip_torch/csrc/raster_zbuffer.cu",
            "replaces": "avatarclip_tpu/ops/raster_zbuffer.py:104", "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, **b, "ms_b2_same_render": ms_b2}


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def counted_modules():
    from avatarclip_torch.ops import (fused_color, fused_composite, fused_neus, fused_sdf,
                                      fused_soft, raster_zbuffer)

    return (raster_zbuffer, fused_neus, fused_composite, fused_soft, fused_sdf, fused_color)


def zero_counts():
    for m in counted_modules():
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0


def read_counts() -> dict:
    return {k: v for m in counted_modules() for k, v in m.LAUNCHES.items()}


def want_counts(**nonzero) -> dict:
    """Every kernel's launch count 0 but those given."""
    want = {k: 0 for k in read_counts()}
    want.update(nonzero)
    return want


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
    want = want_counts(neus_ray_fwd=N_STEPS, neus_ray_bwd=N_STEPS, zbuffer_tiled=N_STEPS + n_calib,
                       neus_point_fwd=chunks_a, composite_fwd=chunks_a)
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
    want = want_counts(neus_point_fwd=chunks_b, composite_fwd=chunks_b)
    if launches_b != want:
        fail(f"path b: kernel launches {launches_b}, expected {want}")
    print(f"[main b] validate_mesh via appearance.main in {wall_b:.3f} s: 512^3 mesh {nv512} "
          f"vertices, {nt512} triangles, {6 * nv512} bake rays; cast light {cast_shape}, "
          f"{cast_rays} rays; {chunks_b} chunks; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches_b}")
    del runner
    torch.cuda.empty_cache()

    # a'. view interpolation on the step-8 checkpoint
    from avatarclip_torch.utils.jpeg import jpeg_markers
    from avatarclip_torch.utils.mp4 import read_mp4_frames

    zero_counts()
    t0 = time.perf_counter()
    runner = appearance.Runner(conf_path, "interpolate_0_30", conf=resumed_conf(conf_path, sets),
                               is_continue=True)
    video = runner.interpolate_view(0, 30)
    torch.cuda.synchronize()
    wall_i = time.perf_counter() - t0
    launches_i = read_counts()
    if runner.iter_step != N_STEPS:
        fail(f"interpolate_view did not resume the step-{N_STEPS} checkpoint")
    frames = read_mp4_frames(video)
    if len(frames) != 120:
        fail(f"{video} holds {len(frames)} frames, expected 120")
    for fr in frames:
        jpeg_markers(fr)
    n_rays = (runner.dataset.H // 4) * (runner.dataset.W // 4)
    per_frame = math.ceil(n_rays / VAL_CHUNK)
    want = want_counts(neus_point_fwd=60 * per_frame, composite_fwd=60 * per_frame)
    if launches_i != want:
        fail(f"path a': kernel launches {launches_i}, expected {want}")
    print(f"[main a'] interpolate_view(0, 30) on the step-{N_STEPS} checkpoint in {wall_i:.3f} s: "
          f"60 renders of {n_rays} rays, {os.path.basename(video)} 120 frames, "
          f"{os.path.getsize(video)} bytes; launches {launches_i}")
    del runner
    torch.cuda.empty_cache()
    return {k: launches_a[k] + launches_b[k] + launches_i[k] for k in launches_a}, (conf_path, sets)


def resumed_conf(conf_path: str, sets):
    """Path (a)'s conf with its --set overrides, for a Runner resumed from
    its step-8 checkpoint."""
    from avatarclip_torch import config as config_mod

    conf = config_mod.parse_file(conf_path)
    for kv in sets:
        key, _, value = kv.partition("=")
        conf.put(key, config_mod._parse_value(value))
    return conf


# ---------------------------------------------------------------------------
# (e) the NeRF++ background path
# ---------------------------------------------------------------------------

N_OUTSIDE = 32  # the published NeuS confs/womask.conf (the repo's confs set 0)


def run_background_path(tmp: str, pretrain: str) -> tuple[dict, dict]:
    """8 photometric steps with the NeRF++ background on at full width, then
    one 256^2 image; the launches, and B6's and B7's max abs errors on the
    path's own inputs (hold_recorded)."""
    import dataclasses

    import torch

    from avatarclip_torch import config as config_mod
    from avatarclip_torch.fields import networks as nets
    from avatarclip_torch.pipelines import appearance, synthetic

    data = os.path.join(tmp, "views")  # path (a)'s 60 synthetic 256^2 views
    exp = os.path.join(tmp, "exp_background")
    conf = config_mod.parse_string(synthetic.make_conf_text(exp, data, "full"))
    for key, value in (("train.end_iter", N_STEPS), ("train.batch_size", PATH_E_RAYS),
                       ("train.val_freq", 10**6), ("train.val_mesh_freq", 10**6),
                       ("train.save_freq", 10**6), ("train.pretrain", pretrain)):
        conf.put(key, value)
    runner = appearance.Runner(None, mode="train", conf=conf)
    nerf_cfg = appearance.nerf_config(config_mod.parse_file(os.path.join(ROOT, "confs", "examples",
                                                                         "hulk.conf")))
    fields = runner.fields
    fields.nerf = nets.NeRFNetwork(nerf_cfg, torch.Generator().manual_seed(0)).to(runner.device)
    runner.optimizer.add_param_group({"params": fields.nerf.parameters()})
    runner.ncfg = dataclasses.replace(runner.ncfg, n_outside=N_OUTSIDE)
    n_params = {k: sum(p.numel() for p in getattr(fields, k).parameters())
                for k in ("sdf", "color", "variance", "nerf")}

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner.train()
    torch.cuda.synchronize()
    wall_steps = time.perf_counter() - t0
    mem_steps = torch.cuda.max_memory_allocated() / 2**30
    launches_steps = read_counts()
    want = want_counts(sdf_fwd=N_STEPS, sdf_bwd=N_STEPS, color_fwd=N_STEPS, color_bwd=N_STEPS)
    if launches_steps != want:
        fail(f"path e steps: kernel launches {launches_steps}, expected {want}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner.validate_image(idx=0, resolution_level=1)
    torch.cuda.synchronize()
    wall_img = time.perf_counter() - t0
    mem_img = torch.cuda.max_memory_allocated() / 2**30
    launches = read_counts()
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if runner.iter_step != N_STEPS or len(recs) != N_STEPS:
        fail(f"path e took {runner.iter_step} steps, {len(recs)} metric records")
    for r in recs:
        bad = [k for k, v in r.items() if not math.isfinite(v)]
        if bad:
            fail(f"path e step {r['step']}: non-finite {bad}")
    name = f"{N_STEPS:08d}_0_0.png"
    shape = check_png(os.path.join(exp, "validations_fine", name))
    check_png(os.path.join(exp, "validations_extra_fine", name))
    img_rays = runner.dataset.H * runner.dataset.W
    chunks = math.ceil(img_rays / VAL_CHUNK)
    want = want_counts(sdf_fwd=N_STEPS + chunks, sdf_bwd=N_STEPS, color_fwd=N_STEPS + chunks,
                       color_bwd=N_STEPS)
    if launches != want:
        fail(f"path e: kernel launches {launches}, expected {want}")
    median = statistics.median(runner.step_seconds[1:])
    print(f"[main e] NeRF++ background: n_outside {N_OUTSIDE}, NeRF D {nerf_cfg.D} W {nerf_cfg.W} "
          f"(confs/examples/hulk.conf), parameters {n_params}; {N_STEPS} photometric steps of "
          f"{PATH_E_RAYS} rays via Runner.train in {wall_steps:.3f} s, launches after the steps "
          f"{launches_steps}")
    print(f"[main e] losses finite; loss by step {[round(r['loss'], 6) for r in recs]}")
    print(f"[main e] median step time excluding the first: {median * 1e3:.3f} ms (first step "
          f"{runner.step_seconds[0] * 1e3:.3f} ms); peak memory over the steps {mem_steps:.2f} GiB")
    print(f"[main e] one 256^2 image ({img_rays} rays, {chunks} chunks, per_ray=False) in "
          f"{wall_img:.3f} s, PNG {shape}, peak memory {mem_img:.2f} GiB; launches {launches}")

    def step():
        loss, _ = runner.photometric_loss(runner.draw_photometric(), N_STEPS)
        runner._update(loss)

    # B6 / B7 on the inputs and cotangents the path gives them: one more
    # step and one more image with the entries recorded (outside the counts)
    with record_entries() as rec:
        step()
        runner.validate_image(idx=0, resolution_level=1)
    errs = hold_recorded(rec)
    profile_steps("e: background photometric step", step, n=2)
    del runner, fields
    torch.cuda.empty_cache()
    return launches, errs


@contextlib.contextmanager
def record_entries():
    """Within the block, B6's and B7's entries record their first call with
    grad (a training step) and their first without (a render chunk): the
    net, copies of the inputs and, with grad, the cotangents their outputs
    receive in the backward (None for an output that receives none)."""
    import torch

    from avatarclip_torch.ops import fused_color, fused_sdf

    rec = {}

    def recording(mod, name, tag):
        entry = getattr(mod, name)

        def call(net, *ins):
            outs = entry(net, *ins)
            key = (tag, "step" if torch.is_grad_enabled() else "render")
            if key not in rec:
                tup = outs if isinstance(outs, tuple) else (outs,)
                r = rec[key] = {"net": net, "ins": [t.detach().clone() for t in ins],
                                "cots": [None] * len(tup), "shapes": [o.shape for o in tup]}
                for i, o in enumerate(tup):
                    if o.requires_grad:
                        o.register_hook(lambda g, i=i, r=r: r["cots"].__setitem__(i, g.detach().clone()))
            return outs

        setattr(mod, name, call)
        return mod, name, entry

    saved = [recording(fused_sdf, "sdf_with_gradient_fused", "B6"),
             recording(fused_color, "color_apply_fused", "B7")]
    try:
        yield rec
    finally:
        for mod, name, entry in saved:
            setattr(mod, name, entry)


def hold_recorded(rec) -> dict:
    """B6 and B7 held against their plain versions in f64 on path (e)'s
    recorded inputs: the step's 802,816 points forward and backward with the
    step's own cotangents, and a 16,384-ray render chunk's 1,048,576 points
    forward. The nets are dense copies (weight norm resolved), so the weight
    columns are the dense gradients the kernels compute. The max abs errors
    by kernel name."""
    import torch

    from avatarclip_torch.ops import fused_color as fc
    from avatarclip_torch.ops import fused_sdf as fs
    from avatarclip_torch.ops import hold

    want = {("B6", "step"): PATH_E_POINTS, ("B7", "step"): PATH_E_POINTS,
            ("B6", "render"): VAL_CHUNK * 64, ("B7", "render"): VAL_CHUNK * 64}
    got = {k: rec[k]["ins"][0].shape[0] if k in rec else None for k in want}
    if got != want:
        fail(f"path e: B6 / B7 recorded at {got} points, expected {want}")
    errs = {}
    col_names = ("points", "normals", "view_dirs", "features")
    for tag, fused, plain, in_names, out_names, fwd, bwd in (
            ("B6", fs.sdf_with_gradient_fused, fs.sdf_with_gradient_plain, ("points",),
             ("sdf", "feature", "gradient"), "sdf_fwd", "sdf_bwd"),
            ("B7", fc.color_apply_fused, fc.color_apply_plain, col_names, ("rgb",),
             "color_fwd", "color_bwd")):
        r = rec[(tag, "step")]
        net = hold.dense_copy(r["net"])
        cots = [torch.zeros(s, device=r["ins"][0].device) if c is None else c
                for c, s in zip(r["cots"], r["shapes"])]
        errs[fwd], errs[bwd] = hold_net(f"{tag} path e step, {PATH_E_POINTS} points", fused, plain, net,
                                        r["ins"], cots, in_names, out_names, relu_ties=tag == "B7")
        del net, cots, rec[(tag, "step")]
        r = rec[(tag, "render")]
        f_ = hold_forward(f"{tag} path e render chunk, {VAL_CHUNK * 64} points", fused, plain,
                          hold.dense_copy(r["net"]), r["ins"], out_names)
        errs[fwd] = max(errs[fwd], f_)
        del rec[(tag, "render")]
        torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
# AvatarAnimate paths: (c) pose mode, (d) motion mode, through animate.main
# ---------------------------------------------------------------------------

POSE_ITERS = 8
MOTION_ITERS = 8
TEXT = "a rendered 3d man is arguing"


def write_body(data_dir: str) -> int:
    """The procedural humanoid at SMPL's 13,776 faces as the zero-beta
    template OBJ, where assets.load_smpl looks for it; its face count."""
    from avatarclip_torch import assets
    from avatarclip_torch.pipelines import synthetic

    v, f = assets._procedural_humanoid(n_seg=41, n_ring=28)
    synthetic.write_template_obj(data_dir, v, f)
    return f.shape[0]


def write_conf(path: str, exp: str, mode: str, pose_gen: str, motion_gen: str = "") -> str:
    with open(path, "w") as fh:
        fh.write(f"general {{\n    base_exp_dir = {exp}\n    mode = {mode}\n    text = {TEXT}\n}}\n"
                 f"pose_generator {{\n{pose_gen}\n}}\n")
        if motion_gen:
            fh.write(f"motion_generator {{\n{motion_gen}\n}}\n")
    return path


def check_jpeg(path: str) -> int:
    from avatarclip_torch.utils.jpeg import jpeg_markers

    if not os.path.exists(path):
        fail(f"missing {path}")
    with open(path, "rb") as fh:
        data = fh.read()
    jpeg_markers(data)  # raises on a malformed stream
    return len(data)


def check_losses(tag: str, losses) -> list:
    vals = [float(x) for x in losses]
    if not vals or not all(math.isfinite(v) for v in vals):
        fail(f"{tag}: losses {vals}")
    return vals


def expect(tag: str, got: dict, soft: int, zbuffer: int) -> None:
    want = {k: 0 for k in got}
    want.update(soft_fwd=soft, soft_bwd=soft, zbuffer_tiled=zbuffer)
    if got != want:
        fail(f"{tag}: kernel launches {got}, expected {want}")


def profile_steps(tag: str, step, n: int = 4) -> None:
    """Device time by kernel over n steps under torch.profiler (one warm-up
    step first), per step, and the device's busy share of the window's wall
    time. These launches fall outside the counted paths."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
        if t > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev.append((t / 1e3 / n, e.key))
    if not dev:
        print(f"[profile {tag}] the profiler saw no device time: breakdown not measured")
        return
    busy = sum(t for t, _ in dev)
    dev.sort(reverse=True)
    top = "; ".join(f"{k[:48]} {t:.3f}" for t, k in dev[:8])
    print(f"[profile {tag}] {n} steps, wall {wall / n * 1e3:.3f} ms per step under the profiler, device "
          f"busy {busy:.3f} ms ({busy / (wall / n * 1e3):.1%}); ms per step by kernel: {top}")


def run_animate_paths(tmp: str) -> dict:
    """Paths (c) and (d) and the other generators; the summed launches."""
    import numpy as np
    import torch

    from avatarclip_torch.pipelines import animate
    from avatarclip_torch.utils.mp4 import read_mp4_frames

    data = os.path.join(tmp, "animate_data")
    os.makedirs(data)
    n_faces = write_body(data)
    use_body_dir(data)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # c. pose mode: PoseOptimizer, 2 restarts x 8 steps, scoring, 2 pictures
    exp_c = os.path.join(tmp, "exp_pose")
    conf = write_conf(os.path.join(tmp, "pose.conf"), exp_c, "pose",
                      f"    type = PoseOptimizer\n    topk = 2\n    num_iteration = {POSE_ITERS}")
    zero_counts()
    t0 = time.perf_counter()
    out = animate.main(["--conf", conf])
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    got = read_counts()
    add(got)
    ctx, gen = out["ctx"], out["pose_generator"]
    if ctx.faces.shape[0] != n_faces:
        fail(f"path c posed {ctx.faces.shape[0]} faces, not the {n_faces} of the written body")
    losses = check_losses("path c", gen.losses)
    if len(losses) != 2 * POSE_ITERS:
        fail(f"path c took {len(losses)} steps")
    sizes = []
    for i in range(2):
        pose = np.load(os.path.join(exp_c, f"candidate_{i}.npy"))
        if pose.shape != (69,) or not np.isfinite(pose).all():
            fail(f"candidate_{i}.npy: shape {pose.shape}, finite {np.isfinite(pose).all()}")
        sizes.append(check_jpeg(os.path.join(exp_c, f"candidate_{i}.jpg")))
    # one soft render of the 5 views per step; scoring: 2 candidates x 5 views; 2 pictures
    expect("path c", got, 2 * POSE_ITERS, 2 * 5 + 2)
    print(f"[main c] pose mode via animate.main (PoseOptimizer, 2 x {POSE_ITERS} steps, 5 views x "
          f"224^2 x {n_faces} faces, CLIP ViT-B/32 random init) in {wall_c:.3f} s; launches {got}")
    print(f"[main c] losses finite: {[round(v, 6) for v in losses]}")
    print(f"[main c] median step {gen.median_step_s() * 1e3:.3f} ms (first {gen.timing['first_step_s'] * 1e3:.3f} "
          f"ms); candidate_0/1.npy (69,), JPEGs of {sizes} bytes at 512^2, JPEG writes "
          f"{[round(t * 1e3, 3) for t in out['jpeg_write_s']]} ms host")
    tf = ctx.get_text_feature(TEXT)
    var = gen.draw_init().to(ctx.device).requires_grad_(True)
    opt = gen.make_optimizer(var)
    profile_steps("c: PoseOptimizer step", lambda: gen.step(var, opt, tf, gen.draw_step()))

    zero_counts()
    vgen = animate.build_pose_generator({"type": "VPoserOptimizer", "topk": 1, "num_iteration": 4}, ctx=ctx)
    poses = vgen.get_topk_poses(TEXT)
    torch.cuda.synchronize()
    got = read_counts()
    add(got)
    check_losses("VPoserOptimizer", vgen.losses)
    if poses.shape != (1, 69) or not torch.isfinite(poses).all():
        fail(f"VPoserOptimizer poses {tuple(poses.shape)}")
    expect("VPoserOptimizer", got, 4, 5)
    print(f"[main c] VPoserOptimizer (1 x 4 steps): median step {vgen.median_step_s() * 1e3:.3f} ms; "
          f"launches {got}")
    zero_counts()
    rgen = animate.build_pose_generator({"type": "VPoserRealNVP", "topk": 1, "num_batch": 2}, ctx=ctx)
    poses = rgen.get_topk_poses(TEXT)
    torch.cuda.synchronize()
    got = read_counts()
    add(got)
    if poses.shape != (1, 69) or not torch.isfinite(poses).all():
        fail(f"VPoserRealNVP poses {tuple(poses.shape)}")
    expect("VPoserRealNVP", got, 0, 2 * rgen.num_sample * 5 + 5)
    print(f"[main c] VPoserRealNVP (2 batches of {rgen.num_sample}, hard-scored): median batch "
          f"{rgen.median_step_s() * 1e3:.3f} ms; launches {got}")

    # d. motion mode: VPoserCodebook candidates, MotionOptimizer, 60 frames
    exp_d = os.path.join(tmp, "exp_motion")
    conf = write_conf(os.path.join(tmp, "motion.conf"), exp_d, "motion", "    type = VPoserCodebook",
                      f"    type = MotionOptimizer\n    num_iteration = {MOTION_ITERS}")
    zero_counts()
    t0 = time.perf_counter()
    out = animate.main(["--conf", conf])
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    got = read_counts()
    add(got)
    mgen, cands = out["motion_generator"], out["candidates"]
    losses = check_losses("path d", mgen.losses)
    if len(losses) != MOTION_ITERS:
        fail(f"path d took {len(losses)} steps")
    motion = np.load(os.path.join(exp_d, "motion.npy"))
    if motion.shape != (60, 69) or not np.isfinite(motion).all():
        fail(f"motion.npy: shape {motion.shape}")
    frames = read_mp4_frames(os.path.join(exp_d, "motion.mp4"))
    if len(frames) != 60:
        fail(f"motion.mp4 holds {len(frames)} frames")
    from avatarclip_torch.utils.jpeg import jpeg_markers

    for fr in frames:
        jpeg_markers(fr)
    n_c = cands.shape[0]
    # one soft render of the n_part = 2 strided frames per step; the candidates' and the frames' pictures
    expect("path d", got, MOTION_ITERS, n_c + 60)
    print(f"[main d] motion mode via animate.main (VPoserCodebook {n_c} candidates, MotionOptimizer "
          f"{MOTION_ITERS} steps, 2 frames x 224^2 per step) in {wall_d:.3f} s; launches {got}")
    print(f"[main d] losses finite: {[round(v, 6) for v in losses]}; median step "
          f"{mgen.median_step_s() * 1e3:.3f} ms (first {mgen.timing['first_step_s'] * 1e3:.3f} ms)")
    lat = mgen.draw_init().to(mgen.ctx.device).requires_grad_(True)
    opt = torch.optim.Adam([lat], lr=0.01)
    p63, tf_d = cands[:, :63], mgen.ctx.get_text_feature(TEXT)
    profile_steps("d: MotionOptimizer step", lambda: mgen.step(lat, opt, p63, tf_d, mgen.draw_step()))
    print(f"[main d] motion.npy (60, 69) finite; motion.mp4 60 frames, "
          f"{os.path.getsize(os.path.join(exp_d, 'motion.mp4'))} bytes; MP4 write (60 JPEG encodes + mux) "
          f"{out['mp4_write_s']:.3f} s host")
    zero_counts()
    igen = animate.build_motion_generator({"type": "MotionInterpolation"}, ctx=ctx)
    if n_c != len(igen.anchor_position):
        fail(f"{n_c} candidates for {len(igen.anchor_position)} interpolation anchors")
    motion = igen.get_motion(TEXT, cands)
    torch.cuda.synchronize()
    got = read_counts()
    add(got)
    if motion.shape != (60, 69) or not torch.isfinite(motion).all():
        fail(f"MotionInterpolation motion {tuple(motion.shape)}")
    expect("MotionInterpolation", got, 0, 0)
    print(f"[main d] MotionInterpolation: (60, 69) finite; launches {got}")
    return total


# ---------------------------------------------------------------------------
# (f) ShapeGen, (g) the export, (h) the sweep hook
# ---------------------------------------------------------------------------

SHAPE_TEXT = "a 3d rendering of a strong man in unreal engine"  # the gen CLI's default target
VAE_DEC_SCALE = 0.005  # the seeded decoder's last layer, scaled: offsets of a few mm


def use_body_dir(path: str | None) -> None:
    """Point both asset lookups at ``path`` ($AVATARCLIP_TPU_DATA; None
    unsets it) and drop the cached body."""
    from avatarclip_torch import assets

    if path is None:
        os.environ.pop("AVATARCLIP_TPU_DATA", None)
    else:
        os.environ["AVATARCLIP_TPU_DATA"] = path
    assets.load_smpl.cache_clear()
    assets.load_smpl_uv.cache_clear()


@contextlib.contextmanager
def record_zbuffer():
    """Within the block, B2's entry records every call's inputs (copies)."""
    from avatarclip_torch.ops import raster_zbuffer as rz

    entry, rec = rz.zbuffer_select_tiled, []

    def call(coef, valid, sx, sy, H, W):
        rec.append([t.detach().clone() for t in (coef, valid, sx, sy)] + [H, W])
        return entry(coef, valid, sx, sy, H, W)

    rz.zbuffer_select_tiled = call
    try:
        yield rec
    finally:
        rz.zbuffer_select_tiled = entry


def run_shape_path(tmp: str, dev):
    """ShapeGen through shape.main: ``gen`` (the seeded full-width VAE, a
    seeded 256 x (16, 512) codebook, ViT-B/32 random init, one 256^2 render)
    and ``render`` (108 views at 256^2 with transforms_train.json), read
    back through the dataset loader. The launches and B2's recorded inputs."""
    import numpy as np
    import torch

    from avatarclip_torch import config as config_mod
    from avatarclip_torch.export import mesh_io
    from avatarclip_torch.pipelines import dataset, shape, synthetic
    from avatarclip_torch.utils.pytree import tree_flatten_paths

    data = os.path.join(tmp, "shape_data")
    os.makedirs(data)
    v, f = synthetic.smpl_size_body()
    synthetic.write_template_obj(data, v, f)
    use_body_dir(data)
    t0 = time.perf_counter()
    vae = shape.vae_init(torch.Generator().manual_seed(16))
    for k in ("w", "b"):
        vae["dec2"][k] *= VAE_DEC_SCALE
    vae_path, cb_path = os.path.join(tmp, "shape_vae.npz"), os.path.join(tmp, "shape_codebook.npz")
    np.savez(vae_path, **tree_flatten_paths(vae))
    g = np.random.default_rng(17)
    np.savez(cb_path, codebook=g.normal(size=(256, shape.LATENT_DIM)).astype(np.float32),
             codebook_embedding=g.normal(size=(256, 512)).astype(np.float32))
    n_vae = sum(t.numel() for d in vae.values() for t in d.values())
    del vae
    setup_s = time.perf_counter() - t0

    out, render_dir = os.path.join(tmp, "coarse_shape"), os.path.join(tmp, "shape_render")
    zero_counts()
    with record_zbuffer() as views:
        t0 = time.perf_counter()
        gen = shape.main(["gen", "--AE_path_fname", vae_path, "--codebook_fname", cb_path,
                          "--output_folder", out])
        torch.cuda.synchronize()
        wall_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        ren = shape.main(["render", "--coarse_shape_obj", gen["obj"], "--pose_type", "stand_pose",
                          "--output_folder", render_dir])
        torch.cuda.synchronize()
        wall_render = time.perf_counter() - t0
    launches = read_counts()
    want = want_counts(zbuffer_tiled=1 + 108)
    if launches != want:
        fail(f"path f: kernel launches {launches}, expected {want}")
    if os.path.basename(gen["obj"]) != "_".join(SHAPE_TEXT.split(" ")) + ".obj":
        fail(f"path f: gen wrote {gen['obj']}")
    body, faces, _, _ = mesh_io.read_obj(gen["obj"])
    off = float(np.abs(body - v).max()) if body.shape == v.shape else float("nan")
    if body.shape != (shape.N_VERTS, 3) or len(faces) != len(f) or not 0.0 < off < 0.03:
        fail(f"path f: coarse body {body.shape}, {len(faces)} faces, largest offset {off}")
    ds = dataset.SMPLViewDataset(config_mod.parse_string(f"data_dir = {render_dir}"), dev)
    eyes = ds.poses[:, :3, 3].norm(dim=-1)
    cover = ds.masks.mean(dim=(1, 2))
    if ren["views"] != 108 or ds.n_images != 108 or (ds.H, ds.W) != (256, 256):
        fail(f"path f: {ren['views']} views written, {ds.n_images} read at {ds.H}x{ds.W}")
    if not torch.allclose(eyes, torch.full_like(eyes, 2.2), atol=1e-4) or not (cover > 0.01).all():
        fail(f"path f: eye distances {eyes.min():.5f}-{eyes.max():.5f}, coverage min {cover.min():.4f}")
    print(f"[main f] ShapeGen via shape.main: seeded VAE ({n_vae} parameters, 16 -> 8192 -> 20670) and "
          f"codebook written in {setup_s:.3f} s; gen (ViT-B/32 random init, one 256^2 render) "
          f"{wall_gen:.3f} s -> {os.path.basename(gen['obj'])}, {body.shape[0]} vertices, largest offset "
          f"{off * 100:.3f} cm; render 108 views at 256^2 + PNGs {wall_render:.3f} s; read back: eyes at "
          f"{float(eyes.mean()):.6f}, coverage {float(cover.min()):.4f}-{float(cover.max()):.4f}; launches "
          f"{launches}")
    del ds
    return launches, views


def hold_brute_on_views(views) -> float:
    """#15 against its plain version and B2 on every render path (f) gave
    B2; the largest near-tie inverse-depth gap."""
    worst, ties, cov = 0.0, [0, 0], 0
    t0 = time.perf_counter()
    for i, (coef, valid, sx, sy, H, W) in enumerate(views):
        gap, n1, n2, c = hold_brute(f"path f render {i}", coef, valid, sx, sy, H, W)
        worst, ties, cov = max(worst, gap), [ties[0] + n1, ties[1] + n2], cov + c
    print(f"[#15] on path (f)'s {len(views)} renders of the {views[0][0].shape[0]}-face body "
          f"({views[0][4]}x{views[0][5]}): {cov} covered px in all, {ties[0]} near-tie differences from "
          f"the plain version and {ties[1]} from B2, equal elsewhere ({time.perf_counter() - t0:.3f} s)")
    return worst


def run_export_path(tmp: str, mesh: str, motion: str, body_dir: str | None) -> dict:
    """drive.main and rigged.main (GLB with the motion baked, FBX ASCII) on
    path (b)'s 512^3 PLY and path (d)'s motion, on the body (a) and (b) used;
    the launches (none: the export runs no kernel)."""
    import struct

    import numpy as np
    import torch

    from avatarclip_torch.export import drive, rigged

    use_body_dir(body_dir)
    pc2, glb, fbx = (os.path.join(tmp, f"avatar.{x}") for x in ("pc2", "glb", "fbx"))
    zero_counts()
    t0 = time.perf_counter()
    t_drive = drive.main(["--mesh", mesh, "--motion", motion, "--out", pc2])
    wall_drive = time.perf_counter() - t0
    t0 = time.perf_counter()
    t_glb = rigged.main(["--ply", mesh, "--out", glb, "--motion", motion])
    wall_glb = time.perf_counter() - t0
    t0 = time.perf_counter()
    t_fbx = rigged.main(["--ply", mesh, "--out", fbx])
    wall_fbx = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_counts()
    if launches != want_counts():
        fail(f"path g: kernel launches {launches}, expected none")
    n_frames = np.load(motion).shape[0]
    with open(pc2, "rb") as fh:
        head = struct.unpack("<12siiffi", fh.read(32))
    V = t_drive["vertices"]
    if head != (b"POINTCACHE2\0", 1, V, 0.0, 1.0, n_frames) or os.path.getsize(pc2) != 32 + n_frames * V * 12:
        fail(f"path g: .pc2 header {head}, {os.path.getsize(pc2)} bytes for {n_frames} x {V} vertices")
    frames = np.fromfile(pc2, "<f4", offset=32).reshape(n_frames, V, 3)
    moved = float(np.abs(frames[1:] - frames[:-1]).max())
    if not np.isfinite(frames).all() or not moved > 1e-3:
        fail(f"path g: frames finite {np.isfinite(frames).all()}, largest move between frames {moved}")
    js, _ = rigged.read_glb(glb)
    anim = js.get("animations", [{}])[0]
    counts = {js["accessors"][sm["input"]]["count"] for sm in anim.get("samplers", [])}
    if len(js["skins"][0]["joints"]) != 24 or len(anim.get("channels", [])) != 24 or counts != {n_frames}:
        fail(f"path g: GLB skin {len(js['skins'][0]['joints'])} joints, animation "
             f"{len(anim.get('channels', []))} channels, samples {counts}")
    with open(fbx) as fh:
        text = fh.read()
    if "FBXVersion: 7300" not in text or text.count('"Model::mixamorig:') != 24:
        fail("path g: the FBX lacks its header or its 24 limb nodes")
    fmt = lambda t: ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in t.items())
    print(f"[main g] drive.main on path (b)'s {t_drive['mesh_vertices']}-vertex 512^3 mesh ({V} vertices "
          f"in its largest island) and path (d)'s motion: {wall_drive:.3f} s, a {n_frames}-frame .pc2 of "
          f"{os.path.getsize(pc2)} bytes, finite, largest move between frames {moved:.4f}; phases: "
          f"{fmt(t_drive)}")
    print(f"[main g] rigged.main .glb with the motion baked: {wall_glb:.3f} s, {t_glb['vertices']} vertices "
          f"after clustering, 24 joints, {n_frames} samples a channel, {os.path.getsize(glb)} bytes; phases: "
          f"{fmt(t_glb)}")
    print(f"[main g] rigged.main .fbx (ASCII 7.3): {wall_fbx:.3f} s, {os.path.getsize(fbx)} bytes; phases: "
          f"{fmt(t_fbx)}; launches {launches}")
    return launches


def run_sweep_hook_path(conf_path: str, sets) -> dict:
    """networks._SWEEP_KERNEL on against off on (a)'s step-8 checkpoint: the
    validate_mesh mode's 512^3 extraction (its grid query through
    networks.sdf_value) and one train_clip step at the same seed. The
    runners of the holds compute in float32 (train.compute_dtype): #12
    computes in f32 whatever the conf says, and the confs' default, bf16
    operands in the plain module (the JAX package's operand type), would set
    the precision gap against it rather than hold the kernel. That gap, what
    a user at the conf's own dtype sees on turning the hook on, is printed as
    a reading: one more hook-off extraction at the conf's dtype against the
    hook-on grid. The launches of all."""
    import numpy as np
    import torch

    from avatarclip_torch.export import marching_cubes as mc
    from avatarclip_torch.fields import networks as nets
    from avatarclip_torch.pipelines import appearance

    def resumed(f32: bool = True):
        conf = resumed_conf(conf_path, sets)
        if f32:
            conf.put("train.compute_dtype", "float32")
        r = appearance.Runner(conf_path, "sweep_hook", conf=conf, is_continue=True)
        if r.iter_step != N_STEPS:
            fail(f"path h did not resume the step-{N_STEPS} checkpoint")
        return r

    total = want_counts()

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    def extract(runner):
        """validate_mesh's 512^3 grid through networks.sdf_value: (grid,
        marching-cubes vertices, chunks, launches, seconds)."""
        calls = [0]
        ds = runner.dataset

        def query(pts):
            calls[0] += 1
            return -nets.sdf_value(runner.fields.sdf, pts)[..., 0]

        zero_counts()
        t0 = time.perf_counter()
        u = mc.extract_fields(ds.object_bbox_min, ds.object_bbox_max, 512, query, threshold=0.0,
                              device=runner.device)
        wall = time.perf_counter() - t0
        counts = read_counts()
        add(counts)
        return u, len(mc.marching_cubes(u, 0.0)[0]), calls[0], counts, wall

    runner, grid, step = resumed(), {}, {}
    try:
        for hook in (False, True):
            nets._SWEEP_KERNEL = hook
            grid[hook] = extract(runner)
        nets._SWEEP_KERNEL = False
        del runner
        runner = resumed(f32=False)
        conf_dtype = runner.conf.get_string("train.compute_dtype", "bfloat16")
        grid["conf"] = extract(runner)
        del runner
        for hook in (False, True):
            r = resumed()
            r.init_clip()
            r.init_smpl()
            cam, S = r.sample_iteration_camera(r.iter_step)
            nets._SWEEP_KERNEL = hook
            zero_counts()
            t0 = time.perf_counter()
            loss, _ = r.clip_loss(S, cam, r.draw_clip(S), r.iter_step)
            r._update(loss)
            torch.cuda.synchronize()
            counts = read_counts()
            add(counts)
            # the coarse samples' query and one a non-final up-sample step
            sweeps = 1 + r.ncfg.up_sample_steps - 1
            step[hook] = (float(loss.detach()), counts, time.perf_counter() - t0, S)
            nets._SWEEP_KERNEL = False
            del r
            torch.cuda.empty_cache()
    finally:
        nets._SWEEP_KERNEL = False

    (u0, nv0, c0, k0, w0), (u1, nv1, c1, k1, w1) = grid[False], grid[True]
    rel = float(np.abs(u1 - u0).max()) / max(float(np.abs(u0).max()), 1e-12)
    if k0 != want_counts() or k1 != want_counts(sdf_only_fwd=c1):
        fail(f"path h grid: launches hook off {k0}, hook on {k1} for {c1} chunks")
    if not rel <= 1e-5 or not abs(nv1 - nv0) <= 1e-3 * nv0:
        fail(f"path h grid: hook on vs off rel err {rel:.2e}, vertices {nv1} vs {nv0}")
    u_c, nv_c, c_c, k_c, w_c = grid["conf"]
    if k_c != want_counts():
        fail(f"path h grid at the conf's dtype, hook off: launches {k_c}")
    rel_c = float(np.abs(u1 - u_c).max()) / max(float(np.abs(u_c).max()), 1e-12)
    (l0, s0, t_0, S), (l1, s1, t_1, _) = step[False], step[True]
    if s0["sdf_only_fwd"] != 0 or s1 != {**s0, "sdf_only_fwd": sweeps}:
        fail(f"path h step: launches hook off {s0}, hook on {s1}")
    if not abs(l1 - l0) <= 1e-4 * abs(l0):
        fail(f"path h step: loss hook on {l1} vs off {l0}")
    print(f"[main h] the sweep hook, float32 runners: validate_mesh's 512^3 extraction, hook off "
          f"{w0:.3f} s ({c0} chunks), on {w1:.3f} s ({c1} chunks, #12 launched {k1['sdf_only_fwd']} "
          f"times); grid rel err {rel:.3e}, marching-cubes vertices {nv1} vs {nv0}")
    print(f"[main h] reading, not a hold: at the conf's compute_dtype ({conf_dtype}) the hook-off grid "
          f"({w_c:.3f} s, {c_c} chunks) is {rel_c:.3e} relative from the hook-on (f32 kernel) grid, "
          f"marching-cubes vertices {nv_c} off vs {nv1} on ({(nv1 - nv_c) / nv_c * 100:+.3f}%)")
    print(f"[main h] one train_clip step from the step-{N_STEPS} checkpoint ({S}^2 bucket): loss hook off "
          f"{l0:.7f}, on {l1:.7f} (rel {abs(l1 - l0) / abs(l0):.2e}); {t_0 * 1e3:.3f} / {t_1 * 1e3:.3f} ms "
          f"(first step of a runner); #12 launches {s1['sdf_only_fwd']}; launches hook on {s1}")
    return total


def main() -> None:
    kernels_only = "--kernels-only" in sys.argv[1:]
    body_dir = os.environ.get("AVATARCLIP_TPU_DATA")  # the body paths a, b and g use
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
            ("fused_neus_point", "fused_neus_point.cu"), ("fused_composite", "fused_composite.cu"),
            ("fused_soft", "fused_soft.cu"), ("fused_sdf", "fused_sdf.cu"),
            ("fused_color", "fused_color.cu")]
    _build.load_all(libs)
    _build.load_host("marching_cubes", "marching_cubes.cpp")
    _build.load_host("mesh_ops", "mesh_ops.cpp")
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
        kernels = [check_zbuffer(runner, dev), check_zbuffer_brute(runner, dev)]
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
        kernels += check_soft(dev)
        torch.cuda.empty_cache()
        kernels += check_sdf(dev)
        torch.cuda.empty_cache()
        kernels += check_colour(dev)
        torch.cuda.empty_cache()
        kernels.append(check_sdf_only(dev))
        torch.cuda.empty_cache()
        if kernels_only:  # no main path ran: no launch count to report
            launches = {k["name"]: None for k in kernels}
        else:
            launches, (conf_path, sets) = run_main_path(tmp, pretrain)
            torch.cuda.empty_cache()

            def add(counts):
                for k, v in counts.items():
                    launches[k] += v

            add(run_sweep_hook_path(conf_path, sets))
            torch.cuda.empty_cache()
            add(run_animate_paths(tmp))
            torch.cuda.empty_cache()
            counts, path_errs = run_background_path(tmp, pretrain)
            add(counts)
            for k in kernels:  # B6 / B7 held on path (e)'s own inputs too
                k["max_abs_err"] = max(k["max_abs_err"], path_errs.get(k["name"], 0.0))
            torch.cuda.empty_cache()
            counts, views = run_shape_path(tmp, dev)
            add(counts)
            for k in kernels:  # #15 held on path (f)'s renders too
                if k["name"] == "zbuffer_brute":
                    k["max_abs_err"] = max(k["max_abs_err"], hold_brute_on_views(views))
            del views
            torch.cuda.empty_cache()
            add(run_export_path(tmp, os.path.join(tmp, "exp", "meshes", f"{N_STEPS:08d}.ply"),
                                os.path.join(tmp, "exp_motion", "motion.npy"), body_dir))
    if len(kernels) != 15:
        fail(f"{len(kernels)} kernels checked, expected 15")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if any(m.split(".")[0] in ("jax", "avatarclip_tpu") for m in sys.modules):
        fail("jax or the JAX package was imported")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
