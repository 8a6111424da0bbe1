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
     - B2, the binned z-buffer: the template at 256^2 and 128^2, a random
       triangle soup, the animate paths' 13,776-face body at the five 224^2
       scoring views and visualize's 512^2 camera, and ShapeGen's
       13,441-face body at 256^2, equal to the plain version at every pixel,
       one counted launch a call, two launches the same bits; timed on the
       256^2 template, the 512^2 body and the 13,441-face body, through its
       entry and as the bare C call;
     - #15, the brute-force z-buffer: against the plain version and B2's
       winners, bit for bit, on the template at 256^2, a ragged triangle
       soup and the 13,441-face ShapeGen body at 256^2 (the body also at
       forced face splits of 1 and 2), and on path f's 109 renders; timed on
       that body beside B2 and on the 13,776-face body at 512^2, each beside
       B2's bound and its own all-pairs floor;
     - B1, the per-ray NeuS pair, and B3, the point-level NeuS pair: forward
       and backward at 256 and 128 wide on 2,048 rays x 64 samples against
       the plain version evaluated in float64, outputs to 1e-4 and gradients
       to 1e-3 of their largest magnitude; B3's forward also under no_grad
       at the validation chunk of 16,384 rays x 64 and at a ragged 16,347
       (4x256 / 2x256 nets); in the bf16 operand mode (B1 and B3: the
       tensor-core pairs) each is
       held against the plain version in float64 of the f32 function beside
       its plain bf16 version (relative RMS), B3's forward again under
       no_grad at 16,384 and 16,347 rays, and B1 again at the training
       step's 12,544 rays x 64 with its float64 reference in 1,024-ray
       chunks, by relative RMS and by its worst ray; B1's kernels timed there
       (the median of 5 calls; the bf16 forward must be below its f32
       CUDA-core bound), B3 at 16,384 rays x 64 in both modes (its bf16
       forward's and backward's comparisons with that bound printed, not
       checked; the backward's two calls equal);
     - B4, the compositing pair: rgb width 6 and 3 on 2,048 rays x 64 against
       float64, same tolerances, and its forward under no_grad and its
       backward at 16,384 and 16,347 rays, at S 64, 48 and 37, on inputs 0-3
       floats past a 16-byte boundary (the backward also onto outputs at
       another offset, and twice: the same bits); timed at 16,384 rays x 64,
       warm (the same inputs back to back) and cold (the L2 flushed before
       each launch by writing, or reading, 128 MB);
     - B5, the soft aggregation pair: forward and backward against the plain
       version in float64 (outputs to 1e-4 of their largest magnitude, the
       rgb and silhouette to 2e-4 absolute, the gradients of the x, y and
       constant edge coefficients, ezf and colf each to 1e-3 of its own
       largest magnitude) at one PoseOptimizer step's shapes (5 views x
       224^2 x the 13,776-face body, sigma 0.5), at one MotionOptimizer
       step's (2 views), at a ragged 200 x 136 x 1,000 faces and on a
       compact 320^2 scene at sigma 0.1 where the culling table skips pairs;
       two launches of each kernel give the same bits; timed at the pose and
       the motion step's shapes (each kernel with the kernel that sums its
       partials), with the pairs the table keeps, the pairs the kernels
       evaluate and the live ones (every live pair must be evaluated), and
       the bound of the live pairs' work (f32 operations, special functions
       and bytes);
     - B6, the standalone SDF pair (4x256), and B7, the colour pair (2x256):
       forward and backward on 2,048 rays x 64 samples' points and on a
       ragged 131,071 of them against the plain version in float64, with
       cotangents on every output; outputs to 1e-4 and each gradient column
       (d(points) or d(inputs), and each weight) to 1e-3 of its own largest
       magnitude, at every point (at B7's relu near-ties the f64 input
       cotangents take the masks the kernel took, ops/hold.py); B7 in
       no_view_dir with the extra head and in idr without it; in the bf16
       mode (both pairs: the tensor-core kernels) held as B1 is, at 256 and
       128 wide on the ragged count; both timed at path (e)'s 802,816
       points a step in both modes, each bf16 kernel beside its plain
       version, its bounds and its TFLOP/s (and held there in path e);
     - #12, the sdf-only forward, through its entry (backward: autograd of
       the plain version) against the plain version in float64 at 4x256
       and 3x128 on 2,048 rays x 56 sweep points and on a ragged 131,071
       points (the sdf to 1e-4, its VJP to 1e-3), and its forward at one
       train_clip step's 12,544 x 56 points and on a 262,144-point grid
       chunk; in the bf16 mode (the tensor-core kernel) held as B1 is at
       4x256 and 3x128 on a ragged 114,687 points and on the grid chunk;
       timed on the step's points and the grid chunk in both operand modes,
       with the bf16 kernel's pack timed alone;
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
        256^3 mesh and saves a checkpoint; then, outside the counts, B1 held
        on one step's own 12,544 rays, nets and cotangents as in phase 3,
        and one step from the checkpoint through the megakernel against the
        gate shut (B6 / B7 per sample) at the conf's bf16: the losses, the
        parameter gradients and the Adam updates held together;
     b. ``appearance.main --mode validate_mesh --is_continue``: the 512^3
        extraction with its colour baking, then the cast-light head render;
     a'. ``Runner.interpolate_view(0, 30)`` on a Runner resumed from (a)'s
        checkpoint: 60 renders at resolution level 4 and their reversal as a
        120-frame MP4;
     h. the sweep hook (``networks._SWEEP_KERNEL``) on against off on (a)'s
        checkpoint, computing in float32 (#12's f32 kernel; the confs' bf16
        operands would measure the precision gap, not the kernel): the
        validate_mesh mode's 512^3 extraction (grids within
        1e-5, vertex counts within 0.1%, #12 once a grid chunk) and one
        train_clip step at the same seed (losses within 1e-4, #12 four
        times: the coarse query and three up-sample sweeps); then the
        extraction hook off and on at the conf's bf16 (#12 on the tensor
        cores once a grid chunk), its wall seconds beside the hook-off
        extraction's and the grids' gap printed as a reading;
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
     i. the reference schedule's self-generated route through the user-stage
        scripts (``avatarclip_torch.scripts.run_reference_schedule``'s stage
        functions in-process, the experiment root in the run's temporary
        directory, their ``make_runner`` wrapped to put ``train.end_iter`` =
        ``train.save_freq`` = 8) on (f)'s coarse body and 108-view render:
        pretrain (PRETRAIN_CONF's 4x256 / 2x256 nets, batch 5,120, 8
        steps), ``eval_photometric`` on views 0, 27, 54 and 81 at level 1,
        sculpt (SCULPT_CONF, ViT-B/32 random init, 8 train_clip steps, the
        CLIP score of 8 views and the face camera before and after),
        ``Runner.profile_trace`` of 3 steps on the sculpt checkpoint, extract
        at 256^3 and export; checks the stage log's order, the evals'
        numbers, the trace (B1's and B2's kernels at 3 steps' launches) and
        the launches; then, outside the counts, ``clip_score`` through the
        kernels against the plain path (``neus._FORCE_MEGA = False``) on the
        sculpt checkpoint: one lattice view's image (65,536 rays) within
        ``hold.bf16_within`` of the f32 function in f64 beside the plain bf16
        version, on the samples the render took, the 9 views' cosines within
        1e-3, two kernel-path calls equal; the stages' wall seconds, the
        eval's renders per second and one eval under the profiler;
     g. the export: ``drive.main`` (a 60-frame .pc2) and ``rigged.main``
        (a GLB with the motion baked, an FBX ASCII) on (b)'s 512^3 mesh and
        (d)'s motion, with each phase's seconds;
     j. data-parallel training (``avatarclip_torch.parallel.dryrun``) on 2
        gloo ranks sharing the card, each rank a process counting its own
        launches, against N = 1 in this process: one train_clip step (12,544
        rays, 6,272 a rank) and one photometric step of the full-scale
        runner, the summed gradients before Adam, the parameters after it
        and the metrics at JAX's tolerances, the replicas equal to the bit,
        six more steps timed; the kernel-path gradient (JAX's dryrun check)
        at 4,096 rays x 64 through render_core per_ray False (B3's and B4's
        backward: #5 and #7) and True, in bf16 (held by hold.bf16_within at
        N and at 1) and f32 (N against 1 and each against f64); then
        ``graft_entry.entry()``;
     and checks the losses, the artifacts, and the launch counts against
     the counts predicted from the ray, step and render counts (paths a-d
     launch B6 / B7 no time: the megakernels take those renders; path j
     launches #5 and #7 twice a rank and twice at N = 1; no path launches
     #15, which no default path of the JAX package runs either);
     c, d, e and i also profile a few steps (device time by kernel, busy share).
Prints a {"kernels": [...]} JSON line, then as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
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
F32_LANE_OPS = 132 * 128 * 1.98e9  # H100 SXM f32 operations/s issued one a lane (no FMA): 3.35e13
VAL_CHUNK = 16384  # render_rays_chunked's chunk: max(batch_size, 16384)
PRETRAIN_L1 = 0.05  # the template fit's last mean |sdf - target| (CPU fits end near 0.02)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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
    from avatarclip_torch.pipelines import synthetic, visualize
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
    body_v, body_f, body_poses, body_focal = synthetic.humanoid_views(dev, elev_std=0.0)
    for k, azim in enumerate((120, 150, 180, 210, 240)):
        cases.append((f"13,776-face body 224^2 azimuth {azim}", body_v[0], body_f, body_poses[k], 224,
                      body_focal))
    vis_pose, vis_focal = visualize.camera(dev, 512)
    cases.append(("13,776-face body 512^2 visualize camera", body_v[0], body_f, vis_pose, 512, vis_focal))
    # path f's shape: ShapeGen's 13,441-face body at 256^2
    sv, sf, s_pose, s_focal = synthetic.smpl_size_body_view(dev)
    cases.append(("13,441-face body 256^2", sv, sf, s_pose, 256, s_focal))

    for name, v, f, pose, res, focal in cases:
        H, W = (res, res) if isinstance(res, int) else res
        proj = raster.project_vertices(v, pose, H, W, focal)
        coef, valid, _ = raster._face_coefficients(proj, f)
        args = (coef, valid, proj.sx[f], proj.sy[f], H, W)
        want = rz.zbuffer_select_plain(coef, valid, H, W)
        n0 = read_counts()["zbuffer_tiled"]
        got = rz.zbuffer_select_tiled(*args)
        if read_counts()["zbuffer_tiled"] != n0 + 1:
            fail(f"B2 {name}: {read_counts()['zbuffer_tiled'] - n0} counted launches for one call")
        _, n = same_winners(f"z-buffer {name}", got, want, coef, W)
        if n:
            fail(f"B2 {name}: {n} pixels differ from the plain version (near-ties included)")
        if not torch.equal(rz.zbuffer_select_tiled(*args), got):
            fail(f"B2 {name}: two launches gave different winners")
        print(f"[B2] {name}: {int((want >= 0).sum())} covered px, kernel == plain at every pixel, "
              f"two launches the same bits")
    # time at the paths' renders (profile_zbuffer's scenes): the train_clip
    # GT raster, a scoring view, the animate paths' largest render (the body
    # at 512^2) and ShapeGen's body
    t, t_a, t_v, t_s = (time_zbuffer(name, *scene) for name, scene in
                        synthetic.zbuffer_scenes(runner, dev).items())
    return {"name": "zbuffer_tiled", "route": "cuda",
            "source": "avatarclip_torch/csrc/raster_zbuffer.cu",
            "replaces": "avatarclip_tpu/ops/raster_zbuffer.py:266",
            "max_abs_err": 0.0, "ms": t["ms"], "ms_kernel": t["ms_kernel"], "plain_ms": t["plain_ms"],
            "library_ms": None, **t["bound"], "tiles": t["tiles"], "ctas": t["ctas"],
            "ms_224_body": t_a["ms"], "ms_kernel_224_body": t_a["ms_kernel"],
            "ms_512_body": t_v["ms"], "ms_kernel_512_body": t_v["ms_kernel"],
            "plain_ms_512_body": t_v["plain_ms"], "bound_ms_512_body": t_v["bound"]["bound_ms"],
            "bound_by_512_body": t_v["bound"]["bound_by"], "tiles_512_body": t_v["tiles"],
            "ctas_512_body": t_v["ctas"],
            "ms_13441_body": t_s["ms"], "ms_kernel_13441_body": t_s["ms_kernel"]}


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


def time_zbuffer(name, v, faces, pose, res, focal, brute: bool = False) -> dict:
    """B2's (or with ``brute`` #15's) and the plain version's milliseconds on
    one render, and the bound of the work that render needs: every (pixel,
    valid face) pair inside the face's screen bbox gets 3 edge tests and an
    inverse depth (~17 FLOPs). #15 computes B2's function, so it has B2's
    operations; it evaluates every (pixel, face) pair, and its all-pairs
    floor (``floor_ms``: H W F pairs x 16 unfused f32 operations at
    F32_LANE_OPS) is printed beside the bound. The bytes are each kernel's
    own inputs and output, read once: coef (48 B a face), the bool flags (1
    B) and, for B2, the corners' screen coordinates (24 B), plus the int32
    ids. Each kernel is timed through its entry (``ms``: the allocation, the
    checks and the C call, as a caller calls it) and as the bare C call on
    buffers allocated once (``ms_kernel``: B2's prologue and raster
    launches; #15's key reset, kernel and id pass)."""
    import torch

    from avatarclip_torch.ops import raster_zbuffer as rz
    from avatarclip_torch.render import raster

    proj = raster.project_vertices(v, pose, res, res, focal)
    coef, valid, _ = raster._face_coefficients(proj, faces)
    sx, sy = proj.sx[faces], proj.sy[faces]
    F = faces.shape[0]
    out = {"tiles": None}
    if brute:
        out["ms"] = cuda_ms(lambda: rz.zbuffer_select(coef, valid, res, res), reps=20)
        keys = torch.empty(3 * res * res, dtype=torch.int32, device=coef.device)
        out["ms_kernel"] = cuda_ms(lambda: rz.brute_launch(coef, valid, keys, keys[2 * res * res:], res, res),
                                   reps=50)
        out["ctas"] = rz.brute_ctas(res, res, F)
        out["tiles"] = (-(-res // rz.BRUTE_TILE)) ** 2
        out["floor_ms"] = res * res * F * 16.0 / F32_LANE_OPS * 1e3
    else:
        out["ms"] = cuda_ms(lambda: rz.zbuffer_select_tiled(coef, valid, sx, sy, res, res), reps=20)
        bins = torch.empty(2 * F, dtype=torch.int32, device=coef.device)
        ids = torch.empty(res * res, dtype=torch.int32, device=coef.device)
        out["ms_kernel"] = cuda_ms(lambda: rz.launch(coef, valid, sx, sy, bins, ids, res, res), reps=50)
        out["tiles"], out["ctas"] = rz.grid(res, res)
    out["plain_ms"] = cuda_ms(lambda: rz.zbuffer_select_plain(coef, valid, res, res), reps=5)
    nx = (sx.amax(1).clamp(0, res - 1).floor() - sx.amin(1).clamp(0, res - 1).ceil() + 1).clamp_min(0)
    ny = (sy.amax(1).clamp(0, res - 1).floor() - sy.amin(1).clamp(0, res - 1).ceil() + 1).clamp_min(0)
    pairs = float((nx * ny * valid.float()).sum())
    out["bound"] = b = bound(17.0 * pairs, F * (48 + 1 + (0 if brute else 24)) + res * res * 4)
    tag = "#15" if brute else "B2"
    if brute:
        kern = (f", bare C call {out['ms_kernel']:.4f} ms ({out['ctas']} CTAs: "
                f"{out['tiles']} tiles of {rz.BRUTE_TILE}x{rz.BRUTE_TILE} pixels x "
                f"{out['ctas'] // out['tiles']} face slices)")
        floor = (f"; all-pairs floor {out['floor_ms']:.4f} ms (16 f32 operations a pair at "
                 f"{F32_LANE_OPS:.3e}/s; the aim, half its rate, {2 * out['floor_ms']:.4f} ms)")
    else:
        kern = (f", bare C call {out['ms_kernel']:.4f} ms ({out['ctas']} CTAs: "
                f"{out['tiles']} tiles of {rz.BIN}x{rz.BIN} pixels, "
                f"{out['ctas'] // out['tiles']} CTAs a tile)")
        floor = ""
    print(f"[{tag}] {name} ({F} faces, {pairs:.0f} bbox pixel-face pairs, {res * res * F} pairs in all): "
          f"entry {out['ms']:.4f} ms{kern}, plain {out['plain_ms']:.4f} ms, bound "
          f"{b['bound_ms']:.5f} ms ({b['bound_by']}, {b['flops']:.3e} FLOPs, {b['bytes']:.0f} bytes){floor}")
    return out


def runner_lookat(eye):
    import numpy as np

    from avatarclip_torch.render import cameras

    return cameras.lookat_np(eye, np.zeros(3, np.float32), np.array([0.0, 1.0, 0.0], np.float32))


# ---------------------------------------------------------------------------
# B1 and B3: the NeuS megakernel pairs
# ---------------------------------------------------------------------------


def neus_problem(width: int, n_rays: int, dev, seed: int = 0, dtype: str = "float32"):
    """Fields of the conf's shapes (4x256 / 2x256 at 256 wide, 3x128 / 1x128
    at 128 wide, extra colour head) with seeded, perturbed weights, and rays
    through the unit sphere with 64 sorted samples each. The nets are built
    without weight norm, so their parameters are the dense weights whose
    gradients the kernel computes (weight norm's chain rule is plain
    autograd outside the kernel and projects the dense gradient, which
    magnifies f32 summation-order noise). ``dtype``: the nets' cfg.dtype, the
    kernels' operand mode (float32 here, bfloat16 as the confs)."""
    import torch

    from avatarclip_torch.fields import networks as nets

    g = torch.Generator().manual_seed(seed)
    if width == 256:
        s_cfg = nets.SDFConfig(d_out=257, d_hidden=256, n_layers=4, skip_in=(4,), multires=6,
                               weight_norm=False, dtype=dtype)
        c_cfg = nets.ColorConfig(d_feature=256, d_hidden=256, n_layers=2, extra_color=True,
                                 weight_norm=False, dtype=dtype)
    else:
        s_cfg = nets.SDFConfig(d_out=129, d_hidden=128, n_layers=3, skip_in=(3,), multires=6,
                               weight_norm=False, dtype=dtype)
        c_cfg = nets.ColorConfig(d_feature=128, d_hidden=128, n_layers=1, extra_color=True,
                                 weight_norm=False, dtype=dtype)
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
    """Outputs and gradients (parameters, then inputs) of sum(probe * out),
    the last output (the eikonal partial sums) as the eikonal loss."""
    import torch

    from avatarclip_torch.ops import fused_neus as fn_mod

    ins = [t.clone().requires_grad_(True) for t in inputs]
    outs = list(fn(fields.sdf, fields.color, *ins, fields.variance.inv_s(), 0.4))
    outs[-1] = fn_mod.eik_ratio(outs[-1])
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


def hold_bf16_sets(tag, names, got, plain, ref) -> tuple[float, float]:
    """The bf16 operand mode's hold (ops/hold.bf16_within): for each tensor,
    the kernel's relative RMS error against the float64 reference of the f32
    function at most twice the plain bf16 version's own plus BF16_FLOOR.
    Returns (the worst kernel relative RMS, the worst ratio to the plain
    version's)."""
    from avatarclip_torch.ops import hold

    worst = worst_ratio = 0.0
    rows = []
    for nm, k, p, r in zip(names, got, plain, ref):
        ek, ep, ok = hold.bf16_within(k, p, r)
        if not ok:
            fail(f"{tag} bf16 {nm}: kernel rel RMS err {ek:.3e} > 2 x plain bf16 {ep:.3e} + "
                 f"{hold.BF16_FLOOR}")
        worst, worst_ratio = max(worst, ek), max(worst_ratio, ek / max(ep, 1e-30))
        rows.append(f"{nm} {ek:.2e}/{ep:.2e}")
    print(f"[{tag}] bf16 operands vs the f32 function in f64 (relative RMS, kernel/plain bf16): "
          + ", ".join(rows))
    return worst, worst_ratio


def hold_neus_bf16(tag, kernel_fn, plain_fn, out_names, n_out, probe_idx, dev) -> float:
    """B1 / B3 in the bf16 operand mode at 256 and 128 wide on 2,048 rays x
    64 samples (hold_bf16_sets); the worst kernel relative RMS error."""
    import torch

    from avatarclip_torch.ops import hold

    worst = 0.0
    for width in (256, 128):
        fields, inputs, probes, point_probes = neus_problem(width, 2048, dev, dtype="bfloat16")
        probes = probes if probe_idx == "ray" else point_probes
        outs_k, grads_k = neus_grads(kernel_fn, fields, inputs, probes, n_out)
        outs_p, grads_p = neus_grads(plain_fn, fields, inputs, probes, n_out)
        f64 = hold.f32_copy(fields).double()
        outs_r, grads_r = neus_grads(plain_fn, f64, [t.double() for t in inputs],
                                     [p.double() for p in probes], n_out)
        torch.cuda.synchronize()
        names = list(out_names) + ["d " + n for n, _ in fields.named_parameters()] + [
            "d rays_o", "d rays_d", "d mid_z", "d dists"]
        w, ratio = hold_bf16_sets(f"{tag} {width}-wide", names, list(outs_k) + list(grads_k),
                                  list(outs_p) + list(grads_p), list(outs_r) + list(grads_r))
        print(f"[{tag}] {width}-wide bf16: worst kernel rel RMS {w:.3e}, at most {ratio:.2f}x the "
              f"plain bf16 version's")
        worst = max(worst, w)
        del f64, outs_r, grads_r
        torch.cuda.empty_cache()
    return worst


def hold_net_bf16(tag, fused, plain, net, ins, cots, in_names, out_names) -> float:
    """B6 / B7 / #12 through their entries in the bf16 operand mode against
    the plain version in f64 at f32 operands, beside the plain bf16 version
    (hold_bf16_sets); the worst kernel relative RMS error."""
    import torch

    from avatarclip_torch.ops import hold

    ok, gk = hold.net_grads(fused, net, ins, cots)
    op, gp = hold.net_grads(plain, net, ins, cots, chunk=REF_CHUNK)
    ref = hold.f32_copy(net).double()
    orf, grf = hold.net_grads(plain, ref, [t.double() for t in ins], [c.double() for c in cots],
                              chunk=REF_CHUNK)
    names = list(out_names) + ["d " + n for n, _ in net.named_parameters()] + [
        "d " + n for n in in_names]
    worst, _ = hold_bf16_sets(tag, names, ok + gk, op + gp, orf + grf)
    del ref, orf, grf, ok, gk, op, gp
    torch.cuda.empty_cache()
    return worst


def bound_tc(flops: float, nbytes: float) -> dict:
    """bound() for a kernel whose GEMMs run on the bf16 tensor cores:
    max(FLOPs / bf16 peak, bytes / HBM rate), with the f32 CUDA-core bound
    beside it."""
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "bound_ms_f32": max(flops / PEAK_F32 * 1e3, t_bytes)}


B1_REPS = 5  # timed calls of each B1 kernel; the median is the time
B1_RAYS = 112 * 112  # the train_clip step's rays
B1_REF_RAYS = 1024  # rays a chunk of B1's plain and float64 references at B1_RAYS


def time_b1_kernels(fields, inputs, probes) -> dict:
    """B1's two kernels alone (the wrappers fused_neus.neus_ray_tc_fwd /
    _bwd in the nets' bf16 mode, neus_ray_fwd / _bwd in f32; weights packed
    once): the median, least and most ms of B1_REPS CUDA-event-timed calls
    each."""
    import torch

    from avatarclip_torch.ops import fused_neus as fn

    spec = fn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, inputs[2].shape[1])
    with torch.no_grad():
        weights = fn.dense_weights(fields.sdf, fields.color)
        flat = torch.cat([w.reshape(-1) for w in weights])
        inv_s = fields.variance.inv_s().reshape(()).float().contiguous()
        lead = (spec, flat) + (fn.pack_tc(spec, weights) if spec.bf16 else ())
    args = (*inputs, inv_s, 0.4)
    fwd_k, bwd_k = ((fn.neus_ray_tc_fwd, fn.neus_ray_tc_bwd) if spec.bf16
                    else (fn.neus_ray_fwd, fn.neus_ray_bwd))
    cots = (probes[0].contiguous(), probes[1].contiguous(), probes[2].contiguous(),
            torch.tensor([0.5, 0.0], device=flat.device))
    res = fwd_k(*lead, *args)
    out = {}
    for name, f in (("fwd", lambda: fwd_k(*lead, *args)),
                    ("bwd", lambda: bwd_k(*lead, *args, res[3], res[4], *cots))):
        f()
        times = []
        for _ in range(B1_REPS):
            times.append(cuda_ms_once(f))
        out[name] = (statistics.median(times), min(times), max(times))
    return out


def hold_b1_full(tag, fields, inputs, probes, cos_anneal=0.4) -> float:
    """B1 in the bf16 mode at the path's size (B1_RAYS x 64 at 4x256 /
    2x256): the kernel on all the rays at once, its plain bf16 version and
    the f32 function in float64 (ops/hold.f32_copy) B1_REF_RAYS rays at a
    time (ops/hold.ray_grads). Held by hold_bf16_sets (relative RMS) and,
    for each per-ray tensor (the three per-ray outputs and the four ray
    inputs' gradients), by its worst ray (ops/hold.per_ray_within). Returns
    the worst kernel relative RMS error."""
    import torch

    from avatarclip_torch.ops import fused_neus as fn
    from avatarclip_torch.ops import hold

    got = hold.ray_grads(fn.point_eval_ray, fields, inputs, probes, cos_anneal)
    plain = hold.ray_grads(fn.point_eval_ray_plain, fields, inputs, probes, cos_anneal,
                           chunk=B1_REF_RAYS)
    ref64 = hold.f32_copy(fields).double()
    ref = hold.ray_grads(fn.point_eval_ray_plain, ref64, [t.double() for t in inputs],
                         [p.double() for p in probes], cos_anneal, chunk=B1_REF_RAYS)
    torch.cuda.synchronize()
    names = ["colorW", "normals_w", "weight_sum", "gradient_error"] + [
        "d " + n for n, _ in fields.named_parameters()] + ["d rays_o", "d rays_d", "d mid_z", "d dists"]
    flat = lambda x: list(x[0]) + list(x[1])
    worst, ratio = hold_bf16_sets(tag, names, flat(got), flat(plain), flat(ref))
    n_par = len(list(fields.parameters()))
    rows, worst_ray = [], 0.0
    for i in (0, 1, 2, 4 + n_par, 5 + n_par, 6 + n_par, 7 + n_par):
        ek, ep, ok = hold.per_ray_within(flat(got)[i], flat(plain)[i], flat(ref)[i])
        if not ok:
            fail(f"{tag} bf16 {names[i]}: worst ray's relative error {ek:.3e} > {hold.PER_RAY_K} x "
                 f"the plain bf16 version's {ep:.3e} + {hold.BF16_FLOOR}")
        worst_ray = max(worst_ray, ek / max(ep, 1e-30))
        rows.append(f"{names[i]} {ek:.2e}/{ep:.2e}")
    print(f"[{tag}] worst ray's relative error, kernel/plain bf16 (at most {hold.PER_RAY_K}x + "
          f"{hold.BF16_FLOOR}): " + ", ".join(rows) + f"; relative RMS at most {ratio:.2f}x, "
          f"worst ray at most {worst_ray:.2f}x the plain version's")
    del got, plain, ref, ref64
    torch.cuda.empty_cache()
    return worst


def check_neus_ray(dev):
    """B1: the f32 mode (fused_neus_ray.cu) held in f64 to OUT_TOL / GRAD_TOL,
    the bf16 mode (the tensor-core pair, fused_neus_ray_tc.cu) held as
    hold_bf16_sets says, both at 256 and 128 wide on 2,048 rays, and the
    bf16 mode again at the training step's 12,544 rays x 64 (hold_b1_full).
    Both modes' kernels timed there (time_b1_kernels) and their entries
    beside their plain versions in the same mode. The bf16 forward must be
    faster than its f32 CUDA-core bound (no f32 kernel could be); the
    backward's comparison with its bound is printed. The kernels line
    carries the bf16 mode (the main path's: every conf is bf16) and its f32
    numbers beside."""
    import torch

    from avatarclip_torch.ops import fused_neus as fn

    worst_f, worst_b = hold_against_f64(
        "B1", fn.point_eval_ray, fn.point_eval_ray_plain,
        ("colorW", "normals_w", "weight_sum", "gradient_error"), (0, 1, 2, 3), "ray", dev)
    worst_bf16 = hold_neus_bf16("B1", fn.point_eval_ray, fn.point_eval_ray_plain,
                                ("colorW", "normals_w", "weight_sum", "gradient_error"),
                                (0, 1, 2, 3), "ray", dev)

    # at the main path's shapes: 12,544 rays x 64 samples, 4x256 / 2x256
    R = B1_RAYS
    times, kern = {}, {}
    for mode in ("bfloat16", "float32"):
        fields, inputs, probes, _ = neus_problem(256, R, dev, seed=1, dtype=mode)
        if mode == "bfloat16":
            worst_bf16 = max(worst_bf16, hold_b1_full(f"B1 {R} rays x 64, 256-wide", fields, inputs,
                                                      probes))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kern[mode] = time_b1_kernels(fields, inputs, probes)
        peak_k = torch.cuda.max_memory_allocated() / 2**30
        for name, f in (("kernel", fn.point_eval_ray), ("plain", fn.point_eval_ray_plain)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fwd_ms = cuda_ms(lambda: neus_grads_loss(f, fields, inputs, probes), reps=3)
            bwd_total = 0.0
            for _ in range(3):
                ins = [t.clone().requires_grad_(True) for t in inputs]
                loss = neus_grads_loss(f, fields, ins, probes)
                torch.cuda.synchronize()
                bwd_total += cuda_ms_once(
                    lambda: torch.autograd.grad(loss, list(fields.parameters()) + ins))
            peak = torch.cuda.max_memory_allocated() / 2**30
            times[mode, name] = (fwd_ms, bwd_total / 3, max(peak, peak_k) if name == "kernel" else peak)
            del ins, loss
        spec = fn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, 64)
        n_w = sum(t.numel() for t in fn.dense_weights(fields.sdf, fields.color))
        del fields, inputs, probes
        torch.cuda.empty_cache()
    P = R * 64
    fl_f, fl_b = neus_gemm_flops(spec)
    Wd = spec.rgb_width
    by_f = 4 * (n_w + 6 * R + 2 * P + (Wd + 4) * R + 4 * P + 2)
    by_b = 4 * (n_w + 6 * R + 2 * P + 4 * P + (Wd + 4) * R + 2 + 6 * R + 2 * P + n_w + 1)
    b_f, b_b = bound_tc(fl_f * P, by_f), bound_tc(fl_b * P, by_b)
    kf, kb = kern["bfloat16"]["fwd"][0], kern["bfloat16"]["bwd"][0]
    for mode in ("bfloat16", "float32"):
        (ef, eb, km), (pf, pb, pm) = times[mode, "kernel"], times[mode, "plain"]
        (f_med, f_lo, f_hi), (b_med, b_lo, b_hi) = kern[mode]["fwd"], kern[mode]["bwd"]
        print(f"[B1] {R} rays x 64 samples, 4x256/2x256, {mode} mode: forward kernel {f_med:.3f} ms "
              f"(median of {B1_REPS}, {f_lo:.3f}-{f_hi:.3f}; entry with the weight packing "
              f"{ef:.3f} ms; plain {pf:.3f} ms), backward kernel {b_med:.3f} ms ({b_lo:.3f}-{b_hi:.3f}; "
              f"through autograd {eb:.3f} ms; plain {pb:.3f} ms); peak memory kernel {km:.2f} GiB, "
              f"plain {pm:.2f} GiB")
    print(f"[B1] bounds: forward {b_f['bound_ms']:.3f} ms at the bf16 tensor-core peak "
          f"({b_f['bound_by']}), {b_f['bound_ms_f32']:.3f} ms at the f32 CUDA-core peak; backward "
          f"{b_b['bound_ms']:.3f} / {b_b['bound_ms_f32']:.3f} ms; {fl_f:.0f} / {fl_b:.0f} GEMM FLOPs "
          f"per point; the bf16 pair achieves {fl_f * P / kf * 1e-9:.1f} / {fl_b * P / kb * 1e-9:.1f} "
          f"TFLOP/s, {b_f['bound_ms'] / kf:.3f} / {b_b['bound_ms'] / kb:.3f} of its bound")
    # below the f32 CUDA-core bound, no f32 kernel could be this fast
    if not kf < b_f["bound_ms_f32"]:
        fail(f"B1 bf16 forward {kf:.3f} ms (median of {B1_REPS}) is not below the f32 CUDA-core "
             f"bound {b_f['bound_ms_f32']:.3f} ms")
    print(f"[B1] bf16 forward {kf:.3f} ms (median of {B1_REPS}) is below the f32 CUDA-core bound "
          f"{b_f['bound_ms_f32']:.3f} ms; bf16 backward {kb:.3f} ms is "
          f"{'below' if kb < b_b['bound_ms_f32'] else 'NOT below'} its f32 CUDA-core bound "
          f"{b_b['bound_ms_f32']:.3f} ms (a reading, not a check)")
    common = {"route": "cuda", "source": "avatarclip_torch/csrc/fused_neus_ray_tc.cu",
              "source_f32": "avatarclip_torch/csrc/fused_neus_ray.cu", "library_ms": None}
    return [
        {"name": "neus_ray_fwd", **common, "replaces": "avatarclip_tpu/ops/fused_neus.py:403",
         "max_abs_err": worst_f, "bf16_rel_rms_err": worst_bf16, "ms": kf,
         "plain_ms": times["bfloat16", "plain"][0], "ms_f32": kern["float32"]["fwd"][0],
         "plain_ms_f32": times["float32", "plain"][0], **b_f},
        {"name": "neus_ray_bwd", **common, "replaces": "avatarclip_tpu/ops/fused_neus.py:620",
         "max_abs_err": worst_b, "bf16_rel_rms_err": worst_bf16, "ms": kb,
         "plain_ms": times["bfloat16", "plain"][1], "ms_f32": kern["float32"]["bwd"][0],
         "plain_ms_f32": times["float32", "plain"][1], **b_b},
    ]


def neus_grads_loss(fn, fields, inputs, probes):
    from avatarclip_torch.ops import fused_neus

    col, nw, ws, eik = fn(fields.sdf, fields.color, *inputs, fields.variance.inv_s(), 0.4)
    return ((col * probes[0]).sum() + (nw * probes[1]).sum() + (ws * probes[2]).sum()
            + fused_neus.eik_ratio(eik) * probes[3])


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
            got = (*got[:6], fn.eik_ratio(got[6]))
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


B3_REF_RAYS = 4096  # rays a chunk of B3's plain and float64 references at the validation chunk


def hold_point_fwd_bf16_at_chunk(fields, inputs) -> float:
    """B3's forward in the bf16 operand mode (the tensor-core kernel) through
    its wrapper under no_grad, as validation runs it, at the validation chunk
    (16,384 rays x 64) and at a ragged 16,347: each output against the f32
    function in f64 beside the plain bf16 version (hold_bf16_sets), the
    references B3_REF_RAYS rays at a time. The worst kernel relative RMS."""
    import torch

    from avatarclip_torch.ops import fused_neus as fn
    from avatarclip_torch.ops import hold

    f64 = hold.f32_copy(fields).double()
    names = ("sdf", "grad", "rgb", "alpha", "cdf", "gradient_error")
    worst = 0.0

    def chunked(flds, ins):
        parts = [[] for _ in range(6)]
        for a in range(0, ins[0].shape[0], B3_REF_RAYS):
            out = fn.point_eval_plain(flds.sdf, flds.color, *[t[a:a + B3_REF_RAYS] for t in ins],
                                      flds.variance.inv_s(), 0.4)
            for acc, t in zip(parts, out[:6]):
                acc.append(t.detach())
        parts = [torch.cat(p) for p in parts]
        ro, rd, mid, _ = ins
        r2 = ((ro[:, None] + rd[:, None] * mid[..., None]) ** 2).sum(-1).reshape(-1)
        relax = (r2 < 1.44).to(r2.dtype)
        ge = (torch.sqrt((parts[1] ** 2).sum(-1) + 1e-12) - 1.0) ** 2
        return parts[:5] + [(relax * ge).sum() / (relax.sum() + 1e-5)], parts[5]

    for R in (VAL_CHUNK, VAL_CHUNK - 37):
        ins = [t[:R].contiguous() for t in inputs]
        with torch.no_grad():
            got = fn.point_eval(fields.sdf, fields.color, *ins, fields.variance.inv_s(), 0.4)
            got = (*got[:6], fn.eik_ratio(got[6]))
            plain, _ = chunked(fields, ins)
            ref, inside = chunked(f64, [t.double() for t in ins])
        torch.cuda.synchronize()
        w, ratio = hold_bf16_sets(f"B3 bf16 forward under no_grad, {R} rays x 64", names,
                                  [got[i] for i in (0, 1, 2, 3, 4, 6)], plain, ref)
        flips = int((got[5] != inside.float()).sum())
        print(f"[B3] bf16 forward at {R} rays x 64: worst kernel rel RMS {w:.3e}, at most "
              f"{ratio:.2f}x the plain bf16 version's; inside flags differing from f64: {flips}")
        if flips > R * 64 * 1e-5:
            fail(f"B3 bf16 forward at {R} rays: {flips} inside flags differ from f64")
        worst = max(worst, w)
        del got, plain, ref, inside
    del f64
    torch.cuda.empty_cache()
    return worst


def check_neus_point(dev):
    """B3: the f32 mode (fused_neus_point.cu's pair) held in f64 to OUT_TOL /
    GRAD_TOL, the bf16 mode (the tensor-core forward of fused_neus_ray_tc.cu,
    the CUDA-core backward rounding its operands) by hold_bf16_sets, at 256
    and 128 wide on 2,048 rays; the forward under no_grad in both modes at
    the validation chunk and a ragged one. Timed at the validation chunk in
    both modes: the bf16 forward beside its f32 CUDA-core bound (a reading,
    not a check), its bf16 tensor-core bound, its plain version and the f32
    CUDA-core kernel, the design that served both modes before. The
    kernels line carries the bf16 mode (every conf's) and f32 beside."""
    import torch

    from avatarclip_torch.ops import fused_neus as fn

    worst_f, worst_b = hold_against_f64(
        "B3", fn.point_eval, fn.point_eval_plain,
        ("sdf", "grad", "rgb", "alpha", "cdf", "gradient_error"), (0, 1, 2, 3, 4, 6), "point", dev)
    worst_bf16 = hold_neus_bf16("B3", fn.point_eval, fn.point_eval_plain,
                                ("sdf", "grad", "rgb", "alpha", "cdf", "gradient_error"),
                                (0, 1, 2, 3, 4, 6), "point", dev)

    R = VAL_CHUNK
    fields, inputs, _, _ = neus_problem(256, R, dev, seed=2)
    worst_f = max(worst_f, hold_point_fwd_at_chunk(fields, inputs))
    del fields
    # the same nets and rays at the confs' bf16
    fields, inputs, _, probes = neus_problem(256, R, dev, seed=2, dtype="bfloat16")
    worst_bf16 = max(worst_bf16, hold_point_fwd_bf16_at_chunk(fields, inputs))

    # time at the validation chunk: 16,384 rays x 64 samples, 4x256 / 2x256;
    # the kernels through their wrappers (the bf16 forward's weights packed
    # once), the plain version forward under no_grad (as validation runs)
    # and its backward through autograd, at bf16
    spec = fn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, 64)
    spec_f = dataclasses.replace(spec, bf16=False)  # the f32 mode, same inputs
    weights = [w.detach().contiguous() for w in fn.dense_weights(fields.sdf, fields.color)]
    flat = torch.cat([w.reshape(-1) for w in weights])
    packed = fn.pack_tc(spec, weights)
    inv_s = fields.variance.inv_s().detach().reshape(()).contiguous()
    ro, rd, mid, dists = [t.contiguous() for t in inputs]
    fwd = lambda: fn.neus_point_fwd(spec, flat, ro, rd, mid, dists, inv_s, 0.4, packed)
    fwd_f = lambda: fn.neus_point_fwd(spec_f, flat, ro, rd, mid, dists, inv_s, 0.4)
    sdf_o, _, _, grad, _, _, _ = fwd()
    P = R * 64
    cots = [probes[0].reshape(P), probes[3], probes[4], probes[1], probes[2],
            torch.stack([probes[5], torch.zeros((), device=dev)])]
    # the backward: bf16 the tensor-core kernel on the weights packed once
    # (as NeuSPointFunction packs them for both passes), f32 the CUDA-core
    # kernel, the design both modes ran before
    bwd = lambda sp, pkd=None: fn.neus_point_bwd(sp, flat, ro, rd, mid, dists, inv_s, 0.4, sdf_o,
                                                 grad, *cots, pkd)
    torch.cuda.reset_peak_memory_stats()
    ms_f, ms_f_f, ms_f2 = cuda_ms(fwd, reps=5), cuda_ms(fwd_f, reps=3), cuda_ms(fwd, reps=5)
    first, second = bwd(spec, packed), bwd(spec, packed)
    same_b = all(torch.equal(a, b) for a, b in zip(first, second))
    del first, second
    if not same_b:
        fail("B3 backward (tensor cores): two calls on the same inputs differ")
    ms_b = statistics.median([cuda_ms_once(lambda: bwd(spec, packed)) for _ in range(5)])
    ms_b_f = cuda_ms(lambda: bwd(spec_f), reps=2)
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
        used = [outs[i] for i in (0, 1, 2, 3, 4)] + [fn.eik_ratio(outs[6])]
        loss = sum((o * p).sum() for o, p in zip(used, probes))
        torch.cuda.synchronize()
        plain_b += cuda_ms_once(lambda: torch.autograd.grad(loss, list(fields.parameters()) + ins))
        del ins, outs, used, loss
    plain_b /= 2
    mem_p = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    n_w, Wd = flat.numel(), spec.rgb_width
    fl_f, fl_b = neus_gemm_flops(spec)
    b_f = bound_tc(fl_f * P, 4 * (n_w + 6 * R + 2 * P + (7 + Wd) * P + 2))
    b_b = bound_tc(fl_b * P, 4 * (n_w + 6 * R + 2 * P + 4 * P + (6 + Wd) * P + 2
                                  + 6 * R + 2 * P + n_w + 1))
    ms_f = statistics.median([ms_f, ms_f2])
    print(f"[B3] {R} rays x 64 samples, 4x256/2x256, bf16 mode: forward kernel (tensor cores) "
          f"{ms_f:.3f} ms, {fl_f * P / ms_f * 1e-9:.1f} TFLOP/s; f32 CUDA-core bound "
          f"{b_f['bound_ms_f32']:.3f} ms ({'below' if ms_f < b_f['bound_ms_f32'] else 'NOT below'} "
          f"it: a reading, not a check), bf16 tensor-core bound {b_f['bound_ms']:.3f} ms "
          f"({b_f['bound_by']}); plain {plain_f:.3f} ms; the f32 CUDA-core kernel (the design "
          f"both modes ran before) {ms_f_f:.3f} ms")
    print(f"[B3] backward kernel, bf16 mode (#5, tensor cores; launched on path j): "
          f"{ms_b:.3f} ms (median of 5), {fl_b * P / ms_b * 1e-9:.1f} TFLOP/s, two calls equal; "
          f"the f32 CUDA-core kernel (the design both modes ran before) {ms_b_f:.3f} ms; plain "
          f"{plain_b:.3f} ms ({'below' if ms_b < plain_b else 'NOT below'} it); bound "
          f"{b_b['bound_ms']:.3f} ms (bf16 tensor cores, {b_b['bound_by']}), f32 CUDA-core bound "
          f"{b_b['bound_ms_f32']:.3f} ms ({'below' if ms_b < b_b['bound_ms_f32'] else 'NOT below'} "
          f"it: a reading, not a check); peak memory kernels {mem_k:.2f} GiB, plain "
          f"{mem_p:.2f} GiB")
    common = {"route": "cuda", "library_ms": None, "bf16_rel_rms_err": worst_bf16}
    return [
        {"name": "neus_point_fwd", **common, "source": "avatarclip_torch/csrc/fused_neus_ray_tc.cu",
         "source_f32": "avatarclip_torch/csrc/fused_neus_point.cu",
         "replaces": "avatarclip_tpu/ops/fused_neus.py:258", "max_abs_err": worst_f, "ms": ms_f,
         "ms_f32": ms_f_f, "plain_ms": plain_f, **b_f},
        {"name": "neus_point_bwd", **common, "source": "avatarclip_torch/csrc/fused_neus_ray_tc.cu",
         "source_f32": "avatarclip_torch/csrc/fused_neus_point.cu",
         "replaces": "avatarclip_tpu/ops/fused_neus.py:534", "max_abs_err": worst_b, "ms": ms_b,
         "ms_f32": ms_b_f, "plain_ms": plain_b, **b_b},
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


def hold_composite_bwd(R, S, W, shift, dev) -> float:
    """#7 at R rays x S samples, rgb width W, through its wrapper on inputs
    and cotangents ``shift`` floats (0-3) past a 16-byte boundary, against
    the plain version's VJP in f64 (GRAD_TOL of each gradient's largest
    magnitude); two calls equal; and the same launch through its C entry
    onto outputs (shift + 1) % 4 floats past a boundary, equal to the
    wrapper's. The max abs error."""
    import torch

    from avatarclip_torch.ops import _build
    from avatarclip_torch.ops import fused_composite as fc

    ins, cots = composite_problem(R, S, W, dev, seed=R + S + W + 1)

    def at(k, t):  # the same values, k floats into a buffer of their own
        return torch.cat([t.new_zeros(k), t.reshape(-1)])[k:].view(t.shape) if k else t

    ins = [at((shift + i) % 4, t) for i, t in enumerate(ins)]
    cots = [at((shift + i) % 4, t) for i, t in enumerate(cots)]
    got = fc.composite_bwd(*ins, *cots)
    again = fc.composite_bwd(*ins, *cots)
    shifted = [at((shift + 1) % 4, torch.full_like(t, float("nan"))) for t in got]
    p = _build.ptr
    _build.check(fc._lib().composite_bwd(R, S, W, *[p(t) for t in ins + cots],
                                         *[p(t) for t in shifted], _build.stream_ptr(dev)),
                 "composite_bwd launch")
    xs = [t.double().requires_grad_(True) for t in ins]
    ref = torch.autograd.grad(sum((o * c.double()).sum() for o, c in
                                  zip(fc.composite_plain(*xs), cots)), xs)
    torch.cuda.synchronize()
    worst = 0.0
    for nm, a, b, c, d in zip(("alpha", "rgb", "grad"), got, ref, again, shifted):
        err, rel = rel_err(a, b)
        if not rel <= GRAD_TOL or not torch.isfinite(a).all():
            fail(f"B4 backward at {R} rays x {S}, W={W}, d/d {nm}: rel err {rel:.2e} > {GRAD_TOL}")
        if not torch.equal(a, c) or not torch.equal(a, d):
            fail(f"B4 backward at {R} rays x {S}, W={W}, d/d {nm}: two calls, or the output "
                 f"{(shift + 1) % 4} floats past 16 bytes, differ")
        worst = max(worst, err)
    print(f"[B4] backward at {R} rays x {S} samples, rgb width {W}, inputs {shift} floats past 16 "
          f"bytes, vs the plain version's VJP in f64: within tolerance, max abs err {worst:.3e}; two "
          f"calls and outputs {(shift + 1) % 4} floats past 16 bytes equal")
    return worst


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
    # path's chunk and at a ragged last chunk (not a multiple of a CTA's 4
    # rays), at S 64 and below, and on inputs that start 1-3 floats past a
    # 16-byte boundary (the staging's single-float ends)
    for R, S, W, shift in ((VAL_CHUNK, 64, 6, 0), (VAL_CHUNK - 37, 64, 6, 0),
                           (VAL_CHUNK - 37, 64, 3, 0), (VAL_CHUNK - 37, 37, 6, 1),
                           (VAL_CHUNK, 48, 3, 3), (VAL_CHUNK - 37, 64, 6, 2)):
        ins, _ = composite_problem(R, S, W, dev, seed=R + S + W)
        if shift:  # the same values, k floats into a buffer of their own
            ins = [torch.cat([t.new_zeros(k), t.reshape(-1)])[k:].view(t.shape)
                   for k, t in zip((shift, shift % 3 + 1, (shift + 1) % 3 + 1), ins)]
        with torch.no_grad():
            got = fc.composite(*ins)
            ref = fc.composite_plain(*[t.double() for t in ins])
        torch.cuda.synchronize()
        for nm, a, b in zip(("weights", "color", "extra", "normals_w"), got, ref):
            err, rel = rel_err(a, b)
            if not rel <= OUT_TOL:
                fail(f"B4 forward at {R} rays x {S}, W={W}, {nm}: rel err {rel:.2e} > {OUT_TOL}")
            worst_f = max(worst_f, err)
        if W == 3 and got[2].any():
            fail("B4 forward at rgb width 3: extra is not zero")
        print(f"[B4] forward under no_grad at {R} rays x {S} samples, rgb width {W}, inputs "
              f"{[t.data_ptr() % 16 // 4 for t in ins]} floats past 16 bytes, vs the plain version "
              f"in f64: within tolerance; max abs err fwd {worst_f:.3e}")
        worst_b = max(worst_b, hold_composite_bwd(R, S, W, shift, dev))
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
    # cold: the L2 flushed before each launch by writing (or reading) 128 MB
    from avatarclip_torch.tools.profile_b4_sdf_only import cuda_ms_cold

    ms_cold = cuda_ms_cold(lambda: lib.composite_fwd(R, S, W, *args, *outs_f, st), 50, "write")
    ms_cold_read = cuda_ms_cold(lambda: lib.composite_fwd(R, S, W, *args, *outs_f, st), 50, "read")
    # the backward (#7), staged, warm and with the L2 flushed both ways
    launch = lambda: lib.composite_bwd(R, S, W, *args, *[p(c) for c in cots], *outs_b, st)
    bw = (cuda_ms(launch, reps=50), cuda_ms_cold(launch, 50, "write"), cuda_ms_cold(launch, 50, "read"))
    ms_b = bw[0]
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
    print(f"[B4] {R} rays x {S} samples, rgb width {W}: forward kernel {ms_f:.4f} ms warm, "
          f"{ms_cold:.4f} ms cold (L2 flushed by writing 128 MB before each launch; "
          f"{b_f['bytes'] / ms_cold / 1e9:.3f} TB/s), {ms_cold_read:.4f} ms cold by reading (through "
          f"the wrapper {wrap_f:.4f} ms; plain {plain_f:.4f} ms, bound {b_f['bound_ms']:.4f} ms "
          f"{b_f['bound_by']})")
    print(f"[B4] backward kernel (#7, staged; launched on path j): warm {bw[0]:.4f} ms, "
          f"L2 flushed by writing {bw[1]:.4f} ms, by reading {bw[2]:.4f} ms "
          f"({b_b['bytes'] / bw[2] / 1e9:.3f} TB/s); plain {plain_b:.4f} ms; "
          f"bound {b_b['bound_ms']:.4f} ms {b_b['bound_by']} "
          f"({b_b['bytes'] / 1e6:.1f} MB; the aim, half the bound's rate, is "
          f"{2 * b_b['bound_ms']:.4f} ms)")
    common = {"route": "cuda", "source": "avatarclip_torch/csrc/fused_composite.cu",
              "library_ms": None}
    return [
        {"name": "composite_fwd", **common, "replaces": "avatarclip_tpu/ops/fused_composite.py:73",
         "max_abs_err": worst_f, "ms": ms_f, "ms_cold": ms_cold, "ms_cold_read": ms_cold_read,
         "plain_ms": plain_f, **b_f},
        {"name": "composite_bwd", **common, "replaces": "avatarclip_tpu/ops/fused_composite.py:82",
         "max_abs_err": worst_b, "ms": ms_b, "ms_cold": bw[1], "ms_cold_read": bw[2],
         "plain_ms": plain_b, **b_b},
    ]


# ---------------------------------------------------------------------------
# B5: the soft aggregation pair
# ---------------------------------------------------------------------------

# Operations per (pixel, face) pair (f32 arithmetic, an FMA counted as 2).
# Every evaluated pair: 3 edge distances (2 mul + 2 add each), 2 min, the
# scale and the x > -104 test (16). A live pair (x > -104: beyond, exp(x)
# underflows in f32 and every term is exactly 0) adds, in the forward,
# exp's argument |x| log2 e, 1 + e, e / (1 + e), the sigmoid select,
# softplus's max(x, 0) and its sum, the product of the (1 + e), w, num's 3
# FMA (6) and den (15), with exp and the reciprocal on the special-function
# unit (softplus's log is one lg2 for a run of up to 32 faces); in the
# backward exp's argument, 1 + e, e / (1 + e), the two selects, dw (6), dd
# (6), the tie test (3), one edge's 3 sums (5), dezf (2), w (1) and dcolf
# (6), 34, with exp and the reciprocal. The bound counts what the inputs
# need, the live pairs' work; the kept (tile, block) pairs' count of the
# earlier design is printed beside it as ops_kept.
SOFT_OPS_PAIR = 16
SOFT_FWD_OPS_LIVE, SOFT_BWD_OPS_LIVE = 15, 34
SOFT_SFU_LIVE = 2
SFU_PER_SM_CLOCK = 16  # H100: special-function results per SM per clock
N_SM = 132
X_DEAD = -104.0  # the kernels' live-pair threshold (fused_soft._MARGIN_LOGITS)


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


def soft_pair_counts(faces, tab, H, W, sigma) -> dict:
    """Pairs of image pixels and valid faces of this input: those in the
    table's kept (tile, block) pairs (the earlier design's work), those in
    the (8 x 8 patch, face) pairs the kernels evaluate
    (fused_soft.patch_keep), and the live ones (x > -104). Fails unless
    every live pair is evaluated."""
    import torch

    from avatarclip_torch.ops import fused_soft as fs

    B, Fp, _ = faces.shape
    n_ty, n_tx = fs.grid_dims(H, W)
    ty = torch.arange(n_ty * n_tx, device=faces.device) // n_tx
    tx = torch.arange(n_ty * n_tx, device=faces.device) % n_tx
    px_tile = ((H - ty * fs.TILE_H).clamp(max=fs.TILE_H) * (W - tx * fs.TILE_W).clamp(max=fs.TILE_W)).double()
    valid_blk = (faces[..., 13] != 0).reshape(B, -1, fs.FBLOCK).sum(-1).double()  # (B, n_fb)
    kept = float((tab.double() * px_tile[None, :, None] * valid_blk[:, None, :]).sum())
    keep = fs.patch_keep(faces, tab, H, W, 1.0 / sigma)  # (B, n_py, n_px, Fp)
    n_py, n_px = keep.shape[1:3]
    r = torch.arange(n_py, device=faces.device) * fs.PATCH
    c = torch.arange(n_px, device=faces.device) * fs.PATCH
    px_patch = ((H - r).clamp(max=fs.PATCH)[:, None] * (W - c).clamp(max=fs.PATCH)[None, :]).double()
    evaluated = float((keep.double().sum(-1) * px_patch).sum())
    live = 0.0
    px, py = fs._pixel_coords(H, W, faces.device, torch.float32)
    pix_patch = ((py.long() // fs.PATCH) * n_px + px.long() // fs.PATCH).reshape(-1)  # (P,)
    keep = keep.reshape(B, n_py * n_px, Fp)
    for f0 in range(0, Fp, 256):
        fc = faces[:, f0:f0 + 256]
        v = [(px * fc[:, None, :, 3 * e] + py * fc[:, None, :, 3 * e + 1]) + fc[:, None, :, 3 * e + 2]
             for e in range(3)]
        x = torch.minimum(torch.minimum(v[0], v[1]), v[2]) * (1.0 / sigma)
        lv = (x > X_DEAD) & (fc[:, None, :, 13] != 0)
        live += float(lv.sum())
        if bool((lv & ~keep[:, pix_patch, f0:f0 + 256]).any()):
            fail("B5: a live pair lies outside the (patch, face) pairs the kernels evaluate")
    return {"kept": kept, "evaluated": evaluated, "live": live}


def time_soft(fp, tab, H, W, sigma) -> dict:
    """Each kernel and its partial sum on preallocated buffers (CUDA
    events, the splits the wrappers pick), the plain version's forward and
    its VJP, and the pair counts and bounds of this input."""
    import torch

    from avatarclip_torch.ops import _build
    from avatarclip_torch.ops import fused_soft as fs

    dev = fp.device
    inv = 1.0 / sigma
    B, Fp, _ = fp.shape
    P, n_fb = H * W, Fp // fs.FBLOCK
    g = torch.Generator().manual_seed(7)
    cots = [(torch.rand(B, P, generator=g) * 1e-3).to(dev), (torch.rand(B, P, 3, generator=g) * 1e-30).to(dev),
            (torch.rand(B, P, generator=g) * -1e-30).to(dev)]
    lib, p, st = fs._lib(), _build.ptr, _build.stream_ptr(dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    kf, kb = fs.fwd_splits(B, H, W, Fp, n_sm), fs.bwd_splits(B, H, W, Fp, n_sm)
    thresh = fs.cull_threshold(inv)
    part_f, part_b = torch.empty(kf, B, 5, P, device=dev), torch.empty(kb, B, Fp, 13, device=dev)
    outs = [torch.empty(B, P, device=dev), torch.empty(B, P, 3, device=dev), torch.empty(B, P, device=dev)]
    dfp = torch.empty_like(fp)
    fwd = lambda: lib.soft_fwd(p(fp), p(tab), p(part_f), B, H, W, n_fb, kf, inv, thresh, st)
    fwd_red = lambda: lib.soft_fwd_reduce(p(part_f), *[p(o) for o in outs], B, P, kf, st)
    bwd = lambda: lib.soft_bwd(p(fp), p(tab), *[p(c) for c in cots], p(part_b), B, H, W, n_fb, kb, inv, thresh, st)
    bwd_red = lambda: lib.soft_bwd_reduce(p(part_b), p(dfp), B * Fp, kb, st)
    t = {"splits_fwd": kf, "splits_bwd": kb}
    t["ms_f"] = cuda_ms(lambda: (fwd(), fwd_red()), reps=10)
    t["ms_b"] = cuda_ms(lambda: (bwd(), bwd_red()), reps=10)
    t["ms_f_reduce"] = cuda_ms(fwd_red, reps=10)
    t["ms_b_reduce"] = cuda_ms(bwd_red, reps=10)
    with torch.no_grad():
        t["plain_f"] = cuda_ms(lambda: fs.aggregate_plain(fp, H, W, inv), reps=2)
    x = fp.clone().requires_grad_(True)
    o = fs.aggregate_plain(x, H, W, inv)
    torch.cuda.synchronize()
    t["plain_b"] = cuda_ms(lambda: torch.autograd.grad(o, [x], cots, retain_graph=True), reps=2)
    del x, o
    torch.cuda.empty_cache()
    n = soft_pair_counts(fp, tab, H, W, sigma)
    clock = sm_clock_hz()
    face_b, pix_b, tab_b = B * Fp * 64, B * P * 20, tab.numel() * 4
    t["b_f"] = soft_bound(n["live"] * (SOFT_OPS_PAIR + SOFT_FWD_OPS_LIVE), n["live"] * SOFT_SFU_LIVE,
                          face_b + tab_b + pix_b, clock)
    t["b_b"] = soft_bound(n["live"] * (SOFT_OPS_PAIR + SOFT_BWD_OPS_LIVE), n["live"] * SOFT_SFU_LIVE,
                          face_b + tab_b + pix_b + face_b, clock)
    t["ops_kept_f"] = n["kept"] * SOFT_OPS_PAIR + n["live"] * SOFT_FWD_OPS_LIVE
    t["ops_kept_b"] = n["kept"] * SOFT_OPS_PAIR + n["live"] * SOFT_BWD_OPS_LIVE
    t.update(n, clock=clock)
    return t


def soft_deterministic(tag, fp, tab, H, W, sigma) -> None:
    """Two launches of each kernel on the same inputs give the same bits."""
    import torch

    from avatarclip_torch.ops import fused_soft as fs

    inv = 1.0 / sigma
    B, P = fp.shape[0], H * W
    g = torch.Generator().manual_seed(11)
    cots = [torch.rand(B, P, generator=g).to(fp.device), (torch.rand(B, P, 3, generator=g) * 1e-26).to(fp.device),
            (-torch.rand(B, P, generator=g) * 1e-26).to(fp.device)]
    a, b = fs.soft_fwd(fp, tab, H, W, inv), fs.soft_fwd(fp, tab, H, W, inv)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"B5 {tag}: two forward launches differ")
    if not torch.equal(fs.soft_bwd(fp, tab, *cots, H, W, inv), fs.soft_bwd(fp, tab, *cots, H, W, inv)):
        fail(f"B5 {tag}: two backward launches differ")


def check_soft(dev):
    import torch

    from avatarclip_torch.pipelines import synthetic

    worst_f = worst_b = 0.0
    H = W = 224
    sigma = 0.5
    # 1. one PoseOptimizer step's shapes: 5 views x 224^2 x 13,776 faces;
    # 2. one MotionOptimizer step's: 2 views (the n_part strided frames)
    scenes = {}
    for n_views, tag in ((5, "pose step"), (2, "motion step")):
        verts, faces, poses, focal = synthetic.humanoid_views(dev, n_views=n_views)
        fp, tab = soft_problem(verts, faces, poses, H, W, focal, sigma)
        f_, b_ = hold_soft(f"{tag} {n_views} x 224^2 x 13,776 faces, sigma 0.5", fp, tab, H, W, sigma, dev)
        worst_f, worst_b = max(worst_f, f_), max(worst_b, b_)
        soft_deterministic(tag, fp, tab, H, W, sigma)
        scenes[tag] = (fp, tab)
    # 3. ragged: partial tiles and a partial face block
    v2, f2, p2 = soup_views(dev, 1000, 5, [(0.0, 0.0, 2.0), (0.3, 0.2, 1.9)])
    fp2, tab2 = soft_problem(v2, f2, p2, 200, 136, 150.0, 0.5)
    f_, b_ = hold_soft("ragged 200x136 x 1,000 faces (1,024 padded)", fp2, tab2, 200, 136, 0.5, dev)
    worst_f, worst_b = max(worst_f, f_), max(worst_b, b_)
    # 4. compact scene at small sigma: the table skips most pairs
    v3, f3, p3 = soup_views(dev, 1500, 11, [(0.0, 0.0, 2.0)], compact=True)
    fp3, tab3 = soft_problem(v3, f3, p3, 320, 320, 320 * 0.5 / math.tan(math.radians(30.0)), 0.1)
    if not float(tab3.float().mean()) < 0.9:
        fail(f"B5: the compact scene keeps {float(tab3.float().mean()):.3f} of its pairs")
    f_, b_ = hold_soft("compact 320^2 x 1,500 faces, sigma 0.1", fp3, tab3, 320, 320, 0.1, dev)
    worst_f, worst_b = max(worst_f, f_), max(worst_b, b_)
    soft_deterministic("compact", fp3, tab3, 320, 320, 0.1)

    # time at size 1: the kernels alone, on preallocated buffers
    t = {tag: time_soft(fp, tab, H, W, sigma) for tag, (fp, tab) in scenes.items()}
    smi = card()
    for tag, n_views in (("pose step", 5), ("motion step", 2)):
        r = t[tag]
        print(f"[B5] {tag} {n_views} x 224^2 x 13,824 padded faces: {r['kept']:.0f} pixel-face pairs in the "
              f"table's kept (tile, block) pairs, {r['evaluated']:.0f} evaluated ((8 x 8 patch, face) pairs "
              f"kept, {r['evaluated'] / max(r['kept'], 1):.4f} of those), {r['live']:.0f} live (x > -104, "
              f"{r['live'] / max(r['evaluated'], 1):.4f} of the evaluated); splits {r['splits_fwd']} forward, "
              f"{r['splits_bwd']} backward; SM clock {r['clock'] / 1e6:.0f} MHz; {smi}")
        print(f"[B5] {tag}: forward {r['ms_f']:.4f} ms (its partial sum {r['ms_f_reduce']:.4f}; plain "
              f"{r['plain_f']:.4f} ms; bound {r['b_f']['bound_ms']:.4f} ms by {r['b_f']['bound_resource']}, "
              f"{r['b_f']['ops']:.4e} ops and {r['b_f']['sfu_ops']:.4e} special functions on the live pairs; "
              f"ops_kept {r['ops_kept_f']:.4e}); backward {r['ms_b']:.4f} ms (its partial sum "
              f"{r['ms_b_reduce']:.4f}; plain {r['plain_b']:.4f} ms; bound {r['b_b']['bound_ms']:.4f} ms by "
              f"{r['b_b']['bound_resource']}, {r['b_b']['ops']:.4e} ops; ops_kept {r['ops_kept_b']:.4e}); "
              f"one launch each way per step, and one of each partial sum")
    pose, motion = t["pose step"], t["motion step"]
    print(f"[B5] motion step / pose step (2 / 5 views): forward {motion['ms_f'] / pose['ms_f']:.3f}, backward "
          f"{motion['ms_b'] / pose['ms_b']:.3f}; live pairs {motion['live'] / pose['live']:.3f}")
    common = {"route": "cuda", "source": "avatarclip_torch/csrc/fused_soft.cu", "library_ms": None}
    out = []
    for name, line, ms, plain, b, kept_ops, red in (
            ("soft_fwd", 106, "ms_f", "plain_f", "b_f", "ops_kept_f", "ms_f_reduce"),
            ("soft_bwd", 132, "ms_b", "plain_b", "b_b", "ops_kept_b", "ms_b_reduce")):
        out.append({"name": name, **common, "replaces": f"avatarclip_tpu/ops/fused_soft.py:{line}",
                    "max_abs_err": worst_f if name == "soft_fwd" else worst_b, "ms": pose[ms],
                    "plain_ms": pose[plain], **pose[b], "ops_kept": pose[kept_ops],
                    "pairs_live": pose["live"], "pairs_evaluated": pose["evaluated"],
                    "partial_sum_ms": pose[red], "ms_2_views": motion[ms],
                    "bound_ms_2_views": motion[b]["bound_ms"]})
    return out


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
    """B6: the f32 mode (fused_sdf.cu's pair) held in f64 to OUT_TOL /
    GRAD_TOL on 131,072 points and a ragged 131,071, the bf16 mode (the
    tensor-core pair of fused_neus_ray_tc.cu) by hold_bf16_sets at 256 and
    128 wide on the ragged count. Timed at path (e)'s 802,816 points in both
    modes: each bf16 kernel beside its plain version and its f32 CUDA-core
    bound (readings, not checks), its bf16 tensor-core bound, its achieved
    TFLOP/s and the f32 CUDA-core kernel."""
    import torch

    from avatarclip_torch.ops import fused_neus as fn
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
    worst_bf16 = 0.0
    for width in (256, 128):
        fields, inputs, _, _ = neus_problem(width, 2048, dev, seed=4, dtype="bfloat16")
        pts, _ = ray_points(inputs)
        P = pts.shape[0] - 1  # ragged
        F = fields.sdf.cfg.d_out - 1
        cots = [(0.5 + torch.rand(P, k, generator=g)).to(dev) for k in (1, F, 3)]
        worst_bf16 = max(worst_bf16, hold_net_bf16(
            f"B6 {width}-wide, {P} points", fs.sdf_with_gradient_fused, fs.sdf_with_gradient_plain,
            fields.sdf, [pts[:P].contiguous()], cots, ("points",), ("sdf", "feature", "gradient")))

    # time at path (e)'s points: 12,544 rays x 64 samples, at the confs' bf16
    # (the backward's weights packed once) and in the f32 mode
    fields, inputs, _, _ = neus_problem(256, PATH_E_RAYS, dev, seed=6, dtype="bfloat16")
    sdf = fields.sdf
    pts, _ = ray_points(inputs)
    P = pts.shape[0]
    spec = fs.spec_from_config(sdf.cfg)
    spec_f = dataclasses.replace(spec, bf16=False)
    weights = [w.detach().contiguous() for w in fs.dense_weights(sdf)]
    flat = torch.cat([w.reshape(-1) for w in weights])
    packed = fn.pack_tc(spec, weights)
    cots = [(0.5 + torch.rand(P, k, generator=g)).to(dev) for k in (1, 256, 3)]
    ms_f = cuda_ms(lambda: fs.sdf_fwd(spec, flat, pts, packed), reps=5)
    ms_f_f = cuda_ms(lambda: fs.sdf_fwd(spec_f, flat, pts), reps=3)
    ms_f = statistics.median([ms_f, cuda_ms(lambda: fs.sdf_fwd(spec, flat, pts, packed), reps=5)])
    torch.cuda.reset_peak_memory_stats()
    ms_b = cuda_ms(lambda: fs.sdf_bwd(spec, flat, pts, *cots, packed=packed), reps=5)
    mem_k = torch.cuda.max_memory_allocated() / 2**30
    ms_b_f = cuda_ms(lambda: fs.sdf_bwd(spec_f, flat, pts, *cots), reps=3)
    ms_b = statistics.median([ms_b, cuda_ms(lambda: fs.sdf_bwd(spec, flat, pts, *cots, packed=packed),
                                            reps=5)])
    torch.cuda.reset_peak_memory_stats()
    plain_f, plain_b = time_plain(lambda x: fs.sdf_with_gradient_plain(sdf, x), [pts],
                                  list(sdf.parameters()), cots)
    mem_p = torch.cuda.max_memory_allocated() / 2**30
    fl_f, fl_b = fs.flops_per_point(spec)
    n_w, F = flat.numel(), spec.feat_dim
    b_f = bound_tc(fl_f * P, 4 * (n_w + 3 * P + (1 + F + 3) * P))
    b_b = bound_tc(fl_b * P, 4 * (n_w + 3 * P + (1 + F + 3) * P + 3 * P + n_w))
    print(f"[B6] {P} points (path e's step), 4x256, bf16 mode: backward kernel (tensor cores) "
          f"{ms_b:.3f} ms, {fl_b * P / ms_b * 1e-9:.1f} TFLOP/s; plain {plain_b:.3f} ms "
          f"({'under' if ms_b < plain_b else 'NOT under'} it); f32 CUDA-core bound "
          f"{b_b['bound_ms_f32']:.3f} ms ({ms_b / b_b['bound_ms_f32']:.2f}x it: a reading, not a "
          f"check), bf16 tensor-core bound {b_b['bound_ms']:.3f} ms ({b_b['bound_by']}); the f32 "
          f"CUDA-core kernel (the design both modes ran before) {ms_b_f:.3f} ms; peak memory "
          f"{mem_k:.2f} GiB (plain {mem_p:.2f} GiB)")
    print(f"[B6] {P} points, 4x256, bf16 mode: forward kernel (tensor cores) {ms_f:.3f} ms, "
          f"{fl_f * P / ms_f * 1e-9:.1f} TFLOP/s; plain {plain_f:.3f} ms ({'under' if ms_f < plain_f else 'NOT under'} "
          f"it); f32 CUDA-core bound {b_f['bound_ms_f32']:.3f} ms ({ms_f / b_f['bound_ms_f32']:.2f}x it: "
          f"a reading, not a check), bf16 tensor-core bound {b_f['bound_ms']:.3f} ms ({b_f['bound_by']}); "
          f"the f32 CUDA-core kernel {ms_f_f:.3f} ms; {fl_f:.0f} / {fl_b:.0f} GEMM FLOPs per point")
    common = {"route": "cuda", "library_ms": None, "bf16_rel_rms_err": worst_bf16}
    return [
        {"name": "sdf_fwd", **common, "source": "avatarclip_torch/csrc/fused_neus_ray_tc.cu",
         "source_f32": "avatarclip_torch/csrc/fused_sdf.cu",
         "replaces": "avatarclip_tpu/ops/fused_sdf.py:261", "max_abs_err": worst_f, "ms": ms_f,
         "ms_f32": ms_f_f, "plain_ms": plain_f, **b_f},
        {"name": "sdf_bwd", **common, "source": "avatarclip_torch/csrc/fused_neus_ray_tc.cu",
         "source_f32": "avatarclip_torch/csrc/fused_sdf.cu",
         "replaces": "avatarclip_tpu/ops/fused_sdf.py:403", "max_abs_err": worst_b, "ms": ms_b,
         "ms_f32": ms_b_f, "plain_ms": plain_b, **b_b},
    ]


def colour_net(mode: str, extra: bool, dev, seed: int, dtype: str = "float32", width: int = 256):
    """A 2x256 (or 1x128) colour net (no weight norm, so its parameters are
    the dense weights the kernel differentiates) with seeded, perturbed
    weights, in the operand mode ``dtype``."""
    import torch

    from avatarclip_torch.fields import networks as nets

    g = torch.Generator().manual_seed(seed)
    net = nets.ColorNetwork(nets.ColorConfig(mode=mode, d_in=9 if mode == "idr" else 6,
                                             d_feature=width, d_hidden=width,
                                             n_layers=2 if width == 256 else 1, extra_color=extra,
                                             weight_norm=False, dtype=dtype), g)
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
    worst_bf16 = 0.0
    for width in (256, 128):
        fields, inputs, _, _ = neus_problem(width, 2048, dev, seed=7, dtype="bfloat16")
        ins = colour_inputs(fields, inputs)
        for mode, extra in (("no_view_dir", True), ("idr", False)):
            net = colour_net(mode, extra, dev, seed=9, dtype="bfloat16", width=width)
            P = ins[0].shape[0] - 1  # ragged
            cots = [(0.5 + torch.rand(P, 6 if extra else 3, generator=g)).to(dev)]
            worst_bf16 = max(worst_bf16, hold_net_bf16(
                f"B7 {width}-wide {mode}{' + extra head' if extra else ''}, {P} points",
                fc.color_apply_fused, fc.color_apply_plain, net, [t[:P].contiguous() for t in ins],
                cots, ("points", "normals", "view_dirs", "features"), ("rgb",)))

    # time at path (e)'s points, in the path's mode (no_view_dir, extra head):
    # both kernels in the bf16 mode (tensor cores, their weights packed once
    # as ColorFunction packs them) beside the f32 CUDA-core kernels
    fields, inputs, _, _ = neus_problem(256, PATH_E_RAYS, dev, seed=10)
    ins = colour_inputs(fields, inputs)
    del fields
    net = colour_net("no_view_dir", True, dev, seed=11)
    net_b = colour_net("no_view_dir", True, dev, seed=11, dtype="bfloat16")
    spec = fc.spec_from_config(net.cfg)
    spec_b = fc.spec_from_config(net_b.cfg)
    flat = torch.cat([w.detach().reshape(-1) for w in fc.dense_weights(net, spec)])
    packed = fc.tc_pack(spec_b, flat)
    P = ins[0].shape[0]
    cot = (0.5 + torch.rand(P, 6, generator=g)).to(dev)
    ms_f = cuda_ms(lambda: fc.color_fwd(spec, flat, *ins), reps=3)
    ms_b_f = cuda_ms(lambda: fc.color_bwd(spec, flat, *ins, cot), reps=3)
    ms_f_b = statistics.median(cuda_ms(lambda: fc.color_fwd(spec_b, flat, *ins, packed), reps=5)
                               for _ in range(3))
    torch.cuda.reset_peak_memory_stats()
    ms_b = cuda_ms(lambda: fc.color_bwd(spec_b, flat, *ins, cot, packed), reps=5)
    mem_k = torch.cuda.max_memory_allocated() / 2**30
    ms_b = statistics.median([ms_b, cuda_ms(lambda: fc.color_bwd(spec_b, flat, *ins, cot, packed), reps=5)])
    plain_f, _ = time_plain(lambda *xs: fc.color_apply_plain(net, *xs), ins,
                            list(net.parameters()), [cot])
    plain_f_b, plain_b = time_plain(lambda *xs: fc.color_apply_plain(net_b, *xs), ins,
                                    list(net_b.parameters()), [cot])
    fl_f, fl_b = fc.flops_per_point(spec)
    n_w, W = flat.numel(), spec.rgb_width
    n_in = 3 * spec.n_vectors + spec.d_feature  # the input floats a point the mode reads
    b_f = bound_tc(fl_f * P, 4 * (n_w + n_in * P + W * P))
    b_b = bound_tc(fl_b * P, 4 * (n_w + n_in * P + W * P + n_in * P + n_w))
    print(f"[B7] {P} points (path e's step), 2x256 no_view_dir + extra head, {fl_f:.0f} / {fl_b:.0f} "
          f"GEMM FLOPs per point forward / backward")
    print(f"[B7] bf16 mode: forward kernel (tensor cores) {ms_f_b:.3f} ms, {fl_f * P / ms_f_b * 1e-9:.1f} "
          f"TFLOP/s; {ms_f_b / b_f['bound_ms']:.2f}x its bf16 bound {b_f['bound_ms']:.3f} ms "
          f"({b_f['bound_by']}; ops {b_f['flops'] / PEAK_BF16 * 1e3:.3f} ms, bytes "
          f"{b_f['bytes'] / HBM * 1e3:.3f} ms), {ms_f_b / b_f['bound_ms_f32']:.2f}x the f32 CUDA-core "
          f"bound {b_f['bound_ms_f32']:.3f} ms; plain bf16 {plain_f_b:.3f} ms; the f32 CUDA-core "
          f"kernel {ms_f:.3f} ms (plain f32 {plain_f:.3f} ms)")
    print(f"[B7] bf16 mode: backward kernel (tensor cores) {ms_b:.3f} ms, "
          f"{fl_b * P / ms_b * 1e-9:.1f} TFLOP/s; plain bf16 {plain_b:.3f} ms "
          f"({'under' if ms_b < plain_b else 'NOT under'} it); f32 CUDA-core bound "
          f"{b_b['bound_ms_f32']:.3f} ms ({ms_b / b_b['bound_ms_f32']:.2f}x it: a reading, not a "
          f"check), bf16 tensor-core bound {b_b['bound_ms']:.3f} ms ({b_b['bound_by']}); the f32 "
          f"CUDA-core kernel {ms_b_f:.3f} ms; peak memory {mem_k:.2f} GiB")
    common = {"route": "cuda", "library_ms": None, "bf16_rel_rms_err": worst_bf16,
              "source": "avatarclip_torch/csrc/fused_neus_ray_tc.cu",
              "source_f32": "avatarclip_torch/csrc/fused_color.cu"}
    return [
        {"name": "color_fwd", **common, "replaces": "avatarclip_tpu/ops/fused_color.py:230",
         "max_abs_err": worst_f, "ms": ms_f_b, "ms_f32": ms_f, "plain_ms": plain_f_b,
         "plain_ms_f32": plain_f, "tflops": fl_f * P / ms_f_b * 1e-9, **b_f},
        {"name": "color_bwd", **common, "replaces": "avatarclip_tpu/ops/fused_color.py:244",
         "max_abs_err": worst_b, "ms": ms_b, "ms_f32": ms_b_f, "plain_ms": plain_b, **b_b},
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
    version backward) against the plain version in f64: in f32 (fused_sdf.cu)
    at 4x256 and 3x128 on 2,048 rays x 56 sweep points and at 4x256 on a
    ragged 131,071 points, the sdf to OUT_TOL and its VJP into every
    parameter and the points to GRAD_TOL, the forward at one train_clip
    step's 12,544 rays x 56 points and on a 262,144-point grid chunk; in
    bf16 (the tensor-core kernel) at 4x256 and 3x128 on a ragged 114,687
    sweep points and at 4x256 on the grid chunk (hold_net_bf16). Timed on
    the step's points and the grid chunk: the bf16 kernel on a pack made
    beforehand and through its entry (the pack included), the f32 kernel,
    the plain version in both modes, both bounds, and the pack alone."""
    import torch

    from avatarclip_torch.ops import fused_neus as fn
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
    worst_bf16 = 0.0
    for width in (256, 128):
        fields, inputs, _, _ = neus_problem(width, 2048, dev, seed=12, dtype="bfloat16")
        pts = sweep_points(inputs)[:-1].contiguous()  # ragged
        cots = [(0.5 + torch.rand(pts.shape[0], 1, generator=g)).to(dev)]
        worst_bf16 = max(worst_bf16, hold_net_bf16(
            f"#12 {'4x256' if width == 256 else '3x128'}, {pts.shape[0]} points", fs.sdf_value_fused,
            fs.sdf_only_plain, fields.sdf, [pts], cots, ("points",), ("sdf",)))

    fields, inputs, _, _ = neus_problem(256, PATH_E_RAYS, dev, seed=14)
    sdf = fields.sdf
    pts = sweep_points(inputs)
    P = pts.shape[0]
    worst_f = max(worst_f, hold_forward(f"#12 4x256, {P} points (a train_clip step's sweeps)",
                                        fs.sdf_value_fused, fs.sdf_only_plain, sdf, [pts], ("sdf",)))
    # the same net at the confs' bf16 (the tensor-core kernel) and at f32
    # (fused_sdf.cu's), on the step's sweep points and on one grid chunk
    sdf_b = copy.deepcopy(sdf)
    sdf_b.cfg = dataclasses.replace(sdf.cfg, dtype="bfloat16")
    grid = ((torch.rand(GRID_CHUNK, 3, generator=g) * 2 - 1) * 1.01).to(dev)
    worst_f = max(worst_f, hold_forward(f"#12 4x256, {GRID_CHUNK}-point grid chunk", fs.sdf_value_fused,
                                        fs.sdf_only_plain, sdf, [grid], ("sdf",)))
    worst_bf16 = max(worst_bf16, hold_net_bf16(
        f"#12 4x256, {GRID_CHUNK}-point grid chunk", fs.sdf_value_fused, fs.sdf_only_plain, sdf_b,
        [grid], [(0.5 + torch.rand(GRID_CHUNK, 1, generator=g)).to(dev)], ("points",), ("sdf",)))
    spec = fs.spec_from_config(sdf.cfg)
    spec_b = fs.spec_from_config(sdf_b.cfg)
    weights = [w.detach() for w in fs.dense_weights(sdf)]
    flat = torch.cat([w.reshape(-1) for w in weights])
    packed = fn.pack_sdf_only_tc(spec_b, weights)
    flops_pt = fs.sdf_only_flops_per_point(spec)
    t = {}
    for tag, x in (("step", pts), ("grid", grid)):
        n = x.shape[0]
        with torch.no_grad():
            t[tag] = {
                "bf16": cuda_ms(lambda: fs.sdf_only_fwd(spec_b, flat, x, packed), reps=10),
                "bf16_entry": cuda_ms(lambda: fs.sdf_value_fused(sdf_b, x), reps=10),
                "f32": cuda_ms(lambda: fs.sdf_only_fwd(spec, flat, x), reps=5),
                "plain_bf16": cuda_ms(lambda: fs.sdf_only_plain(sdf_b, x), reps=3),
                "plain_f32": cuda_ms(lambda: fs.sdf_only_plain(sdf, x), reps=3),
                "bound": bound_tc(flops_pt * n, 4 * (4 * n)),
                "bound_f32": bound(flops_pt * n, 4 * (flat.numel() + 4 * n))}

    def pack():
        ws = [w.detach() for w in fs.dense_weights(sdf_b)]
        return torch.cat([w.reshape(-1) for w in ws]), fn.pack_sdf_only_tc(spec_b, ws)

    pack_ms = cuda_ms(pack, reps=10)
    for tag, what in (("step", f"{P} points (a train_clip step's sweeps)"),
                      ("grid", f"{GRID_CHUNK}-point grid chunk")):
        r = t[tag]
        tflops = r["bound"]["flops"] / r["bf16"] / 1e9
        print(f"[#12] sdf-only forward, 4x256, {flops_pt:.0f} GEMM FLOPs a point, {what}: bf16 "
              f"tensor-core kernel {r['bf16']:.3f} ms ({tflops:.1f} TFLOP/s; through the entry, its "
              f"pack included, {r['bf16_entry']:.3f} ms), f32 CUDA-core "
              f"kernel {r['f32']:.3f} ms; plain bf16 {r['plain_bf16']:.3f} ms, plain f32 "
              f"{r['plain_f32']:.3f} ms (no grad); bound bf16 tensor cores {r['bound']['bound_ms']:.3f} ms "
              f"({r['bound']['bound_by']}), f32 CUDA cores {r['bound_f32']['bound_ms']:.3f} ms")
    print(f"[#12] the pack of one call (dense weights, flat buffer, bf16 stack matrices): {pack_ms:.4f} ms; "
          f"the VJP (autograd of the plain version) max abs err {worst_b:.3e}; bf16 worst rel RMS "
          f"{worst_bf16:.3e}")
    (rs, rg) = t["step"], t["grid"]
    del fields, inputs, sdf_b, packed
    torch.cuda.empty_cache()
    return {"name": "sdf_only_fwd", "route": "cuda", "source": "avatarclip_torch/csrc/fused_neus_ray_tc.cu",
            "source_f32": "avatarclip_torch/csrc/fused_sdf.cu",
            "replaces": "avatarclip_tpu/ops/fused_sdf.py:626", "max_abs_err": worst_f,
            "ms": rs["bf16"], "ms_bf16": rs["bf16"], "ms_bf16_entry": rs["bf16_entry"], "ms_f32": rs["f32"],
            "pack_ms": pack_ms, "bf16_rel_rms_err": worst_bf16, "plain_ms": rs["plain_bf16"],
            "plain_ms_f32": rs["plain_f32"], "library_ms": None, **rs["bound"],
            "ms_grid_chunk": rg["bf16"], "ms_bf16_grid_chunk": rg["bf16"],
            "ms_bf16_entry_grid_chunk": rg["bf16_entry"], "ms_f32_grid_chunk": rg["f32"],
            "plain_ms_grid_chunk": rg["plain_bf16"], "plain_ms_f32_grid_chunk": rg["plain_f32"],
            "bound_ms_grid_chunk": rg["bound"]["bound_ms"],
            "bound_ms_f32_grid_chunk": rg["bound_f32"]["bound_ms"]}


def hold_brute(tag, coef, valid, sx, sy, H, W) -> int:
    """#15 against the plain version and against B2's winners on one
    render, bit for bit (one counted launch); the covered pixels."""
    import torch

    from avatarclip_torch.ops import raster_zbuffer as rz

    n0 = read_counts()["zbuffer_brute"]
    got = rz.zbuffer_select(coef, valid, H, W)
    if read_counts()["zbuffer_brute"] != n0 + 1:
        fail(f"#15 {tag}: {read_counts()['zbuffer_brute'] - n0} counted launches for one call")
    for what, want in (("the plain version", rz.zbuffer_select_plain(coef, valid, H, W)),
                       ("B2", rz.zbuffer_select_tiled(coef, valid, sx, sy, H, W))):
        if not torch.equal(got, want):
            fail(f"#15 {tag}: {int((got != want).sum())} pixels differ from {what}")
    return int((got >= 0).sum())


def check_zbuffer_brute(runner, dev):
    """#15 on the template at 256^2 (three training cameras), on a ragged
    triangle soup (200 x 232, 2,000 faces) and on the 13,441-face ShapeGen
    body at 256^2, equal to the plain version and B2 bit for bit, the body
    also at forced face splits of 1 and 2 and twice (the merge: the same
    bits); timed on that body beside B2 and on the 13,776-face body at 512^2
    (path f holds it on all of ShapeGen's views)."""
    import numpy as np
    import torch

    from avatarclip_torch.ops import raster_zbuffer as rz
    from avatarclip_torch.pipelines import synthetic
    from avatarclip_torch.render import raster

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
    body_v, body_f, body_pose, body_focal = synthetic.smpl_size_body_view(dev)
    cases.append(("13,441-face body 256^2", body_v, body_f, body_pose, (256, 256), body_focal))
    for name, v, f, pose, (H, W), focal in cases:
        proj = raster.project_vertices(v, pose, H, W, focal)
        coef, valid, _ = raster._face_coefficients(proj, f)
        cov = hold_brute(name, coef, valid, proj.sx[f], proj.sy[f], H, W)
        print(f"[#15] {name}: {cov} covered px; equal to the plain version and to B2 at every pixel "
              f"({rz.brute_ctas(H, W, f.shape[0])} CTAs)")
    # the merge at forced face splits, on the body (the last case)
    want = rz.zbuffer_select(coef, valid, H, W)
    keys = torch.empty(3 * H * W, dtype=torch.int32, device=dev)
    for split in (1, 2, 0, 0):
        rz.brute_launch(coef, valid, keys, keys[2 * H * W:], H, W, split)
        if not torch.equal(keys[2 * H * W:], want):
            fail(f"#15 body: the face split {split or 'of the entry'} changed the winners")
    print("[#15] 13,441-face body 256^2: face splits 1, 2 and the entry's (twice) give the same bits")
    scenes = synthetic.zbuffer_scenes(runner, dev)
    t = time_zbuffer("256^2, the 13,441-face body", *scenes["13,441-face body 256^2"], brute=True)
    t_v = time_zbuffer("512^2, the 13,776-face body", *scenes["13,776-face body 512^2"], brute=True)
    t_b2 = time_zbuffer("256^2, the 13,441-face body", *scenes["13,441-face body 256^2"])
    return {"name": "zbuffer_brute", "route": "cuda", "source": "avatarclip_torch/csrc/raster_zbuffer.cu",
            "replaces": "avatarclip_tpu/ops/raster_zbuffer.py:104", "max_abs_err": 0.0, "ms": t["ms"],
            "ms_kernel": t["ms_kernel"], "plain_ms": t["plain_ms"], "library_ms": None, **t["bound"],
            "floor_ms": t["floor_ms"], "ctas": t["ctas"], "ms_b2_same_render": t_b2["ms"],
            "ms_512_body": t_v["ms"], "ms_kernel_512_body": t_v["ms_kernel"],
            "plain_ms_512_body": t_v["plain_ms"], "bound_ms_512_body": t_v["bound"]["bound_ms"],
            "floor_ms_512_body": t_v["floor_ms"], "ctas_512_body": t_v["ctas"]}


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def zero_counts():
    from avatarclip_torch.utils import trace

    trace.reset_counters()


def read_counts() -> dict:
    from avatarclip_torch.utils import trace

    return trace.launches()


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
    with record_b1() as rec_b1:
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
    hold_b1_recorded(rec_b1)
    extra = megakernel_against_gate_shut(conf_path, sets)
    launches_a = {k: launches_a[k] + extra[k] for k in launches_a}

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


# path (a) at bf16, the megakernel path against the per-sample branch, from
# the same checkpoint, seed and draws (readings of the final run before
# these were set, NVIDIA H100 80GB HBM3: the loss 3.1e-5 apart)
STEP_BF16_TOL = 1e-3  # relative, the first step's loss
STEP_GRAD_TOL = 5e-2  # relative RMS, the first step's parameter gradients (two bf16 roundings)
STEP_UPDATE_TOL = 1e-2  # relative RMS, the first step's Adam update (resumed moments)


@contextlib.contextmanager
def record_b1():
    """Within the block, B1's entry (fused_neus.point_eval_ray) records its
    largest call with grad: copies of the nets and of the inputs, inv_s,
    cos_anneal, its eikonal partial sums, and the cotangents its outputs
    receive in the backward."""
    import torch

    from avatarclip_torch.ops import fused_neus as fn

    rec = {}
    entry = fn.point_eval_ray

    def call(sdf, color, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal):
        outs = entry(sdf, color, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal)
        if torch.is_grad_enabled() and mid_z.shape[0] > rec.get("rays", 0):
            rec.clear()
            rec.update(rays=mid_z.shape[0], sdf=copy.deepcopy(sdf), color=copy.deepcopy(color),
                       inv_s=inv_s.detach().float().reshape(()).clone(), cos=float(cos_anneal),
                       ins=[t.detach().float().contiguous().clone() for t in (rays_o, rays_d, mid_z, dists)],
                       eik=outs[3].detach().clone(), cots=[None] * 4,
                       shapes=[o.shape for o in outs])
            for i, o in enumerate(outs):
                if o.requires_grad:
                    o.register_hook(lambda g, i=i: rec["cots"].__setitem__(i, g.detach().float().clone()))
        return outs

    fn.point_eval_ray = call
    try:
        yield rec
    finally:
        fn.point_eval_ray = entry


def hold_b1_recorded(rec) -> None:
    """B1 held (hold_b1_full) on path (a)'s own largest step: its rays,
    samples, nets (dense copies: the weight columns are the dense gradients
    the kernel computes), inv_s (a leaf here), cos_anneal and the cotangents
    the step gave its outputs (the eikonal partial sums' as the loss's:
    d/d num times den + 1e-5)."""
    import torch

    from avatarclip_torch.fields import networks as nets
    from avatarclip_torch.ops import hold

    if rec.get("rays") != B1_RAYS:
        fail(f"path a: B1's largest step took {rec.get('rays')} rays, expected {B1_RAYS}")

    class InvS(torch.nn.Module):
        def __init__(self, v):
            super().__init__()
            self.v = torch.nn.Parameter(v)

        def inv_s(self):
            return self.v

    fields = torch.nn.Module()
    fields.sdf, fields.color = hold.dense_copy(rec["sdf"]), hold.dense_copy(rec["color"])
    fields.variance = InvS(rec["inv_s"])
    if not nets.operand_bf16(fields.sdf.cfg):
        fail("path a: the conf's nets are not in the bf16 operand mode")
    dev = rec["ins"][0].device
    cots = [torch.zeros(s, device=dev) if c is None else c.reshape(s)
            for c, s in zip(rec["cots"], rec["shapes"])]
    cots[3] = cots[3][0] * (rec["eik"][1] + 1e-5)
    hold_b1_full(f"B1 path a step, {B1_RAYS} rays x {rec['ins'][2].shape[1]}", fields, rec["ins"],
                 cots, rec["cos"])
    rec.clear()
    torch.cuda.empty_cache()


def megakernel_against_gate_shut(conf_path: str, sets) -> dict:
    """Two train_clip steps from (a)'s step-8 checkpoint at the conf's own
    compute dtype (bf16), twice from the same seed and draws: through the
    per-ray megakernel (B1's tensor-core pair) and with neus._FORCE_MEGA =
    False (the per-sample branch: B6 and B7 at their bf16 operands, then the
    plain alpha and compositing). The first step's losses within
    STEP_BF16_TOL, its parameter gradients within STEP_GRAD_TOL and its Adam
    update within STEP_UPDATE_TOL (relative RMS over every parameter): both
    paths round the dots' operands at the JAX kernels' points, in another
    order and with other f32 sums. Prints both step times
    (the second step: the first of a runner pays one-time costs) and
    profiles three more megakernel steps (device busy share, time by
    kernel). Returns the launches of the counted steps."""
    import torch

    from avatarclip_torch.pipelines import appearance
    from avatarclip_torch.render import neus

    out, total = {}, want_counts()
    try:
        for force in (None, False):
            neus._FORCE_MEGA = force
            r = appearance.Runner(conf_path, "gate", conf=resumed_conf(conf_path, sets),
                                  is_continue=True)
            dtype = r.conf.get_string("train.compute_dtype", "bfloat16")
            r.init_clip()
            r.init_smpl()
            zero_counts()
            losses, secs = [], []
            params = [p for grp in r.optimizer.param_groups for p in grp["params"]]
            flat = lambda ts: torch.cat([t.detach().float().reshape(-1).cpu() for t in ts])
            for step_i in range(2):
                cam, S = r.sample_iteration_camera(r.iter_step)
                before = flat(params) if step_i == 0 else None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, _ = r.clip_loss(S, cam, r.draw_clip(S), r.iter_step)
                r._update(loss)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(float(loss.detach()))
                if step_i == 0:
                    grads = flat([torch.zeros_like(p) if p.grad is None else p.grad for p in params])
                    update = flat(params) - before
                r.iter_step += 1
            counts = read_counts()
            for k, v in counts.items():
                total[k] += v
            out[force] = (losses, secs, counts, S, grads, update)
            if force is None:  # the step's device busy share and kernels (uncounted)

                def step(r=r):
                    cam, S_ = r.sample_iteration_camera(r.iter_step)
                    loss, _ = r.clip_loss(S_, cam, r.draw_clip(S_), r.iter_step)
                    r._update(loss)
                    r.iter_step += 1

                profile_steps("main a, train_clip at the conf's dtype", step, n=3)
            del r
            torch.cuda.empty_cache()
    finally:
        neus._FORCE_MEGA = None
    (lk, tk, ck, S, gk, uk), (lg, tg, cg, _, gg, ug) = out[None], out[False]
    if ck["neus_ray_fwd"] != 2 or ck["neus_ray_bwd"] != 2 or cg["neus_ray_fwd"] != 0:
        fail(f"path a, megakernel against the gate shut: launches {ck} / {cg}")
    if cg["sdf_fwd"] != 2 or cg["sdf_bwd"] != 2 or cg["color_fwd"] != 2 or cg["color_bwd"] != 2:
        fail(f"path a, gate shut: B6 / B7 launches {cg}")
    rel = abs(lk[0] - lg[0]) / abs(lg[0])
    if not rel <= STEP_BF16_TOL:
        fail(f"path a at {dtype}: loss through the megakernel {lk[0]} vs the gate shut {lg[0]} "
             f"(rel {rel:.2e} > {STEP_BF16_TOL})")
    rel_g = float((gk - gg).norm() / gg.norm())
    rel_u = float((uk - ug).norm() / ug.norm())
    if not (rel_g <= STEP_GRAD_TOL and rel_u <= STEP_UPDATE_TOL):
        fail(f"path a at {dtype}: the first step's parameter gradients {rel_g:.2e} apart (tolerance "
             f"{STEP_GRAD_TOL}), its Adam updates {rel_u:.2e} (tolerance {STEP_UPDATE_TOL})")
    print(f"[main a] the first step through the megakernel against the gate shut: parameter "
          f"gradients {rel_g:.3e} apart, Adam updates {rel_u:.3e} (relative RMS over "
          f"{gk.numel()} parameters)")
    print(f"[main a] one train_clip step at the conf's {dtype} from the step-{N_STEPS} checkpoint "
          f"({S}^2 bucket), same seed and draws: loss through the per-ray megakernel {lk[0]:.7f}, "
          f"with the gate shut (B6 / B7 per sample) {lg[0]:.7f} (rel {rel:.2e}, tolerance "
          f"{STEP_BF16_TOL}); second step {tk[1] * 1e3:.3f} ms megakernel, {tg[1] * 1e3:.3f} ms gate "
          f"shut (first {tk[0] * 1e3:.3f} / {tg[0] * 1e3:.3f} ms)")
    return total


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
    columns are the dense gradients the kernels compute. At the conf's bf16
    operand mode the holds are hold_bf16_sets'. The max abs errors by kernel
    name (of the f32 holds)."""
    import torch

    from avatarclip_torch.fields import networks as nets
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
        bf16 = nets.operand_bf16(net.cfg)  # the conf's mode: bf16 at every conf's default
        cots = [torch.zeros(s, device=r["ins"][0].device) if c is None else c
                for c, s in zip(r["cots"], r["shapes"])]
        name = f"{tag} path e step, {PATH_E_POINTS} points"
        if bf16:
            hold_net_bf16(name, fused, plain, net, r["ins"], cots, in_names, out_names)
        else:
            errs[fwd], errs[bwd] = hold_net(name, fused, plain, net, r["ins"], cots, in_names,
                                            out_names, relu_ties=tag == "B7")
        del net, cots, rec[(tag, "step")]
        r = rec[(tag, "render")]
        name, net = f"{tag} path e render chunk, {VAL_CHUNK * 64} points", hold.dense_copy(r["net"])
        if bf16:
            with torch.no_grad():
                got = fused(net, *r["ins"])
            got = list(got) if isinstance(got, tuple) else [got]
            ref = hold.net_outputs(plain, hold.f32_copy(net).double(),
                                   [t.double() for t in r["ins"]], chunk=REF_CHUNK)
            hold_bf16_sets(name, out_names, got, hold.net_outputs(plain, net, r["ins"],
                                                                  chunk=REF_CHUNK), ref)
            del got, ref
        else:
            errs[fwd] = max(errs[fwd], hold_forward(name, fused, plain, net, r["ins"], out_names))
        del net, rec[(tag, "render")]
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
    want.update(soft_fwd=soft, soft_bwd=soft, soft_fwd_reduce=soft, soft_bwd_reduce=soft,
                zbuffer_tiled=zbuffer)
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
    return launches, views, {"obj": gen["obj"], "render_dir": render_dir}


def hold_brute_on_views(views) -> None:
    """#15 against its plain version and B2, bit for bit, on every render
    path (f) gave B2."""
    cov = 0
    t0 = time.perf_counter()
    for i, (coef, valid, sx, sy, H, W) in enumerate(views):
        cov += hold_brute(f"path f render {i}", coef, valid, sx, sy, H, W)
    print(f"[#15] on path (f)'s {len(views)} renders of the {views[0][0].shape[0]}-face body "
          f"({views[0][4]}x{views[0][5]}): {cov} covered px in all, equal to the plain version and to B2 "
          f"at every pixel ({time.perf_counter() - t0:.3f} s)")


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


PARALLEL_RANKS = 2  # path (j): gloo ranks sharing the one card
PARALLEL_RAYS, PARALLEL_SAMPLES = 4096, 64  # (j2): graft_entry's rays x 64 samples
PARALLEL_TIMED = 6  # (j1): train_clip steps timed after the checked ones (the buckets repeat)


def run_parallel_path() -> dict:
    """Path (j), data-parallel training (avatarclip_torch.parallel.dryrun) on
    PARALLEL_RANKS gloo ranks sharing the card, each rank a process of its
    own, against N = 1 in this process: (j1) one train_clip step (12,544
    rays, 6,272 a rank) and one photometric step of the scale="full" runner
    from the same parameters, optimizer state and seed, then PARALLEL_TIMED
    more train_clip steps timed; (j2) the kernel-path gradient (JAX's
    ``_kernel_path_1_vs_n``) at 4,096 rays x 64 samples, 2,048 a rank,
    through render_core with per_ray False (B3's and B4's pairs: #5 and #7
    launch here) and True (B1), in bf16 (held by hold.bf16_within against
    the f32 function in f64 at N and at 1) and in f32 (N against 1 at JAX's
    rtol, its atol of each gradient's scale, and each against f64); (j3)
    ``graft_entry.entry()`` once. Returns the launches:
    each rank's own, summed, plus this process's."""
    import torch

    from avatarclip_torch import graft_entry
    from avatarclip_torch.parallel import dryrun

    zero_counts()
    t0 = time.perf_counter()
    rep = dryrun.run(PARALLEL_RANKS, device="cuda", backend="gloo", scale="full", res=256,
                     rays=PARALLEL_RAYS, samples=PARALLEL_SAMPLES,
                     dtypes=("bfloat16", "float32"), timed_steps=PARALLEL_TIMED)
    wall = time.perf_counter() - t0
    tr = rep["train"]
    med = lambda xs: statistics.median(xs)
    print(f"[main j] {PARALLEL_RANKS} gloo ranks on one card, {wall:.3f} s with the N = 1 runs and "
          f"the checks: (j1) scale full, train_clip at {tr['sil_res']}^2 with {tr['rays']} rays "
          f"({tr['rays'] // PARALLEL_RANKS} a rank), photometric {tr['batch']} rays: replicas "
          f"equal, max abs diff N vs 1: grads {tr['grads_clip']:.3e} / {tr['grads_photo']:.3e}, "
          f"params {tr['params_clip']:.3e} / {tr['params']:.3e}; loss N {tr['metrics']['loss'][0]:.6f}"
          f", 1 {tr['metrics']['loss'][1]:.6f}")
    print(f"[main j] (j1) step seconds (synchronised; gloo stages every collective through the "
          f"host, so N = {PARALLEL_RANKS} on one card is no multi-card speed): first train_clip "
          f"and photometric at N: {tr['first_seconds']['N']}, at 1: {tr['first_seconds']['1']}; "
          f"{PARALLEL_TIMED} more train_clip steps at N: {tr['step_seconds']['N']} (median of rank 0 "
          f"{med(tr['step_seconds']['N'][0]):.4f} s), at 1: {tr['step_seconds']['1']} (median "
          f"{med(tr['step_seconds']['1']):.4f} s)")
    for row in rep["kernel"]:
        held = (f"N vs 1 max abs diff {row['max_abs_N_vs_1']:.3e} (rtol 1e-4, atol 1e-5 of "
                f"max(1, |largest|)), from f64 N {row['rel_f64_N']:.2e} / 1 "
                f"{row['rel_f64_1']:.2e} of the largest"
                if "max_abs_N_vs_1" in row else
                f"held at N and at 1 by hold.bf16_within, worst {row['bf16_worst_ratio']:.2f}x "
                f"the plain bf16 version's")
        print(f"[main j] (j2) {row['dtype']} {row['rays']} x {row['samples']} per_ray="
              f"{row['per_ray']}: rel RMS N vs 1 {row['rel_N_vs_1']:.3e}, {held}; gradient s: "
              f"ranks {[round(x, 4) for x in row['seconds_N']]}, N = 1 {row['seconds_1']:.4f}")
    ranks, one = rep["launches_ranks_sum"], rep["launches_1"]
    want = PARALLEL_RANKS * 2  # a backward a rank in each operand mode
    for k in ("neus_point_bwd", "composite_bwd", "neus_point_fwd", "composite_fwd"):
        if ranks[k] != want or one[k] != 2:
            fail(f"path j: {k} launched {ranks[k]} times on the ranks, {one[k]} at N = 1; "
                 f"expected {want} and 2")
    print(f"[main j] launches, each rank its own: {rep['launches_ranks']}; N = 1: {one}")
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    with torch.no_grad():
        col, extra, ws = fn(*args)
    torch.cuda.synchronize()
    wall_e = time.perf_counter() - t0
    R = graft_entry.ENTRY_RAYS
    for nm, t, shape in (("color", col, (R, 3)), ("extra", extra, (R, 3)), ("weight_sum", ws, (R, 1))):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            fail(f"path j3: entry()'s {nm} {tuple(t.shape)}, finite {bool(torch.isfinite(t).all())}")
    if not (ws.min() >= 0 and ws.max() <= 1 + 1e-5):
        fail(f"path j3: entry()'s weight_sum in [{float(ws.min())}, {float(ws.max())}]")
    launches = read_counts()
    print(f"[main j] (j3) graft_entry.entry(): {R} rays, 32 + 32 samples, 4 up-sample steps, "
          f"4x256 / 2x256 at bf16: {wall_e:.3f} s with the set-up, outputs finite, weight_sum "
          f"{float(ws.mean()):.4f} on average; launches in this process {launches}")
    for k in launches:
        launches[k] += ranks[k]
    return launches


def run_sweep_hook_path(conf_path: str, sets) -> dict:
    """networks._SWEEP_KERNEL on against off on (a)'s step-8 checkpoint: the
    validate_mesh mode's 512^3 extraction (its grid query through
    networks.sdf_value) and one train_clip step at the same seed. The
    runners of the holds compute in float32 (train.compute_dtype): there #12
    and the plain module agree to f32 rounding. At the confs' bf16 the
    kernel takes bf16 dot operands as the JAX hook does, while the plain
    module also keeps its activations in bf16 (the JAX XLA path's rounding
    points), so the two differ by more than rounding: what a user at the
    conf's own dtype sees on turning the hook on is printed as a reading,
    one more hook-off and hook-on extraction at the conf's dtype. The
    launches of all."""
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
        for hook in (False, True):
            nets._SWEEP_KERNEL = hook
            grid["conf", hook] = extract(runner)
        nets._SWEEP_KERNEL = False
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
    u_c, nv_c, c_c, k_c, w_c = grid["conf", False]
    u_cb, nv_cb, c_cb, k_cb, w_cb = grid["conf", True]
    if k_c != want_counts() or k_cb != want_counts(sdf_only_fwd=c_cb):
        fail(f"path h grid at the conf's dtype: launches hook off {k_c}, hook on {k_cb}")
    rel_c = float(np.abs(u_cb - u_c).max()) / max(float(np.abs(u_c).max()), 1e-12)
    (l0, s0, t_0, S), (l1, s1, t_1, _) = step[False], step[True]
    if s0["sdf_only_fwd"] != 0 or s1 != {**s0, "sdf_only_fwd": sweeps}:
        fail(f"path h step: launches hook off {s0}, hook on {s1}")
    if not abs(l1 - l0) <= 1e-4 * abs(l0):
        fail(f"path h step: loss hook on {l1} vs off {l0}")
    print(f"[main h] the sweep hook, float32 runners: validate_mesh's 512^3 extraction, hook off "
          f"{w0:.3f} s ({c0} chunks), on {w1:.3f} s ({c1} chunks, #12 launched {k1['sdf_only_fwd']} "
          f"times); grid rel err {rel:.3e}, marching-cubes vertices {nv1} vs {nv0}")
    print(f"[main h] reading, not a hold: at the conf's compute_dtype ({conf_dtype}) the hook-off grid "
          f"({w_c:.3f} s, {c_c} chunks) is {rel_c:.3e} relative from the hook-on grid (#12 at its bf16 "
          f"operands on the tensor cores, launched {k_cb['sdf_only_fwd']} times, {w_cb:.3f} s), "
          f"marching-cubes vertices {nv_c} off vs {nv_cb} on ({(nv_cb - nv_c) / nv_c * 100:+.3f}%)")
    print(f"[main h] one train_clip step from the step-{N_STEPS} checkpoint ({S}^2 bucket): loss hook off "
          f"{l0:.7f}, on {l1:.7f} (rel {abs(l1 - l0) / abs(l0):.2e}); {t_0 * 1e3:.3f} / {t_1 * 1e3:.3f} ms "
          f"(first step of a runner); #12 launches {s1['sdf_only_fwd']}; launches hook on {s1}")
    return total


# ---------------------------------------------------------------------------
# (i) the reference schedule's self-generated route
# ---------------------------------------------------------------------------

SCHED_ITERS = 8  # pretrain and sculpt steps (the schedules: 300,000 and 100,000)
SCHED_MCUBE = 256  # the extraction's grid (path b runs the 512^3 mode)
PHOTO_VIEWS = (0, 27, 54, 81)
TRACE_STEPS = 3
CLIP_COS_TOL = 1e-3  # kernel path against the plain path, absolute
N_CALIB = 12 * 4 + 2  # coverage renders of the silhouette calibration
SCHED_STAGES = ["pretrain", "sculpt_eval_before", "sculpt", "sculpt_eval_after", "extract", "export"]


def cut_runner(make_runner, pretrain: str):
    """The schedule twin's make_runner with its iteration counts cut:
    ``train.end_iter`` and ``train.save_freq`` put to SCHED_ITERS, so each
    run ends in a checkpoint that the evals, the trace and the extraction
    resume; and the pretrain stage (mode ``train``) starts from ``pretrain``,
    the SDF fitted to the template, in place of its 300,000 steps from the
    geometric init (8 steps from that init leave a surface of wrinkles: 1.95
    million vertices at 256^3, and the export's nearest-vertex search then
    took minutes). No flag is added to the twin."""
    from avatarclip_torch.pipelines import appearance

    def make(conf_text, mode, is_continue=False, device=None):
        if mode == "train":
            conf_text = conf_text.replace("train {", f"train {{\n    pretrain = {pretrain}", 1)
        r = make_runner(conf_text, mode, is_continue=is_continue, device=device)
        for key in ("train.end_iter", "train.save_freq"):
            r.conf.put(key, SCHED_ITERS)
        r.tc = appearance.train_config_from_conf(r.conf)
        return r

    return make


@contextlib.contextmanager
def record_point_eval():
    """Within the block, B3's entry (fused_neus.point_eval) records each
    call's inputs (copies)."""
    from avatarclip_torch.ops import fused_neus as fn

    entry, rec = fn.point_eval, []

    def call(sdf, color, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal):
        rec.append(([t.detach().clone() for t in (rays_o, rays_d, mid_z, dists)],
                    inv_s.detach().reshape(()).clone(), float(cos_anneal)))
        return entry(sdf, color, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal)

    fn.point_eval = call
    try:
        yield rec
    finally:
        fn.point_eval = entry


def image_from_samples(fields, rec, dtype) -> "torch.Tensor":
    """The validation render's extra-colour image on white from B3's
    recorded inputs, through the plain point evaluation and the plain
    compositing in ``dtype`` (B3_REF_RAYS rays at a time): (rays, 3)."""
    import torch

    from avatarclip_torch.ops import fused_composite, fused_neus as fn

    out = []
    for ins, inv_s, cos in rec:
        for a in range(0, ins[0].shape[0], B3_REF_RAYS):
            part = [t[a:a + B3_REF_RAYS].to(dtype) for t in ins]
            R, S = part[2].shape
            with torch.no_grad():
                _, grad, rgb, alpha, _, _, _ = fn.point_eval_plain(fields.sdf, fields.color, *part,
                                                                   inv_s.to(dtype), cos)
                w, _, extra, _ = fused_composite.composite_plain(
                    alpha.detach().reshape(R, S), rgb.detach().reshape(R, S, -1),
                    grad.detach().reshape(R, S, 3))
            out.append(extra + (1.0 - w.sum(-1, keepdim=True)))
    return torch.cat(out)


def trace_kernels(path: str) -> dict:
    """Kernel events of a Chrome trace by the names of B1's and B2's kernels
    (B1's, the tensor-core pair's per-ray instantiations, apart from B3's
    point-level ones)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    keys = {"B1 fwd": r"neus_tc_fwd_kernel<(false|\(bool\)0)>",
            "B1 bwd": r"neus_tc_bwd_kernel<(false|\(bool\)0)>",
            "B3 bwd": r"neus_tc_bwd_kernel<(true|\(bool\)1)>",
            "wgrad_kernel": "wgrad_kernel", "face_ranges_kernel": "face_ranges_kernel",
            "zbuffer_binned_kernel": "zbuffer_binned_kernel"}
    out = {k: sum(bool(re.search(pat, n)) for n in names) for k, pat in keys.items()}
    out["steps"] = sum(1 for e in events
                       if e.get("name") == "loop.step" and e.get("cat") == "user_annotation")
    out["kernel events"] = len(names)
    return out


def hold_clip_score(runner, dev) -> dict:
    """clip_score through the kernels against clip_score through the plain
    path (neus._FORCE_MEGA = False) on one runner: one lattice view's image
    (65,536 rays at 256^2) within hold.bf16_within of the f32 function in
    f64, beside the plain bf16 version, on the samples the kernel path took;
    every cosine of the 9 views within CLIP_COS_TOL; two kernel-path calls
    the same cosines; prints the evals' seconds."""
    import numpy as np
    import torch

    from avatarclip_torch.ops import hold
    from avatarclip_torch.pipelines import eval_clip
    from avatarclip_torch.render import cameras, neus

    runner.init_clip()
    pose = eval_clip._pose(cameras.sphere_coord_np(0.0, 0.0, 1.5), np.zeros(3), dev)
    rays_o, rays_d = runner.dataset.gen_rays_pose(pose, 1)
    with record_point_eval() as rec:
        got = runner.render_rays_chunked(rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
                                         background_rgb=torch.ones(1, 3, device=dev),
                                         keys=["extra_color_fine"])["extra_color_fine"]
    plain = image_from_samples(runner.fields, rec, torch.float32)
    ref = image_from_samples(hold.f32_copy(runner.fields).double(), rec, torch.float64)
    ek, ep, ok = hold.bf16_within(torch.from_numpy(got), plain.cpu(), ref.cpu())
    n_rays = got.shape[0]
    print(f"[main i] one lattice view ({n_rays} rays, {len(rec)} chunks) through B3 / B4's forwards "
          f"against the f32 function in f64 on the samples the render took: rel RMS {ek:.3e}, the plain "
          f"bf16 version's {ep:.3e}")
    if not ok or n_rays != 256 * 256:
        fail(f"path i: the eval's image at rel RMS {ek:.3e} against the plain bf16 version's {ep:.3e}")
    del plain, ref, rec

    def score():
        t0 = time.perf_counter()
        rep = eval_clip.clip_score(runner, n_views=8)
        torch.cuda.synchronize()
        return rep, time.perf_counter() - t0

    rep1, sec1 = score()
    rep2, sec = score()
    neus._FORCE_MEGA = False
    try:
        rep_p, sec_p = score()
    finally:
        neus._FORCE_MEGA = None
    k = list(rep1.cosines) + [rep1.face_cosine, rep1.back_cosine]
    p = list(rep_p.cosines) + [rep_p.face_cosine, rep_p.back_cosine]
    gap = max(abs(a - b) for a, b in zip(k, p))
    if not all(math.isfinite(c) for c in k) or gap > CLIP_COS_TOL:
        fail(f"path i: kernel-path cosines {k} against the plain path's {p} ({gap:.2e} apart)")
    if rep2.cosines != rep1.cosines or rep2.face_cosine != rep1.face_cosine:
        fail(f"path i: two kernel-path evals differ: {rep1.cosines} / {rep2.cosines}")
    views = rep1.n_views + (rep1.face_cosine is not None)
    print(f"[main i] clip_score on the sculpt checkpoint, {views} views at 256^2 ({card()}): kernel path "
          f"{sec:.3f} s warm ({views / sec:.2f} renders/s, {views * n_rays / sec:.0f} rays/s with the CLIP "
          f"encode; the first call {sec1:.3f} s), plain path {sec_p:.3f} s; cosines "
          f"{[round(c, 6) for c in k]}, {gap:.2e} from the plain path's; two kernel-path calls equal")
    profile_steps("main i, clip_score through the kernels", lambda: eval_clip.clip_score(runner, n_views=8),
                  n=1)


def run_schedule_path(tmp: str, coarse_obj: str, render_dir: str, pretrain: str, dev) -> dict:
    """The schedule twin's stages in-process (avatarclip_torch.scripts.
    run_reference_schedule) on path (f)'s coarse body and 108-view render:
    pretrain (8 steps from ``pretrain``, the fitted SDF), the photometric
    eval of 4 views, sculpt (8 steps
    with the CLIP score of 8 views and the face camera before and after),
    profile_trace (3 steps), extract at 256^3 and export; the launches of
    those stages. Then the CLIP-score hold and the trace's kernels."""
    import types

    import torch

    from avatarclip_torch.scripts import eval_photometric
    from avatarclip_torch.scripts import run_reference_schedule as rrs

    root = os.path.join(tmp, "schedule")
    base = ["--exp_root", root, "--data_dir", render_dir, "--sculpt_data_dir", "", "--template_obj",
            coarse_obj, "--device", str(dev)]
    args = types.SimpleNamespace(template_obj=coarse_obj, sculpt_data_dir="", data_dir=render_dir,
                                 pose_type="stand_pose")
    trace_dir = os.path.join(root, "trace")
    walls, out = {}, {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0

    def trace():
        r = rrs.make_runner(rrs._sculpt_conf(args, "none"), "train_clip", is_continue=True, device=dev)
        if r.iter_step != SCHED_ITERS:
            fail(f"path i: the trace resumed step {r.iter_step}")
        return r.profile_trace(trace_dir, n_iters=TRACE_STEPS)

    make = rrs.make_runner
    rrs.make_runner = cut_runner(make, pretrain)
    zero_counts()
    try:
        stage("pretrain", lambda: rrs.main(["--stage", "pretrain", "--pretrain_iters", str(SCHED_ITERS),
                                            "--val_freq", str(10 * SCHED_ITERS)] + base))
        stage("photometric eval", lambda: eval_photometric.main(
            ["--exp", os.path.join(root, "pretrain"), "--data_dir", render_dir, "--res_level", "1",
             "--device", str(dev), "--views"] + [str(v) for v in PHOTO_VIEWS]))
        stage("sculpt", lambda: rrs.main(["--stage", "sculpt"] + base))
        stage("profile_trace", trace)
        stage("extract", lambda: rrs.main(["--stage", "extract", "--mcube_resolution",
                                           str(SCHED_MCUBE)] + base))
        stage("export", lambda: rrs.main(["--stage", "export"] + base))
    finally:
        rrs.make_runner = make
    launches = read_counts()

    with open(os.path.join(root, "schedule_log.jsonl")) as f:
        log = {r["stage"]: r for r in map(json.loads, f)}
    if list(log) != SCHED_STAGES:
        fail(f"path i: schedule_log.jsonl stages {list(log)}, expected {SCHED_STAGES}")
    photo = out["photometric eval"]
    if ([r["view"] for r in photo["views"]] != list(PHOTO_VIEWS)
            or not all(math.isfinite(r["psnr_db"]) and 0.0 <= r["mask_iou"] <= 1.0 for r in photo["views"])):
        fail(f"path i: photometric eval {photo}")
    for name in ("sculpt_eval_before", "sculpt_eval_after"):
        rep = log[name]
        if (len(rep["cosines"]) != 8 or rep["face_cosine"] is None or rep["pretrained_clip"]
                or not all(math.isfinite(c) for c in rep["cosines"] + [rep["face_cosine"]])):
            fail(f"path i: {name} {rep}")
    if log["pretrain"]["iters"] != SCHED_ITERS or log["sculpt"]["iters"] != SCHED_ITERS:
        fail(f"path i: pretrain {log['pretrain']['iters']}, sculpt {log['sculpt']['iters']} steps")
    nv = log["extract"]["n_vertices"]
    if nv <= 0 or log["extract"]["n_faces"] <= 0 or log["export"]["pc2_bytes"] <= 0 or log["export"]["glb_bytes"] <= 0:
        fail(f"path i: extract {log['extract']}, export {log['export']}")
    cast = check_png(os.path.join(root, "sculpt", "cast_light_texture_head_black.png"))
    eval_chunks = 2 * 9 * math.ceil(256 * 256 / VAL_CHUNK)  # before and after: 8 views + the face
    photo_chunks = len(PHOTO_VIEWS) * math.ceil(256 * 256 / VAL_CHUNK)
    bake_chunks = 6 * math.ceil(nv / VAL_CHUNK) + math.ceil(cast[0] * cast[1] / VAL_CHUNK)
    steps = 2 * SCHED_ITERS + 1 + TRACE_STEPS  # pretrain, sculpt, the trace's warm-up and window
    points = photo_chunks + eval_chunks + bake_chunks
    want = want_counts(neus_ray_fwd=steps, neus_ray_bwd=steps,
                       zbuffer_tiled=SCHED_ITERS + N_CALIB + 1 + TRACE_STEPS + N_CALIB,
                       neus_point_fwd=points, composite_fwd=points)
    if launches != want:
        fail(f"path i: kernel launches {launches}, expected {want}")
    tk = trace_kernels(os.path.join(trace_dir, "trace.json"))
    if (tk["steps"] != TRACE_STEPS or tk["B1 fwd"] != TRACE_STEPS or tk["B3 bwd"]
            or tk["B1 bwd"] < TRACE_STEPS or tk["zbuffer_binned_kernel"] != TRACE_STEPS
            or tk["face_ranges_kernel"] != TRACE_STEPS):
        fail(f"path i: the trace's kernels {tk}, expected {TRACE_STEPS} steps' B1 and B2 launches")
    cos0, cos1 = log["sculpt_eval_before"]["mean_cosine"], log["sculpt_eval_after"]["mean_cosine"]
    print(f"[main i] schedule stages (run_reference_schedule in-process, EXP_ROOT in the run's temporary "
          f"directory; {SCHED_ITERS} pretrain and sculpt steps; {card()}): wall s "
          f"{ {k: round(v, 3) for k, v in walls.items()} }; photometric eval views {list(PHOTO_VIEWS)}: PSNR "
          f"{[float(r['psnr_db']) for r in photo['views']]} dB, IoU {[r['mask_iou'] for r in photo['views']]}; mean "
          f"cosine before {cos0:.6f}, after {cos1:.6f}; {SCHED_MCUBE}^3 mesh {nv} vertices, cast light {cast}; "
          f"trace {tk}; launches {launches}")

    runner = rrs.make_runner(rrs._sculpt_conf(args, "none"), "eval", is_continue=True, device=dev)
    hold_clip_score(runner, dev)
    del runner
    torch.cuda.empty_cache()
    return launches


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
    print(f"[device] {card()}")
    dev = torch.device("cuda:0")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from avatarclip_torch.ops import _build

    t0 = time.perf_counter()
    libs = [("raster_zbuffer", "raster_zbuffer.cu"), ("fused_neus_ray", "fused_neus_ray.cu"),
            ("fused_neus_point", "fused_neus_point.cu"), ("fused_composite", "fused_composite.cu"),
            ("fused_soft", "fused_soft.cu"), ("fused_sdf", "fused_sdf.cu"),
            ("fused_color", "fused_color.cu"), ("fused_neus_ray_tc", "fused_neus_ray_tc.cu")]
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
            counts, views, shape_out = run_shape_path(tmp, dev)
            add(counts)
            hold_brute_on_views(views)  # #15 held on path (f)'s renders too
            del views
            torch.cuda.empty_cache()
            add(run_schedule_path(tmp, shape_out["obj"], shape_out["render_dir"], pretrain, dev))
            torch.cuda.empty_cache()
            add(run_export_path(tmp, os.path.join(tmp, "exp", "meshes", f"{N_STEPS:08d}.ply"),
                                os.path.join(tmp, "exp_motion", "motion.npy"), body_dir))
            torch.cuda.empty_cache()
            add(run_parallel_path())
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
