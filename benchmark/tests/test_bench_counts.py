"""The frozen counts reproduce PERF.md's bounds of the kernel table at its
shapes: rows 1-2 (B1 at a train_clip step's 12,544 rays x 64 samples,
4x256 / 2x256 with the extra head) and rows 8-9 (B5 at a PoseOptimizer
step: 5 views x 224^2 of the 13,776-face body at the zero pose, elevations
0.3 N(0, 1) from seed 0, sigma 0.5, the card's 1,980 MHz SM clock)."""

import math

import pytest
import torch

from benchmark.counts import neus, peaks, soft, vit
from benchmark.harness import inputs, registry
from benchmark.reference import cameras, raster, smpl


def test_b1_bounds_at_a_train_clip_step():
    m = registry.config("appearance-full")["model"]
    d = neus.dims(m["sdf_network"], m["rendering_network"])
    f, b = neus.gemm_flops(d)
    P = 12544 * 64
    fb, bb = neus.pass_bytes(d, 12544, 64)
    fwd, bwd = peaks.bound_tc(f * P, fb), peaks.bound_tc(b * P, bb)
    assert fwd["bound_by"] == bwd["bound_by"] == "operations"
    assert round(fwd["bound_ms"], 3) == 0.963 and round(bwd["bound_ms"], 3) == 2.889
    assert round(fwd["bound_ms_f32"], 3) == 14.215 and round(bwd["bound_ms_f32"], 3) == 42.644


def test_model_flops_leave_out_the_recompute():
    m = registry.config("appearance-full")["model"]
    d = neus.dims(m["sdf_network"], m["rendering_network"])
    f, b = neus.gemm_flops(d)
    recompute = f - (2 * d.SW * d.H + (d.NH - 1) * 2 * d.H * d.H + 2 * d.H * d.E)  # the stacks again
    assert neus.model_flops(d) == pytest.approx(f + b - recompute)
    assert neus.sdf_only_flops(d) < f


def test_vit_b32_flops():
    cfg = registry.config("appearance-full")["clip"]
    fwd = vit.image_forward_flops(cfg)
    assert fwd == pytest.approx(8.8e9, rel=0.01)
    assert 2 * fwd < vit.image_train_flops(cfg) < 2.05 * fwd


def pose_step_faces():
    body = inputs.body_tensors(inputs.body_model(41, 28), "cpu")
    pose = torch.zeros(1, 24, 3)
    pose[0, 0, 0] = math.pi / 2
    v = smpl.skin(body, pose)[0] @ torch.tensor(cameras.BODY_TO_WORLD).t()
    elevs = torch.randn(5, generator=torch.Generator().manual_seed(0)) * 0.3
    poses = cameras.view_poses(elevs, torch.tensor([120.0, 150.0, 180.0, 210.0, 240.0]))
    f = cameras.focal_from_fov(224, math.radians(60))
    sx, sy, iz, front = raster.project(v[None].expand(5, -1, -1), poses, 224, 224, f)
    coef, valid, scale = raster.face_coefficients(sx, sy, iz, front, body["faces"].long())
    return coef[..., :3].transpose(-1, -2) * scale[..., None], valid


def test_b5_bounds_at_a_pose_step():
    cs, valid = pose_step_faces()
    assert cs.shape[1] == 13776
    live = soft.live_pairs(cs, valid, 224, 224, 0.5)
    fwd, bwd = soft.pair_bounds(live, 5, 13824, 224 * 224, 5 * 49 * 27, 1.98e9)
    assert round(fwd["bound_ms"], 3) == 0.553 and fwd["bound_resource"] == "special functions"
    assert round(bwd["bound_ms"], 3) == 0.862 and bwd["bound_resource"] == "operations"


def test_live_pairs_match_the_pairs_evaluated_one_by_one():
    cs, valid = pose_step_faces()
    cs, valid = cs[:2, ::37], valid[:2, ::37]
    H = W = 224
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32), torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    px, py = px.reshape(1, -1, 1), py.reshape(1, -1, 1)
    d = torch.stack([(px * cs[:, None, :, e, 0] + py * cs[:, None, :, e, 1]) + cs[:, None, :, e, 2]
                     for e in range(3)], -1).amin(-1)
    brute = float(((d * 2.0 > soft.X_DEAD) & valid[:, None]).sum())
    assert soft.live_pairs(cs, valid, H, W, 0.5) == pytest.approx(brute, rel=1e-5)
