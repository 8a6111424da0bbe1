"""The plain reference against the program on the CPU, at tiny sizes: each
piece against the program's plain twin, and both cells' entries end to end
(the checked steps of each driver in float32, where the two agree to
rounding)."""

import math

import numpy as np
import pytest
import torch

from benchmark.harness import inputs
from benchmark.reference import cameras, clip, raster, smpl
from benchmark.tests import tiny


@pytest.mark.parametrize("driver,seed", [("train_clip", 2**31 + 77), ("pose_adam", 3 * 10**9 + 11)])
def test_cell_entry_matches_the_reference_in_float32(driver, seed):
    d, _ = tiny.run_driver(driver, seed)
    r = d.readings()
    assert r["loss_gap"] < 1e-5, r
    assert r["grad_gap"] < 1e-5, r
    assert r["change_gap"] < 1e-4, r


def test_cell_entry_at_bf16_operands_stays_near_the_reference():
    cfg, wl = tiny.sculpt("bfloat16")
    d, _ = tiny.run_driver("train_clip", 5, cfg=cfg, wl=wl)
    r = d.readings()
    assert 1e-6 < r["loss_gap"] < 0.05, r


def _body():
    body = inputs.body_tensors(inputs.body_model(6, 8), "cpu")
    pose = torch.zeros(1, 24, 3)
    pose[0, 0, 0] = math.pi / 2
    pose[0, 5] = torch.tensor([0.3, -0.2, 0.1])
    return body, pose


def test_smpl_skinning_matches_the_program():
    from avatarclip_torch.body import smpl as prog

    body, pose = _body()
    m = prog.SMPLModel(body["v_template"], body["shapedirs"], body["posedirs"], body["J_regressor"],
                       body["weights"], body["parents"], body["faces"].numpy())
    want, _ = m.forward(body_pose=pose[:, 1:], global_orient=pose[:, 0])
    torch.testing.assert_close(smpl.skin(body, pose), want, rtol=1e-5, atol=1e-6)


def test_zbuffer_and_shading_match_the_program():
    from avatarclip_torch.render import raster as prog

    body, pose = _body()
    v = smpl.skin(body, pose)[0] @ torch.tensor(cameras.BODY_TO_WORLD).t()
    f = body["faces"].long()
    cam = torch.tensor(cameras.training_camera(3, 1, True, 0.65)["pose"])
    n = raster.vertex_normals(v, f)
    rgb, hit = raster.render_hard(v, f, cam, 48, 48, 40.0, n)
    want = prog.render_mesh(v, f, cam, 48, 48, 40.0, normals=n)
    assert torch.equal(hit, want["mask"])
    torch.testing.assert_close(rgb, want["rgb"], rtol=1e-5, atol=1e-6)


def test_soft_render_matches_the_program():
    from avatarclip_torch.render import raster as prog

    body, pose = _body()
    v = smpl.skin(body, pose)[0] @ torch.tensor(cameras.BODY_TO_WORLD).t()
    poses = cameras.view_poses(torch.tensor([0.1, -0.2]), torch.tensor([150.0, 200.0]))
    got = raster.soft_render(v[None].expand(2, -1, -1), body["faces"].long(), poses, 24, 24, 20.0, 0.5)
    want = prog.soft_render_mesh(v[None].expand(2, -1, -1), body["faces"], poses, 24, 24, 20.0, sigma=0.5)
    torch.testing.assert_close(got, want["rgb"], rtol=1e-5, atol=1e-6)


def test_ray_budget_matches_the_program():
    from avatarclip_torch.render import cameras as prog

    g = torch.Generator().manual_seed(0)
    mask = torch.rand(40, 40, generator=g) > 0.8
    dil = raster.dilate(mask, 2)
    want, dil_p, _ = prog.select_silhouette_rays(mask, 500, 2, 1234)
    assert torch.equal(dil, dil_p)
    assert torch.equal(cameras.select_rays(dil, 500, 1234), want)


def test_camera_stream_and_rays_match_the_program():
    from avatarclip_torch.render import cameras as prog

    for it in range(6):
        want = prog.sample_training_camera(np.random.default_rng([99, it]), it % 4 == 0, 0.65)
        got = cameras.training_camera(99, it, True, 0.65)
        np.testing.assert_array_equal(got["pose"], want["pose"])
        assert got["face"] == want["face_iter"] and got["is_front"] == int(want["is_front"])
    pose = torch.tensor(want["pose"])
    o, d = cameras.grid_rays(pose, 20, 20, 200.0, 256)
    po, pd = prog.pixel_grid_rays(pose, 20, 20, 200.0, 256, 256)
    torch.testing.assert_close(d, pd.reshape(-1, 3), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(o, po.reshape(-1, 3))


def test_clip_towers_and_resize_match_the_program():
    from avatarclip_torch.clip import model as prog

    cfg = tiny.pose()[0]["clip"]
    params = inputs.clip_weights(cfg, torch.Generator().manual_seed(1), "cpu")
    pcfg = prog.CLIPConfig(**{k: cfg[k] for k in ("image_size", "patch_size", "vision_width", "vision_layers",
                                                  "vision_heads", "embed_dim", "context_length", "vocab_size",
                                                  "text_width", "text_layers", "text_heads")})
    img = torch.rand(2, 50, 50, 3, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(clip.resize(img, 64), prog.resize_image(img, 64, 64), rtol=1e-5, atol=1e-6)
    x = clip.normalize(clip.resize(img, 64))
    torch.testing.assert_close(clip.encode_image(params, x, cfg), prog.encode_image(params, pcfg, x),
                               rtol=1e-4, atol=1e-5)
    toks = inputs.tokens(["a rendered 3d man is arguing", "a test"], "cpu")
    torch.testing.assert_close(clip.encode_text(params, toks, cfg), prog.encode_text(params, pcfg, toks),
                               rtol=1e-4, atol=1e-5)
