"""Parity of the port's hard rasterizer with the JAX package's Pallas z-buffer
in interpret mode (the kernel's exact-f32 semantics, not the CPU scan):
face ids equal except near-ties (|d iz| <= 1e-6 |iz|); render_mesh face ids
exactly and shading / depth to 1e-3; the 1e-3 px^2 sliver gate."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu.ops import raster_zbuffer as jrz
from avatarclip_tpu.render import cameras as jcam
from avatarclip_tpu.render import raster as jraster
from avatarclip_torch.ops import raster_zbuffer as trz
from avatarclip_torch.render import raster as traster

NEAR_TIE = 1e-6


def _soup(seed, V=300, F=700):
    g = np.random.default_rng(seed)
    v = g.normal(0.0, 0.4, (V, 3)).astype(np.float32)
    v[:10, 2] += 3.0  # some vertices behind the camera
    return v, g.integers(0, V, (F, 3)).astype(np.int32)


def _pose(eye=(0.1, -0.2, 1.5)):
    return jcam._lookat_np(np.array(eye, np.float32), np.zeros(3, np.float32),
                           np.array([0.0, 1.0, 0.0], np.float32))


def _assert_same_winners(got, want, coef, W):
    got, want = np.asarray(got), np.asarray(want)
    diff = np.nonzero(got != want)[0]
    if diff.size:
        assert (got[diff] >= 0).all() and (want[diff] >= 0).all(), "coverage differs"
        px, py = (diff % W).astype(np.float32), (diff // W).astype(np.float32)
        c = np.asarray(coef)
        iz = [px * c[f, 0, 3] + py * c[f, 1, 3] + c[f, 2, 3] for f in (got[diff], want[diff])]
        assert (np.abs(iz[0] - iz[1]) <= NEAR_TIE * np.abs(iz[1])).all()
    return diff.size


@pytest.mark.parametrize("H,W", [(50, 70), (64, 64)])
def test_plain_zbuffer_matches_pallas_interpret(H, W):
    v, f = _soup(H * W)
    proj = jraster.project_vertices(jnp.asarray(v), jnp.asarray(_pose()), H, W, 60.0)
    coef, valid, _ = jraster._face_coefficients(proj, jnp.asarray(f))
    want = jrz.zbuffer_select_tiled(coef, valid, proj.sx[f], proj.sy[f], H, W, interpret=True)
    tproj = traster.project_vertices(torch.from_numpy(v), torch.from_numpy(_pose()), H, W, 60.0)
    tf = torch.from_numpy(f).long()
    tcoef, tvalid, _ = traster._face_coefficients(tproj, tf)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    got = trz.zbuffer_select_tiled(tcoef, tvalid, tproj.sx[tf], tproj.sy[tf], H, W)
    assert (np.asarray(want) >= 0).sum() > 500
    assert _assert_same_winners(got.numpy(), want, coef, W) <= 5


def test_overlap_table_matches_jax():
    H, W = 50, 70
    v, f = _soup(1)
    proj = jraster.project_vertices(jnp.asarray(v), jnp.asarray(_pose()), H, W, 60.0)
    _, valid, _ = jraster._face_coefficients(proj, jnp.asarray(f))
    jt, jn, jb = jrz.overlap_table(valid, proj.sx[f], proj.sy[f], H, W)
    tt, tn, tb = trz.overlap_table(torch.from_numpy(np.asarray(valid)),
                                   torch.from_numpy(np.asarray(proj.sx[f])),
                                   torch.from_numpy(np.asarray(proj.sy[f])), H, W)
    assert (jn, jb) == (tn, tb)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_render_mesh_matches_jax_kernel_semantics():
    from avatarclip_tpu import assets as jassets

    model = jassets.load_smpl()
    v = np.asarray(model.v_template) @ jcam.BODY_TO_WORLD.T
    f = np.asarray(model.faces, np.int32)
    pose = _pose((0.4, 0.3, 1.8))
    H = W = 64
    focal = jcam.focal_from_fov(W, np.deg2rad(60.0))
    jn = jraster.vertex_normals(jnp.asarray(v), jnp.asarray(f))
    want = jraster.render_mesh(jnp.asarray(v), jnp.asarray(f), jnp.asarray(pose), H, W, focal,
                               normals=jn, use_kernel=True, interpret=True)
    tv, tf = torch.from_numpy(v), torch.from_numpy(f).long()
    tn = traster.vertex_normals(tv, tf)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    got = traster.render_mesh(tv, tf, torch.from_numpy(pose), H, W, focal, face_normals=tn[tf])
    assert np.asarray(want["mask"]).sum() > 100
    np.testing.assert_array_equal(got["face_id"].numpy(), np.asarray(want["face_id"]))
    # the winner's barycentrics are recomputed in another summation order
    # (JAX: an einsum; here (px * c0 + py * c1) + c2), which on a thin face
    # (coefficients ~1e3) moves the shading by up to a few 1e-4
    for k in ("rgb", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-3, rtol=1e-4)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))


def test_gated_sliver_adds_no_coverage():
    verts = torch.tensor([[-0.5, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 1e-7, 0.0],
                          [0.0, 0.3, 0.0], [0.06, 0.3, 0.0], [0.03, 0.36, 0.0]])
    faces = torch.tensor([[0, 1, 2], [3, 4, 5]])
    pose = torch.from_numpy(_pose((0.0, 0.0, 2.2)))
    H = W = 256
    focal = jcam.focal_from_fov(W, np.deg2rad(60.0))
    proj = traster.project_vertices(verts, pose, H, W, focal)
    _, valid, _ = traster._face_coefficients(proj, faces)
    assert valid.tolist() == [False, True]
    fid = traster.render_mesh(verts, faces, pose, H, W, focal)["face_id"].numpy()
    assert not (fid == 0).any() and (fid == 1).sum() > 0


@pytest.mark.parametrize("shading", ["vertex_colors", "uv_texture"])
def test_render_mesh_options_match_jax(shading):
    """The hard render's colour options (per-vertex colours; per-corner uv
    with a bilinearly sampled texture), with AvatarAnimate's picture light
    and white background, against the JAX kernel semantics."""
    from avatarclip_tpu import assets as jassets

    model = jassets.load_smpl()
    v = np.asarray(model.v_template) @ jcam.BODY_TO_WORLD.T
    f = np.asarray(model.faces, np.int32)
    g = np.random.default_rng(5)
    pose = _pose((0.3, 0.4, 1.9))
    H = W = 64
    focal = jcam.focal_from_fov(W, np.deg2rad(50.0))
    light = np.array([0.4, 0.8, 0.6], np.float32)
    if shading == "vertex_colors":
        kw = {"vertex_colors": g.uniform(0.1, 0.9, (v.shape[0], 3)).astype(np.float32)}
    else:
        kw = {"face_uvs": g.uniform(0.0, 1.0, (f.shape[0], 3, 2)).astype(np.float32),
              "texture": g.uniform(0.0, 1.0, (16, 24, 3)).astype(np.float32)}
    want = jraster.render_mesh(jnp.asarray(v), jnp.asarray(f), jnp.asarray(pose), H, W, focal,
                               light_dir=jnp.asarray(light), background=1.0, use_kernel=True,
                               interpret=True, **{k: jnp.asarray(a) for k, a in kw.items()})
    got = traster.render_mesh(torch.from_numpy(v), torch.from_numpy(f).long(), torch.from_numpy(pose),
                              H, W, focal, light_dir=light, background=1.0,
                              **{k: torch.from_numpy(a) for k, a in kw.items()})
    np.testing.assert_array_equal(got["face_id"].numpy(), np.asarray(want["face_id"]))
    assert (np.asarray(want["rgb"]) < 1.0).any(axis=-1).mean() > 0.05  # the body is in view
    # as test_render_mesh_matches_jax_kernel_semantics: the winner's
    # barycentrics are recomputed in another summation order
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), atol=1e-3, rtol=1e-4)
