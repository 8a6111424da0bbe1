"""Parity of the port's soft rasterizer (ops/fused_soft.py, render/raster.py's
soft path) with the JAX package on the CPU, where the port runs the kernel
pair's plain version:

* ``soft_aggregate`` against the Pallas kernel pair in interpret mode:
  rgb and silhouette to 2e-5, and the VJP w.r.t. coef, edge_inv_len,
  iz_face and colors_face to 1e-4 of each gradient's largest magnitude (the
  tile sort and the face chunks change the f32 summation order);
* the culling table, entry for entry, after the same padding and tile sort;
* ``soft_render_mesh`` against the JAX CPU path (the checkpointed scan):
  rgb and silhouette to 2e-5, the vertex gradient to 1e-3 relative norm,
  the JAX side under x64 where its f32 VJP loses the depth-softmax
  denominator's gradient to underflow;
* a gated sliver (below 1e-3 px^2 of doubled area) adds no coverage and
  no NaN gradient; padding faces give exact zeros;
* a batch of views equals the views one at a time.
Inputs are made with numpy from a seed."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu.ops import fused_soft as jfs
from avatarclip_tpu.render import cameras as jcam
from avatarclip_tpu.render import raster as jraster
from avatarclip_torch.ops import fused_soft as tfs
from avatarclip_torch.render import raster as traster


def _scene(n_faces, seed, compact=False):
    """Triangle soup in front of the camera: random small faces with 5%
    slivers and 5 degenerate faces, or (``compact``) equilateral faces
    packed near the centre, on which the culling table skips pairs."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-0.35 if compact else -0.6, 0.35 if compact else 0.6, (n_faces, 3)).astype(np.float32)
    c[:, 2] *= 0.3
    if compact:
        a = np.array([0.0, 2 * np.pi / 3, 4 * np.pi / 3], np.float32)
        offs = np.broadcast_to(0.05 * np.stack([np.cos(a), np.sin(a), np.zeros(3)], -1),
                               (n_faces, 3, 3)).astype(np.float32)
    else:
        offs = rng.uniform(-0.08, 0.08, (n_faces, 3, 3)).astype(np.float32)
        k = n_faces // 20
        offs[:k, :, 0] *= 40.0
        offs[:k, :, 1] *= 0.02
        offs[k:k + 5] = 0.0
    verts = (c[:, None, :] + offs).reshape(-1, 3)
    return verts, np.arange(n_faces * 3, dtype=np.int32).reshape(n_faces, 3)


def _pose(eye=(0.0, 0.0, 2.0)):
    return jcam._lookat_np(np.array(eye, np.float32), np.zeros(3, np.float32),
                           np.array([0.0, 1.0, 0.0], np.float32))


def _face_inputs(verts, faces, H, W, seed):
    """The JAX package's per-face inputs of one view, as numpy, plus seeded
    colours and the corners' screen coordinates."""
    focal = jcam.focal_from_fov(W, np.deg2rad(60.0))
    proj = jraster.project_vertices(jnp.asarray(verts), jnp.asarray(_pose()), H, W, focal)
    coef, valid, eil = jraster._face_coefficients(proj, jnp.asarray(faces))
    rng = np.random.RandomState(seed)
    return {
        "coef": np.array(coef), "valid": np.array(valid), "edge_inv_len": np.array(eil),
        "iz_face": np.asarray(proj.inv_z)[faces].mean(1).astype(np.float32),
        "colors_face": rng.uniform(0.1, 0.9, (faces.shape[0], 3)).astype(np.float32),
        "face_sx": np.asarray(proj.sx)[faces], "face_sy": np.asarray(proj.sy)[faces],
    }


DIFF = ("coef", "edge_inv_len", "iz_face", "colors_face")


@pytest.mark.parametrize("H,W,n_faces", [(64, 64, 600), (50, 70, 137)])
def test_soft_aggregate_matches_pallas_interpret(H, W, n_faces):
    """Forward through the render's post-transform; the VJP at the
    aggregation's own outputs (sil_prod, num, den), with the cotangents an
    rgb / silhouette loss gives them, computed once in f64 and handed to
    both. (Through the division rgb = num / (den + 1) JAX's f32 VJP forms
    den**-2, which underflows at the saturated depth weights, den ~ 1e26:
    see test_soft_render_mesh_matches_jax_cpu_path.)"""
    sigma, gamma = 0.5, 0.005
    x = _face_inputs(*_scene(n_faces, seed=n_faces), H, W, seed=1)
    rng = np.random.RandomState(2)
    w_rgb = rng.randn(H * W, 3)
    w_sil = rng.randn(H * W)

    def jfn(coef, eil, iz, col):
        return jfs.soft_aggregate(coef, jnp.asarray(x["valid"]), eil, iz, col, H, W, sigma, gamma,
                                  face_sx=jnp.asarray(x["face_sx"]), face_sy=jnp.asarray(x["face_sy"]),
                                  interpret=True)

    j_out, vjp = jax.vjp(jfn, *[jnp.asarray(x[k]) for k in DIFF])
    sil_prod, num, den = (np.asarray(o, np.float64) for o in j_out)
    inv = 1.0 / (den + 1.0)
    rgb = num * inv[:, None]
    cots = (-w_sil, w_rgb * inv[:, None], -(w_rgb * rgb).sum(1) * inv)
    j_g = vjp(tuple(jnp.asarray(c, jnp.float32) for c in cots))

    ts = {k: torch.from_numpy(x[k]).requires_grad_(True) for k in DIFF}
    t_out = tfs.soft_aggregate(ts["coef"][None], torch.from_numpy(x["valid"])[None],
                               ts["edge_inv_len"][None], ts["iz_face"][None], ts["colors_face"][None],
                               H, W, sigma, gamma, torch.from_numpy(x["face_sx"])[None],
                               torch.from_numpy(x["face_sy"])[None])
    t_out = [o[0] for o in t_out]  # the one view
    sum((o * torch.from_numpy(c).float()).sum() for o, c in zip(t_out, cots)).backward()

    t_sil, t_num, t_den = (o.detach().numpy() for o in t_out)
    assert (1.0 - sil_prod).mean() > 0.05  # something rendered
    np.testing.assert_allclose(1.0 - t_sil, 1.0 - sil_prod, atol=2e-5)
    np.testing.assert_allclose(t_num / (t_den[:, None] + 1.0), rgb, atol=2e-5)
    for k, jg in zip(DIFF, j_g):
        jg = np.asarray(jg)
        tg = ts[k].grad.numpy()
        assert np.isfinite(tg).all(), k
        assert np.abs(tg - jg).max() <= 1e-4 * max(np.abs(jg).max(), 1e-30), k


def _jax_table(x, H, W, sigma):
    """The JAX package's padding, stable tile sort and scale folding
    (soft_aggregate), then its half-plane culling table."""
    F = x["coef"].shape[0]
    f_pad = (-F) % jfs.FBLOCK
    coef = np.concatenate([x["coef"], np.zeros((f_pad, 3, 4), np.float32)])
    valid = np.concatenate([x["valid"], np.zeros(f_pad, bool)])
    eil = np.concatenate([x["edge_inv_len"], np.zeros((f_pad, 3), np.float32)])
    Hp, Wp = -(-H // jfs.TILE_H) * jfs.TILE_H, -(-W // jfs.TILE_W) * jfs.TILE_W
    cx = jnp.concatenate([jnp.clip(jnp.mean(x["face_sx"], 1), 0.0, Wp - 1.0), jnp.full(f_pad, jnp.inf)])
    cy = jnp.concatenate([jnp.clip(jnp.mean(x["face_sy"], 1), 0.0, Hp - 1.0), jnp.full(f_pad, jnp.inf)])
    key = jnp.where(valid, (cy // jfs.TILE_H) * (Wp // jfs.TILE_W) + (cx // jfs.TILE_W), 1e9)
    order = np.asarray(jnp.argsort(key))
    ct = jnp.asarray(coef[order]).transpose(1, 2, 0)
    cs = [ct[:, e] * jnp.asarray(eil[order][:, e])[None, :] for e in range(3)]
    tab, n_tiles, n_fb = jfs._overlap_table_halfplane(
        jnp.asarray(valid[order]), *cs, H, W, margin=jfs._MARGIN_LOGITS * sigma)
    return np.asarray(tab).reshape(n_tiles, n_fb), np.stack([np.asarray(c) for c in cs])


@pytest.mark.parametrize("H,W,sigma,n_faces,compact", [
    (160, 160, 0.15, 1500, False), (320, 320, 0.1, 1500, True), (50, 70, 0.5, 137, False)])
def test_culling_table_matches_jax(H, W, sigma, n_faces, compact):
    x = _face_inputs(*_scene(n_faces, seed=3, compact=compact), H, W, seed=4)
    want, j_cs = _jax_table(x, H, W, sigma)
    t = {k: torch.from_numpy(v)[None] for k, v in x.items()}
    faces, tab = tfs.prepare(t["coef"], t["valid"], t["edge_inv_len"], t["iz_face"],
                             t["colors_face"], H, W, sigma, 0.005, t["face_sx"], t["face_sy"])
    np.testing.assert_array_equal(tab[0].numpy(), want)
    # the same faces in the same order: cs_e[c, f] of JAX is row f, column 3e + c
    np.testing.assert_array_equal(faces[0, :, :9].reshape(-1, 3, 3).permute(1, 2, 0).numpy(), j_cs)
    if compact:
        assert want.mean() < 0.9  # the table skips pairs here


def _render_pair(verts, faces, H, W, sigma):
    pose = _pose()
    focal = jcam.focal_from_fov(W, np.deg2rad(60.0))
    rng = np.random.RandomState(5)
    w_rgb = rng.randn(H, W, 3).astype(np.float32)
    w_sil = rng.randn(H, W).astype(np.float32)

    def jloss(v):
        out = jraster.soft_render_mesh(v, faces, jnp.asarray(pose), H, W, focal, sigma=sigma, chunk=512,
                                       use_kernel=False)
        return jnp.sum(out["rgb"] * w_rgb) + jnp.sum(out["silhouette"] * w_sil), out

    _, j_out = jloss(jnp.asarray(verts))
    with jax.enable_x64(True):
        # JAX's VJP of a / b forms b**-2: in f32 it underflows to 0 at the
        # saturated depth weights (den ~ e^60 per face), dropping the depth
        # softmax denominator's gradient. Under x64 the JAX package's own
        # weakly typed constants carry the soft core into f64.
        (_, _), j_g = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(verts))
    tv = torch.from_numpy(verts).requires_grad_(True)
    t_out = traster.soft_render_mesh(tv, torch.from_numpy(faces), torch.from_numpy(pose), H, W, focal,
                                     sigma=sigma)
    ((t_out["rgb"] * torch.from_numpy(w_rgb)).sum()
     + (t_out["silhouette"] * torch.from_numpy(w_sil)).sum()).backward()
    return j_out, np.asarray(j_g), t_out, tv.grad.numpy()


def test_soft_render_mesh_matches_jax_cpu_path():
    verts, faces = _scene(400, seed=6)
    j_out, j_g, t_out, t_g = _render_pair(verts, faces, 48, 56, 0.5)
    for k in ("rgb", "silhouette"):
        np.testing.assert_allclose(t_out[k].detach().numpy(), np.asarray(j_out[k]), atol=2e-5)
    assert np.isfinite(t_g).all()
    assert np.linalg.norm(t_g - j_g) <= 1e-3 * np.linalg.norm(j_g)


def test_gated_sliver_adds_no_coverage_and_no_nan():
    """A face of doubled screen area below 1e-3 px^2 is invalid in the soft
    path too: with only it (and the padding faces) in view, the silhouette
    is 0 and rgb the background everywhere, and every gradient is 0 and
    finite; beside a real face it changes nothing."""
    verts = torch.tensor([[-0.5, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 1e-7, 0.0],
                          [0.0, 0.3, 0.0], [0.06, 0.3, 0.0], [0.03, 0.36, 0.0]])
    pose = torch.from_numpy(_pose((0.0, 0.0, 2.2)))
    H = W = 64
    focal = jcam.focal_from_fov(W, np.deg2rad(60.0))
    v = verts.clone().requires_grad_(True)
    out = traster.soft_render_mesh(v, torch.tensor([[0, 1, 2]]), pose, H, W, focal, sigma=0.5,
                                   background=0.25)
    (out["rgb"].sum() + out["silhouette"].sum()).backward()
    assert float(out["silhouette"].detach().abs().max()) == 0.0
    assert torch.equal(out["rgb"], torch.full((H, W, 3), 0.25))
    assert torch.isfinite(v.grad).all() and float(v.grad.abs().max()) == 0.0
    both = traster.soft_render_mesh(verts, torch.tensor([[0, 1, 2], [3, 4, 5]]), pose, H, W, focal, sigma=0.5)
    real = traster.soft_render_mesh(verts, torch.tensor([[3, 4, 5]]), pose, H, W, focal, sigma=0.5)
    assert float(real["silhouette"].max()) > 0.5
    for k in ("rgb", "silhouette"):
        torch.testing.assert_close(both[k], real[k], atol=1e-7, rtol=0)


def test_batched_views_equal_single_views():
    """One soft render of a batch of views (the optimizers' step) equals
    the views rendered one at a time, values and vertex gradients."""
    verts, faces = _scene(200, seed=7)
    H, W = 40, 48
    focal = jcam.focal_from_fov(W, np.deg2rad(60.0))
    poses = torch.stack([torch.from_numpy(_pose(e)) for e in ((0.0, 0.0, 2.0), (0.4, 0.3, 1.9), (-0.5, 0.1, 1.8))])
    f = torch.from_numpy(faces)
    vb = torch.from_numpy(verts).expand(3, -1, -1).clone().requires_grad_(True)
    out = traster.soft_render_mesh(vb, f, poses, H, W, focal, sigma=0.5)
    out["rgb"].square().sum().backward()
    for i in range(3):
        v = torch.from_numpy(verts).requires_grad_(True)
        one = traster.soft_render_mesh(v, f, poses[i], H, W, focal, sigma=0.5)
        one["rgb"].square().sum().backward()
        torch.testing.assert_close(out["rgb"][i], one["rgb"], atol=1e-6, rtol=0)
        torch.testing.assert_close(out["silhouette"][i], one["silhouette"], atol=1e-6, rtol=0)
        torch.testing.assert_close(vb.grad[i], v.grad, atol=1e-5 * float(v.grad.abs().max()), rtol=0)


def test_plain_backward_memory_is_chunk_bounded():
    """The plain version keeps O(B x P x chunk) residuals for its backward,
    not O(B x P x F): every chunk is checkpointed (at the pose step's shapes
    the unchunked graph would hold tens of GB)."""
    g = torch.Generator().manual_seed(0)
    B, Fp, H, W = 2, 4 * tfs.PLAIN_CHUNK, 24, 20
    faces = torch.randn(B, Fp, tfs.NF, generator=g)
    faces[..., 13] = 1.0  # all valid
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    x = faces.clone().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        sil, num, den = tfs.aggregate_plain(x, H, W, 2.0)
    (sil.sum() + num.sum() + den.sum()).backward()
    one_chunk = B * H * W * tfs.PLAIN_CHUNK
    assert max(saved) < one_chunk and sum(saved) < 2 * one_chunk, (max(saved), sum(saved))
    assert torch.isfinite(x.grad).all()

