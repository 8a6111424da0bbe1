"""B2's culling (csrc/raster_zbuffer.cu's binned kernel) through its Python
twin ``raster_zbuffer.tile_faces`` on the CPU: the faces each 16 x 16 screen
tile evaluates, on a ragged 50 x 70 triangle soup, on slivers (edges far
longer than the faces are thick) and on a 96^2 view of the procedural
humanoid.

* sound: every (pixel, face) pair that passes the kernel's inside test (the
  three edge values >= 0, iz > 0, a valid face) has the face in the list of
  the pixel's tile, and in the pixel's own list at tile 1 (what the
  kernel's culling of a warp's 8 x 4 pixels rests on);
* exact: the plain evaluation over each tile's list, in the list's order,
  equals ``zbuffer_select_plain`` bit for bit, and agrees with the JAX
  package's ``zbuffer_select_tiled(..., interpret=True)`` but at near-ties
  (|d iz| <= 1e-6 |iz|, test_torch_raster.py's rule);
* finer than the JAX table: the (tile, face) pairs kept hold at least 5x
  fewer (pixel, face) tests than the table's kept (tile, face-block) pairs;
* the grid: B2's tiles fill the H100's 132 SMs at 224^2 and 256^2.
Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarclip_tpu.ops import raster_zbuffer as jrz
from avatarclip_tpu.render import raster as jraster
from avatarclip_torch.ops import raster_zbuffer as trz
from avatarclip_torch.pipelines import synthetic
from avatarclip_torch.render import cameras, raster

NEAR_TIE = 1e-6
H100_SMS = 132


def _lookat(eye):
    return cameras.lookat_np(np.array(eye, np.float32), np.zeros(3, np.float32),
                             np.array([0.0, 1.0, 0.0], np.float32))


def _soup():
    """700 random faces over 300 vertices, some behind the camera, 50 x 70."""
    g = np.random.default_rng(5)
    v = g.normal(0.0, 0.4, (300, 3)).astype(np.float32)
    v[:10, 2] += 3.0
    return v, g.integers(0, 300, (700, 3)).astype(np.int32), _lookat((0.1, -0.2, 1.5)), 50, 70, 60.0


def _slivers():
    """1,500 thin triangles (5-30 px edges, 1e-4 to 0.4 px thick), some
    below the 1e-3 px^2 area gate, on a 64 x 80 screen."""
    g = np.random.default_rng(6)
    n = 1500
    a = g.uniform(-0.7, 0.7, (n, 3)).astype(np.float32) * np.array([1.0, 0.8, 0.2], np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32) * np.array([1.0, 1.0, 0.1], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    length = g.uniform(0.1, 0.8, (n, 1)).astype(np.float32)
    b = a + length * d
    perp = np.stack([-d[:, 1], d[:, 0], np.zeros(n, np.float32)], 1)
    thick = (10.0 ** g.uniform(-5.5, -2.0, (n, 1))).astype(np.float32)
    c = a + g.uniform(0.0, 1.0, (n, 1)).astype(np.float32) * (b - a) + thick * perp
    v = np.stack([a, b, c], 1).reshape(-1, 3)
    return v, np.arange(3 * n, dtype=np.int32).reshape(n, 3), _lookat((0.0, 0.0, 2.0)), 64, 80, 80.0


def _humanoid():
    """The procedural body at 2,448 faces, one 96^2 view."""
    v, f, poses, focal = synthetic.humanoid_views("cpu", n_views=1, res=96, n_seg=17, n_ring=12)
    return v[0].numpy(), f.numpy().astype(np.int32), poses[0].numpy(), 96, 96, float(focal)


SCENES = {"soup 50x70": _soup, "slivers 64x80": _slivers, "humanoid 96^2": _humanoid}


def _torch_inputs(scene):
    v, f, pose, H, W, focal = SCENES[scene]()
    proj = raster.project_vertices(torch.from_numpy(v), torch.from_numpy(pose), H, W, focal)
    tf = torch.from_numpy(f).long()
    coef, valid, _ = raster._face_coefficients(proj, tf)
    return coef, valid, proj.sx[tf], proj.sy[tf], H, W


def _pixels(H, W):
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32), torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def _tile_of(H, W, tile=trz.BIN):
    px, py = _pixels(H, W)
    n_tx = -(-W // tile)
    return (py.long() // tile) * n_tx + px.long() // tile


def _inside(coef, valid, px, py):
    """(P, F): the kernel's test, in its evaluation order."""
    b = [trz.lin3(px[:, None], py[:, None], coef[None, :, 0, k], coef[None, :, 1, k], coef[None, :, 2, k])
         for k in range(4)]
    return (b[0] >= 0) & (b[1] >= 0) & (b[2] >= 0) & (b[3] > 0) & valid[None], b[3]


@pytest.mark.parametrize("tile", [trz.BIN, 1])
@pytest.mark.parametrize("scene", list(SCENES))
def test_tile_faces_is_sound(scene, tile):
    """At B2's tiles, and per pixel (tile 1: the test the kernel's 8 x 4
    warp culling rests on)."""
    coef, valid, sx, sy, H, W = _torch_inputs(scene)
    lists = trz.tile_faces(valid, sx, sy, H, W, tile)
    assert len(lists) == -(-H // tile) * -(-W // tile)
    kept = torch.zeros(len(lists), coef.shape[0], dtype=torch.bool)
    for t, ids in enumerate(lists):
        assert torch.equal(ids, torch.sort(ids).values) and bool(valid[ids].all())
        kept[t, ids] = True
    px, py = _pixels(H, W)
    inside, _ = _inside(coef, valid, px, py)
    assert int(inside.any(1).sum()) > 300  # the scene covers pixels
    missed = inside & ~kept[_tile_of(H, W, tile)]
    assert not bool(missed.any()), f"{int(missed.sum())} inside (pixel, face) pairs culled"


def _winners_over_lists(coef, lists, H, W):
    """The plain evaluation over each tile's kept faces: the highest iz among
    the inside faces, ties to the higher id (the kernel's increasing order
    with >=)."""
    px, py = _pixels(H, W)
    tile = _tile_of(H, W)
    best = torch.full((H * W,), -1, dtype=torch.int32)
    valid = torch.ones(coef.shape[0], dtype=torch.bool)  # the lists hold valid faces only
    for t, ids in enumerate(lists):
        pix = (tile == t).nonzero().flatten()
        if not ids.numel() or not pix.numel():
            continue
        inside, iz = _inside(coef[ids], valid[ids], px[pix], py[pix])
        iz_in = torch.where(inside, iz, torch.full_like(iz, -1.0))
        top = iz_in.max(1).values
        cand = torch.where((iz_in == top[:, None]) & inside, ids[None].to(torch.int32), -1).max(1).values
        best[pix] = cand
    return best


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


@pytest.mark.parametrize("scene", list(SCENES))
def test_kept_faces_give_the_plain_and_the_jax_winners(scene):
    coef, valid, sx, sy, H, W = _torch_inputs(scene)
    got = _winners_over_lists(coef, trz.tile_faces(valid, sx, sy, H, W), H, W)
    want = trz.zbuffer_select_plain(coef, valid, H, W)
    assert int((want >= 0).sum()) > 300
    assert torch.equal(got, want)
    v, f, pose, _, _, focal = SCENES[scene]()
    jproj = jraster.project_vertices(jnp.asarray(v), jnp.asarray(pose), H, W, focal)
    jcoef, jvalid, _ = jraster._face_coefficients(jproj, jnp.asarray(f))
    np.testing.assert_array_equal(np.asarray(jvalid), valid.numpy())
    jwant = jrz.zbuffer_select_tiled(jcoef, jvalid, jproj.sx[f], jproj.sy[f], H, W, interpret=True)
    assert _assert_same_winners(got.numpy(), jwant, jcoef, W) <= 5


def test_per_face_culling_keeps_fewer_pairs_than_the_table():
    """On the humanoid, the pixel-face tests B2 makes (each kept (tile, face)
    pair: BIN^2 pixels) are at least 5x fewer than those of the JAX table's
    kept (32^2 tile, 512-face block) pairs."""
    coef, valid, sx, sy, H, W = _torch_inputs("humanoid 96^2")
    binned = sum(len(ids) for ids in trz.tile_faces(valid, sx, sy, H, W)) * trz.BIN ** 2
    tab, _, _ = trz.overlap_table(valid, sx, sy, H, W)
    table = int(tab.sum()) * trz.TILE_H * trz.TILE_W * trz.FBLOCK_T
    assert binned * 5 < table, (binned, table)


@pytest.mark.parametrize("res", [224, 256, 512])
def test_bins_fill_the_card(res):
    n_ty, n_tx = trz.bin_grid(res, res)
    assert n_ty * n_tx >= H100_SMS
    assert (n_ty * trz.BIN, n_tx * trz.BIN) == (-(-res // 16) * 16,) * 2
