"""The soft aggregation kernels' culling (csrc/fused_soft.cu), through its
Python twin ``fused_soft.patch_keep`` on the CPU: the (8 x 8 pixel patch,
face) pairs the kernels evaluate, on the ragged 50 x 70 scene of two views
and on a small humanoid view pair.

* sound: every pair with x > -104 (where the f32 sigmoid is not exactly 0)
  of a valid face lies in a kept (patch, face) pair, and the twin skips
  pairs (fewer kept than the table's dense blocks);
* exact: the plain aggregation with every pair outside the kept set given
  zero terms equals ``aggregate_plain`` bit for bit, forward outputs and the
  gradient of every face column;
* the work split: the splits the wrappers pick put about as many CTAs on
  the card at the motion step's 2 views as at the pose step's 5.
Inputs are made with numpy from a seed."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avatarclip_torch.ops import fused_soft as tfs
from avatarclip_torch.pipelines import synthetic
from avatarclip_torch.render import cameras, raster


def _prepare(verts, faces, poses, H, W, focal, sigma):
    fi = raster.soft_face_inputs(verts, faces, poses, H, W, focal)
    fp, tab = tfs.prepare(fi["coef"], fi["valid"], fi["edge_inv_len"], fi["iz_face"], fi["colors_face"],
                          H, W, sigma, 0.005, fi["face_sx"], fi["face_sy"])
    return fp.detach().contiguous(), tab


def _ragged():
    """137 random faces (partial tiles, a partial face block) from 2 views."""
    g = np.random.default_rng(2)
    n = 137
    c = g.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    c[:, 2] *= 0.3
    v = torch.from_numpy((c[:, None] + g.uniform(-0.08, 0.08, (n, 3, 3)).astype(np.float32)).reshape(-1, 3))
    f = torch.arange(3 * n).reshape(n, 3)
    poses = torch.stack([torch.from_numpy(cameras.lookat_np(np.array(e, np.float32), np.zeros(3, np.float32),
                                                            np.array([0, 1, 0], np.float32)))
                         for e in ((0.0, 0.0, 2.0), (0.3, -0.2, 1.9))])
    return _prepare(v.expand(2, -1, -1), f, poses, 50, 70, 60.0, 0.5) + (50, 70, 0.5)


def _humanoid():
    """The procedural body at 2,448 faces, 2 views of 96^2 at sigma 0.5."""
    v, f, poses, focal = synthetic.humanoid_views("cpu", n_views=2, res=96, n_seg=17, n_ring=12)
    return _prepare(v, f, poses, 96, 96, focal, 0.5) + (96, 96, 0.5)


SCENES = {"ragged 50x70": _ragged, "humanoid 2x96^2": _humanoid}


def _pixel_keep(keep, H, W):
    """(B, n_py, n_px, Fp) patch pairs -> (B, P, Fp) pixel pairs."""
    px, py = tfs._pixel_coords(H, W, keep.device, torch.float32)
    pix_patch = ((py.long() // tfs.PATCH) * keep.shape[2] + px.long() // tfs.PATCH).reshape(-1)
    return keep.reshape(keep.shape[0], -1, keep.shape[-1])[:, pix_patch]


def _x(faces, H, W, inv_sigma):
    """x of every (pixel, face) pair as the plain version forms it: (B, P, Fp)."""
    px, py = tfs._pixel_coords(H, W, faces.device, faces.dtype)
    v = [(px * faces[:, None, :, 3 * e] + py * faces[:, None, :, 3 * e + 1]) + faces[:, None, :, 3 * e + 2]
         for e in range(3)]
    return torch.stack(v, -1).amin(-1) * inv_sigma


def _aggregate_kept(faces, keep, H, W, inv_sigma):
    """aggregate_plain's chunks and sums, each pair outside ``keep`` (B, P,
    Fp) given vmask 0, so that it adds exact zeros."""
    B, Fp, _ = faces.shape
    px, py = tfs._pixel_coords(H, W, faces.device, faces.dtype)
    sil, num, den = faces.new_zeros(B, H * W), faces.new_zeros(B, H * W, 3), faces.new_zeros(B, H * W)
    live = (faces[..., 13] != 0).any(0).nonzero()
    n_live = int(live.max()) + 1 if live.numel() else 1
    for f0 in range(0, n_live, tfs.PLAIN_CHUNK):
        fc = faces[:, f0:f0 + tfs.PLAIN_CHUNK]
        v = [(px * fc[:, None, :, 3 * e] + py * fc[:, None, :, 3 * e + 1]) + fc[:, None, :, 3 * e + 2]
             for e in range(3)]
        x = torch.stack(v, -1).amin(-1) * inv_sigma
        vmask = fc[:, None, :, 13] * keep[:, :, f0:f0 + tfs.PLAIN_CHUNK].to(fc.dtype)
        w = torch.sigmoid(x) * vmask * fc[:, None, :, 9]
        sil = sil + (-F.softplus(x) * vmask).sum(-1)
        num = num + torch.bmm(w, fc[..., 10:13])
        den = den + w.sum(-1)
    return sil, num, den


@pytest.mark.parametrize("scene", list(SCENES))
def test_patch_culling_keeps_every_live_pair(scene):
    faces, tab, H, W, sigma = SCENES[scene]()
    inv = 1.0 / sigma
    # the premise: at x <= -104 every term of a pair is exactly 0 in f32
    dead = torch.tensor([-104.0, -120.0, -1e4])
    assert torch.equal(torch.sigmoid(dead), torch.zeros(3))
    assert torch.equal(F.softplus(dead), torch.zeros(3))
    keep = tfs.patch_keep(faces, tab, H, W, inv)
    kp = _pixel_keep(keep, H, W)
    live = (_x(faces, H, W, inv) > -tfs._MARGIN_LOGITS) & (faces[:, None, :, 13] != 0)
    assert live.any()
    assert not (live & ~kp).any(), "a live pair outside the evaluated (patch, face) pairs"
    # finer than the table: fewer pairs than its kept (tile, block) pairs hold
    n_ty, n_tx = tfs.grid_dims(H, W)
    tile = ((torch.arange(-(-H // tfs.PATCH)) // 4)[:, None] * n_tx
            + (torch.arange(-(-W // tfs.PATCH)) // 4)[None, :])
    blocks = (tab[:, tile] != 0).repeat_interleave(tfs.FBLOCK, -1) & (faces[:, None, None, :, 13] != 0)
    assert int(keep.sum()) < int(blocks.sum())
    assert not (keep & ~blocks).any()


@pytest.mark.parametrize("scene", list(SCENES))
def test_kept_pairs_aggregate_exactly_as_plain(scene):
    faces, tab, H, W, sigma = SCENES[scene]()
    inv = 1.0 / sigma
    kp = _pixel_keep(tfs.patch_keep(faces, tab, H, W, inv), H, W)
    g = torch.Generator().manual_seed(3)
    cots = [torch.rand(faces.shape[0], H * W, generator=g), torch.rand(faces.shape[0], H * W, 3, generator=g),
            -torch.rand(faces.shape[0], H * W, generator=g)]

    def run(fn):
        x = faces.clone().requires_grad_(True)
        outs = fn(x)
        (gx,) = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cots)), [x])
        return [o.detach() for o in outs], gx

    want, g_want = run(lambda x: tfs.aggregate_plain(x, H, W, inv))
    got, g_got = run(lambda x: _aggregate_kept(x, kp, H, W, inv))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the gradients of the columns the kernels form (the vmask column's is
    # the mask's own: the kernels write 0 there)
    assert torch.equal(g_got[..., :13], g_want[..., :13])
    assert (1.0 - torch.exp(want[0])).mean() > 0.05  # something rendered


@pytest.mark.parametrize("n_views", [2, 5])
def test_splits_fill_the_card_at_2_and_5_views(n_views):
    """At the animate steps' 224^2 x 13,824 padded faces on 132 SMs both
    kernels launch at least CTAS_PER_SM CTAs an SM, and each split still
    has work of its own (a range of at least one 256-face stage or tile)."""
    H = W = 224
    Fp, n_sm = 13824, 132
    kf = tfs.fwd_splits(n_views, H, W, Fp, n_sm)
    kb = tfs.bwd_splits(n_views, H, W, Fp, n_sm)
    cells = n_views * (H // tfs.FWD_CELL_H) * (W // tfs.FWD_CELL_W)
    groups = n_views * Fp // tfs.GROUP
    n_ty, n_tx = tfs.grid_dims(H, W)
    assert tfs.CTAS_PER_SM * n_sm <= kf * cells < tfs.CTAS_PER_SM * n_sm + cells
    assert tfs.CTAS_PER_SM * n_sm <= kb * groups < tfs.CTAS_PER_SM * n_sm + groups
    assert 1 <= kf <= Fp // tfs.STAGE and 1 <= kb <= n_ty * n_tx
    # a small input takes no more splits than it has stages and tiles
    assert tfs.fwd_splits(1, 50, 70, 512, n_sm) == 512 // tfs.STAGE
    assert tfs.bwd_splits(1, 50, 70, 512, n_sm) == 2 * 3
