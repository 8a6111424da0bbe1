"""Scenes for the hard z-buffer's brute-force kernel (#15) and its work
split, shared by tests/test_torch_zbuffer_brute.py (on the CPU, against the
JAX package) and tests/test_torch_cuda.py (on the card). No JAX here: the
card tests import this module too.

Each scene is made with numpy from a seed for an (H, W) screen and returned
as numpy arrays: coef (F, 3, 4) float32 ([pixel term k][b0, b1, b2, iz], as
raster._face_coefficients gives), valid (F,) bool and the corners' screen
coordinates sx, sy (F, 3) float32, which B2 culls by (a crafted face gets
corners that span the screen)."""

from __future__ import annotations

import numpy as np
import torch

from avatarclip_torch.render import cameras, raster

NAMES = ("soup", "ties", "negzero", "nan", "all invalid", "empty")


def _soup(H: int, W: int, n_faces: int, seed: int):
    """Random triangles over 400 vertices, some behind the camera."""
    g = np.random.default_rng(seed)
    v = g.normal(0.0, 0.4, (400, 3)).astype(np.float32)
    v[:12, 2] += 3.0
    f = g.integers(0, 400, (n_faces, 3))
    pose = cameras.lookat_np(np.array([0.05, -0.1, 1.6], np.float32), np.zeros(3, np.float32),
                             np.array([0.0, 1.0, 0.0], np.float32))
    proj = raster.project_vertices(torch.from_numpy(v), torch.from_numpy(pose), H, W, 0.75 * max(H, W))
    tf = torch.from_numpy(f)
    coef, valid, _ = raster._face_coefficients(proj, tf)
    return [coef.numpy(), valid.numpy(), proj.sx[tf].numpy(), proj.sy[tf].numpy()]


def _crafted(H: int, W: int, rows: list) -> list:
    """Faces given by their coefficients, with corners spanning the screen."""
    coef = np.array(rows, np.float32).reshape(-1, 3, 4)
    n = coef.shape[0]
    sx = np.tile(np.array([-1.0, W, 0.5 * W], np.float32), (n, 1))
    sy = np.tile(np.array([-1.0, -1.0, H], np.float32), (n, 1))
    return [coef, np.ones(n, bool), sx, sy]


def _join(*parts) -> list:
    return [np.concatenate(x) for x in zip(*parts)]


def scene(name: str, H: int, W: int, n_faces: int = 1100, seed: int = 1):
    """(coef, valid, sx, sy) of scene ``name``:

    * soup: ``n_faces`` random triangles;
    * ties: the soup twice, the second copy reversed, so every face has an
      exact duplicate (equal iz at every pixel) at another id, most of them
      in another face slice once there are two or more: the higher id must
      win;
    * negzero: the soup and two faces whose edge 0 is exactly -0.0 where
      they cover: one over the top row (b0 = (px * -0 + py * -1) + -0), one
      at pixel (0, 0) alone (b0 = (px * -1 + py * -1) + -0), both nearer
      than the soup (-0.0 >= 0 holds: a sign-bit test would drop them);
    * nan: the soup with every third face invalid and its coefficients NaN,
      an invalid face nearer than all that covers the screen, and valid
      degenerate faces: a NaN iz, a NaN edge constant (neither may win), an
      infinite edge coefficient (inside where its edge values are inf);
    * all invalid: the soup with every flag False (every pixel -1);
    * empty: no face at all (every pixel -1)."""
    if name == "empty":
        return (np.zeros((0, 3, 4), np.float32), np.zeros(0, bool), np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.float32))
    soup = _soup(H, W, n_faces, seed)
    if name == "soup":
        parts = soup
    elif name == "ties":
        parts = _join(soup, [x[::-1].copy() for x in soup])
    elif name == "negzero":
        one, nz = 1.0, -0.0
        parts = _join(soup, _crafted(H, W, [
            [nz, 0, 0, 0, -1, 0, 0, 0, nz, one, one, 1e4],  # the top row
            [-1, 0, 0, 0, -1, 0, 0, 0, nz, one, one, 2e4],  # pixel (0, 0)
        ]))
    elif name == "nan":
        coef, valid, sx, sy = (x.copy() for x in soup)
        valid[::3] = False
        coef[::3] = np.nan
        cover = _crafted(H, W, [[0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1e5]])
        cover[1][:] = False
        nan, inf = np.nan, np.inf
        bad = _crafted(H, W, [
            [0, 0, 0, nan, 0, 0, 0, 0, 1, 1, 1, 3e5],  # iz NaN everywhere
            [0, 0, 0, 0, 0, 0, 0, 0, nan, 1, 1, 3e5],  # b0 NaN everywhere
            # b0 NaN at px = 0, inf elsewhere; the top 6 rows (b1 = 5 - py)
            [inf, 0, 0, 0, 0, -1, 0, 0, 1, 5, 1, 5e4],
        ])
        parts = _join([coef, valid, sx, sy], cover, bad)
    elif name == "all invalid":
        parts = soup
        parts[1] = np.zeros_like(parts[1])
    else:
        raise KeyError(name)
    coef, valid, sx, sy = parts
    return (np.ascontiguousarray(coef, np.float32), np.ascontiguousarray(valid),
            np.ascontiguousarray(sx, np.float32), np.ascontiguousarray(sy, np.float32))


def split_plain(rz, coef: torch.Tensor, valid: torch.Tensor, H: int, W: int, split: int = 0):
    """The plain version run over each face slice of ``rz.brute_plan`` and
    merged as #15 merges: the largest 64-bit key (iz bits << 32 | id) over
    the slices, -1 where no slice has a winner."""
    _, slices, _ = rz.brute_plan(H, W, coef.shape[0], split)
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32), torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    key = torch.zeros(H * W, dtype=torch.int64)
    for f0, f1 in slices:
        if f1 == f0:
            continue
        ids = rz.zbuffer_select_plain(coef[f0:f1], valid[f0:f1], H, W).long()
        hit = ids >= 0
        c = coef[f0:f1][ids.clamp_min(0)]
        iz = rz.lin3(px, py, c[:, 0, 3], c[:, 1, 3], c[:, 2, 3])
        bits = iz.view(torch.int32).long()  # iz > 0 at a winner: bits below 2^31
        key = torch.maximum(key, torch.where(hit, bits << 32 | (ids + f0), 0))
    return torch.where(key > 0, key & 0xFFFFFFFF, -1).to(torch.int32)
