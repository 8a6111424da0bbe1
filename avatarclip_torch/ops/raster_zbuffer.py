"""Hard z-buffer winner selection: the tiled CUDA kernel (B2) and the
brute-force one (B8's #15), their plain version, the culling table.

Twin of avatarclip_tpu/ops/raster_zbuffer.py (`zbuffer_select_tiled`,
`overlap_table`, the `_select_update` winner rule, and the untiled
`zbuffer_select`). Semantics on every device: the winner of a pixel is the
inside, valid face with iz > 0 that maximises (exact f32 inverse depth, face
id); -1 is background. Edge values are evaluated as (px * c0 + py * c1) + c2
with separately rounded products and sums in every version, so the kernels
and the plain version agree exactly, and the two kernels with each other
(the tiled one's culling is winner-exact).

The kernels are in ``csrc/raster_zbuffer.cu``; a CUDA tensor launches them
(or the call raises), a CPU tensor takes :func:`zbuffer_select_plain`. The
renderer calls the tiled kernel; the brute-force one, as in the JAX package,
is held against it and timed beside it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

TILE_H = 32
TILE_W = 32
FBLOCK_T = 512  # faces per block (the kernel's shared-memory stage)

# kernel launches, counted by the wrapper (reset by callers that measure)
LAUNCHES = {"zbuffer_tiled": 0, "zbuffer_brute": 0}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def overlap_table(valid: torch.Tensor, face_sx: torch.Tensor, face_sy: torch.Tensor,
                  H: int, W: int):
    """tab[i * n_fb + j] > 0 iff screen tile i and face block j overlap (1 px
    float margin). Returns (tab (n_tiles * n_fb,) int32, n_tiles, n_fb)."""
    F = face_sx.shape[0]
    f_pad = _round_up(F, FBLOCK_T) - F
    if f_pad:
        valid = torch.cat([valid, valid.new_zeros(f_pad)])
        face_sx = torch.cat([face_sx, face_sx.new_zeros(f_pad, 3)])
        face_sy = torch.cat([face_sy, face_sy.new_zeros(f_pad, 3)])
    n_fb = face_sx.shape[0] // FBLOCK_T
    n_ty, n_tx = _round_up(H, TILE_H) // TILE_H, _round_up(W, TILE_W) // TILE_W
    n_tiles = n_ty * n_tx
    big = 1e9
    fminx = torch.where(valid, face_sx.min(1).values, big)
    fmaxx = torch.where(valid, face_sx.max(1).values, -big)
    fminy = torch.where(valid, face_sy.min(1).values, big)
    fmaxy = torch.where(valid, face_sy.max(1).values, -big)
    bminx = fminx.reshape(n_fb, FBLOCK_T).min(1).values
    bmaxx = fmaxx.reshape(n_fb, FBLOCK_T).max(1).values
    bminy = fminy.reshape(n_fb, FBLOCK_T).min(1).values
    bmaxy = fmaxy.reshape(n_fb, FBLOCK_T).max(1).values
    t = torch.arange(n_tiles, device=face_sx.device, dtype=torch.float32)
    ty, tx = torch.div(t, n_tx, rounding_mode="floor"), torch.remainder(t, n_tx)
    m = 1.0
    tx0, tx1 = tx * TILE_W - m, tx * TILE_W + (TILE_W - 1) + m
    ty0, ty1 = ty * TILE_H - m, ty * TILE_H + (TILE_H - 1) + m
    tab = (
        (bminx[None, :] <= tx1[:, None]) & (bmaxx[None, :] >= tx0[:, None])
        & (bminy[None, :] <= ty1[:, None]) & (bmaxy[None, :] >= ty0[:, None])
    ).to(torch.int32).reshape(-1)
    return tab, n_tiles, n_fb


def lin3(px, py, c0, c1, c2):
    """(px * c0 + py * c1) + c2 — the kernel's evaluation order."""
    return (px * c0 + py * c1) + c2


def zbuffer_select_plain(coef: torch.Tensor, valid: torch.Tensor, H: int, W: int,
                         chunk: int = 256) -> torch.Tensor:
    """Plain version of both kernels, brute force: every (pixel, face) pair,
    faces in chunks. Returns (H*W,) int32 face ids, -1 for background."""
    dev = coef.device
    py, px = torch.meshgrid(
        torch.arange(H, device=dev, dtype=torch.float32),
        torch.arange(W, device=dev, dtype=torch.float32), indexing="ij",
    )
    px, py = px.reshape(-1, 1), py.reshape(-1, 1)
    best_iz = torch.full((H * W,), -1.0, device=dev)
    best = torch.full((H * W,), -1, dtype=torch.int32, device=dev)
    for f0 in range(0, coef.shape[0], chunk):
        c = coef[f0:f0 + chunk]  # (C, 3, 4)
        b0, b1, b2, iz = (
            lin3(px, py, c[None, :, 0, b], c[None, :, 1, b], c[None, :, 2, b]) for b in range(4)
        )  # each (P, C)
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (iz > 0) & valid[None, f0:f0 + chunk]
        iz_in = torch.where(inside, iz, torch.full_like(iz, -1.0))
        cb = iz_in.max(1).values
        fid = torch.arange(f0, f0 + c.shape[0], device=dev, dtype=torch.int32)
        cand = torch.where((iz_in == cb[:, None]) & inside, fid[None, :], -1).max(1).values
        take = (cb > best_iz) | ((cb == best_iz) & (cand > best))
        best_iz = torch.where(take, cb, best_iz)
        best = torch.where(take, cand, best)
    return best


def zbuffer_select(coef: torch.Tensor, valid: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Winner face id per pixel by the brute-force kernel, (H*W,) int32
    row-major, -1 = background; coef (F, 3, 4) f32 from
    raster._face_coefficients, valid (F,) bool."""
    if not coef.is_cuda:
        return zbuffer_select_plain(coef, valid, H, W)
    F = coef.shape[0]
    if coef.shape != (F, 3, 4) or coef.dtype != torch.float32 or not coef.is_contiguous():
        raise ValueError(f"coef must be contiguous (F, 3, 4) float32, got {tuple(coef.shape)} {coef.dtype}")
    if valid.shape != (F,) or valid.dtype != torch.bool or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous (F,) bool tensor")
    if valid.device != coef.device:
        raise ValueError("all inputs must be on one device")
    out = torch.empty(H * W, dtype=torch.int32, device=coef.device)
    if H * W == 0:
        return out
    lib = _build.load("raster_zbuffer", "raster_zbuffer.cu")
    fn = lib.zbuffer_brute
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    err = fn(_build.ptr(coef), _build.ptr(valid), _build.ptr(out), F, H, W,
             _build.stream_ptr(coef.device))
    _build.check(err, "zbuffer_brute launch")
    _build.count(LAUNCHES, "zbuffer_brute")
    return out


def zbuffer_select_tiled(coef: torch.Tensor, valid: torch.Tensor,
                         face_sx: torch.Tensor, face_sy: torch.Tensor,
                         H: int, W: int) -> torch.Tensor:
    """Winner face id per pixel, (H*W,) int32 row-major, -1 = background.

    coef (F, 3, 4) f32 from raster._face_coefficients, valid (F,) bool,
    face_sx / face_sy (F, 3) screen coordinates of each face's corners."""
    if not coef.is_cuda:
        return zbuffer_select_plain(coef, valid, H, W)
    F = coef.shape[0]
    if coef.shape != (F, 3, 4) or coef.dtype != torch.float32:
        raise ValueError(f"coef must be (F, 3, 4) float32, got {tuple(coef.shape)} {coef.dtype}")
    if valid.shape != (F,) or face_sx.shape != (F, 3) or face_sy.shape != (F, 3):
        raise ValueError("valid / face_sx / face_sy do not match coef")
    for t in (valid, face_sx, face_sy):
        if t.device != coef.device:
            raise ValueError("all inputs must be on one device")
    tab, n_tiles, n_fb = overlap_table(valid, face_sx, face_sy, H, W)
    f_pad = n_fb * FBLOCK_T - F
    coef_p = torch.cat([coef, coef.new_zeros(f_pad, 3, 4)]).contiguous()
    valid_p = torch.cat([valid.to(torch.int32), valid.new_zeros(f_pad, dtype=torch.int32)])
    out = torch.empty(H * W, dtype=torch.int32, device=coef.device)
    lib = _build.load("raster_zbuffer", "raster_zbuffer.cu")
    fn = lib.zbuffer_tiled
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    n_tx, n_ty = _round_up(W, TILE_W) // TILE_W, _round_up(H, TILE_H) // TILE_H
    err = fn(_build.ptr(coef_p), _build.ptr(valid_p), _build.ptr(tab), _build.ptr(out),
             H, W, n_tx, n_ty, n_fb, _build.stream_ptr(coef.device))
    _build.check(err, "zbuffer_tiled launch")
    _build.count(LAUNCHES, "zbuffer_tiled")
    return out
