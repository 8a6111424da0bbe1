"""Hard z-buffer winner selection: the binned CUDA kernel (B2) and the
brute-force one (#15), their plain version, the culling twins and the
brute-force kernel's work split.

Twin of avatarclip_tpu/ops/raster_zbuffer.py (`zbuffer_select_tiled`,
`overlap_table`, the `_select_update` winner rule, and the untiled
`zbuffer_select`). Semantics on every device: the winner of a pixel is the
inside, valid face with iz > 0 that maximises (exact f32 inverse depth, face
id); -1 is background. Edge values are evaluated as (px * c0 + py * c1) + c2
with separately rounded products and sums in every version, so the kernels
and the plain version agree exactly, and the two kernels with each other
(B2's culling is winner-exact).

The kernels are in ``csrc/raster_zbuffer.cu``; a CUDA tensor launches them
(or the call raises), a CPU tensor takes :func:`zbuffer_select_plain`. The
renderer calls B2, which culls by face inside the kernel: a face reaches
the 16 x 16 screen tiles, and within a tile the warps' 8 x 4 pixels, that
meet its pixel bbox (:func:`tile_faces` is the Python twin of the faces a
tile evaluates). :func:`overlap_table` stays as the twin of
the JAX package's table. The brute-force kernel, as in the JAX package, is
held against B2 and timed beside it: it evaluates every (pixel, face) pair,
over the pixel tiles and face slices of :func:`brute_plan`, and merges the
slices' winners by the largest (iz, id).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

TILE_H = 32  # the JAX package's culling table: 32 x 32 tiles ...
TILE_W = 32
FBLOCK_T = 512  # ... against 512-face blocks
BIN = 16  # B2's screen tile (pixels a side; csrc/raster_zbuffer.cu's BIN)
MARGIN = 1.0  # the float margin (pixels) around a face's bbox, the JAX table's
# #15's work split (csrc/raster_zbuffer.cu's BR_TILE, BR_FBLOCK, BR_CTAS)
BRUTE_TILE = 32  # its screen tile (pixels a side), one CTA a (tile, face slice)
BRUTE_FBLOCK = 64  # faces a staged block; a slice holds at least one block's worth
BRUTE_CTAS = 2112  # the face split's most CTAs: 2 waves of 8 an SM of the H100's 132

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


def bin_grid(H: int, W: int) -> tuple[int, int]:
    """(rows, columns) of B2's BIN x BIN screen tiles (each run by a cluster
    of CTAs: :func:`grid` counts them as launched)."""
    return -(-H // BIN), -(-W // BIN)


def tile_faces(valid: torch.Tensor, face_sx: torch.Tensor, face_sy: torch.Tensor,
               H: int, W: int, tile: int = BIN) -> list[torch.Tensor]:
    """Python twin of B2's culling: for each screen tile (row-major), the ids
    of the faces its CTA evaluates, in increasing order. A face is kept for
    a tile iff it is valid and its pixel bbox (the corners' min / max, NaN
    keeping nothing), widened by MARGIN, overlaps the tile's pixels: the
    JAX table's f32 test, per face instead of per 512-face block. At tile =
    1 it is the per-pixel test on which the kernel's warp-level culling (8
    x 4 pixels) rests."""
    n_ty, n_tx = -(-H // tile), -(-W // tile)

    def keep(lo, hi, n):  # (n, F): tile t's pixels [t tile, t tile + tile - 1] +- MARGIN
        t = torch.arange(n, device=lo.device, dtype=torch.float32)[:, None]
        return (lo[None] <= t * tile + (tile - 1) + MARGIN) & (hi[None] >= t * tile - MARGIN)

    kx = keep(face_sx.amin(1), face_sx.amax(1), n_tx)
    ky = keep(face_sy.amin(1), face_sy.amax(1), n_ty)
    kept = ky[:, None] & kx[None] & valid[None, None]
    return [row.nonzero().flatten() for row in kept.reshape(n_ty * n_tx, -1)]


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


def brute_plan(H: int, W: int, F: int, split: int = 0):
    """Twin of #15's work split (csrc/raster_zbuffer.cu's
    ``zbuffer_brute_ctas`` and the kernel's tile and slice of a CTA):
    (tiles, slices, ctas). tiles: the BRUTE_TILE x BRUTE_TILE pixel tiles,
    row-major, each (y0, y1, x0, x1) clipped to the image; slices: the K
    contiguous face ranges (f0, f1),
    slice s holding faces [s F // K, (s + 1) F // K); ctas: tiles x K, one
    CTA a (tile, slice). K is ``split`` if it is > 0, else the most that
    keeps the grid within BRUTE_CTAS, at most F // BRUTE_FBLOCK and at
    least 1."""
    n_ty, n_tx = -(-H // BRUTE_TILE), -(-W // BRUTE_TILE)
    tiles = [(y, min(y + BRUTE_TILE, H), x, min(x + BRUTE_TILE, W))
             for y in range(0, n_ty * BRUTE_TILE, BRUTE_TILE)
             for x in range(0, n_tx * BRUTE_TILE, BRUTE_TILE)]
    if split < 0:
        raise ValueError("split must be 0 (the entry's choice) or positive")
    K = split or max(1, min(BRUTE_CTAS // max(len(tiles), 1), F // BRUTE_FBLOCK))
    slices = [(s * F // K, (s + 1) * F // K) for s in range(K)]
    return tiles, slices, len(tiles) * K


def fold_valid(coef: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Twin of #15's staging: coef with every invalid face's edge-0
    constant set to NaN, which makes its b0 NaN at every pixel, and NaN >=
    0 is false: the face is never inside, as a False flag makes it."""
    out = coef.clone()
    out[:, 2, 0] = torch.where(valid, out[:, 2, 0], torch.full_like(out[:, 2, 0], float("nan")))
    return out


def _lib():
    lib = _build.load("raster_zbuffer", "raster_zbuffer.cu")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.zbuffer_brute.argtypes = [P] * 4 + [I] * 4 + [P]
        lib.zbuffer_brute.restype = I
        lib.zbuffer_brute_ctas.argtypes = [I] * 4
        lib.zbuffer_brute_ctas.restype = I
        lib.zbuffer_binned.argtypes = [P] * 6 + [I] * 4 + [P]
        lib.zbuffer_binned.restype = I
        lib.zbuffer_ctas.argtypes = [I] * 3
        lib.zbuffer_ctas.restype = I
        lib._typed = True
    return lib


def _check_faces(coef: torch.Tensor, valid: torch.Tensor) -> int:
    F = coef.shape[0]
    if coef.shape != (F, 3, 4) or coef.dtype != torch.float32 or not coef.is_contiguous():
        raise ValueError(f"coef must be contiguous (F, 3, 4) float32, got {tuple(coef.shape)} {coef.dtype}")
    if valid.shape != (F,) or valid.dtype != torch.bool or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous (F,) bool tensor")
    if valid.device != coef.device:
        raise ValueError("all inputs must be on one device")
    return F


def zbuffer_select(coef: torch.Tensor, valid: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Winner face id per pixel by the brute-force kernel, (H*W,) int32
    row-major, -1 = background; coef (F, 3, 4) f32 from
    raster._face_coefficients, valid (F,) bool. One allocation (the ids and
    the merge's 8-byte key a pixel) and one call (the keys zeroed, the
    kernel, the ids from the keys)."""
    if not coef.is_cuda:
        return zbuffer_select_plain(coef, valid, H, W)
    _check_faces(coef, valid)
    buf = torch.empty(3 * H * W, dtype=torch.int32, device=coef.device)
    out = buf[2 * H * W:]
    if H * W == 0:
        return out
    brute_launch(coef, valid, buf, out, H, W)
    _build.count(LAUNCHES, "zbuffer_brute")
    return out


def brute_launch(coef, valid, keys, out, H: int, W: int, split: int = 0) -> None:
    """#15's C call on checked inputs: the merge's keys into keys (at least
    2 H W int32, 8-byte aligned), the winners into out (H W int32).
    ``split`` is 0 as the entry calls it (K from :func:`brute_plan`); > 0
    forces K face slices, a seam for the tests of the merge. Not counted:
    zbuffer_select counts its calls."""
    err = _lib().zbuffer_brute(_build.ptr(coef), _build.ptr(valid), _build.ptr(keys), _build.ptr(out),
                               coef.shape[0], H, W, split, _build.stream_ptr(coef.device))
    _build.check(err, "zbuffer_brute launch")


def brute_ctas(H: int, W: int, F: int, split: int = 0) -> int:
    """The CTAs of #15's launch (tiles x K face slices), from the function
    that sets the C call's grid: what :func:`brute_plan`'s third item
    twins."""
    return _lib().zbuffer_brute_ctas(H, W, F, split)


def zbuffer_select_tiled(coef: torch.Tensor, valid: torch.Tensor,
                         face_sx: torch.Tensor, face_sy: torch.Tensor,
                         H: int, W: int) -> torch.Tensor:
    """Winner face id per pixel by B2, (H*W,) int32 row-major, -1 =
    background.

    coef (F, 3, 4) f32 from raster._face_coefficients (16-byte aligned),
    valid (F,) bool, face_sx / face_sy (F, 3) screen coordinates of each
    face's corners, all contiguous. One allocation (the ids and the
    prologue's 8 bytes a face of pixel ranges) and one call that launches
    the prologue and the raster kernel."""
    if not coef.is_cuda:
        return zbuffer_select_plain(coef, valid, H, W)
    F = _check_faces(coef, valid)
    for name, t in (("face_sx", face_sx), ("face_sy", face_sy)):
        if t.shape != (F, 3) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (F, 3) float32 tensor")
        if t.device != coef.device:
            raise ValueError("all inputs must be on one device")
    if coef.data_ptr() % 16:
        raise ValueError("coef must be 16-byte aligned (the kernel reads a face as 3 float4)")
    if max(H, W) > 32752:
        raise ValueError("the binned kernel takes images at most 32,752 pixels a side")
    buf = torch.empty(2 * F + H * W, dtype=torch.int32, device=coef.device)
    out = buf[2 * F:]
    if H * W == 0:
        return out
    launch(coef, valid, face_sx, face_sy, buf, out, H, W)
    _build.count(LAUNCHES, "zbuffer_tiled")
    return out


def grid(H: int, W: int) -> tuple[int, int]:
    """(tiles, CTAs) of B2's raster launch for an (H, W) image, from the
    function that sets the C call's grid: the CTAs are the tiles times the
    CTAs of a tile's cluster."""
    lib = _lib()
    return lib.zbuffer_ctas(H, W, 1), lib.zbuffer_ctas(H, W, 0)


def launch(coef, valid, face_sx, face_sy, ranges, out, H: int, W: int, split: int = 0) -> None:
    """B2's C call on checked inputs: the prologue's pixel ranges into
    ranges (at least 2 F int32, 8-byte aligned), the winners into out (H * W
    int32). ``split`` is 0 as the entry calls it (the CTAs a tile picked
    from the tile count); 1, 2 or 4 forces that cluster size, a seam for the
    tests of the cluster's merge. Not counted: zbuffer_select_tiled counts
    its calls."""
    err = _lib().zbuffer_binned(_build.ptr(coef), _build.ptr(valid), _build.ptr(face_sx),
                                _build.ptr(face_sy), _build.ptr(ranges), _build.ptr(out),
                                coef.shape[0], H, W, split, _build.stream_ptr(coef.device))
    _build.check(err, "zbuffer_binned launch")
