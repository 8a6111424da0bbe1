"""Mesh extraction: SDF grid evaluation in PyTorch + native marching tetrahedra
(twin of avatarclip_tpu/export/marching_cubes.py).

The reference's ``extract_geometry`` (AvatarGen/AppearanceGen/models/
renderer.py:10-36) splits at the device/host boundary: the millions of SDF
evaluations over the grid run as chunked queries on the device (plain torch:
``fields.sdf.sdf`` is matmuls, as the JAX package leaves it to XLA), and the
topology pass runs in a small C++ library (``csrc/host/marching_cubes.cpp``,
a copy of the JAX package's ``native/marching_cubes.cpp``) built with g++ at
first use into ``avatarclip_torch/build/`` and loaded with ctypes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import _build


def _lib():
    lib = _build.load_host("marching_cubes", "marching_cubes.cpp")
    if not getattr(lib, "_typed", False):
        lib.marching_tets.restype = ctypes.c_int
        lib.marching_tets.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mc_free.restype = None
        lib.mc_free.argtypes = [ctypes.c_void_p]
        lib._typed = True
    return lib


def marching_cubes(grid: np.ndarray, threshold: float = 0.0):
    """Iso-surface of grid[x, y, z] at ``threshold`` -> (verts, tris), the
    vertices in grid-index units (like mcubes.marching_cubes,
    renderer.py:31); the caller rescales to world space (renderer.py:35)."""
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    nx, ny, nz = grid.shape
    lib = _lib()
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int32)()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.marching_tets(grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nx, ny, nz,
                           ctypes.c_float(threshold), ctypes.byref(verts_p),
                           ctypes.byref(tris_p), ctypes.byref(nv), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError("marching_tets failed")
    try:
        verts = np.ctypeslib.as_array(verts_p, shape=(nv.value, 3)).copy()
        tris = np.ctypeslib.as_array(tris_p, shape=(nt.value, 3)).copy()
    finally:
        lib.mc_free(ctypes.cast(verts_p, ctypes.c_void_p))
        lib.mc_free(ctypes.cast(tris_p, ctypes.c_void_p))
    return verts, tris


def _eval_points(pts: np.ndarray, query_fn, chunk: int, device) -> np.ndarray:
    """``query_fn((P, 3) tensor) -> (P,)`` over ``pts`` in chunks on
    ``device``, gathered on the host once at the end."""
    pts_t = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(device)
    with torch.no_grad():
        parts = [query_fn(pts_t[i:i + chunk]).reshape(-1) for i in range(0, pts_t.shape[0], chunk)]
    if not parts:
        return np.zeros(0, np.float32)
    return torch.cat(parts).float().cpu().numpy()


def _grid_axes(bound_min, bound_max, resolution: int):
    bound_min = np.asarray(bound_min, np.float32)
    bound_max = np.asarray(bound_max, np.float32)
    return [np.linspace(bound_min[a], bound_max[a], resolution, dtype=np.float32)
            for a in range(3)]


def extract_fields(bound_min, bound_max, resolution: int, query_fn, chunk: int = 64**3,
                   hierarchical: bool | None = None, lipschitz_bound: float = 2.0,
                   threshold: float = 0.0, device="cuda") -> np.ndarray:
    """Evaluate ``query_fn`` over a dense (res, res, res) grid with u[x, y, z]
    layout (renderer.py:10-25).

    ``hierarchical`` (default: on for resolution >= 256 when the 16-voxel
    tile divides it) skips empty space as the JAX package does: a coarse pass
    over tile corners and centres bounds the field per tile, and tiles the
    iso-surface cannot reach under the working gradient bound hold their
    corner mean. The bound starts at ``lipschitz_bound`` and self-widens to
    1.5x the steepest slope observed on the coarse lattice or in the finely
    evaluated tiles, re-activating tiles until stable; ``hierarchical=False``
    is the reference's unconditionally exact dense pass."""
    xs, ys, zs = _grid_axes(bound_min, bound_max, resolution)
    tile = 16
    if hierarchical is None:
        hierarchical = resolution >= 256 and resolution % tile == 0
    if hierarchical and resolution % tile == 0:
        return _extract_fields_tiled(xs, ys, zs, resolution, query_fn, chunk, tile,
                                     lipschitz_bound, threshold, device)
    xx, yy, zz = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    return _eval_points(pts, query_fn, chunk, device).reshape(resolution, resolution, resolution)


def _extract_fields_tiled(xs, ys, zs, resolution: int, query_fn, chunk: int, tile: int,
                          lipschitz_bound: float, threshold: float, device) -> np.ndarray:
    """Coarse-to-fine field evaluation (see extract_fields;
    avatarclip_tpu/export/marching_cubes.py:158-287, the same arithmetic)."""
    nt = resolution // tile
    # tile-corner lattice: fine indices 0, tile, ..., resolution-1
    ci = np.minimum(np.arange(nt + 1) * tile, resolution - 1)
    cx, cy, cz = np.meshgrid(xs[ci], ys[ci], zs[ci], indexing="ij")
    cpts = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)
    cu = _eval_points(cpts, query_fn, chunk, device).reshape(nt + 1, nt + 1, nt + 1)
    # tile centres tighten the covering radius to (sqrt(5)/4) t h
    mi = np.minimum(np.arange(nt) * tile + tile // 2, resolution - 1)
    mx, my, mz = np.meshgrid(xs[mi], ys[mi], zs[mi], indexing="ij")
    mpts = np.stack([mx, my, mz], axis=-1).reshape(-1, 3)
    mu = _eval_points(mpts, query_fn, chunk, device).reshape(nt, nt, nt)

    w = np.lib.stride_tricks.sliding_window_view(cu, (2, 2, 2))  # (nt, nt, nt, 2, 2, 2)
    cmin = np.minimum(w.min(axis=(3, 4, 5)), mu)
    cmax = np.maximum(w.max(axis=(3, 4, 5)), mu)
    cmean = w.mean(axis=(3, 4, 5), dtype=np.float64).astype(np.float32)

    hx = float(xs[1] - xs[0]) if resolution > 1 else 0.0
    hy = float(ys[1] - ys[0]) if resolution > 1 else 0.0
    hz = float(zs[1] - zs[0]) if resolution > 1 else 0.0
    h = max(hx, hy, hz)

    # every observed slope lower-bounds the true Lipschitz constant
    l_obs = max(
        float((np.abs(np.diff(cu, axis=ax)) / np.maximum(
            np.abs(np.diff(axv[ci])), 1e-12
        ).reshape([-1 if a == ax else 1 for a in range(3)])).max())
        for ax, axv in ((0, xs), (1, ys), (2, zs))
    )
    if resolution > 1:  # centre-vs-corner slopes over the exact pair distances
        def _axis_d(axv):
            cv, mv = axv[ci], axv[mi]
            return np.stack([np.abs(mv - cv[:-1]), np.abs(cv[1:] - mv)], -1)

        dx, dy, dz = _axis_d(xs), _axis_d(ys), _axis_d(zs)
        d_cc = np.sqrt((dx ** 2)[:, None, None, :, None, None]
                       + (dy ** 2)[None, :, None, None, :, None]
                       + (dz ** 2)[None, None, :, None, None, :])
        l_obs = max(l_obs, float((np.abs(w - mu[..., None, None, None])
                                  / np.maximum(d_cc, 1e-12)).max()))
    bound = max(lipschitz_bound, 1.5 * l_obs)

    # covering radius of {corners, centre} plus a one-voxel halo
    cover = 0.25 * np.sqrt(5.0) * tile * h
    same_side = (cmin > threshold) == (cmax > threshold)
    dist = np.minimum(np.abs(cmin - threshold), np.abs(cmax - threshold))

    out = cmean.repeat(tile, 0).repeat(tile, 1).repeat(tile, 2).astype(np.float32)
    evaluated = np.zeros((nt, nt, nt), bool)
    t_axis = np.arange(tile)
    while True:
        margin = bound * (cover + np.sqrt(3.0) * h)
        active = ~(same_side & (dist > margin)) & ~evaluated
        ai, aj, ak = np.nonzero(active)
        if ai.size == 0:
            break
        gx = xs[ai[:, None] * tile + t_axis]  # (n, tile)
        gy = ys[aj[:, None] * tile + t_axis]
        gz = zs[ak[:, None] * tile + t_axis]
        pts = np.empty((ai.size, tile, tile, tile, 3), np.float32)
        pts[..., 0] = gx[:, :, None, None]
        pts[..., 1] = gy[:, None, :, None]
        pts[..., 2] = gz[:, None, None, :]
        vals = _eval_points(pts.reshape(-1, 3), query_fn, chunk, device)
        vals = vals.reshape(ai.size, tile, tile, tile)
        for n, (i, j, k) in enumerate(zip(ai, aj, ak)):
            out[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile, k * tile:(k + 1) * tile] = vals[n]
        evaluated[ai, aj, ak] = True
        l_fine = max((float(np.abs(np.diff(vals, axis=ax)).max()) / hh
                      for ax, hh in ((1, hx), (2, hy), (3, hz))
                      if vals.shape[ax] > 1 and hh > 0), default=0.0)
        new_bound = max(bound, 1.5 * l_fine)
        if new_bound <= bound:
            break
        bound = new_bound  # widen and re-check the remaining skips
    return out


def extract_geometry(bound_min, bound_max, resolution: int, threshold: float, query_fn,
                     hierarchical: bool | None = None, device="cuda"):
    """Grid evaluation + marching tets + world-space rescale (renderer.py:28-36)."""
    u = extract_fields(bound_min, bound_max, resolution, query_fn, threshold=threshold,
                       hierarchical=hierarchical, device=device)
    verts, tris = marching_cubes(u, threshold)
    bmin = np.asarray(bound_min, np.float32)
    bmax = np.asarray(bound_max, np.float32)
    verts = verts / (resolution - 1.0) * (bmax - bmin)[None, :] + bmin[None, :]
    return verts, tris
