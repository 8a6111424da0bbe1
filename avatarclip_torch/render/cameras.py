"""Cameras, ray generation and silhouette ray selection (twin of
avatarclip_tpu/render/cameras.py).

Conventions (as in the reference): camera-to-world ``pose`` 4x4 with columns
[x, y, z] camera axes and the eye in the last column; the camera looks down
-z; pixel rays are [(px-cx)/f, -(py-cy)/f, -1] rotated by pose[:3, :3];
f = W / (2 tan(fov_x / 2)).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# body frame -> NeuS world frame (models/utils.py:114-118)
BODY_TO_WORLD = np.array(
    [[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]], dtype=np.float32
)


def sphere_coord(theta, phi, r=1.0):
    return torch.stack([
        r * torch.sin(theta) * torch.cos(phi),
        r * torch.sin(theta) * torch.sin(phi),
        r * torch.cos(theta),
    ], dim=-1)


def focal_from_fov(width: int, fov_x_rad: float) -> float:
    return 0.5 * width / float(np.tan(0.5 * fov_x_rad))


def sphere_coord_np(theta: float, phi: float, r: float) -> np.ndarray:
    return np.array(
        [r * np.sin(theta) * np.cos(phi), r * np.sin(theta) * np.sin(phi), r * np.cos(theta)],
        np.float32,
    )


def lookat(eye: torch.Tensor, at: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Camera-to-world matrix (models/utils.py:9-27), on the inputs' device."""
    z = eye - at
    z = z / z.norm()
    x = torch.linalg.cross(up, z)
    x = x / x.norm()
    y = torch.linalg.cross(z, x)
    pose = torch.eye(4, dtype=eye.dtype, device=eye.device)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, y, z, eye
    return pose


def lookat_np(eye: np.ndarray, at: np.ndarray, up: np.ndarray) -> np.ndarray:
    z = eye - at
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, y, z, eye
    return pose


def sample_training_camera(rng: np.random.Generator, face_iter: bool, head_height: float):
    """Host-side per-iteration train_clip camera (main.py:348-359): every 4th
    iteration a face camera at distance 0.4 aimed at the head, otherwise a
    full-body camera at distance U(1, 2) with a jittered look-at."""
    if face_iter:
        dist = 0.4
        phi = rng.uniform(0.0, 2.0 * np.pi)
        theta = float(np.clip(rng.normal() * (np.pi / 12.0), -np.pi / 2, np.pi / 2))
        is_front = 1
        at = np.array([0.0, head_height, 0.3], np.float32)
        eye = sphere_coord_np(theta, phi, dist) + at
    else:
        dist = float(rng.uniform(1.0, 2.0))
        phi = rng.uniform(0.0, 2.0 * np.pi)
        theta = float(rng.normal() * (np.pi / 3.0))
        is_front = int(-np.pi / 2 <= theta <= np.pi / 2)
        at = np.clip(rng.normal(size=3) * 0.1, -0.3, 0.3).astype(np.float32)
        eye = sphere_coord_np(theta, phi, dist) + at
    pose = lookat_np(eye, at, np.array([0.0, 1.0, 0.0], np.float32))
    return {
        "pose": pose,
        "theta": np.float32(theta),
        "phi": np.float32(phi),
        "is_front": np.int32(is_front),
        "face_iter": bool(face_iter),
        "distance": float(dist),
    }


def pixel_grid_rays(pose: torch.Tensor, H: int, W: int, focal: float,
                    sensor_h: int | None = None, sensor_w: int | None = None):
    """Dense H x W ray grid for a camera pose; the grid spans the full
    sensor (sensor_h x sensor_w pixels) sampled at H x W."""
    sh = H if sensor_h is None else sensor_h
    sw = W if sensor_w is None else sensor_w
    dev = pose.device
    cx, cy = sw * 0.5, sh * 0.5
    tx = torch.linspace(0.0, sw - 1.0, W, device=dev)
    ty = torch.linspace(0.0, sh - 1.0, H, device=dev)
    py, px = torch.meshgrid(ty, tx, indexing="ij")  # (H, W)
    p = torch.stack([(px - cx) / focal, -(py - cy) / focal, -torch.ones_like(px)], dim=-1)
    d = p / p.norm(dim=-1, keepdim=True)
    rays_d = torch.einsum("hwc,rc->hwr", d, pose[:3, :3])
    rays_o = pose[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def near_far_from_sphere(rays_o: torch.Tensor, rays_d: torch.Tensor, clip_near: bool = True):
    """Unit-sphere near/far bounds (dataset.py:331-342)."""
    a = (rays_d**2).sum(-1, keepdim=True)
    b = 2.0 * (rays_o * rays_d).sum(-1, keepdim=True)
    mid = 0.5 * (-b) / a
    near = mid - 1.0
    if clip_near:
        near = near.clamp_min(0.0)
    return near, mid + 1.0


@functools.lru_cache(maxsize=8)
def _fixed_permutation(n: int) -> np.ndarray:
    """A fixed (seeded) permutation of range(n), shared with the JAX package."""
    return np.random.RandomState(1234).permutation(n).astype(np.int64)


def dilate_mask(mask: torch.Tensor, iterations: int = 10) -> torch.Tensor:
    """Binary dilation with a 3x3 element ``iterations`` times, as one
    (2k+1)^2 max-pool."""
    k = iterations
    m = mask.float()[None, None]
    return F.max_pool2d(m, 2 * k + 1, stride=1, padding=k)[0, 0] > 0.5


def select_silhouette_rays(mask: torch.Tensor, n_rays: int, dilate_iters: int, shift: int):
    """A static budget of ``n_rays`` pixel indices, dilated-mask pixels first.

    Pixels are ranked after a fixed permutation rolled by ``shift`` (the
    step's one random draw, drawn by the caller). Returns (flat_idx (n_rays,)
    int64, dilated (H, W), sel (H, W))."""
    H, W = mask.shape
    n = H * W
    dev = mask.device
    dilated = dilate_mask(mask, dilate_iters)
    perm = torch.as_tensor(_fixed_permutation(n), device=dev)
    order = torch.roll(perm, int(shift))
    d_flat = dilated.reshape(-1)[order].long()
    rank_in = torch.cumsum(d_flat, 0) - 1
    m_total = rank_in[-1] + 1
    rank_out = torch.cumsum(1 - d_flat, 0) - 1
    dest = torch.where(d_flat == 1, rank_in, m_total + rank_out)
    idx_by_rank = torch.empty(n, dtype=torch.long, device=dev)
    idx_by_rank[dest] = order
    idx = idx_by_rank[:n_rays]
    sel = torch.zeros(n, dtype=torch.bool, device=dev)
    sel[idx] = True
    return idx, dilated, sel.reshape(H, W)
