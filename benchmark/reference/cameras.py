"""Cameras of AvatarCLIP's sculpting and pose steps, in plain numpy and
float32 torch: camera-to-world look-at matrices (columns x, y, z, eye; the
camera looks down -z), the training camera stream (every 4th step a face
camera at 0.4 from the head, else a body camera at U(1, 2)), pixel ray
grids over the sensor, the unit sphere's near and far, and the silhouette
ray budget (the dilated mask's pixels first, in a fixed seeded order
rolled by the step's draw)."""

from __future__ import annotations

import numpy as np
import torch

BODY_TO_WORLD = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]], np.float32)


def sphere_coord_np(theta, phi, r):
    return np.array([r * np.sin(theta) * np.cos(phi), r * np.sin(theta) * np.sin(phi),
                     r * np.cos(theta)], np.float32)


def lookat_np(eye, at, up=np.array([0.0, 1.0, 0.0], np.float32)):
    z = eye - at
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, eye
    return m


def training_camera(seed: int, it: int, use_face: bool, head_height: float) -> dict:
    rng = np.random.default_rng([seed, it])
    face = bool(use_face) and it % 4 == 0
    if face:
        dist = 0.4
        phi = rng.uniform(0.0, 2.0 * np.pi)
        theta = float(np.clip(rng.normal() * (np.pi / 12.0), -np.pi / 2, np.pi / 2))
        front = 1
        at = np.array([0.0, head_height, 0.3], np.float32)
    else:
        dist = float(rng.uniform(1.0, 2.0))
        phi = rng.uniform(0.0, 2.0 * np.pi)
        theta = float(rng.normal() * (np.pi / 3.0))
        front = int(-np.pi / 2 <= theta <= np.pi / 2)
        at = np.clip(rng.normal(size=3) * 0.1, -0.3, 0.3).astype(np.float32)
    eye = sphere_coord_np(theta, phi, dist) + at
    return {"pose": lookat_np(eye, at), "theta": float(np.float32(theta)),
            "phi": float(np.float32(phi)), "is_front": front, "face": face, "distance": dist}


def focal_from_fov(width: int, fov: float) -> float:
    return 0.5 * width / float(np.tan(0.5 * fov))


def grid_rays(pose: torch.Tensor, H: int, W: int, focal: float, sensor: int):
    """(rays_o, rays_d), each (H * W, 3): the sensor's pixels sampled at H x W."""
    dev = pose.device
    tx = torch.linspace(0.0, sensor - 1.0, W, device=dev)
    ty = torch.linspace(0.0, sensor - 1.0, H, device=dev)
    py, px = torch.meshgrid(ty, tx, indexing="ij")
    c = sensor * 0.5
    p = torch.stack([(px - c) / focal, -(py - c) / focal, -torch.ones_like(px)], -1)
    d = p / p.norm(dim=-1, keepdim=True)
    rays_d = (d.reshape(-1, 3)[:, None, :] * pose[:3, :3][None]).sum(-1)
    return pose[:3, 3].expand(rays_d.shape), rays_d


def near_far(rays_o, rays_d):
    a = (rays_d ** 2).sum(-1, keepdim=True)
    b = 2.0 * (rays_o * rays_d).sum(-1, keepdim=True)
    mid = -0.5 * b / a
    return (mid - 1.0).clamp_min(0.0), mid + 1.0


def select_rays(dilated: torch.Tensor, n_rays: int, shift: int) -> torch.Tensor:
    """The first n_rays pixels of the order: dilated-mask pixels, then the
    others, each in the fixed order RandomState(1234).permutation(H W)
    rolled by ``shift``."""
    n = dilated.numel()
    order = torch.as_tensor(np.roll(np.random.RandomState(1234).permutation(n).astype(np.int64),
                                    int(shift)), device=dilated.device)
    inside = dilated.reshape(-1)[order]
    ranked = torch.cat([order[inside], order[~inside]])
    return ranked[:n_rays]


def sphere_dir(theta, phi):
    return torch.stack([torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
                        torch.cos(theta)], -1)


def view_poses(elevs: torch.Tensor, azims_deg: torch.Tensor, dist: float = 2.0) -> torch.Tensor:
    """(B, 4, 4) cameras at ``dist`` looking at the origin, neural_renderer's
    (elevation, azimuth) convention, y up."""
    a = torch.deg2rad(azims_deg)
    eye = dist * torch.stack([torch.cos(elevs) * torch.sin(a), torch.sin(elevs),
                              -torch.cos(elevs) * torch.cos(a)], -1)
    z = eye / eye.norm(dim=-1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0], device=eye.device).expand_as(z)
    x = torch.linalg.cross(up, z)
    x = x / x.norm(dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x)
    m = torch.eye(4, device=eye.device).repeat(eye.shape[0], 1, 1)
    m[:, :3, 0], m[:, :3, 1], m[:, :3, 2], m[:, :3, 3] = x, y, z, eye
    return m
