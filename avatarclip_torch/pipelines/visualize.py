"""Pose and motion pictures through the port's hard rasterizer (twin of
avatarclip_tpu/pipelines/visualize.py; reference: AvatarAnimate/
visualize.py:15-124): 512^2 renders from a fixed frontal camera with
three-quarter lighting on white; ``render_pose`` writes a JPEG and
``render_motion`` a Motion-JPEG MP4 (utils/jpeg.py, utils/mp4.py)."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..render import cameras, raster
from ..utils.jpeg import write_jpeg
from ..utils.mp4 import write_mp4

LIGHT_DIR = (0.4, 0.8, 0.6)


def camera(device, res: int = 512) -> tuple[torch.Tensor, float]:
    """The pictures' camera: (pose (4, 4), focal), frontal, slightly raised."""
    eye = torch.tensor([0.0, 0.3, 2.4], device=device)
    pose = cameras.lookat(eye, torch.zeros(3, device=device), torch.tensor([0.0, 1.0, 0.0], device=device))
    return pose, cameras.focal_from_fov(res, np.deg2rad(50.0))


def _render_frame(ctx, pose69: torch.Tensor, res: int = 512) -> np.ndarray:
    """(69,) pose -> (res, res, 3) uint8: one z-buffer render."""
    pose69 = torch.as_tensor(pose69, device=ctx.device).reshape(1, -1)
    with torch.no_grad():
        verts = ctx._pose_vertices(pose69)[0]
        pose, focal = camera(ctx.device, res)
        rgb = raster.render_mesh(verts, ctx.faces, pose, res, res, focal, light_dir=LIGHT_DIR,
                                 background=1.0)["rgb"]
    return (rgb.clamp(0.0, 1.0) * 255).to(torch.uint8).cpu().numpy()


def render_pose(pose, path: str, ctx=None, res: int = 512) -> float:
    """(69,) pose -> shaded JPEG (the role of visualize.py:96-110); returns
    the host seconds of the JPEG encoding and write."""
    if ctx is None:
        from .animate import AnimateContext

        ctx = AnimateContext()
    img = _render_frame(ctx, pose, res)
    t0 = time.perf_counter()
    write_jpeg(path, img)
    return time.perf_counter() - t0


def render_motion(motion, path: str, ctx=None, res: int = 512, fps: int = 30) -> float:
    """(T, 69) motion -> MP4 at ``fps`` (the role of visualize.py:113-124);
    returns the host seconds of the JPEG encodes and the muxing."""
    if ctx is None:
        from .animate import AnimateContext

        ctx = AnimateContext()
    frames = [_render_frame(ctx, p, res) for p in motion]
    t0 = time.perf_counter()
    write_mp4(path, frames, fps=fps)
    return time.perf_counter() - t0
