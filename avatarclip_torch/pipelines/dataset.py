"""Multi-view dataset for the photometric NeuS step and the validation renders
(twin of avatarclip_tpu/pipelines/dataset.py): Blender-style
``transforms_train.json`` plus N rendered PNGs, held as tensors on the chosen
device."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import assets
from ..render import cameras
from ..utils.png import read_png


def sample_random_rays(images, masks, poses, focal: float, img_idx: int,
                       px: torch.Tensor, py: torch.Tensor):
    """Rays, colours and mask at the given pixels of one stored view
    (dataset.py:314-329); the pixel draws come from the caller."""
    H, W = images.shape[1], images.shape[2]
    color = images[img_idx, py, px]
    mask = masks[img_idx, py, px][:, None]
    cx, cy = W * 0.5, H * 0.5
    p = torch.stack([(px - cx) / focal, -(py - cy) / focal,
                     -torch.ones(px.shape, device=images.device)], -1)
    d = p / p.norm(dim=-1, keepdim=True)
    pose = poses[img_idx]
    rays_d = d @ pose[:3, :3].t()
    rays_o = pose[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d, color, mask


class SMPLViewDataset:
    def __init__(self, conf, device="cpu"):
        self.data_dir = conf.get_string("data_dir")
        if not os.path.exists(self.data_dir):
            found = assets.find(os.path.basename(os.path.normpath(self.data_dir)))
            if found is None:
                raise FileNotFoundError(
                    f"dataset.data_dir {self.data_dir!r} not found (also searched "
                    f"{assets.search_dirs()})"
                )
            self.data_dir = found
        with open(os.path.join(self.data_dir, "transforms_train.json")) as fp:
            meta = json.load(fp)
        images, poses = [], []
        for frame in meta["frames"]:
            img = read_png(os.path.join(self.data_dir, frame["file_path"] + ".png"))
            if img.shape[-1] < 3:
                img = np.repeat(img[..., :1], 3, -1)
            images.append(img[..., :3])
            poses.append(np.array(frame["transform_matrix"], np.float32))
        self.n_images = len(images)
        arr = (np.asarray(images) / 255.0).astype(np.float32)
        arr = arr[:, :, ::-1]  # the reference mirrors the renders (dataset.py:226)
        self.images = torch.from_numpy(arr.copy()).to(device)  # (N, H, W, 3)
        self.masks = (self.images != 0).any(-1).float()  # (N, H, W)
        self.poses = torch.from_numpy(np.stack(poses)).to(device)
        self.H, self.W = int(arr.shape[1]), int(arr.shape[2])
        self.focal = cameras.focal_from_fov(self.W, float(meta["camera_angle_x"]))
        self.image_pixels = self.H * self.W
        self.object_bbox_min = np.array([-1.01, -1.01, -1.01], np.float32)
        self.object_bbox_max = np.array([1.01, 1.01, 1.01], np.float32)

    def gen_rays_at(self, img_idx: int, resolution_level: float = 1):
        """Dense ray grid for one stored camera (dataset.py:295-312)."""
        return self.gen_rays_pose(self.poses[img_idx], resolution_level)

    def gen_rays_pose(self, pose, resolution_level: float = 1):
        """Dense ray grid for an arbitrary pose (dataset.py:277-293): the
        sensor's frustum sampled at (H // level, W // level)."""
        H, W = int(self.H // resolution_level), int(self.W // resolution_level)
        return cameras.pixel_grid_rays(pose, H, W, self.focal, sensor_h=self.H, sensor_w=self.W)

    def near_far_from_sphere(self, rays_o, rays_d):
        return cameras.near_far_from_sphere(rays_o, rays_d, clip_near=True)
