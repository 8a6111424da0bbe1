"""IDR-style dataset (cameras.npz + image/ + mask/ directories): twin of
avatarclip_tpu/pipelines/idr_dataset.py, the reference's legacy ``Dataset``
(AvatarGen/AppearanceGen/models/dataset.py:42-175) used by stock NeuS scenes.

World / scale projection matrices are decomposed into intrinsics and pose
(an RQ decomposition through scipy, in place of
cv2.decomposeProjectionMatrix), images and masks are read with
``utils/png.read_png`` and normalised by 256, and rays come from each
image's intrinsics. The tensors live on ``device``.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..render import cameras
from ..utils.png import read_png


def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a 3x4 projection into (intrinsics 4x4, pose 4x4)
    (dataset.py:18-39)."""
    import scipy.linalg

    # RQ decomposition of the left 3x3: P[:3, :3] = K @ R
    K, R = scipy.linalg.rq(P[:3, :3])
    # a positive diagonal on K
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1
    K = K * signs[None, :]
    R = R * signs[:, None]
    if np.linalg.det(R) < 0:
        R = -R
        K = -K
    t = np.linalg.lstsq(K, P[:3, 3], rcond=None)[0]
    c = -R.T @ t  # the camera centre

    K = K / K[2, 2]
    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = c
    return intrinsics, pose


class IDRDataset:
    def __init__(self, conf, device="cpu"):
        self.device = torch.device(device)
        self.data_dir = conf.get_string("data_dir")
        cam_name = conf.get_string("render_cameras_name", "cameras_sphere.npz")
        obj_cam_name = conf.get_string("object_cameras_name", cam_name)
        self.scale_mat_scale = conf.get_float("scale_mat_scale", 1.1)

        camera_dict = np.load(os.path.join(self.data_dir, cam_name))
        self.images_lis = sorted(glob.glob(os.path.join(self.data_dir, "image/*.png")))
        self.n_images = len(self.images_lis)
        images = np.stack([read_png(p)[..., :3] for p in self.images_lis]).astype(np.float32) / 256.0
        mask_lis = sorted(glob.glob(os.path.join(self.data_dir, "mask/*.png")))
        if mask_lis:
            masks = np.stack([read_png(p)[..., 0] for p in mask_lis]).astype(np.float32) / 256.0
        else:
            masks = np.ones(images.shape[:3], np.float32)

        world_mats = [camera_dict[f"world_mat_{i}"].astype(np.float32) for i in range(self.n_images)]
        scale_mats = [camera_dict[f"scale_mat_{i}"].astype(np.float32) for i in range(self.n_images)]
        self.scale_mats_np = scale_mats
        intrinsics_all, pose_all = [], []
        for scale_mat, world_mat in zip(scale_mats, world_mats):
            intr, pose = load_K_Rt_from_P((world_mat @ scale_mat)[:3, :4])
            intrinsics_all.append(intr)
            pose_all.append(pose)

        dev = self.device
        self.images = torch.from_numpy(images).to(dev)  # (N, H, W, 3)
        self.masks = torch.from_numpy(masks).to(dev)  # (N, H, W)
        self.intrinsics_all = torch.from_numpy(np.stack(intrinsics_all)).to(dev)
        self.intrinsics_all_inv = torch.linalg.inv(self.intrinsics_all)
        self.poses = torch.from_numpy(np.stack(pose_all)).to(dev)
        self.H, self.W = int(images.shape[1]), int(images.shape[2])
        self.focal = float(intrinsics_all[0][0, 0])
        self.image_pixels = self.H * self.W

        # the mesh extraction box in the normalised frame (dataset.py:91-98)
        object_scale_mat = np.load(os.path.join(self.data_dir, obj_cam_name))["scale_mat_0"]
        bbox_min = np.array([-1.01, -1.01, -1.01, 1.0])
        bbox_max = np.array([1.01, 1.01, 1.01, 1.0])
        inv = np.linalg.inv(scale_mats[0])
        self.object_bbox_min = (inv @ object_scale_mat @ bbox_min[:, None])[:3, 0]
        self.object_bbox_max = (inv @ object_scale_mat @ bbox_max[:, None])[:3, 0]

    def _rays(self, img_idx: int, px: torch.Tensor, py: torch.Tensor):
        """World rays through pixels (px, py) of image ``img_idx``, +y pixel
        convention, no flip."""
        p = torch.stack([px, py, torch.ones_like(px)], -1)
        d = p @ self.intrinsics_all_inv[img_idx, :3, :3].t()
        d = d / d.norm(dim=-1, keepdim=True)
        rays_d = d @ self.poses[img_idx, :3, :3].t()
        return self.poses[img_idx, :3, 3].expand(rays_d.shape), rays_d

    def gen_rays_at(self, img_idx: int, resolution_level: float = 1):
        """Dense rays through the stored intrinsics at (H // level, W // level)
        over the full sensor (dataset.py:102-115)."""
        H, W = int(self.H // resolution_level), int(self.W // resolution_level)
        tx = torch.linspace(0.0, self.W - 1.0, W, device=self.device)
        ty = torch.linspace(0.0, self.H - 1.0, H, device=self.device)
        py, px = torch.meshgrid(ty, tx, indexing="ij")
        return self._rays(img_idx, px, py)

    def gen_random_rays_at(self, generator: torch.Generator, img_idx: int, batch_size: int):
        """Rays, colours and masks at ``batch_size`` pixels drawn from
        ``generator`` (a CPU generator; dataset.py:117-130)."""
        px = torch.randint(0, self.W, (batch_size,), generator=generator).to(self.device)
        py = torch.randint(0, self.H, (batch_size,), generator=generator).to(self.device)
        color = self.images[img_idx, py, px]
        mask = self.masks[img_idx, py, px][:, None]
        rays_o, rays_d = self._rays(img_idx, px.float(), py.float())
        return rays_o, rays_d, color, mask

    def near_far_from_sphere(self, rays_o, rays_d):
        """(dataset.py:165-171: near not clipped to 0 in the IDR variant)."""
        return cameras.near_far_from_sphere(rays_o, rays_d, clip_near=False)
