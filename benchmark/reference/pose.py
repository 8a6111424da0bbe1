"""AvatarAnimate's PoseOptimizer step (Hong et al. 2022,
pose_generation.py) in plain float32: the 63-d body pose (hands zero,
global orientation pi/2 about x) skinned by SMPL, soft-rendered from 5
views at azimuths 120, 150, ..., 240 degrees and the step's elevations,
encoded by CLIP, the views' mean embedding scored against the text
feature (loss 1 - cosine), and one Adam step on the pose.

Random numbers come from a CPU torch.Generator: the pose's initial value
(63 normals), then each step's 5 elevations (normals times 0.3)."""

from __future__ import annotations

import math

import torch

from . import cameras, clip, raster, smpl
from .adam import Adam
from .precision import F32, Precision

ANGLES = (120.0, 150.0, 180.0, 210.0, 240.0)


def render_views(body: dict, pose63: torch.Tensor, elevs: torch.Tensor, res: int, sigma: float):
    dev = pose63.device
    full = torch.cat([pose63, torch.zeros(6, device=dev)])
    pose = torch.cat([torch.tensor([math.pi / 2, 0.0, 0.0], device=dev), full]).reshape(1, 24, 3)
    v = smpl.skin(body, pose)[0] @ torch.tensor(cameras.BODY_TO_WORLD, device=dev).t()
    poses = cameras.view_poses(elevs, torch.tensor(ANGLES, device=dev))
    focal = cameras.focal_from_fov(res, math.radians(60.0))
    n = len(ANGLES)
    return raster.soft_render(v[None].expand(n, -1, -1), body["faces"].long(), poses, res, res,
                              focal, sigma)


class PoseRun:
    def __init__(self, cfg: dict, body: dict, clip_params, tokens, gen: torch.Generator,
                 device, prec: Precision = F32):
        self.cfg, self.body, self.clip, self.gen, self.prec = cfg, body, clip_params, gen, prec
        self.var = torch.randn(63, generator=gen).to(device).requires_grad_(True)
        self.opt = Adam({"pose": self.var})
        with torch.no_grad():
            self.text = clip.encode_text(clip_params, tokens, cfg["clip"], prec)[0]

    def step(self) -> tuple[float, dict]:
        pg = self.cfg["pose_generator"]
        elevs = (torch.randn(len(ANGLES), generator=self.gen) * float(pg["elevation_std"])).to(self.var.device)
        imgs = render_views(self.body, self.var, elevs, int(pg["render_res"]), float(pg["sigma"]))
        imgs = clip.resize(imgs, int(self.cfg["clip"]["image_size"]))
        emb = clip.encode_image(self.clip, clip.normalize(imgs), self.cfg["clip"], self.prec)
        loss = 1.0 - clip.cosine(emb.mean(0), self.text)
        (g,) = torch.autograd.grad(loss, [self.var])
        self.opt.step({"pose": g}, float(pg["lr"]))
        return float(loss.detach()), {"pose": g}
