"""AvatarCLIP's sculpting step (AppearanceGen ``train_clip``) in plain
float32: the template body's hard render as the target, the silhouette
ray budget, the NeuS render of those rays with the step's background,
random relighting of the extra colour, the dense image with the target's
colour where no ray was cast, the photometric, eikonal, mask and CLIP
losses on the textured and the untextured image, the gradients, and Adam
under the warm-up and cosine schedule.

The step's random numbers come from a CPU torch.Generator in this order:
the ray order's shift, the background's choice, its noise image, the
checkerboard's cell count and blur, the light's two offsets, the ambience,
then the rays' stratified jitter."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import cameras, clip, neus, raster, smpl
from .adam import Adam
from .precision import F32, Precision


def lr_at(tc: dict, step: int) -> float:
    warm_end = float(tc["warm_up_end"])
    if step < warm_end and warm_end > 0:
        factor = step / warm_end
    else:
        progress = (step - warm_end) / max(tc["end_iter"] - warm_end, 1.0)
        a = tc["learning_rate_alpha"]
        factor = (math.cos(math.pi * progress) + 1.0) * 0.5 * (1 - a) + a
    return tc["learning_rate"] * factor


def template(body: dict, device) -> dict:
    """The body at the t-pose (global orientation pi/2 about x) in the NeuS
    world frame, its faces and smooth vertex normals."""
    pose = torch.zeros(1, 24, 3, device=device)
    pose[0, 0, 0] = math.pi / 2
    v = smpl.skin(body, pose)[0] @ torch.tensor(cameras.BODY_TO_WORLD, device=device).t()
    faces = body["faces"].long()
    return {"v": v, "f": faces, "n": raster.vertex_normals(v, faces)}


def coverage_table(tmpl: dict, focal: float, sensor: int, head_height: float):
    """Dilated-silhouette coverage of the template at 128^2 against the
    camera distance (12 distances, mean of 4 directions) and of the face
    camera."""
    Sc = 128
    fc = focal * Sc / sensor
    dil = max(1, round(10 * Sc / 256))
    dev = tmpl["v"].device

    def cov(eye, at):
        pose = torch.tensor(cameras.lookat_np(np.asarray(eye, np.float32), np.asarray(at, np.float32)),
                            device=dev)
        _, hit = raster.render_hard(tmpl["v"], tmpl["f"], pose, Sc, Sc, fc, tmpl["n"])
        return float(raster.dilate(hit, dil).float().mean())

    dists = np.linspace(0.35, 2.3, 12)
    dirs = ((0.0, 0.0), (np.pi / 3, 0.0), (2 * np.pi / 3, 0.0), (np.pi / 2, np.pi / 2))
    covs = [float(np.mean(np.float32([cov(cameras.sphere_coord_np(t, p, d), np.zeros(3)) for t, p in dirs])))
            for d in dists]
    at = np.array([0.0, head_height, 0.3], np.float32)
    face = float(np.mean(np.float32([cov(cameras.sphere_coord_np(t, 0.0, 0.4) + at, at)
                                     for t in (0.0, np.pi / 6)])))
    return dists, np.clip(np.float32(covs), 1e-3, 1.0), float(np.clip(np.float32(face), 1e-3, 1.0))


def pick_bucket(table, cam: dict, buckets, sensor: int, max_rays: int) -> int:
    dists, covs, face = table
    c = face if cam["face"] else float(np.interp(cam["distance"], dists, covs))
    s_star = min(float(sensor), np.sqrt(max_rays / max(c, 1e-3)))
    return min(buckets, key=lambda b: abs(np.log(b / s_star)))


def draw(gen: torch.Generator, S: int) -> dict:
    u = lambda lo, hi: lo + (hi - lo) * float(torch.rand((), generator=gen))
    return {"shift": int(torch.randint(0, S * S, (), generator=gen)),
            "choice": int(torch.randint(0, 4, (), generator=gen)),
            "noise": torch.randn((S, S, 1), generator=gen),
            "chess_n": int(torch.randint(10, 20, (), generator=gen)),
            "chess_sigma": u(0.1, 2.0), "light_dtheta": u(-np.pi / 4, np.pi / 4),
            "light_dphi": u(-np.pi / 4, np.pi / 4), "ambience": u(0.0, 0.2)}


def background(S: int, d: dict, device) -> torch.Tensor:
    """(S, S, 1): white, noise, a blurred checkerboard or black."""
    if d["choice"] == 0:
        return torch.ones(S, S, 1, device=device)
    if d["choice"] == 1:
        return (d["noise"].to(device) * 0.2 + 0.5).clamp(0.0, 1.0)
    if d["choice"] == 2:
        cell = max(S // d["chess_n"], 1)
        i = torch.arange(S, device=device)
        board = torch.where(((i[:, None] // cell + i[None, :] // cell) % 2) == 0, 0.8, 0.2).float()

        def kernel(n):
            x = torch.arange(n, dtype=torch.float32, device=device) - (n - 1) / 2.0
            k = torch.exp(-(x ** 2) / (2.0 * d["chess_sigma"] ** 2))
            return k / k.sum()

        out = F.conv2d(board[None, None], kernel(9).reshape(1, 1, 9, 1), padding=(4, 0))
        out = F.conv2d(out, kernel(5).reshape(1, 1, 1, 5), padding=(0, 2))
        return out[0, 0][..., None]
    return torch.zeros(S, S, 1, device=device)


class Sculpt:
    """The reference's sculpting run: ``step(it)`` takes one step from the
    current parameters and returns its loss."""

    def __init__(self, cfg: dict, params: dict, body: dict, clip_params, tokens, cam_seed: int,
                 gen: torch.Generator, focal: float, sensor: int, prec: Precision = F32):
        self.cfg, self.prec, self.gen = cfg, prec, gen
        self.tc = cfg["train"]
        if not (self.tc["add_no_texture"] and self.tc["texture_cast_light"] and self.tc["use_silhouettes"]
                and self.tc["use_bg_aug"] and self.tc["anneal_end"] == 0 and self.tc["mask_weight"] > 0):
            raise ValueError("the reference sculpts with the untextured view, the cast light, silhouette "
                             "rays, background augmentation, a mask loss and no cos annealing")
        self.params = {k: v.detach().clone().float().requires_grad_(True) for k, v in params.items()}
        self.opt = Adam(self.params)
        self.clip = clip_params
        self.cam_seed, self.focal, self.sensor = cam_seed, focal, sensor
        dev = self.params["variance.variance"].device
        self.tmpl = template(body, dev)
        self.buckets = tuple(sorted(self.tc["sil_buckets"]))
        self.table = coverage_table(self.tmpl, focal, sensor, self.tc["head_height"])
        with torch.no_grad():
            self.text = clip.encode_text(clip_params, tokens, cfg["clip"], prec)
        self.updates = 0

    def loss(self, it: int) -> torch.Tensor:
        tc, prec, dev = self.tc, self.prec, self.tmpl["v"].device
        cam = cameras.training_camera(self.cam_seed, it, tc["use_face_prompt"], tc["head_height"])
        S = pick_bucket(self.table, cam, self.buckets, self.sensor, tc["max_ray_num"])
        d = draw(self.gen, S)
        GT = tc["gt_render_res"]
        pose = torch.tensor(cam["pose"], device=dev)
        with torch.no_grad():
            gt, _ = raster.render_hard(self.tmpl["v"], self.tmpl["f"], pose, GT, GT,
                                       self.focal * GT / self.sensor, self.tmpl["n"])
            if GT != S:
                gt = clip.resize(gt[None], S)[0]
        mask_img = (gt.sum(-1) > 1e-6).float()
        R = min(tc["max_ray_num"], S * S)
        R = min((R + 7) // 8 * 8, S * S)
        rays_o, rays_d = cameras.grid_rays(pose, S, S, self.focal, self.sensor)
        idx = cameras.select_rays(raster.dilate(mask_img > 0.5, max(1, round(10 * S / 256))), R, d["shift"])
        rays_o, rays_d = rays_o[idx], rays_d[idx]
        near, far = cameras.near_far(rays_o, rays_d)
        bg = background(S, d, dev)
        t_in = torch.rand((R, 1), generator=self.gen).to(dev)
        out = neus.render(self.params, self.cfg["model"]["sdf_network"],
                          self.cfg["model"]["rendering_network"], self.cfg["model"]["neus_renderer"],
                          rays_o, rays_d, near, far, t_in, bg.reshape(-1, 1)[idx], 1.0, prec)
        mask = (mask_img.reshape(-1, 1) > 0.5).float()
        mask_sum = mask.sum() + 1e-5
        true_rgb = gt.reshape(-1, 3)
        light = cameras.sphere_dir(torch.tensor(cam["theta"] + d["light_dtheta"], device=dev),
                                   torch.tensor(cam["phi"] + d["light_dphi"], device=dev))
        if cam["face"]:
            text = self.text[1]
        elif tc["use_back_prompt"] and cam["is_front"] == 0:
            text = self.text[2]
        else:
            text = self.text[0]
        color, extra, ws = out["color"], out["extra_color"], out["weight_sum"].reshape(-1)
        n = out["normals_weighted"]
        n = n / (n.norm(dim=-1, keepdim=True) + 1e-7)
        shading = torch.nan_to_num((n * light).sum(-1, keepdim=True).clamp(0.0, 1.0), nan=1.0)
        amb = d["ambience"]
        lit = amb + (1.0 - amb) * shading
        low = (ws < 0.5)[:, None]
        untextured = torch.where(low, extra, lit.expand(-1, 3))
        textured = (extra * torch.where(low, torch.ones_like(lit), lit)).clamp(0.0, 1.0)
        if d["choice"] == 0:
            bg3 = torch.ones(S * S, 3, device=dev)
        elif d["choice"] == 3:
            bg3 = torch.zeros(S * S, 3, device=dev)
        else:
            bg3 = bg.reshape(-1, 1).expand(-1, 3)
        body = mask_img.reshape(-1, 1) > 0.5
        fill = torch.where(body, true_rgb, bg3)
        base = torch.cat([true_rgb, body.float(), fill, fill], 1)
        dense = base.index_copy(0, idx, torch.cat([color, ws[:, None], textured, untextured], 1))
        color_loss = ((dense[:, :3] - true_rgb) * mask).abs().sum() / mask_sum
        wsc = dense[:, 3:4].clamp(1e-3, 1.0 - 1e-3)
        mask_loss = (-(mask * torch.log(wsc) + (1 - mask) * torch.log(1 - wsc))).mean()
        size = int(self.cfg["clip"]["image_size"])
        imgs = torch.cat([clip.resize(dense[:, 4:7].reshape(1, S, S, 3), size),
                          clip.resize(dense[:, 7:10].reshape(1, S, S, 3), size)], 0)
        emb = clip.encode_image(self.clip, clip.normalize(imgs), self.cfg["clip"], prec)
        w = tc["clip_weight"]
        return (color_loss + out["gradient_error"] * tc["igr_weight"] + mask_loss * tc["mask_weight"]
                + (1.0 - clip.cosine(emb[0], text)) * w + (1.0 - clip.cosine(emb[1], text)) * w)

    def step(self, it: int) -> tuple[float, dict]:
        """(loss, gradients) of step ``it``, after which Adam has updated
        the parameters."""
        loss = self.loss(it)
        keys = list(self.params)
        grads = dict(zip(keys, torch.autograd.grad(loss, [self.params[k] for k in keys])))
        self.opt.step(grads, lr_at(self.tc, self.updates))
        self.updates += 1
        return float(loss.detach()), grads
