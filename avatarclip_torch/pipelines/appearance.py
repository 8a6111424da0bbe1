"""AppearanceGen: CLIP-guided NeuS avatar sculpting in PyTorch.

Torch twin of avatarclip_tpu/pipelines/appearance.py: the same conf schema,
CLI and artifact layout, for the photometric ``train`` mode, the
CLIP-guided ``train_clip`` mode, and the validation modes (``validate_mesh``:
512^3 extraction, vertex-colour baking and the cast-light head render;
``render_geometry_cast_light``). One train_clip step: host-side camera,
GT template raster (CUDA z-buffer), silhouette ray selection, hierarchical
NeuS render (per-ray CUDA megakernel pair in render_core), relighting,
background augmentation, dense scatter, CLIP scoring, losses, backward and
the Adam update. The step's random draws come from the Runner's seeded
``torch.Generator`` as one explicit dict (``draw_clip``), the camera stream
from numpy exactly as in the JAX package.

Validation renders (``render_rays_chunked``) run ``neus.render`` with
``per_ray=False``: on the card at >= 128 wide that is the point-level NeuS
kernel pair followed by the compositing pair. The train loops validate every
``val_freq`` / ``val_mesh_freq`` steps, by default on one worker thread
against a snapshot of the fields (a bounded queue, drained at loop end).
Images are written with ``utils/png.write_png`` and meshes with
``export/mesh_io.write_ply``.

View interpolation: ``render_novel_image`` renders the camera between two
stored views (rotation by Slerp, centre linearly) through
``render_rays_chunked``, and ``interpolate_view`` writes 60 such frames and
their reversal at 30 fps as an MP4 with ``utils/mp4.write_mp4``.
``profile_trace`` writes a torch.profiler Chrome trace of a few train_clip
steps.

Data parallel (twin of the JAX Runner under a data mesh): ``Runner(mesh=)``
with a mesh of N > 1 ranks (parallel/mesh.py) draws every random number of
a step for the whole batch on every rank, renders its slice of the rays
(``neus.render(mesh=)``), gathers the per-ray outputs and computes the
dense scatter, the CLIP encode and the losses replicated; ``_backward``
sums the gradients over the ranks before Adam. Only rank 0 writes logs,
checkpoints and validations, and the others wait at a barrier while it
does. ``main`` builds the mesh when ``torchrun`` starts it (WORLD_SIZE >
1). With one rank the step is exactly the single-device one.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
import os
import re
import subprocess
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import assets
from .. import config as config_mod
from ..body import rotations
from ..clip import model as clip_model
from ..clip import tokenizer as clip_tokenizer
from ..export import marching_cubes as mc
from ..export import mesh_io
from ..fields import networks as nets
from ..parallel import mesh as pmesh
from ..render import cameras, neus, raster
from ..utils import device as device_mod
from ..utils import trace
from ..utils.logging import MetricsLogger
from ..utils.mp4 import write_mp4
from ..utils.png import write_png
from .dataset import SMPLViewDataset, sample_random_rays

# Full f32 everywhere: the K=3 raster dots (the 1e-3 px^2 face gate of
# raster._face_coefficients and the inside test, docs/VALIDATION.md:29-60),
# the winner barycentrics (raster._winner_outputs) and the gaussian blur of
# sample_background all decide on values near zero, and TF32 keeps ~3 digits
# (cuDNN runs f32 convolutions in TF32 unless told not to).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------


def build_network_configs(conf):
    dtype = conf.get_string("train.compute_dtype", "bfloat16")
    sdf_kw = conf["model.sdf_network"].as_dict()
    sdf_kw["skip_in"] = tuple(sdf_kw.get("skip_in", [4]))
    sdf_kw.setdefault("dtype", dtype)
    col_kw = conf["model.rendering_network"].as_dict()
    col_kw.setdefault("dtype", dtype)
    ncfg = neus.NeuSConfig(**conf["model.neus_renderer"].as_dict())
    return ncfg, nets.SDFConfig(**sdf_kw), nets.ColorConfig(**col_kw)


def nerf_config(conf) -> nets.NeRFConfig:
    """The conf's ``model.nerf`` block as a NeRFConfig. The Runner builds no
    NeRF (nor does the JAX package's, whose confs all set n_outside = 0): a
    caller that renders with n_outside > 0 passes it to NeuSFields."""
    kw = conf["model.nerf"].as_dict()
    kw["skips"] = tuple(kw.get("skips", [4]))
    return nets.NeRFConfig(**kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-4
    learning_rate_alpha: float = 0.05
    end_iter: int = 30000
    batch_size: int = 512
    max_ray_num: int = 112 * 112
    warm_up_end: float = 500.0
    anneal_end: float = 0.0
    use_white_bkgd: bool = False
    igr_weight: float = 0.1
    mask_weight: float = 0.5
    clip_weight: float | None = 1.0
    add_no_texture: bool = False
    texture_cast_light: bool = False
    use_face_prompt: bool = False
    use_back_prompt: bool = False
    use_silhouettes: bool = False
    use_bg_aug: bool = True
    head_height: float = 0.65
    save_freq: int = 1000
    report_freq: int = 100
    val_freq: int = 100
    val_mesh_freq: int = 500
    # pending async validations (running + queued) at most; on overflow the
    # oldest not-yet-started ones are cancelled (a fresher snapshot wins)
    val_queue_cap: int = 2
    validate_resolution_level: int = 1
    silhouette_res: int = 0  # 0 => derived from max_ray_num
    sil_buckets: Sequence[int] = ()
    gt_render_res: int = 0  # 0 => the selection resolution
    clip_stop_iter: int = 30010
    # periodic validations on a worker thread against a snapshot of the fields
    async_validation: bool = True

    @property
    def sil_res(self) -> int:
        if self.silhouette_res > 0:
            return self.silhouette_res
        s = int(np.sqrt(self.max_ray_num / 0.35))
        return int(np.clip((s + 7) // 8 * 8, 64, 256))


def train_config_from_conf(conf) -> TrainConfig:
    g = conf["train"]
    kw: dict[str, Any] = {}
    for f in dataclasses.fields(TrainConfig):
        if f.name == "clip_weight":
            kw[f.name] = g.get_float("clip_weight", None)
        elif f.name == "sil_buckets":
            if f.name in g:
                kw[f.name] = tuple(int(b) for b in g._resolve(f.name))
        elif f.name in g:
            kw[f.name] = g._resolve(f.name)
    return TrainConfig(**kw)


def make_lr_schedule(tc: TrainConfig):
    """Warm-up then cosine decay to alpha (main.py:577-586); evaluated at the
    0-based update count, as optax does."""

    def sched(step: int) -> float:
        warm = step / max(tc.warm_up_end, 1.0)
        progress = (step - tc.warm_up_end) / max(tc.end_iter - tc.warm_up_end, 1.0)
        alpha = tc.learning_rate_alpha
        cos = (math.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha
        factor = warm if (step < tc.warm_up_end and tc.warm_up_end > 0) else cos
        return tc.learning_rate * factor

    return sched


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def cos_anneal_ratio(tc: TrainConfig, it: int) -> float:
    if tc.anneal_end == 0.0:
        return 1.0
    return min(1.0, it / tc.anneal_end)


# ---------------------------------------------------------------------------
# background augmentation (main.py:387-405)
# ---------------------------------------------------------------------------


def _gaussian_blur(img: torch.Tensor, sigma: float, kx: int = 5, ky: int = 9) -> torch.Tensor:
    """Separable gaussian blur of (H, W, 1), zero 'SAME' padding."""

    def kernel(n):
        x = torch.arange(n, dtype=torch.float32, device=img.device) - (n - 1) / 2.0
        k = torch.exp(-(x**2) / (2.0 * sigma**2))
        return k / k.sum()

    out = img[..., 0][None, None]
    out = F.conv2d(out, kernel(ky).reshape(1, 1, ky, 1), padding=(ky // 2, 0))
    out = F.conv2d(out, kernel(kx).reshape(1, 1, 1, kx), padding=(0, kx // 2))
    return out[0, 0][..., None]


def sample_background(S: int, draws: dict, device) -> torch.Tensor:
    """(S, S, 1) background: white / gaussian noise / blurred checkerboard /
    black by ``draws["choice"]``."""
    choice = draws["choice"]
    if choice == 0:
        return torch.ones(S, S, 1, device=device)
    if choice == 1:
        return (draws["noise"].to(device) * 0.2 + 0.5).clamp(0.0, 1.0)
    if choice == 2:
        chess_len = max(S // draws["chess_n"], 1)
        i = torch.arange(S, device=device)
        board = ((i[:, None] // chess_len + i[None, :] // chess_len) % 2) == 0
        board = torch.where(board, 0.8, 0.2).float()
        return _gaussian_blur(board[..., None], draws["chess_sigma"])
    return torch.zeros(S, S, 1, device=device)


def load_reference_pth(path: str, fields: nets.NeuSFields) -> None:
    """Load a reference torch NeuS checkpoint (lin{i}.weight_g / weight_v /
    bias) into the fields; the extra head keeps its init when absent."""
    ck = torch.load(path, map_location="cpu", weights_only=False)

    def load_net(sd, net, extra=False):
        state = {}
        i = 0
        while f"lin{i}.bias" in sd:
            state[f"layers.{i}.g"] = sd[f"lin{i}.weight_g"]
            state[f"layers.{i}.v"] = sd[f"lin{i}.weight_v"]
            state[f"layers.{i}.b"] = sd[f"lin{i}.bias"]
            i += 1
        if extra and "extra_lin.bias" in sd:
            for k, src in (("g", "weight_g"), ("v", "weight_v"), ("b", "bias")):
                state[f"extra.{k}"] = sd[f"extra_lin.{src}"]
        net.load_state_dict(state, strict=False)

    load_net(ck["sdf_network_fine"], fields.sdf)
    load_net(ck["color_network_fine"], fields.color, extra=True)
    with torch.no_grad():
        fields.variance.variance.copy_(torch.as_tensor(ck["variance_network_fine"]["variance"]))


def save_reference_pth(path: str, fields: nets.NeuSFields) -> None:
    """Write weight-normed fields in the layout load_reference_pth reads."""

    def net_state(net):
        sd = {}
        for i, layer in enumerate(net.layers):
            sd[f"lin{i}.weight_g"], sd[f"lin{i}.weight_v"] = layer.g, layer.v
            sd[f"lin{i}.bias"] = layer.b
        if getattr(net, "extra", None) is not None:
            sd["extra_lin.weight_g"], sd["extra_lin.weight_v"] = net.extra.g, net.extra.v
            sd["extra_lin.bias"] = net.extra.b
        return {k: v.detach().cpu() for k, v in sd.items()}

    torch.save({"sdf_network_fine": net_state(fields.sdf),
                "color_network_fine": net_state(fields.color),
                "variance_network_fine": {"variance": fields.variance.variance.detach().cpu()}},
               path)


_CKPT_RE = re.compile(r"ckpt_(\d+)$")


def latest_checkpoint(base_dir: str, end_iter: int | None = None) -> str | None:
    ckpt_dir = os.path.join(base_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_it = None, -1
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m and (end_iter is None or int(m.group(1)) <= end_iter) and int(m.group(1)) > best_it:
            best, best_it = os.path.join(ckpt_dir, name), int(m.group(1))
    return best


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


class Runner:
    """``device``: the card (the default, ``"cuda"``), or the CPU only when
    asked for (``"cpu"``). Asking for CUDA without a card raises. ``mesh``:
    a data group (parallel/mesh.py) to train over; its device is the
    Runner's (a ``device`` that differs raises)."""

    def __init__(self, conf_path: str | None, mode: str = "train", case: str = "CASE_NAME",
                 is_continue: bool = False, conf=None, device=None,
                 mesh: pmesh.DataMesh | None = None):
        self.conf_path = conf_path
        self.conf = conf if conf is not None else config_mod.parse_file(conf_path, case=case)
        conf = self.conf
        if mesh is None:
            mesh = pmesh.single(device_mod.resolve(device, "Runner"))
        elif device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"Runner: device {device} is not the mesh's {mesh.device}")
        self.mesh = mesh
        self.device = mesh.device
        self.base_exp_dir = conf.get_string("general.base_exp_dir")
        os.makedirs(self.base_exp_dir, exist_ok=True)
        self.dataset = SMPLViewDataset(conf["dataset"], self.device)
        self.iter_step = 0
        self.mode = mode
        self.tc = train_config_from_conf(conf)
        self.ncfg, sdf_cfg, col_cfg = build_network_configs(conf)
        self.extra_color = col_cfg.extra_color

        seed = conf.get_int("train.seed", 0) or 0
        self.gen = torch.Generator().manual_seed(seed)  # every draw of a step
        self._camera_seed = seed  # the host-side camera stream (numpy)
        self.pose_type = conf.get_string("general.pose_type", "stand_pose")
        if self.pose_type not in ("stand_pose", "t_pose"):
            raise ValueError(f"general.pose_type must be stand_pose or t_pose, got {self.pose_type}")

        init_val = conf.get_float("model.variance_network.init_val")
        self.fields = nets.NeuSFields(sdf_cfg, col_cfg, init_val, self.gen).to(self.device)
        self.lr_schedule = make_lr_schedule(self.tc)
        self.optimizer = torch.optim.Adam(self.fields.parameters(), lr=0.0, eps=1e-8)
        self.update_count = 0  # optax's count: the schedule's argument

        pretrain = conf.get_string("train.pretrain", None)
        if pretrain is not None:
            path = pretrain
            if not os.path.exists(path) and assets.find(os.path.basename(path)):
                path = assets.find(os.path.basename(path))
            if path and os.path.exists(path):
                print(f"Load pretrain: {path}")
                if path.endswith(".pth"):
                    load_reference_pth(path, self.fields)
                else:  # a JAX pytree npz (keys params/sdf/layers/0/g, ...)
                    from ..utils.convert import params_from_jax

                    with np.load(path) as data:
                        params_from_jax(dict(data), self.fields, prefix="params/")
                self.fields.to(self.device)

        if is_continue:
            latest = latest_checkpoint(self.base_exp_dir, self.tc.end_iter)
            if latest is not None:
                print(f"Find checkpoint: {latest}")
                self.load_checkpoint(latest)
        pmesh.broadcast_(self.fields.parameters(), self.mesh)  # the replicas start equal

        self.logger = None
        self._clip = None
        self._template = None
        self.step_seconds: list[float] = []  # wall time of each step, synchronised
        self.step_sil_res: list[int] = []  # silhouette bucket of each train_clip step
        self._val_futures: list = []
        self._val_dropped = 0
        self.val_seconds: list[tuple[str, int, float]] = []  # (name, iter, s), synchronised
        if mode.startswith("train") and self.mesh.writer:
            self.file_backup()

    # -- setup ------------------------------------------------------------

    def init_clip(self):
        """Load CLIP and encode the prompts once (main.py:258-288)."""
        model_name = self.conf.get_string("clip.model", "vit_b32")
        if model_name == "tiny":
            cfg = clip_model.TINY
            params, pretrained = clip_model.init_params(cfg, torch.Generator().manual_seed(42)), False
        else:
            params, pretrained = clip_model.load_pretrained()
            cdt = self.conf.get_string("train.compute_dtype", "bfloat16")
            cfg = dataclasses.replace(clip_model.VIT_B32, compute_dtype=cdt)
            if not pretrained:
                print("WARNING: no pretrained CLIP weights found (place clip_vit_b32.npz in "
                      "the data dir); using random init — CLIP guidance will be meaningless.")
        params = clip_model.tree_to(params, self.device)
        prompts = [self.conf.get_string("clip.prompt")]
        prompts.append(self.conf.get_string("clip.face_prompt", prompts[0])
                       if self.tc.use_face_prompt else prompts[0])
        prompts.append(self.conf.get_string("clip.back_prompt", prompts[0])
                       if self.tc.use_back_prompt else prompts[0])
        print(f"Prompt: {prompts[0]}")
        toks = torch.from_numpy(clip_tokenizer.tokenize(prompts)).to(self.device)
        with torch.no_grad():
            self._encoded_texts = clip_model.encode_text(params, cfg, toks)
        self._clip = (params, cfg)
        self._clip_pretrained = bool(pretrained)

    def init_smpl(self):
        """Pose the template body into the NeuS world frame (main.py:290-335)."""
        from ..export import mesh_io

        template_obj = self.conf.get_string("dataset.template_obj", None)
        model = assets.load_smpl(self.conf.get_string("general.smpl_model_path", None))
        pose = assets.load_stand_pose() if self.pose_type == "stand_pose" else assets.t_pose()
        pose_rot = rotations.rodrigues(torch.from_numpy(np.asarray(pose)).reshape(-1, 3))
        pose_rot = pose_rot.reshape(1, 24, 3, 3)
        if template_obj is not None and not os.path.exists(template_obj):
            template_obj = assets.find(os.path.basename(template_obj)) or template_obj
        v_shaped = None
        if template_obj is not None and os.path.exists(template_obj):
            v, _, _, _ = mesh_io.read_obj(template_obj)
            v_shaped = torch.from_numpy(np.asarray(v, np.float32)).reshape(1, -1, 3)
        verts, _ = model.forward(v_shaped=v_shaped, body_pose=pose_rot[:, 1:],
                                 global_orient=pose_rot[:, :1], pose2rot=False)
        v_world = (verts[0] @ torch.from_numpy(cameras.BODY_TO_WORLD).t()).to(self.device)
        faces = torch.from_numpy(np.asarray(model.faces, np.int64)).to(self.device)
        self._template = (v_world, faces)
        self._template_normals = raster.vertex_normals(v_world, faces)
        self._template_face_normals = self._template_normals[faces]

    # -- random draws of one step ------------------------------------------

    def _uniform(self, lo: float, hi: float) -> float:
        return lo + (hi - lo) * float(torch.rand((), generator=self.gen))

    def draw_clip(self, S: int) -> dict:
        """Every random draw of one train_clip step (main.py:375-453)."""
        g = self.gen
        with trace.span("loop.draws"):
            return {
                "shift": int(torch.randint(0, S * S, (), generator=g)),
                "choice": int(torch.randint(0, 4, (), generator=g)) if self.tc.use_bg_aug else 3,
                "noise": torch.randn((S, S, 1), generator=g),
                "chess_n": int(torch.randint(10, 20, (), generator=g)),
                "chess_sigma": self._uniform(0.1, 2.0),
                "light_dtheta": self._uniform(-np.pi / 4, np.pi / 4),
                "light_dphi": self._uniform(-np.pi / 4, np.pi / 4),
                "ambience": self._uniform(0.0, 0.2),
            }

    def draw_photometric(self) -> dict:
        g, ds, B = self.gen, self.dataset, self.tc.batch_size
        return {
            "img_idx": int(torch.randint(0, ds.n_images, (), generator=g)),
            "px": torch.randint(0, ds.W, (B,), generator=g),
            "py": torch.randint(0, ds.H, (B,), generator=g),
        }

    # -- losses -----------------------------------------------------------

    def photometric_loss(self, draws: dict, it: int):
        """Photometric NeuS loss on random pixels of one stored view
        (main.py:345-380 of the reference's train mode)."""
        tc, ds, dev = self.tc, self.dataset, self.device
        rays_o, rays_d, true_rgb, mask = sample_random_rays(
            ds.images, ds.masks, ds.poses, ds.focal, draws["img_idx"],
            draws["px"].to(dev), draws["py"].to(dev),
        )
        near, far = ds.near_far_from_sphere(rays_o, rays_d)
        background_rgb = torch.ones(1, 3, device=dev) if tc.use_white_bkgd else None
        mask = (mask > 0.5).float() if tc.mask_weight > 0.0 else torch.ones_like(mask)
        mask_sum = mask.sum() + 1e-5
        out = neus.render(self.fields, self.ncfg, rays_o, rays_d, near, far,
                          generator=self.gen, background_rgb=background_rgb,
                          cos_anneal_ratio=cos_anneal_ratio(tc, it), per_ray=True,
                          mesh=self.mesh)
        color_fine = out["color_fine"]
        color_loss = ((color_fine - true_rgb) * mask).abs().sum() / mask_sum
        psnr = 20.0 * torch.log10(
            1.0 / torch.sqrt(((color_fine - true_rgb) ** 2 * mask).sum() / (mask_sum * 3.0))
        )
        eikonal_loss = out["gradient_error"]
        ws = out["weight_sum"].clamp(1e-3, 1.0 - 1e-3)
        mask_loss = (-(mask * torch.log(ws) + (1 - mask) * torch.log(1 - ws))).mean()
        loss = color_loss + eikonal_loss * tc.igr_weight + mask_loss * tc.mask_weight
        metrics = {"loss": loss, "color_loss": color_loss, "eikonal_loss": eikonal_loss,
                   "mask_loss": mask_loss, "psnr": psnr, "s_val": out["s_val"].mean()}
        return loss, {k: v.detach() for k, v in metrics.items()}

    def clip_loss(self, S: int, cam: dict, draws: dict, it: int):
        """The train_clip loss at silhouette / ray-grid resolution ``S``."""
        tc, ncfg, ds, dev = self.tc, self.ncfg, self.dataset, self.device
        clip_params, clip_cfg = self._clip
        template_v, template_f = self._template
        GT = tc.gt_render_res or S
        SENSOR = ds.W
        R = min(tc.max_ray_num, S * S) if tc.use_silhouettes else S * S
        R = min((R + 7) // 8 * 8, S * S)
        dil_iters = max(1, round(10 * S / 256))
        focal = ds.focal

        with trace.span("render.gt_raster"), torch.no_grad():  # GT template render (main.py:360)
            pose = torch.as_tensor(cam["pose"], dtype=torch.float32, device=dev)
            gt = raster.render_mesh(
                template_v, template_f, pose, GT, GT, focal * GT / SENSOR,
                normals=self._template_normals, face_normals=self._template_face_normals,
            )
            gt_rgb = gt["rgb"] if GT == S else clip_model.resize_image(gt["rgb"][None], S, S)[0]

        with trace.span("render.rays"):
            mask_img = (gt_rgb.sum(-1) > 1e-6).float()
            rays_o_g, rays_d_g = cameras.pixel_grid_rays(pose, S, S, focal, SENSOR, SENSOR)
            if tc.use_silhouettes:
                idx, _, _ = cameras.select_silhouette_rays(mask_img > 0.5, R, dil_iters,
                                                           draws["shift"])
            else:
                idx = torch.arange(R, device=dev)
            rays_o = rays_o_g.reshape(-1, 3)[idx]
            rays_d = rays_d_g.reshape(-1, 3)[idx]
            near, far = cameras.near_far_from_sphere(rays_o, rays_d)

            bg_img = sample_background(S, draws, dev)
            bg_rays = bg_img.reshape(-1, 1)[idx]
            mask = mask_img.reshape(-1, 1)
            mask = (mask > 0.5).float() if tc.mask_weight > 0.0 else torch.ones_like(mask)
            mask_sum = mask.sum() + 1e-5
            true_rgb = gt_rgb.reshape(-1, 3)

            light_theta = torch.tensor(float(cam["theta"]) + draws["light_dtheta"], device=dev)
            light_phi = torch.tensor(float(cam["phi"]) + draws["light_dphi"], device=dev)
            light_dir = cameras.sphere_coord(light_theta, light_phi)
        ambience = draws["ambience"]
        if cam["face_iter"]:
            text_idx = 1
        elif tc.use_back_prompt and int(cam["is_front"]) == 0:
            text_idx = 2
        else:
            text_idx = 0
        text_emb = self._encoded_texts[text_idx]

        out = neus.render(self.fields, ncfg, rays_o, rays_d, near, far, generator=self.gen,
                          background_rgb=bg_rays, cos_anneal_ratio=cos_anneal_ratio(tc, it),
                          per_ray=True, mesh=self.mesh)

        with trace.span("render.shade"):
            color_fine = out["color_fine"]
            extra = out["extra_color_fine"] if self.extra_color else color_fine
            ws = out["weight_sum"].reshape(-1)

            normals = out.get("normals_weighted")
            if normals is None:
                n_total = ncfg.n_samples + ncfg.n_importance
                normals = (out["gradients"] * out["weights"][:, :n_total, None]).sum(1)
            normals = normals / (normals.norm(dim=-1, keepdim=True) + 1e-7)
            shading = (normals * light_dir).sum(-1, keepdim=True).clamp(0.0, 1.0)
            shading = torch.nan_to_num(shading, nan=1.0)
            rand_shading = ambience + (1.0 - ambience) * shading
            lowws = (ws < 0.5)[:, None]
            shading_rgb = torch.where(lowws, extra, rand_shading.expand(-1, 3))
            rand_shading_full = torch.where(lowws, torch.ones_like(rand_shading), rand_shading)
            texture_shading = (extra * rand_shading_full).clamp(0.0, 1.0)

            # dense scatter (main.py:461-487); unrendered body pixels take the GT
            # colour so the CLIP images have no holes and the losses see only
            # rendered pixels
            choice = draws["choice"]
            if choice == 0:
                bg3 = torch.ones(S * S, 3, device=dev)
            elif choice == 3:
                bg3 = torch.zeros(S * S, 3, device=dev)
            else:
                bg3 = bg_img.reshape(-1, 1).expand(-1, 3)
            body = mask_img.reshape(-1, 1) > 0.5
            clip_fill = torch.where(body, true_rgb, bg3)
            chans = [
                (color_fine, true_rgb),
                (ws[:, None], body.float()),
                (texture_shading if tc.texture_cast_light else extra, clip_fill),
            ]
            if tc.add_no_texture:
                chans.append((shading_rgb, clip_fill))
            dense = torch.cat([f for _, f in chans], 1).index_copy(
                0, idx, torch.cat([v for v, _ in chans], 1)
            )
            color_dense, ws_dense, clip_src = dense[:, 0:3], dense[:, 3:4], dense[:, 4:7]

            color_loss = ((color_dense - true_rgb) * mask).abs().sum() / mask_sum
            psnr = 20.0 * torch.log10(
                1.0 / torch.sqrt(((color_dense - true_rgb) ** 2 * mask).sum() / (mask_sum * 3.0))
            )
            eikonal_loss = out["gradient_error"]
            wsc = ws_dense.clamp(1e-3, 1.0 - 1e-3)
            mask_loss = (-(mask * torch.log(wsc) + (1 - mask) * torch.log(1 - wsc))).mean()

        with trace.span("clip.image"):
            # both CLIP views ride one batch-2 ViT forward
            clip_in = clip_model.resize_to_clip(clip_src.reshape(1, S, S, 3), clip_cfg.image_size)
            if tc.add_no_texture:
                shade_in = clip_model.resize_to_clip(dense[:, 7:10].reshape(1, S, S, 3),
                                                     clip_cfg.image_size)
                clip_in = torch.cat([clip_in, shade_in], 0)
            emb = clip_model.encode_image_graphed(clip_params, clip_cfg, clip_in)
            cosine = clip_model.cosine_similarity(emb[0], text_emb)
            clip_w = tc.clip_weight or 0.0
            loss = (color_loss + eikonal_loss * tc.igr_weight + mask_loss * tc.mask_weight
                    + (1.0 - cosine) * clip_w)
            metrics = {"color_loss": color_loss, "eikonal_loss": eikonal_loss,
                       "mask_loss": mask_loss, "cosine": cosine, "psnr": psnr,
                       "s_val": out["s_val"].mean()}
            if tc.add_no_texture:
                cosine_shading = clip_model.cosine_similarity(emb[1], text_emb)
                loss = loss + (1.0 - cosine_shading) * clip_w
                metrics["cosine_shading"] = cosine_shading
            metrics["loss"] = loss
        return loss, {k: v.detach() for k, v in metrics.items()}

    def _clip_update(self, S: int, cam: dict, it: int) -> dict:
        """One train_clip step's loss, backward and Adam update at bucket S;
        the step's metrics."""
        loss, metrics = self.clip_loss(S, cam, self.draw_clip(S), it)
        self._update(loss)
        return metrics

    def _update(self, loss: torch.Tensor) -> None:
        """Backward and one Adam update at lr = schedule(update count)."""
        self._backward(loss)
        self._step()

    def _backward(self, loss: torch.Tensor) -> None:
        """The parameters' gradients of ``loss``, summed over the mesh's ranks."""
        with trace.span("backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            pmesh.all_reduce_grads(self.fields.parameters(), self.mesh)

    def _step(self) -> None:
        """One Adam update at lr = schedule(update count)."""
        with trace.span("loop.adam"):
            lr = self.lr_schedule(self.update_count)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.update_count += 1

    # -- silhouette-resolution buckets ----------------------------------------

    def _calibrate_sil_coverage(self):
        """Dilated-mask coverage of the GT template vs camera distance (mean
        over four view directions) and for the face camera, at 128^2."""
        tc, ds = self.tc, self.dataset
        template_v, template_f = self._template
        Sc = 128
        focal_c = ds.focal * Sc / ds.W
        dil_c = max(1, round(10 * Sc / 256))

        def cov_at(eye, at):
            pose = torch.from_numpy(cameras.lookat_np(
                np.asarray(eye, np.float32), np.asarray(at, np.float32),
                np.array([0.0, 1.0, 0.0], np.float32),
            )).to(self.device)
            with torch.no_grad():
                out = raster.render_mesh(template_v, template_f, pose, Sc, Sc, focal_c,
                                         normals=self._template_normals)
                return cameras.dilate_mask(out["rgb"].sum(-1) > 1e-6, dil_c).float().mean()

        dists = np.linspace(0.35, 2.3, 12)
        dirs = ((0.0, 0.0), (np.pi / 3, 0.0), (2 * np.pi / 3, 0.0), (np.pi / 2, np.pi / 2))
        covs = [torch.stack([cov_at(cameras.sphere_coord_np(t, p, d), np.zeros(3))
                             for t, p in dirs]).mean() for d in dists]
        at_f = np.array([0.0, tc.head_height, 0.3], np.float32)
        face = torch.stack([cov_at(cameras.sphere_coord_np(t, 0.0, 0.4) + at_f, at_f)
                            for t in (0.0, np.pi / 6)]).mean()
        covs = torch.stack(covs + [face]).cpu().numpy()  # one host sync
        self._sil_cov_table = (dists, np.clip(covs[:-1], 1e-3, 1.0))
        self._sil_cov_face = float(np.clip(covs[-1], 1e-3, 1.0))

    def _pick_sil_bucket(self, buckets, cam):
        """Bucket closest (in log space) to W = min(sensor, sqrt(max_ray_num /
        coverage)) (dataset.py:258)."""
        if cam["face_iter"]:
            c = self._sil_cov_face
        else:
            dists, covs = self._sil_cov_table
            c = float(np.interp(cam["distance"], dists, covs))
        s_star = min(float(self.dataset.W), np.sqrt(self.tc.max_ray_num / max(c, 1e-3)))
        return min(buckets, key=lambda b: abs(np.log(b / s_star)))

    def sample_iteration_camera(self, it: int, buckets=None):
        """Host-side camera + bucket of iteration ``it`` (seeded
        np.random.default_rng([seed, it]), face camera every 4th iteration);
        its span, the step's first, notes the bucket and the camera's kind."""
        tc = self.tc
        with trace.span("loop.camera", it) as sp:
            if buckets is None:
                buckets = tuple(sorted(tc.sil_buckets)) or (tc.sil_res,)
            face_iter = bool(tc.use_face_prompt) and (it % 4 == 0)
            rng = np.random.default_rng([self._camera_seed, it])
            cam = cameras.sample_training_camera(rng, face_iter, tc.head_height)
            if len(buckets) > 1:
                if not hasattr(self, "_sil_cov_table"):
                    self._calibrate_sil_coverage()
                S = self._pick_sil_bucket(buckets, cam)
            else:
                S = buckets[0]
            if sp is not trace.NULL:
                sp.note(S=S, face=face_iter)
        return cam, S

    # -- train loops --------------------------------------------------------

    def _timed(self, fn):
        t0 = time.perf_counter()
        with trace.span("loop.step", self.iter_step):
            metrics = fn()
        with trace.span("loop.sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.step_seconds.append(time.perf_counter() - t0)
        return metrics

    def _open_logger(self):
        if self.mesh.writer:
            self.logger = MetricsLogger(os.path.join(self.base_exp_dir, "logs"))

    def _close_logger(self):
        if self.logger is not None:
            self.logger.close()

    def train(self):
        self._open_logger()

        def step():
            loss, metrics = self.photometric_loss(self.draw_photometric(), self.iter_step)
            self._update(loss)
            return metrics

        for _ in range(self.tc.end_iter - self.iter_step):
            metrics = self._timed(step)
            self.iter_step += 1
            self._post_iter(metrics)
        self._drain_validations()
        self._close_logger()

    def train_clip(self):
        self._open_logger()
        if self._clip is None:
            self.init_clip()
        if self._template is None:
            self.init_smpl()
        tc = self.tc
        buckets = tuple(sorted(tc.sil_buckets)) or (tc.sil_res,)
        if len(buckets) > 1 and min(buckets) ** 2 < tc.max_ray_num:
            raise ValueError(f"every sil bucket must hold the full ray budget: "
                             f"{min(buckets)}^2 < {tc.max_ray_num}")
        for i in range(tc.end_iter - self.iter_step):
            if i == tc.clip_stop_iter:
                break
            cam, S = self.sample_iteration_camera(self.iter_step, buckets)
            self.step_sil_res.append(S)
            metrics = self._timed(lambda: self._clip_update(S, cam, self.iter_step))
            self.iter_step += 1
            self._post_iter(metrics)
        self._drain_validations()
        self._close_logger()

    def profile_trace(self, out_dir: str, n_iters: int = 3) -> str:
        """A torch.profiler trace of ``n_iters`` train_clip steps (iterations
        1..n_iters; each the ``loop.camera`` and ``loop.step`` spans, the
        step's layers nested in the latter, utils/trace.py), after one warm-up
        step (iteration 0) outside the window, synchronised at both ends;
        written as the Chrome trace ``out_dir/trace.json``. Shapes and stacks
        are not recorded. The fields, the optimizer and the update count are
        restored afterwards, as JAX's functional steps leave the Runner's
        parameters as they were; the step draws advance the generator, as
        JAX's split advances its key."""
        from torch.profiler import ProfilerActivity, profile

        if self._clip is None:
            self.init_clip()
        if self._template is None:
            self.init_smpl()
        tc = self.tc
        buckets = tuple(sorted(tc.sil_buckets)) or (tc.sil_res,)
        saved = (copy.deepcopy(self.fields.state_dict()),
                 copy.deepcopy(self.optimizer.state_dict()), self.update_count)

        def step(it):
            cam, S = self.sample_iteration_camera(it, buckets)
            with trace.span("loop.step", it):
                self._clip_update(S, cam, it)

        step(0)
        device_mod.sync(self.device)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities, record_shapes=False, with_stack=False) as prof:
            for i in range(n_iters):
                step(i + 1)
            device_mod.sync(self.device)
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        self.fields.load_state_dict(saved[0])
        self.optimizer.load_state_dict(saved[1])
        self.update_count = saved[2]
        return out_dir

    def _post_iter(self, metrics):
        """Rank 0's logs, report, checkpoint and validations of iteration
        iter_step; the other ranks wait at a barrier while it writes."""
        it, tc = self.iter_step, self.tc
        writes = it % tc.save_freq == 0 or it % tc.val_freq == 0 or it % tc.val_mesh_freq == 0
        if self.mesh.writer:
            self._write_iter(metrics)
        if writes:
            pmesh.barrier(self.mesh)

    def _write_iter(self, metrics):
        it, tc = self.iter_step, self.tc
        if self.logger is not None and (it % 10 == 0 or it < 10):
            self.logger.log(it, {k: float(v) for k, v in metrics.items()})
        if it % tc.report_freq == 0:
            m = {k: float(v) for k, v in metrics.items()}
            extra = "".join(f" {k}={m[k]:.4f}" for k in ("cosine", "cosine_shading", "psnr")
                            if k in m)
            print(f"iter:{it:8d} loss = {m.get('loss', 0):.4f}{extra} "
                  f"lr={self.lr_schedule(self.update_count):.6f}")
        if it % tc.save_freq == 0:
            self.save_checkpoint()
        if it % tc.val_freq == 0:
            self._submit_validation(self.validate_image,
                                    idx=58 if self.mode == "train_clip" else -1)
        if it % tc.val_mesh_freq == 0:
            self._submit_validation(self.validate_mesh)

    # -- asynchronous validation (appearance.py:1100-1161) --------------------
    #
    # With tc.async_validation the periodic validations run on one worker
    # thread against a snapshot of the fields, so the host side of a
    # validation (marching cubes, PNG / PLY encoding) overlaps training. Adam
    # updates the fields in place, so the snapshot is a deep copy on the
    # device, taken at submission. The queue is bounded at tc.val_queue_cap:
    # the oldest not-yet-started validations are cancelled (counted in
    # _val_dropped); worker exceptions re-raise at the next submission or at
    # the drain that ends each train loop.

    @functools.cached_property
    def _val_executor(self):
        from concurrent.futures import ThreadPoolExecutor

        def deprioritize():
            # the train loop's dispatch thread keeps the core
            try:
                os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
            except (OSError, AttributeError):
                pass

        return ThreadPoolExecutor(max_workers=1, thread_name_prefix="val",
                                  initializer=deprioritize)

    def _run_validation(self, fn, kw):
        t0 = time.perf_counter()
        with torch.no_grad():  # grad mode is per thread
            fn(**kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.val_seconds.append((fn.__name__, kw.get("it", self.iter_step),
                                 time.perf_counter() - t0))

    def _submit_validation(self, fn, **kw):
        if not self.tc.async_validation:
            self._run_validation(fn, kw)
            return
        kw.setdefault("fields", copy.deepcopy(self.fields))
        kw.setdefault("it", self.iter_step)
        pending = []
        for f in self._val_futures:
            if f.done():
                if not f.cancelled() and f.exception() is not None:
                    raise f.exception()
            else:
                pending.append(f)
        self._val_futures = pending
        self._val_futures.append(self._val_executor.submit(self._run_validation, fn, kw))
        cap = max(1, self.tc.val_queue_cap)
        i = 0
        while len(self._val_futures) > cap and i < len(self._val_futures) - 1:
            if self._val_futures[i].cancel():
                self._val_futures.pop(i)
                self._val_dropped += 1
            else:
                i += 1

    def _drain_validations(self):
        futs, self._val_futures = self._val_futures, []
        for f in futs:
            if not f.cancelled():
                f.result()  # re-raises worker exceptions
        if self._val_dropped:
            print(f"[val] decimated {self._val_dropped} stale pending validation(s) "
                  f"(val_queue_cap={self.tc.val_queue_cap})")
            self._val_dropped = 0

    # -- validation / extraction (appearance.py:1193-1433) ---------------------

    def _render_chunk(self, fields, rays_o, rays_d, background_rgb):
        """One validation chunk (appearance.py:1197-1218): the render without
        jitter at cos_anneal_ratio 1, plus the per-ray depth and weighted
        normal sums (with and without the inside-sphere mask)."""
        near, far = cameras.near_far_from_sphere(rays_o, rays_d)
        out = neus.render(fields, self.ncfg, rays_o, rays_d, near, far, generator=None,
                          background_rgb=background_rgb, cos_anneal_ratio=1.0)
        S = self.ncfg.n_samples + self.ncfg.n_importance
        w = out["weights"][:, :S]
        out["depth"] = (out["mid_z_vals"][:, :S] * w).sum(1)
        out["normal_map"] = (out["gradients"] * w[..., None]
                             * out["inside_sphere"][..., None]).sum(1)
        out["normal_map_nomask"] = (out["gradients"] * w[..., None]).sum(1)
        return out

    def render_rays_chunked(self, rays_o, rays_d, background_rgb=None, keys=None, chunk=None,
                            fields=None):
        """Render N rays in chunks of max(batch_size, 16384) (the kernels take
        any ray count, so the last chunk is not padded); returns a numpy dict
        of the requested keys, gathered on the host once at the end."""
        keys = keys or ["color_fine", "extra_color_fine"]
        chunk = chunk or max(self.tc.batch_size, 16384)
        fields = self.fields if fields is None else fields
        outs: dict[str, list] = {k: [] for k in keys}
        with torch.no_grad():
            for start in range(0, rays_o.shape[0], chunk):
                out = self._render_chunk(fields, rays_o[start:start + chunk],
                                         rays_d[start:start + chunk], background_rgb)
                for k in keys:
                    outs[k].append(None if out[k] is None else out[k].detach())
        return {k: None if v[0] is None else torch.cat(v, 0).float().cpu().numpy()
                for k, v in outs.items()}

    def validate_image(self, idx: int = -1, resolution_level: int = -1, fields=None, it=None):
        """Render stored camera ``idx`` (numpy's global RNG picks one when
        negative) and write the colour, extra-colour and normal PNGs
        (main.py:760-820)."""
        if idx < 0:
            idx = int(np.random.randint(self.dataset.n_images))
        if resolution_level < 0:
            resolution_level = self.tc.validate_resolution_level
        it = self.iter_step if it is None else it
        print(f"Validate: iter: {it}, camera: {idx}")
        rays_o, rays_d = self.dataset.gen_rays_at(idx, resolution_level)
        H, W = rays_o.shape[0], rays_o.shape[1]
        bg = torch.ones(1, 3, device=self.device) if self.tc.use_white_bkgd else None
        out = self.render_rays_chunked(rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), bg,
                                       keys=["color_fine", "extra_color_fine", "normal_map"],
                                       fields=fields)
        name = f"{it:08d}_0_{idx}.png"
        for sub in ("validations_fine", "validations_extra_fine", "normals"):
            os.makedirs(os.path.join(self.base_exp_dir, sub), exist_ok=True)
        img = to8b(out["color_fine"].reshape(H, W, 3))
        # the dataset view below the render, as the reference does (main.py:806-810)
        lvl = max(1, resolution_level)
        gt = self.dataset.images[idx].cpu().numpy()[::lvl, ::lvl]
        img = np.concatenate([img, to8b(gt[:img.shape[0], :img.shape[1]])], axis=0)
        write_png(os.path.join(self.base_exp_dir, "validations_fine", name), img)
        if out["extra_color_fine"] is not None:
            write_png(os.path.join(self.base_exp_dir, "validations_extra_fine", name),
                      to8b(out["extra_color_fine"].reshape(H, W, 3)))
        # normal map in the camera frame (main.py:777-798)
        rot = np.linalg.inv(self.dataset.poses[idx][:3, :3].cpu().numpy())
        normals = (rot[None] @ out["normal_map"][..., None])[..., 0].reshape(H, W, 3)
        write_png(os.path.join(self.base_exp_dir, "normals", name),
                  np.clip(normals * 128 + 128, 0, 255).astype(np.uint8))

    def validate_mesh(self, world_space: bool = False, resolution: int = 256,
                      threshold: float = 0.0, fields=None, it=None):
        """Extract, colour-bake and export the mesh (main.py:850-919) as
        meshes/{it:08d}.ply. ``world_space`` is a no-op for the SMPL dataset,
        which has no scale mats (as in the JAX package)."""
        fields = self.fields if fields is None else fields
        it = self.iter_step if it is None else it

        def query(pts):
            return -nets.sdf_value(fields.sdf, pts)[..., 0]

        vertices, triangles = mc.extract_geometry(
            self.dataset.object_bbox_min, self.dataset.object_bbox_max, resolution=resolution,
            threshold=threshold, query_fn=query, device=self.device,
        )
        os.makedirs(os.path.join(self.base_exp_dir, "meshes"), exist_ok=True)
        rgb_final, _ = self._bake_vertex_colors(vertices, fields)
        mesh_io.write_ply(os.path.join(self.base_exp_dir, "meshes", f"{it:08d}.ply"),
                          vertices, triangles, vertex_colors=to8b(rgb_final))
        return vertices, triangles, rgb_final

    def _bake_vertex_colors(self, vertices: np.ndarray, fields=None):
        """6-axis ray shooting with the depth-consistency pick (main.py:858-913)."""
        origins = [[0, 0, 2], [0, 0, -2], [0, 2, 0], [0, -2, 0], [2, 0, 0], [-2, 0, 0]]
        rgb_final = diff_final = None
        verts = torch.from_numpy(np.asarray(vertices, np.float32)).to(self.device)
        for o in origins:
            rays_o = torch.tensor(o, dtype=torch.float32, device=self.device).expand_as(verts)
            rays_d = verts - rays_o
            dist = rays_d.norm(dim=-1)
            rays_d = rays_d / dist[:, None]
            out = self.render_rays_chunked(rays_o, rays_d, None,
                                           keys=["color_fine", "extra_color_fine", "depth"],
                                           fields=fields)
            color = (out["extra_color_fine"] if self.extra_color
                     and out["extra_color_fine"] is not None else out["color_fine"])
            depth_diff = np.abs(out["depth"] - dist.cpu().numpy())
            if rgb_final is None:
                rgb_final, diff_final = color.copy(), depth_diff.copy()
            else:
                ind = diff_final > depth_diff
                rgb_final[ind] = color[ind]
                diff_final[ind] = depth_diff[ind]
        return rgb_final, diff_final

    def render_geometry_cast_light(self, fields=None):
        """Head close-up under a random cast light (main.py:634-739), written
        to cast_light_texture_head_black.png; the light direction is drawn
        from numpy's global RNG."""
        hh = self.tc.head_height
        dev = self.device
        pose = cameras.lookat(torch.tensor([0.0, hh, 0.8], device=dev),
                              torch.tensor([0.0, hh, 0.3], device=dev),
                              torch.tensor([0.0, 1.0, 0.0], device=dev))
        rays_o, rays_d = self.dataset.gen_rays_pose(pose, 0.5)
        H, W = rays_o.shape[0], rays_o.shape[1]
        out = self.render_rays_chunked(
            rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), None,
            keys=["color_fine", "extra_color_fine", "normal_map_nomask", "weight_sum"],
            fields=fields,
        )
        extra = out["extra_color_fine"] if out["extra_color_fine"] is not None else out["color_fine"]
        normals = out["normal_map_nomask"]
        normals = normals / (np.linalg.norm(normals, axis=-1, keepdims=True) + 1e-7)
        theta = np.random.uniform(-np.pi / 4, np.pi / 4)
        phi = np.random.uniform(-np.pi / 4, np.pi / 4)
        light = cameras.sphere_coord(torch.tensor(theta, dtype=torch.float32),
                                     torch.tensor(phi, dtype=torch.float32)).numpy()
        shading = np.clip((normals * light).sum(-1, keepdims=True), 0, 1)
        shading[np.isnan(shading)] = 1.0
        shading[out["weight_sum"].reshape(-1) < 0.5] = 1.0
        img = np.clip(extra * shading, 0, 1).reshape(H, W, 3)
        write_png(os.path.join(self.base_exp_dir, "cast_light_texture_head_black.png"), to8b(img))

    # -- view interpolation (main.py:822-848) ----------------------------------

    def render_novel_image(self, idx_0: int, idx_1: int, ratio: float,
                           resolution_level: int) -> np.ndarray:
        """The (H, W, 3) uint8 render from the camera at ``ratio`` between
        stored cameras idx_0 and idx_1: camera-to-world rotations by Slerp,
        centres linearly."""
        from scipy.spatial.transform import Rotation, Slerp

        poses = self.dataset.poses.cpu().numpy()
        p0, p1 = np.linalg.inv(poses[idx_0]), np.linalg.inv(poses[idx_1])
        rot = Slerp([0, 1], Rotation.from_matrix(np.stack([p0[:3, :3], p1[:3, :3]])))(ratio)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = rot.as_matrix()
        pose[:3, 3] = (1.0 - ratio) * p0[:3, 3] + ratio * p1[:3, 3]
        pose = torch.from_numpy(np.linalg.inv(pose)).to(self.device)
        rays_o, rays_d = self.dataset.gen_rays_pose(pose, resolution_level)
        H, W = rays_o.shape[0], rays_o.shape[1]
        bg = torch.ones(1, 3, device=self.device) if self.tc.use_white_bkgd else None
        out = self.render_rays_chunked(rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), bg,
                                       keys=["color_fine"])
        return to8b(out["color_fine"].reshape(H, W, 3))

    def interpolate_view(self, img_idx_0: int, img_idx_1: int) -> str:
        """Write render/{iter:08d}_{idx_0}_{idx_1}.mp4: 60 renders at
        resolution level 4 along a sine-eased path between the two cameras,
        then the same frames reversed, at 30 fps. Returns the path."""
        n_frames = 60
        images = []
        for i in range(n_frames):
            ratio = np.sin(((i / n_frames) - 0.5) * np.pi) * 0.5 + 0.5
            images.append(self.render_novel_image(img_idx_0, img_idx_1, ratio, 4))
        images += images[::-1]
        video_dir = os.path.join(self.base_exp_dir, "render")
        os.makedirs(video_dir, exist_ok=True)
        path = os.path.join(video_dir, f"{self.iter_step:08d}_{img_idx_0}_{img_idx_1}.mp4")
        write_mp4(path, images, fps=30)
        return path

    # -- persistence ----------------------------------------------------------

    def save_checkpoint(self) -> str:
        ckpt_dir = os.path.join(self.base_exp_dir, "checkpoints")
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"ckpt_{self.iter_step:06d}")
        torch.save({"fields": self.fields.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "iter_step": self.iter_step, "update_count": self.update_count}, path)
        return path

    def load_checkpoint(self, path: str) -> None:
        ck = torch.load(path, map_location=self.device, weights_only=False)
        self.fields.load_state_dict(ck["fields"])
        self.optimizer.load_state_dict(ck["optimizer"])
        self.iter_step = int(ck["iter_step"])
        self.update_count = int(ck["update_count"])

    def file_backup(self):
        """Record the conf and the code's git revision for reproducibility
        (main.py:588-599)."""
        import shutil

        rec_dir = os.path.join(self.base_exp_dir, "recording")
        os.makedirs(rec_dir, exist_ok=True)
        if self.conf_path and os.path.exists(self.conf_path):
            shutil.copyfile(self.conf_path, os.path.join(rec_dir, "config.conf"))
        # the code's revision beside the conf; nothing when git fails (not a
        # checkout, no git)
        try:
            rev = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                                 cwd=os.path.dirname(os.path.abspath(__file__)), check=True)
        except (OSError, subprocess.CalledProcessError):
            return
        with open(os.path.join(rec_dir, "git_revision.txt"), "w") as f:
            f.write(rev.stdout.strip() + "\n")


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="AppearanceGen (PyTorch + CUDA)")
    parser.add_argument("--conf", type=str, default="./confs/base.conf")
    parser.add_argument("--mode", type=str, default="train",
                        choices=("train", "train_clip", "validate_mesh", "render_geometry_cast_light"))
    parser.add_argument("--mcube_threshold", type=float, default=0.0)
    parser.add_argument("--gpu", type=int, default=0,
                        help="the card's index (under torchrun: each rank's LOCAL_RANK)")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="run on the card (default) or, when asked, on the CPU")
    parser.add_argument("--backend", type=str, default=None, choices=("nccl", "gloo"),
                        help="under torchrun: the process group's backend (nccl on the "
                             "card, one card a rank; gloo on the CPU or for ranks sharing "
                             "a card)")
    parser.add_argument("--is_continue", default=False, action="store_true")
    parser.add_argument("--case", type=str, default="smpl")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="override conf entries, e.g. --set general.base_exp_dir=/tmp/exp")
    args = parser.parse_args(argv)
    if args.mode in ("validate_mesh", "render_geometry_cast_light"):
        args.is_continue = True
    conf = config_mod.parse_file(args.conf, case=args.case)
    for kv in args.set:
        key, _, value = kv.partition("=")
        conf.put(key, config_mod._parse_value(value))
    device = f"cuda:{args.gpu}" if args.device == "cuda" else "cpu"
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # under torchrun: one process a rank
        mesh, device = pmesh.from_env(args.device, args.backend), None
    try:
        runner = Runner(args.conf, args.mode, args.case, args.is_continue, conf=conf,
                        device=device, mesh=mesh)
        if args.mode == "train":
            runner.train()
        elif args.mode == "train_clip":
            runner.init_clip()
            runner.init_smpl()
            runner.train_clip()
        elif runner.mesh.writer:  # the validation modes: rank 0 renders and writes
            if args.mode == "validate_mesh":
                runner.validate_mesh(world_space=True, resolution=512,
                                     threshold=args.mcube_threshold)
            runner.render_geometry_cast_light()
        pmesh.barrier(runner.mesh)
    finally:
        if mesh is not None:
            pmesh.close(mesh)
    return runner


if __name__ == "__main__":
    main()
