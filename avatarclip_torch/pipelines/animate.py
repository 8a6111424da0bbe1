"""AvatarAnimate: text-driven pose and motion generation (PyTorch + CUDA).

Twin of avatarclip_tpu/pipelines/animate.py (reference:
AvatarAnimate/models/pose_generation.py, motion_generation.py, builder.py):
the shared :class:`AnimateContext` (CLIP, SMPL, VPoser, the multi-view pose
score), four pose generators, two motion generators, the string-keyed
registry and the conf-driven CLI

    python -m avatarclip_torch.pipelines.animate --conf confs/pose/pose_optimizer.conf

The optimizers (PoseOptimizer, VPoserOptimizer, MotionOptimizer) take Adam
steps whose gradients flow through CLIP's image encoder and the soft
rasterizer (render/raster.soft_render_mesh, whose aggregation is the CUDA
kernel pair of ops/fused_soft.py on the card); candidate scoring renders
through the hard z-buffer (ops/raster_zbuffer.py). JAX's ``vmap`` over
candidates and views is a batch dimension: one soft render of all views of
a step. Every random number of a generator comes from its own seeded CPU
``torch.Generator`` through its ``draw_*`` methods, so a test can hand a
step the JAX run's draws. Pretrained priors (VPoser, RealNVP, codebook,
motion VAE) load through the JAX package's lookup (assets.find); without
them seeded random stand-ins keep every strategy runnable.

Everything runs on the card unless ``device="cpu"`` (``--device cpu``) is
asked for; asking for CUDA without a card raises.
"""

from __future__ import annotations

import os
import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import assets
from ..body import rotations, vposer as vposer_mod
from ..clip import model as clip_model
from ..clip import tokenizer as clip_tokenizer
from ..render import cameras, raster
from ..utils import device as device_mod
from ..utils import graphs, trace
from . import motion_vae

# every screen-space dot is K = 3 and must stay full f32 (thin faces decide
# the soft coverage on values near zero); CLIP's matmuls too, for parity
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ANGLES = (120.0, 150.0, 180.0, 210.0, 240.0)  # the five scoring azimuths (deg)
SOFT_SIGMA = 0.5  # px, the soft render of the optimizers (pose_generation.py:120-127)


def pose_padding(pose: torch.Tensor) -> torch.Tensor:
    """63-d body pose -> 69-d (the two hand joints zero)."""
    if pose.shape[-1] not in (63, 69):
        raise ValueError(f"a body pose has 63 or 69 values, got {pose.shape[-1]}")
    if pose.shape[-1] == 63:
        pose = torch.cat([pose, torch.zeros_like(pose[..., :6])], -1)
    return pose


def view_poses(elevs: torch.Tensor, azims_deg: torch.Tensor, dist: float = 2.0) -> torch.Tensor:
    """(B,) elevations (rad) and azimuths (deg) -> (B, 4, 4) camera-to-world
    poses looking at the origin from ``dist`` (neural_renderer's
    get_points_from_angles convention, y up)."""
    a = torch.deg2rad(azims_deg)
    eye = dist * torch.stack([torch.cos(elevs) * torch.sin(a), torch.sin(elevs),
                              -torch.cos(elevs) * torch.cos(a)], -1)
    z = eye / eye.norm(dim=-1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0], device=eye.device).expand_as(z)
    x = torch.linalg.cross(up, z)
    x = x / x.norm(dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x)
    pose = torch.eye(4, device=eye.device).repeat(eye.shape[0], 1, 1)
    pose[:, :3, 0], pose[:, :3, 1], pose[:, :3, 2], pose[:, :3, 3] = x, y, z, eye
    return pose


# ---------------------------------------------------------------------------
# shared context: CLIP + SMPL + VPoser (pose_generation.py:27-49)
# ---------------------------------------------------------------------------


class AnimateContext:
    def __init__(self, smpl_path: str | None = None, vposer_path: str | None = None,
                 clip_size: str = "vit_b32", render_res: int = 224, device=None):
        self.device = dev = device_mod.resolve(device, "AvatarAnimate")
        model = assets.load_smpl(smpl_path)
        self.smpl = model.to(dev)
        vp, self.vposer_pretrained = vposer_mod.load_pretrained(vposer_path)
        self.vposer = clip_model.tree_to(vp, dev)
        if clip_size == "tiny":
            self.clip_cfg = clip_model.TINY
            params = clip_model.init_params(self.clip_cfg, torch.Generator().manual_seed(42))
        else:
            params, _ = clip_model.load_pretrained()
            self.clip_cfg = clip_model.VIT_B32
        self.clip_params = clip_model.tree_to(params, dev)
        self.render_res = render_res
        self.focal = cameras.focal_from_fov(render_res, np.deg2rad(60.0))
        self.faces = torch.from_numpy(np.asarray(model.faces, np.int64)).to(dev)
        # SURREAL-textured scoring renders when the asset exists (models/render.py:6-7)
        uv = assets.load_smpl_uv()
        self.uv_texture = None if uv is None else tuple(torch.from_numpy(t).to(dev) for t in uv)

    def get_text_feature(self, text: str) -> torch.Tensor:
        toks = torch.from_numpy(clip_tokenizer.tokenize([text])).to(self.device)
        with torch.no_grad():
            return clip_model.encode_text(self.clip_params, self.clip_cfg, toks)[0]

    def _pose_vertices(self, pose69: torch.Tensor) -> torch.Tensor:
        """(N, 69) -> (N, V, 3) world-frame vertices with the fixed global
        orient x = pi/2 (pose_generation.py:70-75) and the render frame
        rotation (models/render.py:26-29)."""
        with trace.span("render.smpl"):
            N = pose69.shape[0]
            go = torch.zeros(N, 3, device=self.device)
            go[:, 0] = np.pi / 2
            verts, _ = self.smpl.forward(betas=torch.zeros(N, self.smpl.num_betas, device=self.device),
                                         body_pose=pose69.reshape(N, 23, 3), global_orient=go)
            return verts @ torch.from_numpy(cameras.BODY_TO_WORLD).to(verts).t()

    def render_views(self, verts: torch.Tensor, elevs: torch.Tensor, angles: torch.Tensor,
                     soft: bool) -> torch.Tensor:
        """(N, V, 3) bodies x the views (elevs, angles) -> (views * N, res,
        res, 3) images, view-major. Soft: one batched soft render (one
        kernel launch each way); hard: one z-buffer render per image."""
        with trace.span("render.soft" if soft else "render.hard"):
            n_view, N = angles.shape[0], verts.shape[0]
            poses = view_poses(elevs, angles)
            res = self.render_res
            vb = verts[None].expand(n_view, -1, -1, -1).reshape(n_view * N, *verts.shape[1:])
            pb = poses[:, None].expand(-1, N, -1, -1).reshape(n_view * N, 4, 4)
            if soft:
                return raster.soft_render_mesh(vb, self.faces, pb, res, res, self.focal,
                                               sigma=SOFT_SIGMA)["rgb"]
            kw = {}
            if self.uv_texture is not None:
                kw = {"face_uvs": self.uv_texture[0], "texture": self.uv_texture[1]}
            return torch.stack([raster.render_mesh(v, self.faces, p, res, res, self.focal, **kw)["rgb"]
                                for v, p in zip(vb, pb)])

    def pose_feature(self, pose: torch.Tensor, elevs: torch.Tensor, angles: torch.Tensor,
                     soft: bool) -> torch.Tensor:
        """pose (N, 63|69) -> (N, embed): the mean CLIP embedding of its views."""
        pose = pose_padding(pose)
        if pose.dim() == 1:
            pose = pose[None]
        imgs = self.render_views(self._pose_vertices(pose), elevs, angles, soft)
        with trace.span("clip.image"):
            imgs = clip_model.resize_to_clip(imgs, self.clip_cfg.image_size)
            emb = clip_model.encode_image_graphed(self.clip_params, self.clip_cfg, imgs)
            return emb.reshape(angles.shape[0], -1, emb.shape[-1]).mean(0)

    def get_pose_feature(self, pose: torch.Tensor, elevs: torch.Tensor | None = None,
                         angles=ANGLES, differentiable: bool = False) -> torch.Tensor:
        """Five-view render + CLIP encode + mean (pose_generation.py:63-89);
        elevations 0 unless given (the generators draw them ~ N(0, 0.3))."""
        angles = torch.tensor(angles, dtype=torch.float32, device=self.device)
        elevs = torch.zeros_like(angles) if elevs is None else elevs.to(self.device)
        with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
            return self.pose_feature(pose.to(self.device), elevs, angles, soft=differentiable)

    def calculate_pose_score(self, text_feature, pose, elevs=None) -> float:
        pf = self.get_pose_feature(pose, elevs)
        return float(clip_model.cosine_similarity(pf[0], text_feature))

    def sort_poses_by_score(self, text_feature, poses, elevs=None):
        """All candidates scored in one batch, best first."""
        pf = self.get_pose_feature(torch.stack(list(poses)), elevs)
        scores = clip_model.cosine_similarity(pf, text_feature[None]).cpu().numpy()
        return [poses[i] for i in np.argsort(-scores, kind="stable")]


# ---------------------------------------------------------------------------
# pose generators (4 strategies)
# ---------------------------------------------------------------------------


class _Timed:
    """The step loops' timing: ``first_step_s`` (the first step, with any
    build or warm-up), ``steady_s`` / ``steady_steps`` after it, and each
    step's synchronised seconds in ``step_s``."""

    def _clock(self, t0: float) -> None:
        with trace.span("loop.sync"):
            device_mod.sync(self.ctx.device)
            t = time.perf_counter()
            self.timing.setdefault("step_s", []).append(t - t0)
            if "first_step_s" not in self.timing:
                self.timing["first_step_s"] = t - t0
            else:
                self.timing["steady_s"] = self.timing.get("steady_s", 0.0) + t - t0
                self.timing["steady_steps"] = self.timing.get("steady_steps", 0) + 1

    def median_step_s(self) -> float:
        return statistics.median(self.timing["step_s"][1:] or self.timing["step_s"])


class BasePoseGenerator(_Timed):
    def __init__(self, name: str = "", topk: int = 5, smpl_path: str | None = None,
                 vposer_path: str | None = None, ctx: AnimateContext | None = None, seed: int = 0,
                 **kwargs):
        self.name = name
        self.topk = topk
        self.ctx = ctx or AnimateContext(smpl_path, vposer_path, **kwargs)
        self.gen = torch.Generator().manual_seed(seed)
        self.timing: dict = {}

    def get_topk_poses(self, text: str) -> torch.Tensor:
        raise NotImplementedError


class _OptimizerPoseGenerator(BasePoseGenerator):
    """Adam (or SGD) on a pose variable, the gradient through the soft
    rasterizer and CLIP (pose_generation.py:102-173). ``steps`` counts the
    steps taken: the id of the next step's spans (utils/trace.py)."""

    dim = 0

    def __init__(self, optim_name="Adam", optim_cfg=None, num_iteration=500, **kwargs):
        super().__init__(**kwargs)
        if optim_name not in ("Adam", "SGD"):
            raise ValueError(f"optim_name must be Adam or SGD, got {optim_name}")
        self.optim_name = optim_name
        self.optim_cfg = optim_cfg or {"lr": 0.01}
        self.num_iteration = num_iteration
        self.losses: list[torch.Tensor] = []  # every step's loss, on the device
        self.steps = 0

    def make_optimizer(self, var: torch.Tensor):
        lr = self.optim_cfg.get("lr", 0.01)
        if self.optim_name == "Adam":  # optax.adam's defaults
            return torch.optim.Adam([var], lr=lr, betas=(0.9, 0.999), eps=1e-8)
        return torch.optim.SGD([var], lr=lr)

    def draw_init(self) -> torch.Tensor:
        return torch.randn(self.dim, generator=self.gen)

    def draw_step(self) -> dict:
        with trace.span("loop.draws", self.steps):
            return {"elevs": torch.randn(len(ANGLES), generator=self.gen) * 0.3}

    def _decode(self, var: torch.Tensor) -> torch.Tensor:  # var -> (1, 63) body pose
        raise NotImplementedError

    def loss(self, var: torch.Tensor, text_feature: torch.Tensor, elevs: torch.Tensor):
        angles = torch.tensor(ANGLES, device=self.ctx.device)
        pf = self.ctx.pose_feature(self._decode(var), elevs.to(self.ctx.device), angles, soft=True)[0]
        with trace.span("clip.image"):
            return 1.0 - clip_model.cosine_similarity(pf, text_feature)

    def step(self, var: torch.Tensor, opt, text_feature: torch.Tensor, draws: dict) -> torch.Tensor:
        """One Adam step on ``var`` (in place); the loss before it."""
        with trace.span("loop.step", self.steps):
            opt.zero_grad(set_to_none=True)
            loss = self.loss(var, text_feature, draws["elevs"])
            with trace.span("backward"):
                loss.backward()
            with trace.span("loop.adam"):
                opt.step()
        self.steps += 1
        return loss.detach()

    def get_pose(self, text_feature: torch.Tensor) -> torch.Tensor:
        var = self.draw_init().to(self.ctx.device).requires_grad_(True)
        opt = self.make_optimizer(var)
        for _ in range(self.num_iteration):
            t0 = time.perf_counter()
            self.losses.append(self.step(var, opt, text_feature, self.draw_step()))
            self._clock(t0)
        with torch.no_grad():
            return pose_padding(self._decode(var)[0])

    def get_topk_poses(self, text: str) -> torch.Tensor:
        tf = self.ctx.get_text_feature(text)
        poses = [self.get_pose(tf) for _ in range(self.topk)]
        return torch.stack(self.ctx.sort_poses_by_score(tf, poses))


class PoseOptimizer(_OptimizerPoseGenerator):
    """Direct optimization of the 63-d theta (pose_generation.py:102-135)."""

    dim = 63

    def _decode(self, var):
        return var[None]


class VPoserOptimizer(_OptimizerPoseGenerator):
    """Optimization in the 32-d VPoser latent (pose_generation.py:138-173)."""

    dim = 32

    def _decode(self, var):
        return vposer_mod.decode(self.ctx.vposer, var[None])


class VPoserRealNVP(BasePoseGenerator):
    """Conditional RealNVP sampler over VPoser latents (pose_generation.py:
    176-285): affine coupling blocks whose scale / translate MLPs see the
    CLIP text feature, fixed random binary masks; num_batch batches of
    num_sample samples, the best-scoring pose kept."""

    def __init__(self, dim=32, hdim=256, num_block=8, num_sample=10, num_batch=50,
                 ckpt_path="data/pose_realnvp.pth", **kwargs):
        super().__init__(**kwargs)
        self.dim, self.hdim, self.num_block = dim, hdim, num_block
        self.num_sample, self.num_batch = num_sample, num_batch
        self.feat_dim = self.ctx.clip_cfg.embed_dim  # 512 for ViT-B/32
        self.params = clip_model.tree_to(self._load_or_init(ckpt_path), self.ctx.device)

    def _load_or_init(self, ckpt_path):
        g = torch.Generator().manual_seed(11)
        mask = (torch.randn(self.num_block, 1, self.dim, generator=g) > 0).float()

        def dense(dout, din):
            bound = 1.0 / np.sqrt(din)
            return {"w": (torch.rand(dout, din, generator=g) * 2 - 1) * bound, "b": torch.zeros(dout)}

        din = self.dim + self.feat_dim
        blocks = [{"s": [dense(self.hdim, din), dense(self.hdim, self.hdim), dense(self.dim, self.hdim)],
                   "t": [dense(self.hdim, din), dense(self.hdim, self.hdim), dense(self.dim, self.hdim)]}
                  for _ in range(self.num_block)]
        path = assets.find(os.path.basename(ckpt_path), ckpt_path)
        if path and path.endswith(".pth"):
            data = torch.load(path, map_location="cpu", weights_only=False)
            sd = {k: torch.as_tensor(v).float() for k, v in data.get("state_dict", data).items()}
            blocks = [{k: [{"w": sd[f"{k}.{i}.{j}.weight"], "b": sd[f"{k}.{i}.{j}.bias"]}
                           for j in (0, 2, 4)] for k in ("s", "t")} for i in range(self.num_block)]
            mask = sd.get("mask", mask)
        return {"mask": mask, "blocks": blocks}

    def _mlp(self, layers, x, tanh_out):
        x = F.leaky_relu(x @ layers[0]["w"].t() + layers[0]["b"], 0.01)
        x = F.leaky_relu(x @ layers[1]["w"].t() + layers[1]["b"], 0.01)
        x = x @ layers[2]["w"].t() + layers[2]["b"]
        return torch.tanh(x) if tanh_out else x

    def nvp_decode(self, x, features):
        """z -> pose latent (pose_generation.py:233-240)."""
        for i, blk in enumerate(self.params["blocks"]):
            m = self.params["mask"][i]
            x_ = x * m
            trans = torch.cat([x_, features], -1)
            s = self._mlp(blk["s"], trans, tanh_out=True) * (1 - m)
            t = self._mlp(blk["t"], trans, tanh_out=False) * (1 - m)
            x = x_ + (1 - m) * (x * torch.exp(s) + t)
        return x

    def nvp_encode(self, x, features):
        """pose latent -> (z, log-det) (the training path, pose_generation.py:250-263)."""
        log_det = torch.zeros(x.shape[0], device=x.device)
        z = x
        for i in reversed(range(self.num_block)):
            m = self.params["mask"][i]
            z_ = m * z
            trans = torch.cat([z_, features], -1)
            s = self._mlp(self.params["blocks"][i]["s"], trans, True) * (1 - m)
            t = self._mlp(self.params["blocks"][i]["t"], trans, False) * (1 - m)
            z = (1 - m) * (z - t) * torch.exp(-s) + z_
            log_det = log_det - s.sum(1)
        return z, log_det

    def draw_batch(self) -> dict:
        g = self.gen
        return {"z": torch.randn(self.num_sample, self.dim, generator=g),
                "elevs": torch.randn(len(ANGLES), generator=g) * 0.3}

    def get_pose(self, text_feature: torch.Tensor) -> torch.Tensor:
        best_pose, best_score = None, -np.inf
        tf = text_feature[None]
        dev = self.ctx.device
        for _ in range(self.num_batch):
            t0 = time.perf_counter()
            draws = self.draw_batch()
            with torch.no_grad():
                latents = self.nvp_decode(draws["z"].to(dev), tf.expand(self.num_sample, -1))
                poses = vposer_mod.decode(self.ctx.vposer, latents)
                pf = self.ctx.get_pose_feature(poses, draws["elevs"])
                scores = clip_model.cosine_similarity(pf, tf).cpu().numpy()
            self._clock(t0)
            idx = int(np.argmax(scores))
            if scores[idx] > best_score:
                best_score, best_pose = float(scores[idx]), poses[idx]
        return pose_padding(best_pose)

    def get_topk_poses(self, text: str) -> torch.Tensor:
        tf = self.ctx.get_text_feature(text)
        poses = [self.get_pose(tf) for _ in range(self.topk)]
        return torch.stack(self.ctx.sort_poses_by_score(tf, poses))


class VPoserCodebook(BasePoseGenerator):
    """Retrieval from a precomputed (latent, CLIP embedding) codebook
    (pose_generation.py:288-329)."""

    def __init__(self, codebook_path="data/codebook.pth", pre_topk=40, filter_threshold=0.07,
                 **kwargs):
        super().__init__(**kwargs)
        self.pre_topk = pre_topk
        self.filter_threshold = filter_threshold
        book, emb = self._load(codebook_path)
        self.codebook, self.codebook_embedding = book.to(self.ctx.device), emb.to(self.ctx.device)

    def _load(self, codebook_path):
        path = assets.find(os.path.basename(codebook_path), codebook_path)
        if path and path.endswith(".pth"):
            data = torch.load(path, map_location="cpu", weights_only=False)
            return (torch.as_tensor(data["codebook"]).float(),
                    torch.as_tensor(data["codebook_embedding"]).float())
        if path:
            with np.load(path) as data:
                return (torch.from_numpy(data["codebook"]).float(),
                        torch.from_numpy(data["codebook_embedding"]).float())
        # stand-in: random latents and random embeddings keep the retrieval
        # exercised (scoring latents by rendering them would be circular)
        g = torch.Generator().manual_seed(5)
        return torch.randn(512, 32, generator=g), torch.randn(512, self.ctx.clip_cfg.embed_dim, generator=g)

    @staticmethod
    def suppress_duplicated_poses(poses: np.ndarray, threshold: float) -> np.ndarray:
        kept: list[np.ndarray] = []
        for pose in poses:
            if not kept or min(float(np.abs(pose - q).mean()) for q in kept) > threshold:
                kept.append(pose)
        return np.stack(kept, 0)

    def get_topk_poses(self, text: str) -> torch.Tensor:
        tf = self.ctx.get_text_feature(text)
        with torch.no_grad():
            score = clip_model.cosine_similarity(self.codebook_embedding, tf[None])
            idx = torch.topk(score, self.pre_topk).indices
            poses = vposer_mod.decode(self.ctx.vposer, self.codebook[idx])
        poses = self.suppress_duplicated_poses(poses.cpu().numpy(), self.filter_threshold)
        return pose_padding(torch.from_numpy(poses[: self.topk]).to(self.ctx.device))


# ---------------------------------------------------------------------------
# motion generators (2 strategies)
# ---------------------------------------------------------------------------


class BaseMotionGenerator(_Timed):
    def __init__(self, name: str = "", num_frame: int = 60, smpl_path=None, vposer_path=None,
                 ctx: AnimateContext | None = None, seed: int = 0, **kwargs):
        self.name = name
        self.num_frame = num_frame
        self.ctx = ctx or AnimateContext(smpl_path, vposer_path, **kwargs)
        self.gen = torch.Generator().manual_seed(seed)
        self.timing: dict = {}

    def get_motion(self, text: str, poses) -> torch.Tensor:
        raise NotImplementedError


class MotionInterpolation(BaseMotionGenerator):
    """A linear walk in VPoser latent space between the candidate anchors
    (motion_generation.py:100-137)."""

    def __init__(self, anchor_position=(0, 14, 29, 44, 59), **kwargs):
        super().__init__(**kwargs)
        self.anchor_position = tuple(anchor_position)
        if self.anchor_position[0] != 0 or self.anchor_position[-1] != self.num_frame - 1:
            raise ValueError("the anchors must start at frame 0 and end at the last frame")

    def get_motion(self, text: str, poses) -> torch.Tensor:
        poses = torch.as_tensor(poses, device=self.ctx.device)[..., :63]
        with torch.no_grad():
            mu, _ = vposer_mod.encode(self.ctx.vposer, poses)
            latents = [mu[0]]
            for i in range(1, len(self.anchor_position)):
                steps = self.anchor_position[i] - self.anchor_position[i - 1]
                for j in range(steps):
                    t = (j + 1) / steps
                    latents.append(mu[i - 1] * (1 - t) + mu[i] * t)
            return pose_padding(vposer_mod.decode(self.ctx.vposer, torch.stack(latents)))


_decoder_graphs = graphs.Cache("motion_graph", "backward.motion")


class MotionOptimizer(BaseMotionGenerator):
    """Latent optimization against the motion VAE decoder (motion_generation.py:
    249-358): a rank-weighted min-over-frames 6d reconstruction of the
    candidates, a frame-position-weighted CLIP term on strided frames (one
    soft render of n_part frames at azimuth 150 per step) and a negative
    delta loss. ``steps`` counts the steps taken: the id of the next step's
    spans (utils/trace.py). On the card a training step's decoder replays
    from CUDA graphs (utils/graphs.py: counters ``motion_graph_*``)."""

    def __init__(self, latent_dim=256, num_layers=4, num_heads=4, ckpt_path="data/motion_vae.pth",
                 optim_name="Adam", optim_cfg=None, num_iteration=5000,
                 recon_coef=(1, 0.8, 0.6, 0.4, 0.2), clip_coef=0.001, delta_coef=0.01,
                 clip_num_part=30, **kwargs):
        super().__init__(**kwargs)  # optim_name: the conf schema's; Adam, as in JAX
        self.cfg = motion_vae.MotionVAEConfig(seq_len=self.num_frame, latent_dim=latent_dim,
                                              num_heads=num_heads, ff_size=latent_dim * 4,
                                              num_layers=num_layers)
        path = assets.find(os.path.basename(ckpt_path), ckpt_path)
        if path and path.endswith(".pth"):
            vae = motion_vae.convert_torch_ckpt(path, self.cfg)
        else:
            vae = motion_vae.init_params(torch.Generator().manual_seed(3), self.cfg)
        self.vae = clip_model.tree_to(vae, self.ctx.device)
        self.optim_cfg = optim_cfg or {"lr": 0.01}
        self.num_iteration = num_iteration
        self.recon_coef = tuple(recon_coef)
        self.clip_coef = clip_coef
        self.delta_coef = delta_coef
        self.clip_num_part = clip_num_part
        self.n_part = -(-self.num_frame // clip_num_part)  # frames scored per CLIP pass
        self.losses: list[torch.Tensor] = []  # every step's loss, on the device
        self.steps = 0
        self._resident: dict = {}

    def _decode_6d(self, latent: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(latent,) -> (T, 63) via 6d -> matrix -> quaternion -> axis-angle,
        and the (T, 21, 6) 6d rotations of those joints."""
        if latent.dim() == 1:
            latent = latent[None]
        rot6d = motion_vae.decode(self.vae, self.cfg, latent)  # (1, T, 55, 6)
        mats = rotations.rotation_6d_to_matrix(rot6d.reshape(-1, 6))
        aa = rotations.quaternion_to_axis_angle(rotations.matrix_to_quaternion(mats)).reshape(-1, 165)
        motion = aa[:, 3:66]
        return motion, rotations.matrix_to_rotation_6d(rotations.axis_angle_to_matrix(motion.reshape(-1, 21, 3)))

    def decode_6d(self, latent: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``_decode_6d``, replayed from CUDA graphs where the call is a
        training step's (utils/graphs.py; the backward's span
        ``backward.motion``)."""
        return _decoder_graphs(self._decode_6d, (self.cfg, id(self.vae)), graphs.leaves(self.vae), latent)

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        """(latent,) -> (T, 63) via 6d -> matrix -> quaternion -> axis-angle."""
        return self.decode_6d(latent)[0]

    def _constants(self) -> tuple:
        """The step's constants on the device, built once a default dtype:
        the reconstruction's coefficients, the strided frames' offsets, the
        CLIP view's elevation and azimuth."""
        dt = torch.get_default_dtype()
        if dt not in self._resident:
            dev = self.ctx.device
            self._resident[dt] = (torch.tensor(self.recon_coef, device=dev),
                                  torch.arange(self.n_part, device=dev),
                                  torch.zeros(1, device=dev), torch.tensor([150.0], device=dev))
        return self._resident[dt]

    def draw_init(self) -> torch.Tensor:
        return torch.randn(self.cfg.latent_dim, generator=self.gen)

    def draw_step(self) -> dict:
        with trace.span("loop.draws", self.steps):
            return {"st_idx": int(torch.randint(0, self.clip_num_part, (), generator=self.gen))}

    def loss(self, latent, poses63, text_feature, st_idx: int):
        T, P = self.num_frame, self.clip_num_part
        coefs, offsets, elev, azim = self._constants()
        with trace.span("motion.decode"):
            motion, gen6 = self.decode_6d(latent)  # (T, 63), (T, 21, 6)
        with trace.span("motion.loss"):
            # rank-weighted min-over-frames 6d reconstruction (motion_generation.py:319-332)
            ori6 = rotations.matrix_to_rotation_6d(rotations.axis_angle_to_matrix(poses63.reshape(-1, 21, 3)))
            value = ((gen6[None] - ori6[:, None]) ** 2).mean((-1, -2)).amin(1)  # (K,)
            loss = (value * coefs[: value.shape[0]]).sum()
            if self.delta_coef > 0:  # motion intensity (motion_generation.py:347-352)
                delta = ((motion[1:] - motion[:-1]) ** 2).mean() * self.delta_coef
        if self.clip_coef > 0:  # CLIP on strided frames (motion_generation.py:334-345)
            raw = st_idx + P * offsets
            frame_ids = raw.clamp(0, T - 1)
            pf = self.ctx.pose_feature(motion[frame_ids], elev, azim, soft=True)
            with trace.span("clip.image"):
                lc = 1.0 - clip_model.cosine_similarity(pf, text_feature[None])
            w = frame_ids.float() / T * (raw < T).float()
            loss = loss + (w * lc).sum() * self.clip_coef
        if self.delta_coef > 0:
            loss = loss - delta
        return loss

    def step(self, latent, opt, poses63, text_feature, draws: dict) -> torch.Tensor:
        """One Adam step on ``latent`` (in place); the loss before it."""
        with trace.span("loop.step", self.steps):
            opt.zero_grad(set_to_none=True)
            loss = self.loss(latent, poses63, text_feature, draws["st_idx"])
            with trace.span("backward"):
                loss.backward()
            with trace.span("loop.adam"):
                opt.step()
        self.steps += 1
        return loss.detach()

    def get_motion(self, text: str, poses) -> torch.Tensor:
        poses63 = torch.as_tensor(poses, device=self.ctx.device)[..., :63]
        tf = self.ctx.get_text_feature(text)
        latent = self.draw_init().to(self.ctx.device).requires_grad_(True)
        opt = torch.optim.Adam([latent], lr=self.optim_cfg.get("lr", 0.01), betas=(0.9, 0.999), eps=1e-8)
        for _ in range(self.num_iteration):
            t0 = time.perf_counter()
            self.losses.append(self.step(latent, opt, poses63, tf, self.draw_step()))
            self._clock(t0)
        with torch.no_grad():
            return pose_padding(self.decode(latent))


# ---------------------------------------------------------------------------
# registry (builder.py:13-32)
# ---------------------------------------------------------------------------

POSE_GENERATORS = {
    "PoseOptimizer": PoseOptimizer,
    "VPoserOptimizer": VPoserOptimizer,
    "VPoserRealNVP": VPoserRealNVP,
    "VPoserCodebook": VPoserCodebook,
}

MOTION_GENERATORS = {
    "MotionInterpolation": MotionInterpolation,
    "MotionOptimizer": MotionOptimizer,
}


def build_pose_generator(conf: dict, ctx: AnimateContext | None = None):
    conf = dict(conf)
    name = conf.pop("type")
    return POSE_GENERATORS[name](name=name, ctx=ctx, **conf)


def build_motion_generator(conf: dict, ctx: AnimateContext | None = None):
    conf = dict(conf)
    name = conf.pop("type")
    return MOTION_GENERATORS[name](name=name, ctx=ctx, **conf)


# ---------------------------------------------------------------------------
# CLI (AvatarAnimate/main.py:15-52)
# ---------------------------------------------------------------------------


def main(argv=None) -> dict:
    """Write ``candidate_{i}.npy`` / ``.jpg`` and, in motion mode,
    ``motion.npy`` / ``motion.mp4`` under ``general.base_exp_dir``; returns
    the generators, their outputs and the writers' host seconds."""
    import argparse

    from .. import config as config_mod
    from . import visualize

    parser = argparse.ArgumentParser(description="AvatarAnimate (PyTorch + CUDA)")
    parser.add_argument("--conf", type=str, default="./confs/base.conf")
    parser.add_argument("--gpu", type=int, default=0, help="the card's index")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="run on the card (default) or, when asked, on the CPU")
    args = parser.parse_args(argv)

    conf = config_mod.parse_file(args.conf)
    base_exp_dir = conf.get_string("general.base_exp_dir")
    mode = conf.get_string("general.mode")
    text = conf.get_string("general.text")
    viz_res = conf.get_int("general.viz_res", 512)
    os.makedirs(base_exp_dir, exist_ok=True)

    device = f"cuda:{args.gpu}" if args.device == "cuda" else "cpu"
    ctx = AnimateContext(clip_size=conf.get_string("general.clip_model", "vit_b32"),
                         render_res=conf.get_int("general.render_res", 224), device=device)
    pose_generator = build_pose_generator(conf["pose_generator"].as_dict(), ctx=ctx)
    candidates = pose_generator.get_topk_poses(text)
    out = {"ctx": ctx, "pose_generator": pose_generator, "candidates": candidates,
           "jpeg_write_s": []}
    for i in range(candidates.shape[0]):
        np.save(os.path.join(base_exp_dir, f"candidate_{i}.npy"), candidates[i].cpu().numpy())
        out["jpeg_write_s"].append(visualize.render_pose(
            candidates[i], os.path.join(base_exp_dir, f"candidate_{i}.jpg"), ctx=ctx, res=viz_res))
    if mode == "pose":
        return out
    motion_generator = build_motion_generator(conf["motion_generator"].as_dict(), ctx=ctx)
    motion = motion_generator.get_motion(text, poses=candidates)
    np.save(os.path.join(base_exp_dir, "motion.npy"), motion.cpu().numpy())
    mp4_s = visualize.render_motion(motion, os.path.join(base_exp_dir, "motion.mp4"), ctx=ctx,
                                    res=viz_res)
    out.update(motion_generator=motion_generator, motion=motion, mp4_write_s=mp4_s)
    return out


if __name__ == "__main__":
    main()
