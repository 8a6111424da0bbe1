"""AvatarAnimate's MotionOptimizer step (Hong et al. 2022,
motion_generation.py:249-358) in plain float32: the latent of ACTOR's
transformer motion VAE (Petrovich et al. 2021) decoded into 60 frames of
55 joints' 6d rotations, turned into axis-angle poses (6d -> matrix ->
quaternion -> axis-angle, pytorch3d's conversions), and scored by three
terms:

  reconstruction  for each of the K candidate poses, the mean squared 6d
                  gap to its nearest frame (the 21 body joints), weighted
                  by the candidate's rank coefficient and summed;
  CLIP            the frames st_idx, st_idx + P, ... (P = clip_num_part,
                  clamped to the last frame) skinned by SMPL (global
                  orientation pi/2 about x, hands zero), soft-rendered from
                  azimuth 150 degrees at elevation 0, encoded by CLIP; each
                  frame's 1 - cosine to the text feature weighted by its
                  index over T (0 where the unclamped index passed the
                  end), summed, times clip_coef;
  delta           minus delta_coef times the mean squared change of the
                  axis-angle pose between consecutive frames;

then one Adam step on the latent.

The decoder: T queries, each the sinusoidal positional encoding of its
frame (ACTOR's zero time queries plus the encoding), through
``num_layers`` post-LN layers with the semantics of
torch.nn.TransformerDecoderLayer (no dropout, GELU): self-attention over
the queries, cross-attention to the latent as the one memory token, a
feed-forward of ``ff_size``; each sub-layer's residual sum layer-normed;
then a linear map to 55 x 6 features a frame.

Weights are a tree of tensors: ``dec_layers`` [self_attn, cross_attn
{in_w (3d, d), in_b, out_w (d, d), out_b}, ln1, ln2, ln3 {scale, bias},
fc1, fc2 {w (out, in), b}], ``dec_final`` {w, b}.

Departures from the published run: the weights are drawn from the seed
(the pretrained motion_vae.pth is a download), the body is the capsule
humanoid at SMPL's 13,776 faces, CLIP's weights come from the seed and the
text's tokens are hashed words, as in the pose cell's reference; the five
candidate poses are drawn from the seed in place of VPoserCodebook's top
five.

Random numbers come from a CPU torch.Generator: the latent's initial value
(latent_dim normals), then each step's st_idx (an integer in [0, P))."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import cameras, clip, raster, smpl
from .adam import Adam
from .precision import F32, Precision

AZIMUTH = 150.0  # degrees, the CLIP view of every scored frame
BODY_JOINTS = 21  # axis-angle joints 1..21 of SMPL's 55-joint skeleton


def positional_encoding(T: int, d: int, device) -> torch.Tensor:
    """(T, d): sin at the even features, cos at the odd, wavelengths
    10000^(2i / d)."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / d))
    pe = torch.zeros(T, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def layer_norm(p, x):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * p["scale"] + p["bias"]


def attention(p, q_in, kv_in, heads: int, prec: Precision):
    d = q_in.shape[-1]
    hd = d // heads
    wq, wk, wv = p["in_w"][:d], p["in_w"][d:2 * d], p["in_w"][2 * d:]
    bq, bk, bv = p["in_b"][:d], p["in_b"][d:2 * d], p["in_b"][2 * d:]
    q = prec.linear(q_in, wq, bq).reshape(-1, heads, hd).transpose(0, 1)
    k = prec.linear(kv_in, wk, bk).reshape(-1, heads, hd).transpose(0, 1)
    v = prec.linear(kv_in, wv, bv).reshape(-1, heads, hd).transpose(0, 1)
    a = torch.softmax(prec.mm(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    out = prec.mm(a, v).transpose(0, 1).reshape(-1, d)
    return prec.linear(out, p["out_w"], p["out_b"])


def decoder_layer(p, x, memory, heads: int, prec: Precision):
    x = layer_norm(p["ln1"], x + attention(p["self_attn"], x, x, heads, prec))
    x = layer_norm(p["ln2"], x + attention(p["cross_attn"], x, memory, heads, prec))
    ff = prec.linear(F.gelu(prec.linear(x, p["fc1"]["w"], p["fc1"]["b"])), p["fc2"]["w"], p["fc2"]["b"])
    return layer_norm(p["ln3"], x + ff)


def decode(w: dict, latent: torch.Tensor, cfg: dict, prec: Precision = F32) -> torch.Tensor:
    """(latent_dim,) -> (T, 55, 6) 6d rotations."""
    T, d = int(cfg["num_frame"]), int(cfg["latent_dim"])
    x = positional_encoding(T, d, latent.device)
    memory = latent.reshape(1, d)
    for p in w["dec_layers"]:
        x = decoder_layer(p, x, memory, int(cfg["num_heads"]), prec)
    return prec.linear(x, w["dec_final"]["w"], w["dec_final"]["b"]).reshape(T, -1, 6)


# -- rotations (pytorch3d's conversions) -------------------------------------------


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt on the two stored rows; the third their cross product."""
    b1 = F.normalize(d6[..., :3], dim=-1)
    a2 = d6[..., 3:]
    b2 = F.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1)
    return torch.stack([b1, b2, torch.cross(b1, b2, dim=-1)], -2)


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    return m[..., :2, :].reshape(*m.shape[:-2], 6)


def _sqrt_positive(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    pos = x > 0
    out[pos] = torch.sqrt(x[pos])
    return out


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Real part first; of the four candidates, the one divided by the
    largest |component|."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = _sqrt_positive(torch.stack([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                                        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1))
    cand = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], -2)
    cand = cand / (2.0 * q_abs[..., None].clamp_min(0.1))
    best = F.one_hot(q_abs.argmax(-1), 4) > 0.5
    return cand[best].reshape(*m.shape[:-2], 4)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    norms = torch.norm(q[..., 1:], p=2, dim=-1, keepdim=True)
    half = torch.atan2(norms, q[..., :1])
    angles = 2.0 * half
    small = angles.abs() < 1e-6
    ratio = torch.where(small, 0.5 - angles * angles / 48.0,
                        torch.sin(half) / torch.where(small, torch.ones_like(angles), angles))
    return q[..., 1:] / ratio


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Through the quaternion (cos(theta / 2), sin(theta / 2) axis)."""
    angles = torch.norm(aa, p=2, dim=-1, keepdim=True)
    half = 0.5 * angles
    small = angles.abs() < 1e-6
    ratio = torch.where(small, 0.5 - angles * angles / 48.0,
                        torch.sin(half) / torch.where(small, torch.ones_like(angles), angles))
    r, i, j, k = torch.cat([torch.cos(half), aa * ratio], -1).unbind(-1)
    s = 2.0 / (r * r + i * i + j * j + k * k)
    o = torch.stack([1 - s * (j * j + k * k), s * (i * j - k * r), s * (i * k + j * r),
                     s * (i * j + k * r), 1 - s * (i * i + k * k), s * (j * k - i * r),
                     s * (i * k - j * r), s * (j * k + i * r), 1 - s * (i * i + j * j)], -1)
    return o.reshape(*aa.shape[:-1], 3, 3)


def motion_poses(rot6d: torch.Tensor) -> torch.Tensor:
    """(T, 55, 6) -> (T, 63): the body joints' axis-angle."""
    aa = quaternion_to_axis_angle(matrix_to_quaternion(rotation_6d_to_matrix(rot6d)))
    return aa[:, 1:1 + BODY_JOINTS].reshape(aa.shape[0], -1)


# -- the step ------------------------------------------------------------------------


def render_frames(body: dict, frames63: torch.Tensor, res: int, sigma: float) -> torch.Tensor:
    """(N, 63) body poses -> (N, res, res, 3) soft renders from the CLIP view."""
    dev, N = frames63.device, frames63.shape[0]
    orient = torch.tensor([math.pi / 2, 0.0, 0.0], device=dev).expand(N, 3)
    pose = torch.cat([orient, frames63, torch.zeros(N, 6, device=dev)], -1).reshape(N, 24, 3)
    v = smpl.skin(body, pose) @ torch.tensor(cameras.BODY_TO_WORLD, device=dev).t()
    view = cameras.view_poses(torch.zeros(1, device=dev), torch.tensor([AZIMUTH], device=dev))
    focal = cameras.focal_from_fov(res, math.radians(60.0))
    return raster.soft_render(v, body["faces"].long(), view.expand(N, 4, 4), res, res, focal, sigma)


class MotionRun:
    def __init__(self, cfg: dict, body: dict, clip_params, tokens, weights: dict, poses63: torch.Tensor,
                 gen: torch.Generator, device, prec: Precision = F32):
        self.cfg, self.body, self.clip, self.w, self.gen, self.prec = cfg, body, clip_params, weights, gen, prec
        self.mg = cfg["motion_generator"]
        self.poses63 = poses63
        self.latent = torch.randn(int(self.mg["latent_dim"]), generator=gen).to(device).requires_grad_(True)
        self.opt = Adam({"latent": self.latent})
        with torch.no_grad():
            self.text = clip.encode_text(clip_params, tokens, cfg["clip"], prec)[0]

    def loss(self, st_idx: int) -> torch.Tensor:
        mg, dev = self.mg, self.latent.device
        T, P = int(mg["num_frame"]), int(mg["clip_num_part"])
        motion = motion_poses(decode(self.w, self.latent, mg, self.prec))  # (T, 63)
        gen6 = matrix_to_rotation_6d(axis_angle_to_matrix(motion.reshape(T, BODY_JOINTS, 3)))
        ori6 = matrix_to_rotation_6d(axis_angle_to_matrix(self.poses63.reshape(-1, BODY_JOINTS, 3)))
        gap = ((gen6[None] - ori6[:, None]) ** 2).mean((-1, -2)).min(1).values  # (K,)
        coefs = torch.tensor([float(c) for c in mg["recon_coef"]], device=dev)[: gap.shape[0]]
        loss = (gap * coefs).sum()
        clip_coef, delta_coef = float(mg["clip_coef"]), float(mg["delta_coef"])
        if clip_coef > 0:
            raw = st_idx + P * torch.arange(-(-T // P), device=dev)
            ids = raw.clamp(0, T - 1)
            imgs = render_frames(self.body, motion[ids], int(mg["render_res"]), float(mg["sigma"]))
            imgs = clip.resize(imgs, int(self.cfg["clip"]["image_size"]))
            emb = clip.encode_image(self.clip, clip.normalize(imgs), self.cfg["clip"], self.prec)
            weight = ids.float() / T * (raw < T).float()
            loss = loss + (weight * (1.0 - clip.cosine(emb, self.text[None]))).sum() * clip_coef
        if delta_coef > 0:
            loss = loss - ((motion[1:] - motion[:-1]) ** 2).mean() * delta_coef
        return loss

    def step(self) -> tuple[float, dict]:
        st_idx = int(torch.randint(0, int(self.mg["clip_num_part"]), (), generator=self.gen))
        loss = self.loss(st_idx)
        (g,) = torch.autograd.grad(loss, [self.latent])
        self.opt.step({"latent": g}, float(self.mg["lr"]))
        return float(loss.detach()), {"latent": g}
