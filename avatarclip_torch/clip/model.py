"""CLIP (ViT-B/32 image encoder + text transformer) in PyTorch.

Torch twin of avatarclip_tpu/clipjax/model.py (see that module and
avatarclip_tpu/clipjax/ for the JAX reference and the npz weight format that
clipjax/convert.py writes). Parameters are the same nested tree (``visual``,
``text``, ``logit_scale``) of tensors, read from the same npz; without it a
seeded random init keeps every pipeline runnable (the scores are then
meaningless). Attention is plain matmul + softmax and the patch embedding a
matmul, as in JAX.

``compute_dtype`` follows the JAX module's casts and its dtype promotion: a
bf16 operand meeting an f32 one computes in f32 (``_mm``), so the two
packages round at the same places.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils import graphs

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    embed_dim: int = 512
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    compute_dtype: str = "float32"  # or "bfloat16"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


VIT_B32 = CLIPConfig()
# the small stand-in for fast tests and smoke runs (clip.model = tiny)
TINY = CLIPConfig(
    image_size=64, patch_size=16, vision_width=64, vision_layers=2, vision_heads=2,
    embed_dim=32, context_length=77, vocab_size=49408, text_width=64, text_layers=2,
    text_heads=2,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with JAX's dtype promotion (bf16 x f32 -> f32)."""
    rt = torch.promote_types(x.dtype, w.dtype)
    return x.to(rt) @ w.to(rt)


def _layer_norm(p, x):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + 1e-5)
    return (out * p["scale"] + p["bias"]).to(x.dtype)


def _attention(p, x, n_heads: int, causal: bool):
    T, C = x.shape[-2], x.shape[-1]
    hd = C // n_heads
    qkv = _mm(x, p["in_w"].t()) + p["in_b"]
    q, k, v = qkv.split(C, dim=-1)

    def heads(t):
        return t.reshape(*t.shape[:-1], n_heads, hd).transpose(-3, -2)

    q, k, v = heads(q), heads(k), heads(v)
    att = (q @ k.transpose(-1, -2)) / np.sqrt(hd)
    if causal:
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
        att = att.masked_fill(~mask, float("-inf"))
    att = torch.softmax(att.float(), dim=-1).to(x.dtype)
    out = _mm(att, v)
    out = out.transpose(-3, -2).reshape(*x.shape[:-1], C)
    return _mm(out, p["out_w"].t()) + p["out_b"]


def _mlp(p, x):
    h = _mm(x, p["fc_w"].t()) + p["fc_b"]
    h = h * torch.sigmoid(1.702 * h)  # QuickGELU
    return _mm(h, p["proj_w"].t()) + p["proj_b"]


def _block(p, x, n_heads: int, causal: bool):
    x = x + _attention(p["attn"], _layer_norm(p["ln_1"], x), n_heads, causal)
    return x + _mlp(p["mlp"], _layer_norm(p["ln_2"], x))


def encode_image(params, cfg: CLIPConfig, images: torch.Tensor) -> torch.Tensor:
    """images (N, H, W, 3), CLIP-normalised -> (N, embed_dim) f32;
    differentiable w.r.t. the images."""
    dt = _DTYPES[cfg.compute_dtype]
    v = params["visual"]
    N, P, G = images.shape[0], cfg.patch_size, cfg.grid
    x = images.to(dt)
    x = x.reshape(N, G, P, G, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(N, G * G, P * P * 3)
    x = x @ v["patch_w"].to(dt)
    cls = v["class_embedding"].to(dt).expand(N, 1, cfg.vision_width)
    x = torch.cat([cls, x], 1) + v["pos_embed"].to(dt)
    x = _layer_norm(v["ln_pre"], x)
    for blk in v["blocks"]:
        x = _block(blk, x, cfg.vision_heads, causal=False)
    x = _layer_norm(v["ln_post"], x[:, 0])
    return _mm(x, v["proj"].to(dt)).float()


def encode_text(params, cfg: CLIPConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (N, 77) int -> (N, embed_dim) f32, features at the EOT token."""
    dt = _DTYPES[cfg.compute_dtype]
    t = params["text"]
    x = t["token_embedding"][tokens.long()].to(dt) + t["pos_embed"].to(dt)
    for blk in t["blocks"]:
        x = _block(blk, x, cfg.text_heads, causal=True)
    x = _layer_norm(t["ln_final"], x)
    eot = tokens.argmax(-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return _mm(x, t["text_projection"].to(dt)).float()


@functools.lru_cache(maxsize=None)
def _mean_std(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(CLIP_IMAGE_MEAN, device=device),
            torch.as_tensor(CLIP_IMAGE_STD, device=device))


def normalize_image(images: torch.Tensor) -> torch.Tensor:
    mean, std = _mean_std(images.device)  # resident: no copy from the host a call
    return (images - mean) / std


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in, out) bilinear resampling matrix of ``jax.image.resize`` (triangle
    kernel, antialiased when downsampling, edge weights renormalised).
    Memoised per (in, out, device): built once on the host and copied once,
    so a call copies nothing; callers must not write to it."""
    return _resize_weights(int(in_size), int(out_size), torch.device("cpu" if device is None else device),
                           torch.get_default_dtype())


@functools.lru_cache(maxsize=None)
def _resize_weights(in_size: int, out_size: int, device: torch.device,
                    eye_dtype: torch.dtype) -> torch.Tensor:
    if in_size == out_size:  # the identity in the default dtype, the resampling in float32
        return torch.eye(in_size, dtype=eye_dtype, device=device)
    scale = out_size / in_size
    inv_scale = torch.tensor(1.0 / scale, dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize_image(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, out_h, out_w, C), as jax.image.resize(..., "bilinear")."""
    wy = resize_weights(images.shape[1], out_h, images.device)
    wx = resize_weights(images.shape[2], out_w, images.device)
    return torch.einsum("nhwc,ho,wp->nopc", images, wy, wx)


def resize_to_clip(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    return resize_image(images, size, size)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / a.norm(dim=-1, keepdim=True)
    b = b / b.norm(dim=-1, keepdim=True)
    return (a * b).sum(-1)


# ---------------------------------------------------------------------------
# the image tower replayed from CUDA graphs (utils/graphs.py)
# ---------------------------------------------------------------------------

WARMUP_CALLS = graphs.WARMUP_CALLS
_leaves = graphs.leaves
_Replay = graphs.Replay
_ImageGraph = graphs.Graph  # one key's graphs: normalize_image then encode_image, and its input gradient
_cache = graphs.Cache("clip_graph", "backward.clip")
_graphs = _cache.graphs


def encode_image_graphed(params, cfg: CLIPConfig, images: torch.Tensor) -> torch.Tensor:
    """``encode_image(params, cfg, normalize_image(images))`` for un-normalised
    images (N, H, W, 3), the same ops and numbers, replayed from CUDA graphs
    where the call is a training step's: the images on a CUDA device and
    requiring grad, grad mode on, no parameter of the image tower requiring
    grad. Anything else runs the eager ops.

    A key (the images' shape, dtype and device, ``cfg``, ``params``) runs
    eager for its first ``WARMUP_CALLS`` calls, is captured on the next and
    replayed from then on; the backward replays the input gradient's graph
    (span ``backward.clip``). While a replay's backward is pending, a call of
    the same key runs eager. Counters (utils/trace.py): ``clip_graph_eager``
    (grad-mode CUDA calls that ran eager: warm-up and pending replays),
    ``clip_graph_capture``, ``clip_graph_replay`` (calls that replayed an
    earlier capture)."""
    return _cache(lambda x: encode_image(params, cfg, normalize_image(x)), (cfg, id(params)),
                  _leaves(params["visual"]), images)


def init_params(cfg: CLIPConfig, generator: torch.Generator):
    """Seeded random init with the checkpoint's shapes."""
    normal = lambda *s: torch.randn(*s, generator=generator)

    def ln(w):
        return {"scale": torch.ones(w), "bias": torch.zeros(w)}

    def block(w):
        s = w**-0.5
        return {
            "ln_1": ln(w),
            "attn": {"in_w": normal(3 * w, w) * s, "in_b": torch.zeros(3 * w),
                     "out_w": normal(w, w) * s, "out_b": torch.zeros(w)},
            "ln_2": ln(w),
            "mlp": {"fc_w": normal(4 * w, w) * s, "fc_b": torch.zeros(4 * w),
                    "proj_w": normal(w, 4 * w) * s, "proj_b": torch.zeros(w)},
        }

    vw, tw = cfg.vision_width, cfg.text_width
    T = cfg.grid * cfg.grid + 1
    return {
        "visual": {
            "patch_w": normal(cfg.patch_size**2 * 3, vw) * 0.02,
            "class_embedding": normal(vw) * 0.02,
            "pos_embed": normal(T, vw) * 0.01,
            "ln_pre": ln(vw),
            "blocks": [block(vw) for _ in range(cfg.vision_layers)],
            "ln_post": ln(vw),
            "proj": normal(vw, cfg.embed_dim) * vw**-0.5,
        },
        "text": {
            "token_embedding": normal(cfg.vocab_size, tw) * 0.02,
            "pos_embed": normal(cfg.context_length, tw) * 0.01,
            "blocks": [block(tw) for _ in range(cfg.text_layers)],
            "ln_final": ln(tw),
            "text_projection": normal(tw, cfg.embed_dim) * tw**-0.5,
        },
        "logit_scale": torch.tensor(float(np.log(1 / 0.07))),
    }


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def load_npz(path: str):
    """The npz written by avatarclip_tpu/clipjax/convert.py, as tensors."""
    from ..utils.convert import params_from_jax

    with np.load(path) as data:
        return params_from_jax(dict(data))


def load_pretrained(path: str | None = None):
    """(params, pretrained): the npz on disk, else a seeded random init.
    Real weights without the real BPE vocabulary are refused, as in JAX."""
    from . import tokenizer as tk

    from .. import assets

    p = path or assets.find("clip_vit_b32.npz")
    if p and p.endswith(".npz"):
        if isinstance(tk.default_tokenizer(), tk.HashedTokenizer):
            raise RuntimeError(
                f"Pretrained CLIP weights found at {p!r} but the BPE merges file "
                "(bpe_simple_vocab_16e6.txt.gz) is not discoverable; place the "
                "vocab next to the weights."
            )
        return load_npz(p), True
    return init_params(VIT_B32, torch.Generator().manual_seed(42)), False
