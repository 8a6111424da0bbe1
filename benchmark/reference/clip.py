"""CLIP ViT-B/32 (Radford et al. 2021) in plain float32: the image tower
(32 x 32 patches, a class token, pre-LN residual blocks of multi-head
attention and a QuickGELU MLP, the class token's projection) and the text
tower (causal blocks, the projection at the end-of-text token), CLIP's
image normalisation and the antialiased bilinear resize of
jax.image.resize (a triangle kernel widened by the downsampling factor,
weights renormalised over the image).

Weights are a tree of tensors: ``visual`` {patch_w (3 P^2, C),
class_embedding, pos_embed, ln_pre, blocks [ln_1, attn {in_w, in_b, out_w,
out_b}, ln_2, mlp {fc_w, fc_b, proj_w, proj_b}], ln_post, proj}, ``text``
{token_embedding, pos_embed, blocks, ln_final, text_projection}; linear
weights in the (out, in) layout, layer norms {scale, bias}."""

from __future__ import annotations

import math

import numpy as np
import torch

from .precision import F32, Precision

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def layer_norm(p, x):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * p["scale"] + p["bias"]


def attention(p, x, heads: int, causal: bool, prec: Precision):
    T, C = x.shape[-2], x.shape[-1]
    hd = C // heads
    q, k, v = prec.linear(x, p["in_w"], p["in_b"]).split(C, -1)
    split = lambda t: t.reshape(*t.shape[:-1], heads, hd).transpose(-3, -2)
    q, k, v = split(q), split(k), split(v)
    att = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        att = att.masked_fill(~mask, float("-inf"))
    out = prec.mm(torch.softmax(att, -1), v).transpose(-3, -2).reshape(*x.shape[:-1], C)
    return prec.linear(out, p["out_w"], p["out_b"])


def block(p, x, heads: int, causal: bool, prec: Precision):
    x = x + attention(p["attn"], layer_norm(p["ln_1"], x), heads, causal, prec)
    h = prec.linear(layer_norm(p["ln_2"], x), p["mlp"]["fc_w"], p["mlp"]["fc_b"])
    h = h * torch.sigmoid(1.702 * h)
    return x + prec.linear(h, p["mlp"]["proj_w"], p["mlp"]["proj_b"])


def encode_image(params, images: torch.Tensor, cfg: dict, prec: Precision = F32) -> torch.Tensor:
    """(N, S, S, 3) CLIP-normalised images -> (N, embed)."""
    v = params["visual"]
    N, P = images.shape[0], int(cfg["patch_size"])
    G = images.shape[1] // P
    x = images.reshape(N, G, P, G, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(N, G * G, P * P * 3)
    x = prec.mm(x, v["patch_w"])
    cls = v["class_embedding"].expand(N, 1, x.shape[-1])
    x = layer_norm(v["ln_pre"], torch.cat([cls, x], 1) + v["pos_embed"])
    for blk in v["blocks"]:
        x = block(blk, x, int(cfg["vision_heads"]), False, prec)
    return prec.mm(layer_norm(v["ln_post"], x[:, 0]), v["proj"])


def encode_text(params, tokens: torch.Tensor, cfg: dict, prec: Precision = F32) -> torch.Tensor:
    """(N, 77) token ids -> (N, embed), read at each row's end-of-text
    token (its largest id)."""
    t = params["text"]
    x = t["token_embedding"][tokens.long()] + t["pos_embed"]
    for blk in t["blocks"]:
        x = block(blk, x, int(cfg["text_heads"]), True, prec)
    x = layer_norm(t["ln_final"], x)
    x = x[torch.arange(x.shape[0], device=x.device), tokens.long().argmax(-1)]
    return prec.mm(x, t["text_projection"])


def normalize(images: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN, device=images.device)
    std = torch.tensor(STD, device=images.device)
    return (images - mean) / std


def resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of jax.image.resize's bilinear method."""
    if n_in == n_out:
        return torch.eye(n_in, device=device)
    inv = n_in / n_out
    width = max(inv, 1.0)
    centre = (np.arange(n_out) + 0.5) * inv - 0.5
    w = np.clip(1.0 - np.abs(centre[None, :] - np.arange(n_in)[:, None]) / width, 0.0, None)
    total = w.sum(0, keepdims=True)
    w = np.where(total > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1.0), 0.0)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return torch.tensor(np.where(inside[None], w, 0.0), dtype=torch.float32, device=device)


def resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, size, size, C)."""
    wy = resize_matrix(images.shape[1], size, images.device)
    wx = resize_matrix(images.shape[2], size, images.device)
    return torch.einsum("nhwc,ho,wp->nopc", images, wy, wx)


def cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a / a.norm(dim=-1, keepdim=True) * (b / b.norm(dim=-1, keepdim=True))).sum(-1)
