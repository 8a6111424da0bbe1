"""NeuS's fields in plain float32 (the published networks of NeuS,
Wang et al. 2021, as AvatarCLIP configures them): NeRF positional
encoding; the SDF MLP with softplus(100 x) / 100, the skip concat scaled by
1/sqrt(2) and weight norm; the colour MLP (mode ``no_view_dir``) with relu,
an extra colour head off the last hidden activation and sigmoids; the
variance inv_s = exp(10 v).

Parameters are a flat dict of tensors under the checkpoint paths
``sdf.layers.{i}.{g,v,b}``, ``color.layers.{i}.{g,v,b}``,
``color.extra.{g,v,b}`` and ``variance.variance``; a weight-normed layer's
weight is g * v / |v| per output row.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import F32, Precision


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[x, sin(x), cos(x), sin(2x), cos(2x), ...], 2^k for k < multires."""
    if multires <= 0:
        return x
    parts = [x]
    for k in range(multires):
        parts += [torch.sin(x * 2.0**k), torch.cos(x * 2.0**k)]
    return torch.cat(parts, -1)


def dense(params: dict, prefix: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(weight (out, in), bias) of one layer, weight norm resolved."""
    b = params[prefix + ".b"]
    if prefix + ".w" in params:
        return params[prefix + ".w"], b
    g, v = params[prefix + ".g"], params[prefix + ".v"]
    return g * v / v.norm(dim=1, keepdim=True), b


def n_layers(params: dict, net: str) -> int:
    n = 0
    while f"{net}.layers.{n}.b" in params:
        n += 1
    return n


def softplus100(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(100.0 * x) / 100.0


def sdf_forward(params: dict, cfg: dict, pts: torch.Tensor, prec: Precision = F32,
                sdf_only: bool = False) -> torch.Tensor:
    """(P, 3) -> (P, 1 + feature): the SDF and the geometry feature."""
    scale = float(cfg.get("scale", 1.0))
    e = positional_encoding(pts * scale, int(cfg["multires"]))
    skips = tuple(cfg["skip_in"])
    n = n_layers(params, "sdf")
    x = e
    for l in range(n):
        if l in skips:
            x = torch.cat([x, e], -1) / math.sqrt(2.0)
        w, b = dense(params, f"sdf.layers.{l}")
        if sdf_only and l == n - 1:
            w, b = w[:1], b[:1]
        x = prec.linear(x, w, b)
        if l < n - 1:
            x = softplus100(x)
    return torch.cat([x[:, :1] / scale, x[:, 1:]], -1)


def sdf_with_gradient(params: dict, cfg: dict, pts: torch.Tensor, prec: Precision = F32):
    """(sdf (P, 1), feature (P, F), d sdf / d pts (P, 3)); the gradient keeps
    its graph so that the eikonal term differentiates it."""
    x = pts.detach().requires_grad_(True)
    with torch.enable_grad():
        out = sdf_forward(params, cfg, x, prec)
        (g,) = torch.autograd.grad(out[:, 0].sum(), x, create_graph=True)
    return out[:, :1], out[:, 1:], g


def color_forward(params: dict, cfg: dict, points, normals, features,
                  prec: Precision = F32) -> torch.Tensor:
    """Mode no_view_dir: (P, 3) points, normals, (P, F) features -> (P, 3),
    or (P, 6) [main, extra] with the extra head."""
    if cfg["mode"] != "no_view_dir":
        raise ValueError(f"the reference colour net has mode no_view_dir, not {cfg['mode']}")
    x = torch.cat([points, normals, features], -1)
    n = n_layers(params, "color")
    extra = None
    for l in range(n):
        w, b = dense(params, f"color.layers.{l}")
        x = prec.linear(x, w, b)
        if l < n - 1:
            x = torch.relu(x)
            if l == n - 2 and "color.extra.b" in params:
                we, be = dense(params, "color.extra")
                extra = prec.linear(x, we, be)
    if extra is not None:
        x = torch.cat([x, extra], -1)
    return torch.sigmoid(x) if cfg.get("squeeze_out", True) else x


def inv_s(params: dict) -> torch.Tensor:
    return torch.exp(params["variance.variance"] * 10.0).clamp(1e-6, 1e6)
