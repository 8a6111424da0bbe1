"""Colour-space utilities: RGB -> HSV and a differentiable histogram (twin of
avatarclip_tpu/render/color.py; reference: AvatarGen/AppearanceGen/models/
utils.py:127-174). Not called by the training loops; part of the public
surface for custom losses such as a palette regulariser."""

from __future__ import annotations

import torch


def rgb2hsv(rgb: torch.Tensor, epsilon: float = 1e-10) -> torch.Tensor:
    """(N, 3) rgb -> (N, 3) [hue in degrees 0..360, saturation, value]."""
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    max_rgb = rgb.max(dim=1).values
    min_rgb = rgb.min(dim=1).values
    argmin_rgb = rgb.argmin(dim=1)  # the first minimum on ties, as the JAX package
    max_min = max_rgb - min_rgb + epsilon
    h1 = 60.0 * (g - r) / max_min + 60.0
    h2 = 60.0 * (b - g) / max_min + 180.0
    h3 = 60.0 * (r - b) / max_min + 300.0
    # picked by which channel is the minimum, in the reference's order [h2, h3, h1]
    h = torch.stack([h2, h3, h1], dim=0).gather(0, argmin_rgb[None, :])[0]
    s = max_min / (max_rgb + epsilon)
    return torch.stack([h, s, max_rgb], dim=1)


def differentiable_histogram(x: torch.Tensor, bins: int = 255) -> torch.Tensor:
    """Soft (triangular-kernel) histogram with gradients: each value is
    shared linearly between its two neighbouring bins. x is (n, c, H, W) or
    (H, W); returns (n_samples, n_chns, bins). The first and last bins stay
    0, as in the reference."""
    if x.ndim == 4:
        n_samples, n_chns = x.shape[0], x.shape[1]
    elif x.ndim == 2:
        n_samples, n_chns = 1, 1
    else:
        raise AssertionError("The dimension of input tensor should be 2 or 4.")
    x_min, x_max = x.min(), x.max()
    delta = (x_max - x_min) / bins
    bin_table = torch.arange(bins + 1, dtype=x.dtype, device=x.device) * delta + x_min
    flat = x.reshape(n_samples, n_chns, -1)
    zero = torch.zeros(n_samples, n_chns, dtype=x.dtype, device=x.device)
    cols = [zero]
    for dim in range(1, bins - 1):
        h_r, h_rm, h_rp = bin_table[dim], bin_table[dim - 1], bin_table[dim + 1]
        mask_sub = ((flat >= h_rm) & (flat < h_r)).to(x.dtype)
        mask_plus = ((flat >= h_r) & (flat < h_rp)).to(x.dtype)
        cols.append(((flat - h_rm) * mask_sub).sum(-1) + ((h_rp - flat) * mask_plus).sum(-1))
    cols.append(zero)
    return torch.stack(cols[:bins], dim=-1) / delta
