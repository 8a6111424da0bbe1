"""NeRF-style positional encoding (twin of avatarclip_tpu/fields/embedder.py).

Layout: [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...] with
f_k = 2^k, k < multires.
"""

from __future__ import annotations

import torch


def embed_dim(multires: int, input_dims: int = 3) -> int:
    if multires <= 0:
        return input_dims
    return input_dims * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """(..., d) -> (..., d * (1 + 2*multires)); identity when multires <= 0."""
    if multires <= 0:
        return x
    parts = [x]
    for k in range(multires):
        f = float(2.0**k)
        parts.append(torch.sin(x * f))
        parts.append(torch.cos(x * f))
    return torch.cat(parts, dim=-1)
