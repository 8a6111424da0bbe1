"""FLOPs of CLIP's vision tower (a multiply-add counted as 2)."""

from __future__ import annotations


def _parts(cfg: dict) -> tuple[float, float]:
    """(linear, attention) FLOPs of one image's forward: the patch
    embedding, each block's qkv, output and MLP products and the class
    token's projection; each block's attention scores and weighted sums."""
    P, C = int(cfg["patch_size"]), int(cfg["vision_width"])
    T = (int(cfg["image_size"]) // P) ** 2 + 1
    L = int(cfg["vision_layers"])
    linear = (2 * (T - 1) * 3 * P * P * C + L * (2 * T * C * 3 * C + 2 * T * C * C + 2 * 2 * T * C * 4 * C)
              + 2 * C * int(cfg["embed_dim"]))
    return float(linear), float(L * 2 * 2 * T * T * C)


def image_forward_flops(cfg: dict) -> float:
    linear, attn = _parts(cfg)
    return linear + attn


def image_train_flops(cfg: dict) -> float:
    """The forward and the gradient with respect to the image alone (the
    weights are frozen): a linear product's input gradient costs its
    forward again; the scores' and the sums' gradients reach both of
    their operands, twice their forward."""
    linear, attn = _parts(cfg)
    return 2.0 * linear + 3.0 * attn
