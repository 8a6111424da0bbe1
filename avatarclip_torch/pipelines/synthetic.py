"""Synthetic views and confs for smoke runs (twin of
avatarclip_tpu/pipelines/synthetic.py; the conf text is the JAX package's
own ``make_conf_text``)."""

from __future__ import annotations

import json
import os

import numpy as np

from avatarclip_tpu.pipelines.synthetic import make_conf_text  # noqa: F401  (no JAX)

from ..utils.png import write_png


def write_synthetic_views(out_dir: str, n_views: int = 8, res: int = 64) -> str:
    """Circle silhouettes from an orbit of cameras, Blender layout."""
    os.makedirs(os.path.join(out_dir, "img"), exist_ok=True)
    frames = []
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        eye = np.array([2.0 * np.sin(a), 0.0, 2.0 * np.cos(a)], np.float32)
        z = eye / np.linalg.norm(eye)
        x = np.cross([0, 1, 0], z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        m = np.eye(4, dtype=np.float32)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, eye
        img = np.zeros((res, res, 3), np.uint8)
        yy, xx = np.mgrid[0:res, 0:res]
        img[(yy - res / 2) ** 2 + (xx - res / 2) ** 2 < (res / 4) ** 2] = 255
        write_png(os.path.join(out_dir, "img", f"{i:04d}.png"), img)
        frames.append({"file_path": f"img/{i:04d}", "transform_matrix": m.tolist()})
    with open(os.path.join(out_dir, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": float(np.deg2rad(60.0)), "frames": frames}, f)
    return out_dir


def make_runner(tmp_dir: str, scale: str = "tiny", res: int = 64, n_views: int = 4,
                device="cpu"):
    """Self-contained Runner at the requested scale."""
    from avatarclip_tpu import config as config_mod

    from .appearance import Runner

    data_dir = write_synthetic_views(os.path.join(tmp_dir, "views"), n_views=n_views, res=res)
    conf = config_mod.parse_string(
        make_conf_text(os.path.join(tmp_dir, "exp"), data_dir, scale)
    )
    return Runner(None, mode="none", conf=conf, device=device)
